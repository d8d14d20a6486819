"""Coffee game rules in PyTorch, batched over a leading [B] axis.

The port of `katacoffee_tpu/game/board.py`: the same rules, conventions and
Zobrist tables, written as tensor ops on a batch of games instead of a
single-game function under `vmap`. Outputs agree with the JAX version bit for
bit (tests/test_torch_board.py).

Conventions (as in the JAX package):
  * Directions 0=N, 1=W, 2=NW, 3=NE, 4=NONE; (dy, dx) offsets in DIR_OFFSETS.
  * A flat spot is y*X + x; a flat policy action is dir*(Y*X) + spot.
  * The game ends when the mover completes a run of `win_len` through the
    spot just played (the mover wins), or as a draw when the player to move
    has no legal move.
  * The hash is uint32[2] built by XOR only; each word is held in an int64
    tensor and stays below 2**32, since torch's uint32 support is partial.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from katacoffee_tpu_torch.device import resolve_device

P_BLACK = 1
P_WHITE = 2
C_EMPTY = 0

D_NORTH = 0
D_WEST = 1
D_NORTHWEST = 2
D_NORTHEAST = 3
D_NONE = 4
NUM_DIRECTIONS = 4

DIR_OFFSETS = ((-1, 0), (0, -1), (-1, -1), (-1, 1))

NUM_RECENT_MOVES = 6


class GameConfig(NamedTuple):
    """Static game parameters."""

    x_size: int = 5
    y_size: int = 5
    win_len: int = 4

    @property
    def area(self) -> int:
        return self.x_size * self.y_size

    @property
    def policy_size(self) -> int:
        return self.x_size * self.y_size * NUM_DIRECTIONS


class GameState(NamedTuple):
    """A batch of game states; every field has the leading batch dims
    ([B], or [B, N] inside a search tree)."""

    board: torch.Tensor  # int8 [..., Y, X]; 0 empty, 1 black, 2 white
    to_move: torch.Tensor  # int8 [...]; 1 or 2
    last_spot: torch.Tensor  # int64 [...]; flat y*X+x, -1 if no move yet
    last_dir: torch.Tensor  # int64 [...]; 0..3, D_NONE if no move yet
    done: torch.Tensor  # bool [...]
    winner: torch.Tensor  # int8 [...]; 0 = none yet / draw
    num_turns: torch.Tensor  # int64 [...]
    recent_spots: torch.Tensor  # int64 [..., NUM_RECENT_MOVES]; [0] = last move
    recent_dirs: torch.Tensor  # int64 [..., NUM_RECENT_MOVES]
    stone_hash: torch.Tensor  # int64 [..., 2]; two uint32 words, Zobrist over stones

    def map(self, fn) -> "GameState":
        """Apply `fn` to every field."""
        return GameState(*(fn(x) for x in self))


# ---------------------------------------------------------------------------
# Zobrist tables (the same fixed-seed numpy draws as the JAX package)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _zobrist_np(x_size: int, y_size: int):
    rng = np.random.RandomState(0xC0FFEE)
    area = x_size * y_size
    stones = rng.randint(0, 2**32, size=(area, 2, 2), dtype=np.uint64).astype(np.uint32)
    lastloc = rng.randint(0, 2**32, size=(area + 1, 5, 2), dtype=np.uint64).astype(np.uint32)
    player = rng.randint(0, 2**32, size=(2, 2), dtype=np.uint64).astype(np.uint32)
    return stones, lastloc, player


@functools.lru_cache(maxsize=None)
def zobrist_tables(cfg: GameConfig, device: torch.device):
    """(stones [area,2,2], lastloc [area+1,5,2], player [2,2]) as int64."""
    return tuple(
        torch.from_numpy(t.astype(np.int64)).to(device)
        for t in _zobrist_np(cfg.x_size, cfg.y_size)
    )


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def init_state(
    cfg: GameConfig, batch: int, device: str | torch.device | None = None,
    to_move: int = P_BLACK,
) -> GameState:
    """`batch` empty boards on `device` (default `cuda`)."""
    dev = resolve_device(device)

    def full(shape, value, dtype):
        return torch.full((batch,) + shape, value, dtype=dtype, device=dev)

    return GameState(
        board=full((cfg.y_size, cfg.x_size), 0, torch.int8),
        to_move=full((), to_move, torch.int8),
        last_spot=full((), -1, torch.int64),
        last_dir=full((), D_NONE, torch.int64),
        done=full((), False, torch.bool),
        winner=full((), 0, torch.int8),
        num_turns=full((), 0, torch.int64),
        recent_spots=full((NUM_RECENT_MOVES,), -1, torch.int64),
        recent_dirs=full((NUM_RECENT_MOVES,), D_NONE, torch.int64),
        stone_hash=full((2,), 0, torch.int64),
    )


# ---------------------------------------------------------------------------
# Geometry tables (numpy, built once per config)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _line_tables_np(x_size: int, y_size: int, win_len: int):
    """The JAX package's precomputed line tables, built the same way:
      * inc [4, area, area]: inc[d,i,j]=1 iff cell j lies on the maximal line
        through cell i along direction d (including i itself);
      * lastline [area+1, 5, area]: allowed-cell mask given (last_spot,
        last_dir); row area = "no last move" (all True), dir 4 likewise;
      * win_windows [nw, area]: all length-win_len straight windows;
      * exact[L] = (win [nw_L, area], boundary [nw_L, area]) for L in
        win_len-3 .. win_len-1 (at least 1)."""
    area = x_size * y_size
    ys, xs = np.mgrid[0:y_size, 0:x_size]

    def on(x, y):
        return 0 <= x < x_size and 0 <= y < y_size

    inc = np.zeros((4, area, area), np.float32)
    for d, (dy, dx) in enumerate(DIR_OFFSETS):
        for i in range(area):
            ix, iy = i % x_size, i // x_size
            inc[d, i, i] = 1.0
            for sign in (1, -1):
                cx, cy = ix + sign * dx, iy + sign * dy
                while on(cx, cy):
                    inc[d, i, cy * x_size + cx] = 1.0
                    cx += sign * dx
                    cy += sign * dy

    lastline = np.zeros((area + 1, 5, area), bool)
    lastline[area, :, :] = True
    lastline[:, 4, :] = True
    for s in range(area):
        lx, ly = s % x_size, s // x_size
        dxg = xs - lx
        dyg = ys - ly
        lastline[s, 0] = ((dxg == 0) & (dyg != 0)).reshape(-1)
        lastline[s, 1] = ((dyg == 0) & (dxg != 0)).reshape(-1)
        lastline[s, 2] = (dxg == dyg).reshape(-1)
        lastline[s, 3] = (dxg == -dyg).reshape(-1)

    def windows(L):
        wins, bounds = [], []
        for dy, dx in DIR_OFFSETS:
            for y0 in range(y_size):
                for x0 in range(x_size):
                    cells = [(x0 + k * dx, y0 + k * dy) for k in range(L)]
                    if not all(on(x, y) for x, y in cells):
                        continue
                    w = np.zeros((area,), np.float32)
                    for x, y in cells:
                        w[y * x_size + x] = 1.0
                    b = np.zeros((area,), np.float32)
                    for bx, by in ((x0 - dx, y0 - dy), (x0 + L * dx, y0 + L * dy)):
                        if on(bx, by):
                            b[by * x_size + bx] = 1.0
                    wins.append(w)
                    bounds.append(b)
        return np.stack(wins), np.stack(bounds)

    win_windows, _ = windows(win_len)
    exact = {}
    for L in range(max(win_len - 3, 1), win_len):
        exact[L] = windows(L)
    return inc, lastline, win_windows, exact


@functools.lru_cache(maxsize=None)
def _line_tables(cfg: GameConfig, device: torch.device):
    """The line tables as tensors on `device`: inc [4*area, area] f32,
    lastline [area+1, 5, area] bool, win_windows [nw, area] bool, and
    exact {L: (win [nw_L, area] f32, boundary [nw_L, area] f32)}."""
    inc, lastline, win_windows, exact = _line_tables_np(cfg.x_size, cfg.y_size, cfg.win_len)
    t = functools.partial(torch.as_tensor, device=device)
    return (
        t(inc.reshape(4 * cfg.area, cfg.area)),
        t(lastline),
        t(win_windows > 0.5),
        {L: (t(w), t(b)) for L, (w, b) in exact.items()},
    )


# ---------------------------------------------------------------------------
# Rules: legality
# ---------------------------------------------------------------------------


def line_empty_counts(cfg: GameConfig, board: torch.Tensor) -> torch.Tensor:
    """[B, 4, Y, X] int64: empty cells on the maximal line through each cell
    along each direction (walls bound lines, stones do not). The counts are
    small integers, exact in the float32 product."""
    inc = _line_tables(cfg, board.device)[0]
    empty = (board == C_EMPTY).reshape(board.shape[0], -1).to(torch.float32)
    counts = empty @ inc.T  # [B, 4*area]
    return (counts + 0.5).to(torch.int64).reshape(-1, 4, cfg.y_size, cfg.x_size)


def _on_last_move_line(cfg: GameConfig, last_spot, last_dir) -> torch.Tensor:
    """[B, Y, X] bool: cells on the line through the previous move's spot
    along its direction (all True with no previous move)."""
    lastline = _line_tables(cfg, last_spot.device)[1]
    spot_idx = torch.where(last_spot < 0, cfg.area, last_spot)
    return lastline[spot_idx, last_dir].reshape(-1, cfg.y_size, cfg.x_size)


def legal_mask(cfg: GameConfig, state: GameState) -> torch.Tensor:
    """[B, 4, Y, X] bool legal moves for the player to move; all False when
    the game is done."""
    empty = state.board == C_EMPTY
    on_line = _on_last_move_line(cfg, state.last_spot, state.last_dir)
    alive = line_empty_counts(cfg, state.board) >= 2
    mask = (empty & on_line)[:, None] & alive
    return mask & ~state.done[:, None, None, None]


def legal_mask_flat(cfg: GameConfig, state: GameState) -> torch.Tensor:
    """[B, 4*Y*X] bool in the dir-major flat policy layout."""
    return legal_mask(cfg, state).reshape(state.board.shape[0], -1)


# ---------------------------------------------------------------------------
# Rules: runs and win detection
# ---------------------------------------------------------------------------


def _shift2d(arr: torch.Tensor, dy: int, dx: int, fill: int) -> torch.Tensor:
    """Shift [B, Y, X] so out[:, y, x] = arr[:, y+dy, x+dx], `fill` off-board."""
    _, y, x = arr.shape
    out = torch.full_like(arr, fill)
    ys, ye = max(-dy, 0), min(y, y - dy)
    xs, xe = max(-dx, 0), min(x, x - dx)
    if ys < ye and xs < xe:
        out[:, ys:ye, xs:xe] = arr[:, ys + dy : ye + dy, xs + dx : xe + dx]
    return out


def run_lengths(cfg: GameConfig, board: torch.Tensor) -> torch.Tensor:
    """[B, 4, Y, X] int64: length of the maximal same-color run through each
    cell along each direction (computed for empty cells too)."""
    kmax = max(cfg.x_size, cfg.y_size) - 1
    b = board.to(torch.int64)
    outs = []
    for dy, dx in DIR_OFFSETS:
        total = torch.ones_like(b)
        for sign in (1, -1):
            carry = torch.ones_like(b, dtype=torch.bool)
            for k in range(1, kmax + 1):
                neighbor = _shift2d(b, sign * dy * k, sign * dx * k, -1)
                carry = carry & (neighbor == b)
                total = total + carry.to(torch.int64)
        outs.append(total)
    return torch.stack(outs, dim=1)


def per_cell_max_run(cfg: GameConfig, board: torch.Tensor) -> torch.Tensor:
    """[..., Y, X] int64: the longest same-color run through each cell over
    the four directions (the per-cell longest-line training target), for
    boards [..., Y, X]."""
    flat = board.reshape((-1, cfg.y_size, cfg.x_size))
    return run_lengths(cfg, flat).amax(1).reshape(board.shape)


def _wins_at(cfg: GameConfig, board: torch.Tensor, spot: torch.Tensor) -> torch.Tensor:
    """[B] bool: the stone at `spot` lies in a run of at least win_len."""
    win_windows = _line_tables(cfg, board.device)[2]  # [nw, area] bool
    flat = board.reshape(board.shape[0], -1)
    color = flat.gather(1, spot[:, None])  # [B, 1]
    is_c = flat == color  # [B, area]
    # a window is full iff none of its cells lacks the color
    full = ~(win_windows[None] & ~is_c[:, None, :]).any(-1)  # [B, nw]
    contains = win_windows.T[spot]  # [B, nw]
    return (full & contains).any(-1) & (color[:, 0] != C_EMPTY)


def exact_run_mask(cfg: GameConfig, board: torch.Tensor, length: int) -> torch.Tensor:
    """[B, Y, X] bool: stones in a maximal same-color run of exactly `length`
    along some direction."""
    exact = _line_tables(cfg, board.device)[3]
    bsz = board.shape[0]
    if length not in exact:
        return torch.zeros((bsz, cfg.y_size, cfg.x_size), dtype=torch.bool, device=board.device)
    W, Bd = exact[length]
    flat = board.reshape(bsz, -1)
    marked = torch.zeros((bsz, cfg.area), dtype=torch.bool, device=board.device)
    for color in (1, 2):
        is_c = (flat == color).to(torch.float32)
        full = ((is_c @ W.T) >= (length - 0.5)) & ((is_c @ Bd.T) < 0.5)  # [B, nw]
        member = (full.to(torch.float32) @ W) > 0.5  # [B, area]
        marked = marked | (member & (flat == color))
    return marked.reshape(bsz, cfg.y_size, cfg.x_size)


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------


def step(cfg: GameConfig, state: GameState, action: torch.Tensor) -> GameState:
    """Apply flat dir-major actions [B], assumed legal. A game that is
    already done is left as it was."""
    bsz = state.board.shape[0]
    area = cfg.area
    action = action.to(torch.int64)
    direction = action // area
    spot = action % area
    bidx = torch.arange(bsz, device=action.device)

    mover = state.to_move
    flat = state.board.reshape(bsz, -1).clone()
    flat[bidx, spot] = mover
    new_board = flat.reshape(state.board.shape)

    stones, _, _ = zobrist_tables(cfg, action.device)
    new_hash = state.stone_hash ^ stones[spot, mover.to(torch.int64) - 1]

    won = _wins_at(cfg, new_board, spot)

    nxt = GameState(
        board=new_board,
        to_move=(3 - mover).to(torch.int8),
        last_spot=spot,
        last_dir=direction,
        done=won,
        winner=torch.where(won, mover, torch.zeros_like(mover)),
        num_turns=state.num_turns + 1,
        recent_spots=torch.cat([spot[:, None], state.recent_spots[:, :-1]], dim=1),
        recent_dirs=torch.cat([direction[:, None], state.recent_dirs[:, :-1]], dim=1),
        stone_hash=new_hash,
    )
    # no legal reply for the opponent: the game ends as a draw
    has_reply = legal_mask_flat(cfg, nxt).any(-1)
    nxt = nxt._replace(done=won | ~has_reply)

    def keep_if_done(old, new):
        d = state.done.reshape((bsz,) + (1,) * (old.dim() - 1))
        return torch.where(d, old, new)

    return GameState(*(keep_if_done(o, n) for o, n in zip(state, nxt)))


# ---------------------------------------------------------------------------
# Hashing
# ---------------------------------------------------------------------------


def situation_hash(cfg: GameConfig, state: GameState) -> torch.Tensor:
    """[B, 2] int64 words of the uint32[2] hash of stones, player to move and
    last move (the transposition key)."""
    _, lastloc, player = zobrist_tables(cfg, state.board.device)
    spot_idx = torch.where(state.last_spot < 0, cfg.area, state.last_spot)
    h = state.stone_hash ^ player[state.to_move.to(torch.int64) - 1]
    return h ^ lastloc[spot_idx, state.last_dir]
