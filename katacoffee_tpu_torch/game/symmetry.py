"""Dihedral-8 symmetry helpers for boards, feature planes, policies and
states, in PyTorch.

The port of `katacoffee_tpu/game/symmetry.py`, with the same encoding: a
symmetry is 3 bits, flipY (bit 0), flipX (bit 1) and transpose (bit 2),
applied in that order; transposes need a square board. Directions transform
as lines: NE <-> NW iff exactly one of flipX / flipY, N <-> W iff transpose.

Every function works on tensors with a leading batch axis. Where the JAX
package takes one symmetry (an int), the state, spot, direction, action,
policy, plane and feature transforms here also take a [B] tensor of
symmetries, one per game: they are table lookups and index gathers, exact
copies of the values. No function draws a random number by itself:
`random_symmetry` takes a `torch.Generator`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from katacoffee_tpu_torch.game.board import (
    D_NONE,
    NUM_DIRECTIONS,
    GameConfig,
    GameState,
    zobrist_tables,
)

NUM_SYMMETRIES = 8


def num_symmetries(cfg: GameConfig) -> int:
    """Usable dihedral symmetries: 8 on a square board, 4 on a rectangle
    (the transpose bit needs x_size == y_size)."""
    return NUM_SYMMETRIES if cfg.x_size == cfg.y_size else 4


def is_flip_y(sym: int) -> bool:
    return (sym & 1) != 0


def is_flip_x(sym: int) -> bool:
    return (sym & 2) != 0


def is_transpose(sym: int) -> bool:
    return (sym & 4) != 0


def invert(sym):
    """The inverse symmetry: 5 and 6 are each other's inverses, the rest
    invert themselves. `sym` is an int or an integer tensor."""
    if isinstance(sym, torch.Tensor):
        return torch.where(sym == 5, 6, torch.where(sym == 6, 5, sym))
    return {5: 6, 6: 5}.get(sym, sym)


def compose(first: int, then: int) -> int:
    """The symmetry equal to applying `first`, then `then`."""
    if is_transpose(first):
        then = (then & 0x4) | ((then & 0x2) >> 1) | ((then & 0x1) << 1)
    return first ^ then


@functools.lru_cache(maxsize=None)
def dir_perm(sym: int) -> tuple:
    """perm[old_dir] = new_dir for the 4 directions, D_NONE fixed."""
    perm = list(range(NUM_DIRECTIONS)) + [D_NONE]
    if is_flip_x(sym) ^ is_flip_y(sym):
        perm[2], perm[3] = perm[3], perm[2]  # NW <-> NE
    if is_transpose(sym):
        perm[0], perm[1] = perm[1], perm[0]  # N <-> W
    return tuple(perm)


def _inverse_dir_perm(sym: int) -> list:
    inv = [0] * NUM_DIRECTIONS
    for old, new in enumerate(dir_perm(sym)[:NUM_DIRECTIONS]):
        inv[new] = old
    return inv


@functools.lru_cache(maxsize=None)
def _spot_table_np(x_size: int, y_size: int) -> np.ndarray:
    """[nsym, area] int64: each flat spot's image under each symmetry."""
    nsym = num_symmetries(GameConfig(x_size, y_size))
    table = np.zeros((nsym, x_size * y_size), np.int64)
    for s in range(nsym):
        for spot in range(x_size * y_size):
            x, y = spot % x_size, spot // x_size
            if is_flip_x(s):
                x = x_size - 1 - x
            if is_flip_y(s):
                y = y_size - 1 - y
            if is_transpose(s):
                x, y = y, x
            table[s, spot] = y * x_size + x
    return table


@functools.lru_cache(maxsize=None)
def action_table(cfg: GameConfig) -> np.ndarray:
    """[nsym, A] int32: each flat dir-major action's image under each
    symmetry."""
    spots = _spot_table_np(cfg.x_size, cfg.y_size)
    nsym = spots.shape[0]
    table = np.zeros((nsym, cfg.policy_size), np.int32)
    for s in range(nsym):
        perm = dir_perm(s)
        for a in range(cfg.policy_size):
            d, spot = divmod(a, cfg.area)
            table[s, a] = perm[d] * cfg.area + spots[s, spot]
    return table


@functools.lru_cache(maxsize=None)
def _tables(cfg: GameConfig, device: torch.device):
    """(spot [nsym, area], action [nsym, A]) int64 tables."""
    return tuple(
        torch.from_numpy(np.asarray(t, np.int64)).to(device)
        for t in (_spot_table_np(cfg.x_size, cfg.y_size), action_table(cfg))
    )


@functools.lru_cache(maxsize=None)
def _dir_table(device: torch.device) -> torch.Tensor:
    """[8, 5] int64: dir_perm of each symmetry."""
    return torch.tensor([dir_perm(s) for s in range(NUM_SYMMETRIES)], dtype=torch.int64, device=device)


def _per_row(sym, like: torch.Tensor) -> torch.Tensor:
    """`sym` (an int or a [B] tensor) broadcast to the shape of `like`,
    whose leading axis is the batch."""
    if not isinstance(sym, torch.Tensor):
        return torch.full_like(like, sym, dtype=torch.int64)
    return sym.to(torch.int64).reshape((-1,) + (1,) * (like.dim() - 1)).expand(like.shape)


def _check_square(cfg: GameConfig, sym) -> None:
    if cfg.x_size == cfg.y_size:
        return
    bad = bool((sym >= 4).any()) if isinstance(sym, torch.Tensor) else is_transpose(sym)
    if bad:
        raise ValueError("a transpose symmetry needs a square board")


def apply_plane(sym, plane: torch.Tensor) -> torch.Tensor:
    """Apply to the trailing two (H, W) axes of a tensor. `sym` is an int,
    or a [B] tensor, one symmetry per row of a [B, ..., H, W] tensor: then
    one gather on the device."""
    if isinstance(sym, torch.Tensor):
        h, w = plane.shape[-2:]
        spots = _source_spots(w, h, plane.device)[sym.to(torch.int64)]  # [B, area]
        flat = plane.reshape(plane.shape[0], -1, h * w)
        return torch.gather(flat, 2, spots[:, None, :].expand(flat.shape)).reshape(plane.shape)
    if is_flip_y(sym):
        plane = torch.flip(plane, dims=(-2,))
    if is_flip_x(sym):
        plane = torch.flip(plane, dims=(-1,))
    if is_transpose(sym):
        if plane.shape[-1] != plane.shape[-2]:
            raise ValueError("a transpose symmetry needs a square board")
        plane = plane.transpose(-1, -2)
    return plane


def apply_spot(cfg: GameConfig, sym, spot: torch.Tensor) -> torch.Tensor:
    """Flat spot indices [B, ...]; -1 (no spot) maps to itself."""
    _check_square(cfg, sym)
    spots = _tables(cfg, spot.device)[0]
    out = spots[_per_row(sym, spot), spot.clamp(min=0)]
    return torch.where(spot < 0, spot, out)


def apply_direction(sym, direction: torch.Tensor) -> torch.Tensor:
    """Directions [B, ...] (0..3, D_NONE fixed)."""
    return _dir_table(direction.device)[_per_row(sym, direction), direction].to(direction.dtype)


def apply_policy(cfg: GameConfig, sym, policy: torch.Tensor) -> torch.Tensor:
    """Transform dir-major flat policy-sized vectors [B, ..., 4*H*W]: the
    value at action a moves to apply_action(a)."""
    _check_square(cfg, sym)
    if isinstance(sym, torch.Tensor):
        src = _tables(cfg, policy.device)[1][invert(sym).to(torch.int64)]  # [B, A]
        src = src.reshape((src.shape[0],) + (1,) * (policy.dim() - 2) + (src.shape[1],))
        return torch.gather(policy, -1, src.expand(policy.shape))
    shp = policy.shape[:-1]
    p = policy.reshape(*shp, NUM_DIRECTIONS, cfg.y_size, cfg.x_size)
    p = apply_plane(sym, p)
    p = p[..., _inverse_dir_perm(sym), :, :]
    return p.reshape(*shp, -1)


def apply_action(cfg: GameConfig, sym, action: torch.Tensor) -> torch.Tensor:
    """Flat dir-major action indices [B, ...]."""
    direction = action // cfg.area
    spot = action % cfg.area
    return apply_direction(sym, direction) * cfg.area + apply_spot(cfg, sym, spot)


def _feature_channels(sym: int, num_channels: int) -> list:
    """Source channel of each output channel: the direction channels of the
    last-move one-hot (3-6) and the legal-move (11-14) groups permuted."""
    inv = _inverse_dir_perm(sym)
    chans = list(range(num_channels))
    for base in (3, 11):
        chans[base: base + NUM_DIRECTIONS] = [base + inv[d] for d in range(NUM_DIRECTIONS)]
    return chans


@functools.lru_cache(maxsize=None)
def _source_spots(x_size: int, y_size: int, device: torch.device) -> torch.Tensor:
    """[nsym, area] int64: the input spot each output spot reads."""
    nsym = num_symmetries(GameConfig(x_size, y_size))
    spots = _spot_table_np(x_size, y_size)[[invert(s) for s in range(nsym)]]
    return torch.from_numpy(np.asarray(spots, np.int64)).to(device)


@functools.lru_cache(maxsize=None)
def _feature_tables(x_size: int, y_size: int, num_channels: int, device: torch.device):
    """(source spot [nsym, area], source channel [nsym, C]) int64 tables."""
    nsym = num_symmetries(GameConfig(x_size, y_size))
    chans = np.asarray([_feature_channels(s, num_channels) for s in range(nsym)], np.int64)
    return _source_spots(x_size, y_size, device), torch.from_numpy(chans).to(device)


def apply_features(sym, spatial: torch.Tensor) -> torch.Tensor:
    """Transform the 18-channel feature tensor [..., 18, H, W]: every plane,
    and the direction channels of the last-move one-hot (3-6) and the
    legal-move (11-14) groups. `sym` is an int, or a [B] tensor, one
    symmetry per row of a [B, 18, H, W] tensor: then one gather on the
    device, with no host sync."""
    if isinstance(sym, torch.Tensor):
        b, c, h, w = spatial.shape
        spots, chans = _feature_tables(w, h, c, spatial.device)
        sym = sym.to(torch.int64)
        # output (c, j) reads input (chans[c], spots[j]); an out-of-range
        # symmetry (a transpose of a rectangle) fails the index
        src = chans[sym][:, :, None] * (h * w) + spots[sym][:, None, :]  # [B, C, area]
        return torch.gather(spatial.reshape(b, c * h * w), 1, src.reshape(b, -1)).reshape(b, c, h, w)
    spatial = apply_plane(sym, spatial)
    return spatial[..., _feature_channels(sym, spatial.shape[-3]), :, :]


def _stone_hash(cfg: GameConfig, board: torch.Tensor) -> torch.Tensor:
    """[B, 2] Zobrist words of the stones on boards [B, Y, X]: the XOR of the
    present stones' entries, taken bit by bit as the parity of a count."""
    stones = zobrist_tables(cfg, board.device)[0]  # [area, 2, 2]
    flat = board.reshape(board.shape[0], -1)
    contrib = torch.where((flat == 1)[..., None], stones[:, 0], 0) ^ torch.where(
        (flat == 2)[..., None], stones[:, 1], 0
    )  # [B, area, 2]
    shifts = torch.arange(32, device=board.device)
    parity = ((contrib[..., None] >> shifts) & 1).sum(1) & 1  # [B, 2, 32]
    return (parity << shifts).sum(-1)


def apply_state(cfg: GameConfig, sym, state: GameState) -> GameState:
    """Transform a batch of game states [B] (board, last move, history and
    stone hash) by `sym`, an int or a [B] tensor."""
    _check_square(cfg, sym)
    if isinstance(sym, torch.Tensor):
        spots = _tables(cfg, state.board.device)[0]
        src = spots[invert(sym).to(torch.int64)]  # [B, area]: where each new cell comes from
        flat = state.board.reshape(state.board.shape[0], -1)
        board = torch.gather(flat, 1, src).reshape(state.board.shape)
    else:
        board = apply_plane(sym, state.board).contiguous()
    return state._replace(
        board=board,
        last_spot=apply_spot(cfg, sym, state.last_spot),
        last_dir=apply_direction(sym, state.last_dir),
        recent_spots=apply_spot(cfg, sym, state.recent_spots),
        recent_dirs=apply_direction(sym, state.recent_dirs),
        stone_hash=_stone_hash(cfg, board),
    )


def random_symmetry(generator: torch.Generator, shape=()) -> torch.Tensor:
    """Symmetries in [0, 8), drawn from `generator` on its device."""
    return torch.randint(0, NUM_SYMMETRIES, shape, generator=generator, device=generator.device)


def stabilizer_mask(cfg: GameConfig, state: GameState) -> torch.Tensor:
    """[B, nsym] bool: which symmetries fix each game's position (board and
    last move); column 0, the identity, is always set."""
    cols = []
    for s in range(num_symmetries(cfg)):
        ts = apply_state(cfg, s, state)
        same = (ts.board == state.board).flatten(1).all(-1)
        cols.append(same & ((state.last_spot < 0)
                            | ((ts.last_spot == state.last_spot) & (ts.last_dir == state.last_dir))))
    return torch.stack(cols, dim=1)


def stabilizer(cfg: GameConfig, state: GameState) -> list[list[int]]:
    """For each game of the batch, the symmetries that fix its position
    (board and last move); always contains 0."""
    return [torch.nonzero(row)[:, 0].tolist() for row in stabilizer_mask(cfg, state).cpu()]
