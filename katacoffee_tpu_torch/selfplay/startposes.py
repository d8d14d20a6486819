"""Start positions for selfplay from SGF files, in PyTorch.

The port of `katacoffee_tpu/selfplay/startposes.py` (the reference's
startposes machinery: `Sgf::PositionSample`, GameInitializer
startposes/hintposes sampling, play.h:69-142; startPosesProb /
startPosesFromSgfDir / startPosesTurnWeightLambda, selfplay1.cfg:37-41):
every prefix of each SGF's main line, plus pure-placement setups, becomes a
pool position that a fraction of selfplay episodes starts from. The position
after turn t of its game weighs exp(-lambda * t).

The games are stepped together: one batched `step` per ply over all files,
not one call per move of each file.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from katacoffee_tpu_torch.dataio.sgf import parse_sgf_file
from katacoffee_tpu_torch.device import resolve_device
from katacoffee_tpu_torch.game.board import NUM_DIRECTIONS, GameConfig, GameState, init_state, step


def _usable_games(cfg: GameConfig, files: list[str]):
    """[(placements, [action])] of the files that parse, match the board, and
    whose moves lie on the board (an SGF is outside input: a move off the
    board is refused here rather than indexed)."""
    games = []
    for path in files:
        try:
            sgf = parse_sgf_file(path)
        except (ValueError, OSError):
            continue
        if sgf.board_size() != (cfg.x_size, cfg.y_size) or sgf.win_len() != cfg.win_len:
            continue
        try:
            placements = sgf.placements()
        except ValueError:
            continue
        moves = sgf.moves()
        on_board = all(0 <= x < cfg.x_size and 0 <= y < cfg.y_size for x, y, *_ in placements + moves)
        if not on_board or not all(0 <= d < NUM_DIRECTIONS for _, _, d, _ in moves):
            continue
        games.append((placements, [d * cfg.area + y * cfg.x_size + x for x, y, d, _ in moves]))
    return games


def load_startposes(
    cfg: GameConfig,
    paths: list[str] | str,
    turn_weight_lambda: float = 0.0,
    max_positions: int = 4096,
    include_final: bool = False,
    with_hints: bool = False,
    device: str | torch.device | None = None,
):
    """(states [K] on `device` (default `cuda`), sampling probs [K] float32)
    or None if no position is usable; with `with_hints` also hint actions
    [K] int64: the move the source game played from each position (-1 where
    there is none, as for placement setups). `paths` is a directory
    (searched recursively) or a list of SGF files. A game contributes the
    positions after each of its moves until one ends it; `include_final` is
    accepted as the JAX package accepts it, and like there adds nothing.
    Positions are taken in file order up to `max_positions`, as the JAX
    package takes them."""
    dev = resolve_device(device)
    if isinstance(paths, str):
        files = []
        for root, _dirs, names in os.walk(paths):
            files.extend(os.path.join(root, n) for n in sorted(names) if n.endswith(".sgf"))
    else:
        files = list(paths)
    games = _usable_games(cfg, files)
    if not games:
        return None

    # every game's plies at once; a game past its moves steps a dummy move
    # whose positions are not taken
    G = len(games)
    T = max(len(moves) for _, moves in games)
    actions = np.zeros((G, T), np.int64)
    for g, (_, moves) in enumerate(games):
        actions[g, :len(moves)] = moves
    actions_t = torch.from_numpy(actions).to(dev)
    s = init_state(cfg, G, dev)
    after = []  # after[t]: the states after ply t, [G]
    for t in range(T):
        s = step(cfg, s, actions_t[:, t])
        after.append(s)
    done = torch.stack([a.done for a in after], 1).cpu().numpy() if T else np.zeros((G, 0), bool)

    # the JAX package's order and cut: a placement setup adds one position
    # without checking the cap; a game adds its positions one by one and
    # stops at the cap (after at least one), which ends the scan
    setups = []
    picks, weights, hints = [], [], []  # picks index [T * G game positions, then the setups]
    for g, (placements, moves) in enumerate(games):
        if placements and not moves:
            board = np.zeros((cfg.y_size, cfg.x_size), np.int8)
            for x, y, pla in placements:
                board[y, x] = pla
            picks.append(T * G + len(setups))
            setups.append(board)
            weights.append(1.0)
            hints.append(-1)
            continue
        for t in range(len(moves)):
            if done[g, t]:
                break
            picks.append(t * G + g)
            weights.append(math.exp(-turn_weight_lambda * (t + 1)))
            hints.append(moves[t + 1] if t + 1 < len(moves) else -1)
            if len(picks) >= max_positions:
                break
        if len(picks) >= max_positions:
            break
    if not picks:
        return None

    table = [GameState(*(torch.stack(f, 0).reshape((T * G,) + f[0].shape[1:]) for f in zip(*after)))] if T else []
    if setups:
        # a setup keeps the empty board's other fields, its stone hash too,
        # as in the JAX package
        boards = torch.from_numpy(np.stack(setups)).to(dev)
        table.append(init_state(cfg, len(setups), dev)._replace(
            board=boards, num_turns=(boards != 0).flatten(1).sum(1)))
    idx = torch.tensor(picks, dtype=torch.int64, device=dev)
    pool = GameState(*(torch.cat(f, 0)[idx] for f in zip(*table)))
    w = np.asarray(weights, np.float64)
    probs = torch.from_numpy((w / w.sum()).astype(np.float32)).to(dev)
    if with_hints:
        return pool, probs, torch.tensor(hints, dtype=torch.int64, device=dev)
    return pool, probs
