"""Misc commands: demoplay, dataminesgfs, samplesgfs, viewstartposes,
trystartposes and sampleinitializations, the port of
`katacoffee_tpu/command/misc.py` (the reference's `cpp/command/misc.cpp`
subcommands) over the port's engine, search and start-position pool on
`device` (default `cuda`). `samplesgfs` reads and writes files only.

Where the JAX commands draw from a `jax.random` key, these draw from a
`torch.Generator` on the device seeded the same way; `sampleinitializations`
also takes its draws injected (`InitDraws`), as the tests pass the JAX
command's. Under `SearchParams.for_tests_v2()` no search draws anything."""

from __future__ import annotations

import argparse
import itertools
import math
import os
import random
from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from katacoffee_tpu_torch.dataio.sgf import parse_sgf_file, write_sgf
from katacoffee_tpu_torch.device import resolve_device
from katacoffee_tpu_torch.game import io as gio
from katacoffee_tpu_torch.game.board import GameConfig, GameState, init_state, step
from katacoffee_tpu_torch.search import mcts
from katacoffee_tpu_torch.search.params import SearchParams

Device = str | torch.device | None

# dataminesgfs reads and replays the SGFs this many games at a time
REPLAY_CHUNK = 64


def _evaluator(args, device, cfg: GameConfig, announce: bool):
    """(eval_fn, cfg): the exported model's evaluator on `device`, or
    uniform priors without `-model`."""
    if not args.model:
        return mcts.uniform_eval_fn(cfg), cfg
    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model

    model, cfg, meta = load_exported_model(args.model, device)
    if announce:
        print(f"model: {meta['name']}")
    return mcts.make_nn_eval_fn(cfg, model), cfg


def main_demoplay(argv, *, device: Device = None):
    from katacoffee_tpu_torch.program.engine import Engine

    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch demoplay")
    ap.add_argument("-model", default=None)
    ap.add_argument("-visits", type=int, default=100)
    ap.add_argument("-games", type=int, default=1)
    ap.add_argument("-seed", type=int, default=0)
    args = ap.parse_args(argv)

    eval_fn = None
    cfg = GameConfig(5, 5, 4)
    if args.model:
        eval_fn, cfg = _evaluator(args, device, cfg, announce=True)
    sp = SearchParams.for_tests_v2()

    for g in range(args.games):
        eng = Engine(cfg, sp, eval_fn, seed=args.seed + g, device=device)
        print(f"=== game {g + 1} ===")
        while not eng.game_over:
            mover = "black" if eng.to_move == 1 else "white"
            action, result = eng.genmove(args.visits)
            print(
                f"{mover}: {gio.action_to_string(action, cfg)} "
                f"(wr {result.root_winrate:.3f}, visits {result.root_visits})"
            )
            print(eng.showboard())
        res = {0: "draw", 1: "black wins", 2: "white wins"}[eng.winner]
        print(f"result: {res} after {len(eng.move_history)} moves")


def _sgf_games(cfg: GameConfig, sgf_dirs: list[str]):
    """(name, [actions]) of each readable SGF of this board size under the
    dirs, in the JAX command's walk order, each file read only when the
    caller asks for the next game."""
    for d in sgf_dirs:
        for root, _dirs, files in os.walk(d):
            for name in sorted(files):
                if not name.endswith(".sgf"):
                    continue
                try:
                    sgf = parse_sgf_file(os.path.join(root, name))
                except (ValueError, OSError):
                    continue
                if sgf.board_size() != (cfg.x_size, cfg.y_size):
                    continue
                yield name, [dd * cfg.area + y * cfg.x_size + x for x, y, dd, _pla in sgf.moves()]


def _replay(cfg: GameConfig, games, dev: torch.device):
    """Every game's plies at once: (before [T * G] the states before each
    ply, ply-major; done [G, T + 1] host bools of those states, and after
    the last ply). A game past its moves steps a dummy move whose states
    are not taken."""
    G = len(games)
    T = max(len(m) for _, m in games)
    actions = np.zeros((G, max(T, 1)), np.int64)
    for g, (_, moves) in enumerate(games):
        actions[g, :len(moves)] = moves
    acts = torch.from_numpy(actions).to(dev)
    s = init_state(cfg, G, dev)
    seen = [s]
    for t in range(T):
        s = step(cfg, s, acts[:, t])
        seen.append(s)
    done = torch.stack([x.done for x in seen], 1).cpu().numpy()
    before = GameState(*(torch.cat(f[:T] if T else f[:1], 0) for f in zip(*seen)))
    return before, done


def main_dataminesgfs(argv, *, device: Device = None):
    """Search-filtered position mining (the reference's dataminesgfs,
    misc.cpp:1184): batch-search sampled SGF positions and keep the
    "interesting" ones (the search's preferred move disagrees with the
    game's move, or the position is sharply winning or losing) as
    hintpos-style startposes. The SGFs are read and replayed
    REPLAY_CHUNK games at a time, each chunk as one batch, and no further
    once `-max-positions` candidates are drawn; all candidate positions of
    a batch are ONE search call, padded with the last candidate to
    `-batch-size` lanes."""
    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch dataminesgfs")
    ap.add_argument("sgf_dirs", nargs="+")
    ap.add_argument("-out-dir", required=True)
    ap.add_argument("-model", default=None)
    ap.add_argument("-visits", type=int, default=200)
    ap.add_argument("-batch-size", type=int, default=64)
    ap.add_argument("-sample-prob", type=float, default=0.25)
    ap.add_argument("-max-positions", type=int, default=512)
    ap.add_argument("-surprise-threshold", type=float, default=0.5,
                    help="keep if the game move got < this fraction of the search's top-move visits")
    ap.add_argument("-seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    eval_fn, cfg = _evaluator(args, dev, GameConfig(5, 5, 4), announce=False)
    rnd = random.Random(args.seed)

    # collect candidate (position, game-move) pairs in the JAX command's
    # order and with its draws: one per ply t >= 1 of a live game, the games
    # read and replayed REPLAY_CHUNK at a time until the candidates are full
    games = _sgf_games(cfg, args.sgf_dirs)
    cands, chunks = [], []  # (game action, source); the candidates' states, a tensor a chunk
    while len(cands) < args.max_positions:
        chunk = list(itertools.islice(games, REPLAY_CHUNK))
        if not chunk:
            break
        before, done = _replay(cfg, chunk, dev)
        G, rows = len(chunk), []
        for g, (name, moves) in enumerate(chunk):
            if len(cands) >= args.max_positions:
                break
            for t, a in enumerate(moves):
                if t >= 1 and not done[g, t] and rnd.random() < args.sample_prob:
                    rows.append(t * G + g)
                    cands.append((a, f"{name}:{t}"))
                if done[g, t + 1]:
                    break
        if rows:
            rows = torch.tensor(rows, device=dev)
            chunks.append(before.map(lambda x: x[rows]))
    if not cands:
        print("no candidate positions found")
        return
    pool = GameState(*(torch.cat(f, 0) for f in zip(*chunks)))

    sp = SearchParams.for_tests_v2()
    os.makedirs(args.out_dir, exist_ok=True)
    kept = 0
    Bsz = args.batch_size
    A = cfg.policy_size
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    for lo in range(0, len(cands), Bsz):
        batch = cands[lo: lo + Bsz]
        pad = torch.tensor(list(range(lo, lo + len(batch))) + [lo + len(batch) - 1] * (Bsz - len(batch)), device=dev)
        roots = pool.map(lambda x: x[pad])
        tree = mcts.run_search(cfg, sp, eval_fn, roots, args.visits, device=dev, generator=generator)
        # one host copy: visit counts (exact in float32), root wl, the roots
        host = torch.cat([mcts.root_visit_counts(tree).to(torch.float32), mcts.root_values(tree)["root_wl"][:, None],
                          roots.board.flatten(1).to(torch.float32),
                          torch.stack([roots.to_move.to(torch.float32), roots.last_spot.to(torch.float32),
                                       roots.last_dir.to(torch.float32)], 1)], 1).cpu().numpy()
        rv = host[:, :A].astype(np.int32)
        wl = host[:, A]
        boards = host[:, A + 1: A + 1 + cfg.area].astype(np.int64).reshape(-1, cfg.y_size, cfg.x_size)
        scal = host[:, A + 1 + cfg.area:].astype(np.int64)
        for i, (game_a, src) in enumerate(batch):
            top = rv[i].max()
            surprising = rv[i][game_a] < args.surprise_threshold * top
            sharp = abs(wl[i]) > 0.9
            if not (surprising or sharp):
                continue
            board = boards[i]
            placements = [
                (x, y, int(board[y, x]))
                for y in range(cfg.y_size)
                for x in range(cfg.x_size)
                if board[y, x] != 0
            ]
            text = write_sgf(
                cfg.x_size, cfg.y_size, cfg.win_len, [], "mined", "mined",
                placements=placements,
                root_comment=(
                    f"src={src},searchBest={int(np.argmax(rv[i]))},"
                    f"gameMove={game_a},rootWL={wl[i]:+.3f},"
                    f"toMove={int(scal[i, 0])},lastSpot={int(scal[i, 1])},"
                    f"lastDir={int(scal[i, 2])}"
                ),
            )
            with open(os.path.join(args.out_dir, f"hint{kept:06d}.sgf"), "w") as f:
                f.write(text + "\n")
            kept += 1
    print(f"mined {kept} interesting positions from {len(cands)} candidates into {args.out_dir}")


def main_samplesgfs(argv, **_):
    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch samplesgfs")
    ap.add_argument("sgf_dirs", nargs="+")
    ap.add_argument("-out-dir", required=True)
    ap.add_argument("-sample-prob", type=float, default=0.1,
                    help="probability of keeping each position")
    ap.add_argument("-min-turn", type=int, default=2)
    ap.add_argument("-max-turn", type=int, default=18)
    ap.add_argument("-seed", type=int, default=0)
    args = ap.parse_args(argv)

    rnd = random.Random(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    kept = scanned = 0
    for d in args.sgf_dirs:
        for root, _dirs, files in os.walk(d):
            for name in sorted(files):
                if not name.endswith(".sgf"):
                    continue
                try:
                    sgf = parse_sgf_file(os.path.join(root, name))
                except (ValueError, OSError):
                    continue
                scanned += 1
                x, y = sgf.board_size()
                moves = sgf.moves()
                for t in range(args.min_turn, min(len(moves), args.max_turn)):
                    if rnd.random() >= args.sample_prob:
                        continue
                    # prefix game as a startpos SGF (load_startposes replays it)
                    text = write_sgf(x, y, sgf.win_len(), moves[:t], "sampled", "sampled")
                    out = os.path.join(args.out_dir, f"pos{kept:06d}.sgf")
                    with open(out, "w") as f:
                        f.write(text + "\n")
                    kept += 1
    print(f"sampled {kept} positions from {scanned} SGFs into {args.out_dir}")


def main_viewstartposes(argv, *, device: Device = None):
    """View startposes (MainCmds::viewstartposes, misc.cpp:2388): print each
    pool position's board, sampling weight, and hint move."""
    from katacoffee_tpu_torch.selfplay.startposes import load_startposes

    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch viewstartposes")
    ap.add_argument("-start-poses-dir", required=True)
    ap.add_argument("-min-weight", type=float, default=0.0)
    ap.add_argument("-idx", type=int, default=-1)
    ap.add_argument("-turn-weight-lambda", type=float, default=0.0)
    args = ap.parse_args(argv)

    cfg = GameConfig(5, 5, 4)
    out = load_startposes(cfg, args.start_poses_dir, turn_weight_lambda=args.turn_weight_lambda, with_hints=True,
                          device=device)
    if out is None:
        print("no usable startposes")
        return
    pool, probs, hints = out
    boards, to_move, turns, probs, hints = (x.cpu().numpy() for x in (pool.board, pool.to_move, pool.num_turns,
                                                                       probs, hints))
    idxs = [args.idx] if args.idx >= 0 else range(probs.shape[0])
    shown = 0
    for i in idxs:
        if probs[i] < args.min_weight:
            continue
        hint = gio.action_to_string(int(hints[i]), cfg) if hints[i] >= 0 else "-"
        mover = "black" if to_move[i] == 1 else "white"
        print(f"startpos {i}: weight {probs[i]:.5f} turn {turns[i]} {mover} to move, hint {hint}")
        print(gio.board_to_string(boards[i], cfg))
        shown += 1
    print(f"{shown} positions")


def main_trystartposes(argv, *, device: Device = None):
    """Run ONE batched search over the startposes and print each chosen
    move and value (MainCmds::trystartposes, misc.cpp:2230)."""
    from katacoffee_tpu_torch.selfplay.startposes import load_startposes

    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch trystartposes")
    ap.add_argument("-start-poses-dir", required=True)
    ap.add_argument("-model", default=None)
    ap.add_argument("-visits", type=int, default=100)
    ap.add_argument("-min-weight", type=float, default=0.0)
    ap.add_argument("-max-positions", type=int, default=64)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    eval_fn, cfg = _evaluator(args, dev, GameConfig(5, 5, 4), announce=True)
    out = load_startposes(cfg, args.start_poses_dir, with_hints=True, device=dev)
    if out is None:
        print("no usable startposes")
        return
    pool, probs, hints = out
    keep = np.where(probs.cpu().numpy() >= args.min_weight)[0][: args.max_positions]
    roots = pool.map(lambda x: x[torch.from_numpy(keep).to(dev)])

    sp = SearchParams.for_tests_v2()
    tree = mcts.run_search(cfg, sp, eval_fn, roots, args.visits, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
    moves = mcts.select_moves(cfg, sp, tree, generator=torch.Generator(device=dev).manual_seed(1))
    moves, wl, boards, hints = (x.cpu().numpy() for x in (moves, mcts.root_values(tree)["root_wl"], roots.board,
                                                         hints))
    for j, i in enumerate(keep):
        hint = gio.action_to_string(int(hints[i]), cfg) if hints[i] >= 0 else "-"
        print(f"startpos {i}: move {gio.action_to_string(int(moves[j]), cfg)} wl {wl[j]:+.3f} hint {hint}")
        print(gio.board_to_string(boards[j], cfg))
    print(f"tried {len(keep)} positions at {args.visits} visits")


class InitDraws(NamedTuple):
    """sampleinitializations' draws, passed in instead of drawn from the
    generator (the tests pass the JAX command's): `exponential` [B] the
    Exponential(1) sample of each opening's length, `gumbel(t)` [B, A] the
    Gumbel noise of the move sampled at ply t (a categorical draw is the
    argmax of the logits plus it, as jax.random.categorical computes it)."""

    exponential: torch.Tensor
    gumbel: Callable[[int], torch.Tensor]


def main_sampleinitializations(argv, *, device: Device = None, draws: InitDraws | None = None):
    """Sample policy-initialized openings and print them
    (MainCmds::sampleinitializations, misc.cpp:2544): the same
    ~Exponential()*area*prop raw-policy opening the selfplay actor uses
    (PlayUtils::initializeGameUsingPolicy, playutils.cpp:147-174). The
    lengths and moves come from a generator seeded with `-seed`, or from
    `draws`."""
    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch sampleinitializations")
    ap.add_argument("-model", default=None)
    ap.add_argument("-num", type=int, default=1)
    ap.add_argument("-evaluate", action="store_true")
    ap.add_argument("-area-prop", type=float, default=0.04)
    ap.add_argument("-temperature", type=float, default=1.0)
    ap.add_argument("-seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    eval_fn, cfg = _evaluator(args, dev, GameConfig(5, 5, 4), announce=True)
    B = args.num
    A = cfg.policy_size
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    if draws is None:
        draws = InitDraws(
            torch.empty((B,), device=dev).exponential_(generator=generator),
            lambda t: -torch.log(torch.empty((B, A), device=dev).exponential_(generator=generator)))
    lens = np.floor(draws.exponential.cpu().numpy() * cfg.area * args.area_prop).astype(int)
    lens_t = torch.from_numpy(lens).to(dev)
    states = init_state(cfg, B, dev)
    for t in range(int(lens.max()) if B else 0):
        res = eval_fn(states)
        logits = torch.where(res.policy > 0, torch.log(res.policy.clamp(min=1e-30)) / args.temperature, -math.inf)
        acts = torch.argmax(logits + draws.gumbel(t).to(dev), dim=-1)
        still = (lens_t > t) & ~states.done
        nxt = step(cfg, states, torch.where(still, acts, 0))
        states = GameState(*(torch.where(still.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
                             for n, o in zip(nxt, states)))
    boards = states.board.cpu().numpy()
    if args.evaluate:
        res = eval_fn(states)
        wl, draw = res.wl.float().cpu().numpy(), res.draw.float().cpu().numpy()
    for i in range(B):
        print(f"initialization {i}: {lens[i]} opening moves")
        print(gio.board_to_string(boards[i], cfg))
        if args.evaluate:
            print(f"  raw wl {float(wl[i]):+.3f} draw {float(draw[i]):.3f}")
