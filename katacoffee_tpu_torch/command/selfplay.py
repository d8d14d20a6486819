"""Selfplay data-generation daemon, in PyTorch.

The port of `katacoffee_tpu/command/selfplay.py` (the reference's
`cpp/command/selfplay.cpp`): generate training data continuously into
per-model output dirs `<base>/selfplay/<model>/{tdata,sgfs}`
(selfplay.cpp:33-425), polling `<base>/models` for newer nets between
segments. The shards are the JAX package's format (`dataio/trainingwrite.py`),
so its shuffler and trainer read them.

One process drives B games in lockstep on one GPU, `moves_per_segment`
plies per `run_selfplay_segment`; each segment's trajectory stays on the
device until its flush window (`segments_per_flush` segments) is finalized
and written, once per window. Over several GPUs each rank of a process group
drives its B/world games on its own GPU (`run_selfplay_daemon`).

Randomness: the daemon draws from one `torch.Generator` seeded by
`SelfplayConfig.seed` on its device, by (seed, rank) over several ranks (JAX
derives keys from `fold_in(PRNGKey(seed), process_index)` and folds in the
shard index, a stream torch cannot reproduce, so the two packages play
different games for one seed). The numpy generator of the fork candidates
is the JAX package's, `default_rng((seed ^ 0x5EEDF04C) + rank)`, and is
drawn from in the same order.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import signal
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from katacoffee_tpu_torch.dataio.checkpoints import find_latest_model, load_exported_model
from katacoffee_tpu_torch.dataio.sgf import write_sgf
from katacoffee_tpu_torch.dataio.trainingwrite import TrainingDataWriter
from katacoffee_tpu_torch.device import resolve_device
from katacoffee_tpu_torch.game.board import GameConfig, GameState, init_state
from katacoffee_tpu_torch.parallel import mesh
from katacoffee_tpu_torch.search.mcts import make_nn_eval_fn, uniform_eval_fn
from katacoffee_tpu_torch.search.params import SearchParams
from katacoffee_tpu_torch.selfplay.actor import (
    SelfplaySettings,
    Trajectory,
    finalize_targets,
    init_side_state,
    run_selfplay_segment,
    run_side_segment,
)
from katacoffee_tpu_torch.selfplay.forking import (
    ForkChoiceDraws,
    ForkPool,
    choose_fork_moves,
    extract_fork_candidates,
    init_fork_pool,
    refill_pool,
)
from katacoffee_tpu_torch.selfplay.startposes import load_startposes
from katacoffee_tpu_torch.selfplay.treerecord import tree_position_rows
from katacoffee_tpu_torch.utils.config import ConfigParser
from katacoffee_tpu_torch.utils.logger import Logger

def extract_episodes(cfg: GameConfig, traj: Trajectory) -> list[tuple[list, int]]:
    """Complete episodes of a trajectory window as ([(x, y, d, pla)], winner),
    for SGF output (JAX selfplay.py:42). Episodes that do not finish inside
    the window are skipped, as are those that did not start on a fresh board
    inside it."""
    played = traj.played_action.cpu().numpy()  # [T, B]
    done = traj.done_after.cpu().numpy()
    winner = traj.winner_after.cpu().numpy()
    ep = traj.episode_id.cpu().numpy()
    mover = traj.states.to_move.cpu().numpy()
    nturns = traj.states.num_turns.cpu().numpy()
    T, B = played.shape
    out = []
    for b in range(B):
        t = 0
        while t < T:
            e = ep[t, b]
            end = None
            moves = []
            for u in range(t, T):
                if ep[u, b] != e:
                    break
                a = int(played[u, b])
                d, spot = a // cfg.area, a % cfg.area
                moves.append((spot % cfg.x_size, spot // cfg.x_size, d, int(mover[u, b])))
                if done[u, b]:
                    end = u
                    break
            if end is None:
                break  # the unfinished tail
            if int(nturns[t, b]) == 0:
                out.append((moves, int(winner[end, b])))
            t = end + 1
    return out


def concat_trajectories(trajs: list[Trajectory]) -> Trajectory:
    """Trajectories of consecutive segments as one window, moves along dim 0,
    on their device."""
    return Trajectory(*(
        GameState(*(torch.cat(f) for f in zip(*xs))) if isinstance(xs[0], tuple) else torch.cat(xs)
        for xs in zip(*trajs)
    ))


@dataclasses.dataclass
class SelfplayConfig:
    """The daemon's settings: the JAX package's fields and defaults
    (selfplay.py:81)."""

    batch_size: int = 256
    num_sims: int = 600  # reference training op-point (selfplay1.cfg:84)
    moves_per_segment: int = 16  # plies per run_selfplay_segment
    # segments concatenated per finalize window: rows of episodes that do not
    # finish inside a window get weight 0, so the window (moves_per_segment x
    # segments_per_flush) should be 2-3x the typical game length
    segments_per_flush: int = 4
    max_rows_per_file: int = 65536
    poll_every_segments: int = 1
    write_sgfs: bool = True
    max_segments: int | None = None  # None = run forever
    max_rows: int | None = None
    seed: int = 0
    # the game batch over every visible GPU, one rank each, when it divides
    # over them (a single GPU ignores it, as JAX does with one device)
    use_mesh: bool = True
    # start-position SGFs (startPosesFromSgfDir / startPosesProb)
    startposes_dir: str | None = None
    startposes_prob: float = 0.0
    startposes_turn_weight_lambda: float = 0.0
    # side-position forking (sidePositionProb, selfplay1.cfg:58)
    side_position_prob: float = 0.020
    # whole-game forking (earlyForkGameProb/forkGameProb, selfplay1.cfg:26-33)
    early_fork_game_prob: float = 0.040
    fork_game_prob: float = 0.010
    # hint-position SGFs (hintPosesFromSgfDir / hintPosesProb)
    hintposes_dir: str | None = None
    hintposes_prob: float = 0.0
    # tree-position recording (recordTreePositions/recordTreeThreshold/
    # recordTreeTargetWeight, playsettings.h:62-64; off by default)
    record_tree_positions: bool = False
    record_tree_threshold: int = 0
    record_tree_target_weight: float = 0.0
    # mixed-board-size runs tag per-size data dirs (tdata_<tag>, sgfs_<tag>)
    data_tag: str = ""
    # tree slots per search as a fraction of visits
    node_budget_frac: float = 0.3


def _tick(walls: dict | None, part: str, t0: float, dev: torch.device) -> None:
    """Add the seconds since `t0` to `walls[part]`, after the device has
    finished what was queued."""
    if walls is None:
        return
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    walls.setdefault(part, []).append(time.monotonic() - t0)


class FlushResult(NamedTuple):
    rows: int  # training rows written (game rows, then tree-position rows)
    games: int  # finished episodes written as SGFs
    fork_pool: ForkPool | None


def flush_window(
    cfg: GameConfig,
    settings: SelfplaySettings,
    trajs: list[Trajectory],
    writer: TrainingDataWriter,
    *,
    eval_fn=None,
    fork_pool: ForkPool | None = None,
    fork_rng: np.random.Generator | None = None,
    sgf_dir: str | None = None,
    model_name: str = "random",
    seg: int = 0,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
    fork_draws: ForkChoiceDraws | None = None,
    walls: dict | None = None,
    rank: int | None = None,
) -> FlushResult:
    """One flush window of the daemon, in the JAX package's order
    (selfplay.py:333-396): the segments' trajectories concatenated along
    time on the device, `finalize_targets`, the rows to `writer`, the
    tree-position rows; with a `fork_pool`, the fork candidates of the
    window (`extract_fork_candidates` on `fork_rng`), padded to the pool's
    capacity, the value-net choice (`choose_fork_moves` with `eval_fn`, its
    draws from `generator` or `fork_draws`) and `refill_pool`; then, with an
    `sgf_dir`, one SGF per finished episode, `seg{seg:06d}_{i:04d}.sgf`
    (`seg{seg:06d}_rank{rank}_{i:04d}.sgf` with a `rank`: the ranks of a
    process group share the directory). `walls` collects the seconds of
    each part."""
    dev = resolve_device(device)
    t0 = time.monotonic()
    merged = concat_trajectories(trajs)
    batch = finalize_targets(cfg, settings, merged)
    _tick(walls, "finalize", t0, dev)
    t0 = time.monotonic()
    rows = writer.add_batch(batch)
    if settings.record_tree_positions and settings.record_tree_target_weight > 0:
        rows += writer.add_batch(tree_position_rows(cfg, settings, merged))
    _tick(walls, "write", t0, dev)

    if fork_pool is not None:
        t0 = time.monotonic()
        cands = extract_fork_candidates(
            cfg, merged, fork_rng,
            early_fork_prob=settings.early_fork_game_prob,
            early_fork_move_prop=settings.early_fork_game_expected_move_prop,
            fork_prob=settings.fork_game_prob,
            early_max_choices=settings.early_fork_game_max_choices,
            fork_max_choices=settings.fork_game_max_choices,
        )
        if cands is not None:
            Kf = settings.fork_pool_capacity
            flat_idx, maxcs, forceds = (a[:Kf] for a in cands)
            k = len(flat_idx)
            pad = Kf - k
            # pad to the capacity with copies of row 0, as JAX does
            idx = torch.from_numpy(np.concatenate([flat_idx, np.zeros(pad, np.int64)])).to(dev)
            cstates = merged.states.map(lambda x: x.reshape((-1,) + x.shape[2:])[idx])
            cvalid = torch.arange(Kf, device=dev) < k
            cmax = torch.from_numpy(np.concatenate([maxcs, np.zeros(pad, np.int32)])).to(dev)
            cforce = torch.from_numpy(np.concatenate([forceds, np.full(pad, -1, np.int32)])).to(dev)
            # JAX draws the fork choice's key here; the port draws from
            # `generator`, and takes the same numbers so that the candidates
            # of later windows come from the same numpy stream
            fork_rng.integers(0, 2**31, size=2, dtype=np.uint32)
            new_forks = choose_fork_moves(
                cfg, eval_fn, cstates, cvalid, cmax, cforce, device=dev, generator=generator, draws=fork_draws,
                min_choices=settings.fork_game_min_choices,
                num_lanes=max(settings.early_fork_game_max_choices, settings.fork_game_max_choices),
            )
            fork_pool = refill_pool(fork_pool, new_forks)
        _tick(walls, "forks", t0, dev)

    games = 0
    if sgf_dir is not None:
        t0 = time.monotonic()
        episodes = extract_episodes(cfg, merged)
        games = len(episodes)
        tag = "" if rank is None else f"rank{rank}_"
        for i, (moves, winner) in enumerate(episodes):
            text = write_sgf(cfg.x_size, cfg.y_size, cfg.win_len, moves, model_name, model_name, winner=winner)
            with open(os.path.join(sgf_dir, f"seg{seg:06d}_{tag}{i:04d}.sgf"), "w") as f:
                f.write(text + "\n")
        _tick(walls, "sgfs", t0, dev)
    return FlushResult(rows, games, fork_pool)


def run_selfplay_daemon(
    base_dir: str,
    cfg: GameConfig,
    sp: SearchParams,
    spc: SelfplayConfig,
    logger: Logger | None = None,
    install_signal_handlers: bool = False,
    *,
    device: str | torch.device | None = None,
    walls: dict | None = None,
) -> int:
    """The daemon loop on `device` (default `cuda`; JAX selfplay.py:129).
    Returns the training rows written.

    Every `poll_every_segments` segments it looks for the newest model in
    `<base_dir>/models` (`uniform_eval_fn` under the name "random" while
    there is none); on a change it flushes the old model's rows into the old
    model's dirs, then evaluates with the new net under a random symmetry
    per evaluation. Each segment's side positions are searched and written
    at once; every `segments_per_flush` segments a window is flushed
    (`flush_window`). It stops after `max_segments` segments or `max_rows`
    rows. With `install_signal_handlers` (the CLI), SIGINT and SIGTERM stop
    the loop after the current segment and flush (selfplay.cpp:22-31). The
    seconds of each part go to `walls` by name (segment, side, poll, and
    the flush's finalize, write, forks and sgfs), with a device
    synchronization at the end of each; without `walls` nothing is timed.

    Several GPUs (JAX :200-240, :301-319): started outside a launcher where
    the JAX package shards the game batch (use_mesh, several visible GPUs,
    the batch divisible by their number), the daemon runs itself on one
    rank a GPU through `launch_local` (rank 0's walls come back). In a
    process group each rank plays batch_size/world games on its own GPU,
    uncoupled, as each shard of JAX's `shard_map` does, with the side and
    fork pools' capacities rounded as JAX rounds them for its mesh, then
    split over the ranks. Rank 0 polls the models and broadcasts what it
    found, so every rank switches at the same segment; one all-reduce a
    segment sums the rows (and any rank's stop request), so max_rows and
    max_segments hold for the whole run, and every rank returns the total."""
    dev = resolve_device(device)
    logger = logger or Logger(log_to_stdout=True)
    n = mesh.local_world_size(dev, spc.use_mesh, spc.batch_size)
    if n > 1:
        logger.write(f"selfplay: the game batch over {n} GPUs, one rank each")
        rows, rank_walls = mesh.launch_local(_daemon_rank, n, base_dir, cfg, sp, spc, logger, install_signal_handlers,
                                             walls is not None)[0]
        for k, v in (rank_walls or {}).items():
            walls.setdefault(k, []).extend(v)
        return rows
    rank, world = mesh.world()
    dev = mesh.rank_device(dev)
    if spc.batch_size % world:
        raise ValueError(f"numParallelGames {spc.batch_size} does not divide over {world} ranks")
    batch = spc.batch_size // world
    models_dir = os.path.join(base_dir, "models")
    generator = torch.Generator(device=dev).manual_seed(mesh.rank_seed(spc.seed, rank, world))

    stop_requested = [False]
    kept_handlers = {}
    if install_signal_handlers and threading.current_thread() is threading.main_thread():
        def _handler(signum, frame):
            logger.write(f"selfplay: signal {signum}, flushing and stopping")
            stop_requested[0] = True

        for sig in (signal.SIGINT, signal.SIGTERM):
            kept_handlers[sig] = signal.signal(sig, _handler)

    def load_pool(path, prob, what, **kw):
        if not (path and prob > 0.0):
            return None, 0.0
        loaded = load_startposes(cfg, path, device=dev, **kw)
        if loaded is None:
            logger.write(f"selfplay: no usable {what} positions in {path}")
            return None, 0.0
        logger.write(f"selfplay: loaded {loaded[1].shape[0]} {what} positions from {path}")
        return loaded, prob

    startpos_pool, startposes_prob = load_pool(spc.startposes_dir, spc.startposes_prob, "start",
                                               turn_weight_lambda=spc.startposes_turn_weight_lambda)
    hintpos_pool, hintposes_prob = load_pool(spc.hintposes_dir, spc.hintposes_prob, "hint", with_hints=True)

    # over several ranks the pools are split, so their capacities round to a
    # multiple of 8 and of the world size (JAX's cap_round for its mesh)
    cap_round = 8 * world // math.gcd(8, world)
    settings = SelfplaySettings(
        num_sims=spc.num_sims,
        node_budget_frac=spc.node_budget_frac,
        startposes_prob=startposes_prob,
        hintposes_prob=hintposes_prob,
        side_position_prob=spc.side_position_prob,
        side_position_capacity=max(
            cap_round * 2,
            -(-int(spc.batch_size * spc.moves_per_segment * spc.side_position_prob * 2) // cap_round) * cap_round,
        ),
        early_fork_game_prob=spc.early_fork_game_prob,
        fork_game_prob=spc.fork_game_prob,
        record_tree_positions=spc.record_tree_positions,
        record_tree_threshold=spc.record_tree_threshold,
        record_tree_target_weight=spc.record_tree_target_weight,
    )
    if world > 1:
        fork_cap = -(-settings.fork_pool_capacity // cap_round) * cap_round
        settings = dataclasses.replace(settings, side_position_capacity=settings.side_position_capacity // world,
                                       fork_pool_capacity=fork_cap // world)
    states = init_state(cfg, batch, dev)
    ep = torch.zeros((batch,), dtype=torch.int64, device=dev)
    use_game_forks = settings.early_fork_game_prob > 0.0 or settings.fork_game_prob > 0.0
    fork_pool = init_fork_pool(cfg, settings.fork_pool_capacity, dev) if use_game_forks else None
    fork_rng = np.random.default_rng((spc.seed ^ 0x5EEDF04C) + rank)
    who = f"selfplay rank {rank}" if world > 1 else "selfplay"

    def over_ranks(*counts: int) -> list[int]:
        # the counts summed over the ranks, one all-reduce
        if world == 1:
            return list(counts)
        return mesh.all_reduce_sum(torch.tensor(counts, dtype=torch.int64, device=dev)).tolist()

    current_model_dir = None
    eval_fn = uniform_eval_fn(cfg)
    model_name = "random"
    writer = sgf_dir = side_state = None
    rows = total_rows = games_done = seg = 0
    pending: list[Trajectory] = []
    t_start = time.monotonic()

    def build_for_model():
        nonlocal writer, sgf_dir, side_state
        out_base = os.path.join(base_dir, "selfplay", model_name)
        tag = f"_{spc.data_tag}" if spc.data_tag else ""
        sgf_dir = os.path.join(out_base, "sgfs" + tag)
        os.makedirs(sgf_dir, exist_ok=True)
        writer = TrainingDataWriter(os.path.join(out_base, "tdata" + tag), cfg, spc.max_rows_per_file)
        if settings.side_position_prob > 0.0:
            side_state = init_side_state(cfg, settings.side_position_capacity, dev)

    def flush_pending():
        nonlocal pending, rows, games_done, fork_pool
        if not pending:
            return
        res = flush_window(cfg, settings, pending, writer, eval_fn=eval_fn, fork_pool=fork_pool, fork_rng=fork_rng,
                           sgf_dir=sgf_dir if spc.write_sgfs else None, model_name=model_name, seg=seg, device=dev,
                           generator=generator, walls=walls, rank=rank if world > 1 else None)
        pending = []
        rows += res.rows
        games_done += res.games
        fork_pool = res.fork_pool

    try:
        while True:
            if seg % spc.poll_every_segments == 0:
                t0 = time.monotonic()
                latest = mesh.broadcast_object_from_zero(find_latest_model(models_dir) if rank == 0 else None)
                _tick(walls, "poll", t0, dev)
                if latest != current_model_dir:
                    if writer is not None:
                        # rows generated under the old model land in its
                        # dirs (selfplaymanager.h:24)
                        flush_pending()
                        writer.flush()
                    t0 = time.monotonic()
                    current_model_dir = latest
                    if latest is None:
                        eval_fn = uniform_eval_fn(cfg)
                        model_name = "random"
                    else:
                        model, mcfg, meta = load_exported_model(latest, dev)
                        if mcfg != cfg:
                            raise ValueError(f"model {latest} is for {mcfg}, daemon runs {cfg}")
                        # random symmetry per evaluation, as the reference's
                        # selfplay configs set nnRandomize
                        eval_fn = make_nn_eval_fn(cfg, model, symmetry_randomize=True, generator=generator)
                        model_name = meta["name"]
                    build_for_model()
                    _tick(walls, "poll", t0, dev)
                    logger.write(f"{who}: using model {model_name}")
            if writer is None:
                build_for_model()

            t0 = time.monotonic()
            out = run_selfplay_segment(cfg, sp, settings, eval_fn, states, ep, spc.moves_per_segment, device=dev,
                                       generator=generator, startpos_pool=startpos_pool, hintpos_pool=hintpos_pool,
                                       fork_pool=fork_pool)
            if use_game_forks:
                states, ep, traj, fork_pool = out
            else:
                states, ep, traj = out
            _tick(walls, "segment", t0, dev)
            if side_state is not None:
                # the segment's queued side positions, one more search
                t0 = time.monotonic()
                side_state, side_batch = run_side_segment(cfg, sp, settings, eval_fn, side_state, traj, device=dev,
                                                          generator=generator)
                rows += writer.add_batch(side_batch)
                _tick(walls, "side", t0, dev)
            pending.append(traj)
            seg += 1

            # a stop request ends every rank at the same segment: over
            # several ranks it travels with the row count
            done_now = (spc.max_segments is not None and seg >= spc.max_segments) or (world == 1 and stop_requested[0])
            if len(pending) >= spc.segments_per_flush or done_now:
                flush_pending()
                dt = time.monotonic() - t_start
                parts = "" if walls is None else "; seconds so far: " + ", ".join(
                    f"{k} {sum(v):.3f}" for k, v in walls.items())
                logger.write(f"{who}: seg {seg} rows {rows} games {games_done} "
                             f"({rows / max(dt, 1e-9):.1f} rows/s{parts})")
            total_rows, stops = over_ranks(rows, int(stop_requested[0]))
            if done_now or stops:
                break
            if spc.max_rows is not None and total_rows >= spc.max_rows:
                flush_pending()
                break

        flush_pending()
        writer.flush()
        total_rows = over_ranks(rows)[0]
    finally:
        for sig, handler in kept_handlers.items():
            signal.signal(sig, handler)
    return total_rows


def _daemon_rank(base_dir, cfg, sp, spc, logger, install_signal_handlers, timed):
    """One rank of `launch_local`'s daemon: (rows of the whole run, this
    rank's walls or None)."""
    walls = {} if timed else None
    return run_selfplay_daemon(base_dir, cfg, sp, spc, logger, install_signal_handlers, walls=walls), walls


def run_mixed_selfplay(
    base_dir: str,
    size_configs: list,  # [(GameConfig, rel_prob)]
    sp: SearchParams,
    spc: SelfplayConfig,
    logger: Logger | None = None,
    rows_per_pass: int = 20000,
    max_passes: int | None = 1,
    *,
    device: str | torch.device | None = None,
) -> int:
    """Mixed-board-size selfplay (JAX selfplay.py:460; the reference's
    GameInitializer bSizes, play.cpp:93-142): per pass, one daemon stint
    per size with a row quota proportional to its relative probability,
    into per-size data dirs tagged `<X>x<Y>w<W>`. Returns total rows."""
    logger = logger or Logger(log_to_stdout=True)
    total_prob = sum(p for _, p in size_configs)
    total_rows = 0
    passes = 0
    while max_passes is None or passes < max_passes:
        for i, (cfg, prob) in enumerate(size_configs):
            quota = max(int(rows_per_pass * prob / total_prob), 1)
            tag = f"{cfg.x_size}x{cfg.y_size}w{cfg.win_len}"
            spc_i = dataclasses.replace(spc, data_tag=tag, max_rows=quota, max_segments=None,
                                        seed=spc.seed + 1009 * passes + 101 * i)
            logger.write(f"selfplay-mixed: pass {passes} size {tag} quota {quota} rows")
            total_rows += run_selfplay_daemon(base_dir, cfg, sp, spc_i, logger, device=device)
        passes += 1
    return total_rows


def main(argv, *, device: str | torch.device | None = None, walls: dict | None = None) -> None:
    """Entry for `python -m katacoffee_tpu_torch selfplay` (JAX
    selfplay.py:509): the same flags and config keys. Runs on `device`
    (default `cuda`); `walls` collects the daemon's seconds by part. Under
    torchrun (`--nproc-per-node N`) each process joins the group as one
    rank of the daemon."""
    dev = resolve_device(device)
    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch selfplay")
    ap.add_argument("-output-dir", required=True)
    ap.add_argument("-config", default=None)
    ap.add_argument("-override-config", default=None)
    args = ap.parse_args(argv)

    c = ConfigParser(args.config, overrides=args.override_config) if args.config else ConfigParser(text="")
    if args.override_config and not args.config:
        c.apply_overrides(args.override_config)
    cfg = GameConfig(c.get_int("xSize", 5), c.get_int("ySize", 5), c.get_int("winLen", 4))
    sp = SearchParams.for_selfplay()
    spc = SelfplayConfig(
        batch_size=c.get_int("numParallelGames", 256),
        num_sims=c.get_int("maxVisits", 600),
        moves_per_segment=c.get_int("movesPerSegment", 16),
        segments_per_flush=c.get_int("segmentsPerFlush", 4),
        max_segments=c.get_int("maxSegments", 0) or None,
        max_rows=c.get_int("maxRows", 0) or None,
        seed=c.get_int("seed", 0),
        startposes_dir=c.get_string("startPosesFromSgfDir", "") or None,
        startposes_prob=c.get_float("startPosesProb", 0.0),
        startposes_turn_weight_lambda=c.get_float("startPosesTurnWeightLambda", 0.0),
        side_position_prob=c.get_float("sidePositionProb", 0.020),
        early_fork_game_prob=c.get_float("earlyForkGameProb", 0.040),
        fork_game_prob=c.get_float("forkGameProb", 0.010),
        hintposes_dir=c.get_string("hintPosesFromSgfDir", "") or None,
        hintposes_prob=c.get_float("hintPosesProb", 0.0),
        record_tree_positions=c.get_bool("recordTreePositions", False),
        record_tree_threshold=c.get_int("recordTreeThreshold", 0),
        record_tree_target_weight=c.get_float("recordTreeTargetWeight", 0.0),
        node_budget_frac=c.get_float("nodeBudgetFrac", 0.3),
    )
    logger = Logger(log_to_stdout=True)
    os.makedirs(args.output_dir, exist_ok=True)
    logger.add_file(os.path.join(args.output_dir, "selfplay.log"))
    mesh.init_distributed(device=dev)
    try:
        # bSizes / bSizeRelProbs (play.cpp:93-142) and bWinLens switch to the
        # mixed-size daemon
        if c.contains("bSizes"):
            sizes = [int(s) for s in c.get_string("bSizes").split(",")]
            rel = ([float(s) for s in c.get_string("bSizeRelProbs").split(",")] if c.contains("bSizeRelProbs")
                   else [1.0] * len(sizes))
            winlens = ([int(s) for s in c.get_string("bWinLens").split(",")] if c.contains("bWinLens")
                       else [min(s, 5) for s in sizes])
            if not (len(sizes) == len(rel) == len(winlens)):
                raise ValueError("bSizes, bSizeRelProbs, bWinLens must align")
            size_configs = [(GameConfig(s, s, w), p) for s, w, p in zip(sizes, winlens, rel)]
            rows_per_pass = c.get_int("rowsPerPass", 20000)
            # maxPasses 0 (or absent) runs forever, like the reference's loop
            max_passes = c.get_int("maxPasses", 0) or None
            c.warn_unused(logger)
            run_mixed_selfplay(args.output_dir, size_configs, sp, spc, logger, rows_per_pass=rows_per_pass,
                               max_passes=max_passes, device=dev)
            return
        c.warn_unused(logger)
        run_selfplay_daemon(args.output_dir, cfg, sp, spc, logger, install_signal_handlers=True, device=dev,
                            walls=walls)
    finally:
        mesh.destroy_distributed()
        logger.close()
