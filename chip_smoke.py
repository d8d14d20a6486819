#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (`katacoffee_tpu_torch`) on one NVIDIA GPU and
checks it. Usage, from the root of the repository:

    python3 chip_smoke.py

Phases, each printed with the seconds since start; the first failure ends
the run with a non-zero exit and a traceback:
  0. arm a 1160 s watchdog (1100 until the H100 hosts were seen to run
     the script 1.3x slower than one another); print the card (nvidia-smi) and torch's version;
     turn TF32 off so float32 means float32 in every comparison;
  1. build the two CUDA kernels and the empty kernel (the launch floor)
     from the repo's sources, the nvcc runs at once, and print their
     register, shared memory and spill counts;
  2. the launch floor: the empty kernel timed as the gather is (a CUDA
     graph) and as the descent is (events around one launch); each kernel
     against its plain torch version: the child-stats gather
     exactly at the search's shapes, timed against the plain version and
     torch.gather; the fused interior descent on copies of mid-search trees
     (B=512 b6c96 5x5, B=64 uniform 9x9, default and a branch profile; a
     B=512 b6c96 tree grown under the selfplay profile with graph search,
     whose links and catch-ups are counted, as it is and with interior
     edges one visit behind their children), equal in every output,
     `caught` included, except games whose first different act is a
     near-tie of the plain version's scores of the two lanes (counted),
     timed on the B=512 default and selfplay trees, with the deepest game's
     level count;
  3. the b6c96 net (`run-s5200`, loaded with numpy) on the card against the
     CPU: float32 within 1e-4 on every head, the bf16 trunk within BF16_ATOL;
  4. the default profile's path: `benchmark_search` at B=512, 600 visits,
     with both kernels' launch counts reset before and read after (one
     descent launch per simulation, at most two gathers per search); then
     B=64 searches of random positions: plain descent with the gather kernel
     against the plain gather (identical), and both kernels against both
     plain versions (identical games counted, total variation within
     TV_MAX); then card against CPU at float32 on B=8;
  5. bench.py's measurement on the port: the
     selfplay actor's `run_selfplay_segment` at B=512, 600 visits, N=182,
     b6c96 bf16, one untimed 2-move segment from empty boards, then 1 timed
     one (4 until the gatekeeper's phase came) carrying states and episode ids (delivered visits/s, per-move
     walls, the actor's share), with the launch counts reset before and
     read after (one descent launch per simulation run) and the readouts
     checked on every move; then the rest of the actor: games that finish
     (B=64 16-move segments at 8 visits, 16 until phase 16 came, until
     every game ended, then finalize_targets)
     with both kernels against both plain versions under one generator seed
     (every field identical), card against CPU at float32 on a B=8 4-move
     segment at 32 visits (64 until phase 15 met a slow host) with the
     same injected draws, and side positions, whole-game
     forks and tree records at B=512 (configs/selfplay.cfg's probabilities)
     with run_side_segment;
  6. the selfplay command (`phase_selfplay_command`): `command.selfplay.main`
     in this process with configs/selfplay.cfg at B=256 and 600 visits on a
     temporary directory whose models/ links run-s5200, depth cut to 1
     segment of 2 moves, with the launch counts reset before and read
     after; each kernel then held against its plain version, and timed, on
     copies of the inputs this run gave it (every gather shape; the trees
     of every 100th descent launch of the moves' B=256 and of the side
     searches' 24 lanes, the one with the most levels of each timed); then
     twice at 8 visits (16 until phase 15 met a slow host, 64 until the
     gatekeeper's phase came) and 2
     segments of 16 moves with one seed: the shards
     read back and checked, the SGFs replayed, both runs' data equal;
  7. the trainer (`phase_trainer`): the port's `shuffle` over phase 6's shards, then
     `command.train.main` with configs/train.cfg (b6c96, B=256, bf16)
     resuming the flagship checkpoint (the JAX trainer's step 5200) for 80
     steps: metrics finite, the checkpoint's step, count and train_step
     advanced, the export loaded and picked by find_latest_model; times a
     step, samples/s, the parts of a step, peak memory and a profile; one
     float32 step on the card against the CPU. The training path launches
     neither kernel (the JAX trainer reaches no Pallas kernel);
  8. the gatekeeper: (a)
     `command.gatekeeper.main` in this process with configs/gatekeeper.cfg
     and `-override-config maxVisits=16` (200 games at 16 visits; 32 until
     phase 15 met a slow host, 64 until the script first met one, 150, the
     config's, until the contribution bus's phase came; b6c96 bf16, for_gatekeeper():
     uncertainty weighting and policy optimism) gating run-s5200 against
     run-s4800, with both kernels' launch counts set to 0 before and read
     after and their inputs copied (`PathCopies`, as in phase 6): wall,
     games/s, plies, searched visits/s, the tally and the decision, every
     SGF replayed to its winner, each kernel held to its plain version on
     the copies and timed, and a profile of a B=100 gating search; (b) a
     float32 gating match of 4 games at 8 visits (8 games until the GTP
     phase came, 32 visits until the analysis phase came, 16 until phase 15
     met a slow host) on the card and
     on the
     CPU with the same injected draws, the same games; (c) one cycle of
     `command.loop.run_loop` at reduced depth (selfplay at 8 visits, 16
     until phase 15 met a slow host, shuffle, 20 train
     steps from the flagship checkpoint, export, a 16-game gate at 8
     visits, 16 until the analysis phase came);
  9. the GTP engine (`phase_gtp`): (a)
     the engine `gtp -config configs/gtp_example.cfg -model run-s5200`
     builds (graph search, noise pruning, uncertainty, subtree bias, root
     symmetry pruning; its 400 visits cut to 200 and the ponder's 200 to
     100 until the script met a slow host) over a scripted session (two
     genmoves, four until the analysis phase came,
     kata-analyze with ownership, again with an avoid of its best move,
     kata-raw-nn, genmove_debug), with both kernels' launch counts set to 0
     before and read after and their inputs copied (`PathCopies`): the
     replies, seconds and root visits/s of each genmove, a B=1 profile;
     one genmove through the command in a subprocess, run beside the
     session since the script met a slow host; a ponder and a
     genmove that starts from it; (b) each kernel held to its plain version
     on the copies and timed, the descent also with an avoid_until mask
     forbidding lanes at depths 1 and more (lanes hit counted) and with one
     forbidding every lane (ignored); (c) a float32 engine's genmoves on
     the card and on the CPU, the same moves and visits;
 10. the analysis engine (`phase_analysis`): (a) the engine `analysis
     -model run-s5200` builds (for_tests_v2(), seed 0) over a script
     through `run()`: a whole-game review of REF_SGFS game 0 (plies 0-20
     as one search at B=21, 400 visits, ownership, policy, PV visits),
     twelve one-position queries at 200 visits merged into one search
     padded from 12 lanes to 16 (one
     avoiding moves to depth 3, one allowing two), a query streamed every
     0.5 s at 200 visits and one terminated while pending, with
     `PathCopies` entered around it: the seconds and root visits/s of each
     search call with its lanes and batch, num_search_calls (3), the
     reports checked, a B=16 profile (host reads and stream syncs a
     playout); (b) each kernel held to its plain version on the copies,
     padding lanes included, and timed, the forbidden lanes of the two
     restricted lanes counted; (c) a float32 engine on the card and on the
     CPU, the same reports within ANALYSIS_TOL; (d) the command in a
     subprocess fed two queries on a pipe, `evalsgf` and `genconfig -model`
     in process (its benchmark cut to one timed search);
 11. the opening book, the main path since it was ported (`phase_book`):
     (a) `genbook -model run-s5200` in process (b6c96 bf16, for_tests_v2(),
     `-batch-size 64`): the book grown by 4 rounds at 16 visits, then 1
     `-resume` round at the command's width, `-visits 300` (N=302), over
     64 frontier lanes, with `PathCopies` entered around it (depth cut from
     10 rounds at 300 visits): each round's wall, lanes, batch, root
     visits/s, seconds outside `run_search` and nodes; one descent launch
     a playout and at most two gathers a search; writebook, checkbook (no
     errors), booktoposes (every position read back as a start position);
     a profile of a B=64 search of the book's frontier (N=302); (b) each
     kernel held to its plain version on the B=64 round's copies and timed
     (the gather at (64,302,8,100), the descent on the deepest copied
     tree); (c) a float32 book on the card and on the CPU (batch 8, 16
     visits, 2 rounds), the same keys and edges, floats within BOOK_TOL;
     (d) dataminesgfs (one B=64 batch at 200 visits over REF_SGFS's
     games), demoplay (1 game at 8 visits; 16 until phase 16 came),
     trystartposes over
     datamine's output, sampleinitializations -evaluate,
     perfcount.search_counters (B=64, 64 visits, 3 moves) and
     flops_accounting with a B=64 forward's share of the bf16 peak; (e)
     the reference net (refbuild_patches/make_model.py's random b6c96)
     against the refnn fixtures on the card, card against CPU within
     REF_TOL, a B=64 search at 100 visits with make_ref_eval_fn, profiled
     with the line features' launches apart, all with TF32 on for the
     caller;
 12. the contribution bus and two ranks, the main path since they were
     ported (`phase_contribute`): (a) a `ContributionServer` in a thread
     over a base dir whose models/ links run-s5200 (the server's width,
     B=64, b6c96 bf16, for_selfplay(); 16 visits, cut from 600, so that
     every game ends inside one 26-move cycle) and a `ContributeClient` on
     the card running one cycle with `PathCopies` entered around it (one
     descent launch a playout, at most two gathers a search): wall, rows,
     rows/s, seconds uploading, the shard read back with the JAX schema's
     keys and dtypes, every SGF replayed to its winner; (b) each kernel
     held to its plain version on (a)'s copies and timed; (c) a rating
     task (run-s4800 added, 8 games at 16 visits), the server's SGFs
     tallied by `summarize_sgfs` to the client's result; (d) `contribute
     -max-cycles 1` in a subprocess (16 games at 8 visits), exit 0 and its
     rows stored; (e) two ranks through `launch_local` (NCCL over two GPUs
     where two are visible, else gloo on cuda:0, printed): 10 float32
     b6c96 steps at a global B=256 from the flagship checkpoint on phase
     7's shuffled rows against one process's with the same draws (within
     RANKS_TOL, the ranks bit-equal), then the daemon at a global B=64,
     16 visits, 1 segment of 26 moves, both ranks' shards and SGFs read
     back; (e) runs beside (c), in a thread. Paid for by phase 8 (a)'s
     gate, cut from 150 visits to 64, then to 32 with phase 9's session;
 13. profiles of a short B=512 search under both profiles and with the
     selfplay command's symmetry-randomizing evaluator (device busy share,
     launches and host syncs per playout), and that evaluator's cost in
     2 alternated pairs (3 until the book's phase came); every profile of
     phases 8-13 runs 5 playouts (10 until the book's B=64 round came,
     the profiler's own processing being most of a profile's wall);
 15. K playouts a round, the catch-up leak and the gaussian evaluator,
     the main path since they were ported (`phase_search_threads`, after
     13): (a) `for_selfplay()` searches at B=64, 200 visits (b6c96 bf16),
     with numSearchThreads 1, 2 and 4 on the same roots, each a fresh
     search and one reused move inside `PathCopies` (one descent launch a
     round, one root gather a search), then the leak at 0.1 with K = 1 and
     2: rounds, wall and root visits/s; (b) each kernel held to its plain
     version on (a)'s copies and timed, the rows of B*K and the leak
     instantiations among them, then the leak on each run's largest copied
     tree with its edges of two or more visits one visit behind (catch-ups
     counted with and without it); (c) a float32 K=2 search (B=8, 64
     visits) on the card and the CPU with the same root draws; (d) one
     genmove of the GTP engine at 200 visits with numSearchThreads 4 by
     -override-config, and a B=64 200-visit search under
     `gaussian_prior_eval_fn`, their launches counted;
 16. the paths no earlier phase ran (`phase_rectangles`, after 15): (a)
     a 5x7 board (win 4) through `run_search` at B=64, 200 visits, with
     the tiny net (tests/goldens/tinynet, bf16, for_selfplay()) and the
     uniform evaluator, inside `PathCopies`, then each whole search at 64
     visits with both kernels and with both plain versions, each kernel
     held to its plain version on the copies and timed; (b) the selfplay
     command with bSizes 4,5 (B=32, 8 visits, quotas of 500 and 1000
     rows), `shuffle` per size and `run_training_mixed` for 20 steps; (c)
     kill and resume: the daemon (run-s5200, B=64, 8 visits, 256-row
     shards) and `python -m katacoffee_tpu_torch train` (b1c6) as process
     groups on the card, each killed by SIGKILL and started again, in a
     thread beside (a), (b) and (d): seconds to the first shard and the
     first checkpoint after each start, the step resumed; (d) GTP on
     `boardsize 5:7` and `kata-raw-nn` twice, the second from the cache
     with no kernel launched. Paid for by phase 5's finishing games, cut
     from 16 visits to 8, and phase 11's demoplay, from 16 visits to 8;
 14. one log line a timed kernel row (us, bound, launch floor, library
     call; for the descent the deepest game's levels and us a level over
     the floor); the trainer's, the GTP engine's, the analysis engine's,
     the gatekeeper's, the book's, the contribution bus's, phase 15's and
     phase 16's numbers as one JSON line each, the kernel table as one JSON line
     (launches and check from phase 12 (a), times on its copies, the
     earlier paths' launches and the other shapes and trees beside them,
     each row with `floor_ms`, each descent row with `max_levels` and
     `us_per_level`; then a row for each of phase 15's descent
     instantiations, rows of K = 2 and K = 4 and the leak with one and two
     playouts a round, each with its own run's launches and timed copy,
     and the gather and descent rows of phase 16's rectangle),
     then the result line; then the process leaves by `os._exit` with
     main's code, its output flushed and every process it started ended,
     without the interpreter's teardown (a teardown of this process, after
     its last line, has hung until the watchdog with the main thread in no
     Python frame).

Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import faulthandler
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

T0 = time.monotonic()
MODEL_DIR = "artifacts/flagship_b6c96/models/run-s5200"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # H100 SXM data sheet, dense
KERNEL_SHAPES = ((16, 64, 8, 24), (8, 130, 8, 100), (512, 182, 8, 100), (512, 602, 8, 100), (512, 602, 8, 20))
TIMED_SHAPES = ((512, 182, 8, 100), (512, 602, 8, 100), (512, 602, 8, 20))
EMPTY_KERNEL = "katacoffee_tpu_torch/ops/empty_kernel.cu"
# A kernel-vs-plain descent may pick another lane only where the plain
# version scores the kernel's lane below its own by at most this (and not
# equal): sums of float32 lanes in another order differ in the last bits of
# scores of order one.
NEAR_TIE = 1e-6
FP32_ATOL = 1e-4
# The bf16 trunk rounds activations to 8 mantissa bits (2^-9 relative); one
# rounding of a policy logit of |20| is ~0.04 and the trunk stacks ~20
# rounded layers. A few times that passes bf16 rounding and fails a wrong
# cast; the float32 check pins the weights. PERF.md records the choice.
BF16_ATOL = 0.25
TV_MAX = 0.02


def log(msg: str) -> None:
    print(f"[{time.monotonic() - T0:7.1f}s] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def eager_ms(fn, iters: int = 200) -> float:
    """Per-call time of back-to-back eager calls between CUDA events: the
    host's launch rate when the host is slower than the device."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls: int = 100, replays: int = 5) -> float:
    """Per-call device time: `calls` calls captured in one CUDA graph and
    replayed, so no host launch cost is in the window."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def event_ms(launch, reps: int = 30, prepare=None) -> float:
    """Device time of one call of `launch` between CUDA events, a sleep
    kernel queued first so that the host's launch cost stays out of the
    window, and `prepare()`, where given, called before the sleep; the
    median of `reps`, in ms."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        if prepare is not None:
            prepare()
        torch.cuda._sleep(1_000_000)
        start.record()
        launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def launch_floor() -> dict:
    """The card's launch floor: the empty kernel of EMPTY_KERNEL timed as
    the gather is (`device_ms`: launches replayed in a CUDA graph) and as the
    descent is (`event_ms`: events around one launch). In ms."""
    import ctypes

    import torch

    from katacoffee_tpu_torch.ops._build import load_library

    lib = load_library(Path(EMPTY_KERNEL).resolve())
    lib.kc_empty.argtypes = [ctypes.c_void_p]
    lib.kc_empty.restype = ctypes.c_int

    def launch():
        err = lib.kc_empty(torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the empty kernel did not launch: error {err}")

    launch()
    torch.cuda.synchronize()
    floor = {"graph_ms": device_ms(launch), "event_ms": event_ms(launch)}
    log(f"launch floor (an empty kernel): {floor['graph_ms'] * 1e3:.2f} us a launch replayed in a CUDA graph, "
        f"{floor['event_ms'] * 1e3:.2f} us between events around one launch")
    return floor


def gather_inputs(shape, dev, seed: int):
    """Random stats table and child indices: ~30 % -1, a few >= N."""
    import torch

    B, N, S, A = shape
    g = torch.Generator().manual_seed(seed)
    table = torch.randn((B, N, S), generator=g)
    idx = torch.randint(0, N, (B, A), generator=g, dtype=torch.int32)
    idx[torch.rand((B, A), generator=g) < 0.3] = -1
    idx[torch.rand((B, A), generator=g) < 0.02] = N + 3
    return table.to(dev), idx.to(dev)


def gather_bound_ms(table, idx) -> float:
    """Least time for the gather at the HBM rate: each index read once, each
    distinct in-range row read once, each output row written once."""
    import torch

    B, N, S = table.shape
    valid = (idx >= 0) & (idx < N)
    rows = torch.unique((torch.arange(B, device=idx.device)[:, None] * N + idx)[valid]).numel()
    nbytes = idx.numel() * 4 + rows * S * 4 + idx.numel() * S * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_kernel(dev) -> dict:
    import torch

    from katacoffee_tpu_torch.ops.gather import gather_rows, gather_rows_plain

    max_err = 0.0
    for i, shape in enumerate(KERNEL_SHAPES):
        table, idx = gather_inputs(shape, dev, seed=i)
        got = gather_rows(table, idx)
        want = gather_rows_plain(table, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"gather_rows != gather_rows_plain at {shape}")
        max_err = max(max_err, (got - want).abs().max().item())
        log(f"kernel == plain at (B,N,S,A)={shape}")
    timings = {shape: time_gather(*gather_inputs(shape, dev, seed=99)) for shape in TIMED_SHAPES}
    return {"max_abs_err": max_err, "timings": timings}


def time_gather(table, idx, label: str = "") -> dict:
    """Device time per call of the gather kernel, its plain version and
    torch.gather on (table, idx), the bound from these inputs, and the
    kernel's per-call time when launched eagerly. In ms."""
    import torch

    from katacoffee_tpu_torch.ops.gather import gather_rows, gather_rows_plain

    B, N, S = table.shape
    A = idx.shape[1]
    expanded = idx.clamp(0, N - 1).to(torch.int64)[:, :, None].expand(B, A, S).contiguous()
    t = {
        "ms": device_ms(lambda: gather_rows(table, idx)),
        "plain_ms": device_ms(lambda: gather_rows_plain(table, idx)),
        "library_ms": device_ms(lambda: torch.gather(table, 1, expanded)),
        "bound_ms": gather_bound_ms(table, idx),
        "eager_ms": eager_ms(lambda: gather_rows(table, idx)),
    }
    log(
        f"{label}(B,N,S,A)={(B, N, S, A)} device time per call: kernel {t['ms'] * 1e3:.2f} us, "
        f"plain {t['plain_ms'] * 1e3:.2f} us, torch.gather {t['library_ms'] * 1e3:.2f} us, "
        f"bound {t['bound_ms'] * 1e3:.2f} us; kernel launched eagerly {t['eager_ms'] * 1e3:.2f} us"
    )
    return t


def random_positions(cfg, batch: int, seed: int):
    """`batch` positions on the CPU after 0..15 random legal plies."""
    import numpy as np
    import torch

    from katacoffee_tpu_torch.game import board as B

    rng = np.random.default_rng(seed)
    s = B.init_state(cfg, batch, "cpu")
    plies = torch.from_numpy(rng.integers(0, 16, batch))
    for ply in range(16):
        legal = B.legal_mask_flat(cfg, s).numpy()
        act = torch.from_numpy((rng.random(legal.shape) * legal).argmax(-1))
        new = B.step(cfg, s, act)
        keep = ply < plies
        s = B.GameState(*(
            torch.where(keep.reshape((batch,) + (1,) * (o.dim() - 1)), n, o) for o, n in zip(s, new)
        ))
    return s


def ending_positions(cfg, batch: int, seed: int):
    """`batch` positions on the CPU 1-4 plies before the end of a random
    legal game, so that games end within a few moves."""
    import numpy as np
    import torch

    from katacoffee_tpu_torch.game import board as B

    rng = np.random.default_rng(seed)
    out = []
    while len(out) < batch:
        s, line = B.init_state(cfg, 1, "cpu"), []
        while not bool(s.done[0]):
            line.append(s)
            legal = torch.nonzero(B.legal_mask_flat(cfg, s)[0])[:, 0]
            s = B.step(cfg, s, legal[int(rng.integers(len(legal)))].reshape(1))
        out.append(line[max(0, len(line) - int(rng.integers(1, 5)))])
    return B.GameState(*(torch.cat(f) for f in zip(*out)))


def descent_inputs(cfg, sp, tree):
    """The descent inputs of a playout from `tree` after its root level
    (which counts the root edge in `tree.edge_visits`), and a fresh scratch."""
    import torch

    from katacoffee_tpu_torch.search import mcts

    B = tree.stats.shape[0]
    dev = tree.stats.device
    root_cs = mcts._gather_child_stats(
        tree, torch.arange(B, device=dev), torch.zeros((B,), dtype=torch.int64, device=dev)
    )
    max_depth = mcts._max_depth(cfg, sp)
    path, acts, _, node, depth, active, _ = mcts._descend_root(sp, tree, root_cs, max_depth)
    return node, depth, active, path, acts, mcts.make_level_scratch(cfg, B, max_depth, dev)


def run_descent(fn, cfg, sp, tree, start_ev, inputs, avoid_until=None, leak_u=None, acts_f=None):
    """`fn` (kernel dispatcher or plain version) on copies of the inputs;
    returns (leaf, leaf_depth, path, acts, edge_visits, *scratch, caught),
    and the flat actions after them for a round's rows (`acts_f`)."""
    import torch

    from katacoffee_tpu_torch.search import mcts

    node, depth, active, path, acts, scratch = inputs
    tree.edge_visits.copy_(start_ev)
    p, a = path.clone(), acts.clone()
    af = None if acts_f is None else acts_f.clone()
    sc = mcts.LevelScratch(*(x.clone() for x in scratch))
    leaf, leaf_depth, caught = fn(cfg, sp, tree, node, depth, active, p, a, sc, avoid_until, leak_u=leak_u, acts_f=af)
    torch.cuda.synchronize()
    return (leaf, leaf_depth, p, a, tree.edge_visits.clone(), *sc, caught) + (() if af is None else (af,))


def compare_descent(label, cfg, sp, tree, start_ev, inputs, got, want, avoid_until=None) -> tuple[int, float]:
    """Holds a descent's outputs `got` (leaf, leaf_depth, path, acts,
    edge_visits, *scratch, caught) to the plain version's `want` from the same
    `inputs`. A game whose acts agree must agree in every output. A game
    whose acts differ agrees up to its first different act, which the plain
    version recorded too (an active game, a non-terminal node above the depth
    cap), and there the plain version's score of its own lane exceeds its
    score of the other lane by more than 0 and at most NEAR_TIE: equal scores
    go to the lower lane, as torch.argmax does. Leaves `tree.edge_visits` at
    `start_ev`. Returns (games whose acts differ, max |diff| of the float
    outputs of the others). The rows of a round of K playouts a game
    (row r of game r // K) are held the same way, their flat actions too."""
    import torch

    from katacoffee_tpu_torch.search import mcts

    _, depth, active, _, _, _ = inputs
    acts_k, acts_p = got[3], want[3]
    differ = acts_k != acts_p
    flip = differ.any(-1)
    same = ~flip
    err = 0.0
    for i, (x, y) in enumerate(zip(got, want)):
        # a round's rows write no edge visit: the whole tensor is compared
        if not (torch.equal(x, y) if x.shape[0] != same.shape[0] else torch.equal(x[same], y[same])):
            raise AssertionError(f"{label}: descent output {i} differs from plain")
        if x.is_floating_point() and same.any():
            err = max(err, (x[same] - y[same]).abs().max().item())
    tree.edge_visits.copy_(start_ev)
    if not flip.any():
        return 0, err

    B, D = want[5].shape[:2]
    bidx = torch.arange(B, device=acts_p.device)
    gidx = torch.div(bidx, B // tree.stats.shape[0], rounding_mode="floor")  # each row's game
    first = differ.to(torch.int8).argmax(-1)
    path_k, path_p = got[2], want[2]
    cols = torch.arange(D + 1, device=acts_p.device)[None, :]
    if not torch.equal(path_k[flip][(cols <= first[:, None])[flip]],
                       path_p[flip][(cols <= first[:, None])[flip]]):
        raise AssertionError(f"{label}: a game's path differs before its first different act")
    before = (cols[:, :D] < first[:, None])[flip]  # slot j <-> depth j + 1
    for i in range(5, 5 + len(mcts.LevelScratch._fields)):
        if not torch.equal(got[i][flip][before], want[i][flip][before]):
            raise AssertionError(f"{label}: scratch output {i} differs above the first different act")
    # edge visits agree outside the rows of the nodes from that depth down
    beyond = torch.zeros(tree.edge_visits.shape[:2], dtype=torch.bool, device=acts_p.device)
    for p in (path_k, path_p):
        m = (cols >= first[:, None]) & (p >= 0) & flip[:, None]
        beyond[gidx[:, None].expand_as(p)[m], p[m]] = True
    games = torch.zeros(tree.stats.shape[0], dtype=torch.bool, device=acts_p.device)
    games[gidx[flip]] = True
    if not torch.equal(got[4][~beyond & games[:, None]], want[4][~beyond & games[:, None]]):
        raise AssertionError(f"{label}: edge visits differ off the paths below the first different act")

    at = path_p[bidx, first].clamp(min=0)
    recorded = active & (first >= depth) & (first <= want[1]) & (first < D) & ~tree.is_terminal[gidx, at]
    lane_k, lane_p = acts_k[bidx, first], acts_p[bidx, first]
    _, _, sel = mcts._interior_level(cfg, sp, tree, gidx, at, first, avoid_until)
    C = sel.shape[1]
    in_range = (lane_k >= 0) & (lane_k < C)
    gap = sel[bidx, lane_p] - sel[bidx, lane_k.clamp(0, C - 1)]
    ok = recorded & in_range & (gap > 0) & (gap <= NEAR_TIE)
    log(f"  {label}: plain-score gaps at the first different act {gap[flip].tolist()}")
    if not ok[flip].all():
        raise AssertionError(
            f"{label}: the descent picked another lane than the plain version where its scores do not "
            f"differ by more than 0 and at most {NEAR_TIE} (an equal score goes to the lower lane)"
        )
    return int(flip.sum()), err


def forbidden_lanes(cfg, tree, inputs, out, avoid_until) -> list[int]:
    """Each game's legal lanes that `avoid_until` forbade, with the mask
    kept (some legal lane of the node left), on the levels a descent `out`
    (the plain version's outputs) recorded: the lanes its kernel had to
    score -inf."""
    import torch

    from katacoffee_tpu_torch.search import mcts

    node, depth, active, _, _, scratch = inputs
    leaf_depth, path, prior_c = out[1], out[2], out[6]
    B, D, _ = scratch.child_c.shape
    bidx = torch.arange(B, device=node.device)
    hits = torch.zeros(B, dtype=torch.int64, device=node.device)
    for d in range(1, D):
        on = active & (depth <= d) & (d <= leaf_depth)
        if not bool(on.any()):
            continue
        at = path[:, d].clamp(min=0)
        cand, valid = mcts._cand_lanes(cfg, tree.states, bidx, at)
        pidx = (tree.states.to_move[bidx, at].to(torch.int64) - 1).clamp(0, 1)
        forbid = mcts._compact_row(avoid_until[bidx, pidx], cand, valid, 0) > d
        legal = prior_c[:, d - 1] >= 0
        keep = (legal & ~forbid).any(-1, keepdim=True)
        hits += (forbid & legal & keep & on[:, None]).sum(-1)
    return hits.tolist()


def descent_bound_ms(cfg, tree, inputs, out, sp=None, avoid_until=None, leak=False) -> float:
    """Least time for this descent at the HBM rate, each byte the kernel must
    read or write counted once, from the levels this run's data needs. Per
    level: the node's terminal flag and last move (17 B), 12 B per candidate
    (child, edge visits, prior), 32 B per present child's stats row, the
    scratch slot written (44 B a lane); per non-terminal level the node's own
    utility (4 B) and the act (8 B), and on the game's first level its stats
    row (32 B; deeper nodes' rows were read as the level above's child row).
    Each distinct candidate-table row once (2 B a lane); per step 8 B of path
    and the 4 B edge-visit write (its read is the candidate's); per game 17 B
    in and 17 B out (leaf, depth, caught). With noise pruning (`sp`) 4 B a
    candidate's rank read and 4 B a lane's rank_c written; with `avoid_until`
    4 B a candidate's avoid depth and 1 B a game's first mover; with `leak`
    4 B a level's draw. A round's rows (more rows than games) write an 8 B
    flat action a recorded level and no edge visit, and the rows of a game
    read one tree: the reads of a node (its fields, candidates, children's
    stats rows, utility, first stats row, ranks and avoid depths) count
    once for each distinct (game, node), the per-row writes for each row."""
    import torch

    from katacoffee_tpu_torch.search import mcts

    node, depth, active, _, _, scratch = inputs
    leaf_depth, out_path, out_child_c = out[1], out[2], out[7]
    B, D, C = scratch.child_c.shape
    rows = B != tree.stats.shape[0]
    bidx = torch.div(torch.arange(B, device=node.device), B // tree.stats.shape[0], rounding_mode="floor")[:, None]
    last = torch.where(leaf_depth < D, leaf_depth, leaf_depth - 1)
    slots = torch.arange(D, device=node.device)[None, :]  # slot j <-> depth j + 1
    done = active[:, None] & (slots >= depth[:, None] - 1) & (slots <= last[:, None] - 1)
    nodes = out_path[:, 1:].clamp(min=0)
    spot = tree.states.last_spot[bidx, nodes]
    spot = torch.where((spot < 0) | (spot > cfg.area), cfg.area, spot)
    row = spot * 5 + tree.states.last_dir[bidx, nodes].clamp(0, 4)
    table_rows = torch.unique(row[done]).numel()
    # once[r, j]: the first of the recorded levels that read game bidx[r]'s node (all of them, one row a game)
    key = torch.where(done, bidx * tree.stats.shape[1] + nodes, -1).flatten()
    _, inv = torch.unique(key, return_inverse=True)
    pos = torch.arange(key.numel(), device=node.device)
    at = torch.full((int(inv.max()) + 1,), key.numel(), device=node.device).scatter_reduce(0, inv, pos, "amin")
    once = torch.zeros(key.numel(), dtype=torch.bool, device=node.device)
    once[at] = True
    once = once.view_as(done) & done
    cand = mcts._cand_table(cfg, node.device).reshape(-1, C)[row]
    nonterm = done & ~tree.is_terminal[bidx, nodes]
    first = nonterm & once & (slots == depth[:, None] - 1)
    levels, nodes_read = int(done.sum()), int(once.sum())
    valid = int(((cand >= 0) & once[..., None]).sum())
    present = int(((out_child_c >= 0) & once[..., None]).sum())
    steps = int(torch.where(active, leaf_depth - depth, 0).sum())
    nbytes = (nodes_read * 17 + levels * 44 * C + int((nonterm & once).sum()) * 4
              + int(nonterm.sum()) * (16 if rows else 8) + int(first.sum()) * 32
              + table_rows * 2 * C + valid * 12 + present * 32 + steps * (8 if rows else 12) + B * 34)
    if sp is not None and sp.useNoisePruning:
        nbytes += valid * 4 + levels * 4 * C
    if avoid_until is not None:
        nbytes += valid * 4 + int(active.sum())
    if leak:
        nbytes += levels * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def time_descent(cfg, sp, tree, start_ev, inputs, reps: int = 30, avoid_until=None, leak_u=None, acts_f=None):
    """Device time of one kernel launch by `event_ms` (as the launch floor
    is timed) and the plain version's wall time per call, both on the same
    snapshot restored before each call. Medians, in ms."""
    import torch

    from katacoffee_tpu_torch.ops.descend import descend_interior
    from katacoffee_tpu_torch.search import mcts

    node, depth, active, path, acts, scratch = inputs
    cand = mcts._cand_table_i16(cfg, node.device)
    p, a = path.clone(), acts.clone()

    def restore():
        tree.edge_visits.copy_(start_ev)
        p.copy_(path)
        a.copy_(acts)

    kernel = event_ms(lambda: descend_interior(sp, cand, tree, node, depth, active, p, a, scratch, avoid_until,
                                               leak_u, acts_f), reps, prepare=restore)
    plain = []
    for _ in range(max(reps // 3, 3)):
        tree.edge_visits.copy_(start_ev)
        p.copy_(path)
        a.copy_(acts)
        torch.cuda.synchronize()
        t = time.perf_counter()
        mcts._descend_interior_plain(cfg, sp, tree, node, depth, active, p, a, scratch, avoid_until, leak_u, acts_f)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t) * 1e3)
    tree.edge_visits.copy_(start_ev)
    return kernel, statistics.median(plain)


def count_links(tree) -> int:
    """Nodes of `tree` that two or more parents link to (transpositions)."""
    import torch

    kids = tree.children.to(torch.int64)
    m = kids >= 0
    b = torch.arange(kids.shape[0], device=kids.device)[:, None, None].expand_as(kids)
    parents = torch.zeros(tree.stats.shape[:2], dtype=torch.int64, device=kids.device)
    parents.index_put_((b[m], kids[m]), torch.ones_like(kids[m]), accumulate=True)
    return int((parents > 1).sum())


def phase_descend(dev, cfg, cfg9, batch=512, sims=300, batch9=64, sims9=200, selfplay_nodes=182, cfg15=None,
                  batch15=32, sims15=100):
    """The fused descent kernel against `_descend_interior_plain` on copies
    of mid-search trees, held by `compare_descent`: B=512 b6c96 and B=64
    uniform 9x9 under the default and a branch profile, with `cfg15` a B=32
    uniform tree of that board (15x15: the candidate table above the 48 KB
    of shared memory a block has without opting in), and a B=512 b6c96
    tree grown under the selfplay profile (graph search, N=182), as it is
    and with every edge of two or more visits out of a node two or more
    plies below the root one visit behind its child (so that descents pass
    the first interior level and stop at catch-ups deeper down). Timed on
    the B=512 trees with the default and the selfplay profile."""
    import torch

    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.search import mcts
    from katacoffee_tpu_torch.search.params import SearchParams

    branch = SearchParams(
        cpuctExploration=1.1, cpuctExplorationLog=0.4, cpuctUtilityStdevScale=0.85,
        cpuctUtilityStdevPrior=0.4, cpuctUtilityStdevPriorWeight=2.0,
        rootDesiredPerChildVisitsCoeff=2.0, rootFpuReductionMax=0.0,
        fpuParentWeightByVisitedPolicy=True, fpuParentWeightByVisitedPolicyPow=2.0,
    )
    selfplay = SearchParams.for_selfplay()
    default_profiles = (("default", SearchParams(), False), ("branch", branch, False))
    selfplay_profiles = (("selfplay", selfplay, False), ("selfplay, deep edges behind", selfplay, True))
    net = mcts.make_nn_eval_fn(cfg, load_exported_model(MODEL_DIR, dev)[0])
    roots = random_positions(cfg, batch, seed=1)
    cases = (
        (f"B={batch} b6c96 5x5", cfg, net, roots, sims, 602, SearchParams(), default_profiles),
        (f"B={batch9} uniform 9x9", cfg9, mcts.uniform_eval_fn(cfg9), random_positions(cfg9, batch9, seed=2),
         sims9, None, SearchParams(), default_profiles),
        (f"B={batch} b6c96 5x5 N={selfplay_nodes}", cfg, net, roots, sims, selfplay_nodes, selfplay,
         selfplay_profiles),
    )
    if cfg15 is not None:
        cases += ((f"B={batch15} uniform {cfg15.x_size}x{cfg15.y_size}", cfg15, mcts.uniform_eval_fn(cfg15),
                   random_positions(cfg15, batch15, seed=4), sims15, None, SearchParams(), default_profiles[:1]),)
    timed = {(cases[0][0], "default"): "default", (cases[2][0], "selfplay"): "selfplay"}
    result = {"flips": 0, "games": 0, "levels": 0, "max_abs_err": 0.0, "timed": {}}
    for label, c, eval_fn, case_roots, case_sims, max_nodes, grow_sp, profiles in cases:
        caught_in_search = torch.zeros((), dtype=torch.int64, device=dev)
        kept = mcts._descend_interior

        def counting(*args, **kwargs):
            out = kept(*args, **kwargs)
            caught_in_search.add_(out[2].sum())
            return out

        mcts._descend_interior = counting
        try:
            tree = mcts.run_search(c, grow_sp, eval_fn, case_roots, case_sims, max_nodes, device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(3))
        finally:
            mcts._descend_interior = kept
        if grow_sp.useGraphSearch:
            links, caught_n = count_links(tree), int(caught_in_search)
            log(f"{label} selfplay tree {case_sims} sims in: {links} transposition links, "
                f"{caught_n} interior catch-ups while it grew")
            if links == 0 or caught_n == 0:
                raise AssertionError(f"{label}: graph search made no links or no catch-ups")
        base_ev = tree.edge_visits.clone()
        for pname, sp, behind in profiles:
            tree.edge_visits.copy_(base_ev)
            if behind:
                ply = tree.states.num_turns - tree.states.num_turns[:, :1]
                ev = tree.edge_visits
                ev -= ((ev >= 2) & (ply >= 2)[:, :, None]).to(ev.dtype)
            inputs = descent_inputs(c, sp, tree)
            start_ev = tree.edge_visits.clone()
            got = run_descent(mcts._descend_interior, c, sp, tree, start_ev, inputs)
            want = run_descent(mcts._descend_interior_plain, c, sp, tree, start_ev, inputs)
            n_flip, err = compare_descent(f"{label} {pname}", c, sp, tree, start_ev, inputs, got, want)
            result["max_abs_err"] = max(result["max_abs_err"], err)
            depth, active = inputs[1:3]
            leaf_depth = want[1]
            capped = leaf_depth < mcts._max_depth(c, sp)
            game_levels = torch.where(active, leaf_depth - depth + capped.long(), 0)
            levels = int(game_levels.sum())
            n_caught = int(want[-1].sum())
            caught_depths = torch.bincount(leaf_depth[want[-1]]).tolist()
            result["flips"] += n_flip
            result["games"] += int(active.sum())
            result["levels"] += levels
            log(
                f"descent kernel == plain: {label} {pname}: {int(active.sum())} games descending, "
                f"{levels} levels, max depth {int(leaf_depth.max())}, {n_caught} catch-ups "
                f"(by depth of the caught node {caught_depths}), {n_flip} near-tie act flips"
            )
            if behind and sum(caught_depths[2:]) == 0:
                raise AssertionError(f"{label} {pname}: no descent stopped at a catch-up two or more levels down")
            key = timed.get((label, pname))
            if key is not None:
                ms, plain_ms = time_descent(c, sp, tree, start_ev, inputs)
                bound = descent_bound_ms(c, tree, inputs, got)
                result["timed"][key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                            timed_levels=levels, max_levels=int(game_levels.max()),
                                            shape=[batch, max_nodes, c.policy_size,
                                                   4 * max(c.x_size, c.y_size)])
                log(
                    f"  descent per call at {label} {pname} ({case_sims} sims in, deepest game "
                    f"{int(game_levels.max())} levels): kernel {ms * 1e3:.2f} us device, plain "
                    f"{plain_ms * 1e3:.1f} us wall, bound {bound * 1e3:.3f} us (bytes)"
                )
        tree.edge_visits.copy_(base_ev)
    return result


def phase_net(dev, cfg, positions):
    import torch

    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.nn.features import extract_features

    spatial, glob = extract_features(cfg, positions)
    with torch.no_grad():
        ref = load_exported_model(MODEL_DIR, "cpu", torch.float32)[0](spatial, glob)
        for dtype, atol in ((torch.float32, FP32_ATOL), (torch.bfloat16, BF16_ATOL)):
            model = load_exported_model(MODEL_DIR, dev, dtype)[0]
            out = model(spatial.to(dev), glob.to(dev))
            worst = 0.0
            for k, v in ref.items():
                got = out[k].float().cpu()
                if got.shape != v.shape or not torch.isfinite(got).all():
                    raise AssertionError(f"{dtype} head {k}: shape {tuple(got.shape)} or non-finite")
                d = (got - v).abs().max().item()
                worst = max(worst, d)
                if d > atol:
                    raise AssertionError(f"{dtype} head {k}: max |card - cpu| {d:.3e} > {atol}")
            log(f"net {dtype} card vs cpu float32: max |diff| over heads {worst:.3e} (atol {atol})")


def phase_search(dev, cfg, positions, bench_batch=512, bench_visits=600, ab_batch=64,
                 ab_visits=100, tv_batch=8, tv_visits=64):
    import torch

    import katacoffee_tpu_torch.search.mcts as mcts
    from katacoffee_tpu_torch.command.benchmark import benchmark_search
    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.ops.descend import descend_interior
    from katacoffee_tpu_torch.ops.gather import gather_rows, gather_rows_plain
    from katacoffee_tpu_torch.search.params import SearchParams

    sp = SearchParams()
    net16 = load_exported_model(MODEL_DIR, dev)[0]
    eval16 = mcts.make_nn_eval_fn(cfg, net16)
    reps = 1
    searches = reps + 1

    gather_rows.launches = 0
    descend_interior.launches = 0
    vps = benchmark_search(cfg, sp, eval16, batch_sizes=(bench_batch,), num_visits=bench_visits,
                           reps=reps, device=dev, log=log)[bench_batch]
    launches = {"gather_rows": gather_rows.launches, "descend_interior": descend_interior.launches}
    per_search = {k: v / searches for k, v in launches.items()}
    log(
        f"main path: B={bench_batch} {bench_visits} visits: {vps:.1f} visits/s, "
        f"{bench_batch * bench_visits / vps * 1e3:.1f} ms/search; launches in {searches} searches: "
        + ", ".join(f"{k} {v} ({per_search[k]:.1f} per search)" for k, v in launches.items())
    )
    if launches["descend_interior"] != searches * bench_visits:
        raise AssertionError(
            f"descend_interior launched {launches['descend_interior']} times, "
            f"not once per simulation ({searches * bench_visits})"
        )
    if not 0 < per_search["gather_rows"] <= 2:
        raise AssertionError(f"gather_rows launched {per_search['gather_rows']} times per search, not 1-2")
    log(f"descend_interior.launches == num_sims per search ({bench_visits}); "
        f"gather_rows launches per search {per_search['gather_rows']:.1f} <= 2")

    live = torch.nonzero(~positions.done)[:ab_batch, 0]
    roots = positions.map(lambda x: x[live])
    variants = {
        "plain descent + gather kernel": (mcts._descend_interior_plain, gather_rows),
        "plain": (mcts._descend_interior_plain, gather_rows_plain),
        "kernels": (mcts._descend_interior, gather_rows),
    }
    kept = (mcts._descend_interior, mcts.gather_rows)
    trees = {}
    for name, (descend_fn, gather_fn) in variants.items():
        mcts._descend_interior, mcts.gather_rows = descend_fn, gather_fn
        try:
            tree = mcts.run_search(cfg, sp, eval16, roots, ab_visits, device=dev)
            trees[name] = (mcts.root_visit_counts(tree).clone(), mcts.root_values(tree))
        finally:
            mcts._descend_interior, mcts.gather_rows = kept
        if not torch.isfinite(tree.stats).all():
            raise AssertionError(f"{name}: non-finite tree stats")
        if not (trees[name][0].sum(-1) == ab_visits).all():
            raise AssertionError(f"{name}: root visits do not sum to {ab_visits}")
    (vk, rk), (vp, rp) = trees["plain descent + gather kernel"], trees["plain"]
    if not torch.equal(vk, vp) or any(not torch.equal(rk[k], rp[k]) for k in rk):
        raise AssertionError("search with the gather kernel differs from search with the plain gather")
    log(f"B={len(live)} {ab_visits} visits, plain descent: gather kernel and plain gather give "
        f"identical root visits and values")
    vk = trees["kernels"][0]
    ab_games = len(live)
    identical = int((vk == vp).all(-1).sum())
    ab_tv = 0.5 * (vk.float() / ab_visits - vp.float() / ab_visits).abs().sum(-1).max().item()
    log(f"B={len(live)} {ab_visits} visits, both kernels vs both plain versions: {identical} of "
        f"{len(live)} games with identical root visits, max total variation {ab_tv:.4f} (max {TV_MAX})")
    if ab_tv > TV_MAX:
        raise AssertionError(f"kernel search differs from plain search: TV {ab_tv} > {TV_MAX}")

    live = torch.nonzero(~positions.done)[:tv_batch, 0]
    roots = positions.map(lambda x: x[live])
    dists = []
    for d in (dev, torch.device("cpu")):
        net32 = load_exported_model(MODEL_DIR, d, torch.float32)[0]
        tree = mcts.run_search(cfg, sp, mcts.make_nn_eval_fn(cfg, net32), roots, tv_visits, device=d)
        v = mcts.root_visit_counts(tree).float().cpu()
        dists.append(v / v.sum(-1, keepdim=True))
    tv = 0.5 * (dists[0] - dists[1]).abs().sum(-1).max().item()
    log(f"B={len(live)} {tv_visits} visits, float32: max total-variation card vs cpu {tv:.4f} (max {TV_MAX})")
    if tv > TV_MAX:
        raise AssertionError(f"root visit distributions differ: TV {tv} > {TV_MAX}")
    return {"vps": vps, "launches": launches, "per_search": per_search, "ab_identical": identical,
            "ab_games": ab_games, "ab_tv": ab_tv}


SELFPLAY_METRIC = "selfplay_delivered_visits_per_sec_b6c96_600visits"


def check_segment(cfg, traj, visits, label) -> None:
    """The readout checks on every move of a segment: finite policy targets
    and values, policy targets summing to 1, legal played moves, visits + 1
    root visits."""
    import torch

    from katacoffee_tpu_torch.game.board import legal_mask_flat

    T, B = traj.played_action.shape
    flat = traj.states.map(lambda x: x.reshape((T * B,) + x.shape[2:]))
    pt = traj.policy_target.reshape(T * B, -1)
    for name in ("policy_target", "root_wl", "root_draw", "raw_policy", "raw_value"):
        if not torch.isfinite(getattr(traj, name)).all():
            raise AssertionError(f"{label}: non-finite {name}")
    if not torch.allclose(pt.sum(-1), torch.ones((), device=pt.device), atol=1e-5):
        raise AssertionError(f"{label}: policy targets do not sum to 1")
    if not legal_mask_flat(cfg, flat)[torch.arange(T * B, device=pt.device), traj.played_action.reshape(-1)].all():
        raise AssertionError(f"{label}: an illegal move was played")
    if not (traj.root_visits == visits + 1).all():
        raise AssertionError(f"{label}: a root does not have {visits + 1} visits")


def phase_selfplay(dev, cfg, batch=512, visits=600, moves=2, segments=1):
    """The slice's main path, bench.py's measurement: `run_selfplay_segment`
    at B=512, SelfplaySettings(num_sims=600) (policy-init openings, tree
    reuse, N=182), for_selfplay, b6c96 bf16, 2-move segments from empty
    boards carrying states and episode ids: one untimed segment, then
    `segments` timed ones. Both kernels' launch counts are reset before the
    timed segments and read after; the simulations, backup levels and each
    search's wall time (between device synchronizations) are counted by
    wrappers around the search's functions."""
    import torch

    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.game.board import init_state
    from katacoffee_tpu_torch.ops.descend import descend_interior
    from katacoffee_tpu_torch.ops.gather import gather_rows
    from katacoffee_tpu_torch.search import mcts
    from katacoffee_tpu_torch.command.selfplay import concat_trajectories
    from katacoffee_tpu_torch.search.params import SearchParams
    from katacoffee_tpu_torch.selfplay.actor import SelfplaySettings, run_selfplay_segment

    sp = SearchParams.for_selfplay()
    settings = SelfplaySettings(num_sims=visits)
    if settings.nodes() != 182 and visits == 600:
        raise AssertionError(f"node budget {settings.nodes()}, not 182")
    evaluate = mcts.make_nn_eval_fn(cfg, load_exported_model(MODEL_DIR, dev)[0])
    generator = torch.Generator(device=dev).manual_seed(0)
    states = init_state(cfg, batch, dev)
    episode = torch.zeros((batch,), dtype=torch.int64, device=dev)
    states, episode, _ = run_selfplay_segment(cfg, sp, settings, evaluate, states, episode, moves, device=dev,
                                              generator=generator)
    torch.cuda.synchronize()

    counts = {"sims": 0, "levels_fresh": 0, "levels_reused": 0, "sims_fresh": 0, "sims_reused": 0}
    walls = {"fresh": [], "reused": []}
    last = {}
    kept = (mcts.run_search, mcts._simulate_once, mcts._recompute_node)
    phase = ["fresh"]

    def search(*args, **kwargs):
        phase[0] = "reused" if kwargs.get("reuse_tree") is not None else "fresh"
        torch.cuda.synchronize()
        t = time.monotonic()
        tree = kept[0](*args, **kwargs)
        torch.cuda.synchronize()
        walls[phase[0]].append(time.monotonic() - t)
        if phase[0] == "reused":
            last.update(tree=tree, args=args, kwargs=kwargs)
        return tree

    def simulate(*args, **kwargs):
        counts["sims"] += 1
        counts["sims_" + phase[0]] += 1
        return kept[1](*args, **kwargs)

    def recompute(*args, **kwargs):
        # one tree level per call: its calls per simulation are the batch's
        # deepest backup path, which sets a playout's host work
        counts["levels_" + phase[0]] += 1
        return kept[2](*args, **kwargs)

    mcts.run_search, mcts._simulate_once, mcts._recompute_node = search, simulate, recompute
    trajs = []
    try:
        gather_rows.launches = 0
        descend_interior.launches = 0
        seg_walls = []
        t = time.monotonic()
        for _ in range(segments):
            states, episode, traj = run_selfplay_segment(cfg, sp, settings, evaluate, states, episode, moves,
                                                         device=dev, generator=generator)
            trajs.append(traj)
            torch.cuda.synchronize()
            seg_walls.append(time.monotonic() - t - sum(seg_walls))
        wall = time.monotonic() - t
        launches = {"gather_rows": gather_rows.launches, "descend_interior": descend_interior.launches}
    finally:
        mcts.run_search, mcts._simulate_once, mcts._recompute_node = kept

    traj = concat_trajectories(trajs)
    check_segment(cfg, traj, visits, "selfplay segment")
    delivered = batch * visits * moves * segments / wall
    search_s = sum(walls["fresh"]) + sum(walls["reused"])
    resets = int(traj.done_after.sum())
    out = {
        "launches": launches, "sims": counts["sims"], "wall_s": wall, "delivered_vps": delivered,
        "segment_walls": seg_walls, "segment_sims": moves * visits,
        "fresh_move_ms": statistics.mean(walls["fresh"]) * 1e3,
        "reused_move_ms": statistics.mean(walls["reused"]) * 1e3,
        "actor_share": 1.0 - search_s / wall, "resets": resets,
        "fresh_levels_per_sim": counts["levels_fresh"] / max(counts["sims_fresh"], 1),
        "reused_levels_per_sim": counts["levels_reused"] / max(counts["sims_reused"], 1),
        "reused_sims_per_move": counts["sims_reused"] / max(len(walls["reused"]), 1),
        "states": states, "episode": episode, "traj": traj, "tree": last["tree"],
    }
    advance_ms = []
    kw = last["kwargs"]
    for _ in range(3):
        t = time.monotonic()
        mcts.advance_root(cfg, sp, evaluate, kw["reuse_tree"], kw["reuse_actions"], last["args"][3],
                          generator=generator, reuse_ok=kw["reuse_ok"], root_hint=kw["root_hint"])
        torch.cuda.synchronize()
        advance_ms.append((time.monotonic() - t) * 1e3)
    out["advance_ms"] = statistics.median(advance_ms)
    log(f"{SELFPLAY_METRIC} {delivered:.1f} visits/s (B={batch}, {visits} visits, N={settings.nodes()}, "
        f"{segments} timed {moves}-move segments, {wall:.3f} s: " + ", ".join(f"{x:.3f}" for x in seg_walls)
        + f" s) on {card_line()}")
    log(f"  per move: fresh (first of a segment) {out['fresh_move_ms']:.1f} ms, reused {out['reused_move_ms']:.1f} ms "
        f"({out['reused_sims_per_move']:.1f} simulations); the actor's own work outside the searches "
        f"{out['actor_share']:.2%} of the wall; {resets} games ended and reset; advance_root alone "
        f"{out['advance_ms']:.1f} ms (median of 3)")
    log(f"  backup levels (_recompute_node calls) per simulation: fresh {out['fresh_levels_per_sim']:.2f}, "
        f"reused {out['reused_levels_per_sim']:.2f}")
    log(f"  launches in the timed segments: descend_interior {launches['descend_interior']} for {counts['sims']} "
        f"simulations run; gather_rows {launches['gather_rows']} ({launches['gather_rows'] / (moves * segments):.1f} "
        f"a move)")
    if launches["descend_interior"] != counts["sims"]:
        raise AssertionError(f"descend_interior launched {launches['descend_interior']} times, not once per "
                             f"simulation run ({counts['sims']})")
    if launches["gather_rows"] == 0:
        raise AssertionError("gather_rows was not launched on the selfplay path")
    return out


def phase_selfplay_ab(dev, cfg, batch=64, visits=8, moves=16, max_segments=4):
    """Games that finish: B=64 segments of 16 moves at 8 visits from empty
    boards until every game has ended at least once, then finalize_targets,
    once with both kernels and once with both plain versions, under one
    generator seed. Every field of every Trajectory and of the TrainingBatch
    must be identical."""
    import torch

    import katacoffee_tpu_torch.search.mcts as mcts
    from katacoffee_tpu_torch.command.selfplay import concat_trajectories
    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.game.board import init_state
    from katacoffee_tpu_torch.ops.gather import gather_rows_plain
    from katacoffee_tpu_torch.search.params import SearchParams
    from katacoffee_tpu_torch.selfplay.actor import SelfplaySettings, finalize_targets, run_selfplay_segment

    sp = SearchParams.for_selfplay()
    settings = SelfplaySettings(num_sims=visits)
    evaluate = mcts.make_nn_eval_fn(cfg, load_exported_model(MODEL_DIR, dev)[0])
    kept = (mcts._descend_interior, mcts.gather_rows)
    results = {}
    segments = None
    for name, fns in (("kernels", kept), ("plain", (mcts._descend_interior_plain, gather_rows_plain))):
        mcts._descend_interior, mcts.gather_rows = fns
        try:
            generator = torch.Generator(device=dev).manual_seed(7)
            states = init_state(cfg, batch, dev)
            episode = torch.zeros((batch,), dtype=torch.int64, device=dev)
            trajs = []
            while len(trajs) < (segments or max_segments):
                states, episode, traj = run_selfplay_segment(cfg, sp, settings, evaluate, states, episode, moves,
                                                             device=dev, generator=generator)
                trajs.append(traj)
                if segments is None and bool((episode > 0).all()):
                    break
            traj = concat_trajectories(trajs)
            results[name] = (traj, finalize_targets(cfg, settings, traj), states, episode)
        finally:
            mcts._descend_interior, mcts.gather_rows = kept
        segments = len(trajs)
    traj, batch_k, states, episode = results["kernels"]
    if not bool((episode > 0).all()):
        raise AssertionError(f"a game did not end in {segments} segments of {moves} moves")
    check_segment(cfg, traj, visits, "finishing games")
    fields = 0
    for label, a, b in (("trajectory", traj, results["plain"][0]), ("training batch", batch_k, results["plain"][1]),
                        ("states", states, results["plain"][2])):
        for name, x, y in zip(a._fields, a, b):
            for i, (u, v) in enumerate(zip(x, y) if isinstance(x, tuple) else ((x, y),)):
                fields += 1
                if not torch.equal(u, v):
                    raise AssertionError(f"finishing games: {label} field {name}[{i}] differs between the kernels "
                                         f"and the plain versions")
    ended = int(traj.done_after.sum())
    rows = int((batch_k.weight > 0).sum())
    log(f"finishing games, B={batch} {visits} visits, {segments} segments of {moves} moves: {ended} games ended, "
        f"{rows} weighted training rows; kernels vs plain versions: all {fields} trajectory, training-batch and "
        f"state tensors identical")
    return {"games": batch, "segments": segments, "ended": ended, "rows": rows, "identical_fields": fields,
            "traj": traj}


def phase_selfplay_card_vs_cpu(dev, cfg, batch=8, visits=32, moves=4):
    """The card against the CPU at float32: a B=8 segment of 4 moves from
    positions a few plies before a game's end (games end and reset inside
    it) with the same injected draws on both. Played moves must be equal in
    every game; a game that parts is printed with its move and the CPU's two
    top play-selection weights there, and passes only where those two are
    within NEAR_TIE (relative)."""
    import torch

    import katacoffee_tpu_torch.search.mcts as mcts
    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.game.symmetry import num_symmetries
    from katacoffee_tpu_torch.search.params import SearchParams
    from katacoffee_tpu_torch.selfplay.actor import MoveDraws, SegmentDraws, SelfplaySettings, run_selfplay_segment

    sp = SearchParams.for_selfplay()
    settings = SelfplaySettings(num_sims=visits)
    roots = ending_positions(cfg, batch, seed=6)
    A = cfg.policy_size
    g = torch.Generator().manual_seed(6)
    k = min(sp.rootNumSymmetriesToSample, num_symmetries(cfg))

    def gumbel(shape):
        return -torch.log(torch.empty(shape).exponential_(generator=g))

    draws = SegmentDraws(
        init_len=torch.empty((batch,)).exponential_(generator=g),
        moves=tuple(MoveDraws(
            search=mcts.RootDraws(
                syms=torch.argsort(torch.rand((batch, num_symmetries(cfg)), generator=g), dim=-1)[:, :k],
                gamma=torch._standard_gamma(torch.full((batch, A), 0.1083), generator=g),
                gamma_reused=torch._standard_gamma(torch.full((batch, A), 0.1083), generator=g)),
            select=gumbel((batch, A)), init_move=gumbel((batch, A)),
            init_len=torch.empty((batch,)).exponential_(generator=g),
        ) for _ in range(moves)),
    )
    runs = []
    kept = mcts.policy_target
    for d in (dev, torch.device("cpu")):
        trees = []

        def recording(tree, sp_):
            trees.append(mcts.root_play_selection_weights(sp_, tree).cpu())
            return kept(tree, sp_)

        net32 = load_exported_model(MODEL_DIR, d, torch.float32)[0]
        mcts.policy_target = recording
        try:
            _, _, traj = run_selfplay_segment(cfg, sp, settings, mcts.make_nn_eval_fn(cfg, net32), roots, torch.zeros(
                (batch,), dtype=torch.int64), moves, device=d, draws=draws)
        finally:
            mcts.policy_target = kept
        runs.append((traj, trees))
    (tk, _), (tc, weights) = runs
    act_k, act_c = tk.played_action.cpu(), tc.played_action
    parted = []
    for b in range(batch):
        differ = torch.nonzero(act_k[:, b] != act_c[:, b])[:, 0]
        if len(differ) == 0:
            continue
        t = int(differ[0])
        top = torch.topk(weights[t][b], 2).values.tolist()
        near = top[0] - top[1] <= NEAR_TIE * max(1.0, abs(top[0]))
        log(f"  card vs cpu: game {b} parts at move {t} (card plays {int(act_k[t, b])}, cpu {int(act_c[t, b])}); "
            f"the cpu's two top play-selection weights {top[0]:.7g}, {top[1]:.7g}")
        parted.append((b, t, near))
    same_visits = bool(torch.equal(tk.root_visits.cpu(), tc.root_visits))
    pt_diff = (tk.policy_target.cpu() - tc.policy_target).abs().max().item()
    log(f"card vs cpu, B={batch} {visits} visits {moves} moves float32, same draws: played moves equal in "
        f"{batch - len(parted)} of {batch} games; max |policy target diff| {pt_diff:.3e}; "
        f"{int(tc.done_after.sum())} games ended")
    if not all(near for _, _, near in parted):
        raise AssertionError("card and cpu segments part where the play-selection weights are not a near tie")
    return {"games": batch, "parted": len(parted), "max_pt_diff": pt_diff, "same_root_visits": same_visits}


def phase_selfplay_branches(dev, cfg, main, window, visits=200, moves=2, seed=3, tree_threshold=50):
    """Side positions, whole-game forks and tree records at B=512 and 200
    visits (N=64) with configs/selfplay.cfg's probabilities (sidePositionProb 0.02,
    earlyForkGameProb 0.04, forkGameProb 0.01) and tree recording
    (threshold 50, weight 0.25): fork candidates from the finished games of
    `window` (`extract_fork_candidates`, `choose_fork_moves`, `refill_pool`),
    one segment from the main path's states consuming that pool, then
    `run_side_segment` with 128 lanes, `finalize_targets` and
    `tree_position_rows`."""
    import numpy as np
    import torch

    import katacoffee_tpu_torch.search.mcts as mcts
    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.search.params import SearchParams
    from katacoffee_tpu_torch.selfplay import forking
    from katacoffee_tpu_torch.selfplay.actor import (
        SelfplaySettings,
        finalize_targets,
        init_side_state,
        run_selfplay_segment,
        run_side_segment,
    )
    from katacoffee_tpu_torch.selfplay.treerecord import tree_position_rows

    sp = SearchParams.for_selfplay()
    settings = SelfplaySettings(num_sims=visits, side_position_prob=0.02, side_position_capacity=128,
                                early_fork_game_prob=0.04, fork_game_prob=0.01, record_tree_positions=True,
                                record_tree_threshold=tree_threshold, record_tree_target_weight=0.25)
    evaluate = mcts.make_nn_eval_fn(cfg, load_exported_model(MODEL_DIR, dev)[0])
    generator = torch.Generator(device=dev).manual_seed(seed)
    t = time.monotonic()
    cands = forking.extract_fork_candidates(
        cfg, window, np.random.default_rng(seed), early_fork_prob=settings.early_fork_game_prob,
        early_fork_move_prop=settings.early_fork_game_expected_move_prop, fork_prob=settings.fork_game_prob,
        early_max_choices=settings.early_fork_game_max_choices, fork_max_choices=settings.fork_game_max_choices)
    pool = forking.init_fork_pool(cfg, settings.fork_pool_capacity, dev)
    n_cands = 0
    if cands is not None:
        idx, max_choices, forced = (torch.from_numpy(x).to(dev) for x in cands)
        n_cands = len(idx)
        T, B = window.played_action.shape
        from_states = window.states.map(lambda x: x.reshape((T * B,) + x.shape[2:])[idx])
        new = forking.choose_fork_moves(cfg, evaluate, from_states, torch.ones_like(idx, dtype=torch.bool),
                                        max_choices, forced, device=dev, generator=generator,
                                        min_choices=settings.fork_game_min_choices,
                                        num_lanes=settings.fork_game_max_choices)
        pool = forking.refill_pool(pool, new)
    pooled = int(pool.valid.sum())
    torch.cuda.synchronize()
    fork_s = time.monotonic() - t

    t = time.monotonic()
    states, episode, traj, pool = run_selfplay_segment(cfg, sp, settings, evaluate, main["states"], main["episode"],
                                                       moves, device=dev, generator=generator, fork_pool=pool)
    torch.cuda.synchronize()
    seg_s = time.monotonic() - t
    check_segment(cfg, traj, visits, "segment with forks and tree records")
    popped = pooled - int(pool.valid.sum())
    batch = finalize_targets(cfg, settings, traj)
    rows = tree_position_rows(cfg, settings, traj)
    t = time.monotonic()
    side, side_batch = run_side_segment(cfg, sp, settings, evaluate, init_side_state(cfg, 128, dev), traj,
                                        device=dev, generator=generator)
    torch.cuda.synchronize()
    side_s = time.monotonic() - t
    forks = int(traj.fork_valid.sum())
    side_rows = int(side_batch.weight.sum())
    tree_rows = int(traj.tree_pos_valid.sum())
    for label, b in (("segment", batch), ("tree rows", rows), ("side rows", side_batch)):
        for name, x in zip(b._fields, b):
            if torch.is_tensor(x) and x.is_floating_point() and not torch.isfinite(x).all():
                raise AssertionError(f"{label}: non-finite {name}")
    valid_side = side_batch.weight > 0
    if side_rows != min(forks, 128) or not torch.allclose(side_batch.policy_target[valid_side].sum(-1),
                                                          torch.ones((), device=dev), atol=1e-5):
        raise AssertionError(f"side rows {side_rows} for {forks} forks, or their policy targets do not sum to 1")
    if tree_rows == 0 or not torch.allclose(rows.policy_target[rows.weight > 0].sum(-1), torch.ones((), device=dev),
                                            atol=1e-5):
        raise AssertionError("no tree-position rows, or their policy targets do not sum to 1")
    log(f"forks and tree records, B={main['states'].board.shape[0]} {visits} visits {moves} moves: "
        f"{n_cands} fork candidates from {int(window.done_after.sum())} finished games, {pooled} pooled "
        f"({fork_s * 1e3:.1f} ms), {popped} popped by resetting games; segment {seg_s:.3f} s with {forks} "
        f"side-position forks and {tree_rows} recorded tree positions; run_side_segment (128 lanes) "
        f"{side_s:.3f} s, {side_rows} side rows, {int(side.valid.sum())} continuations carried")
    return {"candidates": n_cands, "pooled": pooled, "popped": popped, "segment_s": seg_s, "forks": forks,
            "tree_rows": tree_rows, "side_s": side_s, "side_rows": side_rows}


SELFPLAY_CFG = "configs/selfplay.cfg"


def replay_sgfs(cfg, paths, dev):
    """Replays SGF games batched with the port's rules: every move legal
    when it is played, the game over after its last move and not before,
    its winner the one `RE` names. Returns the number of games."""
    import torch

    from katacoffee_tpu_torch.dataio.sgf import parse_sgf_file
    from katacoffee_tpu_torch.game.board import init_state, legal_mask_flat, step

    games = [parse_sgf_file(p) for p in paths]
    results = {"B+": 1, "W+": 2, "0": 0}
    moves = [[d * cfg.area + y * cfg.x_size + x for x, y, d, _ in g.moves()] for g in games]
    if any(g.board_size() != (cfg.x_size, cfg.y_size) or g.result() not in results or not m
           for g, m in zip(games, moves)):
        raise AssertionError("an SGF of another board, without a result, or without moves")
    G, T = len(games), max(len(m) for m in moves)
    lengths = torch.tensor([len(m) for m in moves], device=dev)
    acts = torch.tensor([m + [0] * (T - len(m)) for m in moves], device=dev)
    s = init_state(cfg, G, dev)
    rows = torch.arange(G, device=dev)
    for t in range(T):
        live = t < lengths
        if not bool((legal_mask_flat(cfg, s)[rows, acts[:, t]] | ~live).all()):
            raise AssertionError(f"an SGF plays an illegal move at ply {t + 1}")
        if bool((s.done & live).any()):
            raise AssertionError(f"an SGF goes on after its game ended, at ply {t + 1}")
        s = step(cfg, s, acts[:, t])
    want = torch.tensor([results[g.result()] for g in games], device=dev, dtype=s.winner.dtype)
    if not bool(s.done.all()) or not torch.equal(s.winner, want):
        raise AssertionError("an SGF ends before its game does, or names another winner")
    return G


# the shard schema of the JAX package's batch_to_arrays (katacoffee_tpu/dataio/trainingwrite.py:53-85)
SHARD_DTYPES = {
    "schema_version": "int32", "board_shape": "int32", "board": "int8", "to_move": "int8", "recent_spots": "int16",
    "recent_dirs": "int8", "num_turns": "int16", "policy_target": "float16", "opponent_policy_target": "float16",
    "value_target": "float16", "td_value_targets": "float16", "ownership": "int8", "line_target": "int8",
    "futurepos": "int8", "var_time_left": "float32", "shortterm_value": "float32", "weight": "float32",
    "opponent_policy_weight": "float32", "aux_weight": "float32",
}

def read_daemon_rows(cfg, out, model, dev):
    """Every shard written for `model` under `out` (the daemon's or the
    contribution server's layout), read back through the port's reader and
    rows_to_batch and checked, the JAX schema's keys and dtypes among the
    checks; returns the rows concatenated by key (numpy) and the SGF
    paths."""
    import os

    import numpy as np
    import torch

    from katacoffee_tpu_torch.dataio.trainingwrite import _ROW_KEYS, iter_shards, read_npz_rows, rows_to_batch

    tdata = os.path.join(out, "selfplay", model, "tdata")
    cols = {k: [] for k in _ROW_KEYS}
    for path in iter_shards(tdata):
        data = read_npz_rows(path)
        dtypes = {k: str(v.dtype) for k, v in data.items()}
        if dtypes != SHARD_DTYPES:
            raise AssertionError(f"{path}: keys and dtypes {dtypes}, not the JAX schema's")
        batch = rows_to_batch(data, cfg, device=dev)
        ok = (bool((batch.weight > 0).all()) and bool(torch.isin(batch.states.board, torch.tensor(
            [0, 1, 2], device=dev, dtype=torch.int8)).all()) and bool(((batch.states.to_move == 1)
                                                                         | (batch.states.to_move == 2)).all())
              and bool(torch.allclose(batch.policy_target.sum(-1), torch.ones((), device=dev), atol=1e-2)))
        if not ok:
            raise AssertionError(f"{path}: a row with weight 0, a board cell or player to move out of range, "
                                 f"or a policy target that does not sum to 1")
        for k in _ROW_KEYS:
            cols[k].append(data[k])
    if not cols["weight"]:
        raise AssertionError(f"no shard in {tdata}")
    rows = {k: np.concatenate(v) for k, v in cols.items()}
    sgf_dir = os.path.join(out, "selfplay", model, "sgfs")
    return rows, sorted(os.path.join(sgf_dir, n) for n in os.listdir(sgf_dir))


def sorted_rows(rows):
    """The rows as one byte string each, in a stable sorted order."""
    import numpy as np

    n = rows["weight"].shape[0]
    flat = np.concatenate([np.ascontiguousarray(v).reshape(n, -1).view(np.uint8) for v in rows.values()], axis=1)
    return sorted(flat[i].tobytes() for i in range(n))


def check_path_gather(label, table, idx) -> tuple[dict, float]:
    """The gather kernel against gather_rows_plain on inputs the main path
    gave it (copied at its call): equal, then timed by `time_gather`.
    Returns (timings, max |kernel - plain|)."""
    import torch

    from katacoffee_tpu_torch.ops.gather import gather_rows, gather_rows_plain

    got, want = gather_rows(table, idx), gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: gather_rows != gather_rows_plain at {tuple(table.shape)}, {tuple(idx.shape)}")
    log(f"{label}: gather kernel == plain on the path's own table and indices")
    return time_gather(table, idx, label + ": "), (got - want).abs().max().item()


def check_path_descent(label, cfg, sp, tree, inputs, timed: bool, avoid_until=None, leak_u=None,
                       acts_f=None) -> dict:
    """The descent kernel against `_descend_interior_plain` on a copy of the
    tree and inputs the main path gave it at one launch (with the avoid
    mask, leak draws and a round's flat-action rows it was given), held by
    `compare_descent`; with `timed`, then timed by `time_descent`, its bound
    from this copy."""
    import torch

    from katacoffee_tpu_torch.search import mcts

    start_ev = tree.edge_visits.clone()
    extra = dict(leak_u=leak_u, acts_f=acts_f)
    got = run_descent(mcts._descend_interior, cfg, sp, tree, start_ev, inputs, avoid_until, **extra)
    want = run_descent(mcts._descend_interior_plain, cfg, sp, tree, start_ev, inputs, avoid_until, **extra)
    flips, err = compare_descent(label, cfg, sp, tree, start_ev, inputs, got, want, avoid_until)
    depth, active = inputs[1:3]
    leaf_depth = want[1]
    capped = leaf_depth < mcts._max_depth(cfg, sp)
    game_levels = torch.where(active, leaf_depth - depth + capped.long(), 0)
    levels = int(game_levels.sum())
    B, N, A = tree.prior.shape
    out = dict(timed_levels=levels, max_levels=int(game_levels.max()), flips=flips, max_abs_err=err,
               games=int(active.sum()), caught=int(want[10].sum()), shape=[B, N, A, inputs[5].child_c.shape[-1]],
               rows=int(active.shape[0]))
    if avoid_until is not None:
        out["forbidden_by_game"] = forbidden_lanes(cfg, tree, inputs, want, avoid_until)
        out["forbidden_lanes"] = sum(out["forbidden_by_game"])
    if timed:
        out["ms"], out["plain_ms"] = time_descent(cfg, sp, tree, start_ev, inputs, avoid_until=avoid_until, **extra)
        out["bound_ms"] = descent_bound_ms(cfg, tree, inputs, got, sp, avoid_until, leak_u is not None)
        log(f"{label}: {out['games']} games descending, {levels} levels, the deepest game {out['max_levels']}: "
            f"kernel {out['ms'] * 1e3:.2f} us device, plain {out['plain_ms'] * 1e3:.1f} us wall, "
            f"bound {out['bound_ms'] * 1e3:.3f} us (bytes)")
    return out


class PathCopies:
    """While entered: counts the simulations the search runs and copies the
    inputs the main path gives both kernels, each gather's table and
    indices at its call (the last call of each shape kept) and the tree and
    inputs of every `snapshot_every`-th descent launch of each batch width.
    Entering sets both kernels' launch counts to 0; `launches` holds them as
    read at the exit. `check` then holds each kernel against its plain
    version on every copy, and times the gathers and, for each width, the
    descent copy with the most levels."""

    def __init__(self, snapshot_every: int = 100):
        import collections

        self.snapshot_every = snapshot_every
        self.sims = self.rounds = 0
        self.gathers, self.descents, self.descent_calls = {}, {}, collections.Counter()
        self.launches = None

    def __enter__(self):
        import torch

        from katacoffee_tpu_torch.ops.descend import descend_interior
        from katacoffee_tpu_torch.ops.gather import gather_rows
        from katacoffee_tpu_torch.search import mcts

        kept = self.kept = (mcts._simulate_once, mcts.gather_rows, mcts._descend_interior, mcts._simulate_round)

        def simulate(*args, **kwargs):
            self.sims += 1
            return kept[0](*args, **kwargs)

        def simulate_round(*args, **kwargs):
            self.rounds += 1
            return kept[3](*args, **kwargs)

        def copy_gather(table, idx):
            self.gathers[tuple(table.shape) + (idx.shape[1],)] = (table.clone(), idx.clone())
            return kept[1](table, idx)

        def copy_descent(c, sp, tree, node, depth, active, path, acts, scratch, avoid_until=None, leak_u=None,
                         acts_f=None):
            B = node.shape[0]
            self.descent_calls[B] += 1
            if self.descent_calls[B] % self.snapshot_every == 0:
                copy = mcts.Tree(*(x.map(torch.clone) if isinstance(x, tuple) else x.clone() for x in tree))
                self.descents.setdefault(B, []).append((self.descent_calls[B], sp, copy, tuple(
                    x.clone() for x in (node, depth, active, path, acts)) + (mcts.LevelScratch(*(
                        x.clone() for x in scratch)),), None if avoid_until is None else avoid_until.clone(), {
                        k: None if v is None else v.clone() for k, v in (("leak_u", leak_u), ("acts_f", acts_f))}))
            return kept[2](c, sp, tree, node, depth, active, path, acts, scratch, avoid_until, leak_u=leak_u,
                           acts_f=acts_f)

        mcts._simulate_once, mcts.gather_rows, mcts._descend_interior = simulate, copy_gather, copy_descent
        mcts._simulate_round = simulate_round
        gather_rows.launches = descend_interior.launches = 0
        return self

    def __exit__(self, *exc):
        from katacoffee_tpu_torch.ops.descend import descend_interior
        from katacoffee_tpu_torch.ops.gather import gather_rows
        from katacoffee_tpu_torch.search import mcts

        self.launches = {"gather_rows": gather_rows.launches, "descend_interior": descend_interior.launches}
        mcts._simulate_once, mcts.gather_rows, mcts._descend_interior, mcts._simulate_round = self.kept
        return False

    def check_launches(self, label: str, main_width: int) -> None:
        """One descent launch per simulation or round of K playouts run,
        some gathers, and a copy of the descent at every batch width it ran
        at."""
        if self.launches["descend_interior"] != self.sims + self.rounds:
            raise AssertionError(f"{label}: descend_interior launched {self.launches['descend_interior']} times, "
                                 f"not once per simulation or round run ({self.sims} + {self.rounds})")
        if self.launches["gather_rows"] == 0:
            raise AssertionError(f"{label}: gather_rows was not launched")
        if set(self.descents) != set(self.descent_calls) or main_width not in self.descents:
            raise AssertionError(f"{label}: descent launches by batch width {dict(self.descent_calls)}: a width "
                                 f"with fewer than {self.snapshot_every} launches was not copied, so its kernel is "
                                 f"not checked")

    def check(self, label: str, cfg) -> dict:
        gather_timings, gather_err = {}, 0.0
        for shape, (table, idx) in sorted(self.gathers.items(), reverse=True):
            gather_timings[shape], err = check_path_gather(f"{label} {shape}", table, idx)
            gather_err = max(gather_err, err)
        self.gathers.clear()
        descent_timings = {}
        for B, copies in sorted(self.descents.items(), reverse=True):
            checked = [check_path_descent(f"{label} B={B} launch {n}", cfg, sp, tree, inputs, False, avoid, **extra)
                       for n, sp, tree, inputs, avoid, extra in copies]
            log(f"{label} B={B}: descent kernel == plain on the path's own tree at launches "
                f"{[c[0] for c in copies]}: games descending {[c['games'] for c in checked]}, levels "
                f"{[c['timed_levels'] for c in checked]}, catch-ups {[c['caught'] for c in checked]}, near-tie act "
                f"flips {sum(c['flips'] for c in checked)}")
            best = max(range(len(copies)), key=lambda i: checked[i]["timed_levels"])
            if checked[best]["timed_levels"] == 0:
                raise AssertionError(f"{label} B={B}: no copied descent went below the root, so the kernel is not "
                                     f"checked")
            n, sp, tree, inputs, avoid, extra = copies[best]
            descent_timings[B] = check_path_descent(f"{label} B={B} launch {n}", cfg, sp, tree, inputs, True, avoid,
                                                    **extra)
            descent_timings[B].update(
                launch=n, flips=sum(c["flips"] for c in checked), games=sum(c["games"] for c in checked),
                levels_compared=sum(c["timed_levels"] for c in checked),
                max_abs_err=max(c["max_abs_err"] for c in checked))
            masked = [c["forbidden_by_game"] for c in checked if "forbidden_by_game" in c]
            if masked:
                descent_timings[B]["forbidden_by_game"] = [sum(g) for g in zip(*masked)]
        self.descents.clear()
        return {"gather": gather_timings, "gather_max_abs_err": gather_err, "descent": descent_timings}


def phase_selfplay_command(dev, cfg, root, batch=256, visits=600, rows_visits=8, rows_moves=16, snapshot_every=100):
    """The selfplay command: `command.selfplay.main`, in this process, on
    output directories under `root` (a temporary directory outside the repo
    that the caller removes) whose models/ links
    run-s5200, with configs/selfplay.cfg (B=256, 600 visits, b6c96 bf16
    with a random symmetry per evaluation, side positions and game forks at
    the cfg's probabilities), the depth cut by overrides:
      (a) 1 segment of 2 moves (2 segments until the gatekeeper came),
          then a flush: both kernels' launch counts reset before and read
          after (one descent launch per
          simulation run, the side searches' included), delivered visits/s
          of the segments and of the whole daemon, and the daemon's own
          seconds outside the segments by part. Each gather's table and
          indices are copied at the call (the last call of each shape
          kept), and the tree and inputs of every `snapshot_every`-th
          descent launch of each batch width (the moves' B and the side
          searches' lanes); after the run each kernel is held against its
          plain version on every copy, and timed on the gathers' and, for
          each width, on the descent copy with the most levels;
      (b) 8 visits (16 until phase 15 met a slow host), 2 segments of 16
          moves in one flush window, twice with
          the same seed: games end, every shard reads back through the
          port's reader and rows_to_batch with weights > 0, policy targets
          summing to 1 (float16), board cells in {0, 1, 2} and the player
          to move in {1, 2}; every SGF replays legally to its game's end and
          winner, one SGF per game ended; both runs' rows equal after a
          stable sort, and their SGFs equal; the daemon's seconds by part.
    The first (b) run's shards are left for the trainer phase (`rows_dir`)."""
    import os

    import torch

    from katacoffee_tpu_torch.command import selfplay as command

    model = os.path.basename(MODEL_DIR)
    kept = command.run_selfplay_segment
    ended = []

    def segment(*args, **kwargs):
        out = kept(*args, **kwargs)
        ended.append(int(out[2].done_after.sum()))
        return out

    def run(name, overrides):
        out = os.path.join(root, name)
        os.makedirs(os.path.join(out, "models"))
        os.symlink(os.path.abspath(MODEL_DIR), os.path.join(out, "models", model))
        walls = {}
        ended.clear()
        torch.cuda.synchronize()
        t = time.monotonic()
        command.main(["-output-dir", out, "-config", SELFPLAY_CFG, "-override-config", overrides], device=dev,
                     walls=walls)
        torch.cuda.synchronize()
        return out, walls, time.monotonic() - t

    def parts_line(walls):
        return ", ".join(f"{k} {sum(v):.3f}" for k, v in walls.items() if k != "segment")

    command.run_selfplay_segment = segment
    try:
        moves, segments = 2, 1
        with PathCopies(snapshot_every) as copies:
            out_a, walls, wall = run("a", f"numParallelGames={batch},maxVisits={visits},movesPerSegment={moves},"
                                          f"maxSegments={segments},segmentsPerFlush=1")
        launches = copies.launches
        run_sims = copies.sims
        rows_a, _ = read_daemon_rows(cfg, out_a, model, dev)
        seg_s = sum(walls["segment"])
        delivered = batch * visits * moves * segments / seg_s
        side_rows = int((rows_a["aux_weight"] == 0).sum())
        log(f"selfplay command (a), B={batch} {visits} visits, {segments} segments of {moves} moves, a flush each: "
            f"delivered {delivered:.1f} visits/s over the segments ({batch * visits * moves * segments / wall:.1f} over "
            f"the daemon's {wall:.3f} s); segment walls " + ", ".join(f"{x:.3f}" for x in walls["segment"])
            + f" s; outside the segments {wall - seg_s:.3f} s ({parts_line(walls)}); {rows_a['weight'].shape[0]} "
            f"rows, {side_rows} of them side rows; {sum(ended)} games ended")
        log(f"  launches in the daemon run: descend_interior {launches['descend_interior']} for {run_sims} "
            f"simulations run (segments and side searches; by batch width {dict(copies.descent_calls)}); gather_rows "
            f"{launches['gather_rows']} (shapes {sorted(copies.gathers)})")
        copies.check_launches("the selfplay command", batch)
        if side_rows == 0:
            raise AssertionError("the daemon wrote no side-position rows")
        checked = copies.check("selfplay command (a)", cfg)

        runs, parts_b = [], []
        for name in ("b1", "b2"):
            out, bw, bwall = run(name, f"numParallelGames={batch},maxVisits={rows_visits},"
                                       f"movesPerSegment={rows_moves},segmentsPerFlush=2,maxSegments=2")
            rows, sgfs = read_daemon_rows(cfg, out, model, dev)
            games = replay_sgfs(cfg, sgfs, dev)
            if games == 0 or games != sum(ended):
                raise AssertionError(f"{games} SGFs for {sum(ended)} games ended")
            runs.append((rows, [open(p).read() for p in sgfs]))
            own = sum(sum(v) for k, v in bw.items() if k not in ("segment", "side"))
            parts_b.append({"wall_s": bwall, "own_s": own, **{k: sum(v) for k, v in bw.items()}})
            log(f"selfplay command (b) run {name}, B={batch} {rows_visits} visits, 2 segments of {rows_moves} moves: "
                f"{bwall:.3f} s, {rows['weight'].shape[0]} rows ({int((rows['aux_weight'] == 0).sum())} side rows), "
                f"{games} games ended, each an SGF that replays legally to its winner; segments "
                f"{sum(bw['segment']):.3f} s, {parts_line(bw)}; the daemon's own work (poll, finalize, write, forks, "
                f"sgfs) {own:.3f} s, {own / bwall:.2%} of the wall")
        same = sorted_rows(runs[0][0]) == sorted_rows(runs[1][0]) and runs[0][1] == runs[1][1]
        if not same:
            raise AssertionError("two daemon runs with the same seed wrote different rows or SGFs")
        log(f"  both runs wrote the same {runs[0][0]['weight'].shape[0]} rows (after a stable sort) and the same "
            f"{len(runs[0][1])} SGFs")
    finally:
        command.run_selfplay_segment = kept
    return {"rows_dir": os.path.join(root, "b1", "selfplay", model, "tdata"), "launches": launches,
            "sims": run_sims, "delivered_vps": delivered, "outside_s": wall - seg_s,
            "segment_walls": walls["segment"], "segment_sims": moves * visits, **checked,
            "gather_shape": next(s for s in checked["gather"] if s[0] == batch), "rows_runs": parts_b}


TRAIN_CFG = "configs/train.cfg"
FLAGSHIP_CKPT = "artifacts/flagship_b6c96/train/run/checkpoint.ckpt"
# card against CPU, one float32 b6c96 step from the flagship state: the
# gradients differ by the order of float32 sums over 256 rows x 25 cells
# (cuDNN's against the CPU's convolutions, TF32 off), a few ulps of a
# gradient; the step moves a parameter by lr * |u| (lr 0.004 here) and the
# EMA by a thousandth of that, far below 1e-5; the trace carries the
# gradient itself, whose elements are below 1. PERF.md records the choice.
TRAIN_PARAM_TOL = 1e-5
TRAIN_METRIC_RTOL = 1e-4
LAUNCH_EVENTS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def train_step_flops(model, batch: int, area: int) -> float:
    """Multiply-adds x 2 of one train step's convolutions and dense layers:
    forward once, backward twice (input and weight gradients)."""
    import torch

    macs = 0
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            macs += m.weight.numel() * area * batch
        elif isinstance(m, torch.nn.Linear):
            macs += m.weight.numel() * batch
    return 2.0 * 3 * macs


def phase_trainer(dev, cfg, rows_dir, positions, root, batch_size=256, steps=80, export_every=40, timed=30,
                  warmup=5, profile_steps=5):
    """The trainer: the selfplay command's shards (`rows_dir`) shuffled by
    the port's `shuffle` CLI into `root`/shuffleddata with a 5 % val split,
    the flagship checkpoint (the JAX trainer's step 5200, b6c96) copied to
    `root`/train/run/, then `command.train.main` with configs/train.cfg
    (b6c96, B=`batch_size`, bf16 trunk) for `steps` steps, an export every
    `export_every`:
      (a) checks: every metric line finite; the checkpoint decodes with
          train_step 5200 + steps, and its count and step advanced by the
          steps; the export loads, its heads on `positions` finite and not
          equal to run-s5200's; find_latest_model over a models dir holding
          both picks the new one;
      (b) times, with a device sync at each step's end, after `warmup`
          untimed steps: ms a step (median, spread), samples/s, the batch
          iterator's host seconds a batch (timed alone), forward+loss /
          backward / optimizer+EMA from CUDA events in one more run, peak
          device memory, and a `profile_steps`-step torch.profiler profile
          (launches and host syncs a step, device busy share, top kernels);
      (c) one float32 step from the flagship state on one batch with
          injected symmetries and history depths, on the card and on the
          CPU: every metric within TRAIN_METRIC_RTOL relative, every
          parameter, trace and EMA leaf within TRAIN_PARAM_TOL *
          max(|x|, 1)."""
    import dataclasses
    import math
    import os

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from katacoffee_tpu_torch import cli
    from katacoffee_tpu_torch.command import train as command
    from katacoffee_tpu_torch.dataio import checkpoints as ckpt
    from katacoffee_tpu_torch.dataio import flaxbytes
    from katacoffee_tpu_torch.dataio.trainingwrite import iter_shards, read_npz_rows, rows_to_batch
    from katacoffee_tpu_torch.nn.configs import get_model_spec
    from katacoffee_tpu_torch.nn.features import extract_features, sample_history_levels
    from katacoffee_tpu_torch.nn.model import CoffeeNet
    from katacoffee_tpu_torch.ops.descend import descend_interior
    from katacoffee_tpu_torch.ops.gather import gather_rows
    from katacoffee_tpu_torch.train import train as train_mod

    base = os.path.join(root, "trainer")
    shuffled = os.path.join(base, "shuffleddata")
    if cli.main(["shuffle", rows_dir, "-out-dir", shuffled, "-min-rows", "4000", "-val-prop", "0.05",
                 "-seed", "0"]) != 0:
        raise AssertionError("shuffle failed")
    os.makedirs(os.path.join(base, "train", "run"))
    ckpt_path = os.path.join(base, "train", "run", "checkpoint.ckpt")
    shutil.copy(FLAGSHIP_CKPT, ckpt_path)
    start_meta, start_blob = ckpt.read_raw(ckpt_path)
    start_tree = flaxbytes.decode(start_blob)
    start_count, start_step = int(start_tree["opt_state"]["2"]["1"]["count"]), int(start_tree["step"])

    # (a) the command, resuming at the flagship's step, with the kernels'
    # launch counts reset before and read after: training reaches neither
    gather_rows.launches = descend_interior.launches = 0
    torch.cuda.synchronize()
    t = time.monotonic()
    command.main(["-base-dir", base, "-config", TRAIN_CFG, "-override-config",
                  f"maxSteps={steps},stepsPerExport={export_every},batchSize={batch_size}"], device=dev)
    torch.cuda.synchronize()
    wall = time.monotonic() - t
    kernel_launches = {"gather_rows": gather_rows.launches, "descend_interior": descend_interior.launches}
    run_dir = os.path.join(base, "train", "run")
    lines = {name: [json.loads(x) for x in open(os.path.join(run_dir, name))]
             for name in ("metrics_train.json", "metrics_val.json")}
    for name, ls in lines.items():
        bad = [(m["step"], k) for m in ls for k, v in m.items() if isinstance(v, float) and not math.isfinite(v)]
        if not ls or bad:
            raise AssertionError(f"{name}: {len(ls)} lines, non-finite {bad}")
    meta, blob = ckpt.read_raw(ckpt_path)
    tree = flaxbytes.decode(blob)
    end = start_meta["train_step"] + steps
    count, step = int(tree["opt_state"]["2"]["1"]["count"]), int(tree["step"])
    if (meta["train_step"], count, step) != (end, start_count + steps, start_step + steps):
        raise AssertionError(f"checkpoint train_step {meta['train_step']}, count {count}, step {step}: not "
                             f"{end}, {start_count + steps}, {start_step + steps}")
    export = os.path.join(base, "modelstobetested", f"run-s{end}")
    new, _, new_meta = ckpt.load_exported_model(export, dev)
    old = ckpt.load_exported_model(MODEL_DIR, dev)[0]
    spatial, glob = (x.to(dev) for x in extract_features(cfg, positions))
    with torch.no_grad():
        a, b = new(spatial, glob), old(spatial, glob)
    moved = max(float((a[k].float() - b[k].float()).abs().max()) for k in a)
    if not all(bool(torch.isfinite(v).all()) for v in a.values()) or moved == 0.0:
        raise AssertionError(f"the export's heads are not finite or equal run-s5200's (max |d| {moved})")
    models = os.path.join(base, "models")
    os.makedirs(models)
    os.symlink(os.path.abspath(MODEL_DIR), os.path.join(models, os.path.basename(MODEL_DIR)))
    os.symlink(export, os.path.join(models, os.path.basename(export)))
    latest = ckpt.find_latest_model(models)
    if latest is None or os.path.basename(latest) != os.path.basename(export):
        raise AssertionError(f"find_latest_model picked {latest}, not {export}")
    first, last = lines["metrics_train.json"][0], lines["metrics_train.json"][-1]
    log(f"trainer (a): shuffled {rows_dir} ({sorted(os.listdir(shuffled))}); `train` resumed the flagship "
        f"checkpoint at step {start_meta['train_step']} (count {start_count}) and took {steps} b6c96 B={batch_size} bf16 "
        f"steps in {wall:.3f} s: loss {first['loss']:.4f} at step {first['step']} -> {last['loss']:.4f} at "
        f"{last['step']}, p_lr {last['p_lr']}, val loss {lines['metrics_val.json'][-1]['loss']:.4f} on "
        f"{lines['metrics_val.json'][-1]['rows']} rows; checkpoint train_step {meta['train_step']}, count {count}, "
        f"step {step}; exported {os.path.basename(export)} (train_step {new_meta['train_step']}): heads finite, "
        f"max |d| from run-s5200 {moved:.4e}; find_latest_model picks it; kernel launches in the run "
        f"{kernel_launches}")

    # (b) times on the run's own data and state
    tc = train_mod.TrainConfig()
    model = CoffeeNet(get_model_spec("b6c96"), cfg.win_len).to(dev)
    state, _ = ckpt.load_checkpoint(ckpt_path, train_mod.init_train_state(model))
    step_fn = train_mod.make_train_step(cfg, tc, batch_size)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = command._batch_iterator(shuffled, batch_size, np.random.default_rng(0), cfg, dev)
    pool = [next(batches)[1] for _ in range(warmup + timed)]
    iter_s = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t = time.monotonic()
        next(batches)
        torch.cuda.synchronize()
        iter_s.append(time.monotonic() - t)
    for b in pool[:warmup]:
        step_fn(state, b, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # tensors other phases keep alive count in the device's peak: report the
    # steps' own peak above what was allocated when they started
    live = torch.cuda.memory_allocated()
    step_ms = []
    for b in pool[warmup:]:
        t = time.monotonic()
        step_fn(state, b, gen)
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() - live
    parts = {"forward+loss": [], "backward": [], "optimizer+EMA": []}
    for b in pool[warmup:]:
        marks = [("start", torch.cuda.Event(enable_timing=True))]
        marks[0][1].record()

        def mark(part):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((part, e))

        step_fn(state, b, gen, mark=mark)
        torch.cuda.synchronize()
        for (_, e0), (part, e1) in zip(marks, marks[1:]):
            parts[part].append(e0.elapsed_time(e1))
    med = statistics.median(step_ms)
    flops = train_step_flops(model, batch_size, cfg.area)
    log(f"trainer (b), {card_line()}: {timed} b6c96 B={batch_size} bf16 steps after {warmup} untimed, each ended "
        f"by a device sync: median {med:.3f} ms a step (min {min(step_ms):.3f}, max {max(step_ms):.3f}, "
        f"p10 {np.percentile(step_ms, 10):.3f}, p90 {np.percentile(step_ms, 90):.3f}), "
        f"{batch_size / med * 1e3:.1f} samples/s; the batch iterator alone {statistics.median(iter_s) * 1e3:.3f} ms "
        f"of host time a batch (median; max {max(iter_s) * 1e3:.3f}); by part from CUDA events (median ms): "
        + ", ".join(f"{k} {statistics.median(v):.3f}" for k, v in parts.items())
        + f"; peak device memory {peak / 2**20:.1f} MiB above the {live / 2**20:.1f} MiB live before the steps "
        f"(the state and batches included); convolution and dense FLOPs a step {flops / 1e9:.2f} G, "
        f"{flops / BF16_FLOPS * 1e3:.4f} ms at the card's bf16 tensor peak")

    t = time.monotonic()
    for b in pool[warmup: warmup + profile_steps]:
        step_fn(state, b, gen)
    torch.cuda.synchronize()
    prof_wall = time.monotonic() - t
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in pool[warmup: warmup + profile_steps]:
            step_fn(state, b, gen)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = {k: sum(e.count for e in events if e.key == k) / profile_steps for k in LAUNCH_EVENTS}
    launches = {k: v for k, v in launches.items() if v}
    syncs = {k: sum(e.count for e in events if e.key == k) / profile_steps
             for k in ("aten::_local_scalar_dense", "cudaStreamSynchronize", "cudaDeviceSynchronize")}
    log(f"trainer (b) profile of {profile_steps} steps: wall {prof_wall:.3f} s unprofiled, device busy {busy:.4f} s "
        f"({busy / prof_wall:.1%}); a step: launches {launches}, {sum(e.count for e in kernels) / profile_steps:.0f} "
        f"device kernels, host syncs {syncs}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:100]}")

    # (c) card against CPU, float32, one step with injected draws
    g = torch.Generator().manual_seed(7)
    syms = torch.randint(0, 8, (batch_size,), generator=g)
    levels = sample_history_levels(batch_size, 0.7, generator=g)
    data = read_npz_rows(next(iter_shards(shuffled)))
    rows = {k: v[:batch_size] for k, v in data.items()}
    f32 = dataclasses.replace(get_model_spec("b6c96"), dtype=torch.float32)
    out = []
    for d in (dev, torch.device("cpu")):
        s, _ = ckpt.load_checkpoint(FLAGSHIP_CKPT, train_mod.init_train_state(CoffeeNet(f32, cfg.win_len).to(d)))
        s, m = train_mod.make_train_step(cfg, tc, batch_size)(s, rows_to_batch(rows, cfg, d),
                                                              draws=train_mod.StepDraws(syms.to(d), levels.to(d)))
        out.append(({k: float(v) for k, v in m.items()}, ckpt.flatten(ckpt.state_to_tree(s))))
    (gm, gt), (cm, ct) = out
    metric_err = max(abs(gm[k] - cm[k]) / max(abs(cm[k]), 1.0) for k in cm)
    leaf_err = {}
    for k in ct:
        if k.startswith(("params", "opt_state", "ema_params")) and ct[k].dtype == np.float32:
            part = k.split("/")[0]
            d = float(np.abs(gt[k].astype(np.float64) - ct[k]).max() / max(float(np.abs(ct[k]).max()), 1.0))
            leaf_err[part] = max(leaf_err.get(part, 0.0), d)
    log(f"trainer (c): one float32 b6c96 step from the flagship state on a {batch_size}-row batch with injected draws, card "
        f"against CPU: loss {gm['loss']:.6f} / {cm['loss']:.6f}, grad_norm {gm['grad_norm']:.6f} / "
        f"{cm['grad_norm']:.6f}; largest metric difference {metric_err:.3e} relative (tol {TRAIN_METRIC_RTOL}); "
        f"largest leaf difference / max(|x|, 1): " + ", ".join(f"{k} {v:.3e}" for k, v in leaf_err.items())
        + f" (tol {TRAIN_PARAM_TOL})")
    if metric_err > TRAIN_METRIC_RTOL or max(leaf_err.values()) > TRAIN_PARAM_TOL:
        raise AssertionError("the card's float32 train step disagrees with the CPU's")
    return {
        "steps": steps, "command_wall_s": wall, "ms_per_step_median": med, "ms_per_step_min": min(step_ms),
        "ms_per_step_max": max(step_ms), "samples_per_s": batch_size / med * 1e3,
        "iterator_ms_per_batch": statistics.median(iter_s) * 1e3,
        "parts_ms": {k: statistics.median(v) for k, v in parts.items()}, "peak_mib": peak / 2**20,
        "live_mib": live / 2**20,
        "launches_per_step": sum(launches.values()), "syncs_per_step": syncs, "busy_share": busy / prof_wall,
        "flops_per_step": flops, "bound_ms": flops / BF16_FLOPS * 1e3, "card_vs_cpu_metric_rel": metric_err, "card_vs_cpu_leaf": leaf_err,
        "loss_first": first["loss"], "loss_last": last["loss"], "export": os.path.basename(export),
        "kernel_launches": kernel_launches,
    }


GATE_CFG = "configs/gatekeeper.cfg"
CHAMPION_DIR = "artifacts/flagship_b6c96/models/run-s4800"


def phase_gatekeeper(dev, cfg, root, snapshot_every=100, profile_sims=5, visits=16):
    """The gatekeeper, the main path since the gatekeeper was ported:
    `command.gatekeeper.main` in this process with configs/gatekeeper.cfg
    (200 games, requiredCandidateWinProp 0.5, seed 0), its 150 visits cut to
    `visits` by an override (32 until phase 15 came, 64 until the script met
    a slow host, 150 until the contribution bus's phase came),
    on a base dir under `root` holding copies of run-s4800 as the champion
    in models/ and run-s5200 as the candidate in modelstobetested/, both
    b6c96 bf16 on the card, under for_gatekeeper(). With `PathCopies`
    entered around it (launch counts set to 0 before and read after; one
    descent launch per simulation run, two searches of `visits` simulations a
    ply): the wall, games/s, plies until every game ended, searched visits/s
    (every game of both halves searched at every ply) and the same counting
    live games only, the tally, the decision and where the candidate
    landed; every SGF replayed legally to its winner; then both kernels held
    to their plain versions on the copies and timed; then a short profile
    of a fresh B=100 search under for_gatekeeper() (launches and host syncs
    a playout, device busy share)."""
    import os

    import torch

    from katacoffee_tpu_torch.command import gatekeeper as command
    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.game.board import init_state
    from katacoffee_tpu_torch.search import mcts
    from katacoffee_tpu_torch.search.params import SearchParams
    from katacoffee_tpu_torch.utils.config import ConfigParser

    base = os.path.join(root, "gate")
    cand, champ = os.path.basename(MODEL_DIR), os.path.basename(CHAMPION_DIR)
    shutil.copytree(CHAMPION_DIR, os.path.join(base, "models", champ))
    shutil.copytree(MODEL_DIR, os.path.join(base, "modelstobetested", cand))
    required = ConfigParser(GATE_CFG).get_float("requiredCandidateWinProp")
    kept = command.run_match
    matches = []

    def timed_match(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.monotonic()
        result = kept(*args, **kwargs)
        torch.cuda.synchronize()
        matches.append((result, time.monotonic() - t))
        return result

    command.run_match = timed_match
    try:
        with PathCopies(snapshot_every) as copies:
            t = time.monotonic()
            command.main(["-base-dir", base, "-config", GATE_CFG, "-override-config", f"maxVisits={visits}",
                          "-quit-if-no-candidates"], device=dev)
            torch.cuda.synchronize()
            wall = time.monotonic() - t
    finally:
        command.run_match = kept
    if len(matches) != 1:
        raise AssertionError(f"the gatekeeper played {len(matches)} matches, not 1")
    result, match_s = matches[0]
    B, plies = result.games, len(result.live_per_ply)
    searched, live = B * visits * plies, visits * sum(result.live_per_ply)
    landed = [d for d in ("models", "rejectedmodels") if os.path.isdir(os.path.join(base, d, cand))]
    promoted = result.score_a >= required
    log(f"gatekeeper (a), configs/gatekeeper.cfg: {cand} (candidate) vs {champ}, {B} games at {visits} visits, b6c96 "
        f"bf16: {result.wins_a}-{result.wins_b}-{result.draws} (score {result.score_a:.3f}), "
        f"{'promoted' if promoted else 'rejected'}, landed in {landed}; command wall {wall:.3f} s, match {match_s:.3f} s, "
        f"{B / match_s:.3f} games/s; {plies} plies until every game ended (live games at each ply "
        f"{result.live_per_ply}); searched visits/s {searched / match_s:.1f} (every game searched), "
        f"{live / match_s:.1f} (live games only)")
    log(f"  launches in the gating run: descend_interior {copies.launches['descend_interior']} for {copies.sims} "
        f"simulations run (by batch width {dict(copies.descent_calls)}); gather_rows {copies.launches['gather_rows']} "
        f"(shapes {sorted(copies.gathers)})")
    copies.check_launches("the gatekeeper", B // 2)
    if copies.sims != 2 * visits * plies:
        raise AssertionError(f"{copies.sims} simulations run, not two searches of {visits} a ply over {plies} plies")
    if landed != ["models" if promoted else "rejectedmodels"] or os.listdir(os.path.join(base, "modelstobetested")):
        raise AssertionError(f"the candidate landed in {landed} after a score of {result.score_a}")
    sgf_dir = os.path.join(base, "gatekeepersgfs", cand)
    games = replay_sgfs(cfg, sorted(os.path.join(sgf_dir, n) for n in os.listdir(sgf_dir)), dev)
    if games != B:
        raise AssertionError(f"{games} SGFs replayed for {B} games")
    log(f"  {games} SGFs, each replays legally to its winner")
    checked = copies.check("gatekeeper (a)", cfg)

    net = load_exported_model(MODEL_DIR, dev)[0]
    evaluate = mcts.make_nn_eval_fn(cfg, net)
    roots = init_state(cfg, B // 2, dev)

    def search(wrap=lambda name, fn: fn):
        mcts.run_search(cfg, SearchParams.for_gatekeeper(), wrap("net", evaluate), roots, profile_sims, device=dev)
        torch.cuda.synchronize()

    prof = phase_profile(dev, f"gatekeeper B={B // 2} fresh", search, profile_sims)
    return {"games": B, "visits": visits, "wall_s": wall, "match_s": match_s, "games_per_s": B / match_s,
            "plies": plies, "live_per_ply": result.live_per_ply, "searched_vps": searched / match_s,
            "live_vps": live / match_s, "wins_a": result.wins_a, "wins_b": result.wins_b, "draws": result.draws,
            "score_a": result.score_a, "promoted": promoted, "landed": landed[0], "launches": copies.launches,
            "sims": copies.sims, **checked, "gather_shape": next(iter(checked["gather"])), "profile": prof}


def phase_gate_card_vs_cpu(dev, cfg, games=4, visits=8):
    """The card against the CPU: a float32 gating match (run-s5200 against
    run-s4800, for_gatekeeper()) of `games` games at `visits` visits with
    the same injected Gumbel draws on both. The move records must be equal;
    a game that parts is printed with its ply and passes only where the
    CPU's two best sampling scores (log weight over temperature plus the
    Gumbel noise, `chosen_move_logits`) there lie within NEAR_TIE
    (relative)."""
    import math

    import torch

    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.program import match
    from katacoffee_tpu_torch.search import mcts
    from katacoffee_tpu_torch.search.params import SearchParams

    sp = SearchParams.for_gatekeeper()
    half = games // 2
    g = torch.Generator().manual_seed(8)
    table = {(ply, h): -torch.log(torch.empty((half, cfg.policy_size)).exponential_(generator=g))
             for ply in range(cfg.area + 2) for h in (0, 1)}
    kept = match.select_moves
    runs = []
    for d in (dev, torch.device("cpu")):
        at, scores = [None], {}

        def draws(ply, h):
            at[0] = (ply, h)
            return table[ply, h]

        def recording(cfg_, sp_, tree, generator=None, gumbel=None, turn_number=None):
            _, logits, _ = mcts.chosen_move_logits(cfg_, sp_, tree, turn_number)
            scores[at[0]] = (logits + gumbel.to(logits.device)).cpu()
            return kept(cfg_, sp_, tree, generator=generator, gumbel=gumbel, turn_number=turn_number)

        evals = [mcts.make_nn_eval_fn(cfg, load_exported_model(m, d, torch.float32)[0]) for m in (MODEL_DIR,
                                                                                                 CHAMPION_DIR)]
        match.select_moves = recording
        # the CPU's ops here are on [4, ...] tensors: one thread beats a pool
        threads = torch.get_num_threads()
        torch.set_num_threads(1 if d.type == "cpu" else threads)
        t = time.monotonic()
        try:
            result = match.run_match(cfg, sp, sp, *evals, num_games=games, num_visits=visits, record_moves=True,
                                     device=d, draws=draws)
        finally:
            match.select_moves = kept
            torch.set_num_threads(threads)
        runs.append((result, scores, time.monotonic() - t))
    (rk, _, tk), (rc, scores, tc) = runs
    parted = []
    for gi in range(games):
        a, b = rk.move_records[gi], rc.move_records[gi]
        if a == b:
            continue
        t = next(i for i in range(min(len(a), len(b)) + 1) if i == min(len(a), len(b)) or a[i] != b[i])
        key = (t, gi // half)
        top = torch.topk(scores[key][gi % half], 2).values.tolist() if key in scores else [math.inf, -math.inf]
        near = top[0] - top[1] <= NEAR_TIE * max(1.0, abs(top[0]))
        log(f"  card vs cpu: game {gi} parts at ply {t}; the cpu's two best sampling scores {top[0]:.7g}, {top[1]:.7g}")
        parted.append((gi, t, near))
    log(f"gatekeeper (b) card vs cpu, {games} games at {visits} visits float32, same draws: move records equal in "
        f"{games - len(parted)} of {games} games; tallies {rk.wins_a}-{rk.wins_b}-{rk.draws} / {rc.wins_a}-{rc.wins_b}-"
        f"{rc.draws}; card {tk:.1f} s, cpu {tc:.1f} s")
    if not all(near for _, _, near in parted):
        raise AssertionError("card and cpu gating matches part where the sampling scores are not a near tie")
    if not parted and (rk.wins_a, rk.wins_b, rk.draws) != (rc.wins_a, rc.wins_b, rc.draws):
        raise AssertionError("card and cpu play the same games and tally them differently")
    return {"games": games, "parted": len(parted), "card_s": tk, "cpu_s": tc}


def phase_loop(dev, cfg, root, rows=1000, batch=64, visits=8, moves=6, steps=20, gate_games=16, gate_visits=8):
    """One cycle of `command.loop.run_loop` at reduced depth on a base dir
    under `root` whose models/ holds run-s5200 and whose train/run/ holds the
    flagship checkpoint (step 5200): selfplay B=`batch` at `visits` visits,
    `moves`-move segments, until `rows` rows (the first flush comes after 4
    segments, by when every game has ended), the shuffle, `steps` b6c96 train steps at B=`batch`,
    the export, and a gate of `gate_games` games at `gate_visits` visits.
    Checks the shards (read back), the shuffled chunks, the checkpoint's
    step, the export gated into models/ or rejectedmodels/, and its gating
    SGFs replayed."""
    import os

    import torch

    from katacoffee_tpu_torch.command import loop
    from katacoffee_tpu_torch.dataio import checkpoints as ckpt

    base = os.path.join(root, "loop")
    model = os.path.basename(MODEL_DIR)
    shutil.copytree(MODEL_DIR, os.path.join(base, "models", model))
    ckpt_path = os.path.join(base, "train", "run", "checkpoint.ckpt")
    os.makedirs(os.path.dirname(ckpt_path))
    shutil.copy(FLAGSHIP_CKPT, ckpt_path)
    start = ckpt.read_raw(ckpt_path)[0]["train_step"]
    lc = loop.LoopConfig(num_cycles=1, rows_per_cycle=rows, selfplay_batch=batch, selfplay_visits=visits,
                         moves_per_segment=moves, train_steps_per_cycle=steps, train_batch=batch, model="b6c96", gate_games=gate_games,
                         gate_visits=gate_visits, seed=0)
    t = time.monotonic()
    loop.run_loop(base, cfg, lc, device=dev)
    torch.cuda.synchronize()
    wall = time.monotonic() - t
    got, _ = read_daemon_rows(cfg, base, model, dev)
    shuffled = [n for n in os.listdir(os.path.join(base, "shuffleddata")) if n.endswith(".npz")]
    step = ckpt.read_raw(ckpt_path)[0]["train_step"]
    export = f"run-s{start + steps}"
    landed = [d for d in ("models", "rejectedmodels") if os.path.isdir(os.path.join(base, d, export))]
    sgf_dir = os.path.join(base, "gatekeepersgfs", export)
    sgfs = sorted(os.path.join(sgf_dir, n) for n in os.listdir(sgf_dir)) if os.path.isdir(sgf_dir) else []
    ok = (got["weight"].shape[0] >= rows and shuffled and step == start + steps and len(landed) == 1
          and not os.listdir(os.path.join(base, "modelstobetested")) and len(sgfs) == gate_games)
    if not ok:
        raise AssertionError(f"loop cycle: {got['weight'].shape[0]} rows, shuffled {shuffled}, checkpoint step {step}, "
                             f"{export} in {landed}, {len(sgfs)} gating SGFs")
    replay_sgfs(cfg, sgfs, dev)
    log(f"gatekeeper (c) the loop, one cycle: selfplay B={batch} {visits} visits wrote {got['weight'].shape[0]} rows, "
        f"shuffled into {shuffled}, {steps} b6c96 B={batch} train steps from step {start} to {step}, {export} gated "
        f"({gate_games} games at {gate_visits} visits) into {landed[0]}, its SGFs replayed; {wall:.1f} s")
    return {"wall_s": wall, "rows": int(got["weight"].shape[0]), "export": export, "landed": landed[0]}


GTP_CFG = "configs/gtp_example.cfg"
GTP_WINRATE_TOL = 2e-4  # tests/torch_parity.py assert_same_search: float32 sums of another order


def gtp_engine(dev, dtype=None, visits=None, overrides=None, **kw):
    """The GTP engine as `python -m katacoffee_tpu_torch gtp -config GTP_CFG
    -model MODEL_DIR` builds it (command/gtp.py `main`, cli.py `_gtp`):
    configs/gtp_example.cfg over SearchParams.for_tests_v2(), run-s5200 on
    `dev` (bf16 trunk unless `dtype`), its evaluator and cached full-head
    forward; `visits` in place of the config's maxVisits, as
    `-override-config maxVisits=...` gives it, and `overrides` ("k=v,...")
    as the rest of -override-config. Returns (GTPEngine, SearchParams,
    GameConfig, maxVisits)."""
    from katacoffee_tpu_torch.command.gtp import GTPEngine
    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.program.setup import load_game_config, load_search_params
    from katacoffee_tpu_torch.search import mcts
    from katacoffee_tpu_torch.search.params import SearchParams
    from katacoffee_tpu_torch.utils.config import ConfigParser

    c = ConfigParser(GTP_CFG, overrides=overrides)
    sp = load_search_params(c, SearchParams.for_tests_v2())
    model, cfg, _ = load_exported_model(MODEL_DIR, dev, dtype)
    if load_game_config(c) != cfg:
        raise AssertionError(f"{GTP_CFG} plays {load_game_config(c)}, the model {cfg}")
    visits = visits or c.get_int("maxVisits")
    eng = GTPEngine(cfg, sp, mcts.make_nn_eval_fn(cfg, model), max_visits=visits,
                    raw_fwd=mcts.make_cached_raw_forward_fn(cfg, model), device=dev, **kw)
    return eng, sp, cfg, visits


def gtp_session(eng, lines) -> list[tuple[str, str, float]]:
    """Feeds `lines` to the engine one at a time: (line, reply, seconds)."""
    import torch

    out = []
    for line in lines:
        t = time.monotonic()
        reply = eng.handle(line)
        torch.cuda.synchronize()
        dt = time.monotonic() - t
        reply = reply[0] if isinstance(reply, tuple) else reply
        out.append((line, reply, dt))
        log(f"  gtp> {line}  ({dt:.3f} s)")
        for r in reply.splitlines():
            log(f"  gtp< {r}")
    return out


def phase_gtp(dev, snapshot_every=200, profile_sims=5, visits=200, ponder_visits=100, cpu_visits=64, cpu_moves=2,
              cli_visits=100):
    """The GTP engine, the main path when it was ported. (a) `gtp_engine` (`visits`,
    cut from the config's 400; graph search, noise pruning, uncertainty, subtree bias, root
    symmetry pruning; ponder off) over a scripted session: clear_board, two
    genmoves of alternating colour, kata-analyze b maxmoves 3 ownership
    true, the same with `avoid b <its best move> 1`, kata-raw-nn 0,
    genmove_debug b, quit, with `PathCopies` entered around it (launch
    counts set to 0 before and read after, one descent launch a simulation);
    each reply checked and printed with its seconds, root visits/s a
    genmove; a profile of a B=1 search of the same params (launches and host
    syncs a playout); one `genmove b` through `python -m
    katacoffee_tpu_torch gtp -config ... -model ...` in a subprocess, at
    `cli_visits` (-override-config maxVisits), started before the session
    and read after it; then a
    ponder of `ponder_visits` and a genmove that starts from the pondered
    root. (b) Each kernel held to its plain version on the session's copies
    (noise pruning: all five scratch fields, rank_c included) and timed;
    the descent also with an avoid_until mask that forbids lanes at depths
    1 and more on the copy with the deepest levels (forbidden lanes hit
    counted, at least one) and with one that forbids every lane (ignored).
    (c) A float32 engine plays `cpu_moves` genmoves at `cpu_visits` visits
    on the card and on the CPU: the same moves and root visit counts, root
    and row winrates within GTP_WINRATE_TOL."""
    import numpy as np
    import torch

    from katacoffee_tpu_torch.game import io as gio
    from katacoffee_tpu_torch.search import mcts

    eng, sp, cfg, visits = gtp_engine(dev, visits=visits)
    log(f"gtp (a): {GTP_CFG} over for_tests_v2(): {visits} visits (-override-config maxVisits), useGraphSearch "
        f"{sp.useGraphSearch}, useNoisePruning {sp.useNoisePruning}, useUncertainty {sp.useUncertainty}, "
        f"subtreeValueBiasFactor {sp.subtreeValueBiasFactor}, rootSymmetryPruning {sp.rootSymmetryPruning}; run-s5200 bf16")
    genmoves = ["genmove b", "genmove w"]
    analyze = "kata-analyze b maxmoves 3 ownership true"
    t_cli = time.monotonic()
    proc = subprocess.Popen([sys.executable, "-m", "katacoffee_tpu_torch", "gtp", "-config", GTP_CFG,
                             "-override-config", f"maxVisits={cli_visits}", "-model", MODEL_DIR],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        proc.stdin.write("genmove b\nquit\n")
        proc.stdin.flush()
        t = time.monotonic()
        with PathCopies(snapshot_every) as copies:
            session = gtp_session(eng, ["clear_board", *genmoves, analyze])
            best = session[-1][1].split()[3]
            session += gtp_session(eng, [f"{analyze} avoid b {best} 1", "kata-raw-nn 0", "genmove_debug b", "quit"])
        wall = time.monotonic() - t
        cli_out, cli_err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    cli_s = time.monotonic() - t_cli
    replies = {line: reply for line, reply, _ in session}
    for line, reply, _ in session:
        if not reply.startswith("="):
            raise AssertionError(f"gtp: {line!r} answered {reply!r}")
    moves = [reply[2:] for line, reply, _ in session if line.startswith("genmove")]
    for m in moves:
        gio.parse_loc(m, cfg)  # a move string
    a1, a2 = replies[analyze], replies[f"{analyze} avoid b {best} 1"]
    if " ownership " not in a1 or not 1 <= a1.count("info move") <= 3 or f"info move {best} " in a2:
        raise AssertionError(f"gtp: the analyses do not hold 1-3 rows with ownership, or the avoided {best} shows")
    if "whiteWin" not in replies["kata-raw-nn 0"]:
        raise AssertionError("gtp: kata-raw-nn printed no evaluation")
    genmove_s = [dt for line, _, dt in session if line.startswith("genmove")]
    searches = len(genmove_s) + 2
    log(f"gtp (a): session {wall:.3f} s; genmove seconds {[round(x, 3) for x in genmove_s]}, root visits/s "
        f"{[round(visits / x, 1) for x in genmove_s]}; launches: descend_interior {copies.launches['descend_interior']} "
        f"for {copies.sims} simulations run, gather_rows {copies.launches['gather_rows']} (shapes "
        f"{sorted(copies.gathers)})")
    copies.check_launches("gtp", 1)
    if copies.sims != searches * visits:
        raise AssertionError(f"gtp: {copies.sims} simulations run, not {searches} searches of {visits}")
    deepest = max(copies.descents[1], key=lambda c: int(c[2].node_count[0]))

    engine = eng.engine
    roots = engine.state

    def search(wrap=lambda name, fn: fn):
        mcts.run_search(cfg, sp, wrap("net", engine.eval_fn), roots, profile_sims, device=dev)
        torch.cuda.synchronize()

    prof = phase_profile(dev, "gtp B=1 fresh", search, profile_sims)

    cli_reply = cli_out.strip().splitlines()[0] if cli_out.strip() else ""
    log(f"gtp (a): python -m katacoffee_tpu_torch gtp -config {GTP_CFG} -override-config maxVisits={cli_visits} "
        f"-model {MODEL_DIR}: 'genmove b' -> {cli_reply!r}, exit {proc.returncode}, {cli_s:.1f} s with the "
        f"process's start, beside the session")
    if proc.returncode != 0 or not cli_reply.startswith("= "):
        raise AssertionError(f"gtp: the command failed: {cli_out[-2000:]}{cli_err[-2000:]}")
    gio.parse_loc(cli_reply[2:], cfg)

    engine.clear_board()
    engine.reuse_enabled = True
    engine.min_reuse_cap = engine._bucket_cap(max(visits, ponder_visits))
    pondered = [done for _, done in engine.ponder_stream(ponder_visits, interval_visits=visits // 4)]
    sims = [0]
    kept = mcts._simulate_once

    def counting(*args, **kwargs):
        sims[0] += 1
        return kept(*args, **kwargs)

    mcts._simulate_once = counting
    try:
        t = time.monotonic()
        _, res = engine.genmove(visits)
        torch.cuda.synchronize()
        reuse_s = time.monotonic() - t
    finally:
        mcts._simulate_once = kept
    log(f"gtp (a): ponder {ponder_visits} visits (root visits by chunk {pondered}), then genmove {visits}: "
        f"{sims[0]} playouts in {reuse_s:.3f} s, root {res.root_visits} visits")
    if pondered[-1] != ponder_visits + 1 or sims[0] != visits + 1 - pondered[-1] or res.root_visits != visits + 1:
        raise AssertionError("gtp: the genmove after a ponder did not start from the pondered root")
    engine.reuse_enabled = False

    checked = copies.check("gtp (b)", cfg)
    n, dsp, tree, inputs, _, _ = deepest
    B, _, A = tree.prior.shape
    rng = np.random.default_rng(5)
    until = rng.integers(2, 8, (B, 2, A)) * (rng.random((B, 2, A)) < 0.4)
    forbid = check_path_descent(f"gtp (b) launch {n}, avoid_until at depths 1-6", cfg, dsp, tree, inputs, False,
                                torch.from_numpy(until.astype(np.int32)).to(dev))
    ignored = check_path_descent(f"gtp (b) launch {n}, every lane forbidden", cfg, dsp, tree, inputs, False,
                                 torch.full((B, 2, A), 30, dtype=torch.int32, device=dev))
    log(f"gtp (b): descent kernel == plain (leaf, depth, path, acts, edge visits, cs_raw, prior_c, child_c, ev_c, "
        f"rank_c, caught) with avoid_until on launch {n}'s tree: {forbid['timed_levels']} levels, "
        f"{forbid['forbidden_lanes']} forbidden lanes hit; with every lane forbidden (mask ignored): "
        f"{ignored['timed_levels']} levels, {ignored['forbidden_lanes']} lanes hit")
    if forbid["forbidden_lanes"] == 0 or ignored["forbidden_lanes"] != 0:
        raise AssertionError("gtp (b): no forbidden lane was hit, or a mask that leaves no lane was not ignored")

    t = time.monotonic()
    runs = []
    for d in (dev, torch.device("cpu")):
        e = gtp_engine(d, torch.float32)[0].engine
        runs.append([e.genmove(cpu_visits) for _ in range(cpu_moves)])
    card_cpu = {"moves": [a for a, _ in runs[0]], "max_winrate_diff": 0.0}
    for (ca, cres), (pa, pres) in zip(*runs):
        rows = [(m.action, m.visits) for m in cres.move_infos], [(m.action, m.visits) for m in pres.move_infos]
        if ca != pa or rows[0] != rows[1] or cres.root_visits != pres.root_visits:
            raise AssertionError(f"gtp (c): card and CPU part: {ca} {rows[0]} against {pa} {rows[1]}")
        diffs = [abs(cres.root_winrate - pres.root_winrate)] + [
            abs(x.winrate - y.winrate) for x, y in zip(cres.move_infos, pres.move_infos)]
        card_cpu["max_winrate_diff"] = max(card_cpu["max_winrate_diff"], *diffs)
    log(f"gtp (c): float32 engine, {cpu_moves} genmoves at {cpu_visits} visits on the card and the CPU: moves "
        f"{[gio.action_to_string(a, cfg) for a in card_cpu['moves']]} equal, root and row visits equal, winrates "
        f"within {card_cpu['max_winrate_diff']:.3g} ({time.monotonic() - t:.1f} s)")
    if card_cpu["max_winrate_diff"] > GTP_WINRATE_TOL:
        raise AssertionError(f"gtp (c): winrates part by more than {GTP_WINRATE_TOL}")
    main_shape = (1, visits + 2, 8, cfg.policy_size)
    return {"visits": visits, "wall_s": wall, "genmove_s": genmove_s, "moves": moves, "launches": copies.launches,
            "sims": copies.sims, "profile": prof, "cli_s": cli_s, "cli_reply": cli_reply,
            "ponder": {"pondered": pondered, "genmove_playouts": sims[0], "genmove_s": reuse_s},
            "forbidden_lanes": forbid["forbidden_lanes"], "forbid_levels": forbid["timed_levels"],
            "card_vs_cpu": card_cpu, **checked,
            "gather_shape": main_shape if main_shape in checked["gather"] else next(iter(checked["gather"]))}


REF_SGFS = "tests/goldens/ref_sgfs/ref_000.sgfs"
ANALYSIS_TOL = 2e-4  # GTP_WINRATE_TOL's rule: float32 sums of another order


def ref_game_moves(k: int, cfg) -> list[list[str]]:
    """Game k (counted from 0, one a line) of REF_SGFS as the analysis
    protocol's [player, compact move] pairs."""
    from katacoffee_tpu_torch.dataio.sgf import parse_sgf
    from katacoffee_tpu_torch.game import io as gio

    line = Path(REF_SGFS).read_text().splitlines()[k]
    return [["B" if pla == 1 else "W", gio.loc_to_compact(x, y, d, cfg)] for x, y, d, pla in parse_sgf(line).moves()]


def legal_after(cfg, moves) -> list[str]:
    """The legal compact moves after `moves`, in action order (on the CPU)."""
    import torch

    from katacoffee_tpu_torch.game import io as gio
    from katacoffee_tpu_torch.game.board import init_state, legal_mask_flat, step

    st = init_state(cfg, 1, "cpu")
    for _, m in moves:
        x, y, d = gio.parse_loc(m, cfg)
        st = step(cfg, st, torch.tensor([d * cfg.area + y * cfg.x_size + x]))
    return [gio.action_to_compact(int(a), cfg) for a in torch.nonzero(legal_mask_flat(cfg, st)[0])[:, 0]]


def analysis_engine(dev, dtype=None, raw=True):
    """The analysis engine as `python -m katacoffee_tpu_torch analysis -model
    MODEL_DIR` builds it (cli.py `_analysis`, command/analysis.py `main`):
    for_tests_v2(), 100 default visits, seed 0, run-s5200 on `dev` (bf16
    trunk unless `dtype`), an evaluator factory and, with `raw`, the cached
    full-head forward factory. Returns (AnalysisEngine, GameConfig)."""
    from katacoffee_tpu_torch.command.analysis import AnalysisEngine
    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.search import mcts
    from katacoffee_tpu_torch.search.params import SearchParams

    model, cfg, _ = load_exported_model(MODEL_DIR, dev, dtype)
    eng = AnalysisEngine(SearchParams.for_tests_v2(), lambda c: mcts.make_nn_eval_fn(c, model),
                         raw_forward_factory=(lambda c: mcts.make_cached_raw_forward_fn(c, model)) if raw else None,
                         seed=0, device=dev)
    return eng, cfg


def analysis_script(cfg, review_visits=400, batch_visits=200, stream_visits=200) -> list[dict]:
    """Phase 10 (a)'s queries: query_version; r0, the whole-game review of
    REF_SGFS game 0 (every live ply, ownership, policy and PV visits); c0-c11,
    the position after ply 4 + (k mod 6) of game 2 + k each, c3 avoiding
    every move of direction 0 for its mover to depth 3 (so that the descent
    meets avoided lanes two plies down) and c7 allowing two legal moves to
    depth 3; s0 streamed every 0.5 s; p0 at priority -1, then its
    terminate."""
    from katacoffee_tpu_torch.game import io as gio

    g0 = ref_game_moves(0, cfg)
    queries = [{"action": "query_version", "id": "v"},
               {"id": "r0", "moves": g0, "analyzeTurns": list(range(len(g0))), "maxVisits": review_visits,
                "includeOwnership": True, "includePolicy": True, "includePVVisits": True}]
    for k in range(12):
        moves = ref_game_moves(2 + k, cfg)[:4 + k % 6]
        q = {"id": f"c{k}", "moves": moves, "maxVisits": batch_visits}
        mover = "B" if len(moves) % 2 == 0 else "W"
        legal = legal_after(cfg, moves)
        if k == 3:
            q["avoidMoves"] = [{"player": mover, "moves": [gio.action_to_compact(a, cfg) for a in range(cfg.area)],
                                "untilDepth": 3}]
        if k == 7:
            q["allowMoves"] = [{"player": mover, "moves": [legal[0], legal[-1]], "untilDepth": 3}]
        queries.append(q)
    queries.append({"id": "s0", "moves": ref_game_moves(14, cfg)[:5], "maxVisits": stream_visits,
                    "reportDuringSearchEvery": 0.5})
    queries.append({"id": "p0", "moves": ref_game_moves(15, cfg)[:4], "maxVisits": batch_visits, "priority": -1})
    queries.append({"action": "terminate", "id": "t", "terminateId": "p0"})
    return queries


def run_analysis(eng, queries) -> list[dict]:
    import io

    out = io.StringIO()
    eng.run(io.StringIO("\n".join(json.dumps(q) for q in queries) + "\n"), out)
    return [json.loads(line) for line in out.getvalue().splitlines()]


def check_review(queries, reports) -> dict:
    """The checks of phase 10 (a) on the reports: one final report a live
    turn, root visits at least maxVisits, c3 without an avoided row, c7's
    rows within its allowed moves, ownership in [-1, 1], s0 streamed, p0
    terminated."""
    by_id = {q["id"]: q for q in queries}
    finals = [r for r in reports if r.get("isDuringSearch") is False and "moveInfos" in r]
    for r in finals:
        if r["rootInfo"]["visits"] < by_id[r["id"]]["maxVisits"] or not r["moveInfos"]:
            raise AssertionError(f"analysis: {r['id']} turn {r['turnNumber']}: {r['rootInfo']['visits']} root "
                                 f"visits, {len(r['moveInfos'])} rows")
        own = r.get("ownership", [])
        if any(not -1.0 <= v <= 1.0 for v in own):
            raise AssertionError(f"analysis: {r['id']} ownership outside [-1, 1]")
    got = sorted((r["id"], r["turnNumber"]) for r in finals)
    want = sorted([("r0", t) for t in by_id["r0"]["analyzeTurns"]] + [(f"c{k}", len(by_id[f"c{k}"]["moves"]))
                                                                      for k in range(12)] + [("s0", 5)])
    if got != want:
        raise AssertionError(f"analysis: final reports {got}, not {want}")
    rows = {r["id"]: {mi["move"] for mi in r["moveInfos"]} for r in finals if r["id"][0] in "cs"}
    avoided = set(by_id["c3"]["avoidMoves"][0]["moves"])
    allowed = set(by_id["c7"]["allowMoves"][0]["moves"])
    if rows["c3"] & avoided or not rows["c7"] <= allowed:
        raise AssertionError(f"analysis: c3 rows {rows['c3']} meet its avoided moves, or c7 rows {rows['c7']} "
                             f"leave {allowed}")
    stream = [r["isDuringSearch"] for r in reports if r.get("id") == "s0"]
    if stream.count(False) != 1 or stream.count(True) < 1:
        raise AssertionError(f"analysis: s0 reported {stream}")
    if [r for r in reports if r.get("id") == "p0"] != [
            {"id": "p0", "turnNumber": 4, "isDuringSearch": False, "noResults": True}]:
        raise AssertionError("analysis: p0 was not answered noResults")
    owned = sum(len(r.get("ownership", [])) for r in finals)
    return {"finals": len(finals), "interim_s0": stream.count(True), "ownership_values": owned,
            "c3_rows": sorted(rows["c3"]), "c7_rows": sorted(rows["c7"])}


def compare_reports(label, a, b, tol=ANALYSIS_TOL) -> float:
    """Two runs' final reports: the same moves, visits, orders and PVs;
    winrate, lcb and utility of the root and the rows within `tol`.
    Returns the largest difference."""
    fa = [r for r in a if "moveInfos" in r]
    fb = [r for r in b if "moveInfos" in r]
    worst = 0.0
    if [(r["id"], r["turnNumber"]) for r in fa] != [(r["id"], r["turnNumber"]) for r in fb]:
        raise AssertionError(f"{label}: different reports")
    for ra, rb in zip(fa, fb):
        rows = [[(m["move"], m["visits"], m["order"], m["pv"]) for m in r["moveInfos"]] for r in (ra, rb)]
        if rows[0] != rows[1] or ra["rootInfo"]["visits"] != rb["rootInfo"]["visits"]:
            raise AssertionError(f"{label}: {ra['id']} turn {ra['turnNumber']} parts: {rows[0]} against {rows[1]}")
        pairs = [(ra["rootInfo"][k], rb["rootInfo"][k]) for k in ("winrate", "utility")]
        pairs += [(x[k], y[k]) for x, y in zip(ra["moveInfos"], rb["moveInfos"]) for k in ("winrate", "lcb", "utility")]
        worst = max([worst] + [abs(x - y) for x, y in pairs])
    if worst > tol:
        raise AssertionError(f"{label}: floats part by {worst} > {tol}")
    return worst


def phase_analysis(dev, snapshot_every=100, profile_sims=5, review_visits=400, batch_visits=200, stream_visits=200,
                   cpu_visits=64, cli_visits=100, evalsgf_visits=100):
    """The analysis engine, this slice's main path. (a) `analysis_engine`
    (run-s5200 bf16, for_tests_v2(), seed 0) over `analysis_script` through
    `run()`, with `PathCopies` entered around it (launch counts set to 0
    before and read after, one descent launch a playout) and each search
    call timed (run_search and continue_search, ended by a device sync):
    the seconds of each call with its lanes and batch, root visits/s over
    lanes x visits, `num_search_calls` (3: r0 at B=21, the c-batch padded
    from 12 lanes to 16, s0), the checks of `check_review`; a profile of 10
    playouts at the c-batch's shape (B=16, its roots and masks). (b) Each
    kernel held to its plain version on the copies (padding lanes
    included) and timed, the forbidden lanes hit in c3's and c7's games
    counted. (c) A float32 engine on the card and on the CPU over one
    4-turn query and then two compatible queries at `cpu_visits`: the same
    moves, visits, orders and PVs, floats within ANALYSIS_TOL. (d) `python
    -m katacoffee_tpu_torch analysis -model` in a subprocess fed two queries
    at `cli_visits` on a pipe (the interactive `select` path); `evalsgf` on
    game 1 before move 6 at 100 visits and `genconfig -noninteractive
    -model` in process (its benchmark cut to one timed search after the
    warm-up, 3 until the book's phase came), the config read back."""
    import contextlib
    import io

    import numpy as np
    import torch

    from katacoffee_tpu_torch.command import analysis as analysis_cmd
    from katacoffee_tpu_torch.command import benchmark as benchmark_cmd
    from katacoffee_tpu_torch.command import evalsgf, genconfig
    from katacoffee_tpu_torch.game.board import init_state
    from katacoffee_tpu_torch.program.setup import load_search_params
    from katacoffee_tpu_torch.search import mcts
    from katacoffee_tpu_torch.search.params import SearchParams
    from katacoffee_tpu_torch.utils.config import ConfigParser

    eng, cfg = analysis_engine(dev)
    queries = analysis_script(cfg, review_visits, batch_visits, stream_visits)
    search_log = []
    eng.logger, eng.log_search_info = type("Lines", (), {"write": lambda self, m: search_log.append(m)})(), True
    calls = []
    kept = mcts.run_search, mcts.continue_search

    def timed(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.monotonic()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            calls.append((name, int(args[3].stats.shape[0] if name == "continue" else args[3].board.shape[0]),
                          time.monotonic() - t))
            return out
        return call

    mcts.run_search, mcts.continue_search = timed("run", kept[0]), timed("continue", kept[1])
    t = time.monotonic()
    try:
        with PathCopies(snapshot_every) as copies:
            reports = run_analysis(eng, queries)
    finally:
        mcts.run_search, mcts.continue_search = kept
    wall = time.monotonic() - t
    checked_reports = check_review(queries, reports)
    if eng.num_search_calls != 3:
        raise AssertionError(f"analysis: {eng.num_search_calls} search calls, not 3")
    by_id = {q["id"]: q for q in queries}
    searches = []
    for line in search_log:
        lanes = int(line.split(" lanes=")[1].split()[0])
        visits = int(line.split(" visits=")[1].split()[0])
        searches.append({"log": line, "lanes": lanes, "visits": visits})
    runs = [c for c in calls if c[0] == "run"]
    for s, (_, batch, sec) in zip(searches, runs):
        s["batch"] = batch
        s["seconds"] = sec
    # the streamed search: its run_search(0) and every continue_search chunk
    searches[-1]["seconds"] += sum(c[2] for c in calls if c[0] == "continue")
    searches[-1]["chunks"] = sum(c[0] == "continue" for c in calls)
    for s in searches:
        s["root_vps"] = s["lanes"] * s["visits"] / s["seconds"]
        s["batch_vps"] = s["batch"] * s["visits"] / s["seconds"]
    if [(s["lanes"], s["batch"]) for s in searches] != [(21, 21), (12, 16), (1, 1)]:
        raise AssertionError(f"analysis: searches {[(s['lanes'], s['batch']) for s in searches]}")
    sims_want = sum(s["visits"] for s in searches)  # a simulation runs every lane of its batch
    log(f"analysis (a): run() {wall:.3f} s; " + "; ".join(
        f"{s['log'].split(' visits=')[0][len('Search: '):]}: {s['seconds']:.3f} s, {s['root_vps']:.1f} root "
        f"visits/s over lanes ({s['batch_vps']:.1f} over the batch)" for s in searches)
        + f"; num_search_calls {eng.num_search_calls}; launches: descend_interior "
        f"{copies.launches['descend_interior']} for {copies.sims} simulations run, gather_rows "
        f"{copies.launches['gather_rows']} (shapes {sorted(copies.gathers)}); reports {checked_reports}")
    copies.check_launches("analysis", 16)
    if copies.sims != sims_want:
        raise AssertionError(f"analysis: {copies.sims} simulations run, not {sims_want}")

    preps = [eng._prepare(by_id[f"c{k}"]) for k in range(12)]
    roots = analysis_cmd._cat([p["states_by_turn"][p["live"][0]] for p in preps] + [init_state(cfg, 4, dev)])
    avoid = torch.from_numpy(np.concatenate([p["avoid"] for p in preps] + [np.zeros((4, cfg.policy_size), bool)]))
    until = torch.from_numpy(np.concatenate([p["avoid_until"] for p in preps]
                                            + [np.zeros((4, 2, cfg.policy_size), np.int32)]))
    sp = eng.sp
    ev = eng._eval_fn(cfg)

    def search(wrap=lambda name, fn: fn):
        mcts.run_search(cfg, sp, wrap("net", ev), roots, profile_sims, device=dev, root_avoid=avoid.to(dev),
                        avoid_until=until.to(dev))
        torch.cuda.synchronize()

    prof = phase_profile(dev, "analysis c-batch B=16 fresh", search, profile_sims)

    checked = copies.check("analysis (b)", cfg)
    by_game = checked["descent"][16].get("forbidden_by_game", [0] * 16)
    forbidden = {"c3": by_game[3], "c7": by_game[7], "other_lanes": sum(by_game) - by_game[3] - by_game[7]}
    log(f"analysis (b): forbidden lanes hit in the c-batch's copies: {forbidden}")
    if forbidden["c3"] + forbidden["c7"] == 0 or forbidden["other_lanes"] != 0:
        raise AssertionError("analysis (b): no forbidden lane hit in c3 or c7, or one in an unrestricted lane")

    t = time.monotonic()
    first = [{"id": "f0", "moves": ref_game_moves(20, cfg)[:3], "analyzeTurns": [0, 1, 2, 3],
              "maxVisits": cpu_visits}]
    pair = [{"id": f"f{k}", "moves": ref_game_moves(20 + k, cfg)[:4 + k], "maxVisits": cpu_visits} for k in (1, 2)]
    outs = []
    for d in (dev, torch.device("cpu")):
        e = analysis_engine(d, torch.float32, raw=False)[0]
        outs.append(run_analysis(e, first) + run_analysis(e, pair))
        if e.num_search_calls != 2:
            raise AssertionError(f"analysis (c): {e.num_search_calls} search calls on {d}, not 2")
    card_cpu = compare_reports("analysis (c) card against CPU", *outs)
    log(f"analysis (c): float32 engine on the card and the CPU, a 4-turn query then two compatible ones at "
        f"{cpu_visits} visits: moves, visits, orders and PVs equal, floats within {card_cpu:.3g} "
        f"({time.monotonic() - t:.1f} s)")

    t = time.monotonic()
    lines = [{"id": f"i{k}", "moves": ref_game_moves(30 + k, cfg)[:5], "maxVisits": cli_visits} for k in range(2)]
    proc = subprocess.run([sys.executable, "-m", "katacoffee_tpu_torch", "analysis", "-model", MODEL_DIR],
                          input="".join(json.dumps(q) + "\n" for q in lines), capture_output=True, text=True,
                          timeout=300)
    cli_s = time.monotonic() - t
    try:
        cli_reports = [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]
    except json.JSONDecodeError:
        cli_reports = []
    cli_ok = (proc.returncode == 0 and sorted(r.get("id") for r in cli_reports) == ["i0", "i1"]
              and all(r["rootInfo"]["visits"] >= cli_visits and not r["isDuringSearch"] for r in cli_reports))
    log(f"analysis (d): python -m katacoffee_tpu_torch analysis -model {MODEL_DIR}, two queries at {cli_visits} "
        f"visits on a pipe: {len(cli_reports)} reports, exit {proc.returncode}, {cli_s:.1f} s with the process's "
        f"start")
    if not cli_ok:
        raise AssertionError(f"analysis (d): the command failed: {proc.stdout[-2000:]}{proc.stderr[-2000:]}")

    work = Path(tempfile.mkdtemp(prefix="katacoffee_analysis_"))
    try:
        sgf = work / "game1.sgf"
        sgf.write_text(Path(REF_SGFS).read_text().splitlines()[1] + "\n")
        t = time.monotonic()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            evalsgf.main([str(sgf), "-move-num", "6", "-visits", str(evalsgf_visits), "-model", MODEL_DIR])
        evalsgf_s = time.monotonic() - t
        printed = buf.getvalue().splitlines()
        root = [x for x in printed if x.startswith("root: visits ")]
        rows = [x for x in printed if x.startswith("  ") and " v=" in x and " pv: " in x]
        log(f"analysis (d): evalsgf game 1 before move 6 at {evalsgf_visits} visits ({evalsgf_s:.1f} s): {root} and "
            f"{len(rows)} rows, the first {rows[:1]}")
        if len(root) != 1 or int(root[0].split()[2]) != evalsgf_visits + 1 or not rows:
            raise AssertionError(f"analysis (d): evalsgf printed {printed}")

        measured = []
        kept_bench = benchmark_cmd.benchmark_search

        def recording(*args, **kwargs):
            measured.append(kept_bench(*args, **kwargs, reps=1))  # depth cut: 3 timed searches to 1
            return measured[-1]

        benchmark_cmd.benchmark_search = recording
        t = time.monotonic()
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                genconfig.main(["-noninteractive", "-model", MODEL_DIR, "-output", str(work / "gen.cfg")])
        finally:
            benchmark_cmd.benchmark_search = kept_bench
        genconfig_s = time.monotonic() - t
        printed = buf.getvalue()
        c = ConfigParser(str(work / "gen.cfg"))
        gen_sp = load_search_params(c, SearchParams.for_tests_v2())
        gen_visits = c.get_int("maxVisits")
        vps = measured[0][1]
        printed_vps = float(printed.split("measured ")[1].split(" visits/s")[0])
        log(f"analysis (d): genconfig -noninteractive -model ({genconfig_s:.1f} s): {printed.strip()!r}; "
            f"{vps:.3f} visits/s measured, maxVisits {gen_visits}, useNoisePruning {gen_sp.useNoisePruning}")
        if gen_visits != max(16, int(vps * 2.0)) or abs(printed_vps - vps) > 0.5 or not gen_sp.useGraphSearch:
            raise AssertionError(f"analysis (d): genconfig wrote maxVisits {gen_visits} for {vps} visits/s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    main_shape = (16, by_id["c0"]["maxVisits"] + 2, 8, cfg.policy_size)
    return {"wall_s": wall, "searches": searches, "num_search_calls": eng.num_search_calls,
            "launches": copies.launches, "sims": copies.sims, "profile": prof, "reports": checked_reports,
            "forbidden": forbidden, "card_vs_cpu_max_diff": card_cpu, "cli_s": cli_s, "evalsgf_s": evalsgf_s,
            "genconfig_s": genconfig_s, "genconfig_vps": vps, "genconfig_max_visits": gen_visits, **checked,
            "gather_shape": main_shape if main_shape in checked["gather"] else next(iter(checked["gather"]))}


BOOK_TOL = 1e-6  # card against CPU, float32 book floats (float32 sums of another order; analysis (c) agreed within 2e-7)
REF_TOL = 1e-5  # the reference net's float32 forward, card against CPU


def _captured(fn, argv, **kwargs) -> tuple[object, str]:
    """(return value, standard output) of a command's main called in this
    process."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv, **kwargs)
    return rc, buf.getvalue()


def check_ref_fixtures(model, dev) -> int:
    """The imported reference net on `dev` against tests/goldens/refnn/*.json
    (the reference binary's own outputs) at tests/test_refmodel.py's
    tolerances, each file's positions replayed and evaluated as one batch.
    Returns the number of positions checked."""
    import numpy as np
    import torch

    from katacoffee_tpu_torch.game.board import GameConfig, GameState, init_state, legal_mask_flat, step
    from katacoffee_tpu_torch.nn.refmodel import ref_compat_features, ref_forward

    checked = 0
    for path in sorted(Path("tests/goldens/refnn").glob("*.json")):
        data = json.loads(path.read_text())
        cfg = GameConfig(data["x"], data["y"], data["win_len"])
        fixtures = data["fixtures"]
        n, T = len(fixtures), max(len(fx["moves"]) for fx in fixtures)
        acts = torch.tensor([[d * cfg.area + my * cfg.x_size + mx for mx, my, d in fx["moves"]]
                             + [0] * (T - len(fx["moves"])) for fx in fixtures], device=dev)
        lengths = torch.tensor([len(fx["moves"]) for fx in fixtures], device=dev)
        st = init_state(cfg, n, dev)
        for t in range(T):
            nxt = step(cfg, st, acts[:, t])
            live = t < lengths
            st = GameState(*(torch.where(live.reshape((n,) + (1,) * (o.dim() - 1)), x, o) for o, x in zip(st, nxt)))
        outs = {k: v.cpu().numpy() for k, v in ref_forward(model, *ref_compat_features(cfg, st)).items()}
        legals = legal_mask_flat(cfg, st).cpu().numpy()
        for i, fx in enumerate(fixtures):
            out = {k: v[i] for k, v in outs.items()}
            legal = legals[i]
            ref_policy = np.asarray(fx["policy"], np.float32)
            if not np.array_equal(legal, ref_policy >= 0.0):
                raise AssertionError(f"ref (e): {path.name} {fx['moves']}: legality differs from the reference's")
            lg = np.where(legal, out["policy_logits"], -np.inf)
            p = np.exp(lg - lg[legal].max())
            p = p / p[legal].sum()
            np.testing.assert_allclose(p[legal], ref_policy[legal], rtol=2e-3, atol=2e-6)
            vl = out["value_logits"]
            wl = np.exp(vl[:2] - vl[:2].max())
            wl = wl / wl.sum()
            mover_is_white = len(fx["moves"]) % 2 == 1
            white_win = wl[0] if mover_is_white else wl[1]
            np.testing.assert_allclose(white_win, fx["whiteWinProb"], atol=2e-5)
            np.testing.assert_allclose(1.0 - white_win, fx["whiteLossProb"], atol=2e-5)
            np.testing.assert_allclose(np.logaddexp(0.0, out["sv"][3]) * 40.0, fx["varTimeLeft"], rtol=2e-4)
            np.testing.assert_allclose(np.logaddexp(0.0, out["sv"][4] * 0.5) * 0.5, fx["shorttermWinlossError"],
                                       rtol=2e-4)
            own = np.tanh(out["ownership"].reshape(-1)) * (1.0 if mover_is_white else -1.0)
            np.testing.assert_allclose(own, np.asarray(fx["ownership"], np.float32), atol=2e-5)
            checked += 1
    return checked


def compare_books(label, a, b, tol=BOOK_TOL) -> float:
    """Two books: the same node keys in order, fields and edges (action,
    child key, visits); the floats within `tol`. Returns the largest float
    difference."""
    if list(a.nodes) != list(b.nodes) or a.best_line() != b.best_line():
        raise AssertionError(f"{label}: the node keys or best lines differ")
    worst = 0.0
    for k, x in a.nodes.items():
        y = b.nodes[k]
        exact = ("board", "to_move", "last_spot", "last_dir", "num_turns", "visits", "expanded", "rec_visits")
        if ([getattr(x, f) for f in exact] != [getattr(y, f) for f in exact]
                or [(m, e[0], e[2]) for m, e in x.edges.items()] != [(m, e[0], e[2]) for m, e in y.edges.items()]):
            raise AssertionError(f"{label}: node {k} differs: {x} against {y}")
        worst = max([worst, abs(x.unexpanded_mass - y.unexpanded_mass)]
                    + [abs(getattr(x, f) - getattr(y, f)) for f in ("winloss", "draw", "path_prob", "wl_cost",
                                                                    "book_wl")]
                    + [abs(e[1] - y.edges[m][1]) for m, e in x.edges.items()])
    if worst > tol:
        raise AssertionError(f"{label}: floats part by {worst} > {tol}")
    return worst


def phase_book(dev, grow_rounds=4, grow_visits=16, resume_rounds=1, batch=64, visits=300, snapshot_every=100,
               profile_sims=5, cpu_batch=8, cpu_visits=16, cpu_rounds=2, mine_visits=200, mine_positions=50,
               demo_visits=8, try_visits=16, init_num=64, counter_batch=64, counter_visits=64, counter_moves=3,
               flops_sims=4, ref_batch=64, ref_visits=100, ref_profile_sims=3):
    """The opening book, this slice's main path, then the other frontends of
    the slice. (a) `genbook -model run-s5200` (b6c96 bf16, for_tests_v2(),
    `-batch-size 64`) in this process: the book grown by `grow_rounds`
    rounds at `grow_visits` visits (the frontier grows from the one empty
    board, so only a later round has more than 32 nodes to search), then
    `resume_rounds` `-resume` rounds at the command's width, `-visits 300`
    (N=302) over a frontier of more than 32 nodes (B=64), with `PathCopies`
    entered around them (launch counts set to 0 before and read after: one
    descent launch a playout, at most two gathers a search): each round's
    wall ended by a sync, lanes and batch, root visits/s over the lanes,
    the seconds outside `run_search` (the batched child steps and keys, the
    host copy) and the node count; then writebook, checkbook (no errors)
    and booktoposes, every position it writes read back as a start
    position equal to its node; a profile of a B=64 search of the grown
    book's frontier as `Book.expand` pads it (N=302; launches, host reads
    and stream syncs a playout by caller). (b) Each kernel held to its
    plain version on (a)'s copies and timed: the gather at every shape,
    (64,302,8,100) among them; the descent on the deepest copied tree of
    the B=64 rounds. (c) A float32 book on the card
    and on the CPU (batch 8, 16 visits, 2 rounds): the same keys and edges,
    floats within BOOK_TOL. (d) dataminesgfs (one B=64 batch at 200 visits
    over the games of REF_SGFS), demoplay (1 game at 8 visits),
    trystartposes over datamine's output, sampleinitializations -evaluate,
    perfcount.search_counters (B=64, 64 visits, 3 moves) and
    flops_accounting (a B=64 forward; FLOPs a row, the share of the bf16
    peak). (e) The reference net (refbuild_patches/make_model.py's
    random-weights b6c96) on the card against the refnn fixtures, card
    against CPU within REF_TOL, and a B=64 search at 100 visits with
    make_ref_eval_fn, profiled by caller (the line features apart); all of
    (e) with TF32 switched on for the caller, which ref_forward turns off
    for itself."""
    import os

    import torch
    from torch.profiler import record_function

    from katacoffee_tpu_torch.book import Book
    from katacoffee_tpu_torch.book import book as book_mod
    from katacoffee_tpu_torch.book import build_book
    from katacoffee_tpu_torch.command import genbook, misc
    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.dataio.sgf import parse_sgf_file
    from katacoffee_tpu_torch.game.board import GameConfig, init_state
    from katacoffee_tpu_torch.nn import refmodel
    from katacoffee_tpu_torch.nn.features import extract_features
    from katacoffee_tpu_torch.ops.gather import gather_rows
    from katacoffee_tpu_torch.search import mcts
    from katacoffee_tpu_torch.search.params import SearchParams
    from katacoffee_tpu_torch.selfplay.startposes import load_startposes
    from katacoffee_tpu_torch.utils import perfcount

    cfg = GameConfig(5, 5, 4)
    sp = SearchParams.for_tests_v2()
    work = Path(tempfile.mkdtemp(prefix="katacoffee_book_"))
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        # (a) the book, through the command
        book_path = str(work / "book.json")
        round_log, searches = [], []
        kept = Book.expand, mcts.run_search

        def timed_search(*args, **kwargs):
            torch.cuda.synchronize()
            t, n = time.monotonic(), gather_rows.launches
            tree = kept[1](*args, **kwargs)
            torch.cuda.synchronize()
            searches.append((int(args[3].board.shape[0]), time.monotonic() - t, gather_rows.launches - n))
            return tree

        def timed_expand(self, keys, sp_, eval_fn, num_visits, *args, **kwargs):
            torch.cuda.synchronize()
            n, t = len(searches), time.monotonic()
            kept[0](self, keys, sp_, eval_fn, num_visits, *args, **kwargs)
            torch.cuda.synchronize()
            wall = time.monotonic() - t
            inside = sum(s[1] for s in searches[n:])
            round_log.append({"lanes": len(keys), "batch": searches[-1][0], "wall_s": wall, "search_s": inside,
                              "outside_s": wall - inside, "nodes": len(self.nodes),
                              "root_vps": len(keys) * num_visits / wall})

        argv = ["-out", book_path, "-model", MODEL_DIR, "-batch-size", str(batch)]
        Book.expand, mcts.run_search = timed_expand, timed_search
        t = time.monotonic()
        try:
            printed = _captured(genbook.main_genbook, argv + ["-visits", str(grow_visits), "-rounds",
                                                              str(grow_rounds)])[1]
            grown = len(round_log)
            with PathCopies(snapshot_every) as copies:
                printed += _captured(genbook.main_genbook, argv + ["-visits", str(visits), "-rounds",
                                                                   str(resume_rounds), "-resume"])[1]
        finally:
            Book.expand, mcts.run_search = kept
        wall = time.monotonic() - t
        for i, r in enumerate(round_log):
            log(f"book (a) round {i}: {r['lanes']} lanes, batch {r['batch']}, "
                f"{grow_visits if i < grown else visits} visits, {r['wall_s']:.3f} s ({r['search_s']:.3f} s in "
                f"run_search, {r['outside_s']:.4f} s outside it), {r['root_vps']:.1f} root visits/s over the lanes, "
                f"{r['nodes']} nodes")
        timed_rounds, timed_searches = round_log[grown:], searches[grown:]
        book = Book.load(book_path, dev)
        log(f"book (a): genbook {grown} rounds at {grow_visits} visits then {resume_rounds} -resume round(s) at "
            f"{visits}, {wall:.1f} s with both model loads; {len(book.nodes)} nodes; best line {book.best_line()}; "
            f"launches in the -resume rounds: descend_interior {copies.launches['descend_interior']} for "
            f"{copies.sims} simulations run, gather_rows {copies.launches['gather_rows']}, "
            f"{[s[2] for s in timed_searches]} in each of the {len(timed_searches)} searches, the rest in the rounds' "
            f"readouts (shapes {sorted(copies.gathers)})")
        if (grown != grow_rounds or len(timed_rounds) != resume_rounds or printed.count("saved ") != 2
                or any(r["batch"] != batch for r in timed_rounds)):
            raise AssertionError(f"book (a): {grown} + {len(timed_rounds)} rounds, batches "
                                 f"{[r['batch'] for r in round_log]}, printed {printed!r}")
        copies.check_launches("book", batch)
        in_search = [s[2] for s in timed_searches]
        if copies.sims != visits * len(timed_searches) or max(in_search) > 2:
            raise AssertionError(f"book (a): {copies.sims} simulations in {len(timed_searches)} searches, gathers in "
                                 f"each search {in_search}")

        rc, checkbook = _captured(genbook.main_checkbook, [book_path])
        edges = sum(len(n.edges) for n in book.nodes.values())
        if rc != 0 or not checkbook.endswith(f"{len(book.nodes)} nodes, {edges} edges, 0 errors\n"):
            raise AssertionError(f"book (a): checkbook exit {rc}: {checkbook}")
        _captured(genbook.main_writebook, [book_path, "-out-dir", str(work / "html")])
        pages = len(os.listdir(work / "html"))
        printed = _captured(genbook.main_booktoposes, [book_path, "-out-dir", str(work / "poses")])[1]
        poses = sorted((work / "poses").iterdir())
        for p in poses:
            node = book.nodes[p.stem]
            board = [[0] * cfg.x_size for _ in range(cfg.y_size)]
            for x, y, pla in parse_sgf_file(str(p)).placements():
                board[y][x] = pla
            if board != node.board:
                raise AssertionError(f"book (a): {p.name} is not its node's board")
        pool = load_startposes(cfg, str(work / "poses"), device=dev)
        if pool is None or pool[0].board.shape[0] != len(poses) or pages != len(book.nodes) + 3:
            raise AssertionError(f"book (a): {len(poses)} SGFs, {0 if pool is None else pool[0].board.shape[0]} "
                                 f"start positions read back, {pages} pages")
        log(f"book (a): checkbook {checkbook.strip()!r}; writebook {pages} files; booktoposes wrote {len(poses)} "
            f"positions, each its node's board, all read back as start positions")

        keys = book.frontier(batch)
        keys = keys + [keys[-1]] * (batch - len(keys))  # as Book.expand pads a frontier of more than 32
        roots = book_mod._node_states(cfg, [book.nodes[k] for k in keys], dev)
        net = load_exported_model(MODEL_DIR, dev)[0]
        ev = mcts.make_nn_eval_fn(cfg, net)

        def frontier_search(wrap=lambda name, fn: fn):
            mcts.run_search(cfg, sp, wrap("net", ev), roots, profile_sims, visits + 2, device=dev)
            torch.cuda.synchronize()

        prof = phase_profile(dev, f"book frontier search B={batch} (N={visits + 2})", frontier_search, profile_sims)

        # (b) the kernels on the path's copies
        checked = copies.check("book (b)", cfg)

        # (c) card against CPU, float32
        t = time.monotonic()
        books = []
        for d in (dev, torch.device("cpu")):
            net32 = load_exported_model(MODEL_DIR, d, torch.float32)[0]
            books.append(build_book(cfg, sp, mcts.make_nn_eval_fn(cfg, net32), cpu_rounds, cpu_batch, cpu_visits,
                                    log=lambda *a: None, device=d))
        card_cpu = compare_books("book (c) card against CPU", *books)
        log(f"book (c): float32 books on the card and the CPU, batch {cpu_batch}, {cpu_visits} visits, {cpu_rounds} "
            f"rounds: {len(books[0].nodes)} nodes, keys, edges and best lines equal, floats within {card_cpu:.3g} "
            f"({time.monotonic() - t:.1f} s)")

        # (d) the other frontends
        sgfs = work / "sgfs"
        sgfs.mkdir()
        for k, line in enumerate(Path(REF_SGFS).read_text().splitlines()):
            (sgfs / f"g{k:02d}.sgf").write_text(line + "\n")
        frontends = {}
        t = time.monotonic()
        printed = _captured(misc.main_dataminesgfs, [str(sgfs), "-out-dir", str(work / "mined"), "-model",
                                                      MODEL_DIR, "-visits", str(mine_visits), "-max-positions",
                                                      str(mine_positions)])[1]
        frontends["dataminesgfs_s"] = time.monotonic() - t
        words = printed.split()  # mined K interesting positions from C candidates into D
        mined, cands = int(words[1]), int(words[5])
        if not (mine_positions <= cands <= 64 and 0 < mined == len(os.listdir(work / "mined"))):
            raise AssertionError(f"book (d): dataminesgfs printed {printed!r}")
        t = time.monotonic()
        printed = _captured(misc.main_demoplay, ["-model", MODEL_DIR, "-visits", str(demo_visits)])[1]
        frontends["demoplay_s"] = time.monotonic() - t
        plies = printed.count(f"visits {demo_visits + 1})")
        if not printed.splitlines()[-1].startswith("result: ") or f"after {plies} moves" not in printed:
            raise AssertionError(f"book (d): demoplay printed {printed[-500:]!r}")
        t = time.monotonic()
        printed = _captured(misc.main_trystartposes, ["-start-poses-dir", str(work / "mined"), "-model", MODEL_DIR,
                                                      "-visits", str(try_visits)])[1]
        frontends["trystartposes_s"] = time.monotonic() - t
        if not printed.endswith(f"tried {mined} positions at {try_visits} visits\n"):
            raise AssertionError(f"book (d): trystartposes printed {printed[-500:]!r}")
        t = time.monotonic()
        printed = _captured(misc.main_sampleinitializations, ["-model", MODEL_DIR, "-num", str(init_num),
                                                              "-evaluate"])[1]
        frontends["sampleinitializations_s"] = time.monotonic() - t
        if printed.count("raw wl ") != init_num:
            raise AssertionError(f"book (d): sampleinitializations printed {printed[-500:]!r}")
        log(f"book (d): dataminesgfs mined {mined} of {cands} candidates at {mine_visits} visits (one B=64 batch) in "
            f"{frontends['dataminesgfs_s']:.1f} s; demoplay 1 game of {plies} plies at {demo_visits} visits in "
            f"{frontends['demoplay_s']:.1f} s; trystartposes {mined} positions at {try_visits} visits in "
            f"{frontends['trystartposes_s']:.1f} s; sampleinitializations -num {init_num} -evaluate in "
            f"{frontends['sampleinitializations_s']:.1f} s")

        counters = perfcount.search_counters(cfg, sp, ev, init_state, counter_batch, counter_visits, counter_moves,
                                             device=dev)
        log(f"book (d): perfcount.search_counters B={counter_batch}, {counter_visits} visits, {counter_moves} "
            f"moves: {counters}")
        if counters["rounds_per_move"][0] != counter_visits or counters["visits_per_nn_row"] < 1.0:
            raise AssertionError(f"book (d): the counters do not reconcile: {counters}")
        states = init_state(cfg, counter_batch, dev)

        def forward():
            net(*extract_features(cfg, states))

        def segment():
            mcts.run_search(cfg, sp, ev, states, flops_sims, device=dev)

        segment()
        torch.cuda.synchronize()
        t = time.monotonic()
        segment()
        torch.cuda.synchronize()
        seg_s = time.monotonic() - t
        flops = perfcount.flops_accounting(segment, forward, counter_batch, seg_s, device=dev)
        forward_ms = eager_ms(forward, 50)
        flops["forward_ms"] = forward_ms
        flops["forward_peak_share"] = flops["nn_forward_flops_per_row"] * counter_batch / (forward_ms / 1e3) / BF16_FLOPS
        log(f"book (d): flops_accounting, b6c96 bf16: {flops['nn_forward_flops_per_row']:.0f} FLOPs a row "
            f"(FlopCounterMode); one B={counter_batch} forward {forward_ms:.3f} ms between events, "
            f"{flops['forward_peak_share']:.3%} of the {BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 peak; a {flops_sims}-playout "
            f"B={counter_batch} search {seg_s:.3f} s, {flops['segment_flops']} FLOPs, mfu {flops.get('mfu')} "
            f"({flops['device_kind']}, {card_line()})")
        out.update(frontends=frontends, counters=counters, flops=flops)

        # (e) the reference net, TF32 on for the caller (ref_forward turns it
        # off for itself)
        t = time.monotonic()
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        (work / "ref").mkdir()
        subprocess.run([sys.executable, str(Path("refbuild_patches/make_model.py").resolve())], cwd=work / "ref",
                       check=True, capture_output=True, timeout=120)
        ref = refmodel.load_ref_model(str(work / "ref/models/coffee-b6c96-random.bin.gz"))
        fixtures = check_ref_fixtures(ref, dev)
        pos = random_positions(cfg, 16, seed=5)
        got = refmodel.ref_forward(ref, *refmodel.ref_compat_features(cfg, pos.map(lambda x: x.to(dev))))
        want = refmodel.ref_forward(ref, *refmodel.ref_compat_features(cfg, pos))
        ref_diff = max((got[k].cpu() - want[k]).abs().max().item() for k in want)
        if ref_diff > REF_TOL:
            raise AssertionError(f"ref (e): card against CPU {ref_diff} > {REF_TOL}")
        ref_ev = refmodel.make_ref_eval_fn(cfg, ref)
        ref_roots = random_positions(cfg, ref_batch, seed=6).map(lambda x: x.to(dev))
        torch.cuda.synchronize()
        t_search = time.monotonic()
        mcts.run_search(cfg, sp, ref_ev, ref_roots, ref_visits, device=dev)
        torch.cuda.synchronize()
        ref_search_s = time.monotonic() - t_search
        kept_lines = refmodel.ref_compat_line_features

        def lines(*args):
            with record_function("kc::line features"):
                return kept_lines(*args)

        def ref_search(wrap=lambda name, fn: fn):
            mcts.run_search(cfg, sp, wrap("net", ref_ev), ref_roots, ref_profile_sims, device=dev)
            torch.cuda.synchronize()

        refmodel.ref_compat_line_features = lines
        try:
            ref_prof = phase_profile(dev, f"ref net search B={ref_batch}", ref_search, ref_profile_sims)
        finally:
            refmodel.ref_compat_line_features = kept_lines
        log(f"ref (e), TF32 on for the caller: {fixtures} fixture positions match the reference binary on the card; "
            f"card against CPU within "
            f"{ref_diff:.3g}; a B={ref_batch} search at {ref_visits} visits {ref_search_s:.3f} s "
            f"({ref_batch * ref_visits / ref_search_s:.1f} root visits/s), line features "
            f"{ref_prof['by_phase'].get('line features', 0.0):.1f} launches a playout of "
            f"{ref_prof['launches_per_sim']:.0f} ({time.monotonic() - t:.1f} s)")
        out["ref"] = {"fixtures": fixtures, "card_vs_cpu_max_diff": ref_diff, "search_s": ref_search_s,
                      "profile": ref_prof}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        shutil.rmtree(work, ignore_errors=True)
    main_shape = (batch, visits + 2, 8, cfg.policy_size)
    return {"wall_s": wall, "rounds": timed_rounds, "grow_rounds": round_log[:grown], "nodes": len(book.nodes),
            "launches": copies.launches, "sims": copies.sims, "searches": len(timed_searches), "profile": prof,
            "card_vs_cpu_max_diff": card_cpu, **out, **checked,
            "visits": visits, "round_widths": sorted({r["batch"] for r in timed_rounds}),
            "gather_shape": main_shape if main_shape in checked["gather"] else max(checked["gather"])}


PROFILED = ("_descend_root", "_descend_interior", "_recompute_node", "_hash_lookup", "_bias_keys", "_bias_avg",
            "_root_eval", "_tree_from_root_eval", "advance_root")


RANKS_TOL = 1e-5  # the trainer's card bound: two ranks against one process, |d| <= tol * max(|x|, 1) a leaf


def rank_phase(rows: dict, syms, levels, batch: int, steps: int, sp_dir: str, sp_batch: int, visits: int,
               moves: int) -> dict:
    """One rank of phase 12 (e), started by `launch_local`: `steps` float32
    b6c96 steps of `make_sharded_train_step` from the flagship checkpoint on
    the rank's block of each global batch of `batch` rows with the global
    draws, then the selfplay daemon at a global B=`sp_batch` into `sp_dir`.
    Returns the rank's state (flattened), metrics and rows."""
    import dataclasses

    import numpy as np
    import torch

    from katacoffee_tpu_torch.command.selfplay import SelfplayConfig, run_selfplay_daemon
    from katacoffee_tpu_torch.dataio import checkpoints as ckpt
    from katacoffee_tpu_torch.dataio.trainingwrite import rows_to_batch
    from katacoffee_tpu_torch.game.board import GameConfig
    from katacoffee_tpu_torch.nn.configs import get_model_spec
    from katacoffee_tpu_torch.nn.model import CoffeeNet
    from katacoffee_tpu_torch.parallel import mesh
    from katacoffee_tpu_torch.search.params import SearchParams
    from katacoffee_tpu_torch.train import train as train_mod
    from katacoffee_tpu_torch.utils.logger import Logger

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = mesh.world()
    dev = mesh.rank_device("cuda")
    cfg = GameConfig(5, 5, 4)
    f32 = dataclasses.replace(get_model_spec("b6c96"), dtype=torch.float32)
    state, _ = ckpt.load_checkpoint(FLAGSHIP_CKPT, train_mod.init_train_state(CoffeeNet(f32, cfg.win_len).to(dev)))
    with torch.no_grad():
        mesh.broadcast_from_zero([*state.model.parameters(), *state.trace.values(), *state.ema.values()])
    step = train_mod.make_sharded_train_step(cfg, train_mod.TrainConfig(), batch, world)
    metrics = []
    torch.cuda.synchronize()
    t = time.monotonic()
    for i in range(steps):
        block = {k: mesh.rank_rows(torch.from_numpy(v[i * batch:(i + 1) * batch]), rank, world).numpy()
                 for k, v in rows.items()}
        state, m = step(state, rows_to_batch(block, cfg, dev),
                        draws=train_mod.StepDraws(syms[i].to(dev), levels[i].to(dev)))
        metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    train_s = time.monotonic() - t
    tree = {k: np.asarray(v) for k, v in ckpt.flatten(ckpt.state_to_tree(state)).items()}
    spc = SelfplayConfig(batch_size=sp_batch, num_sims=visits, moves_per_segment=moves, max_segments=1, seed=0)
    t = time.monotonic()
    total = run_selfplay_daemon(sp_dir, cfg, SearchParams.for_selfplay(), spc, Logger(), device=dev)
    torch.cuda.synchronize()
    return {"rank": rank, "world": world, "device": str(dev), "card": torch.cuda.get_device_name(dev),
            "tree": tree, "metrics": metrics, "train_s": train_s, "selfplay_rows": total,
            "selfplay_s": time.monotonic() - t}


def phase_ranks(dev, cfg, sp_dir, shuffled, n, visits=16, moves=26, train_batch=256, train_steps=10, sp_batch=64,
                label="ranks"):
    """`n` ranks through `launch_local`, NCCL over cuda:0..n-1 where n GPUs
    are visible, else all on cuda:0 over gloo (named): `train_steps`
    float32 b6c96 steps at a global B=`train_batch` from the flagship
    checkpoint on the rows of `shuffled` with injected draws, against one
    process's steps with the same draws (every leaf within RANKS_TOL *
    max(|x|, 1), the ranks bit-equal), then the selfplay daemon at a global
    B=`sp_batch`, `visits` visits, 1 segment of `moves` moves into `sp_dir`
    (whose models/ links run-s5200): every rank's shard and SGFs read back,
    the names distinct, the total returned by every rank."""
    import dataclasses

    import numpy as np
    import torch

    from katacoffee_tpu_torch.dataio import checkpoints as ckpt
    from katacoffee_tpu_torch.dataio.trainingwrite import iter_shards, read_npz_rows, rows_to_batch
    from katacoffee_tpu_torch.nn.configs import get_model_spec
    from katacoffee_tpu_torch.nn.features import sample_history_levels
    from katacoffee_tpu_torch.nn.model import CoffeeNet
    from katacoffee_tpu_torch.parallel import mesh
    from katacoffee_tpu_torch.train import train as train_mod

    n_gpu = torch.cuda.device_count()
    backend, where = ("nccl", "cuda") if n_gpu >= n else ("gloo", "cuda:0")
    data = [read_npz_rows(p) for p in iter_shards(shuffled)]
    cols = {k: np.concatenate([d[k] for d in data]) for k in data[0] if k not in ("schema_version", "board_shape")}
    take = np.arange(train_batch * train_steps) % cols["weight"].shape[0]
    rows_in = {k: v[take] for k, v in cols.items()}
    g = torch.Generator().manual_seed(11)
    syms = [torch.randint(0, 8, (train_batch,), generator=g) for _ in range(train_steps)]
    levels = [sample_history_levels(train_batch, 0.98, generator=g) for _ in range(train_steps)]
    t = time.monotonic()
    ranks = mesh.launch_local(rank_phase, n, rows_in, syms, levels, train_batch, train_steps, sp_dir, sp_batch,
                              visits, moves, backend=backend, device=where)
    ranks_s = time.monotonic() - t
    f32 = dataclasses.replace(get_model_spec("b6c96"), dtype=torch.float32)
    state, _ = ckpt.load_checkpoint(FLAGSHIP_CKPT, train_mod.init_train_state(CoffeeNet(f32, cfg.win_len).to(dev)))
    step = train_mod.make_train_step(cfg, train_mod.TrainConfig(), train_batch)
    for i in range(train_steps):
        block = {k: v[i * train_batch:(i + 1) * train_batch] for k, v in rows_in.items()}
        state, m = step(state, rows_to_batch(block, cfg, dev), draws=train_mod.StepDraws(syms[i].to(dev),
                                                                                          levels[i].to(dev)))
    ref = ckpt.flatten(ckpt.state_to_tree(state))
    bit_equal = all(np.array_equal(r["tree"][k], ranks[0]["tree"][k]) for r in ranks[1:] for k in ref)
    worst = 0.0
    for k, v in ref.items():
        v = np.asarray(v, np.float64)
        worst = max(worst, float(np.abs(ranks[0]["tree"][k] - v).max() / max(float(np.abs(v).max()), 1.0)))
    model = os.path.basename(MODEL_DIR)
    got, sgfs = read_daemon_rows(cfg, sp_dir, model, dev)
    sp_rows, sp_games = got["weight"].shape[0], replay_sgfs(cfg, sgfs, dev)
    names = [os.path.basename(p) for p in sgfs]
    shards = sorted(os.listdir(os.path.join(sp_dir, "selfplay", model, "tdata")))
    named = {name.split("_")[1] for name in names}
    log(f"{label}: {n} ranks over {backend} on {[r['device'] for r in ranks]} ({n_gpu} GPU(s) visible, "
        f"{ranks[0]['card']}), {ranks_s:.1f} s with the spawns: {train_steps} float32 b6c96 steps at a global "
        f"B={train_batch} in {ranks[0]['train_s']:.3f} s against one process: largest leaf difference "
        f"{worst:.3e} * max(|x|, 1) (tol {RANKS_TOL}), last loss {ranks[0]['metrics'][-1]['loss']:.6f} / "
        f"{float(m['loss']):.6f}; the ranks {'bit-equal' if bit_equal else 'NOT bit-equal'}; the daemon at a global "
        f"B={sp_batch}, {visits} visits, {moves} moves: {sp_rows} rows ({[r['selfplay_rows'] for r in ranks]} "
        f"returned), shards {shards}, {sp_games} SGFs replayed ({len(named)} ranks named) in "
        f"{ranks[0]['selfplay_s']:.1f} s")
    if (worst > RANKS_TOL or not bit_equal or [r["world"] for r in ranks] != [n] * n
            or any(r["selfplay_rows"] != sp_rows for r in ranks) or len(shards) != n
            or named != {f"rank{r}" for r in range(n)} or len(set(names)) != len(names)):
        raise AssertionError(f"{label}: the ranks disagree with one process or with each other, or their selfplay "
                             f"output does not add up")
    return {"backend": backend, "gpus_visible": n_gpu, "devices": [r["device"] for r in ranks], "seconds": ranks_s,
            "train_s": ranks[0]["train_s"], "max_leaf_diff": worst, "bit_equal": bit_equal,
            "selfplay_rows": sp_rows, "selfplay_sgfs": sp_games, "selfplay_s": ranks[0]["selfplay_s"]}


def phase_contribute(dev, cfg, root, shuffled, snapshot_every=50, visits=16, batch=64, moves=26, rating_visits=16,
                     rating_games=8, cmd_visits=8, cmd_batch=16, train_batch=256, train_steps=10, sp_batch=64):
    """The contribution bus and several GPUs, this slice's main path:
    (a) a `ContributionServer` in a thread on 127.0.0.1:0 over a base dir
    under `root` whose models/ links run-s5200, selfplay_config
    {"maxVisits": `visits`, "numParallelGames": `batch`} (the server's
    default width, B=64, b6c96 bf16, for_selfplay(); depth cut from 600
    visits to 16 so every game ends inside one 26-move cycle), and a
    `ContributeClient` on the card running one `run_cycle(26)` with
    `PathCopies` entered around it (one descent launch a playout, at most
    two gathers a search): the wall, rows, rows/s and the seconds spent
    uploading; the uploaded shard read back through the port's reader with
    the JAX schema's keys and dtypes, every SGF replayed to its winner;
    (b) each kernel held to its plain version on (a)'s copies and timed
    (the gather at (64, 64, 8, 100), the descent on the cycle's deepest
    copied tree); (c) a rating task: run-s4800 added to the models,
    rating_game_prob 1.0 and {"maxVisits": 16, "numRatingGames": 8}, one
    cycle, the SGFs on the server tallied through the port's
    `summarize_sgfs` to the client's own result; (d) `python -m
    katacoffee_tpu_torch contribute -max-cycles 1` in a subprocess against a
    server at {"maxVisits": 8, "numParallelGames": 16}: it exits 0 and its
    rows are stored ((d) runs beside (c) and (e)); (e) `phase_ranks` with
    two ranks on phase 7's shuffled rows (`shuffled`), in a thread beside
    (c)."""
    import collections

    import torch

    from katacoffee_tpu_torch.command.summarize_sgfs import collect_results
    from katacoffee_tpu_torch.distributed import ContributeClient, ContributionServer
    from katacoffee_tpu_torch.distributed import client as client_mod
    from katacoffee_tpu_torch.ops.gather import gather_rows
    from katacoffee_tpu_torch.search import mcts
    from katacoffee_tpu_torch.utils.logger import Logger

    out = {}
    model_name, champion = os.path.basename(MODEL_DIR), os.path.basename(CHAMPION_DIR)

    def server_dir(name, *models):
        base = os.path.join(root, name)
        os.makedirs(os.path.join(base, "models"))
        for m in models:
            os.symlink(os.path.abspath(m), os.path.join(base, "models", os.path.basename(m)))
        return base

    # (a) one selfplay cycle at the server's width
    base = server_dir("bus", MODEL_DIR)
    srv = ContributionServer(base, cfg, selfplay_config={"maxVisits": visits, "numParallelGames": batch}).start()
    searches, uploads = [], []
    try:
        client = ContributeClient(srv.url, os.path.join(root, "bus_cache"), logger=Logger(), seed=0, device=dev)
        request = client._request

        def timed_request(path, data=None):
            t = time.monotonic()
            reply = request(path, data)
            if data is not None:
                uploads.append(time.monotonic() - t)
            return reply

        def counted_search(*args, **kwargs):
            n = gather_rows.launches
            tree = kept(*args, **kwargs)
            searches.append(gather_rows.launches - n)
            return tree

        client._request = timed_request
        kept = mcts.run_search
        mcts.run_search = counted_search
        try:
            with PathCopies(snapshot_every) as copies:
                torch.cuda.synchronize()
                t = time.monotonic()
                rows = client.run_cycle(moves_per_segment=moves)
                torch.cuda.synchronize()
                wall = time.monotonic() - t
        finally:
            mcts.run_search = kept
    finally:
        srv.stop()
    got, sgfs = read_daemon_rows(cfg, base, model_name, dev)
    stored, games = got["weight"].shape[0], replay_sgfs(cfg, sgfs, dev)
    log(f"contribute (a): one cycle, {batch} games at {visits} visits, {moves} moves, b6c96 bf16: {wall:.3f} s with "
        f"the model's download and load, {rows} rows ({rows / wall:.1f} rows/s), {len(uploads)} uploads in "
        f"{sum(uploads):.3f} s; the shard read back ({stored} rows, the JAX schema's keys and dtypes), {games} SGFs "
        f"replayed to their winners; launches: descend_interior {copies.launches['descend_interior']} for "
        f"{copies.sims} simulations run, gather_rows {copies.launches['gather_rows']} ({max(searches)} at most in "
        f"each of {len(searches)} searches; shapes {sorted(copies.gathers)})")
    copies.check_launches("contribute", batch)
    if stored != rows or games == 0 or not searches or max(searches) > 2:
        raise AssertionError(f"contribute (a): {stored} rows stored of {rows}, {games} SGFs, {len(searches)} searches "
                             f"with gathers {searches}")
    out.update(wall_s=wall, rows=rows, rows_per_s=rows / wall, upload_s=sum(uploads), uploads=len(uploads),
               games=games, visits=visits, batch=batch, moves=moves, launches=copies.launches, sims=copies.sims,
               searches=len(searches))

    # (b) the kernels on the cycle's own inputs
    checked = copies.check("contribute (b)", cfg)
    out.update(checked, gather_shape=next(iter(checked["gather"])))

    # (d) the command in a subprocess, which runs while (c) and (e) do
    base_d = server_dir("command", MODEL_DIR)
    srv_d = ContributionServer(base_d, cfg, selfplay_config={"maxVisits": cmd_visits,
                                                             "numParallelGames": cmd_batch}).start()
    t_d = time.monotonic()
    proc = subprocess.Popen([sys.executable, "-m", "katacoffee_tpu_torch", "contribute", "-server", srv_d.url,
                             "-max-cycles", "1", "-cache-dir", os.path.join(root, "command_cache")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # (e) two ranks, in a thread beside (c): the ranks are processes of their own
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(phase_ranks, dev, cfg, server_dir("ranks", MODEL_DIR), shuffled, 2, visits=visits,
                                moves=moves, train_batch=train_batch, train_steps=train_steps,
                                sp_batch=sp_batch, label="contribute (e)")
            # (c) a rating task
            base = server_dir("rating", MODEL_DIR, CHAMPION_DIR)
            srv = ContributionServer(base, cfg, rating_game_prob=1.0, rating_seed=0,
                                     rating_config={"maxVisits": rating_visits, "numRatingGames": rating_games}).start()
            played, tasks = [], []
            kept_match = client_mod.run_match
            client_mod.run_match = lambda *a, **kw: played.append(kept_match(*a, **kw)) or played[-1]
            try:
                client = ContributeClient(srv.url, os.path.join(root, "bus_cache"), logger=Logger(), seed=1,
                                          device=dev)
                get_task = client.get_task
                client.get_task = lambda: tasks.append(get_task()) or tasks[-1]
                t = time.monotonic()
                n = client.run_cycle()
                rating_s = time.monotonic() - t
            finally:
                client_mod.run_match = kept_match
                srv.stop()
            (task,), (result,) = tasks, played
            records = collect_results([os.path.join(base, "ratinggames")], device=dev)
            wins = collections.Counter()
            for pb, pw, wb, ww, _ in records:
                wins[pb] += wb
                wins[pw] += ww
            draws = sum(r[4] for r in records)
            log(f"contribute (c): rating task {task['modelBlack']} (black first) vs {task['modelWhite']}, {n} games "
                f"at {rating_visits} visits in {rating_s:.3f} s beside (e): client {result.wins_a}-{result.wins_b}-"
                f"{result.draws}, the server's SGFs tally {dict(wins)} and {draws} draws")
            if (task["taskType"] != "rating" or {task["modelBlack"], task["modelWhite"]} != {model_name, champion}
                    or n != rating_games or sum(r[2] + r[3] + r[4] for r in records) != n
                    or dict(wins) != {task["modelBlack"]: result.wins_a, task["modelWhite"]: result.wins_b}
                    or draws != result.draws):
                raise AssertionError(f"contribute (c): task {task}, {n} games, records {records}, result {result}")
            out["rating"] = {"games": n, "seconds": rating_s, "wins_black_model": result.wins_a,
                             "wins_white_model": result.wins_b, "draws": result.draws}
            out["ranks"] = ranks.result()
    except BaseException:
        proc.kill()
        proc.communicate()
        srv_d.stop()
        raise
    try:
        stdout, stderr = proc.communicate(timeout=max(300 - (time.monotonic() - t_d), 1))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        srv_d.stop()
    cmd_s = time.monotonic() - t_d
    if proc.returncode != 0:
        raise AssertionError(f"contribute (d): exit {proc.returncode}\n{stdout[-2000:]}\n{stderr[-4000:]}")
    cmd_rows = read_daemon_rows(cfg, base_d, model_name, dev)[0]["weight"].shape[0]
    log(f"contribute (d): `contribute -max-cycles 1` in a subprocess, run beside (c) and (e), exited 0 after "
        f"{cmd_s:.1f} s; {cmd_rows} rows stored ({cmd_batch} games at {cmd_visits} visits): "
        f"{stdout.strip().splitlines()[-1]}")
    out["command"] = {"seconds": cmd_s, "rows": cmd_rows}
    return out


def phase_profile(dev, label, search, sims=20):
    """Where a search's time goes: the wall time of `search()` (`sims`
    playouts, ending in a device synchronization), then the same under
    torch.profiler: the device busy share, kernel launches and host syncs
    per playout, the launches of each search function (by the nearest
    labelled caller; "expansion and backup" is `_simulate_once`'s own code,
    "net" the evaluator), and the kernels with the most device time."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from katacoffee_tpu_torch.search import mcts

    search()
    t = time.monotonic()
    search()
    wall = time.monotonic() - t
    kept = {name: getattr(mcts, name) for name in PROFILED}

    def labelled(name, fn):
        def call(*args, **kwargs):
            with record_function("kc::" + name):
                return fn(*args, **kwargs)
        return call

    for name, fn in kept.items():
        setattr(mcts, name, labelled(name, fn))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            search(labelled)
    finally:
        for name, fn in kept.items():
            setattr(mcts, name, fn)
    events = prof.key_averages()
    # the labels also show as ranges on the device's timeline: not kernels
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith("kc::")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    device_kernels = sum(e.count for e in kernels)
    syncs = sum(e.count for e in events if e.key == "aten::_local_scalar_dense")
    stream_syncs = sum(e.count for e in events if e.key == "cudaStreamSynchronize")
    by_phase = collections.Counter()
    for e in prof.events():
        if e.name != "cudaLaunchKernel":
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith("kc::"):
            p = p.cpu_parent
        by_phase["expansion and backup" if p is None else p.name[4:]] += 1
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(
        f"profile {label} {sims} sims: wall {wall:.3f}s unprofiled, device busy {busy:.3f}s "
        f"({busy / wall:.1%} of the wall), {launches / sims:.0f} cudaLaunchKernel calls and "
        f"{device_kernels / sims:.0f} device kernels and {syncs / sims:.2f} host reads of a device "
        f"value (aten::_local_scalar_dense, each a host sync) per simulation, {stream_syncs / sims:.2f} "
        f"cudaStreamSynchronize"
    )
    log("  cudaLaunchKernel per simulation by caller: "
        + ", ".join(f"{k} {v / sims:.1f}" for k, v in by_phase.most_common()))
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:7d}x  {e.key[:90]}")
    return {"launches_per_sim": launches / sims, "syncs_per_sim": syncs / sims,
            "stream_syncs_per_sim": stream_syncs / sims, "busy_share": busy / wall,
            "by_phase": {k: v / sims for k, v in by_phase.items()}}


def profile_searches(dev, cfg, reused_tree, batch=512, sims=5, pairs=2):
    """Profiles of `sims` playouts at B=512 b6c96: a fresh search from the
    empty board under the default and the selfplay profile, the selfplay
    one again with the selfplay command's evaluator (a random symmetry per
    evaluation), and the continuation of the main path's reused tree (its
    second move) by `sims` playouts under the selfplay profile. Then the
    evaluator's cost alone: `pairs` alternated pairs of the fresh selfplay
    search with the plain and the randomizing evaluator, host clock."""
    import torch

    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.game.board import init_state
    from katacoffee_tpu_torch.search import mcts
    from katacoffee_tpu_torch.search.params import SearchParams

    net = load_exported_model(MODEL_DIR, dev)[0]
    evaluate = mcts.make_nn_eval_fn(cfg, net)
    randomizing = mcts.make_nn_eval_fn(cfg, net, symmetry_randomize=True,
                                       generator=torch.Generator(device=dev).manual_seed(1))
    roots = init_state(cfg, batch, dev)
    out = {}

    def fresh_search(sp, ev, wrap=lambda name, fn: fn):
        mcts.run_search(cfg, sp, wrap("net", ev), roots, sims, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()

    for label, sp, ev in (("default", SearchParams(), evaluate), ("selfplay", SearchParams.for_selfplay(), evaluate),
                          ("selfplay randomized eval", SearchParams.for_selfplay(), randomizing)):
        out[label] = phase_profile(dev, f"{label} B={batch} fresh",
                                   lambda wrap=lambda name, fn: fn, sp=sp, ev=ev: fresh_search(sp, ev, wrap), sims)
    target = reused_tree.stats[:, 0, mcts.S_VISITS] + sims

    def reused(wrap=lambda name, fn: fn):
        tree = mcts.Tree(*(x.map(torch.clone) if isinstance(x, tuple) else x.clone() for x in reused_tree))
        mcts.continue_search(cfg, SearchParams.for_selfplay(), wrap("net", evaluate), tree, sims, target)
        torch.cuda.synchronize()

    out["selfplay reused"] = phase_profile(dev, f"selfplay B={batch} reused tree", reused, sims)

    walls = {"plain": [], "randomized": []}
    for i in range(2 * pairs):
        name = ("plain", "randomized", "randomized", "plain")[i % 4]
        t = time.monotonic()
        fresh_search(SearchParams.for_selfplay(), evaluate if name == "plain" else randomizing)
        walls[name].append(time.monotonic() - t)
    plain, rand = statistics.median(walls["plain"]), statistics.median(walls["randomized"])
    log(f"symmetry-randomized evaluator, {pairs} alternated pairs of a fresh B={batch} {sims}-playout selfplay "
        f"search: median {plain * 1e3:.1f} ms plain, {rand * 1e3:.1f} ms randomized ({rand / plain - 1:+.2%}); "
        f"plain " + ", ".join(f"{x * 1e3:.1f}" for x in walls["plain"]) + " ms; randomized "
        + ", ".join(f"{x * 1e3:.1f}" for x in walls["randomized"]) + " ms")
    out["randomization_ab"] = {"plain_ms": plain * 1e3, "randomized_ms": rand * 1e3}
    return out


def phase_search_threads(dev, batch=64, visits=200, threads=(2, 4), snapshot_every=25, leak=0.1, cpu_batch=8,
                         cpu_visits=64, gtp_visits=200, gtp_threads=4):
    """Phase 15, K playouts a round (numSearchThreads = K), the catch-up
    leak and the gaussian evaluator, this slice's main path, at the width of
    b6c96 run-s5200 bf16. (a) `for_selfplay()` at B=64, 200 visits, K = 1
    and each of `threads` on the same roots: a fresh search, then one
    reused move (the most visited child of each game), inside `PathCopies`
    (launch counts set to 0 before, read after, every 25th descent launch
    of each row count copied): rounds, wall, root visits/s and launches;
    one descent launch a round and one root gather a search; then the leak
    at `leak` with K = 1 and K = 2, the same way. (b) Each kernel held to
    its plain version on the copies of (a) and timed, K = 1 and the rows of
    B * K; then, on the deepest copy of each run, its edges of two or more
    visits one visit behind their children (so that descents stop at
    catch-ups), with the leak at `leak` on injected draws. (c) A float32
    K = 2 `for_selfplay()` search at B=8, 64 visits, on the card and the CPU
    with the same injected root draws. (d) One genmove of the GTP engine
    at 200 visits with numSearchThreads = 4 from -override-config through
    `load_search_params`, and a B=64 200-visit search under
    `gaussian_prior_eval_fn`, each with its launches counted."""
    import dataclasses

    import numpy as np
    import torch

    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.game.board import GameConfig, step
    from katacoffee_tpu_torch.game.symmetry import num_symmetries
    from katacoffee_tpu_torch.ops.descend import descend_interior
    from katacoffee_tpu_torch.ops.gather import gather_rows
    from katacoffee_tpu_torch.search import mcts
    from katacoffee_tpu_torch.search.params import SearchParams

    cfg = GameConfig(5, 5, 4)
    model = load_exported_model(MODEL_DIR, dev)[0]
    ev = mcts.make_nn_eval_fn(cfg, model)
    roots = random_positions(cfg, batch, seed=15)
    runs, checks, deepest = {}, {}, {}
    for K, p in [(k, 0.0) for k in (1, *threads)] + [(1, leak), (2, leak)]:
        label = f"K={K}" + (f" leak {p}" if p else "")
        sp = dataclasses.replace(SearchParams.for_selfplay(), numSearchThreads=K, graphSearchCatchUpLeakProb=p)
        g = torch.Generator(device=dev).manual_seed(15)
        with PathCopies(snapshot_every) as copies:
            torch.cuda.synchronize()
            t = time.monotonic()
            tree, diag = mcts.run_search(cfg, sp, ev, roots, visits, device=dev, generator=g, with_diag=True)
            torch.cuda.synchronize()
            fresh_s = time.monotonic() - t
            fresh = {"descend_interior": descend_interior.launches, "gather_rows": gather_rows.launches}
            acts = mcts.root_visit_counts(tree).argmax(-1)
            moved = step(cfg, roots.map(lambda x: x.to(dev)), acts)
            torch.cuda.synchronize()
            t = time.monotonic()
            reused, rdiag = mcts.run_search(cfg, sp, ev, moved, visits, device=dev, generator=g, reuse_tree=tree,
                                            reuse_actions=acts, reuse_ok=~moved.done, with_diag=True)
            torch.cuda.synchronize()
            reused_s = time.monotonic() - t
        launches = copies.launches
        run = {"K": K, "leak": p, "fresh_rounds": diag["rounds"], "fresh_s": fresh_s,
               "fresh_root_vps": batch * visits / fresh_s, "reused_rounds": rdiag["rounds"], "reused_s": reused_s,
               "reused_root_vps": float((reused.stats[:, 0, mcts.S_VISITS] - rdiag["start_visits"]).sum()) / reused_s,
               "launches": launches, "fresh_launches": fresh}
        log(f"threads (a) {label}: fresh search {diag['rounds']} rounds {fresh_s:.3f} s "
            f"({run['fresh_root_vps']:.1f} root visits/s), reused move {rdiag['rounds']} rounds {reused_s:.3f} s "
            f"({run['reused_root_vps']:.1f} root visits/s); launches descend_interior {fresh['descend_interior']} + "
            f"{launches['descend_interior'] - fresh['descend_interior']}, gather_rows {fresh['gather_rows']} + "
            f"{launches['gather_rows'] - fresh['gather_rows']}")
        rounds = diag["rounds"] + rdiag["rounds"]
        if diag["rounds"] != -(-visits // K) or launches["descend_interior"] != rounds or fresh[
                "descend_interior"] != diag["rounds"] or copies.sims + copies.rounds != rounds:
            raise AssertionError(f"threads (a) {label}: not one descent launch a round ({rounds} rounds)")
        if fresh["gather_rows"] != 1 or launches["gather_rows"] != 2:
            raise AssertionError(f"threads (a) {label}: not one root gather a search")
        for t_ in (tree, reused):
            if not torch.isfinite(t_.stats).all() or not (t_.stats[:, 0, mcts.S_VISITS] == visits + 1).all():
                raise AssertionError(f"threads (a) {label}: a root without {visits + 1} visits or a non-finite row")
            pt = mcts.policy_target(t_, sp)[~t_.is_terminal[:, 0]]
            if not torch.allclose(pt.sum(-1), torch.ones((), device=dev), atol=1e-5):
                raise AssertionError(f"threads (a) {label}: a live root's policy target does not sum to 1")
        copies.check_launches(f"threads {label}", batch * K)
        deepest[label] = max(copies.descents[batch * K], key=lambda c: int(c[2].node_count.sum()))
        checks[label] = copies.check(f"threads (b) {label}", cfg)
        runs[label] = run

    # (b) the leak on trees that stop at catch-ups
    u_gen = torch.Generator().manual_seed(16)
    leak_checks = {}
    for label in [f"K={k}" for k in (1, *threads)]:
        n, dsp, tree, inputs, _, extra = deepest[label]
        behind = tree.edge_visits >= 2
        tree.edge_visits.sub_(behind.to(torch.int32))
        lsp = dataclasses.replace(dsp, graphSearchCatchUpLeakProb=leak)
        rows, D = inputs[0].shape[0], inputs[5].child_c.shape[1]
        u = torch.rand((rows, D + 1), generator=u_gen).to(dev)
        closed = check_path_descent(f"threads (b) {label} launch {n}, lagging edges", cfg, dsp, tree, inputs, False,
                                    acts_f=extra["acts_f"])
        leak_checks[label] = check_path_descent(f"threads (b) {label} launch {n}, lagging edges, leak {leak}", cfg,
                                                lsp, tree, inputs, True, leak_u=u, acts_f=extra["acts_f"])
        leak_checks[label]["levels_without_leak"] = closed["timed_levels"]
        leak_checks[label]["caught_without_leak"] = closed["caught"]
        log(f"threads (b) {label}: catch-ups {closed['caught']} without the leak, {leak_checks[label]['caught']} "
            f"with it; levels {closed['timed_levels']} -> {leak_checks[label]['timed_levels']}")
    if all(c["timed_levels"] == c["levels_without_leak"] for c in leak_checks.values()):
        raise AssertionError("threads (b): no descent stopped at a catch-up and leaked through it")
    for label, c in checks.items():
        for rows, d in c["descent"].items():
            log(f"threads (b) {label} rows {rows}: kernel == plain, {d['flips']} near-tie flips, "
                f"{d['ms'] * 1e3:.2f} us a launch ({d['max_levels']} levels), plain {d['plain_ms'] * 1e3:.1f} us")

    # (c) card against CPU, float32, K = 2
    sp2 = dataclasses.replace(SearchParams.for_selfplay(), numSearchThreads=2)
    cpu_roots = random_positions(cfg, cpu_batch, seed=17)
    g = torch.Generator().manual_seed(17)
    A = cfg.policy_size
    draws = mcts.RootDraws(
        syms=torch.argsort(torch.rand((cpu_batch, num_symmetries(cfg)), generator=g), dim=-1)[:, :4],
        gamma=torch._standard_gamma(torch.full((cpu_batch, A), 0.1083), generator=g))
    found = []
    for d in (dev, torch.device("cpu")):
        net32 = load_exported_model(MODEL_DIR, d, torch.float32)[0]
        tree = mcts.run_search(cfg, sp2, mcts.make_nn_eval_fn(cfg, net32), cpu_roots, cpu_visits, device=d,
                               draws=draws)
        found.append((mcts.root_visit_counts(tree).cpu(), {k: v.cpu() for k, v in mcts.root_values(tree).items()}))
    (vk, rk), (vc, rc) = found
    same = (vk == vc).all(-1)
    tv = 0.5 * (vk.float() / cpu_visits - vc.float() / cpu_visits).abs().sum(-1).max().item()
    value_diff = max([(rk[k][same] - rc[k][same]).abs().max().item() for k in rk
                      if rk[k].is_floating_point() and same.any()] or [0.0])
    log(f"threads (c): float32 K=2 B={cpu_batch} {cpu_visits} visits, card and CPU, same draws: {int(same.sum())} of "
        f"{cpu_batch} games with identical root visits, max total variation {tv:.4f}; root values of those within "
        f"{value_diff:.3g}")
    if tv > TV_MAX or value_diff > GTP_WINRATE_TOL:
        raise AssertionError("threads (c): card and CPU part beyond the contract")

    # (d) the GTP engine with numSearchThreads = 4, and the gaussian evaluator
    eng, gsp, _, _ = gtp_engine(dev, visits=gtp_visits, overrides=f"numSearchThreads={gtp_threads}")
    if gsp.numSearchThreads != gtp_threads:
        raise AssertionError(f"threads (d): load_search_params read numSearchThreads {gsp.numSearchThreads}")
    with PathCopies(10**9) as gcopies:
        session = gtp_session(eng, ["clear_board", "genmove b"])
    gtp_s = session[-1][2]
    if not session[-1][1].startswith("= ") or gcopies.launches["descend_interior"] != gcopies.rounds or \
            gcopies.rounds != -(-gtp_visits // gtp_threads):
        raise AssertionError(f"threads (d): genmove {session[-1][1]!r}, {gcopies.rounds} rounds, "
                             f"{gcopies.launches} launches")
    gauss = mcts.gaussian_prior_eval_fn(cfg, generator=torch.Generator(device=dev).manual_seed(18))
    with PathCopies(10**9) as gauss_copies:
        torch.cuda.synchronize()
        t = time.monotonic()
        gtree = mcts.run_search(cfg, SearchParams(), gauss, roots, visits, device=dev)
        torch.cuda.synchronize()
        gauss_s = time.monotonic() - t
    if not torch.isfinite(gtree.stats).all() or not (gtree.stats[:, 0, mcts.S_VISITS] == visits + 1).all() or \
            gauss_copies.launches["descend_interior"] != visits:
        raise AssertionError("threads (d): the gaussian search is not whole")
    log(f"threads (d): gtp genmove at {gtp_visits} visits, numSearchThreads {gsp.numSearchThreads}: "
        f"{session[-1][1]!r} in {gtp_s:.3f} s, {gcopies.rounds} rounds, descend_interior "
        f"{gcopies.launches['descend_interior']}; gaussian_prior_eval_fn B={batch} {visits} visits {gauss_s:.3f} s, "
        f"descend_interior {gauss_copies.launches['descend_interior']}")
    return {"runs": runs, "checks": checks, "leak_checks": leak_checks,
            "card_vs_cpu": {"identical_games": int(same.sum()), "games": cpu_batch, "max_tv": tv,
                            "max_value_diff": value_diff},
            "gtp": {"visits": gtp_visits, "threads": gtp_threads, "seconds": gtp_s, "rounds": gcopies.rounds,
                    "launches": gcopies.launches, "reply": session[-1][1]},
            "gaussian": {"seconds": gauss_s, "launches": gauss_copies.launches}}


TINYNET_DIR = "tests/goldens/tinynet"
RECT = (5, 7, 4)  # x, y, win length: a rectangle whose axes differ
# the daemon of phase 16 (c) in a process of its own: run_selfplay_daemon
# with small shards (max_rows_per_file; the selfplay command keeps the JAX
# command's 65,536 rows a shard and takes no key for it, so its first shard
# comes at its end), on the card, with the model its models/ links
DAEMON_CODE = """
from katacoffee_tpu_torch.command.selfplay import SelfplayConfig, run_selfplay_daemon
from katacoffee_tpu_torch.game.board import GameConfig
from katacoffee_tpu_torch.search.params import SearchParams
from katacoffee_tpu_torch.utils.logger import Logger

spc = SelfplayConfig(batch_size={batch}, num_sims={visits}, moves_per_segment={moves}, segments_per_flush=1,
                     max_rows_per_file={rows_per_file}, seed={seed})
run_selfplay_daemon({base!r}, GameConfig(5, 5, 4), SearchParams.for_selfplay(), spc, Logger(log_to_stdout=True))
"""


def spawn_group(argv, log_path):
    """`argv` in a process group of its own (so that a kill of the group
    reaches every process it starts), its output to `log_path`."""
    with open(log_path, "ab") as out:
        return subprocess.Popen(argv, stdout=out, stderr=subprocess.STDOUT, start_new_session=True)


def kill_group(proc) -> None:
    import signal

    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait(timeout=60)


def wait_until(proc, cond, what: str, log_path: str, timeout: float = 240.0) -> float:
    """Seconds until `cond()` holds, polled; fails if `proc` ends first."""
    t = time.monotonic()
    while time.monotonic() - t < timeout:
        if cond():
            return time.monotonic() - t
        if proc.poll() is not None:
            raise AssertionError(f"{what}: the process exited {proc.returncode} first:\n"
                                 f"{Path(log_path).read_text()[-3000:]}")
        time.sleep(0.05)
    raise AssertionError(f"{what}: not within {timeout} s:\n{Path(log_path).read_text()[-3000:]}")


def shard_rows(paths) -> int:
    """Rows of the shards, each loaded whole, its row keys of one length."""
    import numpy as np

    total = 0
    for p in paths:
        with np.load(p) as z:
            lengths = {k: z[k].shape[0] for k in z.files if k not in ("schema_version", "board_shape")}
        if len(set(lengths.values())) != 1:
            raise AssertionError(f"{p}: a partial shard, row keys of lengths {lengths}")
        total += next(iter(lengths.values()))
    return total


def checkpoint_step(path) -> int:
    """The train_step of a checkpoint, which loads whole into a b1c6 state
    on the CPU."""
    from katacoffee_tpu_torch.dataio.checkpoints import load_checkpoint
    from katacoffee_tpu_torch.nn.configs import get_model_spec
    from katacoffee_tpu_torch.nn.model import CoffeeNet
    from katacoffee_tpu_torch.train.train import init_train_state

    state, meta = load_checkpoint(path, init_train_state(CoffeeNet(get_model_spec("b1c6"), win_len=4)))
    if state.step != int(meta["train_step"]):
        raise AssertionError(f"{path}: step {state.step}, train_step {meta['train_step']}")
    return int(meta["train_step"])


def kill_and_resume(root, batch=64, visits=8, moves=26, rows_per_file=256, train_batch=8, steps_after=5) -> dict:
    """Phase 16 (c), JAX tests/test_loop_faults.py's contracts on the card:
    the selfplay daemon (DAEMON_CODE, run-s5200 bf16) and the trainer
    (`python -m katacoffee_tpu_torch train`, b1c6), each a process group of
    its own on cuda, killed by SIGKILL and started again. The trainer starts
    with the first daemon and waits for shuffled rows, as in the loop; the
    second daemon runs beside the trainer's kill and bounded rerun."""
    import signal

    from katacoffee_tpu_torch.dataio.shuffle import shuffle_data
    from katacoffee_tpu_torch.dataio.trainingwrite import iter_shards

    base = os.path.join(root, "faults")
    os.makedirs(os.path.join(base, "models"))
    # the trainer waits for rows in an existing shuffled dir (a missing one
    # ends it, in the JAX trainer as here)
    os.makedirs(os.path.join(base, "shuffleddata"))
    os.symlink(os.path.abspath(MODEL_DIR), os.path.join(base, "models", os.path.basename(MODEL_DIR)))
    tdata = os.path.join(base, "selfplay", os.path.basename(MODEL_DIR), "tdata")
    ckpt = os.path.join(base, "train", "run", "checkpoint.ckpt")
    logs = os.path.join(root, "faults_{}.log")
    train = [sys.executable, "-m", "katacoffee_tpu_torch", "train", "-base-dir", base, "-config", TRAIN_CFG,
             "-override-config", f"model=b1c6,batchSize={train_batch},stepsPerExport=1000000"]
    out = {}

    def daemon(seed):
        code = DAEMON_CODE.format(batch=batch, visits=visits, moves=moves, rows_per_file=rows_per_file, seed=seed,
                                  base=base)
        return spawn_group([sys.executable, "-c", code], logs.format(f"daemon{seed}"))

    def shards():
        return list(iter_shards(tdata)) if os.path.isdir(tdata) else []

    procs = []
    try:
        # the first daemon, and the trainer waiting for rows
        procs += [daemon(1), spawn_group(train, logs.format("train1"))]
        first, trainer = procs
        t_train = time.monotonic()
        out["daemon_first_shard_s"] = wait_until(first, lambda: len(shards()) >= 2, "faults (c) daemon",
                                                 logs.format("daemon1"))
        kill_group(first)
        before = shards()
        rows_before = shard_rows(before)
        with open(os.path.join(tdata, ".junk.npz.tmp"), "wb") as f:
            f.write(b"half a shard")
        if any(p.endswith(".tmp") for p in shards()):
            raise AssertionError("faults (c): iter_shards lists a temp file")
        shuffle_data([tdata], os.path.join(base, "shuffleddata"), min_rows=10**9, seed=0)
        rows_in = time.monotonic()
        # a fresh daemon into the same tree, beside the trainer's kill and rerun
        t_second = time.time()
        procs.append(daemon(2))
        second = procs[-1]
        wait_until(trainer, lambda: os.path.exists(ckpt), "faults (c) trainer", logs.format("train1"))
        out["train_first_checkpoint_s"] = time.monotonic() - t_train
        out["train_first_checkpoint_after_rows_s"] = time.monotonic() - rows_in
        wait_until(trainer, lambda: os.path.exists(ckpt + ".prev"), "faults (c) rotation", logs.format("train1"))
        # stopped where both generations are on disk, then killed
        while True:
            os.killpg(trainer.pid, signal.SIGSTOP)
            if os.path.exists(ckpt) and os.path.exists(ckpt + ".prev"):
                break
            os.killpg(trainer.pid, signal.SIGCONT)
            time.sleep(0.01)
        kill_group(trainer)
        step_at_kill = checkpoint_step(ckpt)
        prev_step = checkpoint_step(ckpt + ".prev")

        # the trainer again, bounded: it resumes from the persisted step
        t = time.monotonic()
        t_rerun = time.time()
        rerun = subprocess.run(train[:-1] + [train[-1].replace("model=", f"maxSteps={steps_after},model=")],
                               capture_output=True, text=True, timeout=300)
        out["train_resumed_s"] = time.monotonic() - t
        out["train_resumed_checkpoint_s"] = os.path.getmtime(ckpt) - t_rerun
        resumed = checkpoint_step(ckpt)
        if rerun.returncode != 0 or f"resumed from step {step_at_kill}" not in rerun.stdout or \
                resumed != step_at_kill + steps_after or prev_step >= step_at_kill:
            raise AssertionError(f"faults (c): rerun exit {rerun.returncode}, killed at {step_at_kill} (.prev "
                                 f"{prev_step}), resumed to {resumed}\n{rerun.stdout[-2000:]}\n{rerun.stderr[-2000:]}")
        wait_until(second, lambda: len(shards()) > len(before), "faults (c) second daemon", logs.format("daemon2"))
        kill_group(second)
    finally:
        for proc in procs:
            kill_group(proc)
    after = shards()
    out["daemon_resumed_first_shard_s"] = min(os.path.getmtime(p) for p in after if p not in before) - t_second
    rows_after = shard_rows(after)
    stats = shuffle_data([tdata], os.path.join(base, "shuffled_all"), min_rows=10**9, seed=0)
    if not set(before) < set(after) or stats["rows_out"] != rows_after or rows_after < rows_before:
        raise AssertionError(f"faults (c): {len(before)} shards then {len(after)}, {rows_before} rows then "
                             f"{rows_after}, shuffled {stats['rows_out']}")
    out.update(shards_before=len(before), rows_before=rows_before, shards_after=len(after), rows_after=rows_after,
               step_at_kill=step_at_kill, prev_step=prev_step, resumed_step=resumed)
    log(f"faults (c): daemon (B={batch}, {visits} visits, run-s5200) first shard {out['daemon_first_shard_s']:.1f} s "
        f"after its start, SIGKILL with {len(before)} shards ({rows_before} rows) whole; the second daemon's first "
        f"shard {out['daemon_resumed_first_shard_s']:.1f} s after its start, {len(after)} shards ({rows_after} rows) "
        f"shuffled; trainer (b1c6, B={train_batch}) first checkpoint {out['train_first_checkpoint_s']:.1f} s after "
        f"its start ({out['train_first_checkpoint_after_rows_s']:.1f} s after its rows), SIGKILL at step "
        f"{step_at_kill} (.prev {prev_step}), the bounded rerun resumed and wrote step {resumed} "
        f"{out['train_resumed_checkpoint_s']:.1f} s after its start, exited after {out['train_resumed_s']:.1f} s")
    return out


def phase_rectangles(dev, root, batch=64, visits=200, ab_visits=64, snapshot_every=25, mixed_batch=32,
                     mixed_visits=8, mixed_rows=1500, mixed_steps=20, gtp_visits=64):
    """Phase 16, the paths the port had not run on the card. (a) 5x7 (win 4)
    `run_search` at B=64, 200 visits, with the tiny net (bf16,
    `for_selfplay()`: 4 root symmetries of the rectangle's 4) and the
    uniform evaluator (`SearchParams()`), inside `PathCopies` (one descent
    launch a playout, at most two gathers a search); then each whole search
    again at 64 visits with both kernels and with both plain versions
    (identical games counted, total variation within TV_MAX); each kernel
    held to its plain version on the copies and timed, after (c). (b) The
    selfplay command's `main` with bSizes 4,5 (bSizeRelProbs 1,2, bWinLens
    3,4; no model for either size, so the uniform evaluator) at B=32, 8
    visits, 26-move segments, 1500 rows a pass (quotas 500 and 1000, one
    segment and two), one pass; the rows of each size read back
    (`board_shape` (x, y, w), boards [y, x]); `shuffle` per size;
    `run_training_mixed` (b1c6) for 20 steps, the steps of each size
    counted. (c) `kill_and_resume`, in a thread from the start of the
    phase. (d) A GTP session on `boardsize 5:7` (run-s5200 bf16 built for
    the rectangle, configs/gtp_example.cfg's search at 64 visits): a
    genmove, then `kata-raw-nn 0` twice, the second served by the cache:
    one hit more, no forward, and under torch.profiler no kernel launched."""
    import json as json_mod

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from katacoffee_tpu_torch.command import selfplay as selfplay_cmd
    from katacoffee_tpu_torch.command import train as train_cmd
    from katacoffee_tpu_torch.command.gtp import GTPEngine
    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.dataio.shuffle import shuffle_data
    from katacoffee_tpu_torch.dataio.trainingwrite import iter_shards
    from katacoffee_tpu_torch.game.board import GameConfig
    from katacoffee_tpu_torch.game.symmetry import num_symmetries
    from katacoffee_tpu_torch.ops.gather import gather_rows_plain
    from katacoffee_tpu_torch.program.setup import load_search_params
    from katacoffee_tpu_torch.search import mcts
    from katacoffee_tpu_torch.search.params import SearchParams
    from katacoffee_tpu_torch.train.train import TrainConfig
    from katacoffee_tpu_torch.utils.config import ConfigParser
    from katacoffee_tpu_torch.utils.logger import Logger

    cfg = GameConfig(*RECT)
    out = {"board": list(RECT)}
    with ThreadPoolExecutor(1) as pool:
        faults = pool.submit(kill_and_resume, root)
        try:
            # (a) the search on the rectangle, beside (c)
            tiny = load_exported_model(TINYNET_DIR, dev)[0]
            evals = {"tinynet": (mcts.make_nn_eval_fn(cfg, tiny), SearchParams.for_selfplay()),
                     "uniform": (mcts.uniform_eval_fn(cfg), SearchParams())}
            roots = random_positions(cfg, batch, seed=16)
            if num_symmetries(cfg) != 4 or SearchParams.for_selfplay().rootNumSymmetriesToSample < 4:
                raise AssertionError("rect (a): the rectangle's root symmetries are not all sampled")
            copies, runs = {}, {}
            for label, (ev, sp) in evals.items():
                with PathCopies(snapshot_every) as c:
                    torch.cuda.synchronize()
                    t = time.monotonic()
                    tree = mcts.run_search(cfg, sp, ev, roots, visits, device=dev,
                                           generator=torch.Generator(device=dev).manual_seed(16))
                    torch.cuda.synchronize()
                    wall = time.monotonic() - t
                if not torch.isfinite(tree.stats).all() or tree.prior.shape[-1] != cfg.policy_size or not (
                        tree.stats[:, 0, mcts.S_VISITS] == visits + 1).all():
                    raise AssertionError(f"rect (a) {label}: a root without {visits + 1} visits or a bad row")
                c.check_launches(f"rect (a) {label}", batch)
                if c.launches["descend_interior"] != visits or c.launches["gather_rows"] > 2:
                    raise AssertionError(f"rect (a) {label}: launches {c.launches} for {visits} playouts")
                copies[label] = c
                runs[label] = {"seconds": wall, "root_vps": batch * visits / wall, "launches": c.launches,
                               "sims": c.sims}
                log(f"rect (a) {label}: {cfg} B={batch} {visits} visits {wall:.3f} s ({runs[label]['root_vps']:.1f} "
                    f"root visits/s, beside (c)), launches {c.launches}")
            # the whole search with both kernels against both plain versions
            kept = (mcts._descend_interior, mcts.gather_rows)
            for label, (ev, sp) in evals.items():
                found = {}
                for name, fns in (("kernels", kept), ("plain", (mcts._descend_interior_plain, gather_rows_plain))):
                    mcts._descend_interior, mcts.gather_rows = fns
                    try:
                        tree = mcts.run_search(cfg, sp, ev, roots, ab_visits, device=dev,
                                               generator=torch.Generator(device=dev).manual_seed(17))
                    finally:
                        mcts._descend_interior, mcts.gather_rows = kept
                    found[name] = mcts.root_visit_counts(tree).float()
                same = int((found["kernels"] == found["plain"]).all(-1).sum())
                tv = 0.5 * (found["kernels"] - found["plain"]).abs().sum(-1).max().item() / ab_visits
                log(f"rect (a) {label}: B={batch} {ab_visits} visits, both kernels against both plain versions: "
                    f"{same} of {batch} games with identical root visits, max total variation {tv:.4f}")
                if tv > TV_MAX:
                    raise AssertionError(f"rect (a) {label}: kernel search parts from plain: TV {tv}")
                runs[label].update(ab_identical=same, ab_games=batch, ab_tv=tv)

            # (b) mixed board sizes through the selfplay command, then training
            mixed = os.path.join(root, "mixed")
            os.makedirs(mixed)
            config = os.path.join(mixed, "mixed.cfg")
            Path(config).write_text(
                f"bSizes = 4,5\nbSizeRelProbs = 1,2\nbWinLens = 3,4\nrowsPerPass = {mixed_rows}\nmaxPasses = 1\n"
                f"numParallelGames = {mixed_batch}\nmaxVisits = {mixed_visits}\nmovesPerSegment = 26\n"
                f"segmentsPerFlush = 1\nseed = 1\n")
            t = time.monotonic()
            with PathCopies(10**9) as c:
                selfplay_cmd.main(["-output-dir", mixed, "-config", config], device=dev)
                torch.cuda.synchronize()
            sp_s = time.monotonic() - t
            if c.launches["descend_interior"] != c.sims or c.sims == 0:
                raise AssertionError(f"rect (b): launches {c.launches} for {c.sims} playouts")
            sizes = {"4x4w3": GameConfig(4, 4, 3), "5x5w4": GameConfig(5, 5, 4)}
            rows = {}
            for tag, scfg in sizes.items():
                d = os.path.join(mixed, "selfplay", "random", "tdata_" + tag)
                n = 0
                for shard in iter_shards(d):
                    with np.load(shard) as z:
                        if tuple(z["board_shape"]) != tuple(scfg) or z["board"].shape[1:] != (scfg.y_size,
                                                                                              scfg.x_size):
                            raise AssertionError(f"rect (b) {shard}: board_shape {z['board_shape']}, boards "
                                                 f"{z['board'].shape}")
                        n += int(z["weight"].shape[0])
                rows[tag] = n
                shuffle_data([d], os.path.join(mixed, "shuffleddata", tag), min_rows=10**9, seed=0)
            if not rows["5x5w4"] > rows["4x4w3"] > 0:
                raise AssertionError(f"rect (b): rows {rows} (quotas 1:2)")
            stepped = {}
            kept_step = train_cmd.make_train_step

            def counted(scfg, *args):
                step = kept_step(scfg, *args)

                def run(state, b, generator):
                    stepped[scfg] = stepped.get(scfg, 0) + 1
                    return step(state, b, generator)
                return run

            train_cmd.make_train_step = counted
            try:
                t = time.monotonic()
                trc = train_cmd.TrainerConfig(model="b1c6", batch_size=64, max_steps=mixed_steps,
                                              steps_per_export=10**9, checkpoint_every=10**9)
                steps = train_cmd.run_training_mixed(mixed, list(sizes.values()), TrainConfig(), trc, Logger(),
                                                     device=dev)
                torch.cuda.synchronize()
                train_s = time.monotonic() - t
            finally:
                train_cmd.make_train_step = kept_step
            by_size = {f"{s.x_size}x{s.y_size}w{s.win_len}": n for s, n in stepped.items()}
            metrics = [json_mod.loads(line)
                       for line in Path(mixed, "train", "run", "metrics_train.json").read_text().splitlines()]
            if steps != mixed_steps or sum(by_size.values()) != steps or set(by_size) != set(sizes) or not all(
                    np.isfinite(m["loss"]) for m in metrics):
                raise AssertionError(f"rect (b): {steps} steps, by size {by_size}, metrics {metrics}")
            out["mixed"] = {"rows": rows, "selfplay_s": sp_s, "steps": by_size, "train_s": train_s,
                            "launches": c.launches, "sims": c.sims}
            log(f"rect (b): selfplay bSizes 4,5 (B={mixed_batch}, {mixed_visits} visits, {mixed_rows} rows a pass) "
                f"{sp_s:.1f} s, rows {rows}, {c.sims} playouts, launches {c.launches}; run_training_mixed {steps} "
                f"steps {train_s:.1f} s, by size {by_size}")

            # (d) GTP on boardsize 5:7, kata-raw-nn twice
            model = load_exported_model(MODEL_DIR, dev)[0]
            sp = load_search_params(ConfigParser(GTP_CFG), SearchParams.for_tests_v2())
            raw = mcts.make_cached_raw_forward_fn(cfg, model)
            forwards = []
            kept_forward = raw._forward
            raw._forward = lambda states: forwards.append(1) or kept_forward(states)
            eng = GTPEngine(cfg, sp, mcts.make_nn_eval_fn(cfg, model), max_visits=gtp_visits, raw_fwd=raw,
                            device=dev)
            with PathCopies(10**9) as g:
                session = gtp_session(eng, ["boardsize 5:7", "play B C3 north", "genmove white", "kata-raw-nn 0"])
            hits, misses, n_fwd = raw.hits, raw.misses, len(forwards)
            with PathCopies(10**9) as g2:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    again = gtp_session(eng, ["kata-raw-nn 0"])
            launched = sum(e.count for e in prof.key_averages() if e.key in LAUNCH_EVENTS)
            if any(not r.startswith("=") for _, r, _ in session + again) or again[0][1] != session[-1][1] or \
                    raw.hits != hits + 1 or raw.misses != misses or len(forwards) != n_fwd or launched or \
                    any(g2.launches.values()) or g.launches["descend_interior"] != g.sims:
                raise AssertionError(f"rect (d): replies {session + again}, cache {hits}/{misses} -> "
                                     f"{raw.hits}/{raw.misses}, forwards {n_fwd} -> {len(forwards)}, launches "
                                     f"{launched}, counters {g2.launches}")
            out["gtp"] = {"visits": gtp_visits, "genmove_s": session[2][2], "genmove": session[2][1],
                          "launches": g.launches, "raw_nn_s": [session[3][2], again[0][2]],
                          "cache": {"hits": raw.hits, "misses": raw.misses}, "second_raw_nn_launches": launched}
            log(f"rect (d): gtp boardsize 5:7, genmove white {session[2][1]!r} in {session[2][2]:.3f} s at "
                f"{gtp_visits} visits (descend_interior {g.launches['descend_interior']}), kata-raw-nn "
                f"{session[3][2]:.3f} s then {again[0][2]:.3f} s from the cache (hits {raw.hits}, misses "
                f"{raw.misses}, no forward, {launched} kernel launches, counters {g2.launches})")
        finally:
            out["faults"] = faults.result()

    # (a) the kernels on the rectangle's copies, after (c) ended
    out["runs"] = runs
    out["checks"] = {label: c.check(f"rect (a) {label}", cfg) for label, c in copies.items()}
    return out


def gather_row(t: dict, floor: dict) -> dict:
    """A gather timing with the launch floor as the gather is timed (a CUDA
    graph)."""
    return dict(t, floor_ms=floor["graph_ms"])


def descent_row(t: dict, floor: dict) -> dict:
    """A descent timing with the launch floor as the descent is timed (events
    around one launch) and us a level of the deepest game over the floor."""
    per_level = (t["ms"] - floor["event_ms"]) * 1e3 / max(t["max_levels"], 1)
    return dict(t, floor_ms=floor["event_ms"], us_per_level=per_level)


def log_kernel_rows(gather_entry: dict, descend_entry: dict) -> None:
    """One line a timed row of the kernels line: us, the bound, the launch
    floor, the library call, and for the descent the deepest game's levels
    and us a level."""
    def us(x):
        return "n/a" if x is None else f"{x * 1e3:.2f}"

    rows = [(f"contribute {gather_entry['shape']}", gather_entry), *gather_entry["other_shapes"].items()]
    for label, r in rows:
        log(f"  gather_rows {label}: {us(r['ms'])} us, bound {us(r['bound_ms'])}, floor {us(r['floor_ms'])}, "
            f"torch.gather {us(r['library_ms'])}, plain {us(r['plain_ms'])}")
    rows = [(f"contribute B={descend_entry['shape'][0]}", descend_entry), *descend_entry["other_trees"].items()]
    for label, r in rows:
        log(f"  descend_interior {label}: {us(r['ms'])} us, bound {us(r['bound_ms'])}, floor {us(r['floor_ms'])}, "
            f"deepest game {r['max_levels']} levels, {r['us_per_level']:.3f} us a level")


def main() -> int:
    faulthandler.dump_traceback_later(1160, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    log(f"phase 0: {card}; torch {torch.__version__} (CUDA {torch.version.cuda})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from katacoffee_tpu_torch.game.board import GameConfig
    from katacoffee_tpu_torch.ops import _build, descend, gather

    t = time.monotonic()
    empty = Path(EMPTY_KERNEL).resolve()
    with ThreadPoolExecutor(3) as pool:
        builds = [pool.submit(gather.load_kernel), pool.submit(descend.load_kernel),
                  pool.submit(_build.load_library, empty)]
        for built in builds:
            built.result()
    log(f"phase 1: gather, descent and empty kernels built and loaded in {time.monotonic() - t:.1f}s")
    for source in (gather.SOURCE, descend.SOURCE, empty):
        for line in _build.build_log(source).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {source.name}: {line.strip()}")

    log("phase 2: kernels against their plain versions")
    floor = launch_floor()
    kern = phase_kernel(dev)
    cfg = GameConfig(5, 5, 4)
    desc = phase_descend(dev, cfg, GameConfig(9, 9, 4), cfg15=GameConfig(15, 15, 5))

    log("phase 3: net")
    positions = random_positions(cfg, 64, seed=0)
    phase_net(dev, cfg, positions)

    log("phase 4: search, default profile")
    search = phase_search(dev, cfg, positions)

    log("phase 5: the selfplay actor's segment (bench.py's measurement), then the rest of the actor")
    selfplay = phase_selfplay(dev, cfg)
    finishing = phase_selfplay_ab(dev, cfg)
    card_cpu = phase_selfplay_card_vs_cpu(dev, cfg)
    branches = phase_selfplay_branches(dev, cfg, selfplay, finishing.pop("traj"))

    work = tempfile.mkdtemp(prefix="katacoffee_smoke_")
    try:
        log("phase 6: the selfplay command")
        command = phase_selfplay_command(dev, cfg, work)
        log("phase 7: the trainer, on phase 6's shards")
        trainer = phase_trainer(dev, cfg, command["rows_dir"], positions, work)
        log("phase 8: the gatekeeper, card against CPU, and one loop cycle")
        gate = phase_gatekeeper(dev, cfg, work)
        gate["card_vs_cpu"] = phase_gate_card_vs_cpu(dev, cfg)
        gate["loop"] = phase_loop(dev, cfg, work)

        log("phase 9: the GTP engine, its kernels' inputs, card against CPU")
        gtp = phase_gtp(dev)

        log("phase 10: the analysis engine, its kernels' inputs, card against CPU, the analysis, evalsgf and "
            "genconfig commands")
        analysis = phase_analysis(dev)

        log("phase 11: the opening book, its kernels' inputs, card against CPU, the misc commands, perfcount and "
            "the reference net")
        book = phase_book(dev)

        log("phase 12: the contribution bus, its kernels' inputs, a rating task, the contribute command, two ranks")
        t = time.monotonic()
        contribute = phase_contribute(dev, cfg, work, os.path.join(work, "trainer", "shuffleddata"))
        contribute["phase_s"] = time.monotonic() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)

    log("phase 13: profiles")
    profiles = profile_searches(dev, cfg, selfplay.pop("tree"))
    ab = profiles.pop("randomization_ab")
    log("per playout: cudaLaunchKernel " + ", ".join(
        f"{k} {v['launches_per_sim']:.0f}" for k, v in profiles.items()) + "; host syncs " + ", ".join(
        f"{k} {v['syncs_per_sim']:.2f}" for k, v in profiles.items()))

    log("phase 15: K playouts a round, the catch-up leak and the gaussian evaluator, their kernels' inputs, card "
        "against CPU, the GTP engine with numSearchThreads = 4")
    t = time.monotonic()
    threads = phase_search_threads(dev)
    threads["phase_s"] = time.monotonic() - t

    log("phase 16: a 5x7 board through the search and both kernels, mixed board sizes through the selfplay command "
        "and the trainer, kill and resume of the daemon and the trainer, GTP on boardsize 5:7 and its cache")
    t = time.monotonic()
    work = tempfile.mkdtemp(prefix="katacoffee_smoke_")
    try:
        rect = phase_rectangles(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rect["phase_s"] = time.monotonic() - t

    # the kernels line reports the main path (phase 12 (a), the contribute
    # cycle): its launches, and each kernel's check and times on the inputs
    # that path gave it; the earlier paths' launches and times beside them
    # (the trainer's path, phase 7, launches neither)
    paths = (command, gate, gtp, analysis, book, contribute)
    shape = contribute["gather_shape"]
    t = gather_row(contribute["gather"][shape], floor)
    gather_entry = {
        "name": "gather_rows",
        "route": "cuda",
        "source": "katacoffee_tpu_torch/ops/gather_kernel.cu",
        "replaces": "katacoffee_tpu/ops/gather.py:39",
        "launches": contribute["launches"]["gather_rows"],
        "searches_contribute_path": contribute["searches"],
        "launches_book_path": book["launches"]["gather_rows"],
        "searches_book_path": book["searches"],
        "launches_analysis_path": analysis["launches"]["gather_rows"],
        "launches_gtp_path": gtp["launches"]["gather_rows"],
        "launches_gatekeeper_path": gate["launches"]["gather_rows"],
        "launches_selfplay_command_path": command["launches"]["gather_rows"],
        "launches_segment_path": selfplay["launches"]["gather_rows"],
        "launches_trainer_path": trainer["kernel_launches"]["gather_rows"],
        "max_abs_err": max(kern["max_abs_err"], *(p["gather_max_abs_err"] for p in paths)),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "library_ms": t["library_ms"],
        "eager_ms": t["eager_ms"],
        "floor_ms": t["floor_ms"],
        "shape": list(shape),
        "launches_default_path": search["launches"]["gather_rows"],
        "launches_per_search_default_path": search["per_search"]["gather_rows"],
        "other_shapes": {
            **{f"contribute {list(s)}": gather_row(v, floor) for s, v in contribute["gather"].items() if s != shape},
            **{f"book {list(s)}": gather_row(v, floor) for s, v in book["gather"].items()},
            **{f"analysis {list(s)}": gather_row(v, floor) for s, v in analysis["gather"].items()},
            **{f"gtp {list(s)}": gather_row(v, floor) for s, v in gtp["gather"].items()},
            **{f"gatekeeper {list(s)}": gather_row(v, floor) for s, v in gate["gather"].items()},
            **{f"selfplay command {list(s)}": gather_row(v, floor) for s, v in command["gather"].items()},
            **{f"random inputs {list(s)}": gather_row(v, floor) for s, v in kern["timings"].items()},
            **{f"threads {label} {list(s)}": gather_row(v, floor) for label, c in threads["checks"].items()
               for s, v in c["gather"].items()},
        },
        "launches_threads_path": {label: r["launches"]["gather_rows"] for label, r in threads["runs"].items()},
    }
    # the deepest copied tree of the contribute cycle (B=64)
    width = contribute["batch"]
    timed = descent_row(contribute["descent"][width], floor)
    descend_entry = {
        "name": "descend_interior",
        "route": "cuda",
        "source": "katacoffee_tpu_torch/ops/descend_kernel.cu",
        "replaces": "katacoffee_tpu/ops/gather.py:39",
        "also_replaces": "katacoffee_tpu/search/mcts.py:1267",
        "launches": contribute["launches"]["descend_interior"],
        "simulations_run_contribute": contribute["sims"],
        "launches_book_path": book["launches"]["descend_interior"],
        "simulations_run_book": book["sims"],
        "launches_analysis_path": analysis["launches"]["descend_interior"],
        "simulations_run_analysis": analysis["sims"],
        "forbidden_lanes_hit_analysis": analysis["forbidden"],
        "launches_gtp_path": gtp["launches"]["descend_interior"],
        "simulations_run_gtp": gtp["sims"],
        "forbidden_lanes_hit": gtp["forbidden_lanes"],
        "launches_gatekeeper_path": gate["launches"]["descend_interior"],
        "simulations_run_gatekeeper": gate["sims"],
        "launches_selfplay_command_path": command["launches"]["descend_interior"],
        "simulations_run_selfplay_command": command["sims"],
        "launches_segment_path": selfplay["launches"]["descend_interior"],
        "launches_trainer_path": trainer["kernel_launches"]["descend_interior"],
        "max_abs_err": max(desc["max_abs_err"], *(v["max_abs_err"] for path in paths
                                                  for v in path["descent"].values())),
        "ms": timed["ms"],
        "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "floor_ms": timed["floor_ms"],
        "max_levels": timed["max_levels"],
        "us_per_level": timed["us_per_level"],
        "shape": timed["shape"],
        "timed_levels": timed["timed_levels"],
        "other_trees": {
            **{f"contribute B={b}": descent_row(v, floor) for b, v in contribute["descent"].items() if b != width},
            **{f"book B={b}": descent_row(v, floor) for b, v in book["descent"].items()},
            **{f"analysis B={b}": descent_row(v, floor) for b, v in analysis["descent"].items()},
            **{f"gtp B={b}": descent_row(v, floor) for b, v in gtp["descent"].items()},
            **{f"gatekeeper B={b}": descent_row(v, floor) for b, v in gate["descent"].items()},
            **{f"selfplay command B={b}": descent_row(v, floor) for b, v in command["descent"].items()},
            **{f"grown {k} tree B=512": descent_row(v, floor) for k, v in desc["timed"].items()},
            "threads K=1 B=64": descent_row(threads["checks"]["K=1"]["descent"][64], floor),
        },
        "simulations_run_segment_path": selfplay["sims"],
        "launches_default_path": search["launches"]["descend_interior"],
        "near_tie_flips": desc["flips"] + sum(v["flips"] for p in paths for v in p["descent"].values()),
        "games_compared": desc["games"] + sum(v["games"] for p in paths for v in p["descent"].values()),
        "levels_compared": desc["levels"] + sum(v["levels_compared"] for p in paths for v in p["descent"].values()),
        "ab_identical_games": search["ab_identical"],
        "ab_games": search["ab_games"],
        "ab_max_tv": search["ab_tv"],
        "selfplay_finishing_games_identical_fields": finishing["identical_fields"],
        "selfplay_finishing_games": finishing["games"],
        "selfplay_card_vs_cpu_parted_games": card_cpu["parted"],
        "gatekeeper_card_vs_cpu_parted_games": gate["card_vs_cpu"]["parted"],
    }
    # phase 5's timed segment (plies 3-4, B=512, plain evaluator) and the
    # command's segment (plies 1-2, B=256, randomizing)
    per_sim = [selfplay["segment_walls"][0] / selfplay["segment_sims"] * 1e3,
               command["segment_walls"][0] / command["segment_sims"] * 1e3]
    own = [r["own_s"] / r["wall_s"] for r in command["rows_runs"]]
    searches = ", ".join(f"lanes {s['lanes']} batch {s['batch']} at {s['visits']} visits {s['seconds']:.3f} s "
                         f"({s['root_vps']:.1f} root visits/s)" for s in analysis["searches"])
    rounds = ", ".join(f"{r['lanes']} lanes at B={r['batch']} {r['wall_s']:.3f} s ({r['root_vps']:.1f} root visits/s, "
                       f"{r['outside_s']:.4f} s outside run_search)" for r in book["rounds"])
    bus, ranks = contribute, contribute["ranks"]
    log("phase 15 (K playouts a round, B=64, 200 visits, for_selfplay): " + "; ".join(
        f"{label} fresh {r['fresh_rounds']} rounds {r['fresh_s']:.3f} s ({r['fresh_root_vps']:.1f} root visits/s), "
        f"reused {r['reused_rounds']} rounds {r['reused_s']:.3f} s ({r['reused_root_vps']:.1f} root visits/s)"
        for label, r in threads["runs"].items()) + f"; gtp genmove K={threads['gtp']['threads']} "
        f"{threads['gtp']['seconds']:.3f} s; phase 15 {threads['phase_s']:.1f} s")
    log(f"phase 14: done; contribute cycle {bus['wall_s']:.3f} s, {bus['rows']} rows ({bus['rows_per_s']:.1f} rows/s, "
        f"{bus['upload_s']:.3f} s uploading), rating task {bus['rating']['seconds']:.3f} s, the command "
        f"{bus['command']['seconds']:.1f} s, two ranks over {ranks['backend']} {ranks['seconds']:.1f} s, phase 12 "
        f"{bus['phase_s']:.1f} s; book rounds at {book['visits']} visits: {rounds} ({book['profile']['launches_per_sim']:.0f} launches, "
        f"{book['profile']['syncs_per_sim']:.2f} host reads and {book['profile']['stream_syncs_per_sim']:.2f} stream "
        f"syncs a playout at B=64); analysis searches {searches} ({analysis['profile']['launches_per_sim']:.0f} launches, "
        f"{analysis['profile']['syncs_per_sim']:.2f} host reads and {analysis['profile']['stream_syncs_per_sim']:.2f} "
        f"stream syncs a playout at B=16); gtp genmoves at {gtp['visits']} visits in "
        + ", ".join(f"{x:.3f}" for x in gtp["genmove_s"]) + f" s ({gtp['profile']['launches_per_sim']:.0f} launches, "
        f"{gtp['profile']['syncs_per_sim']:.2f} host syncs a playout); gatekeeper {gate['games']} games at {gate['visits']} visits in {gate['match_s']:.3f} s "
        f"({gate['games_per_s']:.3f} games/s, {gate['searched_vps']:.1f} searched visits/s, {gate['plies']} plies), "
        f"{gate['wins_a']}-{gate['wins_b']}-{gate['draws']}, candidate {gate['landed']}; loop cycle "
        f"{gate['loop']['wall_s']:.1f} s, {gate['loop']['export']} into {gate['loop']['landed']}; default B=512 600-visit search {search['vps']:.1f} visits/s; {SELFPLAY_METRIC} "
        f"{selfplay['delivered_vps']:.1f} (fresh move {selfplay['fresh_move_ms']:.1f} ms, reused move "
        f"{selfplay['reused_move_ms']:.1f} ms); side segment {branches['side_s']:.3f} s; selfplay command "
        f"{command['delivered_vps']:.1f} visits/s over its segments, {command['outside_s']:.3f} s outside them; "
        f"ms a simulation: B=512 segment (plies 3-4) {per_sim[0]:.2f}, the command's B=256 segment (plies 1-2) "
        f"{per_sim[1]:.2f}; "
        f"the daemon's own work in the rows runs " + ", ".join(f"{x:.2%}" for x in own) + " of the wall; "
        f"randomized evaluator {ab['randomized_ms'] / ab['plain_ms'] - 1:+.2%} on a fresh search; trainer "
        f"{trainer['ms_per_step_median']:.3f} ms a b6c96 B=256 step, {trainer['samples_per_s']:.1f} samples/s")
    # phase 15's instantiations of the descent: the rows of a round and the
    # leak, each with the launches and the timed copy of its own run
    threads_entries = []
    for label, name in (("K=2", "descend_interior rows K=2"), ("K=4", "descend_interior rows K=4"),
                        ("K=1 leak 0.1", "descend_interior leak"), ("K=2 leak 0.1", "descend_interior rows K=2 leak")):
        run, checked = threads["runs"][label], threads["checks"][label]["descent"]
        rows = max(checked)
        t = descent_row(checked[rows], floor)
        threads_entries.append({
            "name": name, "route": "cuda", "source": "katacoffee_tpu_torch/ops/descend_kernel.cu",
            "replaces": "katacoffee_tpu/ops/gather.py:39",
            "also_replaces": "katacoffee_tpu/search/mcts.py:1785" if run["K"] > 1 else "katacoffee_tpu/search/mcts.py:1209",
            "launches": run["launches"]["descend_interior"], "rounds_run": run["fresh_rounds"] + run["reused_rounds"],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "floor_ms": t["floor_ms"], "max_levels": t["max_levels"],
            "us_per_level": t["us_per_level"], "shape": t["shape"], "rows": rows, "near_tie_flips": t["flips"],
        })
    # phase 16's rectangle (5x7): the tiny net's for_selfplay() run, the
    # uniform evaluator's copies beside it
    rect_entries = []
    for kernel in ("gather", "descent"):
        by_eval = {label: c[kernel] for label, c in rect["checks"].items()}
        key = max(by_eval["tinynet"])
        run = rect["runs"]["tinynet"]
        if kernel == "gather":
            t = gather_row(by_eval["tinynet"][key], floor)
            entry = {"name": "gather_rows rect 5x7x4", "launches": run["launches"]["gather_rows"],
                     "max_abs_err": rect["checks"]["tinynet"]["gather_max_abs_err"], "shape": list(key),
                     "source": "katacoffee_tpu_torch/ops/gather_kernel.cu", "library_ms": t["library_ms"],
                     "other_shapes": {f"uniform {list(k)}": gather_row(v, floor)
                                      for k, v in by_eval["uniform"].items()}}
        else:
            t = descent_row(by_eval["tinynet"][key], floor)
            entry = {"name": "descend_interior rect 5x7x4", "launches": run["launches"]["descend_interior"],
                     "also_replaces": "katacoffee_tpu/search/mcts.py:1267", "max_abs_err": t["max_abs_err"],
                     "source": "katacoffee_tpu_torch/ops/descend_kernel.cu", "library_ms": None,
                     "shape": t["shape"], "max_levels": t["max_levels"], "us_per_level": t["us_per_level"],
                     "near_tie_flips": sum(v["flips"] for v in by_eval.values() for v in v.values()),
                     "games_compared": sum(v["games"] for v in by_eval.values() for v in v.values()),
                     "levels_compared": sum(v["levels_compared"] for v in by_eval.values() for v in v.values()),
                     "other_trees": {f"uniform B={b}": descent_row(v, floor) for b, v in by_eval["uniform"].items()}}
        entry.update(route="cuda", replaces="katacoffee_tpu/ops/gather.py:39", ms=t["ms"], plain_ms=t["plain_ms"],
                     bound_ms=t["bound_ms"], bound_by="bytes", floor_ms=t["floor_ms"],
                     simulations_run=run["sims"])
        rect_entries.append(entry)
    faults, mixed = rect["faults"], rect["mixed"]
    log(f"phase 16 (5x7 B=64 200 visits): tinynet {rect['runs']['tinynet']['seconds']:.3f} s, uniform "
        f"{rect['runs']['uniform']['seconds']:.3f} s; mixed sizes rows {mixed['rows']}, steps {mixed['steps']}; "
        f"daemon first shard {faults['daemon_first_shard_s']:.1f} s, again "
        f"{faults['daemon_resumed_first_shard_s']:.1f} s; trainer first checkpoint "
        f"{faults['train_first_checkpoint_s']:.1f} s, killed at step "
        f"{faults['step_at_kill']}, resumed to {faults['resumed_step']} in {faults['train_resumed_s']:.1f} s; gtp "
        f"kata-raw-nn {rect['gtp']['raw_nn_s'][0]:.3f} s then {rect['gtp']['raw_nn_s'][1]:.3f} s from the cache; "
        f"phase 16 {rect['phase_s']:.1f} s")
    log("kernel rows (device us a call):")
    log_kernel_rows(gather_entry, descend_entry)
    for e in rect_entries:
        log(f"  {e['name']} {e['shape']}: {e['ms'] * 1e3:.2f} us, bound {e['bound_ms'] * 1e3:.3f}, floor "
            f"{e['floor_ms'] * 1e3:.2f}, plain {e['plain_ms'] * 1e3:.2f}, launches {e['launches']}")
    for e in threads_entries:
        log(f"  {e['name']} ({e['rows']} rows): {e['ms'] * 1e3:.2f} us, bound {e['bound_ms'] * 1e3:.2f}, floor "
            f"{e['floor_ms'] * 1e3:.2f}, plain {e['plain_ms'] * 1e3:.2f}, deepest row {e['max_levels']} levels, "
            f"launches {e['launches']}")
    print(card_line(), flush=True)
    print(json.dumps({"trainer": trainer}), flush=True)
    print(json.dumps({"gtp": {k: v for k, v in gtp.items() if k not in ("gather", "descent")}}, default=str),
          flush=True)
    print(json.dumps({"analysis": {k: v for k, v in analysis.items() if k not in ("gather", "descent")}},
                     default=str), flush=True)
    print(json.dumps({"gatekeeper": {k: v for k, v in gate.items() if k not in ("gather", "descent")}},
                     default=str), flush=True)
    print(json.dumps({"book": {k: v for k, v in book.items() if k not in ("gather", "descent")}}, default=str),
          flush=True)
    print(json.dumps({"contribute": {k: v for k, v in contribute.items() if k not in ("gather", "descent")}},
                     default=str), flush=True)
    print(json.dumps({"search_threads": {k: v for k, v in threads.items() if k not in ("checks",)}}, default=str),
          flush=True)
    print(json.dumps({"rectangles": {k: v for k, v in rect.items() if k != "checks"}}, default=str), flush=True)
    print(json.dumps({"kernels": [gather_entry, descend_entry, *threads_entries, *rect_entries]}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    # the work and its output end in main; the interpreter's teardown after it
    # (CUDA, the profiler, spawned process groups) does nothing this script
    # needs and has hung once after the result line, so it is skipped
    try:
        code = main()
    except BaseException:
        traceback.print_exc()
        code = 1
    print(f"chip_smoke: exit {code} after {time.monotonic() - T0:.1f}s", file=sys.stderr, flush=True)
    sys.stdout.flush()
    os._exit(code)
