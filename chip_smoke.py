#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (`katacoffee_tpu_torch`) on one NVIDIA GPU and
checks it. Usage, from the root of the repository:

    python3 chip_smoke.py

Phases, each printed with the seconds since start; the first failure ends
the run with a non-zero exit and a traceback:
  0. arm a 600 s watchdog; print the card (nvidia-smi) and torch's version;
     turn TF32 off so float32 means float32 in every comparison;
  1. build the two CUDA kernels from the repo's sources, both nvcc runs at
     once, and print their register and spill counts;
  2. each kernel against its plain torch version: the child-stats gather
     exactly at the search's shapes, timed against the plain version and
     torch.gather; the fused interior descent on copies of mid-search trees
     (B=512 b6c96 5x5, B=64 uniform 9x9; the default and a branch profile),
     equal except games whose first different act is a near-tie of the
     plain version's scores of the two lanes (counted), timed at B=512;
  3. the b6c96 net (`run-s5200`, loaded with numpy) on the card against the
     CPU: float32 within 1e-4 on every head, the bf16 trunk within BF16_ATOL;
  4. the main path: `benchmark_search` at B=512, 600 visits, with both
     kernels' launch counts reset before and read after (one descent launch
     per simulation, at most two gathers per search); then B=64 searches of
     random positions: plain descent with the gather kernel against the
     plain gather (identical), and both kernels against both plain versions
     (identical games counted, total variation within TV_MAX); then card
     against CPU at float32 on B=8 (root visit distributions); then a
     profile of a short B=512 search (device busy share, launches, host
     syncs);
  5. the kernel table as one JSON line, then the result line.

Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import faulthandler
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

T0 = time.monotonic()
MODEL_DIR = "artifacts/flagship_b6c96/models/run-s5200"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
KERNEL_SHAPES = ((16, 64, 8, 24), (8, 130, 8, 100), (512, 602, 8, 100), (512, 602, 8, 20))
TIMED_SHAPES = ((512, 602, 8, 100), (512, 602, 8, 20))
MAIN_SHAPE = (512, 602, 8, 100)  # the root's full-width gather, the one left on the main path
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
    timings = {}
    for shape in TIMED_SHAPES:
        table, idx = gather_inputs(shape, dev, seed=99)
        B, N, S, A = shape
        expanded = idx.clamp(0, N - 1).to(torch.int64)[:, :, None].expand(B, A, S).contiguous()
        t = {
            "ms": device_ms(lambda: gather_rows(table, idx)),
            "plain_ms": device_ms(lambda: gather_rows_plain(table, idx)),
            "library_ms": device_ms(lambda: torch.gather(table, 1, expanded)),
            "bound_ms": gather_bound_ms(table, idx),
            "eager_ms": eager_ms(lambda: gather_rows(table, idx)),
        }
        timings[shape] = t
        log(
            f"(B,N,S,A)={shape} device time per call: kernel {t['ms'] * 1e3:.2f} us, "
            f"plain {t['plain_ms'] * 1e3:.2f} us, torch.gather {t['library_ms'] * 1e3:.2f} us, "
            f"bound {t['bound_ms'] * 1e3:.2f} us; kernel launched eagerly {t['eager_ms'] * 1e3:.2f} us"
        )
    return {"max_abs_err": max_err, "timings": timings}


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
    path, acts, _, node, depth, active = mcts._descend_root(sp, tree, root_cs, cfg.area + 1)
    return node, depth, active, path, acts, mcts.make_level_scratch(cfg, B, cfg.area + 1, dev)


def run_descent(fn, cfg, sp, tree, start_ev, inputs):
    """`fn` (kernel dispatcher or plain version) on copies of the inputs;
    returns (leaf, leaf_depth, path, acts, edge_visits, *scratch)."""
    import torch

    from katacoffee_tpu_torch.search import mcts

    node, depth, active, path, acts, scratch = inputs
    tree.edge_visits.copy_(start_ev)
    p, a = path.clone(), acts.clone()
    sc = mcts.LevelScratch(*(x.clone() for x in scratch))
    leaf, leaf_depth = fn(cfg, sp, tree, node, depth, active, p, a, sc)
    torch.cuda.synchronize()
    return (leaf, leaf_depth, p, a, tree.edge_visits.clone(), *sc)


def compare_descent(label, cfg, sp, tree, start_ev, inputs, got, want) -> tuple[int, float]:
    """Holds a descent's outputs `got` (leaf, leaf_depth, path, acts,
    edge_visits, *scratch) to the plain version's `want` from the same
    `inputs`. A game whose acts agree must agree in every output. A game
    whose acts differ agrees up to its first different act, which the plain
    version recorded too (an active game, a non-terminal node above the depth
    cap), and there the plain version's score of its own lane exceeds its
    score of the other lane by more than 0 and at most NEAR_TIE: equal scores
    go to the lower lane, as torch.argmax does. Leaves `tree.edge_visits` at
    `start_ev`. Returns (games whose acts differ, max |diff| of the float
    outputs of the others)."""
    import torch

    from katacoffee_tpu_torch.search import mcts

    _, depth, active, _, _, _ = inputs
    acts_k, acts_p = got[3], want[3]
    differ = acts_k != acts_p
    flip = differ.any(-1)
    same = ~flip
    err = 0.0
    for i, (x, y) in enumerate(zip(got, want)):
        if not torch.equal(x[same], y[same]):
            raise AssertionError(f"{label}: descent output {i} differs from plain")
        if x.is_floating_point() and same.any():
            err = max(err, (x[same] - y[same]).abs().max().item())
    tree.edge_visits.copy_(start_ev)
    if not flip.any():
        return 0, err

    B, D = want[5].shape[:2]
    bidx = torch.arange(B, device=acts_p.device)
    first = differ.to(torch.int8).argmax(-1)
    path_k, path_p = got[2], want[2]
    cols = torch.arange(D + 1, device=acts_p.device)[None, :]
    if not torch.equal(path_k[flip][(cols <= first[:, None])[flip]],
                       path_p[flip][(cols <= first[:, None])[flip]]):
        raise AssertionError(f"{label}: a game's path differs before its first different act")
    before = (cols[:, :D] < first[:, None])[flip]  # slot j <-> depth j + 1
    for i in range(5, 9):
        if not torch.equal(got[i][flip][before], want[i][flip][before]):
            raise AssertionError(f"{label}: scratch output {i} differs above the first different act")
    # edge visits agree outside the rows of the nodes from that depth down
    beyond = torch.zeros(tree.edge_visits.shape[:2], dtype=torch.bool, device=acts_p.device)
    for p in (path_k, path_p):
        m = (cols >= first[:, None]) & (p >= 0) & flip[:, None]
        beyond[bidx[:, None].expand_as(p)[m], p[m]] = True
    if not torch.equal(got[4][~beyond & flip[:, None]], want[4][~beyond & flip[:, None]]):
        raise AssertionError(f"{label}: edge visits differ off the paths below the first different act")

    at = path_p[bidx, first].clamp(min=0)
    recorded = active & (first >= depth) & (first <= want[1]) & (first < D) & ~tree.is_terminal[bidx, at]
    lane_k, lane_p = acts_k[bidx, first], acts_p[bidx, first]
    _, _, sel = mcts._interior_level(cfg, sp, tree, bidx, at)
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


def descent_bound_ms(cfg, tree, inputs, out) -> float:
    """Least time for this descent at the HBM rate, each byte the kernel must
    read or write counted once, from the levels this run's data needs. Per
    level: the node's terminal flag and last move (17 B), 12 B per candidate
    (child, edge visits, prior), 32 B per present child's stats row, the
    scratch slot written (44 B a lane); per non-terminal level the node's own
    utility (4 B) and the act (8 B), and on the game's first level its stats
    row (32 B; deeper nodes' rows were read as the level above's child row).
    Each distinct candidate-table row once (4 B a lane); per step 8 B of path
    and the 4 B edge-visit write (its read is the candidate's); per game 17 B
    in and 16 B out."""
    import torch

    from katacoffee_tpu_torch.search import mcts

    node, depth, active, _, _, scratch = inputs
    leaf_depth, out_path, out_child_c = out[1], out[2], out[7]
    B, D, C = scratch.child_c.shape
    bidx = torch.arange(B, device=node.device)[:, None]
    last = torch.where(leaf_depth < D, leaf_depth, leaf_depth - 1)
    slots = torch.arange(D, device=node.device)[None, :]  # slot j <-> depth j + 1
    done = active[:, None] & (slots >= depth[:, None] - 1) & (slots <= last[:, None] - 1)
    nodes = out_path[:, 1:].clamp(min=0)
    spot = tree.states.last_spot[bidx, nodes]
    spot = torch.where((spot < 0) | (spot > cfg.area), cfg.area, spot)
    row = spot * 5 + tree.states.last_dir[bidx, nodes].clamp(0, 4)
    rows = torch.unique(row[done]).numel()
    cand = mcts._cand_table(cfg, node.device).reshape(-1, C)[row]
    nonterm = done & ~tree.is_terminal[bidx, nodes]
    first = nonterm & (slots == depth[:, None] - 1)
    levels = int(done.sum())
    valid = int(((cand >= 0) & done[..., None]).sum())
    present = int(((out_child_c >= 0) & done[..., None]).sum())
    steps = int(torch.where(active, leaf_depth - depth, 0).sum())
    nbytes = (levels * (17 + 44 * C) + int(nonterm.sum()) * 12 + int(first.sum()) * 32 + rows * 4 * C
              + valid * 12 + present * 32 + steps * 12 + B * 33)
    return nbytes / HBM_BYTES_PER_S * 1e3


def time_descent(cfg, sp, tree, start_ev, inputs, reps: int = 30):
    """Device time of one kernel launch (CUDA events around the launch only;
    a sleep kernel queued first keeps the host's launch cost out of the
    window) and the plain version's wall time per call, both on the same
    snapshot restored before each call. Medians, in ms."""
    import torch

    from katacoffee_tpu_torch.ops.descend import descend_interior
    from katacoffee_tpu_torch.search import mcts

    node, depth, active, path, acts, scratch = inputs
    cand = mcts._cand_table_i32(cfg, node.device)
    p, a = path.clone(), acts.clone()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    kernel = []
    for _ in range(reps):
        tree.edge_visits.copy_(start_ev)
        p.copy_(path)
        a.copy_(acts)
        torch.cuda._sleep(1_000_000)
        start.record()
        descend_interior(sp, cand, tree, node, depth, active, p, a, scratch)
        end.record()
        end.synchronize()
        kernel.append(start.elapsed_time(end))
    plain = []
    for _ in range(max(reps // 3, 3)):
        tree.edge_visits.copy_(start_ev)
        p.copy_(path)
        a.copy_(acts)
        torch.cuda.synchronize()
        t = time.perf_counter()
        mcts._descend_interior_plain(cfg, sp, tree, node, depth, active, p, a, scratch)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t) * 1e3)
    tree.edge_visits.copy_(start_ev)
    return statistics.median(kernel), statistics.median(plain)


def phase_descend(dev, cfg, cfg9, batch=512, sims=300, batch9=64, sims9=200):
    """The fused descent kernel against `_descend_interior_plain` on copies
    of mid-search trees, held by `compare_descent`. Timed on the B=512
    b6c96 tree with the default profile."""
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
    profiles = (("default", SearchParams()), ("branch", branch))
    net = mcts.make_nn_eval_fn(cfg, load_exported_model(MODEL_DIR, dev)[0])
    cases = (
        (f"B={batch} b6c96 5x5", cfg, net, random_positions(cfg, batch, seed=1), sims, 602),
        (f"B={batch9} uniform 9x9", cfg9, mcts.uniform_eval_fn(cfg9), random_positions(cfg9, batch9, seed=2),
         sims9, None),
    )
    timed = cases[0][0]
    result = {"flips": 0, "games": 0, "levels": 0, "max_abs_err": 0.0}
    for label, c, eval_fn, roots, sims, max_nodes in cases:
        tree = mcts.run_search(c, SearchParams(), eval_fn, roots, sims, max_nodes, device=dev)
        base_ev = tree.edge_visits.clone()
        for pname, sp in profiles:
            tree.edge_visits.copy_(base_ev)
            inputs = descent_inputs(c, sp, tree)
            start_ev = tree.edge_visits.clone()
            got = run_descent(mcts._descend_interior, c, sp, tree, start_ev, inputs)
            want = run_descent(mcts._descend_interior_plain, c, sp, tree, start_ev, inputs)
            n_flip, err = compare_descent(f"{label} {pname}", c, sp, tree, start_ev, inputs, got, want)
            result["max_abs_err"] = max(result["max_abs_err"], err)
            depth, active = inputs[1:3]
            leaf_depth = want[1]
            levels = int(torch.where(active, leaf_depth - depth + (leaf_depth < c.area + 1).long(), 0).sum())
            result["flips"] += n_flip
            result["games"] += int(active.sum())
            result["levels"] += levels
            log(
                f"descent kernel == plain: {label} {pname}: {int(active.sum())} games descending, "
                f"{levels} levels, max depth {int(leaf_depth.max())}, {n_flip} near-tie act flips"
            )
            if label == timed and pname == "default":
                ms, plain_ms = time_descent(c, sp, tree, start_ev, inputs)
                bound = descent_bound_ms(c, tree, inputs, got)
                result.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, timed_levels=levels,
                              shape=[batch, 602, c.policy_size, 4 * max(c.x_size, c.y_size)])
                log(
                    f"  descent per call at {label} ({sims} sims in): kernel {ms * 1e3:.2f} us device, "
                    f"plain {plain_ms * 1e3:.1f} us wall, bound {bound * 1e3:.3f} us (bytes)"
                )
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
                 ab_visits=200, tv_batch=8, tv_visits=64):
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
    reps = 3
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


def phase_profile(dev, cfg, batch=512, sims=20):
    """Where a search's time goes: the wall time of a fresh `sims`-playout
    search, then the device time of the same search under torch.profiler,
    its kernel launches, its host syncs and the kernels with the most device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.game.board import init_state
    from katacoffee_tpu_torch.search import mcts
    from katacoffee_tpu_torch.search.params import SearchParams

    def search():
        mcts.run_search(cfg, SearchParams(), evaluate, roots, sims, device=dev)
        torch.cuda.synchronize()

    evaluate = mcts.make_nn_eval_fn(cfg, load_exported_model(MODEL_DIR, dev)[0])
    roots = init_state(cfg, batch, dev)
    search()
    t = time.monotonic()
    search()
    wall = time.monotonic() - t
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        search()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    device_kernels = sum(e.count for e in kernels)
    syncs = sum(e.count for e in events if e.key == "aten::_local_scalar_dense")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(
        f"profile B={batch} {sims} sims: wall {wall:.3f}s unprofiled, device busy {busy:.3f}s "
        f"({busy / wall:.1%} of the wall), {launches / sims:.0f} cudaLaunchKernel calls and "
        f"{device_kernels / sims:.0f} device kernels and {syncs / sims:.2f} host reads of a device "
        f"value (aten::_local_scalar_dense, each a host sync) per simulation"
    )
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:7d}x  {e.key[:90]}")


def main() -> int:
    faulthandler.dump_traceback_later(600, exit=True)
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
    with ThreadPoolExecutor(2) as pool:
        for built in [pool.submit(m.load_kernel) for m in (gather, descend)]:
            built.result()
    log(f"phase 1: gather and descent kernels built and loaded in {time.monotonic() - t:.1f}s")
    for m in (gather, descend):
        for line in _build.build_log(m.SOURCE).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {m.SOURCE.name}: {line.strip()}")

    log("phase 2: kernels against their plain versions")
    kern = phase_kernel(dev)
    cfg = GameConfig(5, 5, 4)
    desc = phase_descend(dev, cfg, GameConfig(9, 9, 4))

    log("phase 3: net")
    positions = random_positions(cfg, 64, seed=0)
    phase_net(dev, cfg, positions)

    log("phase 4: search")
    search = phase_search(dev, cfg, positions)
    phase_profile(dev, cfg)

    t = kern["timings"][MAIN_SHAPE]
    gather_entry = {
        "name": "gather_rows",
        "route": "cuda",
        "source": "katacoffee_tpu_torch/ops/gather_kernel.cu",
        "replaces": "katacoffee_tpu/ops/gather.py:39",
        "launches": search["launches"]["gather_rows"],
        "max_abs_err": kern["max_abs_err"],
        "max_abs_diff_vs_plain": kern["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "library_ms": t["library_ms"],
        "eager_ms": t["eager_ms"],
        "shape": list(MAIN_SHAPE),
        "launches_per_search": search["per_search"]["gather_rows"],
        "other_shapes": {
            str(list(s)): v for s, v in kern["timings"].items() if s != MAIN_SHAPE
        },
    }
    descend_entry = {
        "name": "descend_interior",
        "route": "cuda",
        "source": "katacoffee_tpu_torch/ops/descend_kernel.cu",
        "replaces": "katacoffee_tpu/ops/gather.py:39",
        "also_replaces": "katacoffee_tpu/search/mcts.py:1267",
        "launches": search["launches"]["descend_interior"],
        "max_abs_err": desc["max_abs_err"],
        "ms": desc["ms"],
        "plain_ms": desc["plain_ms"],
        "bound_ms": desc["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shape": desc["shape"],
        "timed_levels": desc["timed_levels"],
        "launches_per_search": search["per_search"]["descend_interior"],
        "near_tie_flips": desc["flips"],
        "games_compared": desc["games"],
        "levels_compared": desc["levels"],
        "ab_identical_games": search["ab_identical"],
        "ab_games": search["ab_games"],
        "ab_max_tv": search["ab_tv"],
    }
    log(f"phase 5: done; B=512 600-visit search {search['vps']:.1f} visits/s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [gather_entry, descend_entry]}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
