#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (`katacoffee_tpu_torch`) on one NVIDIA GPU and
checks it. Usage, from the root of the repository:

    python3 chip_smoke.py

Phases, each printed with the seconds since start; the first failure ends
the run with a non-zero exit and a traceback:
  0. arm a 600 s watchdog; print the card (nvidia-smi) and torch's version;
     turn TF32 off so float32 means float32 in every comparison;
  1. build and load the CUDA child-stats gather kernel from the repo's source;
  2. kernel against its plain torch version at the search's shapes, exact;
     time the kernel, the plain version and torch.gather;
  3. the b6c96 net (`run-s5200`, loaded with numpy) on the card against the
     CPU: float32 within 1e-4 on every head, the bf16 trunk within BF16_ATOL;
  4. the main path: `benchmark_search` at B=512, 600 visits, with the kernel
     launch count reset before and read after; then the same search at B=64
     with the kernel and with the plain gather injected (identical trees);
     then card against CPU at float32 on B=8 (root visit distributions);
     then a profile of a short B=512 search (device busy share, launches);
  5. the kernel table as one JSON line, then the result line.

Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import faulthandler
import json
import subprocess
import sys
import time

T0 = time.monotonic()
MODEL_DIR = "artifacts/flagship_b6c96/models/run-s5200"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
KERNEL_SHAPES = ((16, 64, 8, 24), (8, 130, 8, 100), (512, 602, 8, 100), (512, 602, 8, 20))
TIMED_SHAPES = ((512, 602, 8, 100), (512, 602, 8, 20))
MAIN_SHAPE = (512, 602, 8, 20)  # interior descent levels: the path's most frequent gather
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
    from katacoffee_tpu_torch.game.board import init_state
    from katacoffee_tpu_torch.ops.gather import gather_rows, gather_rows_plain
    from katacoffee_tpu_torch.search.params import SearchParams

    sp = SearchParams()
    net16 = load_exported_model(MODEL_DIR, dev)[0]
    eval16 = mcts.make_nn_eval_fn(cfg, net16)
    reps = 3

    gather_rows.launches = 0
    vps = benchmark_search(cfg, sp, eval16, batch_sizes=(bench_batch,), num_visits=bench_visits,
                           reps=reps, device=dev, log=log)[bench_batch]
    launches = gather_rows.launches
    if launches == 0:
        raise AssertionError("the main path launched no gather_rows kernel")
    per_search = launches / (reps + 1)
    log(
        f"main path: B={bench_batch} {bench_visits} visits: {vps:.1f} visits/s, "
        f"{bench_batch * bench_visits / vps * 1e3:.1f} ms/search, "
        f"{per_search:.1f} gather_rows launches per search ({launches} in {reps + 1} searches)"
    )

    roots = init_state(cfg, ab_batch, dev)
    trees = {}
    for name, fn in (("kernel", gather_rows), ("plain", gather_rows_plain)):
        mcts.gather_rows = fn
        try:
            tree = mcts.run_search(cfg, sp, eval16, roots, ab_visits, device=dev)
            trees[name] = (mcts.root_visit_counts(tree).clone(), mcts.root_values(tree))
        finally:
            mcts.gather_rows = gather_rows
        if not torch.isfinite(tree.stats).all():
            raise AssertionError(f"{name}: non-finite tree stats")
        if not (trees[name][0].sum(-1) == ab_visits).all():
            raise AssertionError(f"{name}: root visits do not sum to {ab_visits}")
    (vk, rk), (vp, rp) = trees["kernel"], trees["plain"]
    if not torch.equal(vk, vp) or any(not torch.equal(rk[k], rp[k]) for k in rk):
        raise AssertionError("search with the kernel differs from search with the plain gather")
    log(f"B={ab_batch} {ab_visits} visits: kernel and plain gather give identical root visits and values")

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
    return {"vps": vps, "launches": launches, "per_search": per_search}


def phase_profile(dev, cfg, batch=512, sims=20):
    """Where a search's time goes: the wall time of a fresh `sims`-playout
    search, then the device time of the same search under torch.profiler,
    its kernel launches and the kernels with the most device time."""
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
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(
        f"profile B={batch} {sims} sims: wall {wall:.3f}s unprofiled, device busy {busy:.3f}s "
        f"({busy / wall:.1%} of the wall), {launches / sims:.0f} kernel launches per simulation"
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
    from katacoffee_tpu_torch.ops.gather import load_kernel

    t = time.monotonic()
    load_kernel()
    log(f"phase 1: gather kernel built and loaded in {time.monotonic() - t:.1f}s")

    log("phase 2: kernel against plain")
    kern = phase_kernel(dev)

    log("phase 3: net")
    cfg = GameConfig(5, 5, 4)
    positions = random_positions(cfg, 64, seed=0)
    phase_net(dev, cfg, positions)

    log("phase 4: search")
    search = phase_search(dev, cfg, positions)
    phase_profile(dev, cfg)

    t = kern["timings"][MAIN_SHAPE]
    entry = {
        "name": "gather_rows",
        "route": "cuda",
        "source": "katacoffee_tpu_torch/ops/gather_kernel.cu",
        "replaces": "katacoffee_tpu/ops/gather.py:39",
        "launches": search["launches"],
        "max_abs_err": kern["max_abs_err"],
        "max_abs_diff_vs_plain": kern["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "library_ms": t["library_ms"],
        "eager_ms": t["eager_ms"],
        "shape": list(MAIN_SHAPE),
        "launches_per_search": search["per_search"],
        "other_shapes": {
            str(list(s)): v for s, v in kern["timings"].items() if s != MAIN_SHAPE
        },
    }
    log(f"phase 5: done; B=512 600-visit search {search['vps']:.1f} visits/s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
