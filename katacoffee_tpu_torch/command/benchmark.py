"""Benchmark: search visits/s over batch sizes, the port of
`katacoffee_tpu/command/benchmark.py` (`benchmark_search` and the
`benchmark` subcommand's `main`).

The parallelism axis is the game batch size B; the number reported is
NN-evaluated playouts per second. The first search per batch size is a
warm-up that pays the one-time costs (the CUDA kernel's build, cuDNN's
algorithm choice, allocator growth) and is not timed, as the JAX version
excludes compilation.
"""

from __future__ import annotations

import time

import torch

from katacoffee_tpu_torch.device import resolve_device
from katacoffee_tpu_torch.game.board import GameConfig, init_state
from katacoffee_tpu_torch.search.mcts import run_search
from katacoffee_tpu_torch.search.params import SearchParams


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark_search(
    cfg: GameConfig,
    sp: SearchParams,
    eval_fn,
    batch_sizes=(1, 16, 64, 256),
    num_visits: int = 200,
    reps: int = 3,
    device: str | torch.device | None = None,
    log=print,
    generator: torch.Generator | None = None,
    warmups: dict | None = None,
) -> dict:
    """Returns {batch_size: visits_per_second} for fresh-tree searches of
    `num_visits` playouts from the initial position, on `device` (default
    `cuda`). Each rate is B * num_visits over the mean wall time of `reps`
    searches, timed between device synchronizations. A profile that draws
    at the root (noise, sampled symmetries) draws from `generator`. The
    warm-up's seconds go to `warmups[batch_size]` where given."""
    dev = resolve_device(device)
    results = {}
    for B in batch_sizes:
        states = init_state(cfg, B, dev)
        t0 = time.monotonic()
        float(run_search(cfg, sp, eval_fn, states, num_visits, device=dev, generator=generator).stats.sum())
        warmup_s = time.monotonic() - t0
        if warmups is not None:
            warmups[B] = warmup_s
        total = torch.zeros((), device=dev)
        _sync(dev)
        t0 = time.monotonic()
        for _ in range(reps):
            total += run_search(cfg, sp, eval_fn, states, num_visits, device=dev, generator=generator).stats.sum()
        float(total)
        _sync(dev)
        dt = (time.monotonic() - t0) / reps
        results[B] = B * num_visits / dt
        log(
            f"batch {B:5d}: {results[B]:12.1f} visits/s "
            f"({dt * 1000:.1f} ms/search, warmup {warmup_s:.1f}s)"
        )
    best = max(results, key=results.get)
    log(f"best: batch {best} at {results[best]:.1f} visits/s")
    return results


def main(argv, *, device: str | torch.device | None = None) -> dict:
    """Entry for `python -m katacoffee_tpu_torch benchmark` (JAX
    benchmark.py:69): the same arguments, under the selfplay profile, on
    `device` (default `cuda`). Returns what benchmark_search returns."""
    import argparse

    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.search.mcts import make_nn_eval_fn, uniform_eval_fn

    dev = resolve_device(device)
    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch benchmark")
    ap.add_argument("-model", default=None, help="exported model dir (default: uniform priors)")
    ap.add_argument("-visits", type=int, default=200)
    ap.add_argument("-batch-sizes", default="1,16,64,256")
    args = ap.parse_args(argv)

    cfg = GameConfig(5, 5, 4)
    if args.model:
        model, cfg, meta = load_exported_model(args.model, device=dev)
        eval_fn = make_nn_eval_fn(cfg, model)
        print(f"model: {meta['name']}")
    else:
        eval_fn = uniform_eval_fn(cfg)
        print("model: none (uniform priors)")
    sp = SearchParams.for_selfplay()
    sizes = tuple(int(s) for s in args.batch_sizes.split(","))
    return benchmark_search(cfg, sp, eval_fn, batch_sizes=sizes, num_visits=args.visits, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(0))
