"""Benchmark: search visits/s over batch sizes, the port of
`katacoffee_tpu/command/benchmark.py` `benchmark_search`.

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
) -> dict:
    """Returns {batch_size: visits_per_second} for fresh-tree searches of
    `num_visits` playouts from the initial position, on `device` (default
    `cuda`). Each rate is B * num_visits over the mean wall time of `reps`
    searches, timed between device synchronizations."""
    dev = resolve_device(device)
    results = {}
    for B in batch_sizes:
        states = init_state(cfg, B, dev)
        t0 = time.monotonic()
        float(run_search(cfg, sp, eval_fn, states, num_visits, device=dev).stats.sum())
        warmup_s = time.monotonic() - t0
        total = torch.zeros((), device=dev)
        _sync(dev)
        t0 = time.monotonic()
        for _ in range(reps):
            total += run_search(cfg, sp, eval_fn, states, num_visits, device=dev).stats.sum()
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
