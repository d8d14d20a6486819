"""Device selection shared by the port's entry points."""

from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Asking for `cuda` on a machine without a GPU raises instead of
    running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "katacoffee_tpu_torch: no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def refuse_multi_host(command: str) -> None:
    """A command for which the JAX package forms no cluster (match,
    gatekeeper, loop) raises when a launcher started it as one of several
    processes (torch's WORLD_SIZE, or the JAX package's coordinator
    variables that the loop's launch scripts set)."""
    env = os.environ
    if (int(env.get("WORLD_SIZE") or 1) > 1 or env.get("JAX_COORDINATOR_ADDRESS")
            or int(env.get("JAX_NUM_PROCESSES") or 1) > 1):
        raise NotImplementedError(
            f"katacoffee_tpu_torch {command} runs as one process (the JAX package forms no cluster for it); "
            f"selfplay and train run one rank a GPU under torchrun --nproc-per-node N, and use every visible GPU "
            f"without it")
