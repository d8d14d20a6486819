"""Device selection shared by the port's entry points."""

from __future__ import annotations

import os

import torch

MULTI_GPU = "ROADMAP Queue 1 item 8 (multiple GPUs)"


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


def refuse_several_gpus(command: str, dev: torch.device, use_mesh: bool, batch_size: int) -> None:
    """Where the JAX package would shard the batch over every visible device
    (use_mesh, more than one device, the batch divisible), the port raises:
    several GPUs are not ported yet."""
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    if use_mesh and n_dev > 1 and batch_size % n_dev == 0:
        raise NotImplementedError(
            f"katacoffee_tpu_torch {command}: sharding the batch over {n_dev} GPUs (use_mesh) is not ported yet, "
            f"{MULTI_GPU}; make one GPU visible (CUDA_VISIBLE_DEVICES)")


def refuse_multi_host(command: str) -> None:
    """A multi-process launch (torch's WORLD_SIZE, or the JAX package's
    coordinator variables that the loop's launch scripts set) is not ported."""
    env = os.environ
    if (int(env.get("WORLD_SIZE") or 1) > 1 or env.get("JAX_COORDINATOR_ADDRESS")
            or int(env.get("JAX_NUM_PROCESSES") or 1) > 1):
        raise NotImplementedError(f"katacoffee_tpu_torch {command}: multi-host runs are not ported yet, {MULTI_GPU}")
