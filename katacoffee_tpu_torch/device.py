"""Device selection shared by the port's entry points."""

from __future__ import annotations

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
