"""Child-stats row gather: `out[b, a, :] = table[b, idx[b, a], :]`, zero
where `idx[b, a]` is outside [0, N).

The port of `katacoffee_tpu/ops/gather.py` (the Pallas kernel
`_gather_kernel`) and of the missing-child masking around it in
`_gather_child_stats`. Every child-stats row gather of the search goes
through `gather_rows`: on a CUDA tensor it launches the hand-written kernel
in `gather_kernel.cu` (built at first use by `_build.py`) or raises; on a CPU
tensor it computes `gather_rows_plain`.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from katacoffee_tpu_torch.ops._build import load_library

SOURCE = Path(__file__).resolve().with_name("gather_kernel.cu")
ROW_WIDTH = 8  # float32 channels per row: the packed node stats


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain torch version: advanced indexing, then the mask."""
    B, N, _ = table.shape
    valid = (idx >= 0) & (idx < N)
    bidx = torch.arange(B, device=table.device)[:, None]
    rows = table[bidx, idx.clamp(0, N - 1).to(torch.int64)]
    return torch.where(valid[..., None], rows, torch.zeros((), dtype=table.dtype, device=table.device))


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build (once) and load the CUDA kernel's library."""
    lib = load_library(SOURCE)
    lib.kc_gather_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.kc_gather_rows.restype = ctypes.c_int
    lib.kc_error_string.argtypes = [ctypes.c_int]
    lib.kc_error_string.restype = ctypes.c_char_p
    return lib


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out [B, A, 8] float32 from table [B, N, 8] float32 and idx [B, A]
    int32; rows whose index is outside [0, N) are zero.

    CPU tensors take `gather_rows_plain`. CUDA tensors launch the kernel on
    the current stream, counted in `gather_rows.launches`; a tensor the
    kernel does not take, or a kernel that fails to build or launch, raises."""
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if not (table.is_cuda and idx.is_cuda and table.device == idx.device):
        raise ValueError(f"gather_rows: table on {table.device}, idx on {idx.device}")
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"gather_rows: need float32 table and int32 idx, got {table.dtype}, {idx.dtype}")
    if (
        table.dim() != 3 or table.shape[2] != ROW_WIDTH
        or idx.dim() != 2 or idx.shape[0] != table.shape[0]
    ):
        raise ValueError(f"gather_rows: bad shapes table {tuple(table.shape)}, idx {tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()) or table.data_ptr() % 16:
        raise ValueError("gather_rows: table and idx must be contiguous, table 16-byte aligned")
    if table.get_device() != torch.cuda.current_device():
        # the kernel launches on the current device
        with torch.cuda.device(table.device):
            return gather_rows(table, idx)
    B, N, S = table.shape
    A = idx.shape[1]
    out = torch.empty((B, A, S), dtype=torch.float32, device=table.device)
    lib = load_kernel()
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.kc_gather_rows(table.data_ptr(), idx.data_ptr(), out.data_ptr(), B, N, A, stream)
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: {lib.kc_error_string(err).decode()}")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
