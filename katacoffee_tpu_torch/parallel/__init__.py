"""Several GPUs and several hosts: the port of `katacoffee_tpu/parallel/`,
one process a GPU over torch.distributed (`mesh.py`)."""

from katacoffee_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    broadcast_from_zero,
    init_distributed,
    launch_local,
    rank_rows,
)

__all__ = ["all_reduce_sum", "broadcast_from_zero", "init_distributed", "launch_local", "rank_rows"]
