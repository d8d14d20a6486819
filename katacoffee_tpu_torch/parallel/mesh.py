"""Several GPUs and several hosts: torch.distributed in the role of
`katacoffee_tpu/parallel/mesh.py`.

The JAX package runs one process a host and shards the batch over that
host's chips inside it (a `Mesh` over axis "data", `shard_map` for the
selfplay daemon, sharding annotations for the train step). The port runs
one process a GPU, torch's idiom for data parallelism: the search is
host-bound (about a thousand eager launches a playout, the card mostly
idle), so one Python thread driving several GPUs would gain nothing.

- `init_distributed` joins the world a launcher describes (torchrun's
  `WORLD_SIZE`, `RANK`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`): the
  role of `jax.distributed.initialize` (JAX mesh.py:11-30), multi-host
  included.
- `launch_local` starts that world on this host when a command runs outside
  a launcher and the JAX package would shard (`use_mesh`, several visible
  devices, the batch divisible by their number: JAX command/selfplay.py:205,
  command/train.py:225).
- `rank_rows` is `shard_leading_axis`'s role: the rank's contiguous block
  of the leading axis, as `P("data")` gives device i block i.
- `broadcast_from_zero` is `replicate`'s role, `all_reduce_sum` the psum
  that XLA inserts.

`local_rows` (JAX mesh.py:87) and `shard_map_batched` (:124) have no
counterpart: a rank holds only its own rows, so its host copy is its
shard, and it runs the unsharded step on them, which is what `shard_map`
makes each shard run (per-shard lockstep, no collective inside a segment).
"""

from __future__ import annotations

import datetime
import os
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist

from katacoffee_tpu_torch.device import resolve_device

# a rank that never arrives, or never answers a collective, fails the run
# after this long instead of hanging it
TIMEOUT = datetime.timedelta(seconds=60)


def world() -> tuple[int, int]:
    """(rank, world size) of this process: (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def in_launcher() -> bool:
    """Whether a launcher (torchrun) started this process as one rank of
    several."""
    return int(os.environ.get("WORLD_SIZE") or 1) > 1


def init_distributed(backend: str | None = None, *, device: str | torch.device | None = None) -> tuple[int, int]:
    """Join the process group that the environment describes (torchrun's
    variables) and return (rank, world size); a no-op for one process. The
    backend is `nccl` for a CUDA device and `gloo` for the CPU unless
    `backend` names one; an NCCL failure raises, it never falls back to
    gloo. On CUDA the rank's device becomes the current one: `device`'s
    index where it names one, else LOCAL_RANK."""
    if not in_launcher() or dist.is_initialized():
        return world()
    dev = resolve_device(device)
    env = os.environ
    rank, size = int(env["RANK"]), int(env["WORLD_SIZE"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None else int(env.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"), init_method="env://",
                            rank=rank, world_size=size, timeout=TIMEOUT)
    return world()


def destroy_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """`device` with the rank's GPU index filled in (`cuda` becomes the
    current device, which `init_distributed` set)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def local_world_size(device: torch.device, use_mesh: bool, batch_size: int) -> int:
    """How many ranks a command started outside a launcher runs on this
    host: every visible GPU where the JAX package would shard over every
    local device (use_mesh, more than one, the batch divisible by their
    number) and `device` names no index, else 1."""
    if device.type != "cuda" or device.index is not None or in_launcher() or dist.is_initialized():
        return 1
    n = torch.cuda.device_count()
    return n if use_mesh and n > 1 and batch_size % n == 0 else 1


def rank_seed(seed: int, rank: int, size: int) -> int:
    """A rank's generator seed: `seed` itself for one process, else one
    drawn from (seed, rank), as the JAX package folds the shard index into
    its key."""
    if size == 1:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0] >> 1)


def rank_rows(x: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """The rank's contiguous block of the leading axis, which must divide
    by the world size."""
    if x.shape[0] % size:
        raise ValueError(f"a leading axis of {x.shape[0]} does not divide over {size} ranks")
    n = x.shape[0] // size
    return x[rank * n: (rank + 1) * n]


def broadcast_from_zero(tensors) -> None:
    """Rank 0's values of `tensors`, in place on every rank."""
    if world()[1] > 1:
        for t in tensors:
            dist.broadcast(t, src=0)


def broadcast_object_from_zero(obj):
    """Rank 0's `obj` (picklable) on every rank."""
    if world()[1] == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, in place; returns `x`. Every rank
    gets the same bits."""
    if world()[1] > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, size: int, port: int, backend, device, fn, args, results) -> None:
    env = os.environ
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(size), RANK=str(rank),
               LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(size))
    try:
        init_distributed(backend, device=device)
        try:
            out = fn(*args)
        finally:
            destroy_distributed()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def launch_local(fn, n: int, *args, backend: str | None = None, device: str | torch.device | None = None) -> list:
    """Run `fn(*args)` in `n` spawned ranks of one process group on this
    host (a free localhost port), each after `init_distributed(backend,
    device=device)`: `device` `cuda` puts rank r on GPU r; one that names
    an index puts every rank there. `fn` and `args` must pickle (`fn` a
    module-level function). Returns the ranks' results in rank order;
    raises, with the traceback, when a rank fails, after stopping the
    others."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    dev = None if device is None else str(device)
    procs = [ctx.Process(target=_rank_main, args=(r, n, port, backend, dev, fn, args, results), daemon=False)
             for r in range(n)]
    for p in procs:
        p.start()
    got: dict[int, object] = {}
    failed = None
    try:
        while len(got) < n and failed is None:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    failed = f"rank {dead[0][0]} exited with code {dead[0][1]}"
                continue
            if ok:
                got[rank] = out
            else:
                failed = f"rank {rank} failed:\n{out}"
    finally:
        for p in procs:
            if failed is not None and p.is_alive():
                p.terminate()
            p.join()
    if failed is not None:
        raise RuntimeError(f"launch_local: {failed}")
    return [got[r] for r in range(n)]
