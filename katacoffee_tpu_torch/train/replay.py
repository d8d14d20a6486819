"""Replay buffer: the port of `katacoffee_tpu/train/replay.py`, in numpy.
A host-side ring of recent training rows with a sliding window that grows as
a tapered power of the rows added, sampled uniformly with the same
`np.random.RandomState` stream as the JAX package's, so one seed samples
the same rows.

Rows are kept as a TrainingBatch of numpy arrays (its `states` a GameState);
`add` takes one of tensors on any device, or of numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from katacoffee_tpu_torch.game.board import GameState
from katacoffee_tpu_torch.selfplay.actor import TrainingBatch


def _map(fn, batch: TrainingBatch) -> TrainingBatch:
    return TrainingBatch(*(GameState(*map(fn, x)) if isinstance(x, GameState) else fn(x) for x in batch))


def _zip_map(fn, a: TrainingBatch, b: TrainingBatch) -> None:
    for x, y in zip(a, b):
        for xx, yy in (zip(x, y) if isinstance(x, GameState) else ((x, y),)):
            fn(xx, yy)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class ReplayBuffer:
    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = int(capacity)
        self.rng = np.random.RandomState(seed)
        self._store: TrainingBatch | None = None  # numpy arrays [capacity, ...]
        self.size = 0
        self.head = 0
        self.total_added = 0

    def add(self, batch: TrainingBatch) -> int:
        """Add the rows with weight > 0. Returns the number added."""
        host = _map(_host, batch)
        keep = host.weight > 0
        n = int(keep.sum())
        if n == 0:
            return 0
        rows = _map(lambda x: x[keep], host)
        if self._store is None:
            self._store = _map(lambda x: np.zeros((self.capacity,) + x.shape[1:], x.dtype), rows)
        idx = (self.head + np.arange(n)) % self.capacity
        _zip_map(lambda store, new: store.__setitem__(idx, new[: len(idx)]), self._store, rows)
        self.head = int((self.head + n) % self.capacity)
        self.size = int(min(self.size + n, self.capacity))
        self.total_added += n
        return n

    def window_size(self) -> int:
        """The newest min(size, 25k * (total/25k)^0.65) rows once more than
        25k rows were added; all rows before."""
        base = 25_000
        if self.total_added <= base:
            return self.size
        w = int(base * (self.total_added / base) ** 0.65)
        return max(1, min(self.size, w))

    def sample(self, batch_size: int) -> TrainingBatch:
        """A uniform sample of the window: a TrainingBatch of numpy arrays
        [batch_size, ...]."""
        if self.size <= 0:
            raise ValueError("empty replay buffer")
        w = self.window_size()
        # newest w rows: positions head-1 ... head-w
        offs = self.rng.randint(0, w, size=batch_size)
        idx = (self.head - 1 - offs) % min(self.size, self.capacity)
        return _map(lambda x: x[idx], self._store)
