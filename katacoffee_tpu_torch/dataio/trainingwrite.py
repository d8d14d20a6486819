"""Training-data npz writer/reader: the port of
`katacoffee_tpu/dataio/trainingwrite.py`, writing and reading the same
shards (same keys, dtypes, shapes and schema versions).

The role of the reference's `TrainingDataWriter`/`TrainingWriteBuffers`
(`cpp/dataio/trainingwrite.{h,cpp}`) + `NumpyBuffer`/`ZipFile`
(`numpywrite.{h,cpp}`): serialize finished selfplay rows into sharded .npz
files that the shuffler windows and the trainer streams.

Schema: one npz per shard, keys below. Instead of the reference's bit-packed
feature planes (`binaryInputNCHWPacked`, trainingwrite.cpp:222,371) we store
the *compact game state* and re-derive the 18 feature planes on device at
train time — smaller rows, and training sees exactly what the actor's search
saw. Mapping to the reference row schema (trainingwrite.h:112-197):

  reference                      | here
  -------------------------------+------------------------------------------
  binaryInputNCHWPacked          | board/to_move/recent_spots/recent_dirs
  globalInputNC                  | (re-derived: win_len constant per run)
  policyTargetsNCMove C0         | policy_target (normalized probs, f16)
  policyTargetsNCMove C1         | opponent_policy_target
  globalTargetsNC win/loss/draw  | value_target [N,3]
  globalTargetsNC TD targets ×3  | td_value_targets [N,3,3]
  globalTargetsNC varTimeLeft    | var_time_left
  globalTargetsNC shortterm      | shortterm_value
  globalTargetsNC weights/masks  | weight, opponent_policy_weight
  valueTargetsNCHW C0 ownership  | ownership int8
  valueTargetsNCHW C1-2 futurepos| futurepos int8 [N,2,Y,X]
  valueTargetsNCHW C3 max-line   | line_target int8
  (npz filename randomness)      | same trick — random shard names make
                                 | concurrent writers safe (selfplay.cpp:81-84)

Writes are atomic (tmp file + rename) so the shuffler never sees partial
shards (the reference's shuffler tolerates partial files; we prevent them).
"""

from __future__ import annotations

import os
import secrets
from typing import Iterator

import numpy as np
import torch

from katacoffee_tpu_torch.device import resolve_device
from katacoffee_tpu_torch.game.board import D_NONE, GameState
from katacoffee_tpu_torch.selfplay.actor import TrainingBatch

# v2 adds aux_weight (side-position rows); v1 shards read back with
# aux_weight = 1 for every row
SCHEMA_VERSION = 2
_READABLE_VERSIONS = (1, 2)


def _to_np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def batch_to_arrays(batch: TrainingBatch, cfg) -> dict[str, np.ndarray]:
    """TrainingBatch (tensors on any device, or numpy) -> npz-ready dict of
    numpy arrays. Rows with weight 0 (incomplete episodes) are dropped; the
    kept rows are selected on the batch's device, then each field is copied
    to the host once."""
    w = batch.weight
    keep = torch.nonzero(w > 0.0)[:, 0] if isinstance(w, torch.Tensor) else np.flatnonzero(np.asarray(w) > 0.0)
    st = batch.states

    def k(x, dtype=None):
        a = _to_np(x[keep])
        return a.astype(dtype) if dtype is not None else a

    return {
        "schema_version": np.asarray([SCHEMA_VERSION], np.int32),
        "board_shape": np.asarray([cfg.x_size, cfg.y_size, cfg.win_len], np.int32),
        "board": k(st.board, np.int8),
        "to_move": k(st.to_move, np.int8),
        "recent_spots": k(st.recent_spots, np.int16),
        "recent_dirs": k(st.recent_dirs, np.int8),
        "num_turns": k(st.num_turns, np.int16),
        "policy_target": k(batch.policy_target, np.float16),
        "opponent_policy_target": k(batch.opponent_policy_target, np.float16),
        "value_target": k(batch.value_target, np.float16),
        "td_value_targets": k(batch.td_value_targets, np.float16),
        "ownership": k(batch.ownership_target, np.int8),
        "line_target": k(batch.line_target, np.int8),
        "futurepos": k(batch.futurepos_target, np.int8),
        "var_time_left": k(batch.var_time_left_target, np.float32),
        "shortterm_value": k(batch.shortterm_value_target, np.float32),
        "weight": k(batch.weight, np.float32),
        "opponent_policy_weight": k(batch.opponent_policy_weight, np.float32),
        "aux_weight": k(batch.aux_weight, np.float32),
    }


_ROW_KEYS = [
    "board",
    "to_move",
    "recent_spots",
    "recent_dirs",
    "num_turns",
    "policy_target",
    "opponent_policy_target",
    "value_target",
    "td_value_targets",
    "ownership",
    "line_target",
    "futurepos",
    "var_time_left",
    "shortterm_value",
    "weight",
    "opponent_policy_weight",
    "aux_weight",
]


class TrainingDataWriter:
    """Accumulates rows and writes sharded npz files of at most
    `max_rows_per_file` rows each (the reference's maxRowsPerTrainFile,
    trainingwrite.cpp row sharding), with random shard names."""

    def __init__(self, out_dir: str, cfg, max_rows_per_file: int = 65536):
        self.out_dir = out_dir
        self.cfg = cfg
        self.max_rows = max_rows_per_file
        self.pending: list[dict[str, np.ndarray]] = []
        self.pending_rows = 0
        self.total_rows_written = 0
        os.makedirs(out_dir, exist_ok=True)

    def add_batch(self, batch) -> int:
        arrays = batch_to_arrays(batch, self.cfg)
        n = int(arrays["weight"].shape[0])
        if n == 0:
            return 0
        self.pending.append(arrays)
        self.pending_rows += n
        while self.pending_rows >= self.max_rows:
            self._write_shard(self.max_rows)
        return n

    def flush(self):
        while self.pending_rows > 0:
            self._write_shard(min(self.pending_rows, self.max_rows))

    def _write_shard(self, rows: int):
        merged: dict[str, list] = {kk: [] for kk in _ROW_KEYS}
        meta = None
        left = rows
        while left > 0 and self.pending:
            arrays = self.pending[0]
            meta = meta or {
                "schema_version": arrays["schema_version"],
                "board_shape": arrays["board_shape"],
            }
            n = arrays["weight"].shape[0]
            take = min(n, left)
            for kk in _ROW_KEYS:
                merged[kk].append(arrays[kk][:take])
            if take == n:
                self.pending.pop(0)
            else:
                self.pending[0] = {
                    kk: (arrays[kk][take:] if kk in _ROW_KEYS else arrays[kk])
                    for kk in arrays
                }
            left -= take
            self.pending_rows -= take
        out = {kk: np.concatenate(v, axis=0) for kk, v in merged.items()}
        out.update(meta)
        name = f"data_{secrets.token_hex(8)}.npz"
        tmp = os.path.join(self.out_dir, "." + name + ".tmp")
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **out)
        os.replace(tmp, os.path.join(self.out_dir, name))
        self.total_rows_written += rows


def read_npz_rows(path: str) -> dict[str, np.ndarray]:
    """Load one shard. Returns the raw dict (row keys + meta)."""
    with np.load(path) as z:
        data = {kk: z[kk] for kk in z.files}
    ver = int(data["schema_version"][0])
    if ver not in _READABLE_VERSIONS:
        raise ValueError(f"{path}: schema version {ver} not in {_READABLE_VERSIONS}")
    if "aux_weight" not in data:  # v1 shard
        data["aux_weight"] = np.ones_like(data["weight"])
    return data


def rows_to_batch(data: dict[str, np.ndarray], cfg, device: str | torch.device | None = None) -> TrainingBatch:
    """npz row dict -> TrainingBatch of tensors on `device` (default
    `cuda`), with the port's dtypes. GameState fields not needed for feature
    extraction are reconstructed as neutral values, as in the JAX package."""
    dev = resolve_device(device)

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    n = data["board"].shape[0]
    recent_spots = data["recent_spots"].astype(np.int64)
    recent_dirs = data["recent_dirs"].astype(np.int64)
    states = GameState(
        board=t(data["board"], torch.int8),
        to_move=t(data["to_move"], torch.int8),
        last_spot=t(recent_spots[:, 0], torch.int64),
        last_dir=t(np.where(recent_spots[:, 0] >= 0, recent_dirs[:, 0], D_NONE), torch.int64),
        done=torch.zeros((n,), dtype=torch.bool, device=dev),
        winner=torch.zeros((n,), dtype=torch.int8, device=dev),
        num_turns=t(data["num_turns"], torch.int64),
        recent_spots=t(recent_spots, torch.int64),
        recent_dirs=t(recent_dirs, torch.int64),
        stone_hash=torch.zeros((n, 2), dtype=torch.int64, device=dev),
    )
    f32 = torch.float32
    return TrainingBatch(
        states=states,
        policy_target=t(data["policy_target"], f32),
        opponent_policy_target=t(data["opponent_policy_target"], f32),
        value_target=t(data["value_target"], f32),
        td_value_targets=t(data["td_value_targets"], f32),
        ownership_target=t(data["ownership"], f32),
        line_target=t(data["line_target"], torch.int32),
        futurepos_target=t(data["futurepos"], f32),
        var_time_left_target=t(data["var_time_left"], f32),
        shortterm_value_target=t(data["shortterm_value"], f32),
        weight=t(data["weight"], f32),
        opponent_policy_weight=t(data["opponent_policy_weight"], f32),
        aux_weight=t(data.get("aux_weight", np.ones_like(data["weight"])), f32),
    )


def iter_shards(data_dir: str) -> Iterator[str]:
    for name in sorted(os.listdir(data_dir)):
        if name.endswith(".npz") and not name.startswith("."):
            yield os.path.join(data_dir, name)
