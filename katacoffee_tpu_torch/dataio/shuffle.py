"""Shuffler: power-law training window over selfplay npz shards. The
port's numpy-only copy of `katacoffee_tpu/dataio/shuffle.py`: the same
window, permutation and chunk files from the same shards and seed.

Ports the *policy* of the reference's `python/shuffle.py` (per SURVEY.md §7
stage 5), not its multiprocessing file mechanics:

  * window size over run rows N follows the reference's exact power law
    (shuffle.py:556-574): with taper offset t (default = min_rows), exponent e,
    expand-per-row r, the window is
        min_rows + r * ((x**e - t**e) / (e * t**(e-1))),  x = N - min_rows + t
    clamped to [min_rows, N]; defaults e=0.65, r=0.4 match the recommended
    ongoing-selfplay settings (shuffle.py:317-318).
  * the most recent `window` rows across all shards are shuffled and at most
    `keep_target_rows` of them written out in fixed-row chunks for the
    trainer (shuffle.py:324).

At Coffee scale (5×5 board, tiny rows) the whole window fits in host RAM, so
the output is a single in-memory permutation materialized to chunk files.
"""

from __future__ import annotations

import os
import secrets

import numpy as np

from katacoffee_tpu_torch.dataio.trainingwrite import _ROW_KEYS, iter_shards, read_npz_rows


def compute_window_size(
    total_rows: int,
    min_rows: int = 250_000,
    expand_window_per_row: float = 0.4,
    taper_window_exponent: float = 0.65,
    taper_window_scale: float | None = None,
) -> int:
    """The reference's window power law (shuffle.py:556-574)."""
    if total_rows <= min_rows:
        return total_rows
    t = taper_window_scale if taper_window_scale is not None else float(min_rows)
    e = taper_window_exponent
    x = float(total_rows - min_rows) + t
    unscaled = x**e - t**e
    scaled = unscaled / (e * t ** (e - 1.0))
    window = int(min_rows + expand_window_per_row * scaled)
    return max(min_rows, min(window, total_rows))


def shuffle_data(
    data_dirs: list[str],
    out_dir: str,
    min_rows: int = 250_000,
    expand_window_per_row: float = 0.4,
    taper_window_exponent: float = 0.65,
    keep_target_rows: int | None = None,
    chunk_rows: int = 65536,
    seed: int | None = None,
    add_to_data_rows: int = 0,
    val_prop: float = 0.0,
) -> dict:
    """Shuffle the most recent window of rows from `data_dirs` into chunk
    files under `out_dir`. With val_prop > 0, that fraction of the shuffled
    rows is held out into `<out_dir>/val/` for validation metrics (the
    reference shuffler's train/val split). Returns summary stats."""
    shards: list[tuple[float, str, int]] = []  # (mtime, path, rows)
    total = 0
    for d in data_dirs:
        if not os.path.isdir(d):
            continue
        for path in iter_shards(d):
            with np.load(path) as z:
                n = int(z["weight"].shape[0])
            shards.append((os.path.getmtime(path), path, n))
            total += n
    shards.sort()  # oldest first

    window = compute_window_size(
        total + add_to_data_rows,
        min_rows=min_rows,
        expand_window_per_row=expand_window_per_row,
        taper_window_exponent=taper_window_exponent,
    )
    window = min(window, total)

    # take the newest `window` rows (newest shards last)
    chosen: list[tuple[str, int, int]] = []  # (path, start_row, rows)
    need = window
    for _, path, n in reversed(shards):
        if need <= 0:
            break
        take = min(n, need)
        chosen.append((path, n - take, take))
        need -= take

    cols: dict[str, list[np.ndarray]] = {k: [] for k in _ROW_KEYS}
    meta = None
    for path, start, take in chosen:
        data = read_npz_rows(path)
        meta = meta or {
            "schema_version": data["schema_version"],
            "board_shape": data["board_shape"],
        }
        for k in _ROW_KEYS:
            cols[k].append(data[k][start : start + take])

    os.makedirs(out_dir, exist_ok=True)
    if meta is None:
        return {"total_rows": 0, "window": 0, "rows_out": 0, "chunks": 0}

    merged = {k: np.concatenate(v, axis=0) for k, v in cols.items()}
    n = merged["weight"].shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    if keep_target_rows is not None and keep_target_rows < n:
        perm = perm[:keep_target_rows]
    merged = {k: v[perm] for k, v in merged.items()}
    n_out = perm.shape[0]

    n_val = int(n_out * val_prop)
    run_id = secrets.token_hex(6)

    def write_chunks(dest: str, lo: int, hi: int) -> int:
        os.makedirs(dest, exist_ok=True)
        count = 0
        for start in range(lo, hi, chunk_rows):
            out = {k: v[start : min(start + chunk_rows, hi)] for k, v in merged.items()}
            out.update(meta)
            name = f"shuffled_{run_id}_{count:05d}.npz"
            tmp = os.path.join(dest, "." + name + ".tmp")
            with open(tmp, "wb") as f:
                np.savez_compressed(f, **out)
            os.replace(tmp, os.path.join(dest, name))
            count += 1
        return count

    chunks = write_chunks(out_dir, n_val, n_out)
    val_chunks = write_chunks(os.path.join(out_dir, "val"), 0, n_val) if n_val else 0

    return {
        "total_rows": total,
        "window": window,
        "rows_out": n_out - n_val,
        "val_rows": n_val,
        "chunks": chunks,
        "val_chunks": val_chunks,
    }
