"""validate: an exported model over written training rows, the port of
`katacoffee_tpu/command/validate.py`. `python -m katacoffee_tpu_torch
validate <model_dir> <data_dir ...>` prints one JSON object of the
weight-averaged loss metrics over the rows (no augmentation)."""

from __future__ import annotations

import argparse
import json

import torch

from katacoffee_tpu_torch.command.train import weighted_loss_metrics
from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
from katacoffee_tpu_torch.dataio.trainingwrite import iter_shards
from katacoffee_tpu_torch.device import resolve_device


def main(argv, *, device: str | torch.device | None = None) -> int:
    dev = resolve_device(device)
    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch validate")
    ap.add_argument("model_dir")
    ap.add_argument("data_dirs", nargs="+", help="dirs of .npz training rows")
    ap.add_argument("-max-rows", type=int, default=100000)
    args = ap.parse_args(argv)

    model, cfg, _ = load_exported_model(args.model_dir, dev)
    totals: dict[str, float] = {}
    wsum = 0.0
    rows = 0
    for d in args.data_dirs:
        t, w, n = weighted_loss_metrics(cfg, model, iter_shards(d), dev, args.max_rows - rows)
        for k, v in t.items():
            totals[k] = totals.get(k, 0.0) + v
        wsum += w
        rows += n
        if rows >= args.max_rows:
            break
    if wsum <= 0:
        print(json.dumps({"error": "no rows found"}))
        return 1
    out = {k: (v / wsum if k != "weight_sum" else v) for k, v in totals.items()}
    out["rows"] = rows
    out["model"] = args.model_dir
    print(json.dumps({k: round(v, 6) if isinstance(v, float) else v for k, v in out.items()}))
    return 0
