"""Checkpoint surgery on the JAX package's trainer checkpoints, the port of
`katacoffee_tpu/command/checkpoint.py`, on the port's msgpack codec.

Actions:
  dump    print the meta header and a parameter-tree summary as JSON
  edit    overwrite meta header fields in place, e.g. -set train_step=0
  export  write the EMA (or raw) params as an exported model dir, the
          release artifact that selfplay loads
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from katacoffee_tpu_torch.dataio import flaxbytes
from katacoffee_tpu_torch.dataio.checkpoints import export_model, load_checkpoint, read_raw, write_raw
from katacoffee_tpu_torch.device import resolve_device
from katacoffee_tpu_torch.game.board import GameConfig
from katacoffee_tpu_torch.nn.configs import get_model_spec
from katacoffee_tpu_torch.nn.model import CoffeeNet
from katacoffee_tpu_torch.train.train import init_train_state


def _tree_summary(tree, prefix: str = "") -> tuple[list[str], int]:
    """(lines, total elements) over a decoded tree."""
    lines: list[str] = []
    total = 0
    if isinstance(tree, dict):
        for k in sorted(tree):
            sub, n = _tree_summary(tree[k], f"{prefix}/{k}" if prefix else str(k))
            lines.extend(sub)
            total += n
    elif hasattr(tree, "shape"):
        arr = np.asarray(tree)
        lines.append(f"{prefix}: {arr.dtype} {list(arr.shape)}")
        total += int(arr.size)
    else:
        lines.append(f"{prefix}: {tree!r}")
    return lines, total


def main_dump(args: argparse.Namespace) -> int:
    meta, blob = read_raw(args.checkpoint)
    state = flaxbytes.decode(blob)
    out: dict = {"meta": meta}
    for field in state if isinstance(state, dict) else {}:
        lines, total = _tree_summary(state[field])
        out[field] = {"num_elements": total}
        if args.shapes:
            out[field]["leaves"] = lines
    text = json.dumps(out, indent=2, default=str)
    if args.out_json:
        with open(args.out_json, "w") as f:
            f.write(text)
        print(f"dumped {args.checkpoint} -> {args.out_json}")
    else:
        print(text)
    return 0


def main_edit(args: argparse.Namespace) -> int:
    meta, blob = read_raw(args.checkpoint)
    for kv in args.set or []:
        if "=" not in kv:
            raise SystemExit(f"-set expects key=value, got {kv!r}")
        k, v = kv.split("=", 1)
        try:
            meta[k] = json.loads(v)
        except json.JSONDecodeError:
            meta[k] = v
        print(f"set {k} = {meta[k]!r}")
    write_raw(args.checkpoint, meta, blob)
    print(f"updated {args.checkpoint}")
    return 0


def main_export(args: argparse.Namespace, device: str | torch.device | None = None) -> int:
    dev = resolve_device(device)
    cfg = GameConfig(args.x_size, args.y_size, args.win_len)
    model = CoffeeNet(get_model_spec(args.model), win_len=cfg.win_len).to(dev)
    state, meta = load_checkpoint(args.checkpoint, init_train_state(model))
    params = dict(state.model.named_parameters()) if args.raw_params else state.ema
    step = int(meta.get("train_step", state.step))
    out = export_model(args.out_dir, args.name or f"export-s{step}", params, args.model, cfg,
                       extra={"train_step": step, "from_checkpoint": os.path.abspath(args.checkpoint)})
    print(f"exported {'raw' if args.raw_params else 'EMA'} params -> {out}")
    return 0


def main(argv: list[str], *, device: str | torch.device | None = None) -> int:
    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch checkpoint")
    sub = ap.add_subparsers(dest="action", required=True)

    d = sub.add_parser("dump", help="print meta + parameter summary as JSON")
    d.add_argument("-checkpoint", required=True)
    d.add_argument("-out-json", default=None)
    d.add_argument("-shapes", action="store_true", help="list every leaf shape")

    e = sub.add_parser("edit", help="overwrite meta header fields in place")
    e.add_argument("-checkpoint", required=True)
    e.add_argument("-set", action="append", metavar="key=value")

    x = sub.add_parser("export", help="export ckpt params as a model dir")
    x.add_argument("-checkpoint", required=True)
    x.add_argument("-model", required=True, help="model spec name, e.g. b6c96")
    x.add_argument("-out-dir", required=True)
    x.add_argument("-name", default=None)
    x.add_argument("-x-size", type=int, default=5)
    x.add_argument("-y-size", type=int, default=5)
    x.add_argument("-win-len", type=int, default=4)
    x.add_argument("-raw-params", action="store_true", help="export raw instead of EMA params")

    args = ap.parse_args(argv)
    if args.action == "export":
        return main_export(args, device)
    return {"dump": main_dump, "edit": main_edit}[args.action](args)
