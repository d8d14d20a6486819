"""Loading models exported by the JAX package, with numpy alone.

`katacoffee_tpu/dataio/checkpoints.py` `export_model` writes
`<dir>/model.npz` (flax parameters flattened to "/"-joined keys such as
`params/RegularBlock_0/Conv_0/Conv_0/kernel`) and `<dir>/model.json` (model
name and game config). `params_from_jax` turns those keys and layouts into a
`CoffeeNet` state dict; `load_exported_model` builds the net from a model
directory.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import numpy as np
import torch

from katacoffee_tpu_torch.device import resolve_device
from katacoffee_tpu_torch.game.board import GameConfig
from katacoffee_tpu_torch.nn.configs import get_model_spec
from katacoffee_tpu_torch.nn.model import CoffeeNet

_MODULE = re.compile(r"(Conv|Dense|BiasAct)_(\d+)$")
_BLOCK = re.compile(r"(RegularBlock|GPoolBlock|NestedBottleneckBlock)_\d+$")
_HEADS = {"PolicyHead_0": "policy_head", "ValueHead_0": "value_head"}


def _torch_key(key: str) -> str:
    parts = key.split("/")
    if parts[0] != "params":
        raise ValueError(f"unexpected weight key {key!r}")
    out = []
    i = 1
    while i < len(parts) - 1:
        p = parts[i]
        if p in _HEADS:
            out.append(_HEADS[p])
        elif _BLOCK.match(p):
            out += ["blocks", p]
        elif m := _MODULE.match(p):
            kind, idx = m.groups()
            out.append({"Conv": "conv", "Dense": "linear", "BiasAct": "act"}[kind] + idx)
            # the trunk's Conv wrapper holds one flax nn.Conv named Conv_0
            if kind == "Conv" and i + 1 < len(parts) - 1 and parts[i + 1] == "Conv_0":
                i += 1
        else:
            raise ValueError(f"unexpected weight key {key!r}")
        i += 1
    leaf = parts[-1]
    if leaf == "kernel":
        leaf = "weight"
    elif m := re.fullmatch(r"alpha_inner_(\d+)", leaf):
        leaf = f"alpha_inner{m.group(1)}"
    elif leaf not in ("bias", "alpha"):
        raise ValueError(f"unexpected weight key {key!r}")
    return ".".join(out + [leaf])


def params_from_jax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """CoffeeNet state dict from flattened flax parameters: conv kernels
    [kh, kw, cin, cout] -> [cout, cin, kh, kw], dense kernels [in, out] ->
    [out, in], everything else as it is, all float32."""
    state = {}
    for key, arr in flat.items():
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if key.endswith("/kernel"):
            t = t.permute(3, 2, 0, 1) if t.dim() == 4 else t.T
        state[_torch_key(key)] = t.contiguous()
    return state


def load_exported_model(
    model_dir: str,
    device: str | torch.device | None = None,
    dtype: torch.dtype | None = None,
):
    """Returns (model, cfg, meta) for an exported model directory, the model
    on `device` (default `cuda`) in eval mode. `dtype` overrides the trunk's
    compute dtype (e.g. torch.float32 for parity runs)."""
    dev = resolve_device(device)
    with open(os.path.join(model_dir, "model.json")) as f:
        meta = json.load(f)
    iv = meta.get("inputs_version", 1)
    if iv != 1:
        raise ValueError(f"{model_dir}: inputs_version {iv} unsupported (V1 features only)")
    cfg = GameConfig(meta["x_size"], meta["y_size"], meta["win_len"])
    spec = get_model_spec(meta["model"])
    if dtype is not None:
        spec = dataclasses.replace(spec, dtype=dtype)
    model = CoffeeNet(spec, win_len=cfg.win_len)
    with np.load(os.path.join(model_dir, "model.npz")) as z:
        flat = {k: z[k] for k in z.files}
    model.load_state_dict(params_from_jax(flat), strict=True)
    return model.to(dev).eval(), cfg, meta


def is_complete_model_dir(d: str) -> bool:
    return os.path.isfile(os.path.join(d, "model.npz")) and os.path.isfile(os.path.join(d, "model.json"))


def find_latest_model(models_dir: str) -> str | None:
    """The newest complete model directory under `models_dir` by its
    `export_time` (the mtime of model.npz where that is missing or 0), or
    None, the "random" sentinel (loadmodel.cpp semantics). The port of
    `katacoffee_tpu/dataio/checkpoints.py` `find_latest_model`."""
    if not os.path.isdir(models_dir):
        return None
    best, best_t = None, -1.0
    for name in os.listdir(models_dir):
        d = os.path.join(models_dir, name)
        if name.startswith(".") or not os.path.isdir(d) or not is_complete_model_dir(d):
            continue
        try:
            with open(os.path.join(d, "model.json")) as f:
                t = float(json.load(f).get("export_time", 0.0))
        except (json.JSONDecodeError, OSError):
            continue
        if t <= 0.0:
            t = os.path.getmtime(os.path.join(d, "model.npz"))
        if t > best_t:
            best, best_t = d, t
    return best
