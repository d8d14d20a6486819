"""The JAX package's checkpoints and exported models, with numpy alone.

`katacoffee_tpu/dataio/checkpoints.py` writes two formats, and the port reads
and writes both:
  * exported models: `<dir>/model.npz` (flax parameters flattened to
    "/"-joined keys such as `params/RegularBlock_0/Conv_0/Conv_0/kernel`) and
    `<dir>/model.json` (model name and game config). `params_from_jax` turns
    those keys and layouts into a `CoffeeNet` state dict and `params_to_jax`
    back; `load_exported_model` builds the net, `export_model` writes one;
  * trainer checkpoints: an 8-byte little-endian length, a JSON meta header,
    then flax's msgpack of the JAX TrainState (`dataio/flaxbytes.py`):
    `params` and `ema_params` as `{"params": <flax tree>}`, `opt_state` the
    optax chain's states (`"2"/"0"/"trace"` the nesterov trace,
    `"2"/"1"/"count"` the schedule count), `step` an int32 scalar.
    `save_checkpoint` / `load_checkpoint` map it onto the port's
    `train.train.TrainState`.
Files and model directories are written tmp -> rename.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import time

import numpy as np
import torch

from katacoffee_tpu_torch.dataio import flaxbytes
from katacoffee_tpu_torch.device import resolve_device
from katacoffee_tpu_torch.game.board import GameConfig
from katacoffee_tpu_torch.nn.configs import get_model_spec
from katacoffee_tpu_torch.nn.model import CoffeeNet

_MODULE = re.compile(r"(Conv|Dense|BiasAct)_(\d+)$")
_BLOCK = re.compile(r"(RegularBlock|GPoolBlock|NestedBottleneckBlock)_\d+$")
_HEADS = {"PolicyHead_0": "policy_head", "ValueHead_0": "value_head"}
_FLAX_HEADS = {v: k for k, v in _HEADS.items()}
_TORCH_MODULE = re.compile(r"(conv|linear|act)(\d+)$")
_FLAX_KIND = {"conv": "Conv", "linear": "Dense", "act": "BiasAct"}


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


def _jax_key(name: str) -> str:
    """The flax key of a CoffeeNet state-dict name (inverse of `_torch_key`):
    convs outside the heads sit in a `Conv` wrapper holding one `Conv_0`."""
    *mods, leaf = name.split(".")
    out = ["params"]
    in_head = False
    for p in mods:
        if p == "blocks":
            continue
        if p in _FLAX_HEADS:
            out.append(_FLAX_HEADS[p])
            in_head = True
        elif _BLOCK.match(p):
            out.append(p)
        elif m := _TORCH_MODULE.match(p):
            kind, idx = m.groups()
            out.append(f"{_FLAX_KIND[kind]}_{idx}")
            if kind == "conv" and not in_head:
                out.append("Conv_0")
        else:
            raise ValueError(f"unexpected parameter name {name!r}")
    if leaf == "weight":
        leaf = "kernel"
    elif m := re.fullmatch(r"alpha_inner(\d+)", leaf):
        leaf = f"alpha_inner_{m.group(1)}"
    elif leaf not in ("bias", "alpha"):
        raise ValueError(f"unexpected parameter name {name!r}")
    return "/".join(out + [leaf])


def params_to_jax(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Flattened flax parameters from a CoffeeNet state dict, the exact
    inverse of `params_from_jax`: conv kernels [cout, cin, kh, kw] -> [kh,
    kw, cin, cout], dense kernels [out, in] -> [in, out], float32 numpy."""
    flat = {}
    for name, t in state.items():
        t = t.detach().to("cpu", torch.float32)
        if name.endswith(".weight"):
            t = t.permute(2, 3, 1, 0) if t.dim() == 4 else t.T
        flat[_jax_key(name)] = t.contiguous().numpy().copy()
    return flat


def nest(flat: dict[str, np.ndarray]) -> dict:
    """"/"-joined keys -> nested dicts, keys sorted at every level as JAX's
    tree functions leave flax's trees (and as flax writes them)."""
    tree: dict = {}
    for key in sorted(flat, key=lambda k: k.split("/")):
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    return tree


def flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts -> "/"-joined keys (the inverse of `nest`)."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(flatten(v, key))
        else:
            flat[key] = v
    return flat


# ---------------------------------------------------------------------------
# Trainer checkpoints
# ---------------------------------------------------------------------------


def state_to_tree(state) -> dict:
    """flax's state dict of the JAX TrainState holding `state` (a
    `train.train.TrainState`)."""
    return {
        "params": nest(params_to_jax(dict(state.model.named_parameters()))),
        "opt_state": {
            "0": {},  # clip_by_global_norm
            "1": {"inner_state": {}},  # masked add_decayed_weights
            "2": {"0": {"trace": nest(params_to_jax(state.trace))},
                  "1": {"count": np.asarray(state.count, np.int32)}},
            "3": {},  # the output heads' scale
        },
        "ema_params": nest(params_to_jax(state.ema)),
        "step": np.asarray(state.step, np.int32),
    }


def _write(path: str, meta: dict, blob: bytes) -> None:
    head = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        f.write(blob)


def write_raw(path: str, meta: dict, blob: bytes) -> None:
    """The checkpoint file: length, JSON meta, blob; written tmp -> rename."""
    _write(path + ".tmp", meta, blob)
    os.replace(path + ".tmp", path)


def read_raw(path: str) -> tuple[dict, bytes]:
    """(meta, msgpack blob) of a checkpoint file."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(n).decode())
        return meta, f.read()


def save_checkpoint(path: str, state, extra: dict | None = None) -> None:
    """Write `state` (a `train.train.TrainState`) as the JAX package's
    checkpoint, which its `load_checkpoint` reads (JAX checkpoints.py:36).
    The previous file is rotated to `<path>.prev`."""
    blob = flaxbytes.encode(state_to_tree(state))
    meta = dict(extra or {})
    meta["save_time"] = time.time()
    _write(path + ".tmp", meta, blob)
    if os.path.exists(path):
        os.replace(path, path + ".prev")
    os.replace(path + ".tmp", path)


def _tensors(flat_jax: dict, like: dict[str, torch.Tensor], what: str) -> dict[str, torch.Tensor]:
    state = params_from_jax(flat_jax)
    if state.keys() != like.keys():
        raise ValueError(f"checkpoint {what} do not match the model: missing {sorted(like.keys() - state.keys())}, "
                         f"unexpected {sorted(state.keys() - like.keys())}")
    for k, t in state.items():
        if t.shape != like[k].shape:
            raise ValueError(f"checkpoint {what} {k}: shape {tuple(t.shape)} != {tuple(like[k].shape)}")
    return {k: t.to(like[k].device) for k, t in state.items()}


def state_from_tree(tree: dict, template):
    """`template` (a `train.train.TrainState`, e.g. from `init_train_state`,
    whose model gives the structure and device) filled in place from flax's
    state dict of a JAX TrainState: parameters, trace, EMA, count, step."""
    params = dict(template.model.named_parameters())
    with torch.no_grad():
        for k, t in _tensors(flatten(tree["params"]), params, "params").items():
            params[k].copy_(t)
        opt = tree["opt_state"]["2"]
        template.trace = _tensors(flatten(opt["0"]["trace"]), params, "trace")
        template.ema = _tensors(flatten(tree["ema_params"]), params, "ema_params")
    template.count = int(opt["1"]["count"])
    template.step = int(tree["step"])
    return template


def load_checkpoint(path: str, template):
    """Returns (state, meta): `template` filled in place from the checkpoint
    (`state_from_tree`; JAX checkpoints.py:52)."""
    meta, blob = read_raw(path)
    return state_from_tree(flaxbytes.decode(blob), template), meta


# ---------------------------------------------------------------------------
# Exported models
# ---------------------------------------------------------------------------


def export_model(models_dir: str, name: str, params: dict[str, torch.Tensor], model_name: str, cfg,
                 extra: dict | None = None) -> str:
    """Write `<models_dir>/<name>/{model.npz, model.json}` atomically from a
    CoffeeNet state dict, as the JAX package's `export_model` does
    (checkpoints.py:76). Returns the model dir."""
    final = os.path.join(models_dir, name)
    tmp = os.path.join(models_dir, f".tmp_{name}_{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "model.npz"), **flatten(nest(params_to_jax(params))))
    meta = {
        "name": name,
        "model": model_name,
        # loaders reject models from a different inputs era
        "model_version": 1,
        "inputs_version": 1,
        "x_size": cfg.x_size,
        "y_size": cfg.y_size,
        "win_len": cfg.win_len,
        "export_time": time.time(),
    }
    meta.update(extra or {})
    with open(os.path.join(tmp, "model.json"), "w") as f:
        json.dump(meta, f, indent=2)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


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
