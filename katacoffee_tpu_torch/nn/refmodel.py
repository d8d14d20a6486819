"""Reference ModelDesc (.bin.gz) import and export, and a float32 forward
on `device`, the port of `katacoffee_tpu/nn/refmodel.py`.

The file format and its reader and writer (`_Reader`, the `_parse_*` and
`_emit_*` functions, `parse_ref_model`, `load_ref_model`, `save_ref_model`,
`RefModel`) are plain numpy, copied: the JAX module imports JAX, so the port
keeps its own copy. The parse order is the reference's
`cpp/neuralnet/desc.cpp` (ModelDesc desc.cpp:972-1096; ConvLayerDesc
:110-155 [file order y,x,ic,oc], BatchNormLayerDesc :177-219,
MatMulLayerDesc :274-302 [file order ic,oc], MatBiasLayerDesc :320-337,
block stacks :562-641, TrunkDesc :648-696, PolicyHeadDesc :752-815,
ValueHeadDesc :846-925). The Coffee fork's policy head has one plane per
move direction (p2Conv out = 4, 8 with the optimistic planes from version
12) and the pass head is parsed but unused.

The forward (`ref_forward`) runs in float32 as the JAX one does, in NCHW
with cuDNN convolutions like `CoffeeNet`, mirroring the repaired reference
Eigen backend:
  * conv: SAME zero padding, cross-correlation;
  * batchnorm folded to x*mergedScale+mergedBias, then the activation, then
    hard zeroing outside the board mask (eigenbackend.cpp:684-733); mish as
    Eigen computes it;
  * gpool = [mean, mean*(sqrt(maskSum)-14)*0.1, max over the board] with
    the max floored at -1.0 (poolRowsGPool, eigenbackend.cpp:141-167);
  * value pool = poolRowsValueHead (eigenbackend.cpp:168-186);
  * pre-activation residual, gpool and nested-bottleneck blocks;
  * policy logits dir-major [dir*(Y*X) + y*X + x].

`make_ref_eval_fn` adds the fork's NNEvaluator post-processing
(nneval.cpp:765-812): a TWO-way win/loss softmax (draw 0) and
shorttermWinlossError = softplus(x*0.5)*sqrt(shorttermValueErrorMult).
Its input features replace channels 15-17 by the reference's own
exact-run semantics (`ref_compat_line_features`), an order-dependent loop
over the board's cells, vectorised over the batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import math
from collections.abc import Callable

import numpy as np
import torch
import torch.nn.functional as F

from katacoffee_tpu_torch.game import symmetry as S
from katacoffee_tpu_torch.game.board import NUM_DIRECTIONS, GameConfig, GameState, legal_mask_flat
from katacoffee_tpu_torch.nn.features import extract_features
from katacoffee_tpu_torch.search.mcts import EvalResult, _masked_softmax

ACT_IDENTITY = 0
ACT_RELU = 1
ACT_MISH = 2

_ACT_NAMES = {
    "ACTIVATION_IDENTITY": ACT_IDENTITY,
    "ACTIVATION_RELU": ACT_RELU,
    "ACTIVATION_MISH": ACT_MISH,
}
_ACT_TOKENS = {v: k for k, v in _ACT_NAMES.items()}

ORDINARY_BLOCK = "ordinary_block"
GPOOL_BLOCK = "gpool_block"
NESTED_BLOCK = "nested_bottleneck_block"

# ModelPostProcessParams defaults (desc.cpp:938-947) for file version < 13
DEFAULT_POSTPROCESS = {
    "tdScoreMultiplier": 20.0,
    "scoreMeanMultiplier": 20.0,
    "scoreStdevMultiplier": 20.0,
    "leadMultiplier": 20.0,
    "varianceTimeMultiplier": 40.0,
    "shorttermValueErrorMultiplier": 0.25,
    "shorttermScoreErrorMultiplier": 30.0,
}


class _Reader:
    """Token/binary reader replicating desc.cpp's istream usage: `in >> tok`
    skips whitespace; binary float blocks are '@BIN@' + n*4 little-endian
    bytes (readFloats, desc.cpp:37-92). Plain-text float models (.txt.gz)
    read floats as whitespace tokens instead."""

    def __init__(self, data: bytes, binary_floats: bool):
        self.data = data
        self.pos = 0
        self.binary_floats = binary_floats

    def token(self) -> str:
        d, n = self.data, len(self.data)
        i = self.pos
        while i < n and d[i : i + 1].isspace():
            i += 1
        if i >= n:
            raise ValueError("unexpected end of model file")
        j = i
        while j < n and not d[j : j + 1].isspace():
            j += 1
        self.pos = j
        return d[i:j].decode()

    def int(self) -> int:
        return int(self.token())

    def float(self) -> float:
        return float(self.token())

    def floats(self, n: int) -> np.ndarray:
        if not self.binary_floats:
            return np.array([self.float() for _ in range(n)], np.float32)
        d = self.data
        i = self.pos
        skipped = 0
        while d[i : i + 1] != b"@":
            i += 1
            skipped += 1
            if skipped > 100 or i >= len(d):
                raise ValueError("binary float block header not found")
        if d[i : i + 5] != b"@BIN@":
            raise ValueError("bad binary float block header")
        i += 5
        arr = np.frombuffer(d, dtype="<f4", count=n, offset=i).astype(np.float32)
        self.pos = i + 4 * n
        if not np.isfinite(arr).all():
            raise ValueError("non-finite weight in model file")
        return arr


def _parse_conv(r: _Reader) -> dict:
    name = r.token()
    ky, kx, ic, oc = r.int(), r.int(), r.int(), r.int()
    dy, dx = r.int(), r.int()
    if dy != 1 or dx != 1:
        raise ValueError(f"{name}: dilation unsupported")
    w = r.floats(ky * kx * ic * oc).reshape(ky, kx, ic, oc)  # HWIO directly
    return {"name": name, "w": w}


def _parse_bn(r: _Reader, act: int | None = None) -> dict:
    name = r.token()
    c = r.int()
    eps = r.float()
    has_scale, has_bias = r.int(), r.int()
    mean = r.floats(c)
    var = r.floats(c)
    scale = r.floats(c) if has_scale else np.ones(c, np.float32)
    bias = r.floats(c) if has_bias else np.zeros(c, np.float32)
    # Fold like eigenbackend.cpp:705-710 so the forward is a single FMA
    mscale = scale / np.sqrt(var + eps)
    mbias = bias - mscale * mean
    return {
        "name": name,
        "mean": mean,
        "var": var,
        "scale_raw": scale,
        "bias_raw": bias,
        "eps": eps,
        "has_scale": has_scale,
        "has_bias": has_bias,
        "scale": mscale.astype(np.float32),
        "bias": mbias.astype(np.float32),
    }


def _parse_act(r: _Reader, version: int) -> int:
    r.token()  # name
    if version >= 11:
        return _ACT_NAMES[r.token()]
    return ACT_RELU


def _parse_matmul(r: _Reader) -> dict:
    name = r.token()
    ic, oc = r.int(), r.int()
    w = r.floats(ic * oc).reshape(ic, oc)
    return {"name": name, "w": w}


def _parse_matbias(r: _Reader) -> dict:
    name = r.token()
    c = r.int()
    return {"name": name, "b": r.floats(c)}


def _parse_block_stack(r: _Reader, version: int, num_blocks: int) -> list:
    blocks = []
    for _ in range(num_blocks):
        kind = r.token()
        if kind == ORDINARY_BLOCK:
            b = {"kind": kind, "name": r.token()}
            b["preBN"] = _parse_bn(r)
            b["preAct"] = _parse_act(r, version)
            b["regularConv"] = _parse_conv(r)
            b["midBN"] = _parse_bn(r)
            b["midAct"] = _parse_act(r, version)
            b["finalConv"] = _parse_conv(r)
        elif kind == GPOOL_BLOCK:
            b = {"kind": kind, "name": r.token()}
            b["preBN"] = _parse_bn(r)
            b["preAct"] = _parse_act(r, version)
            b["regularConv"] = _parse_conv(r)
            b["gpoolConv"] = _parse_conv(r)
            b["gpoolBN"] = _parse_bn(r)
            b["gpoolAct"] = _parse_act(r, version)
            b["gpoolToBiasMul"] = _parse_matmul(r)
            b["midBN"] = _parse_bn(r)
            b["midAct"] = _parse_act(r, version)
            b["finalConv"] = _parse_conv(r)
        elif kind == NESTED_BLOCK:
            b = {"kind": kind, "name": r.token()}
            n = r.int()
            b["numBlocks"] = n
            b["preBN"] = _parse_bn(r)
            b["preAct"] = _parse_act(r, version)
            b["preConv"] = _parse_conv(r)
            b["blocks"] = _parse_block_stack(r, version, n)
            b["postBN"] = _parse_bn(r)
            b["postAct"] = _parse_act(r, version)
            b["postConv"] = _parse_conv(r)
        else:
            raise ValueError(f"unknown block kind {kind!r}")
        blocks.append(b)
    return blocks


@dataclasses.dataclass
class RefModel:
    """A parsed reference net: structural metadata + numpy weight tree
    (`ref_forward` runs it)."""

    name: str
    version: int  # file/arch version (desc.cpp); Coffee writes 9
    num_input_channels: int
    num_input_global_channels: int
    post_process: dict
    trunk: dict
    policy_head: dict
    value_head: dict
    # the weights as tensors, by device (`_weights`); not part of the model
    _tensors: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def policy_channels(self) -> int:
        return int(self.policy_head["p2Conv"]["w"].shape[-1])


def parse_ref_model(data: bytes, binary_floats: bool = True) -> RefModel:
    r = _Reader(data, binary_floats)
    name = r.token()
    version = r.int()
    if version < 3:
        raise ValueError(f"model file version {version} too old")
    in_c = r.int()
    in_g = r.int()
    pp = dict(DEFAULT_POSTPROCESS)
    if version >= 13:
        for key in (
            "tdScoreMultiplier",
            "scoreMeanMultiplier",
            "scoreStdevMultiplier",
            "leadMultiplier",
            "varianceTimeMultiplier",
            "shorttermValueErrorMultiplier",
            "shorttermScoreErrorMultiplier",
        ):
            pp[key] = r.float()

    trunk: dict = {"name": r.token()}
    trunk["numBlocks"] = r.int()
    trunk["trunkNumChannels"] = r.int()
    trunk["midNumChannels"] = r.int()
    trunk["regularNumChannels"] = r.int()
    trunk["dilatedNumChannels"] = r.int()  # parsed, unused (desc.cpp:655)
    trunk["gpoolNumChannels"] = r.int()
    trunk["initialConv"] = _parse_conv(r)
    trunk["initialMatMul"] = _parse_matmul(r)
    trunk["blocks"] = _parse_block_stack(r, version, trunk["numBlocks"])
    trunk["tipBN"] = _parse_bn(r)
    trunk["tipAct"] = _parse_act(r, version)

    ph: dict = {"name": r.token()}
    ph["p1Conv"] = _parse_conv(r)
    ph["g1Conv"] = _parse_conv(r)
    ph["g1BN"] = _parse_bn(r)
    ph["g1Act"] = _parse_act(r, version)
    ph["gpoolToBiasMul"] = _parse_matmul(r)
    ph["p1BN"] = _parse_bn(r)
    ph["p1Act"] = _parse_act(r, version)
    ph["p2Conv"] = _parse_conv(r)
    ph["gpoolToPassMul"] = _parse_matmul(r)
    n_pol = ph["p2Conv"]["w"].shape[-1]
    expect = 2 * NUM_DIRECTIONS if version >= 12 else NUM_DIRECTIONS
    if n_pol != expect:
        raise ValueError(
            f"p2Conv out channels {n_pol} != {expect} (Coffee dir-planes, "
            "repaired desc.cpp check)"
        )

    vh: dict = {"name": r.token()}
    vh["v1Conv"] = _parse_conv(r)
    vh["v1BN"] = _parse_bn(r)
    vh["v1Act"] = _parse_act(r, version)
    vh["v2Mul"] = _parse_matmul(r)
    vh["v2Bias"] = _parse_matbias(r)
    vh["v2Act"] = _parse_act(r, version)
    vh["v3Mul"] = _parse_matmul(r)
    vh["v3Bias"] = _parse_matbias(r)
    vh["sv3Mul"] = _parse_matmul(r)
    vh["sv3Bias"] = _parse_matbias(r)
    vh["vOwnershipConv"] = _parse_conv(r)

    return RefModel(
        name=name,
        version=version,
        num_input_channels=in_c,
        num_input_global_channels=in_g,
        post_process=pp,
        trunk=trunk,
        policy_head=ph,
        value_head=vh,
    )


def load_ref_model(path: str) -> RefModel:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    binary = ".bin." in path or path.endswith(".bin") or b"@BIN@" in data[:200000]
    return parse_ref_model(data, binary_floats=binary)


# ---------------------------------------------------------------------------
# Export (.bin.gz writer) — inverse of the parse above
# ---------------------------------------------------------------------------


def _emit_conv(out: list, c: dict):
    w = np.asarray(c["w"], "<f4")
    ky, kx, ic, oc = w.shape
    out.append(f"{c['name']}\n{ky}\n{kx}\n{ic}\n{oc}\n1\n1\n".encode())
    out.append(b"@BIN@" + w.tobytes() + b"\n")


def _emit_bn(out: list, b: dict):
    c = len(b["mean"])
    out.append(
        f"{b['name']}\n{c}\n{b['eps']}\n{int(b['has_scale'])}\n"
        f"{int(b['has_bias'])}\n".encode()
    )
    for key in ("mean", "var"):
        out.append(b"@BIN@" + np.asarray(b[key], "<f4").tobytes() + b"\n")
    if b["has_scale"]:
        out.append(b"@BIN@" + np.asarray(b["scale_raw"], "<f4").tobytes() + b"\n")
    if b["has_bias"]:
        out.append(b"@BIN@" + np.asarray(b["bias_raw"], "<f4").tobytes() + b"\n")


def _emit_act(out: list, version: int, act: int, name: str):
    if version >= 11:
        out.append(f"{name}\n{_ACT_TOKENS[act]}\n".encode())
    else:
        out.append(f"{name}\n".encode())


def _emit_matmul(out: list, m: dict):
    w = np.asarray(m["w"], "<f4")
    ic, oc = w.shape
    out.append(f"{m['name']}\n{ic}\n{oc}\n".encode())
    out.append(b"@BIN@" + w.tobytes() + b"\n")


def _emit_matbias(out: list, m: dict):
    b = np.asarray(m["b"], "<f4")
    out.append(f"{m['name']}\n{len(b)}\n".encode())
    out.append(b"@BIN@" + b.tobytes() + b"\n")


def _emit_blocks(out: list, version: int, blocks: list):
    for b in blocks:
        out.append(f"{b['kind']}\n{b['name']}\n".encode())
        if b["kind"] == ORDINARY_BLOCK:
            _emit_bn(out, b["preBN"])
            _emit_act(out, version, b["preAct"], b["name"] + ".preAct")
            _emit_conv(out, b["regularConv"])
            _emit_bn(out, b["midBN"])
            _emit_act(out, version, b["midAct"], b["name"] + ".midAct")
            _emit_conv(out, b["finalConv"])
        elif b["kind"] == GPOOL_BLOCK:
            _emit_bn(out, b["preBN"])
            _emit_act(out, version, b["preAct"], b["name"] + ".preAct")
            _emit_conv(out, b["regularConv"])
            _emit_conv(out, b["gpoolConv"])
            _emit_bn(out, b["gpoolBN"])
            _emit_act(out, version, b["gpoolAct"], b["name"] + ".gpoolAct")
            _emit_matmul(out, b["gpoolToBiasMul"])
            _emit_bn(out, b["midBN"])
            _emit_act(out, version, b["midAct"], b["name"] + ".midAct")
            _emit_conv(out, b["finalConv"])
        else:
            out.append(f"{b['numBlocks']}\n".encode())
            _emit_bn(out, b["preBN"])
            _emit_act(out, version, b["preAct"], b["name"] + ".preAct")
            _emit_conv(out, b["preConv"])
            _emit_blocks(out, version, b["blocks"])
            _emit_bn(out, b["postBN"])
            _emit_act(out, version, b["postAct"], b["name"] + ".postAct")
            _emit_conv(out, b["postConv"])


def save_ref_model(model: RefModel, path: str):
    """Write back to the reference's .bin.gz format (desc.cpp parse order)."""
    out: list = []
    out.append(f"{model.name}\n{model.version}\n".encode())
    out.append(
        f"{model.num_input_channels}\n{model.num_input_global_channels}\n".encode()
    )
    if model.version >= 13:
        for key in (
            "tdScoreMultiplier",
            "scoreMeanMultiplier",
            "scoreStdevMultiplier",
            "leadMultiplier",
            "varianceTimeMultiplier",
            "shorttermValueErrorMultiplier",
            "shorttermScoreErrorMultiplier",
        ):
            out.append(f"{model.post_process[key]}\n".encode())
    t = model.trunk
    out.append(
        f"{t['name']}\n{t['numBlocks']}\n{t['trunkNumChannels']}\n"
        f"{t['midNumChannels']}\n{t['regularNumChannels']}\n"
        f"{t['dilatedNumChannels']}\n{t['gpoolNumChannels']}\n".encode()
    )
    _emit_conv(out, t["initialConv"])
    _emit_matmul(out, t["initialMatMul"])
    _emit_blocks(out, model.version, t["blocks"])
    _emit_bn(out, t["tipBN"])
    _emit_act(out, model.version, t["tipAct"], t["name"] + ".tipAct")

    ph = model.policy_head
    out.append(f"{ph['name']}\n".encode())
    _emit_conv(out, ph["p1Conv"])
    _emit_conv(out, ph["g1Conv"])
    _emit_bn(out, ph["g1BN"])
    _emit_act(out, model.version, ph["g1Act"], "g1Act")
    _emit_matmul(out, ph["gpoolToBiasMul"])
    _emit_bn(out, ph["p1BN"])
    _emit_act(out, model.version, ph["p1Act"], "p1Act")
    _emit_conv(out, ph["p2Conv"])
    _emit_matmul(out, ph["gpoolToPassMul"])

    vh = model.value_head
    out.append(f"{vh['name']}\n".encode())
    _emit_conv(out, vh["v1Conv"])
    _emit_bn(out, vh["v1BN"])
    _emit_act(out, model.version, vh["v1Act"], "v1Act")
    _emit_matmul(out, vh["v2Mul"])
    _emit_matbias(out, vh["v2Bias"])
    _emit_act(out, model.version, vh["v2Act"], "v2Act")
    _emit_matmul(out, vh["v3Mul"])
    _emit_matbias(out, vh["v3Bias"])
    _emit_matmul(out, vh["sv3Mul"])
    _emit_matbias(out, vh["sv3Bias"])
    _emit_conv(out, vh["vOwnershipConv"])

    data = b"".join(out)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(data)


# ---------------------------------------------------------------------------
# Forward (float32, Eigen-parity)
# ---------------------------------------------------------------------------


def _to_tensors(tree, device: torch.device):
    """The weight tree with every array a float32 tensor on `device`: conv
    weights HWIO -> OIHW, batchnorm scale and bias as [1, C, 1, 1]."""
    if isinstance(tree, list):
        return [_to_tensors(x, device) for x in tree]
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if isinstance(v, np.ndarray):
            t = torch.as_tensor(np.asarray(v, np.float32), device=device)
            if k == "w" and t.dim() == 4:
                t = t.permute(3, 2, 0, 1).contiguous()
            elif k in ("scale", "bias"):
                t = t.reshape(1, -1, 1, 1)
            out[k] = t
        else:
            out[k] = _to_tensors(v, device)
    return out


def _weights(model: RefModel, device: torch.device) -> dict:
    """The model's weights as tensors on `device`, converted once a device."""
    w = model._tensors.get(device)
    if w is None:
        w = model._tensors[device] = _to_tensors(
            {"trunk": model.trunk, "policy_head": model.policy_head, "value_head": model.value_head}, device)
    return w


def _act(x: torch.Tensor, kind: int) -> torch.Tensor:
    if kind == ACT_IDENTITY:
        return x
    if kind == ACT_RELU:
        return torch.relu(x)
    # ACTIVATION_MISH as the Eigen backend computes it (eigenbackend.cpp:729):
    # x * tanh(log1p(exp(min(x,20))) + max(x,20) - 20)
    return x * torch.tanh(torch.log1p(torch.exp(torch.clamp(x, max=20.0))) + torch.clamp(x, min=20.0) - 20.0)


def _bn_act(x, bn: dict, act: int, mask):
    """Folded batchnorm + activation + hard mask (eigenbackend.cpp:714-733).
    x [B,C,H,W], mask [B,1,H,W]."""
    return _act(x * bn["scale"] + bn["bias"], act) * mask


def _conv(x, w):
    """SAME cross-correlation with OIHW weights (odd kernels)."""
    return F.conv2d(x, w, padding=w.shape[-1] // 2)


def _gpool(x, mask, mask_sum):
    """poolRowsGPool (eigenbackend.cpp:141-167): [B,C,H,W] -> [B,3C]
    = concat(mean, mean*(sqrt(n)-14)*0.1, masked max). The max accumulator
    starts at -1.0, so the pooled max is floored there."""
    mean = x.sum(dim=(2, 3)) / mask_sum[:, None]
    sqrtdiv = torch.sqrt(mask_sum)[:, None]
    mx = torch.clamp((x + (mask - 1.0)).amax(dim=(2, 3)), min=-1.0)
    return torch.cat([mean, mean * (sqrtdiv - 14.0) * 0.1, mx], dim=1)


def _vpool(x, mask_sum):
    """poolRowsValueHead (eigenbackend.cpp:168-186)."""
    mean = x.sum(dim=(2, 3)) / mask_sum[:, None]
    s = (torch.sqrt(mask_sum)[:, None] - 14.0) * 0.1
    return torch.cat([mean, mean * s, mean * (s * s - 0.1)], dim=1)


def _apply_blocks(trunk, blocks: list, mask, mask_sum):
    for b in blocks:
        if b["kind"] == ORDINARY_BLOCK:
            h = _bn_act(trunk, b["preBN"], b["preAct"], mask)
            h = _conv(h, b["regularConv"]["w"])
            h = _bn_act(h, b["midBN"], b["midAct"], mask)
            trunk = trunk + _conv(h, b["finalConv"]["w"])
        elif b["kind"] == GPOOL_BLOCK:
            h = _bn_act(trunk, b["preBN"], b["preAct"], mask)
            reg = _conv(h, b["regularConv"]["w"])
            gp = _conv(h, b["gpoolConv"]["w"])
            gp = _bn_act(gp, b["gpoolBN"], b["gpoolAct"], mask)
            bias = _gpool(gp, mask, mask_sum) @ b["gpoolToBiasMul"]["w"]
            reg = _bn_act(reg + bias[:, :, None, None], b["midBN"], b["midAct"], mask)
            trunk = trunk + _conv(reg, b["finalConv"]["w"])
        else:  # nested bottleneck
            h = _bn_act(trunk, b["preBN"], b["preAct"], mask)
            h = _conv(h, b["preConv"]["w"])
            h = _apply_blocks(h, b["blocks"], mask, mask_sum)
            h = _bn_act(h, b["postBN"], b["postAct"], mask)
            trunk = trunk + _conv(h, b["postConv"]["w"])
    return trunk


@contextlib.contextmanager
def _ieee_float32():
    """cuDNN convolutions and CUDA matmuls in full float32 while entered:
    PyTorch runs cuDNN convolutions in TF32 unless told otherwise, which
    parts from the Eigen float32 this forward mirrors by about 1e-3."""
    kept = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = kept


@torch.no_grad()
def ref_forward(model: RefModel, spatial_nchw: torch.Tensor, glob: torch.Tensor) -> dict[str, torch.Tensor]:
    """Full forward on the inputs' device. spatial_nchw [B, C, Y, X]
    (extract_features layout), glob [B, G]. Returns a dict of RAW head
    outputs (logits), pre-postprocessing, in float32: policy_logits
    [B, 4*Y*X] dir-major, value_logits [B,3] (win, loss, draw; draw unused
    by the reference engine), sv [B,6], ownership [B,Y,X], policy_pass
    [B,1-2] (parsed, unused in Coffee). From version 12 the policy channels
    double (plain, optimistic) and optimistic_policy_logits is returned
    too. The convolutions and products run in IEEE float32 whatever the
    caller's TF32 settings (`_ieee_float32`)."""
    with _ieee_float32():
        return _forward(model, spatial_nchw, glob)


def _forward(model: RefModel, spatial_nchw: torch.Tensor, glob: torch.Tensor) -> dict[str, torch.Tensor]:
    x = spatial_nchw.to(torch.float32)
    glob = glob.to(torch.float32)
    w = _weights(model, x.device)
    mask = x[:, :1]  # input channel 0 = on-board (nninputs fillRowV1)
    mask_sum = mask.sum(dim=(1, 2, 3))

    t = w["trunk"]
    trunk = _conv(x, t["initialConv"]["w"]) + (glob @ t["initialMatMul"]["w"])[:, :, None, None]
    trunk = _apply_blocks(trunk, t["blocks"], mask, mask_sum)
    trunk = _bn_act(trunk, t["tipBN"], t["tipAct"], mask)

    ph = w["policy_head"]
    p1 = _conv(trunk, ph["p1Conv"]["w"])
    g1 = _bn_act(_conv(trunk, ph["g1Conv"]["w"]), ph["g1BN"], ph["g1Act"], mask)
    g1pool = _gpool(g1, mask, mask_sum)
    p1 = p1 + (g1pool @ ph["gpoolToBiasMul"]["w"])[:, :, None, None]
    p1 = _bn_act(p1, ph["p1BN"], ph["p1Act"], mask)
    pol = _conv(p1, ph["p2Conv"]["w"])  # [B,4,Y,X] (or 8 from version 12)
    policy_pass = g1pool @ ph["gpoolToPassMul"]["w"]

    B = pol.shape[0]
    opt_logits = None
    if model.version >= 12:
        policy_logits = pol[:, 0::2].reshape(B, -1)
        opt_logits = pol[:, 1::2].reshape(B, -1)
    else:
        policy_logits = pol.reshape(B, -1)

    vh = w["value_head"]
    v1 = _bn_act(_conv(trunk, vh["v1Conv"]["w"]), vh["v1BN"], vh["v1Act"], mask)
    v2 = _act(_vpool(v1, mask_sum) @ vh["v2Mul"]["w"] + vh["v2Bias"]["b"], vh["v2Act"])
    out = {
        "policy_logits": policy_logits,
        "value_logits": v2 @ vh["v3Mul"]["w"] + vh["v3Bias"]["b"],
        "sv": v2 @ vh["sv3Mul"]["w"] + vh["sv3Bias"]["b"],
        "ownership": _conv(v1, vh["vOwnershipConv"]["w"])[:, 0],
        "policy_pass": policy_pass,
    }
    if opt_logits is not None:
        out["optimistic_policy_logits"] = opt_logits
    return out


def ref_compat_line_features(cfg: GameConfig, board: torch.Tensor) -> torch.Tensor:
    """The reference's exact-run feature channels with its ACTUAL semantics
    (repaired Board::fillRowWithLine, board.cpp:392-420), which differ from
    the port's channels 15-17 in two ways an imported reference-trained net
    depends on:

      * FOREACHADJ only iterates N/W/E/S offsets (board.cpp:71-81), so only
        HORIZONTAL and VERTICAL runs are ever scanned;
      * a per-board `visited` set, shared across directions, suppresses
        scans: when a stone initiates (first unvisited stone in y-major
        scan order), its entire h-run AND v-run are marked visited, so any
        stone of those runs never initiates its own scans.

    boards [B, Y, X] -> [B, 3, Y, X] float32 for exact lengths win_len-1,
    win_len-2, win_len-3: the drop-in replacement for extract_features
    channels 15-17 when feeding an imported reference net. The algorithm is
    order-dependent, so the loop over the `area` cells stays; each step is
    a few vector ops over the whole batch."""
    Y, X = cfg.y_size, cfg.x_size
    area = cfg.area
    B = board.shape[0]
    dev = board.device
    stone = board.reshape(B, area) > 0
    cell = torch.arange(area, device=dev)
    same_row = (cell // X)[:, None] == (cell // X)[None, :]  # [area, area]
    same_col = (cell % X)[:, None] == (cell % X)[None, :]

    # segment ids: cells of one row (column) with the same id form a maximal
    # same-value run (boundaries at any value change or row/column start)
    ones = torch.ones((B, Y, 1), dtype=torch.int64, device=dev)
    hseg = torch.cumsum(torch.cat([ones, (board[:, :, 1:] != board[:, :, :-1]).long()], 2).reshape(B, area), 1)
    ones = torch.ones((B, 1, X), dtype=torch.int64, device=dev)
    vbound = torch.cat([ones, (board[:, 1:, :] != board[:, :-1, :]).long()], 1)
    vseg = torch.cumsum(vbound.transpose(1, 2).reshape(B, area), 1).reshape(B, X, Y).transpose(1, 2).reshape(B, area)
    lengths = torch.tensor([cfg.win_len - 1, cfg.win_len - 2, cfg.win_len - 3], device=dev)

    visited = torch.zeros((B, area), dtype=torch.bool, device=dev)
    out = torch.zeros((B, 3, area), dtype=torch.bool, device=dev)
    for i in range(area):
        init = stone[:, i] & ~visited[:, i]  # [B]
        hmask = same_row[i] & (hseg == hseg[:, i:i + 1]) & stone  # [B, area]
        vmask = same_col[i] & (vseg == vseg[:, i:i + 1]) & stone
        visited |= init[:, None] & (hmask | vmask)
        hit = (init[:, None] & (hmask.sum(1)[:, None] == lengths))[:, :, None] & hmask[:, None, :]
        hit |= (init[:, None] & (vmask.sum(1)[:, None] == lengths))[:, :, None] & vmask[:, None, :]
        out |= hit
    return out.to(torch.float32).reshape(B, 3, Y, X)


def ref_compat_features(cfg: GameConfig, state: GameState) -> tuple[torch.Tensor, torch.Tensor]:
    """extract_features with channels 15-17 replaced by the reference's
    actual fillRowWithLine semantics: what an imported reference net was
    trained on, and what the reference binary feeds it."""
    spatial, glob = extract_features(cfg, state)
    return torch.cat([spatial[:, :15], ref_compat_line_features(cfg, state.board)], dim=1), glob


def make_ref_eval_fn(
    cfg: GameConfig,
    model: RefModel,
    symmetry_randomize: bool = False,
    generator: torch.Generator | None = None,
    draw_syms: Callable[[int], torch.Tensor] | None = None,
):
    """EvalFn over the imported reference net on the states' device, with
    the repaired reference engine's post-processing (nneval.cpp:765-812):
    policy = softmax of the dir-major logits over LEGAL moves; value = TWO-way
    softmax over win/loss (the fork's NNOutput has no draw field, so draw is
    0 and utility = P(win)-P(loss) of the player to move); shortterm_error =
    softplus(sv4*0.5)*sqrt(shorttermValueErrorMultiplier).

    `symmetry_randomize` mirrors nnRandomize: a random dihedral symmetry is
    applied to the features and inverted on the policy per evaluation, the
    symmetries [B] from `generator` (on the states' device) or from
    `draw_syms(B)`, as the tests pass the JAX package's."""
    sem = math.sqrt(model.post_process["shorttermValueErrorMultiplier"])
    nsym = S.num_symmetries(cfg)
    if symmetry_randomize and draw_syms is None and generator is None:
        raise ValueError("make_ref_eval_fn: symmetry_randomize needs a generator or draw_syms")

    @torch.no_grad()
    def fn(states: GameState) -> EvalResult:
        spatial, glob = ref_compat_features(cfg, states)
        if symmetry_randomize:
            B = spatial.shape[0]
            syms = (draw_syms(B) if draw_syms is not None else
                    torch.randint(0, nsym, (B,), generator=generator, device=spatial.device)).to(spatial.device)
            spatial = S.apply_features(syms, spatial)
        out = ref_forward(model, spatial, glob)
        logits = out["policy_logits"]
        if symmetry_randomize:
            logits = S.apply_policy(cfg, S.invert(syms), logits)
        # 2-way softmax over win/loss (nneval.cpp:779-787)
        wl2 = torch.softmax(out["value_logits"][:, :2], dim=-1)
        utility = wl2[:, 0] - wl2[:, 1]
        return EvalResult(
            policy=_masked_softmax(logits, legal_mask_flat(cfg, states)),
            utility=utility,
            wl=utility,
            draw=torch.zeros_like(utility),
            shortterm_error=F.softplus(out["sv"][:, 4] * 0.5) * sem,
        )

    return fn
