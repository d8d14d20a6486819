"""CoffeeNet in PyTorch: the port of `katacoffee_tpu/nn/model.py`.

The same KataGo-style conv ResNet, in NCHW:
  * a trunk computed in `ModelSpec.dtype` (bfloat16 by default, float32 when
    asked) with float32 parameters cast at use, and float32 heads;
  * no batch norm: every residual branch is gated by a learnable scalar
    `alpha` (ReZero);
  * regular, global-pooling and nested-bottleneck blocks;
  * global pooling = concat(mean, mean*bscale, max), bscale =
    (sqrt(HW) - 14) / 10;
  * policy logits per (direction, spot), flattened dir-major; value head
    with win/loss/draw logits, TD values, misc outputs, ownership, future
    positions and longest-line logits.

Submodules and parameters are named after the flax modules they mirror
(`Conv_i` -> `conv{i}`, `Dense_i` -> `linear{i}`, `BiasAct_i` -> `act{i}`,
blocks keep their flax names), so the weight bridge in
`dataio/checkpoints.py` maps an exported model key by key.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    trunk_channels: int
    mid_channels: int
    gpool_channels: int
    blocks: tuple  # tuple of 'regular' | 'gpool' | 'nbt'
    p1_channels: int
    g1_channels: int
    v1_channels: int
    v2_size: int
    num_policy_outputs: int = 3  # policy, opponent, optimistic
    activation: str = "mish"
    # compute dtype for the trunk; heads always run fp32
    dtype: torch.dtype = torch.bfloat16


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


_ACTIVATIONS = {"mish": mish, "relu": F.relu, "identity": lambda x: x}


def global_pool(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, 3C]: mean, mean*bscale, max (KataGPool)."""
    _, _, h, w = x.shape
    mean = x.mean(dim=(2, 3))
    bscale = torch.tensor((math.sqrt(h * w) - 14.0) / 10.0, dtype=torch.float32).to(x.dtype)
    return torch.cat([mean, mean * bscale.to(x.device), x.amax(dim=(2, 3))], dim=1)


class Conv(nn.Conv2d):
    """Bias-free conv with SAME padding, computed in its input's dtype."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__(cin, cout, kernel, padding=kernel // 2, bias=False)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), padding=self.padding)


class Dense(nn.Linear):
    """Linear layer computed in its input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class BiasAct(nn.Module):
    def __init__(self, channels: int, activation: str):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))
        self.act = _ACTIVATIONS[activation]

    def forward(self, x):
        b = self.bias.to(x.dtype)
        if x.dim() == 4:
            b = b[None, :, None, None]
        return self.act(x + b)


def _gate(alpha: nn.Parameter, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return x + alpha.to(x.dtype) * h


class RegularBlock(nn.Module):
    """Pre-activation residual block with ReZero gate."""

    def __init__(self, s: ModelSpec):
        super().__init__()
        self.act0 = BiasAct(s.trunk_channels, s.activation)
        self.conv0 = Conv(s.trunk_channels, s.mid_channels, 3)
        self.act1 = BiasAct(s.mid_channels, s.activation)
        self.conv1 = Conv(s.mid_channels, s.trunk_channels, 3)
        self.alpha = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        h = self.conv1(self.act1(self.conv0(self.act0(x))))
        return _gate(self.alpha, x, h)


class GPoolBlock(nn.Module):
    """Residual block whose pooled gpool channels bias its mid channels."""

    def __init__(self, s: ModelSpec):
        super().__init__()
        self.act0 = BiasAct(s.trunk_channels, s.activation)
        self.conv0 = Conv(s.trunk_channels, s.mid_channels, 3)
        self.conv1 = Conv(s.trunk_channels, s.gpool_channels, 3)
        self.act1 = BiasAct(s.gpool_channels, s.activation)
        self.linear0 = Dense(3 * s.gpool_channels, s.mid_channels, bias=False)
        self.act2 = BiasAct(s.mid_channels, s.activation)
        self.conv2 = Conv(s.mid_channels, s.trunk_channels, 3)
        self.alpha = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        h = self.act0(x)
        hr = self.conv0(h)
        hg = self.act1(self.conv1(h))
        hr = hr + self.linear0(global_pool(hg))[:, :, None, None]
        hr = self.conv2(self.act2(hr))
        return _gate(self.alpha, x, hr)


class NestedBottleneckBlock(nn.Module):
    """1x1 down -> two inner residual 3x3 blocks -> 1x1 up."""

    def __init__(self, s: ModelSpec):
        super().__init__()
        self.act0 = BiasAct(s.trunk_channels, s.activation)
        self.conv0 = Conv(s.trunk_channels, s.mid_channels, 1)
        for i in range(1, 5):
            setattr(self, f"act{i}", BiasAct(s.mid_channels, s.activation))
            setattr(self, f"conv{i}", Conv(s.mid_channels, s.mid_channels, 3))
        self.alpha_inner0 = nn.Parameter(torch.zeros(()))
        self.alpha_inner1 = nn.Parameter(torch.zeros(()))
        self.act5 = BiasAct(s.mid_channels, s.activation)
        self.conv5 = Conv(s.mid_channels, s.trunk_channels, 1)
        self.alpha = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        h = self.conv0(self.act0(x))
        for i, alpha in enumerate((self.alpha_inner0, self.alpha_inner1)):
            k = 1 + 2 * i
            hh = getattr(self, f"conv{k}")(getattr(self, f"act{k}")(h))
            hh = getattr(self, f"conv{k + 1}")(getattr(self, f"act{k + 1}")(hh))
            h = _gate(alpha, h, hh)
        h = self.conv5(self.act5(h))
        return _gate(self.alpha, x, h)


_BLOCKS = {
    "regular": ("RegularBlock", RegularBlock),
    "gpool": ("GPoolBlock", GPoolBlock),
    "nbt": ("NestedBottleneckBlock", NestedBottleneckBlock),
}


class PolicyHead(nn.Module):
    def __init__(self, s: ModelSpec):
        super().__init__()
        self.num_outputs = s.num_policy_outputs
        self.conv0 = Conv(s.trunk_channels, s.p1_channels, 1)
        self.conv1 = Conv(s.trunk_channels, s.g1_channels, 1)
        self.act0 = BiasAct(s.g1_channels, s.activation)
        self.linear0 = Dense(3 * s.g1_channels, s.p1_channels, bias=False)
        self.act1 = BiasAct(s.p1_channels, s.activation)
        self.conv2 = Conv(s.p1_channels, s.num_policy_outputs * 4, 1)

    def forward(self, trunk):
        x = trunk.to(torch.float32)
        p = self.conv0(x)
        g = self.act0(self.conv1(x))
        p = p + self.linear0(global_pool(g))[:, :, None, None]
        p = self.conv2(self.act1(p))
        b, _, h, w = p.shape
        # channel index is (output, direction) row-major: flat dir-major policy
        return p.reshape(b, self.num_outputs, 4 * h * w)


class ValueHead(nn.Module):
    def __init__(self, s: ModelSpec, win_len: int):
        super().__init__()
        self.act = _ACTIVATIONS[s.activation]
        self.conv0 = Conv(s.trunk_channels, s.v1_channels, 1)
        self.act0 = BiasAct(s.v1_channels, s.activation)
        self.linear0 = Dense(3 * s.v1_channels, s.v2_size)
        self.linear1 = Dense(s.v2_size, 3)
        self.linear2 = Dense(s.v2_size, 9)
        self.linear3 = Dense(s.v2_size, 2)
        self.conv1 = Conv(s.v1_channels, 1, 1)
        self.conv2 = Conv(s.trunk_channels, 2, 1)
        self.conv3 = Conv(s.v1_channels, win_len + 1, 1)

    def forward(self, trunk):
        x = trunk.to(torch.float32)
        v1 = self.act0(self.conv0(x))
        v2 = self.act(self.linear0(global_pool(v1)))
        misc = self.linear3(v2)
        return {
            "value_logits": self.linear1(v2),
            "td_value_logits": self.linear2(v2).reshape(-1, 3, 3),
            "var_time_left": torch.square(F.softplus(misc[:, 0])) * 2.0,
            "shortterm_error": torch.square(F.softplus(misc[:, 1])) * 0.25,
            "ownership": self.conv1(v1)[:, 0],
            "futurepos": self.conv2(x),
            "line_logits": self.conv3(v1),
        }


class CoffeeNet(nn.Module):
    """Full model: 18 spatial + 1 global input planes from
    `katacoffee_tpu_torch.nn.features`, NCHW, to a dict of head outputs."""

    def __init__(self, spec: ModelSpec, win_len: int = 4):
        super().__init__()
        from katacoffee_tpu_torch.nn.features import NUM_FEATURES_GLOBAL, NUM_FEATURES_SPATIAL

        s = spec
        self.spec = spec
        self.conv0 = Conv(NUM_FEATURES_SPATIAL, s.trunk_channels, 3)
        self.linear0 = Dense(NUM_FEATURES_GLOBAL, s.trunk_channels, bias=False)
        counts = {kind: 0 for kind in _BLOCKS}
        blocks = {}
        for kind in s.blocks:
            name, cls = _BLOCKS[kind]
            blocks[f"{name}_{counts[kind]}"] = cls(s)
            counts[kind] += 1
        self.blocks = nn.ModuleDict(blocks)
        self.act0 = BiasAct(s.trunk_channels, s.activation)
        self.policy_head = PolicyHead(s)
        self.value_head = ValueHead(s, win_len)

    def forward(self, spatial, glob):
        dtype = self.spec.dtype
        x = self.conv0(spatial.to(dtype))
        x = x + self.linear0(glob.to(torch.float32).to(dtype))[:, :, None, None]
        for block in self.blocks.values():
            x = block(x)
        x = self.act0(x)
        policy = self.policy_head(x)
        out = self.value_head(x)
        out["policy_logits"] = policy[:, 0]
        out["opponent_policy_logits"] = policy[:, 1]
        out["optimistic_policy_logits"] = policy[:, 2]
        return out


# variance_scaling scales that JAX model.py:195-243 names; every other conv and
# dense kernel takes flax's default lecun_normal (scale 1)
_INIT_SCALES = {
    "policy_head.conv2.weight": 0.09,
    "value_head.linear1.weight": 0.09,
    "value_head.linear2.weight": 0.09,
    "value_head.conv1.weight": 0.04,
    "value_head.conv2.weight": 0.04,
    "value_head.conv3.weight": 0.04,
}
# flax's truncated_normal variance_scaling divides the stddev by the std of a
# unit normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def init_params(model: CoffeeNet, generator: torch.Generator) -> CoffeeNet:
    """Fresh weights for a run with no checkpoint, in place, with the
    distributions of JAX `init_params` (model.py:289; threefry's values
    cannot be reproduced): every conv and dense kernel a truncated normal
    within 2 stddevs, variance_scaling(scale, "fan_in") with the scale of
    `_INIT_SCALES` or 1 (lecun_normal); biases and the ReZero gates `alpha`
    and `alpha_inner*` zero. Draws come from `generator`, on the model's
    device."""
    for name, p in model.named_parameters():
        if not name.endswith(".weight"):
            p.zero_()
            continue
        fan_in = p[0].numel()  # [out, in, kh, kw] or [out, in]
        std = math.sqrt(_INIT_SCALES.get(name, 1.0) / fan_in) / _TRUNCATED_STD
        nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std, generator=generator)
    return model

