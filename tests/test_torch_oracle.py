"""Tier-4 per-layer numerics oracle: an independently written PyTorch (CPU,
NCHW, fp32) forward pass consuming the SAME flax params must reproduce
CoffeeNet's outputs.

Role of the reference's per-layer backend tests (`nninterface.h:127-169`
testEvaluateConv/BatchNorm/ResidualBlock/GPoolBlock vs the Eigen CPU
reference, run by `runnnlayertests`) and of `runtinynntests`: every layout
choice (NHWC vs NCHW, SAME padding, kernel transposition), the KataGPool
semantics (mean / mean*bscale / max concat order), the ReZero residual
gating, and both head reshapes are pinned against a second implementation
that shares no code with the flax model.

Tolerance is fp32-tight (1e-4 abs): both sides run fp32 on CPU; drift
beyond that means a real semantics mismatch, not rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from katacoffee_tpu.game.board import GameConfig
from katacoffee_tpu.nn.features import NUM_FEATURES_GLOBAL, NUM_FEATURES_SPATIAL
from katacoffee_tpu.nn.model import CoffeeNet, ModelSpec, init_params
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

torch.set_grad_enabled(False)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _conv_w(flax_conv_params) -> torch.Tensor:
    """flax nn.Conv kernel [kh, kw, cin, cout] -> torch [cout, cin, kh, kw]."""
    return _t(flax_conv_params["Conv_0"]["kernel"]).permute(3, 2, 0, 1)


def _raw_conv_w(kernel) -> torch.Tensor:
    return _t(kernel).permute(3, 2, 0, 1)


def _mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def _bias_act(p, x: torch.Tensor) -> torch.Tensor:
    """BiasAct on NCHW (bias over channel dim)."""
    b = _t(p["bias"])
    if x.dim() == 4:
        b = b[None, :, None, None]
    return _mish(x + b)


def _gpool(x: torch.Tensor) -> torch.Tensor:
    """KataGPool on NCHW [B,C,H,W] -> [B,3C] (mean, mean*bscale, max)."""
    b, c, h, w = x.shape
    mean = x.mean(dim=(2, 3))
    bscale = (np.sqrt(float(h * w)) - 14.0) / 10.0
    mx = x.amax(dim=(2, 3))
    return torch.cat([mean, mean * bscale, mx], dim=1)


def _dense(p, x: torch.Tensor) -> torch.Tensor:
    """flax nn.Dense kernel [in, out] (+ optional bias)."""
    y = x @ _t(p["kernel"])
    if "bias" in p:
        y = y + _t(p["bias"])
    return y


def _conv3(p, x: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    return F.conv2d(x, _conv_w(p), padding=kernel // 2)


def _regular_block(p, x):
    h = _bias_act(p["BiasAct_0"], x)
    h = _conv3(p["Conv_0"], h)
    h = _bias_act(p["BiasAct_1"], h)
    h = _conv3(p["Conv_1"], h)
    return x + float(np.asarray(p["alpha"])) * h


def _gpool_block(p, x):
    h = _bias_act(p["BiasAct_0"], x)
    hr = _conv3(p["Conv_0"], h)
    hg = _conv3(p["Conv_1"], h)
    hg = _bias_act(p["BiasAct_1"], hg)
    pooled = _gpool(hg)
    bias = _dense(p["Dense_0"], pooled)
    hr = hr + bias[:, :, None, None]
    hr = _bias_act(p["BiasAct_2"], hr)
    hr = _conv3(p["Conv_2"], hr)
    return x + float(np.asarray(p["alpha"])) * hr


def _nbt_block(p, x):
    h = _bias_act(p["BiasAct_0"], x)
    h = F.conv2d(h, _conv_w(p["Conv_0"]))  # 1x1 down
    for i in range(2):
        hh = _bias_act(p[f"BiasAct_{1 + 2 * i}"], h)
        hh = _conv3(p[f"Conv_{1 + 2 * i}"], hh)
        hh = _bias_act(p[f"BiasAct_{2 + 2 * i}"], hh)
        hh = _conv3(p[f"Conv_{2 + 2 * i}"], hh)
        h = h + float(np.asarray(p[f"alpha_inner_{i}"])) * hh
    h = _bias_act(p["BiasAct_5"], h)
    h = F.conv2d(h, _conv_w(p["Conv_5"]))  # 1x1 up
    return x + float(np.asarray(p["alpha"])) * h


def _policy_head(p, trunk, n_out):
    x = trunk
    pc = F.conv2d(x, _raw_conv_w(p["Conv_0"]["kernel"]))
    g = F.conv2d(x, _raw_conv_w(p["Conv_1"]["kernel"]))
    g = _bias_act(p["BiasAct_0"], g)
    pooled = _gpool(g)
    pc = pc + _dense(p["Dense_0"], pooled)[:, :, None, None]
    pc = _bias_act(p["BiasAct_1"], pc)
    pc = F.conv2d(pc, _raw_conv_w(p["Conv_2"]["kernel"]))
    b, c, h, w = pc.shape
    # NCHW channel c == flax NHWC channel index (n_out, dir) row-major
    return pc.reshape(b, n_out, 4, h, w).reshape(b, n_out, 4 * h * w)


def _value_head(p, trunk, win_len):
    v1 = F.conv2d(trunk, _raw_conv_w(p["Conv_0"]["kernel"]))
    v1 = _bias_act(p["BiasAct_0"], v1)
    pooled = _gpool(v1)
    v2 = _mish(_dense(p["Dense_0"], pooled))
    value_logits = _dense(p["Dense_1"], v2)
    td = _dense(p["Dense_2"], v2).reshape(-1, 3, 3)
    misc = _dense(p["Dense_3"], v2)
    var_time_left = torch.square(F.softplus(misc[:, 0])) * 2.0
    shortterm = torch.square(F.softplus(misc[:, 1])) * 0.25
    ownership = F.conv2d(v1, _raw_conv_w(p["Conv_1"]["kernel"]))[:, 0]
    futurepos = F.conv2d(trunk, _raw_conv_w(p["Conv_2"]["kernel"]))
    line_logits = F.conv2d(v1, _raw_conv_w(p["Conv_3"]["kernel"]))
    return {
        "value_logits": value_logits,
        "td_value_logits": td,
        "var_time_left": var_time_left,
        "shortterm_error": shortterm,
        "ownership": ownership,
        "futurepos": futurepos,
        "line_logits": line_logits,
    }


def torch_forward(params, spec: ModelSpec, win_len: int, spatial, glob):
    """Independent NCHW/fp32 CoffeeNet forward from the flax param tree."""
    p = params["params"]
    x = _t(spatial)  # already NCHW
    x = _conv3(p["Conv_0"], x)
    gb = _dense(p["Dense_0"], _t(glob))
    x = x + gb[:, :, None, None]
    counters = {"regular": 0, "gpool": 0, "nbt": 0}
    impls = {"regular": _regular_block, "gpool": _gpool_block, "nbt": _nbt_block}
    names = {"regular": "RegularBlock", "gpool": "GPoolBlock", "nbt": "NestedBottleneckBlock"}
    for kind in spec.blocks:
        x = impls[kind](p[f"{names[kind]}_{counters[kind]}"], x)
        counters[kind] += 1
    x = _bias_act(p["BiasAct_0"], x)
    pol = _policy_head(p["PolicyHead_0"], x, spec.num_policy_outputs)
    out = _value_head(p["ValueHead_0"], x, win_len)
    out["policy_logits"] = pol[:, 0]
    out["opponent_policy_logits"] = pol[:, 1]
    out["optimistic_policy_logits"] = pol[:, 2]
    return out


SPEC = ModelSpec(
    name="tiny-oracle",
    trunk_channels=16,
    mid_channels=16,
    gpool_channels=8,
    blocks=("regular", "gpool", "nbt", "regular"),
    p1_channels=8,
    g1_channels=8,
    v1_channels=8,
    v2_size=12,
    dtype=jnp.float32,  # fp32 so the comparison is numerics, not bf16 rounding
)


@pytest.fixture(scope="module")
def model_and_params():
    cfg = GameConfig(5, 5, 4)
    model = CoffeeNet(spec=SPEC, win_len=cfg.win_len)
    params = init_params(model, cfg, jax.random.PRNGKey(7))
    # init leaves ReZero alphas and biases at 0 — randomize EVERY param so
    # the comparison exercises each weight, then rebuild the pytree
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(11), len(leaves))
    leaves = [
        0.3 * jax.random.normal(k, l.shape, jnp.float32) for k, l in zip(keys, leaves)
    ]
    return cfg, model, jax.tree_util.tree_unflatten(treedef, leaves)


def test_torch_oracle_matches_flax_forward(model_and_params):
    cfg, model, params = model_and_params
    rng = np.random.default_rng(3)
    spatial = rng.standard_normal((4, NUM_FEATURES_SPATIAL, cfg.y_size, cfg.x_size))
    spatial = spatial.astype(np.float32)
    glob = rng.standard_normal((4, NUM_FEATURES_GLOBAL)).astype(np.float32)

    ours = model.apply(params, jnp.asarray(spatial), jnp.asarray(glob))
    oracle = torch_forward(params, SPEC, cfg.win_len, spatial, glob)

    assert set(ours) == set(oracle)
    for k in sorted(ours):
        a = np.asarray(ours[k], dtype=np.float32)
        b = oracle[k].numpy()
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=k)


def test_torch_oracle_catches_layout_mistakes(model_and_params):
    """Sanity that the oracle has teeth: transposing the first conv kernel's
    spatial axes must break the match (SAME-padding 3x3 kernels are not
    symmetric under this flip for random weights)."""
    cfg, model, params = model_and_params
    rng = np.random.default_rng(4)
    spatial = rng.standard_normal((2, NUM_FEATURES_SPATIAL, cfg.y_size, cfg.x_size))
    spatial = spatial.astype(np.float32)
    glob = rng.standard_normal((2, NUM_FEATURES_GLOBAL)).astype(np.float32)

    bad = jax.tree_util.tree_map(lambda x: x, params)  # shallow copy of tree
    k = bad["params"]["Conv_0"]["Conv_0"]["kernel"]
    import flax

    bad = flax.core.unfreeze(bad) if hasattr(flax.core, "unfreeze") else bad
    bad["params"]["Conv_0"]["Conv_0"]["kernel"] = jnp.transpose(k, (1, 0, 2, 3))

    ours = model.apply(bad, jnp.asarray(spatial), jnp.asarray(glob))
    oracle = torch_forward(params, SPEC, cfg.win_len, spatial, glob)
    diff = np.abs(np.asarray(ours["policy_logits"]) - oracle["policy_logits"].numpy())
    assert diff.max() > 1e-2
