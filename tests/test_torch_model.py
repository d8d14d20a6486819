"""Parity of the PyTorch CoffeeNet (`katacoffee_tpu_torch.nn.model`) and its
numpy-only weight bridge (`katacoffee_tpu_torch.dataio.checkpoints`) with the
flax model: both sides in float32 on the same inputs, every head within
1e-4 (fp32 rounding differences only; a layout or mapping mistake moves
logits by orders of magnitude more)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katacoffee_tpu.dataio.checkpoints import _flatten_params
from katacoffee_tpu.dataio.checkpoints import load_exported_model as jax_load
from katacoffee_tpu.game.board import GameConfig
from katacoffee_tpu.nn.model import CoffeeNet as JaxNet
from katacoffee_tpu.nn.model import ModelSpec as JaxSpec
from katacoffee_tpu.nn.model import init_params
from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model, params_from_jax
from katacoffee_tpu_torch.nn.model import CoffeeNet, ModelSpec
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

torch.set_grad_enabled(False)

CFG = GameConfig(5, 5, 4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {
    "tinynet": os.path.join(ROOT, "tests/goldens/tinynet"),
    "run-s5200": os.path.join(ROOT, "artifacts/flagship_b6c96/models/run-s5200"),
}
ATOL = 1e-4


def _inputs(batch, seed):
    rng = np.random.default_rng(seed)
    spatial = (rng.random((batch, 18, 5, 5)) < 0.3).astype(np.float32)
    spatial[:, 0] = 1.0
    glob = np.full((batch, 1), 4.0, np.float32)
    return spatial, glob


def _assert_heads_close(jax_out, torch_out, atol):
    assert set(jax_out) == set(torch_out)
    for k in sorted(jax_out):
        a = np.asarray(jax_out[k], np.float32)
        b = torch_out[k].float().numpy()
        assert a.shape == b.shape, k
        np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_exported_model_matches_flax_fp32(name):
    model, params, _, _ = jax_load(MODELS[name])
    jnet = JaxNet(dataclasses.replace(model.spec, dtype=jnp.float32), win_len=CFG.win_len)
    tnet, cfg, meta = load_exported_model(MODELS[name], device="cpu", dtype=torch.float32)
    assert cfg == tuple(CFG) and meta["model"] == model.spec.name
    spatial, glob = _inputs(8, seed=1)
    _assert_heads_close(
        jnet.apply(params, jnp.asarray(spatial), jnp.asarray(glob)),
        tnet(torch.from_numpy(spatial), torch.from_numpy(glob)),
        ATOL,
    )


def test_bridge_from_live_params_all_block_kinds():
    """params_from_jax on `_flatten_params` of randomized live flax params,
    with every block kind (regular, gpool, nested bottleneck)."""
    fields = dict(
        name="tiny-bridge", trunk_channels=16, mid_channels=8, gpool_channels=8,
        blocks=("regular", "gpool", "nbt", "regular"), p1_channels=8, g1_channels=8,
        v1_channels=8, v2_size=12,
    )
    jnet = JaxNet(JaxSpec(**fields, dtype=jnp.float32), win_len=CFG.win_len)
    params = init_params(jnet, CFG, jax.random.PRNGKey(7))
    rng = np.random.default_rng(11)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    leaves = [jnp.asarray(0.3 * rng.standard_normal(l.shape), jnp.float32) for l in leaves]
    params = jax.tree_util.tree_unflatten(treedef, leaves)

    tnet = CoffeeNet(ModelSpec(**fields, dtype=torch.float32), win_len=CFG.win_len)
    tnet.load_state_dict(params_from_jax(_flatten_params(params)), strict=True)
    spatial, glob = _inputs(4, seed=2)
    glob = glob + np.random.default_rng(3).standard_normal(glob.shape).astype(np.float32)
    _assert_heads_close(
        jnet.apply(params, jnp.asarray(spatial), jnp.asarray(glob)),
        tnet(torch.from_numpy(spatial), torch.from_numpy(glob)),
        ATOL,
    )


def test_bridge_rejects_unknown_keys():
    with pytest.raises(ValueError):
        params_from_jax({"params/Mystery_0/kernel": np.zeros((2, 2), np.float32)})


def test_bf16_trunk_tracks_flax_bf16():
    """The default dtype policy: bf16 trunk, fp32 heads, as in the flax
    model. The two frameworks round bf16 at different places, so this holds
    them to the size of the bf16 effect itself, the tolerance chip_smoke.py
    uses for the card's bf16 net against the CPU's float32 net."""
    model, params, _, _ = jax_load(MODELS["run-s5200"])
    tnet, _, _ = load_exported_model(MODELS["run-s5200"], device="cpu")
    assert tnet.spec.dtype == torch.bfloat16
    spatial, glob = _inputs(8, seed=4)
    out = tnet(torch.from_numpy(spatial), torch.from_numpy(glob))
    assert all(v.dtype == torch.float32 for v in out.values())
    _assert_heads_close(model.apply(params, jnp.asarray(spatial), jnp.asarray(glob)), out, 0.25)
