"""Parity of the PyTorch feature encoder (`katacoffee_tpu_torch.nn.features`)
with the JAX one: the same random games on both sides, the 18 spatial planes
and the global feature equal exactly at every ply."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katacoffee_tpu.game import board as JB
from katacoffee_tpu.game import jitted
from katacoffee_tpu.nn.features import extract_features as jax_features
from katacoffee_tpu_torch.game import board as TB
from katacoffee_tpu_torch.nn.features import (
    NUM_FEATURES_GLOBAL,
    NUM_FEATURES_SPATIAL,
    extract_features,
)
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

CFG = JB.GameConfig(5, 5, 4)
TCFG = TB.GameConfig(5, 5, 4)


@functools.lru_cache(maxsize=None)
def _vfeatures():
    return jax.jit(jax.vmap(functools.partial(jax_features, CFG)))


@pytest.mark.parametrize("seed", [0, 1])
def test_features_match_jax_along_random_games(seed):
    B = 16
    vstep = jitted.vstep_fn(CFG)
    vlegal = jitted.vlegal_mask_flat_fn(CFG)
    rng = np.random.default_rng(seed)
    js = jax.vmap(lambda _: JB.init_state(CFG))(jnp.arange(B))
    ts = TB.init_state(TCFG, B, "cpu")
    for ply in range(CFG.area + 1):
        j_sp, j_gl = _vfeatures()(js)
        t_sp, t_gl = extract_features(TCFG, ts)
        assert t_sp.shape == (B, NUM_FEATURES_SPATIAL, 5, 5)
        assert t_gl.shape == (B, NUM_FEATURES_GLOBAL)
        assert t_sp.dtype == torch.float32 and t_gl.dtype == torch.float32
        assert np.array_equal(t_sp.numpy(), np.asarray(j_sp)), ply
        assert np.array_equal(t_gl.numpy(), np.asarray(j_gl)), ply
        if bool(np.asarray(js.done).all()):
            break
        legal = np.asarray(vlegal(js))
        action = (rng.random(legal.shape) * legal).argmax(-1)
        js = vstep(js, jnp.asarray(action, jnp.int32))
        ts = TB.step(TCFG, ts, torch.from_numpy(action))
