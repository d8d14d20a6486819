"""Parity of the PyTorch rules (`katacoffee_tpu_torch.game.board`) with the
JAX rules: random rollouts at B=32 played to the end, the same actions fed to
both, every GameState field, legal mask and both hash words equal bit for
bit after every ply."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katacoffee_tpu.game import board as JB
from katacoffee_tpu.game import jitted
from katacoffee_tpu_torch.game import board as TB
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

CFG = JB.GameConfig(5, 5, 4)
TCFG = TB.GameConfig(5, 5, 4)
B = 32


@functools.lru_cache(maxsize=None)
def _jax_fns():
    return (
        jax.jit(jax.vmap(functools.partial(JB.situation_hash, CFG))),
        jax.jit(jax.vmap(functools.partial(JB.run_lengths, CFG))),
        jax.jit(jax.vmap(lambda b: jnp.stack([JB.exact_run_mask(CFG, b, L) for L in (1, 2, 3)]))),
        jax.jit(jax.vmap(functools.partial(JB.line_empty_counts, CFG))),
    )


def _assert_same_state(js, ts, ply):
    for name, j in js._asdict().items():
        t = getattr(ts, name).numpy()
        j = np.asarray(j)
        assert t.shape == j.shape, (ply, name)
        assert np.array_equal(t, j.astype(np.int64) if j.dtype == np.uint32 else j), (ply, name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rollouts_match_jax(seed):
    vhash, vruns, vexact, vcounts = _jax_fns()
    vstep = jitted.vstep_fn(CFG)
    vlegal = jitted.vlegal_mask_flat_fn(CFG)
    rng = np.random.default_rng(seed)
    js = jax.vmap(lambda _: JB.init_state(CFG))(jnp.arange(B))
    ts = TB.init_state(TCFG, B, "cpu")
    _assert_same_state(js, ts, -1)
    for ply in range(CFG.area + 1):
        legal = np.asarray(vlegal(js))
        assert np.array_equal(TB.legal_mask_flat(TCFG, ts).numpy(), legal), ply
        assert np.array_equal(np.asarray(vhash(js)).astype(np.int64), TB.situation_hash(TCFG, ts).numpy()), ply
        assert np.array_equal(np.asarray(vruns(js.board)), TB.run_lengths(TCFG, ts.board).numpy()), ply
        assert np.array_equal(np.asarray(vcounts(js.board)), TB.line_empty_counts(TCFG, ts.board).numpy()), ply
        exact = np.stack([TB.exact_run_mask(TCFG, ts.board, L).numpy() for L in (1, 2, 3)], axis=1)
        assert np.array_equal(np.asarray(vexact(js.board)), exact), ply
        if bool(np.asarray(js.done).all()):
            break
        action = (rng.random(legal.shape) * legal).argmax(-1)
        js = vstep(js, jnp.asarray(action, jnp.int32))
        ts = TB.step(TCFG, ts, torch.from_numpy(action))
        _assert_same_state(js, ts, ply)
    assert ts.done.all()
    # wins and draws both occur in random 5x5 play
    assert (ts.winner != 0).any()


def test_hash_words_stay_below_2_pow_32():
    ts = TB.init_state(TCFG, 4, "cpu")
    rng = np.random.default_rng(5)
    for _ in range(6):
        legal = TB.legal_mask_flat(TCFG, ts).numpy()
        ts = TB.step(TCFG, ts, torch.from_numpy((rng.random(legal.shape) * legal).argmax(-1)))
        for h in (ts.stone_hash, TB.situation_hash(TCFG, ts)):
            assert ((h >= 0) & (h < 2**32)).all()
