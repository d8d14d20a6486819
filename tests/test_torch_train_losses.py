"""The port's training losses (`katacoffee_tpu_torch/train/losses.py`) and
history masking (`nn/features.py` `mask_history_state`,
`sample_history_levels`) against the JAX package's, on the CPU.

The JAX loss draws its augmentation from a key: the row symmetries
`jax.random.randint(key, (R,), 0, 8)` and the history depths
`sample_history_levels(fold_in(key, 0x415), R, keep_prob)`. The port takes
those draws as tensors, so the test derives them from the same key and
injects them. Net: b2c16 (a regular and a global-pooling block) with its
trunk in float32 on both sides, the JAX init with noise on every leaf so no
ReZero gate is zero. Tolerance: |d| <= 1e-5 * max(|x|, 1) on every metric
and, per parameter, on every gradient (float32 sums over 48 rows and the
board taken in another order differ by a few ulps; measured 1e-6 at worst).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katacoffee_tpu.dataio import checkpoints as JC
from katacoffee_tpu.dataio import trainingwrite as JW
from katacoffee_tpu.game import board as JB
from katacoffee_tpu.nn import configs as JNC
from katacoffee_tpu.nn import features as JF
from katacoffee_tpu.nn import model as JNM
from katacoffee_tpu.train import losses as JL
from katacoffee_tpu_torch.dataio import checkpoints as TC
from katacoffee_tpu_torch.dataio import trainingwrite as TW
from katacoffee_tpu_torch.game import board as TB
from katacoffee_tpu_torch.nn import configs as TNC
from katacoffee_tpu_torch.nn import features as TF
from katacoffee_tpu_torch.nn import model as TNM
from katacoffee_tpu_torch.train import losses as TL
from torch_parity import one_torch_thread, torch_states, training_rows  # noqa: F401 (autouse fixture)

CFG = JB.GameConfig(5, 5, 4)
TCFG = TB.GameConfig(5, 5, 4)
ROWS = 48
TOL = 1e-5


def close(want, got, what):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    assert want.shape == got.shape, what
    err = float(np.abs(want - got).max(initial=0.0))
    assert err <= TOL * scale, f"{what}: |d| {err} > {TOL} * {scale}"


def noisy_params(model, seed):
    """JAX init_params with noise on every leaf (gates and biases nonzero)."""
    params = JNM.init_params(model, CFG, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: x + rng.normal(0, 0.3 if x.ndim < 2 else 0.05, x.shape).astype(np.float32), params)


@pytest.fixture(scope="module")
def nets():
    jmodel = JNM.CoffeeNet(dataclasses.replace(JNC.get_model_spec("b2c16"), dtype=jnp.float32), win_len=4)
    params = noisy_params(jmodel, 0)
    tmodel = TNM.CoffeeNet(dataclasses.replace(TNC.get_model_spec("b2c16"), dtype=torch.float32), 4)
    tmodel.load_state_dict(TC.params_from_jax(JC._flatten_params(params)))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b, key, keep: JL.compute_losses(CFG, jmodel, p, b, symmetrize_rng=key,
                                                  history_mask_rng=jax.random.fold_in(key, 0x415),
                                                  history_keep_prob=keep), has_aux=True),
        static_argnums=(3,))
    return jmodel, params, tmodel, grad_fn


def jax_draws(key, keep):
    syms = np.array(jax.random.randint(key, (ROWS,), 0, 8))
    levels = np.array(JF.sample_history_levels(jax.random.fold_in(key, 0x415), ROWS, keep))
    return torch.from_numpy(syms), torch.from_numpy(levels)


def test_mask_history_state_is_exact():
    rows = training_rows(CFG, 64, seed=1)
    jstates = JW.rows_to_batch(rows, CFG).states
    levels = np.arange(64) % 6
    want = jax.vmap(JF.mask_history_state)(jstates, jnp.asarray(levels, jnp.int32))
    got = TF.mask_history_state(torch_states(jstates), torch.from_numpy(levels))
    for name, w, g in zip(TB.GameState._fields, want, got):
        assert np.array_equal(np.asarray(w).astype(np.int64), g.numpy().astype(np.int64)), name
    # keep == 0 clears the last move, and with it the legality constraint
    assert (got.last_spot[levels == 0] == -1).all() and (got.last_dir[levels == 0] == TB.D_NONE).all()
    want_f = jax.vmap(lambda s: JF.extract_features(CFG, s))(want)
    got_f = TF.extract_features(TCFG, got)
    for w, g in zip(want_f, got_f):
        assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("keep_prob", [0.98, 0.6, 0.3])
def test_sample_history_levels_from_jax_uniforms(keep_prob):
    rng = jax.random.PRNGKey(5)
    n = 4096
    want = np.asarray(JF.sample_history_levels(rng, n, keep_prob))
    uniforms = torch.from_numpy(np.array(jax.random.uniform(rng, (n, 5))))
    got = TF.sample_history_levels(n, keep_prob, uniforms=uniforms)
    assert np.array_equal(want, got.numpy())
    assert got.min() >= 0 and got.max() <= 5
    # drawn from a generator: depth >= k with probability keep_prob^k
    drawn = TF.sample_history_levels(n, keep_prob, generator=torch.Generator().manual_seed(0))
    for k in (1, 2):
        p = keep_prob**k
        assert abs(float((drawn >= k).float().mean()) - p) <= 4 * np.sqrt(p * (1 - p) / n)
    with pytest.raises(ValueError):
        TF.sample_history_levels(n, keep_prob)


@pytest.mark.parametrize("augment", [True, False], ids=["augmented", "plain"])
def test_compute_losses_metrics_and_gradients_match_jax(nets, augment):
    """Rows with all-zero policy targets and side rows (aux_weight 0) are
    among the 48; with augmentation, syms and levels are the JAX key's."""
    jmodel, params, tmodel, grad_fn = nets
    rows = training_rows(CFG, ROWS, seed=3, zero_policy=0.15, side=0.25)
    assert (rows["policy_target"].astype(np.float32).sum(-1) == 0).any() and (rows["aux_weight"] == 0).any()
    jbatch = JW.rows_to_batch(rows, CFG)
    tbatch = TW.rows_to_batch(rows, TCFG, "cpu")
    if augment:
        key, keep = jax.random.PRNGKey(7), 0.5
        (_, want), jgrads = grad_fn(params, jbatch, key, keep)
        syms, levels = jax_draws(key, keep)
        assert len(set(syms.tolist())) > 4 and len(set(levels.tolist())) > 2
    else:
        (_, want), jgrads = jax.jit(jax.value_and_grad(lambda p, b: JL.compute_losses(CFG, jmodel, p, b),
                                                       has_aux=True))(params, jbatch)
        syms = levels = None
    tmodel.zero_grad(set_to_none=True)
    with torch.enable_grad():  # another test module may turn grad mode off
        loss, got = TL.compute_losses(TCFG, tmodel, tbatch, syms=syms, levels=levels)
        loss.backward()
    assert set(got) == set(want)
    for k in want:
        close(want[k], got[k].detach(), k)
    assert float(want["policy_acc1"]) > 0 or float(want["value_acc1"]) > 0
    want_g = TC.params_from_jax(JC._flatten_params(jgrads))
    for name, p in tmodel.named_parameters():
        assert float(want_g[name].abs().max()) > 0 or "alpha" not in name, name
        close(want_g[name].numpy(), p.grad.numpy(), f"grad {name}")


def test_aux_weight_zero_rows_train_no_aux_head(nets):
    """Side rows alone: the ownership, futurepos, line, var-time and
    shortterm terms are zero, and so is the gradient of the heads that only
    they train."""
    _, _, tmodel, _ = nets
    rows = training_rows(CFG, 16, seed=4, side=1.0)
    batch = TW.rows_to_batch(rows, TCFG, "cpu")
    tmodel.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss, m = TL.compute_losses(TCFG, tmodel, batch)
        loss.backward()
    for k in ("loss_ownership", "loss_futurepos", "loss_line", "loss_var_time", "loss_shortterm_error",
              "loss_optimistic_policy"):
        assert float(m[k].detach()) == 0.0, k
    for name in ("value_head.conv1.weight", "value_head.conv2.weight", "value_head.conv3.weight"):
        assert float(dict(tmodel.named_parameters())[name].grad.abs().max()) == 0.0, name
