"""The port's train step (`katacoffee_tpu_torch/train/train.py`), learning-rate
schedules, optimizer masks, fresh initializer (`nn/model.py` `init_params`)
and replay buffer (`train/replay.py`) against the JAX package's, on the CPU.

The step: three optax steps of JAX `make_train_step` and three of the
port's from one state (b2c16, float32 trunk on both sides, gates and biases
nonzero), with `grad_clip` lowered so that the clip triggers, on new rows
each step, with the JAX key's augmentation draws injected into the port
(`StepDraws`). After each step params, trace, count, EMA, step, grad_norm
and every metric agree within |d| <= 1e-5 * max(|x|, 1) per leaf (the
gradients differ by float32 summation order, ~1e-7 relative measured; the
optimizer's own arithmetic is optax's, op for op).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from katacoffee_tpu.dataio import checkpoints as JC
from katacoffee_tpu.dataio import trainingwrite as JW
from katacoffee_tpu.game import board as JB
from katacoffee_tpu.nn import configs as JNC
from katacoffee_tpu.nn import features as JF
from katacoffee_tpu.nn import model as JNM
from katacoffee_tpu.train import replay as JR
from katacoffee_tpu.train import train as JT
from katacoffee_tpu_torch.dataio import checkpoints as TC
from katacoffee_tpu_torch.dataio import trainingwrite as TW
from katacoffee_tpu_torch.game import board as TB
from katacoffee_tpu_torch.nn import configs as TNC
from katacoffee_tpu_torch.nn import model as TNM
from katacoffee_tpu_torch.train import replay as TR
from katacoffee_tpu_torch.train import train as TT
from torch_parity import one_torch_thread, training_rows  # noqa: F401 (autouse fixture)

CFG = JB.GameConfig(5, 5, 4)
TCFG = TB.GameConfig(5, 5, 4)
ROWS = 32
TOL = 1e-5


def close(want, got, what):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert want.shape == got.shape, what
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    err = float(np.abs(want - got).max(initial=0.0))
    assert err <= TOL * scale, f"{what}: |d| {err} > {TOL} * {scale}"


def jax_tree(state):
    return jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(state))


def f32_net(name):
    jmodel = JNM.CoffeeNet(dataclasses.replace(JNC.get_model_spec(name), dtype=jnp.float32), win_len=4)
    tmodel = TNM.CoffeeNet(dataclasses.replace(TNC.get_model_spec(name), dtype=torch.float32), 4)
    return jmodel, tmodel


@pytest.mark.parametrize("schedule", ["stepwise", "linear"])
def test_three_steps_match_jax(schedule):
    # thresholds at 48, 96, ... samples: the stepwise scale rises at step 3;
    # the linear ramp starts at lr 0
    kw = dict(grad_clip=1.0, lr_schedule=schedule, warmup_samples_scale=ROWS * 1.5 / 1e6, warmup_steps=4,
              history_keep_prob=0.7, learning_rate=0.05)
    jtc, ttc = JT.TrainConfig(**kw), TT.TrainConfig(**kw)
    jmodel, tmodel = f32_net("b2c16")
    jstate = JT.init_train_state(jmodel, CFG, jtc, ROWS, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    jstate = jstate._replace(params=jax.tree_util.tree_map(
        lambda x: x + rng.normal(0, 0.3 if x.ndim < 2 else 0.05, x.shape).astype(np.float32), jstate.params))
    tstate = TC.state_from_tree(jax_tree(jstate), TT.init_train_state(tmodel))
    jstep = JT.make_train_step(jmodel, CFG, jtc, ROWS)
    tstep = TT.make_train_step(TCFG, ttc, ROWS)
    clipped = 0
    for i in range(3):
        rows = training_rows(CFG, ROWS, seed=10 + i)
        key = jax.random.PRNGKey(100 + i)
        draws = TT.StepDraws(torch.from_numpy(np.array(jax.random.randint(key, (ROWS,), 0, 8))),
                             torch.from_numpy(np.array(JF.sample_history_levels(jax.random.fold_in(key, 0x415),
                                                                                ROWS, jtc.history_keep_prob))))
        jstate, want = jstep(jstate, JW.rows_to_batch(rows, CFG), key)
        tstate, got = tstep(tstate, TW.rows_to_batch(rows, TCFG, "cpu"), draws=draws)
        assert set(got) == set(want)
        for k in want:
            close(want[k], got[k].detach(), f"step {i} {k}")
        clipped += float(want["grad_norm"]) >= jtc.grad_clip
        jt, tt = TC.flatten(jax_tree(jstate)), TC.flatten(TC.state_to_tree(tstate))
        assert jt.keys() == tt.keys()
        for k in jt:
            close(jt[k], tt[k], f"step {i} {k}")
        assert tstate.count == tstate.step == i + 1
    assert clipped >= 1


def jax_lr(tc, batch_size, count):
    """The learning rate optax's chain applies at a count: with momentum 0
    a unit gradient on a non-kernel leaf comes out as -lr."""
    opt = JT.make_optimizer(dataclasses.replace(tc, momentum=0.0), batch_size)
    params = {"x": jnp.zeros(())}
    s = opt.init(params)
    s = (s[0], s[1], (s[2][0], s[2][1]._replace(count=jnp.asarray(count, jnp.int32))), s[3])
    u, _ = opt.update({"x": jnp.ones(())}, s, params)
    return -float(u["x"])


@pytest.mark.parametrize("schedule", ["stepwise", "linear"])
@pytest.mark.parametrize("batch_size", [256, 100])
def test_schedules_match_optax(schedule, batch_size):
    tc = dict(lr_schedule=schedule, warmup_samples_scale=0.01, warmup_steps=100, learning_rate=0.02)
    jtc, ttc = JT.TrainConfig(**tc), TT.TrainConfig(**tc)
    counts = [0, 1, 37, 39, 40, 41, 78, 79, 99, 100, 101, 156, 157, 234, 235, 1000, 10**6]
    for c in counts:
        assert TT.scheduled_lr(ttc, batch_size, c) == jax_lr(jtc, batch_size, c), (schedule, batch_size, c)
        assert TT.current_lr(ttc, batch_size, c) == JT.current_lr(jtc, batch_size, c)
    for samples in (0, 999_999, 1_000_000, 3_999_999, 6_000_000, 1e9):
        for scale in (1.0, 0.37):
            assert TT.warmup_scale_at(samples, scale) == JT.warmup_scale_at(samples, scale)
    with pytest.raises(ValueError):
        TT.scheduled_lr(TT.TrainConfig(lr_schedule="cosine"), 256, 0)


@pytest.mark.parametrize("name", ["b6c96", "b10c384nbt"])
def test_decay_and_head_masks_select_jax_leaves(name):
    params = jax.eval_shape(lambda: JNM.init_params(JNM.CoffeeNet(JNC.get_model_spec(name), win_len=4), CFG,
                                                    jax.random.PRNGKey(0)))
    decay = JC._flatten_params(JT._decay_mask(params))
    heads = {"/".join(str(p.key) for p in path): JT._is_output_head(path)
             for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    with torch.device("meta"):
        model = TNM.CoffeeNet(TNC.get_model_spec(name), 4)
    got_decay, got_heads = {}, {}
    for n, p in model.named_parameters():
        key = TC._jax_key(n)
        got_decay[key] = TT.is_decayed(n, p)
        got_heads[key] = TT.is_output_head(n)
    assert got_decay == {k: bool(v) for k, v in decay.items()}
    assert got_heads == heads
    assert any(got_decay.values()) and not all(got_decay.values()) and any(got_heads.values())


def test_replay_buffer_samples_the_same_rows():
    jbuf, tbuf = JR.ReplayBuffer(capacity=96, seed=3), TR.ReplayBuffer(capacity=96, seed=3)
    for i in range(4):
        rows = training_rows(CFG, 40, seed=20 + i)
        rows["weight"][::5] = 0.0  # not added
        assert jbuf.add(JW.rows_to_batch(rows, CFG)) == tbuf.add(TW.rows_to_batch(rows, TCFG, "cpu")) == 32
        assert (jbuf.size, jbuf.head, jbuf.window_size()) == (tbuf.size, tbuf.head, tbuf.window_size())
        want, got = jbuf.sample(24), tbuf.sample(24)
        for w, g in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(tuple(got))):
            assert np.array_equal(np.asarray(w), g), i
    assert tbuf.size == 96 and tbuf.total_added == 128
    with pytest.raises(ValueError):
        TR.ReplayBuffer(8).sample(1)


def test_fresh_init_matches_jax_distributions():
    """Per leaf, pooled over 8 seeds: the std within 10 % of JAX
    init_params', zeros where JAX's are, |x| within the 2-sigma truncation
    of variance_scaling's corrected stddev (b6c96 widths)."""
    jmodel = JNM.CoffeeNet(JNC.get_model_spec("b6c96"), win_len=4)
    init = jax.jit(lambda k: JNM.init_params(jmodel, CFG, k))
    seeds = range(8)
    want = [JC._flatten_params(init(jax.random.PRNGKey(s))) for s in seeds]
    tmodel = TNM.CoffeeNet(TNC.get_model_spec("b6c96"), 4)
    got = []
    for s in seeds:
        TNM.init_params(tmodel, torch.Generator().manual_seed(s))
        got.append(TC.params_to_jax(dict(tmodel.named_parameters())))
    assert want[0].keys() == got[0].keys()
    for k in want[0]:
        w = np.concatenate([x[k].ravel() for x in want])
        g = np.concatenate([x[k].ravel() for x in got])
        if not w.any():
            assert not g.any(), k
            continue
        assert abs(g.std() / w.std() - 1) <= 0.10, (k, g.std(), w.std())
        bound = 2 * w.std() / 0.87962566103423978 * 1.05
        assert np.abs(g).max() <= bound and np.abs(w).max() <= bound, k
    assert not np.array_equal(got[0]["params/Conv_0/Conv_0/kernel"], got[1]["params/Conv_0/Conv_0/kernel"])
