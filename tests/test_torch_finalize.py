"""The selfplay targets of the PyTorch port against the JAX package:
`per_cell_max_run` bit-exact on random boards, and `finalize_targets` on the
same numpy-built Trajectory through both packages (episodes that end at
varied moves and episodes that do not end, policy-init rows, hint rows with
hintposes_prob > 0, surprise reweighting on and off). Integer fields equal
exactly, floats within 1e-6 absolute, the reweighted `weight` within 1e-5
relative (episode sums in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katacoffee_tpu.game import board as JB
from katacoffee_tpu.selfplay import actor as JA
from katacoffee_tpu_torch.game import board as TB
from katacoffee_tpu_torch.selfplay import actor as TA
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

CFG = JB.GameConfig(5, 5, 4)
TCFG = TB.GameConfig(5, 5, 4)
FLOAT_ATOL = 1e-6
WEIGHT_RTOL = 1e-5


def to_torch(x):
    """A numpy or JAX array as the port holds it (int32 and uint32 as int64)."""
    x = np.asarray(x)
    if x.dtype in (np.int32, np.uint32):
        x = x.astype(np.int64)
    return torch.from_numpy(x.copy())


def torch_traj(jtraj):
    """A JAX Trajectory (or TrainingBatch) as the port's."""
    cls = TA.Trajectory if isinstance(jtraj, JA.Trajectory) else TA.TrainingBatch
    return cls(*(TB.GameState(*(to_torch(f) for f in x)) if isinstance(x, JB.GameState) else to_torch(x)
                 for x in jtraj))


def assert_same_batch(jbatch, tbatch, weight_rtol=WEIGHT_RTOL, atol=FLOAT_ATOL):
    """Every TrainingBatch field: integers equal, floats within `atol`, the
    weights within `weight_rtol` relative."""
    for name in JA.TrainingBatch._fields:
        j, t = getattr(jbatch, name), getattr(tbatch, name)
        if name == "states":
            for sname, a, b in zip(TB.GameState._fields, t, j):
                assert np.array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype)), sname
            continue
        a, b = t.numpy(), np.asarray(j)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if name in ("weight", "opponent_policy_weight"):
            np.testing.assert_allclose(a, b, rtol=weight_rtol, atol=0, err_msg=name)
        elif b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=name)
        else:
            assert np.array_equal(a, b.astype(a.dtype)), name


@pytest.mark.parametrize("shape", [(5, 5, 4), (7, 5, 4), (9, 9, 5)])
def test_per_cell_max_run_matches_jax(shape):
    x, y, win = shape
    rng = np.random.default_rng(x * 100 + y)
    boards = rng.choice(np.array([0, 1, 2], np.int8), size=(64, y, x), p=[0.3, 0.35, 0.35])
    want = np.asarray(jax.vmap(lambda b: JB.per_cell_max_run(JB.GameConfig(x, y, win), b))(jnp.asarray(boards)))
    got = TB.per_cell_max_run(TB.GameConfig(x, y, win), torch.from_numpy(boards))
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    # leading dims [T, B] as finalize_targets passes them
    got2 = TB.per_cell_max_run(TB.GameConfig(x, y, win), torch.from_numpy(boards.reshape(4, 16, y, x)))
    assert np.array_equal(got2.numpy().reshape(want.shape), want)


def _probs(rng, shape, zero_prob):
    p = rng.random(shape).astype(np.float32) * (rng.random(shape) >= zero_prob)
    p[..., 0] += (p.sum(-1) == 0)  # at least one entry
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def numpy_trajectory(seed: int, T: int = 8, B: int = 12) -> JA.Trajectory:
    """A JAX Trajectory of random records whose episodes are consistent:
    episode ids advance after each ended game, games 0 and 1 never end in the
    window, game 2 ends on the last move, the rest end at random moves."""
    rng = np.random.default_rng(seed)
    A = CFG.policy_size
    done = rng.random((T, B)) < 0.3
    done[:, :2] = False
    done[:, 2] = False
    done[-1, 2] = True
    episode = np.zeros((T, B), np.int32)
    episode[0] = rng.integers(0, 5, B)
    for t in range(1, T):
        episode[t] = episode[t - 1] + done[t - 1]
    winner = np.where(done, rng.integers(0, 3, (T, B)), 0).astype(np.int8)
    to_move = rng.integers(1, 3, (T, B)).astype(np.int8)
    pt = _probs(rng, (T, B, A), 0.6)
    raw = _probs(rng, (T, B, A), 0.4)
    raw[0, 0] = np.where(pt[0, 0] > 0, 0.0, raw[0, 0])  # a zero raw prior under the target
    vals = rng.random((T, B, 3)).astype(np.float32) + 1e-3
    hint_first = rng.random((T, B)) < 0.2

    def ints(*shape):
        return np.zeros((T, B) + shape, np.int32)

    states = JB.GameState(
        board=rng.integers(0, 3, (T, B, CFG.y_size, CFG.x_size)).astype(np.int8),
        to_move=to_move, last_spot=rng.integers(-1, CFG.area, (T, B)).astype(np.int32),
        last_dir=rng.integers(0, 5, (T, B)).astype(np.int32), done=np.zeros((T, B), bool),
        winner=np.zeros((T, B), np.int8), num_turns=rng.integers(0, 20, (T, B)).astype(np.int32),
        recent_spots=ints(6) - 1, recent_dirs=ints(6) + 4,
        stone_hash=rng.integers(0, 2**32, (T, B, 2), dtype=np.uint64).astype(np.uint32),
    )
    empty = JB.GameState(*(np.zeros((T, B, 0) + x.shape[2:], x.dtype) for x in states))
    traj = JA.Trajectory(
        states=states,
        policy_target=pt,
        played_action=rng.integers(0, A, (T, B)).astype(np.int32),
        root_wl=rng.uniform(-1, 1, (T, B)).astype(np.float32),
        root_draw=rng.uniform(0, 0.5, (T, B)).astype(np.float32),
        root_visits=np.full((T, B), 33, np.int32),
        done_after=done,
        winner_after=winner,
        final_board=rng.integers(0, 3, (T, B, CFG.y_size, CFG.x_size)).astype(np.int8),
        episode_id=episode,
        raw_policy=raw,
        raw_value=(vals / vals.sum(-1, keepdims=True)).astype(np.float32),
        policy_init=rng.random((T, B)) < 0.2,
        fork_states=states,
        fork_valid=np.zeros((T, B), bool),
        hint_first=hint_first,
        hint_action=np.where(hint_first, rng.integers(0, A, (T, B)), -1).astype(np.int32),
        tree_pos_states=empty,
        tree_pos_policy=np.zeros((T, B, 0, A), np.float32),
        tree_pos_value=np.zeros((T, B, 0, 3), np.float32),
        tree_pos_valid=np.zeros((T, B, 0), bool),
    )
    return jax.tree_util.tree_map(jnp.asarray, traj)


SETTINGS = {
    "default": JA.SelfplaySettings(),
    "no surprise": JA.SelfplaySettings(policy_surprise_weight=0.0, value_surprise_weight=0.0),
    "value surprise only": JA.SelfplaySettings(policy_surprise_weight=0.0, value_surprise_weight=0.3),
    "hint rows": JA.SelfplaySettings(hintposes_prob=0.5),
}


def _port_settings(settings):
    return TA.SelfplaySettings(**dataclasses.asdict(settings))


@pytest.mark.parametrize("name", list(SETTINGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_finalize_targets_matches_jax(name, seed):
    settings = SETTINGS[name]
    jtraj = numpy_trajectory(seed)
    jbatch = jax.jit(lambda tr: JA.finalize_targets(CFG, settings, tr))(jtraj)
    tbatch = TA.finalize_targets(TCFG, _port_settings(settings), torch_traj(jtraj))
    assert_same_batch(jbatch, tbatch)
    w = tbatch.weight.numpy().reshape(jtraj.done_after.shape)
    assert (w[:, :2] == 0).all(), "an unfinished episode kept weight"
    assert (w > 0).any() and (np.asarray(jtraj.policy_init) & (w != 0)).sum() == 0
    if settings.policy_surprise_weight > 0:
        # reweighting moved weight between the rows of some episode
        plain = TA.finalize_targets(TCFG, _port_settings(SETTINGS["no surprise"]), torch_traj(jtraj)).weight
        assert not torch.equal(plain, tbatch.weight)
        assert torch.allclose(plain.sum(), tbatch.weight.sum(), rtol=1e-4)


def test_settings_match_jax():
    """The port's SelfplaySettings has the JAX package's fields and defaults."""
    assert dataclasses.asdict(TA.SelfplaySettings()) == dataclasses.asdict(JA.SelfplaySettings())
    assert TA.SelfplaySettings(num_sims=600).nodes() == 182
