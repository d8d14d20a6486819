"""The rest of the PyTorch selfplay actor against the JAX package: the
side-position fork move, whole-game forking (`choose_fork_moves`,
`extract_fork_candidates`, `refill_pool`), and a segment with every branch
on (side positions, tree records, start and hint pools, a fork pool), then
`run_side_segment` and the rows of the recorded tree positions
(`record_tree_positions` alone: tests/test_torch_treerecord.py). Tinynet at
float32 on both sides; every draw of the port is derived from the JAX key
chain (tests/test_torch_selfplay_segment.py). Integer fields and states
equal exactly; floats as in that file."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katacoffee_tpu.game import jitted
from katacoffee_tpu.selfplay import actor as JA
from katacoffee_tpu.selfplay import forking as JF
from katacoffee_tpu.selfplay import treerecord as JT
from katacoffee_tpu_torch.selfplay import actor as TA
from katacoffee_tpu_torch.selfplay import forking as TF
from katacoffee_tpu_torch.selfplay import treerecord as TT
from test_torch_finalize import assert_same_batch, numpy_trajectory, to_torch, torch_traj
from test_torch_search import CFG, TCFG, TINYNET, _evals
from test_torch_selfplay_segment import (
    JSP,
    TSP,
    assert_same_states,
    assert_same_trajectory,
    fork_move_draws,
    gamma_table,
    jax_trajectory,
    late_positions,
    port_settings,
    run_both,
    t,
)
from torch_parity import one_torch_thread, recorded_gamma, symmetry_draws, torch_states  # noqa: F401

A = CFG.policy_size


def _random_policy(rng, batch, zero_rows=2):
    p = rng.random((batch, A)).astype(np.float32) * (rng.random((batch, A)) < 0.15)
    p[:zero_rows] = 0.0
    p[zero_rows, :] = 0.0
    p[zero_rows, 7] = 0.3  # one legal move, which is banned below
    s = p.sum(-1, keepdims=True)
    return np.where(s > 0, p / np.maximum(s, 1e-30), 0.0).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_fork_move_matches_jax(seed):
    rng = np.random.default_rng(seed)
    batch = 32
    raw = _random_policy(rng, batch)
    ban = np.where(rng.random(batch) < 0.8, np.argmax(raw, -1), -1).astype(np.int32)
    ban[2] = 7
    key = jax.random.PRNGKey(seed)
    jact, jok = jax.jit(lambda k, p, b: JA._sample_fork_move(CFG, k, p, b))(key, jnp.asarray(raw), jnp.asarray(ban))
    tact, tok = TA._sample_fork_move(torch.from_numpy(raw), torch.from_numpy(ban.astype(np.int64)),
                                     fork_move_draws(key, batch, A))
    assert np.array_equal(tact.numpy(), np.asarray(jact)) and np.array_equal(tok.numpy(), np.asarray(jok))
    assert not tok[:3].any() and tok[3:].all()
    assert (tact.numpy() != ban)[3:].all()


def test_choose_fork_moves_matches_jax():
    jev, tev = _evals(TINYNET)
    K, lanes = 8, 36
    jstates = late_positions(K, seed=5, empty=1)
    rng = np.random.default_rng(5)
    legal = np.asarray(jitted.vlegal_mask_flat_fn(CFG)(jstates))
    forced = np.full(K, -1, np.int32)
    forced[1] = np.flatnonzero(legal[1])[0]  # a legal forced move
    forced[2] = np.flatnonzero(~legal[2])[0]  # an illegal one: invalid
    valid = np.ones(K, bool)
    valid[3] = False
    max_choices = np.where(rng.random(K) < 0.5, 12, 36).astype(np.int32)
    key = jax.random.PRNGKey(8)
    jpool = jax.jit(lambda s, v, m, f, k: JF.choose_fork_moves(CFG, jev, s, v, m, f, k))(
        jstates, jnp.asarray(valid), jnp.asarray(max_choices), jnp.asarray(forced), key)
    k_n, k_lanes, _ = jax.random.split(key, 3)
    draws = TF.ForkChoiceDraws(choices=t(jax.random.uniform(k_n, (K,))),
                               lanes=t(jax.random.gumbel(k_lanes, (K, lanes, A))))
    tpool = TF.choose_fork_moves(TCFG, tev, torch_states(jstates), torch.from_numpy(valid),
                                 torch.from_numpy(max_choices), torch.from_numpy(forced), device="cpu", draws=draws)
    assert_same_states(jpool.states, tpool.states, "fork states")
    assert np.array_equal(tpool.valid.numpy(), np.asarray(jpool.valid))
    assert not tpool.valid[2] and not tpool.valid[3] and tpool.valid.any()


def _host_traj(seed):
    """A numpy-built trajectory whose episodes start inside the window."""
    jtraj = numpy_trajectory(seed, T=10, B=16)
    nturns = np.asarray(jtraj.states.num_turns).copy()
    nturns[0, ::2] = 0
    return jtraj._replace(states=jtraj.states._replace(num_turns=jnp.asarray(nturns)))


@pytest.mark.parametrize("seed", [0, 1])
def test_extract_fork_candidates_matches_jax(seed):
    jtraj = _host_traj(seed)
    probs = dict(early_fork_prob=0.5, fork_prob=0.5)
    want = JF.extract_fork_candidates(CFG, jax.tree_util.tree_map(np.asarray, jtraj), np.random.default_rng(seed),
                                      **probs)
    got = TF.extract_fork_candidates(TCFG, torch_traj(jtraj), np.random.default_rng(seed), **probs)
    assert want is not None and got is not None
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (got[2] >= 0).any()  # a hint fork among them


def test_refill_pool_matches_jax():
    jstates = late_positions(12, seed=6, empty=2)
    pool_valid = np.array([True, False, False, True, False, False], bool)
    new_valid = np.array([False, True, True, False, True, True], bool)
    take = lambda lo, hi: jax.tree_util.tree_map(lambda x: x[lo:hi], jstates)  # noqa: E731
    jpool, jnew = JF.ForkPool(take(0, 6), jnp.asarray(pool_valid)), JF.ForkPool(take(6, 12), jnp.asarray(new_valid))
    want = JF.refill_pool(jpool, jnew)
    got = TF.refill_pool(TF.ForkPool(torch_states(jpool.states), to_torch(jpool.valid)),
                         TF.ForkPool(torch_states(jnew.states), to_torch(jnew.valid)))
    assert_same_states(want.states, got.states, "pool")
    assert np.array_equal(got.valid.numpy(), np.asarray(want.valid)) and got.valid.all()


# ---------------------------------------------------------------------------
# A segment with every branch on, then its side positions and tree rows
# ---------------------------------------------------------------------------

BRANCHES = JA.SelfplaySettings(
    num_sims=24, side_position_prob=0.5, record_tree_positions=True, record_tree_threshold=3,
    record_tree_target_weight=0.25, record_tree_capacity=4, startposes_prob=0.3, hintposes_prob=0.4,
)


@functools.lru_cache(maxsize=None)
def _branch_segment():
    jev, tev = _evals(TINYNET)
    batch = 8
    jstates = late_positions(batch, seed=11)
    pool_states = late_positions(12, seed=12, empty=0)
    rng = np.random.default_rng(12)
    legal = np.asarray(jitted.vlegal_mask_flat_fn(CFG)(pool_states))
    hints = np.asarray([rng.choice(np.flatnonzero(row)) for row in legal], np.int32)
    take = lambda lo, hi: jax.tree_util.tree_map(lambda x: x[lo:hi], pool_states)  # noqa: E731
    pools = dict(
        startpos_pool=(take(0, 4), jnp.asarray([0.1, 0.2, 0.3, 0.4], jnp.float32)),
        hintpos_pool=(take(4, 8), jnp.asarray([0.25] * 4, jnp.float32), jnp.asarray(hints[4:8])),
        fork_pool=JF.ForkPool(take(8, 12), jnp.asarray([True, False, True, False])),
    )
    jout, tout, trees = run_both(jev, tev, BRANCHES, jstates, jax.random.PRNGKey(31), 5, **pools)
    return jev, tev, jout, tout, trees


def test_segment_with_every_branch_matches_jax():
    *_, (jst, jep, jtraj, jpool), (tst, tep, ttraj, tpool), trees = _branch_segment()
    assert_same_trajectory(jtraj, ttraj, trees)
    assert_same_states(jst, tst, "new_states")
    assert np.array_equal(tep.numpy(), np.asarray(jep))
    assert np.array_equal(tpool.valid.numpy(), np.asarray(jpool.valid))
    # each branch did something: forks, recorded rows, hint searches, pool pops
    assert ttraj.fork_valid.any() and ttraj.tree_pos_valid.any() and ttraj.hint_first.any()
    assert tpool.valid.sum() < 2


def test_finalize_with_hint_rows_on_the_branch_segment():
    _, _, (_, _, jtraj, _), (_, _, ttraj, _), _ = _branch_segment()
    jbatch = jax.jit(lambda tr: JA.finalize_targets(CFG, BRANCHES, tr))(jax_trajectory(ttraj, jtraj))
    assert_same_batch(jbatch, TA.finalize_targets(TCFG, port_settings(BRANCHES), ttraj))


def test_tree_position_rows_match_jax():
    _, _, (_, _, jtraj, _), (_, _, ttraj, _), _ = _branch_segment()
    want = JT.tree_position_rows(CFG, BRANCHES, jax_trajectory(ttraj, jtraj))
    got = TT.tree_position_rows(TCFG, port_settings(BRANCHES), ttraj)
    assert_same_batch(want, got)
    assert (got.weight == 0.25).any()


def test_run_side_segment_matches_jax():
    jev, tev, (_, _, jtraj, _), (_, _, ttraj, _), _ = _branch_segment()
    jtraj = jax_trajectory(ttraj, jtraj)
    C = 8
    carried = late_positions(C, seed=13, empty=0)
    jside = JA.SideState(carried, jnp.asarray([True, False] * (C // 2)))
    key = jax.random.PRNGKey(41)
    with recorded_gamma() as calls:
        jnew, jbatch = jax.jit(lambda s, tr, k: JA.run_side_segment(CFG, JSP, BRANCHES, jev, s, tr, k))(
            jside, jtraj, key)
        jax.effects_barrier()
    gammas = gamma_table(calls)
    k_search, k_move, k_cont, k_fork, _ = jax.random.split(key, 5)
    k_eval, k_noise = jax.random.split(jax.random.split(k_search)[0])
    draws = TA.SideDraws(
        search=TA.mcts.RootDraws(syms=symmetry_draws(CFG, JSP, k_eval, C), gamma=gammas[np.asarray(k_noise).tobytes()]),
        select=t(jax.random.gumbel(k_move, (C, A))), cont=t(jax.random.uniform(k_cont, (C,))),
        fork_move=fork_move_draws(k_fork, C, A))
    tnew, tbatch = TA.run_side_segment(TCFG, TSP, port_settings(BRANCHES), tev,
                                       TA.SideState(torch_states(carried), to_torch(jside.valid)), ttraj,
                                       device="cpu", draws=draws)
    assert_same_states(jnew.states, tnew.states, "side states")
    assert np.array_equal(tnew.valid.numpy(), np.asarray(jnew.valid))
    # the side search's policy target takes the ceil step only where the
    # segment's does; here it agrees within the tolerance
    assert_same_batch(jbatch, tbatch, atol=2e-4)
    assert (tbatch.weight == 1).sum() > C // 2
