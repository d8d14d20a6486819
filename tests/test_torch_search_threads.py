"""K playouts a round (numSearchThreads = K > 1) in the PyTorch search,
held to the JAX package's `_simulate_round` on the CPU: the tinynet at
float32 on both sides, B = 4 roots (three golden positions and a late one),
23 playouts, so that the last round of K = 2 and of K = 3 hands out only
the rest of the budget. Under `SearchParams()` the search draws nothing;
under `for_selfplay()` (graph search, root noise and symmetries, forced
playouts, the subtree value bias; tests/test_torch_search_threads_selfplay.py)
the port is handed JAX's root draws (tests/torch_parity.py). Trees compared
whole (`assert_same_tree`): child links, edge visits, node counts and visits
exactly, every stats row and the root values within 2e-4 (float32 sums of
another order over a whole search); the rounds `with_diag` reports; and the
policy targets (`assert_policy_targets_match`: apart only by the ceil step
of PERF.md section 2).

Here also: a tree reused through `advance_root`, whose games get only as
many playout slots a round as they lack visits, then `continue_search` to a
target per game past the tree's capacity; and the setting JAX refuses, K > 1
with maxPlayoutDepthProp < 1 under graph search, which raises the same error
in `run_search` and runs in `continue_search`, in both packages."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from katacoffee_tpu.game import board as JB
from katacoffee_tpu.search import mcts as JM
from katacoffee_tpu.search.params import SearchParams as JaxParams
from katacoffee_tpu_torch.search import mcts as TM
from katacoffee_tpu_torch.search.params import SearchParams
from test_torch_search import CFG, GOLDEN_PLAN, TCFG, TINYNET, _evals, _nth_legal_actions, _torch_roots
from torch_parity import assert_same_search, jax_search, jax_tree, one_torch_thread  # noqa: F401 (autouse fixture)

VISITS = 23
PLAN = GOLDEN_PLAN + [[(3, 9)]]
PROFILES = {"default": (JaxParams(), SearchParams()),
            "selfplay": (JaxParams.for_selfplay(), SearchParams.for_selfplay())}


def params(profile, **kw):
    jsp, tsp = PROFILES[profile]
    return dataclasses.replace(jsp, **kw), dataclasses.replace(tsp, **kw)


def assert_same_tree(jtree, ttree):
    """`assert_same_search`, and every edge visit and node visit count
    equal, every stats row within 2e-4."""
    assert_same_search(jtree, ttree)
    assert np.array_equal(ttree.edge_visits.numpy(), np.asarray(jtree.edge_visits))
    jstats, tstats = np.asarray(jtree.stats), ttree.stats.numpy()
    assert np.array_equal(tstats[..., TM.S_VISITS], jstats[..., TM.S_VISITS])
    np.testing.assert_allclose(tstats, jstats, atol=2e-4, rtol=0)


def assert_policy_targets_match(jsp, tsp, jtree, ttree):
    """The policy-target readout is JAX's on the port's tree (within 1e-6),
    and the two trees' play-selection weights differ at most by the ceil
    step (PERF.md section 2): one unit, at a root child whose weight lies
    within 8 * 2**-24 * max(|w|, 1) of an integer."""
    np.testing.assert_allclose(TM.policy_target(ttree, tsp).numpy(), np.asarray(JM.policy_target(jax_tree(ttree), jsp)),
                               atol=1e-6, rtol=0)
    d = TM.root_play_selection_weights(tsp, ttree).numpy() - np.asarray(JM.root_play_selection_weights(jsp, jtree))
    w = TM._root_child_stats(ttree)["w"].numpy()
    near = np.abs(w - np.round(w)) <= 8 * 2.0**-24 * np.maximum(np.abs(w), 1.0)
    assert ((np.abs(d) <= 1e-5) | (near & (np.abs(np.abs(d) - 1.0) <= 1e-5))).all(), d[np.abs(d) > 1e-5]


@functools.lru_cache(maxsize=None)
def searches(profile, K):
    jsp, tsp = params(profile, numSearchThreads=K)
    jev, tev = _evals(TINYNET)
    jroots = _nth_legal_actions(PLAN)
    jtree, jdiag, draws = jax_search(CFG, jsp, jev, jroots, VISITS, jax.random.PRNGKey(1))
    ttree, tdiag = TM.run_search(TCFG, tsp, tev, _torch_roots(jroots), VISITS, device="cpu", draws=draws,
                                 with_diag=True)
    return jsp, tsp, jtree, jdiag, ttree, tdiag


def check_fresh_search(profile, K):
    jsp, tsp, jtree, jdiag, ttree, tdiag = searches(profile, K)
    assert_same_tree(jtree, ttree)
    rounds = -(-VISITS // K)
    assert tdiag["rounds"] == int(jdiag["rounds"]) == rounds and VISITS % K != 0
    assert torch.equal(tdiag["start_visits"], torch.ones(4))
    # every game's root got exactly the budget, the last round's idle slots none
    assert (TM.root_visit_counts(ttree).sum(-1) == VISITS).all()
    assert (ttree.stats[:, 0, TM.S_VISITS] == VISITS + 1).all()
    assert_policy_targets_match(jsp, tsp, jtree, ttree)
    if profile == "selfplay":
        # root noise and symmetries were drawn and the bias table filled
        assert (ttree.bias_table[..., 1] != 0).any()


@pytest.mark.parametrize("K", [2, 3])
def test_fresh_search_with_k_playouts_a_round_matches_jax(K):
    check_fresh_search("default", K)


def test_reused_tree_and_continued_search_with_two_playouts_a_round_match_jax():
    """The moves JAX's search would play, one game's reuse refused; the
    reused roots hold 4-6 visits, so their deficits of 17 + 1 - visits are
    odd or even and some games get one slot in their last round. Then
    `continue_search` to 25-40 visits a game in a tree of 22 slots, which
    fills (overflow revisits)."""
    jsp, tsp, jtree, _, ttree, _ = searches("default", 2)
    jev, tev = _evals(TINYNET)
    acts = np.asarray(JM.root_visit_counts(jtree)).argmax(-1).astype(np.int32)
    step = jax.jit(jax.vmap(lambda s, a: JB.step(CFG, s, a)))
    jroots = step(_nth_legal_actions(PLAN), jax.numpy.asarray(acts))
    ok = np.array([True, True, False, True])
    jtree2, jdiag, draws = jax_search(CFG, jsp, jev, jroots, 17, jax.random.PRNGKey(6), reuse_tree=jtree,
                                      reuse_actions=jax.numpy.asarray(acts), reuse_ok=jax.numpy.asarray(ok))
    ttree2, tdiag = TM.run_search(TCFG, tsp, tev, _torch_roots(jroots), 17, device="cpu", draws=draws,
                                  reuse_tree=ttree, reuse_actions=torch.from_numpy(acts.astype(np.int64)),
                                  reuse_ok=torch.from_numpy(ok), with_diag=True)
    assert_same_tree(jtree2, ttree2)
    start = tdiag["start_visits"].numpy()
    np.testing.assert_array_equal(start, np.asarray(jdiag["start_visits"]))
    assert start[2] == 1 and (start[[0, 1, 3]] > 1).all() and len(set((18 - start) % 2)) == 2
    assert tdiag["rounds"] == int(jdiag["rounds"]) == 9
    assert (ttree2.stats[:, 0, TM.S_VISITS] == 18).all()

    target = np.array([30, 25, 40, 33], np.float32)
    jc = jax.jit(lambda t, k, g: JM.continue_search(CFG, jsp, jev, t, 40, k, g))(
        jtree2, jax.random.PRNGKey(7), jax.numpy.asarray(target))
    tc = TM.continue_search(TCFG, tsp, tev, ttree2, 40, torch.from_numpy(target))
    assert_same_tree(jc, tc)
    assert np.array_equal(tc.stats[:, 0, TM.S_VISITS].numpy(), target)
    assert (tc.node_count == tc.stats.shape[1]).all()


def test_the_setting_jax_refuses_raises_in_run_search_and_runs_in_continue_search():
    jsp, tsp = params("default", numSearchThreads=2, useGraphSearch=True, maxPlayoutDepthProp=0.5)
    jev, tev = _evals(TINYNET)
    jroots = _nth_legal_actions(PLAN[:2])
    with pytest.raises(NotImplementedError) as jax_err:
        JM.run_search(CFG, jsp, jev, jroots, 4, jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError) as port_err:
        TM.run_search(TCFG, tsp, tev, _torch_roots(jroots), 4, device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    # continue_search refuses nothing, in either package
    tree = TM.run_search(TCFG, dataclasses.replace(tsp, numSearchThreads=1), tev, _torch_roots(jroots), 2, 12,
                         device="cpu")
    TM.continue_search(TCFG, tsp, tev, tree, 4, 8.0)
    assert (tree.stats[:, 0, TM.S_VISITS] == 8).all()
