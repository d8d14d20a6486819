"""Parity of the PyTorch search (`katacoffee_tpu_torch.search.mcts`) with the
JAX `run_search` on a fresh tree: the same roots and net (float32 on both
sides), root visit counts equal exactly, root values within 2e-4 and play
selection weights within 1e-5. The default `SearchParams()` profile draws no
random numbers, so the two searches are the same computation."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katacoffee_tpu.dataio.checkpoints import load_exported_model as jax_load
from katacoffee_tpu.game import board as JB
from katacoffee_tpu.game import jitted
from katacoffee_tpu.nn.model import CoffeeNet as JaxNet
from katacoffee_tpu.search import mcts as JM
from katacoffee_tpu.search.params import SearchParams as JaxParams
from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
from katacoffee_tpu_torch.game import board as TB
from katacoffee_tpu_torch.search import mcts as TM
from katacoffee_tpu_torch.search.params import SearchParams

CFG = JB.GameConfig(5, 5, 4)
TCFG = TB.GameConfig(5, 5, 4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINYNET = os.path.join(ROOT, "tests/goldens/tinynet")
B6C96 = os.path.join(ROOT, "artifacts/flagship_b6c96/models/run-s5200")


def _nth_legal_actions(plan):
    """Roots reached by playing, from the empty board, the n-th legal action
    at each ply; `plan` is a list of (rank, plies) per root. Built with the
    JAX rules (the roots of tests/test_search_goldens.py are plans (5, 2)
    and (11, 4), applied one after the other)."""
    legal_fn = jitted.legal_mask_flat_fn(CFG)
    step_fn = jitted.step_fn(CFG)
    roots = []
    for moves in plan:
        s = JB.init_state(CFG)
        for rank, plies in moves:
            for _ in range(plies):
                legal = np.flatnonzero(np.asarray(legal_fn(s)))
                s = step_fn(s, jnp.asarray(int(legal[rank % len(legal)]), jnp.int32))
        roots.append(s)
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *roots)


GOLDEN_PLAN = [[], [(5, 2)], [(5, 2), (11, 4)]]


def _torch_roots(jroots):
    return TB.GameState(*(
        torch.from_numpy(np.asarray(x).astype(np.int64 if np.asarray(x).dtype == np.uint32 else np.asarray(x).dtype))
        for x in jroots
    ))


@functools.lru_cache(maxsize=None)
def _evals(name):
    if name == "uniform":
        return JM.uniform_eval_fn(CFG), TM.uniform_eval_fn(TCFG)
    model, params, _, _ = jax_load(name)
    jnet = JaxNet(dataclasses.replace(model.spec, dtype=jnp.float32), win_len=CFG.win_len)
    tnet = load_exported_model(name, device="cpu", dtype=torch.float32)[0]
    return JM.make_nn_eval_fn(CFG, jnet, params), TM.make_nn_eval_fn(TCFG, tnet)


def _compare(jsp, tsp, evals, plan, visits, max_nodes=None):
    jev, tev = _evals(evals)
    jroots = _nth_legal_actions(plan)
    jtree = jax.jit(lambda r, k: JM.run_search(CFG, jsp, jev, r, visits, k, max_nodes=max_nodes))(
        jroots, jax.random.PRNGKey(0)
    )
    ttree = TM.run_search(TCFG, tsp, tev, _torch_roots(jroots), visits, max_nodes, device="cpu")

    jv = np.asarray(JM.root_visit_counts(jtree))
    tv = TM.root_visit_counts(ttree).numpy()
    assert np.array_equal(tv, jv)
    if max_nodes is None:  # a full tree drops the visits that find no slot
        assert ((tv.sum(-1) == visits) | np.asarray(jroots.done)).all()
    jr = JM.root_values(jtree)
    tr = TM.root_values(ttree)
    for k in jr:
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]), atol=2e-4, rtol=0, err_msg=k)
    np.testing.assert_allclose(
        TM.root_play_selection_weights(tsp, ttree).numpy(),
        np.asarray(JM.root_play_selection_weights(jsp, jtree)),
        atol=1e-5, rtol=0,
    )
    assert np.array_equal(ttree.children.numpy(), np.asarray(jtree.children))
    assert np.array_equal(ttree.node_count.numpy(), np.asarray(jtree.node_count))
    return ttree


@pytest.mark.parametrize("evals", [TINYNET, "uniform"])
def test_golden_positions_match_jax(evals):
    _compare(JaxParams(), SearchParams(), evals, GOLDEN_PLAN, 80)


def test_b6c96_matches_jax():
    _compare(JaxParams(), SearchParams(), B6C96, GOLDEN_PLAN[1:], 32)


def test_deep_roots_with_terminals_and_a_full_tree_match_jax():
    """Late-game roots reach terminal nodes (revisits) and a node budget
    below the playout count overflows the tree."""
    plan = [[(3, 9)], [(7, 11)], [(1, 14)], [(2, 12)]]
    ttree = _compare(JaxParams(), SearchParams(), TINYNET, plan, 40, max_nodes=24)
    assert ttree.is_terminal.any()
    assert (ttree.node_count == 24).any()


SELECT_BRANCHES = dict(
    cpuctExploration=1.1,
    cpuctExplorationLog=0.4,
    cpuctUtilityStdevScale=0.85,
    cpuctUtilityStdevPrior=0.4,
    cpuctUtilityStdevPriorWeight=2.0,
    rootDesiredPerChildVisitsCoeff=2.0,
    rootFpuReductionMax=0.0,
)


@pytest.mark.parametrize(
    "extra",
    [
        dict(fpuParentWeightByVisitedPolicy=True, fpuParentWeightByVisitedPolicyPow=2.0),
        dict(fpuParentWeight=0.5, fpuLossProp=0.1, valueWeightExponent=0.0),
    ],
)
def test_selection_branches_match_jax(extra):
    """The non-default branches of the ported selection code: the cpuct log
    term, the utility-stdev factor, root forced playouts and the FPU
    variants."""
    kw = dict(SELECT_BRANCHES, **extra)
    _compare(JaxParams(**kw), SearchParams(**kw), TINYNET, GOLDEN_PLAN, 60)


@pytest.mark.parametrize(
    "kw,flag",
    [
        (dict(useGraphSearch=True), "useGraphSearch"),
        (dict(rootNoiseEnabled=True), "rootNoiseEnabled"),
        (dict(rootNumSymmetriesToSample=4), "rootNumSymmetriesToSample"),
        (dict(subtreeValueBiasFactor=0.3), "subtreeValueBiasFactor"),
        (dict(useNoisePruning=True), "useNoisePruning"),
        (dict(useUncertainty=True), "useUncertainty"),
        (dict(rootPolicyTemperature=1.1), "rootPolicyTemperature"),
        (dict(numSearchThreads=2), "numSearchThreads"),
    ],
)
def test_unported_settings_raise(kw, flag):
    roots = TB.init_state(TCFG, 2, "cpu")
    with pytest.raises(NotImplementedError, match=flag):
        TM.run_search(TCFG, SearchParams(**kw), TM.uniform_eval_fn(TCFG), roots, 4, device="cpu")


@pytest.mark.parametrize("arg", ["reuse_tree", "root_hint", "root_avoid", "avoid_until"])
def test_unported_arguments_raise(arg):
    roots = TB.init_state(TCFG, 2, "cpu")
    with pytest.raises(NotImplementedError, match=arg):
        TM.run_search(TCFG, SearchParams(), TM.uniform_eval_fn(TCFG), roots, 4, device="cpu",
                      **{arg: torch.zeros(2)})


def test_selfplay_profile_and_eval_symmetries_raise():
    roots = TB.init_state(TCFG, 2, "cpu")
    with pytest.raises(NotImplementedError):
        TM.run_search(TCFG, SearchParams.for_selfplay(), TM.uniform_eval_fn(TCFG), roots, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="symmetry_randomize"):
        TM.make_nn_eval_fn(TCFG, None, symmetry_randomize=True)
