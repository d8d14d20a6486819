"""Parity of the PyTorch search (`katacoffee_tpu_torch.search.mcts`) with the
JAX `run_search` on a fresh tree: the same roots and net (float32 on both
sides), root visit counts equal exactly, root values within 2e-4 and play
selection weights within 1e-5. The default `SearchParams()` profile draws no
random numbers, so the two searches are the same computation.

The rounding contract. The port rounds as torch does, not as XLA on the CPU
does: torch's `pow(x, 0.5)` is a square root where XLA's is not, and row
sums add in another order. The card's kernels are bit-identical to torch's
rounding, and JAX on a TPU does not round like XLA on the CPU either, so
XLA-CPU's rounding is no reference to copy into a CUDA kernel. What the port
is held to instead:
  * a stats row that the port recomputes from the same inputs as JAX agrees
    with JAX's within |d| <= 8 * 2**-24 * max(|x|, 1) in every channel
    (ULP_BOUND; a handful of float32 roundings of values of order x);
  * a descent decision may differ from JAX's only where JAX's two best
    scores tie exactly, or lie within that bound of each other;
  * whole-search tests that assert exact visit counts use real nets
    (tinynet, b6c96), whose scores do not tie; with `uniform_eval_fn` exact
    ties are common. The pinned input below (5x5 win 4, `SearchParams()`,
    `uniform_eval_fn`, one late root with 2 legal moves) shows a 1-ulp
    difference at 11 playouts, JAX's two root children tied exactly at 15
    root visits, and the trees parting at the next playout."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katacoffee_tpu.game import board as JB
from katacoffee_tpu.game import jitted
from katacoffee_tpu.nn.model import CoffeeNet as JaxNet
from katacoffee_tpu.search import mcts as JM
from katacoffee_tpu.search.params import SearchParams as JaxParams
from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
from katacoffee_tpu_torch.game import board as TB
from katacoffee_tpu_torch.search import mcts as TM
from katacoffee_tpu_torch.search.params import SearchParams
from torch_parity import jax_exported_net, one_torch_thread, torch_tree  # noqa: F401 (autouse fixture)

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
    jnet, params = jax_exported_net(name)
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


ULP_BOUND = 8 * 2.0**-24
PINNED_PLAN = [[(1, 14)]]


def _within_bound(got, want):
    return np.abs(got - want) <= ULP_BOUND * np.maximum(np.abs(want), 1.0)


@functools.lru_cache(maxsize=None)
def _pinned_jax_trees(sims=15):
    """JAX trees of the pinned root after 0..`sims` playouts, one jitted
    `_simulate_once` at a time (the body of `run_search`'s loop), as numpy
    pytrees, and the root."""
    jroots = _nth_legal_actions(PINNED_PLAN)
    jev = JM.uniform_eval_fn(CFG)
    sp = JaxParams()
    tree = JM.init_tree(CFG, sp, jev, jroots, sims + 2, jax.random.PRNGKey(0))
    one = jax.jit(lambda t, k: JM._simulate_once(CFG, sp, jev, t, k, CFG.area + 1)[0])
    trees = [tree]
    for i in range(sims):
        tree = one(tree, jax.random.PRNGKey(i))
        trees.append(tree)
    return jroots, [jax.tree_util.tree_map(np.asarray, t) for t in trees]


def _pinned_port_tree(sims):
    jroots, _ = _pinned_jax_trees()
    return TM.run_search(TCFG, SearchParams(), TM.uniform_eval_fn(TCFG), _torch_roots(jroots), sims, 17,
                         device="cpu")


def test_pinned_root_rounds_within_the_bound_and_parts_after_an_exact_tie():
    """The smallest input on which the port's rounding parts from JAX's: at
    11 playouts node 1's S_WSQ differs (5.999999046 in JAX, 5.999999523 in
    the port) and lies within the bound, as does every other entry; at 15
    root visits JAX's two root children are tied exactly in every input of
    the PUCT score, while the port's S_W differ by one ulp; one playout
    later the root visits are (8, 7) on one side and (7, 8) on the other."""
    _, jt = _pinned_jax_trees()
    t11 = _pinned_port_tree(11)
    j11 = jt[11].stats[0]
    assert j11[1, TM.S_WSQ] != t11.stats[0, 1, TM.S_WSQ].item()
    assert _within_bound(t11.stats[0].numpy(), j11).all()

    j14, t14 = jt[14], _pinned_port_tree(14)
    root_kids = np.flatnonzero(j14.children[0, 0] >= 0)
    assert len(root_kids) == 2 and np.array_equal(j14.children[0, 0, root_kids], [1, 2])
    assert j14.stats[0, 0, TM.S_VISITS] == 15
    rows = j14.stats[0, [1, 2]]
    for ch in (TM.S_VISITS, TM.S_W, TM.S_U):
        assert rows[0, ch] == rows[1, ch], ch
    assert j14.edge_visits[0, 0, root_kids[0]] == j14.edge_visits[0, 0, root_kids[1]]
    assert j14.root_prior[0, root_kids[0]] == j14.root_prior[0, root_kids[1]]
    t_rows = t14.stats[0, [1, 2]].numpy()
    assert t_rows[0, TM.S_W] != t_rows[1, TM.S_W]
    assert _within_bound(t_rows, rows).all()

    j15 = jt[15].edge_visits[0, 0, root_kids]
    t15 = _pinned_port_tree(15).edge_visits[0, 0, root_kids].numpy()
    assert sorted(j15) == sorted(t15) == [7, 8] and not np.array_equal(j15, t15)


@pytest.mark.parametrize("sims", [11, 14, 15])
def test_recompute_steps_match_jax_within_the_bound(sims):
    """Step parity: JAX's tree after playout `sims` loaded into the port,
    and the port's `_recompute_node` run on every node that playout
    recomputed (the non-terminal nodes whose visits it raised); each row
    agrees with JAX's within the bound, visits exactly."""
    _, jt = _pinned_jax_trees()
    before, after = jt[sims - 1], jt[sims]
    loaded = torch_tree(after)
    raised = np.flatnonzero(
        (after.stats[0, :, TM.S_VISITS] > before.stats[0, :, TM.S_VISITS])
        & (np.arange(after.stats.shape[1]) < before.node_count[0])
        & ~after.is_terminal[0]
    )
    assert len(raised) >= 2
    for n in raised:
        tree = loaded._replace(stats=loaded.stats.clone())
        TM._recompute_node(SearchParams(), tree, torch.tensor([n]), torch.tensor([True]))
        got = tree.stats[0, n].numpy()
        want = after.stats[0, n]
        assert got[TM.S_VISITS] == want[TM.S_VISITS] + 1
        assert _within_bound(got[1:], want[1:]).all(), (sims, n, got, want)


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
        (dict(numSearchThreads=2, useGraphSearch=True, maxPlayoutDepthProp=0.5), "numSearchThreads"),
        (dict(useGraphSearch=True, graphSearchCatchUpLeakProb=0.1), "graphSearchCatchUpLeakProb"),
    ],
)
def test_unported_settings_raise(kw, flag):
    """What the search refuses raises, naming the setting: several playouts
    a round with maxPlayoutDepthProp < 1 under graph search, which the JAX
    package refuses too (NotImplementedError), and the catch-up leak with
    neither a generator nor injected draws (ValueError), as every drawing
    setting. Both are held to JAX in tests/test_torch_search_threads.py and
    tests/test_torch_search_leak.py; the other settings ported since in
    tests/test_torch_search_settings.py, tests/test_torch_gatekeeper_search.py
    (uncertainty weighting, policy optimism) and
    tests/test_torch_search_options.py (noise pruning, root symmetry pruning,
    the avoid masks)."""
    roots = TB.init_state(TCFG, 2, "cpu")
    error = NotImplementedError if flag == "numSearchThreads" else ValueError
    with pytest.raises(error, match=flag):
        TM.run_search(TCFG, SearchParams(**kw), TM.uniform_eval_fn(TCFG), roots, 4, device="cpu")


def test_eval_symmetries_raise():
    """A symmetry-randomizing evaluator draws: without a generator or
    injected symmetries it raises, as every drawing call of the port does."""
    with pytest.raises(ValueError, match="Generator"):
        TM.make_nn_eval_fn(TCFG, None, symmetry_randomize=True)


@functools.lru_cache(maxsize=None)
def _tinynets():
    model, params = jax_exported_net(TINYNET)
    return model, params, load_exported_model(TINYNET, device="cpu", dtype=torch.float32)[0]


@pytest.mark.parametrize("board,keys", [("5x5", (0, 1, 2)), ("6x4", (3, 4))])
def test_randomized_eval_matches_jax_with_its_symmetries(board, keys):
    """The symmetry-randomizing evaluator (tinynet, float32) equal to JAX's
    on random positions, the port handed the symmetries JAX draws,
    `jax.random.randint(rng, (B,), 0, nsym)`, with every symmetry of the
    board among them: policy, utility, draw and shortterm error within
    1e-5."""
    from test_torch_symmetry import BOARDS, _positions

    batch = 64
    tcfg, jcfg, ts, js = _positions(board, batch=batch, seed=len(keys))
    model, params, tnet = _tinynets()
    jnet = JaxNet(dataclasses.replace(model.spec, dtype=jnp.float32), win_len=BOARDS[board][2])
    jev = jax.jit(JM.make_nn_eval_fn(jcfg, jnet, params, symmetry_randomize=True))
    nsym = 8 if board == "5x5" else 4
    seen = set()
    for k in keys:
        rng = jax.random.PRNGKey(k)
        syms = torch.from_numpy(np.asarray(jax.random.randint(rng, (batch,), 0, nsym)).astype(np.int64))
        seen |= set(syms.tolist())
        want = jev(js, rng)
        got = TM.make_nn_eval_fn(tcfg, tnet, symmetry_randomize=True, draw_syms=lambda n, s=syms: s[:n])(ts)
        for name in ("policy", "utility", "draw", "shortterm_error"):
            np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), atol=1e-5,
                                       rtol=0, err_msg=(k, name))
    assert seen == set(range(nsym))


def test_randomized_eval_with_symmetry_zero_is_the_plain_eval_and_draws_cover_every_symmetry(monkeypatch):
    from test_torch_symmetry import _positions

    tcfg, _, ts, _ = _positions("5x5", batch=32, seed=5)
    tnet = _tinynets()[2]
    plain = TM.make_nn_eval_fn(tcfg, tnet)(ts)
    zero = TM.make_nn_eval_fn(tcfg, tnet, symmetry_randomize=True,
                              draw_syms=lambda n: torch.zeros(n, dtype=torch.int64))(ts)
    for a, b in zip(plain, zero):
        assert torch.equal(a, b)

    drawn = []
    apply_features = TM.S.apply_features

    def recording(sym, spatial):
        drawn.append(sym.clone())
        return apply_features(sym, spatial)

    monkeypatch.setattr(TM.S, "apply_features", recording)
    n = 8192
    big = TB.GameState(*(x.repeat((n // 32,) + (1,) * (x.dim() - 1)) for x in ts))
    ev = TM.make_nn_eval_fn(tcfg, tnet, symmetry_randomize=True, generator=torch.Generator().manual_seed(11))
    ev(big)
    counts = torch.bincount(drawn[0], minlength=8).double()
    chi2 = float(((counts - n / 8) ** 2 / (n / 8)).sum())
    assert drawn[0].shape == (n,) and counts.min() > 0
    assert chi2 < 24.32, (chi2, counts)  # the 0.999 quantile of chi-square with 7 degrees of freedom


def test_random_settings_without_a_generator_raise():
    """A search that draws at its root needs a generator or its draws."""
    roots = TB.init_state(TCFG, 2, "cpu")
    for kw in (dict(rootNoiseEnabled=True), dict(rootNumSymmetriesToSample=4)):
        with pytest.raises(ValueError, match="Generator"):
            TM.run_search(TCFG, SearchParams(**kw), TM.uniform_eval_fn(TCFG), roots, 4, device="cpu")
    tree = TM.run_search(TCFG, SearchParams(), TM.uniform_eval_fn(TCFG), roots, 4, device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        TM.select_moves(TCFG, SearchParams.for_selfplay(), tree)
