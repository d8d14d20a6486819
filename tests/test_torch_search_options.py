"""The search options the GTP engine turns on, in the port against JAX:
noise pruning, root symmetry pruning and the avoid masks (`root_avoid` at
the root prior, `avoid_until` in the root selection and the descent, also
through `continue_search`). Tinynet at float32 on both sides, 3-4 roots,
32 visits; `SearchParams.for_tests_v2()` (graph search, noise pruning,
uncertainty weighting, the subtree value bias), which draws no random
number, so the two searches are the same computation.

Whole searches: root visit counts, node counts and child links equal
exactly, root values within 2e-4 (tests/torch_parity.py
`assert_same_search`), the policy ranks equal. The noise-pruned
aggregation itself is held to rounding contract item 1 (PERF.md section 2):
`_recompute_node` on JAX's tree, at full width and on the compact lanes the
descent saves, agrees with JAX's row within 8 * 2**-24 * max(|x|, 1)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katacoffee_tpu.game import board as JB
from katacoffee_tpu.search import mcts as JM
from katacoffee_tpu.search.params import SearchParams as JaxParams
from katacoffee_tpu_torch.game.board import init_state
from katacoffee_tpu_torch.search import mcts as TM
from katacoffee_tpu_torch.search.params import SearchParams
from test_torch_search import CFG, GOLDEN_PLAN, TCFG, TINYNET, ULP_BOUND, _evals, _nth_legal_actions, _torch_roots
from torch_parity import assert_same_search, jax_search, one_torch_thread, torch_tree  # noqa: F401

VISITS = 32
A = CFG.policy_size
# an opening that breaks every symmetry of the board (tests/test_rootsym.py)
ASYMMETRIC = [0 * 25 + 2 * 5 + 1, 1 * 25 + 0 * 5 + 1]


def _params(**kw):
    return dataclasses.replace(JaxParams.for_tests_v2(), **kw), dataclasses.replace(SearchParams.for_tests_v2(), **kw)


def _roots(lines):
    """Roots reached by playing each list of flat actions from the empty
    board (JAX rules)."""
    step = jax.jit(lambda s, a: JB.step(CFG, s, a))
    roots = []
    for line in lines:
        s = JB.init_state(CFG)
        for a in line:
            s = step(s, jnp.asarray(a, jnp.int32))
        roots.append(s)
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *roots)


def _legal(jroots):
    return np.asarray(jax.vmap(lambda s: JB.legal_mask_flat(CFG, s))(jroots))


def _both(jsp, tsp, jroots, visits=VISITS, **extra):
    """JAX `run_search` and the port's on the same roots, with `extra`
    search arguments (numpy), compared as whole searches."""
    jev, tev = _evals(TINYNET)
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    jtree, _, draws = jax_search(CFG, jsp, jev, jroots, visits, jax.random.PRNGKey(2), **jextra)
    ttree = TM.run_search(TCFG, tsp, tev, _torch_roots(jroots), visits, device="cpu", draws=draws,
                          **{k: torch.from_numpy(np.asarray(v)) for k, v in extra.items()})
    assert_same_search(jtree, ttree)
    assert np.array_equal(ttree.policy_rank.numpy(), np.asarray(jtree.policy_rank))
    np.testing.assert_allclose(ttree.root_prior.numpy(), np.asarray(jtree.root_prior), atol=1e-6, rtol=0)
    return jtree, ttree


@functools.lru_cache(maxsize=None)
def _noise_pruned_searches():
    jsp, tsp = _params()
    return _both(jsp, tsp, _nth_legal_actions(GOLDEN_PLAN))


@pytest.mark.parametrize("noise_pruning", [True, False], ids=["on", "off"])
def test_noise_pruning_matches_jax(noise_pruning):
    if noise_pruning:
        jtree, ttree = _noise_pruned_searches()
    else:
        jtree, ttree = _both(*_params(useNoisePruning=False), _nth_legal_actions(GOLDEN_PLAN))
    assert tuple(ttree.policy_rank.shape) == ((3, VISITS + 2, A) if noise_pruning else (3, 1, 1))
    if noise_pruning:
        # every allocated node's ranks are a permutation of the actions
        kept = ttree.policy_rank[:, : int(ttree.node_count.min())]
        assert torch.equal(kept.sort(-1).values, torch.arange(A, dtype=torch.int32).expand_as(kept))


def test_policy_ranks_break_ties_by_action_as_jax():
    """Every legal prior tied and every illegal one at -1: the stable sorts
    order both groups by action, as jnp.argsort does."""
    prior = np.where(np.arange(A) % 3 == 0, 0.25, -1.0).astype(np.float32)[None]
    prior[0, 5] = 0.5
    want = np.asarray(JM._policy_ranks(jnp.asarray(prior)))
    assert np.array_equal(TM._policy_ranks(torch.from_numpy(prior)).numpy(), want)


@pytest.mark.parametrize("lanes", [False, True], ids=["full_width", "compact_lanes"])
def test_noise_pruned_recompute_within_the_bound(lanes):
    """`_recompute_node` with noise pruning on JAX's searched tree, node by
    node (every non-terminal node with children, all games at once), against
    JAX's recompute of the same node; with `lanes` the port recomputes an
    interior node from the compact lanes (prior_c, rank_c) that the descent
    saves, as the backup does."""
    jsp, tsp = _params()
    jtree, _ = _noise_pruned_searches()
    jt = jax.tree_util.tree_map(np.asarray, jtree)
    recompute = jax.jit(lambda t, n, m: JM._recompute_node(CFG, jsp, t, n, m).stats)
    ttree = torch_tree(jt)
    B, N = jt.stats.shape[:2]
    has_kids = (jt.children >= 0).any(-1) & ~jt.is_terminal & (np.arange(N)[None] < jt.node_count[:, None])
    checked = 0
    for n in range(0 if not lanes else 1, N):
        mask = has_kids[:, n]
        if not mask.any():
            continue
        node = np.full(B, n, np.int32)
        want = np.asarray(recompute(jtree, jnp.asarray(node), jnp.asarray(mask)))[np.arange(B), node]
        tree = ttree._replace(stats=ttree.stats.clone(), bias_table=ttree.bias_table.clone(),
                              last_bias_delta=ttree.last_bias_delta.clone(),
                              last_bias_weight=ttree.last_bias_weight.clone())
        tnode, tmask = torch.from_numpy(node.astype(np.int64)), torch.from_numpy(mask)
        if lanes:
            bidx = torch.arange(B)
            _, lv, _ = TM._interior_level(TCFG, tsp, tree, bidx, tnode, torch.ones_like(tnode))
            assert (lv.rank_c < 1e6).any() and (lv.rank_c == 1e6).any()
            TM._recompute_node(tsp, tree, tnode, tmask, cs_raw=lv.cs_raw,
                               lanes=(lv.child_c, lv.ev_c, lv.prior_c, lv.rank_c))
        else:
            TM._recompute_node(tsp, tree, tnode, tmask)
        got = tree.stats[torch.arange(B), tnode].numpy()
        assert np.array_equal(got[mask, TM.S_VISITS], want[mask, TM.S_VISITS])
        ok = np.abs(got - want) <= ULP_BOUND * np.maximum(np.abs(want), 1.0)
        assert ok[mask].all(), (n, got[mask], want[mask])
        checked += int(mask.sum())
    assert checked >= 8


@functools.lru_cache(maxsize=None)
def _root_symmetry_searches():
    """One search of both roots, the empty board (game 0) and an opening
    that breaks every symmetry (game 1), under rootSymmetryPruning."""
    jroots = _roots([[], ASYMMETRIC])
    return _legal(jroots), _both(*_params(rootSymmetryPruning=True), jroots)[1]


@pytest.mark.parametrize("position", ["empty", "asymmetric"])
def test_root_symmetry_pruning_matches_jax(position):
    """rootSymmetryPruning: on the empty board one move of each orbit of
    the 8 symmetries keeps its prior (about 8 times fewer), on an opening
    that breaks every symmetry nothing is pruned (tests/test_rootsym.py)."""
    legal, ttree = _root_symmetry_searches()
    b = 0 if position == "empty" else 1
    kept = (ttree.root_prior[b] >= 0).numpy()
    if position == "empty":
        assert kept.sum() < legal[b].sum() / 4
        table = TM.S.action_table(TCFG)
        for a in np.flatnonzero(kept):
            assert table[:, a].min() == a
    else:
        assert np.array_equal(kept, legal[b])
    assert (TM.root_visit_counts(ttree)[b].numpy()[~kept] == 0).all()


def test_sym_action_table_is_jax_table():
    assert np.array_equal(TM._sym_action_table(TCFG, torch.device("cpu")).numpy(), JM._sym_action_table(CFG))


def test_root_avoid_matches_jax():
    """`root_avoid`: some legal moves of game 0 avoided, every legal move of
    game 1 (the mask is ignored), none of game 2."""
    jroots = _nth_legal_actions(GOLDEN_PLAN)
    legal = _legal(jroots)
    avoid = np.zeros((3, A), bool)
    avoid[0, np.flatnonzero(legal[0])[::2]] = True
    avoid[1] = legal[1]
    _, ttree = _both(*_params(), jroots, root_avoid=avoid)
    prior = ttree.root_prior.numpy()
    assert (prior[0][avoid[0]] == -1).all() and (prior[0][legal[0] & ~avoid[0]] >= 0).all()
    assert np.array_equal(prior[1] >= 0, legal[1]) and np.array_equal(prior[2] >= 0, legal[2])


def _avoid_until(jroots, until):
    """[B, 2, A]: game 0 avoids every third legal move of the root for both
    players until `until`, game 1 every action for both players until 30
    (the mask is ignored at every node), game 2 nothing."""
    legal = _legal(jroots)
    au = np.zeros((3, 2, A), np.int32)
    au[0, :, np.flatnonzero(legal[0])[::3]] = until
    au[0, :, np.flatnonzero(~legal[0])[::3]] = until  # moves legal deeper down
    au[1] = 30
    return au


@pytest.mark.parametrize("until", [1, 3], ids=["depth0", "depth2"])
def test_avoid_until_matches_jax(until):
    """`avoid_until` forbids at the root (depth 0 < until) and, with until
    3, in the descent down to depth 2; the unforbidden games search as
    without it."""
    jroots = _nth_legal_actions(GOLDEN_PLAN)
    au = _avoid_until(jroots, until)
    _, ttree = _both(*_params(), jroots, avoid_until=au)
    rv = TM.root_visit_counts(ttree).numpy()
    assert rv[0][au[0, 0] > 0].sum() == 0 and rv[0].sum() == VISITS
    assert rv[1].sum() == VISITS


def test_until_depth_gates_the_descent():
    """As tests/test_avoidmoves.py `test_until_depth_gates_descent`, on the
    port with the tiny net from the empty board: white's favourite first
    reply (depth 1) in an unrestricted search gets no visit there under
    untilDepth 3, and untilDepth 1 covers the root only, where black moves,
    so it changes nothing."""
    _, tev = _evals(TINYNET)
    tsp = SearchParams.for_tests_v2()
    roots = init_state(TCFG, 1, "cpu")

    def white_first_moves(until, y=0):
        au = torch.zeros((1, 2, A), dtype=torch.int32)
        au[0, 1, y] = until
        tree = TM.run_search(TCFG, tsp, tev, roots, 200, device="cpu", avoid_until=au)
        st = tree.states
        live = (tree.stats[0, :, TM.S_VISITS] > 0) & (st.to_move[0] == 2) & (st.num_turns[0] == 1)
        return tree.edge_visits[0, live].sum(0)

    base = white_first_moves(0)
    y = int(base.argmax())
    assert base[y] > 0
    assert white_first_moves(3, y)[y] == 0
    assert torch.equal(white_first_moves(1, y), base)


def test_continue_search_with_avoid_until_matches_jax():
    """The engine's streamed search: a 0-playout `run_search` into a tree of
    64 slots with both masks, then `continue_search` to 20 and to 33 root
    visits with `avoid_until`."""
    jsp, tsp = _params()
    jev, tev = _evals(TINYNET)
    jroots = _nth_legal_actions(GOLDEN_PLAN)
    au = _avoid_until(jroots, 3)
    # the root mover's depth-0 row doubles as the root mask, as in the engine
    avoid = au[np.arange(3), np.asarray(jroots.to_move).astype(np.int64) - 1] > 0
    jstart = jax.jit(lambda r, k: JM.run_search(CFG, jsp, jev, r, 0, k, max_nodes=64, root_avoid=jnp.asarray(avoid),
                                                avoid_until=jnp.asarray(au)))
    jcont = jax.jit(lambda t, k, target: JM.continue_search(CFG, jsp, jev, t, 64, k, target,
                                                             avoid_until=jnp.asarray(au)))
    jtree = jstart(jroots, jax.random.PRNGKey(0))
    ttree = TM.run_search(TCFG, tsp, tev, _torch_roots(jroots), 0, 64, device="cpu",
                          root_avoid=torch.from_numpy(avoid), avoid_until=torch.from_numpy(au))
    for target in (20.0, 33.0):
        jtree = jcont(jtree, jax.random.PRNGKey(1), jnp.asarray(target))
        TM.continue_search(TCFG, tsp, tev, ttree, 64, target, avoid_until=torch.from_numpy(au))
        assert_same_search(jtree, ttree)
    assert (TM.root_visit_counts(ttree).sum(-1) == 32).all()
