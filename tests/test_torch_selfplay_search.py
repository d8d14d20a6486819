"""The PyTorch search under `SearchParams.for_selfplay()` against JAX: whole
searches, and tree reuse as the selfplay actor plays a 2-move segment (a
fresh search, `select_moves`, the step, a search on the reused tree), and
`continue_search`. Tinynet and b6c96 at float32 on both sides, B <= 3, the
actor's node budget N = 0.3 * visits + 2, the JAX searches' root draws and
Gumbel noise passed to the port (tests/torch_parity.py).

Searches: root visit counts, node counts and child links equal exactly; root
values within 2e-4, the bias table within 1e-4 + 1e-5 relative (float32 sums
in another order over a whole search); the root prior within 1e-6.
`advance_root`: every integer field equal, the node count and the start
visits included; stats, priors and the bias table within 1e-5 absolute (the
built tree's rounding, copied, and the freed nodes' bias given back)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katacoffee_tpu.game import jitted
from katacoffee_tpu.search import mcts as JM
from katacoffee_tpu.search.params import SearchParams as JaxParams
from katacoffee_tpu_torch.game import board as TB
from katacoffee_tpu_torch.search import mcts as TM
from katacoffee_tpu_torch.search.params import SearchParams
from test_torch_search import B6C96, CFG, GOLDEN_PLAN, TCFG, TINYNET, _evals, _nth_legal_actions, _torch_roots
from torch_parity import (  # noqa: F401 (one_torch_thread: autouse fixture)
    assert_same_search,
    jax_search,
    one_torch_thread,
    recorded_gamma,
    symmetry_draws,
)

JSP, TSP = JaxParams.for_selfplay(), SearchParams.for_selfplay()
TOL = 1e-6
VISITS = 64
NODES = int(0.3 * VISITS) + 2


def _same_selfplay_search(evals, plan, visits, key):
    jev, tev = _evals(evals)
    jroots = _nth_legal_actions(plan)
    nodes = int(0.3 * visits) + 2
    jtree, _, draws = jax_search(CFG, JSP, jev, jroots, visits, key, max_nodes=nodes)
    ttree = TM.run_search(TCFG, TSP, tev, _torch_roots(jroots), visits, nodes, device="cpu", draws=draws)
    assert_same_search(jtree, ttree)
    np.testing.assert_allclose(ttree.bias_table.numpy(), np.asarray(jtree.bias_table), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(ttree.root_prior.numpy(), np.asarray(jtree.root_prior), atol=TOL, rtol=0)
    return jev, tev, jroots, jtree, ttree


@functools.lru_cache(maxsize=None)
def _first_move():
    """The tinynet search of the 2-move segment's first move."""
    return _same_selfplay_search(TINYNET, GOLDEN_PLAN, VISITS, jax.random.PRNGKey(11))


@pytest.mark.parametrize("evals", ["tinynet", "b6c96"])
def test_selfplay_profile_matches_jax(evals):
    if evals == "tinynet":
        _first_move()
    else:
        _same_selfplay_search(B6C96, GOLDEN_PLAN[1:], 40, jax.random.PRNGKey(4))


@functools.lru_cache(maxsize=None)
def _jax_continue():
    """JAX `continue_search` with up to VISITS more playouts, jitted once:
    the loop of `run_search`'s reuse branch (:2539-2555), which runs it
    after `advance_root` with target VISITS + 1."""
    jev = _first_move()[0]
    return jax.jit(lambda t, target: JM.continue_search(CFG, JSP, jev, t, VISITS, jax.random.PRNGKey(5), target))


def _clone(tree):
    return TM.Tree(*(x.map(torch.clone) if isinstance(x, tuple) else x.clone() for x in tree))


def test_two_move_segment_matches_jax():
    """The JAX side of the reused search is `advance_root` then the search
    loop to VISITS + 1 root visits, which is what JAX's `run_search` does
    with a reuse tree; the port's side is its `run_search` with the reuse
    arguments."""
    jev, tev, jroots, jtree, ttree = _first_move()
    ttree = _clone(ttree)
    B = jroots.board.shape[0]
    key = jax.random.PRNGKey(12)
    jact = JM.select_moves(CFG, JSP, jtree, key)
    gumbel = torch.from_numpy(np.asarray(jax.random.gumbel(key, (B, CFG.policy_size))).copy())
    tact = TM.select_moves(TCFG, TSP, ttree, gumbel=gumbel)
    assert np.array_equal(tact.numpy(), np.asarray(jact))
    np.testing.assert_allclose(TM.policy_target(ttree, TSP).numpy(), np.asarray(JM.policy_target(jtree, JSP)),
                               atol=1e-6, rtol=0)
    jnext = jitted.vstep_fn(CFG)(jroots, jact)
    tnext = TB.step(TCFG, _torch_roots(jroots), tact)
    ok = jnp.asarray([True, True, False])  # the third game takes a fresh root

    # advance_root, with the root draws of the reused search's key chain
    # (run_search :2422, advance_root :2671)
    k_init, _ = jax.random.split(jax.random.PRNGKey(13))
    with recorded_gamma() as calls:
        jadv = jax.jit(lambda t, a, s, k: JM.advance_root(CFG, JSP, jev, t, a, s, k, reuse_ok=ok))(
            jtree, jact, jnext, k_init)
        jax.effects_barrier()
    k_eval = jax.random.split(k_init, 3)[0]
    draws = TM.RootDraws(syms=symmetry_draws(CFG, JSP, k_eval, B), gamma=torch.from_numpy(calls[0][1].copy()),
                         gamma_reused=torch.from_numpy(calls[1][1].copy()))
    t_ok = torch.from_numpy(np.array(ok))
    tadv = TM.advance_root(TCFG, TSP, tev, ttree, tact, tnext, draws=draws, reuse_ok=t_ok)
    for name in TM.Tree._fields:
        if name == "states":
            for sname, a, b in zip(TB.GameState._fields, getattr(tadv, name), getattr(jadv, name)):
                assert np.array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype)), sname
            continue
        a, b = getattr(tadv, name).numpy(), np.asarray(getattr(jadv, name))
        if b.dtype == np.float32:
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)
        else:
            assert np.array_equal(a, b.astype(a.dtype)), name
    start = tadv.stats[:, 0, TM.S_VISITS]
    assert (start[:2] > 1).all() and start[2] == 1
    assert (tadv.node_count[:2] > 1).all() and (tadv.bias_table[:2, :, 1] > 0).any()

    # the whole reused search
    jtree2 = _jax_continue()(jadv, jnp.float32(VISITS + 1))
    ttree2, tdiag = TM.run_search(TCFG, TSP, tev, tnext, VISITS, NODES, device="cpu", draws=draws,
                                  reuse_tree=ttree, reuse_actions=tact, reuse_ok=t_ok, with_diag=True)
    assert torch.equal(tdiag["start_visits"], start)
    assert tdiag["rounds"] == VISITS + 1 - int(start.min())
    assert_same_search(jtree2, ttree2)
    assert (ttree2.stats[:, 0, TM.S_VISITS] == VISITS + 1).all()


def test_continue_search_matches_jax():
    """The interruptible search loop: the first move's trees continued to a
    per-game target of visits, at most VISITS more playouts (the third
    game's target lies beyond that)."""
    _, tev, _, jtree, ttree = _first_move()
    target = np.asarray([80.0, 70.0, 200.0], np.float32)
    jtree2 = _jax_continue()(jtree, jnp.asarray(target))
    ttree2 = TM.continue_search(TCFG, TSP, tev, _clone(ttree), VISITS, torch.from_numpy(target))
    assert_same_search(jtree2, ttree2)
    visits = ttree2.stats[:, 0, TM.S_VISITS].numpy()
    assert np.array_equal(visits, np.minimum(target, 2 * VISITS + 1))
