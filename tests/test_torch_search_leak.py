"""The catch-up leak (graphSearchCatchUpLeakProb) and the gaussian evaluator
(`gaussian_prior_eval_fn`) of the PyTorch search, held to the JAX package on
the CPU with its draws injected.

The leak: a tree 40 playouts into a `for_selfplay()` search on four roots,
whose edges with two or more visits then lose one, as a transposition
leaves an edge behind its child, so that playouts stop at catch-ups at the
root and below it. JAX `continue_search` from that tree and the port's, at
leak probability 0.3, with one playout a round and with two, the port handed
JAX's uniform draws: its key chain (`continue_search` splits a key a round;
`_simulate_once` draws `uniform(fold_in(fold_in(k_leak, 0), 1), (B, D + 1))`,
`_simulate_round` `uniform(fold_in(k_leak, 1), (B * K, D + 1))`, k_leak the
first of three keys split from the round's). Trees compared whole
(tests/test_torch_search_threads.py `assert_same_tree`); the leak changes
them. The port's own draws leak at the probability, within five binomial
standard deviations.

The gaussian evaluator: equal to JAX's on random positions given JAX's
normals (`split(rng)` into the policy's and the value's keys), within 1e-6;
and a search under it with two playouts a round, the port handed the
normals of JAX's evaluation keys (`init_tree`'s `k_eval`, then the second of
three keys split from each round's), equal to JAX's."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from katacoffee_tpu.search import mcts as JM
from katacoffee_tpu.search.params import SearchParams as JaxParams
from katacoffee_tpu_torch.game.board import init_state
from katacoffee_tpu_torch.search import mcts as TM
from katacoffee_tpu_torch.search.params import SearchParams
from test_torch_search import CFG, GOLDEN_PLAN, TCFG, TINYNET, _evals, _nth_legal_actions, _torch_roots
from test_torch_search_threads import assert_same_tree
from torch_parity import jax_tree, leak_draws, one_torch_thread, round_keys  # noqa: F401 (autouse fixture)

LEAK = 0.3
PLAN = GOLDEN_PLAN + [[(3, 9)]]
D = CFG.area + 1


@functools.lru_cache(maxsize=None)
def lagging_tree():
    """The port's tree 40 playouts into a selfplay search (80 slots), every
    edge with two or more visits one visit behind its child."""
    _, tev = _evals(TINYNET)
    tree = TM.run_search(TCFG, SearchParams.for_selfplay(), tev, _torch_roots(_nth_legal_actions(PLAN)), 40, 80,
                         device="cpu", generator=torch.Generator().manual_seed(0))
    tree.edge_visits.sub_((tree.edge_visits >= 2).to(torch.int32))
    return tree


def copy(tree):
    return TM.Tree(*(x.map(torch.clone) if isinstance(x, tuple) else x.clone() for x in tree))


@pytest.mark.parametrize("K", [1, 2])
def test_catch_up_leak_matches_jax_with_its_draws(K):
    jsp, tsp = (dataclasses.replace(p, graphSearchCatchUpLeakProb=LEAK, numSearchThreads=K)
                for p in (JaxParams.for_selfplay(), SearchParams.for_selfplay()))
    jev, tev = _evals(TINYNET)
    base = lagging_tree()
    key = jax.random.PRNGKey(8 + K)
    jtree = jax.jit(lambda t, k: JM.continue_search(CFG, jsp, jev, t, 30, k, 61.0))(jax_tree(base), key)
    ttree = TM.continue_search(TCFG, tsp, tev, copy(base), 30, 61.0, draw_leak=leak_draws(key, K))
    assert_same_tree(jtree, ttree)
    assert (ttree.stats[:, 0, TM.S_VISITS] == 61).all()
    closed = TM.continue_search(TCFG, dataclasses.replace(tsp, graphSearchCatchUpLeakProb=0.0), tev, copy(base), 30,
                                61.0)
    assert not torch.equal(closed.edge_visits, ttree.edge_visits), "the leak changed nothing"


def test_own_leak_draws_leak_at_the_probability():
    sp = SearchParams(useGraphSearch=True, graphSearchCatchUpLeakProb=LEAK)
    draw = TM._leak_source(sp, torch.Generator().manual_seed(5))
    rows = torch.arange(512)
    leaked = torch.cat([TM._leaked(sp, draw(512, D, torch.device("cpu")), rows, torch.full((512,), d))
                        for d in range(D) for _ in range(8)])
    n = leaked.numel()
    bound = 5 * (LEAK * (1 - LEAK) / n) ** 0.5
    assert abs(leaked.double().mean().item() - LEAK) < bound, (leaked.double().mean().item(), bound)


def gaussian_normals(key, b):
    k_pol, k_val = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.normal(k_pol, (b, CFG.area)))),
            torch.from_numpy(np.array(jax.random.normal(k_val, (b, 2)))))


def test_gaussian_eval_matches_jax_with_its_normals():
    from test_torch_symmetry import _positions

    _, _, ts, js = _positions("5x5", batch=32, seed=2)
    key = jax.random.PRNGKey(12)
    want = jax.jit(JM.gaussian_prior_eval_fn(CFG))(js, key)
    got = TM.gaussian_prior_eval_fn(TCFG, draw_normals=lambda b: gaussian_normals(key, b))(ts)
    for name in ("policy", "utility", "wl", "draw", "shortterm_error"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), atol=1e-6, rtol=0,
                                   err_msg=name)
    assert (got.policy[:, CFG.area:] > 0).any() and got.utility.abs().max() > 0


def test_search_under_the_gaussian_eval_matches_jax():
    K = 2
    jsp, tsp = JaxParams(numSearchThreads=K), SearchParams(numSearchThreads=K)
    jroots = _nth_legal_actions(PLAN)
    key = jax.random.PRNGKey(13)
    jtree = jax.jit(lambda r, k: JM.run_search(CFG, jsp, JM.gaussian_prior_eval_fn(CFG), r, 16, k))(jroots, key)
    k_init, k_sims = jax.random.split(key)
    eval_keys = iter([jax.random.split(k_init)[0]])
    rounds = round_keys(k_sims)

    def normals(b):
        k = next(eval_keys, None)
        return gaussian_normals(jax.random.split(next(rounds), 3)[1] if k is None else k, b)

    ttree = TM.run_search(TCFG, tsp, TM.gaussian_prior_eval_fn(TCFG, draw_normals=normals), _torch_roots(jroots), 16,
                          device="cpu")
    assert_same_tree(jtree, ttree)


def test_gaussian_eval_without_a_generator_or_normals_raises():
    with pytest.raises(ValueError, match="Generator"):
        TM.gaussian_prior_eval_fn(TCFG)
    res = TM.gaussian_prior_eval_fn(TCFG, generator=torch.Generator().manual_seed(0))(init_state(TCFG, 3, "cpu"))
    torch.testing.assert_close(res.policy.sum(-1), torch.ones(3))
    assert res.policy[0].unique().numel() > 2  # not uniform
