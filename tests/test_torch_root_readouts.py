"""The selfplay profile's root prior, root evaluation and readouts in the
PyTorch search against JAX (`SearchParams.for_selfplay()` unless named).

* Root prior (`_make_root_prior`, `_add_dirichlet_noise`) on the same
  policy, turn numbers and gamma sample: within 1e-6 (float32 exp, log and
  row sums in another order, on probabilities of order 1).
* Root evaluation with 4 sampled symmetries, injected: within 1e-6 (the
  tinynet's forward in the two frameworks differs in the last bits).
* Readouts on trees the port built, loaded into JAX: `select_moves` with
  JAX's Gumbel noise chooses the same moves; `policy_target`,
  `root_child_weights` and the LCB inputs within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katacoffee_tpu.search import mcts as JM
from katacoffee_tpu.search.params import SearchParams as JaxParams
from katacoffee_tpu_torch.search import mcts as TM
from katacoffee_tpu_torch.search.params import SearchParams
from test_torch_search import CFG, GOLDEN_PLAN, TCFG, TINYNET, _evals, _nth_legal_actions, _torch_roots
from torch_parity import jax_tree, one_torch_thread, recorded_gamma, symmetry_draws  # noqa: F401 (autouse fixture)

JSP, TSP = JaxParams.for_selfplay(), SearchParams.for_selfplay()
TOL = 1e-6


def _root_inputs():
    jev, _ = _evals(TINYNET)
    jroots = _nth_legal_actions(GOLDEN_PLAN)
    legal = np.asarray(jax.vmap(lambda s: JM.legal_mask_flat(CFG, s))(jroots))
    policy = np.array(jev(jroots, jax.random.PRNGKey(0)).policy)
    return jroots, legal, policy


@pytest.mark.parametrize("turns", [(0, 0, 0), (3, 11, 40)])
def test_root_prior_matches_jax(turns):
    """Temperature (interpolated by turn number), Dirichlet noise with JAX's
    gamma sample, and the hint shift (a hint on two games)."""
    jroots, legal, policy = _root_inputs()
    turn = np.asarray(turns, np.float32)
    hint = np.where(legal, policy, np.inf).argmin(-1)
    hint[1] = -1
    args = (jnp.asarray(policy), jnp.asarray(legal), jroots)
    for jsp, tsp in ((JaxParams(rootPolicyTemperature=1.1, rootPolicyTemperatureEarly=1.25),
                      SearchParams(rootPolicyTemperature=1.1, rootPolicyTemperatureEarly=1.25)), (JSP, TSP)):
        key = jax.random.PRNGKey(int(turn.sum()))
        with recorded_gamma() as calls:
            want = JM._make_root_prior(CFG, jsp, *args, key, jnp.asarray(turn), jnp.asarray(hint, jnp.int32))
        gamma = torch.from_numpy(calls[0][1].copy()) if calls else None
        got = TM._make_root_prior(TCFG, tsp, torch.from_numpy(policy), torch.from_numpy(legal),
                                  _torch_roots(jroots), gamma=gamma, turn_number=torch.from_numpy(turn),
                                  root_hint=torch.from_numpy(hint))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
        assert np.array_equal(got.numpy() < 0, ~legal)
    with recorded_gamma() as calls:
        want = JM._add_dirichlet_noise(JSP, key, jnp.asarray(policy), jnp.asarray(legal))
    noisy = TM._add_dirichlet_noise(TSP, torch.from_numpy(policy), torch.from_numpy(legal),
                                    gamma=torch.from_numpy(calls[0][1].copy()))
    np.testing.assert_allclose(noisy.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_root_eval_with_sampled_symmetries_matches_jax():
    jev, tev = _evals(TINYNET)
    jroots = _nth_legal_actions(GOLDEN_PLAN)
    key = jax.random.PRNGKey(9)
    want = JM._root_eval(CFG, JSP, jev, jroots, key)
    syms = symmetry_draws(CFG, JSP, key, jroots.board.shape[0])
    assert syms.shape == (3, 4) and all(len(set(r.tolist())) == 4 for r in syms)
    got = TM._root_eval(TCFG, TSP, tev, _torch_roots(jroots), syms=syms)
    for name in TM.EvalResult._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), atol=TOL, rtol=0,
                                   err_msg=name)
    # the generator's draw: k distinct symmetries per game
    g = torch.Generator().manual_seed(0)
    drawn = TM._root_eval(TCFG, TSP, tev, _torch_roots(jroots), generator=g)
    assert torch.isfinite(drawn.policy).all()


@pytest.fixture(scope="module")
def port_trees():
    """Trees the port built under for_selfplay (tinynet, 48 visits) and one
    with no playout."""
    _, tev = _evals(TINYNET)
    roots = _torch_roots(_nth_legal_actions(GOLDEN_PLAN))
    g = torch.Generator().manual_seed(2)
    searched = TM.run_search(TCFG, TSP, tev, roots, 48, 16, device="cpu", generator=g)
    empty = TM.run_search(TCFG, TSP, tev, roots, 0, 16, device="cpu", generator=g)
    return searched, empty


@pytest.mark.parametrize("case", ["selfplay", "selfplay_late", "greedy", "fallback"])
def test_readouts_match_jax(port_trees, case):
    """select_moves (LCB, the temperature by turn number, the greedy and
    the fallback branches), policy_target and root_child_weights."""
    searched, empty = port_trees
    tree = empty if case == "fallback" else searched
    jsp, tsp = (JaxParams(), SearchParams()) if case == "greedy" else (JSP, TSP)
    turn = np.full((3,), 60 if case == "selfplay_late" else 0, np.int32)
    jt = jax_tree(tree)
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(JM.select_moves(CFG, jsp, jt, key, turn_number=jnp.asarray(turn)))
        gumbel = torch.from_numpy(np.asarray(jax.random.gumbel(key, (3, CFG.policy_size))).copy())
        got = TM.select_moves(TCFG, tsp, tree, gumbel=gumbel, turn_number=torch.from_numpy(turn))
        assert np.array_equal(got.numpy(), want), (seed, got, want)
    np.testing.assert_allclose(TM.policy_target(tree, tsp).numpy(), np.asarray(JM.policy_target(jt, jsp)),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(TM.root_child_weights(tree).numpy(), np.asarray(JM.root_child_weights(jt)),
                               atol=TOL, rtol=0)
    u, stdev, w = TM._child_utility_stdev(tree)
    ju, jstdev, jw = JM._child_utility_stdev(jt)
    for a, b in ((u, ju), (stdev, jstdev), (w, jw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=1e-6)
