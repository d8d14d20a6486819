"""The PyTorch search under `SearchParams.for_gatekeeper()` against JAX: the
two options that profile turns on, uncertainty weighting (`_eval_weight`)
and policy optimism (`_blend_policy`, the evaluator's `policy_opt`), and
whole gating searches with real nets (tinynet and b6c96 at float32 on both
sides; the profile draws nothing at the root).

Tolerances:
  * `_eval_weight` on seeded numpy inputs: within 2 ulps of JAX's;
  * `_blend_policy` on seeded numpy inputs: within
    4 * 2**-24 * (2 + |ln p|) of JAX's p, relative. The blend is
    exp((1 - o) ln p_raw + o ln p_opt), normalized; torch's and XLA's float32
    log each round within 1 ulp of the other's, and a difference d in an
    exponent of magnitude |ln p| moves the exponential by d relative, so 2
    ulps of the output cannot be had (measured: up to 31 * 2**-24 relative,
    3.4 * 2**-24 * (2 + |ln p|));
  * the evaluator's `policy_opt`, plain and under injected symmetries, and
    the eval-level `policy_optimism` blend: within 1e-5 absolute (two nets'
    float32 forwards);
  * whole searches: root visit counts, node counts and child links equal
    exactly; root values within 2e-4; the root prior within 1e-6; the moves
    `select_moves` picks with JAX's Gumbel draws equal. Node weights are
    fractional here (uncertainty); a stats row recomputed by both packages
    from the same tree stays within the rounding contract of
    tests/test_torch_search.py, 8 * 2**-24 * max(|x|, 1) (PERF.md section 2,
    item 1).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katacoffee_tpu.search import mcts as JM
from katacoffee_tpu.search.params import SearchParams as JaxParams
from katacoffee_tpu_torch.search import mcts as TM
from katacoffee_tpu_torch.search.params import SearchParams
from test_torch_search import B6C96, CFG, GOLDEN_PLAN, TCFG, TINYNET, ULP_BOUND, _evals, _nth_legal_actions, \
    _torch_roots
from torch_parity import assert_same_search, jax_search, one_torch_thread, torch_tree  # noqa: F401 (autouse fixture)

JSP, TSP = JaxParams.for_gatekeeper(), SearchParams.for_gatekeeper()
WEIGHT_PROFILES = {
    "gatekeeper": {},
    "exponent": dict(uncertaintyExponent=0.7, uncertaintyCoeff=0.2, uncertaintyMaxWeight=4.0),
    "utility_factor": dict(winLossUtilityFactor=0.8, uncertaintyExponent=2.0),
    "off": dict(useUncertainty=False),
}


@pytest.mark.parametrize("profile", list(WEIGHT_PROFILES))
def test_eval_weight_matches_jax(profile):
    kw = WEIGHT_PROFILES[profile]
    rng = np.random.default_rng(len(profile))
    err = np.concatenate([[0.0, 1e-6, 0.25, 4.0], rng.gamma(0.5, 0.3, 508)]).astype(np.float32)
    want = np.asarray(JM._eval_weight(dataclasses.replace(JSP, **kw), jnp.asarray(err)))
    got = TM._eval_weight(dataclasses.replace(TSP, **kw), torch.from_numpy(err)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=2)
    if profile != "off":
        assert (got < 1.0).any() and (got != np.round(got)).any()
        assert got.max() <= dataclasses.replace(TSP, **kw).uncertaintyMaxWeight * (1 + 1e-6)


def _policies(rng, batch, actions):
    """Softmax policies over random legal masks (some rows with one legal
    move), 0 on illegal entries."""
    legal = rng.random((batch, actions)) < 0.6
    legal[0] = False
    legal[0, 3] = True
    legal[:, 0] |= ~legal.any(-1)

    def soft(scale):
        x = np.where(legal, rng.standard_normal((batch, actions)) * scale, -np.inf)
        e = np.exp(x - x.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    return soft(2.0), soft(3.0)


@pytest.mark.parametrize("optimism", [0.0, 0.3, 1.0])
def test_blend_policy_matches_jax(optimism):
    policy, opt = _policies(np.random.default_rng(int(optimism * 10)), 64, 100)
    jres = JM.EvalResult(jnp.asarray(policy), *(jnp.zeros(64),) * 4, policy_opt=jnp.asarray(opt))
    tres = TM.EvalResult(torch.from_numpy(policy), *(torch.zeros(64),) * 4, policy_opt=torch.from_numpy(opt))
    want = np.asarray(JM._blend_policy(jres, optimism))
    got = TM._blend_policy(tres, optimism).numpy()
    assert np.array_equal(got > 0, policy > 0) and np.array_equal(want > 0, policy > 0)
    m = want > 0
    bound = 4 * 2.0**-24 * (2.0 + np.abs(np.log(want[m]))) * want[m]
    assert (np.abs(got[m] - want[m]) <= bound).all(), np.max(np.abs(got[m] - want[m]) / bound)
    if optimism == 0.0:
        assert got is policy or np.array_equal(got, policy)
    assert TM._blend_policy(tres._replace(policy_opt=None), optimism) is tres.policy


@functools.lru_cache(maxsize=None)
def _tinynet_evals(**kw):
    from test_torch_search import _tinynets
    from katacoffee_tpu.nn.model import CoffeeNet as JaxNet

    model, params, tnet = _tinynets()
    jnet = JaxNet(dataclasses.replace(model.spec, dtype=jnp.float32), win_len=CFG.win_len)
    return jax.jit(JM.make_nn_eval_fn(CFG, jnet, params, **kw)), tnet


@pytest.mark.parametrize("mode", ["plain", "symmetries", "eval_optimism"])
def test_policy_opt_matches_jax(mode):
    """The optimistic policy of the evaluator, on random positions; under
    symmetry_randomize the port is handed the symmetries JAX draws, and the
    policy_opt is inverted with the policy."""
    from test_torch_symmetry import _positions

    batch = 48
    _, _, ts, js = _positions("5x5", batch=batch, seed=7)
    kw = {"plain": {}, "symmetries": dict(symmetry_randomize=True), "eval_optimism": dict(policy_optimism=0.5)}[mode]
    jev, tnet = _tinynet_evals(**kw)
    rng = jax.random.PRNGKey(3)
    want = jev(js, rng)
    tkw = dict(kw)
    if mode == "symmetries":
        syms = torch.from_numpy(np.asarray(jax.random.randint(rng, (batch,), 0, 8)).astype(np.int64))
        assert len(set(syms.tolist())) == 8
        tkw["draw_syms"] = lambda n: syms[:n]
    got = TM.make_nn_eval_fn(TCFG, tnet, **tkw)(ts)
    for name in TM.EvalResult._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), atol=1e-5, rtol=0,
                                   err_msg=name)
    assert not torch.allclose(got.policy_opt, got.policy, atol=1e-3)
    legal = got.policy > 0
    assert torch.equal(got.policy_opt > 0, legal)
    some = legal.any(-1)
    assert some.any()
    torch.testing.assert_close(got.policy_opt.sum(-1), some.float(), atol=1e-5, rtol=0)
    assert TM.uniform_eval_fn(TCFG)(ts).policy_opt is None


def _same_gating_search(evals, plan, visits, seed):
    jev, tev = _evals(evals)
    jroots = _nth_legal_actions(plan)
    key = jax.random.PRNGKey(seed)
    jtree, _, draws = jax_search(CFG, JSP, jev, jroots, visits, key)
    assert draws.syms is None and draws.gamma is None
    ttree = TM.run_search(TCFG, TSP, tev, _torch_roots(jroots), visits, device="cpu", draws=draws)
    assert_same_search(jtree, ttree)
    np.testing.assert_allclose(ttree.root_prior.numpy(), np.asarray(jtree.root_prior), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ttree.bias_table.numpy(), np.asarray(jtree.bias_table), atol=1e-4, rtol=1e-5)
    # the weights are fractional: uncertainty weighting is on
    w = ttree.self_stats[..., TM.F_W][ttree.stats[..., TM.S_VISITS] > 0]
    assert ((w > 0) & (w < TSP.uncertaintyMaxWeight) & (w != torch.round(w))).float().mean() > 0.5
    # the move choice, with JAX's Gumbel draws
    B = jroots.board.shape[0]
    for k in range(3):
        skey = jax.random.PRNGKey(100 + k)
        gumbel = torch.from_numpy(np.asarray(jax.random.gumbel(skey, (B, CFG.policy_size))).copy())
        jact = np.asarray(JM.select_moves(CFG, JSP, jtree, skey))
        assert np.array_equal(TM.select_moves(TCFG, TSP, ttree, gumbel=gumbel).numpy(), jact)
    return jtree, ttree


def test_gatekeeper_search_matches_jax_tinynet():
    _same_gating_search(TINYNET, GOLDEN_PLAN, 80, 0)


def test_gatekeeper_search_matches_jax_b6c96_within_the_rounding_contract():
    """The b6c96 gating search, then the rounding contract's item 1 with
    fractional weights: JAX's finished tree loaded into the port, and every
    node slot below 12 recomputed by both packages from that same tree
    (`_recompute_node`, the uncertainty-weighted own evaluation and the
    subtree bias included); each row within the bound, visits exactly."""
    jtree, ttree = _same_gating_search(B6C96, GOLDEN_PLAN[1:], 48, 1)
    loaded = torch_tree(jtree)
    recompute = jax.jit(lambda t, n, m: JM._recompute_node(CFG, JSP, t, n, m).stats)
    B = ttree.stats.shape[0]
    checked = 0
    for n in range(12):
        node = np.full((B,), n, np.int32)
        mask = (n < np.asarray(jtree.node_count)) & ~np.asarray(jtree.is_terminal)[:, n]
        want = np.asarray(recompute(jtree, jnp.asarray(node), jnp.asarray(mask)))[:, n]
        tree = loaded._replace(stats=loaded.stats.clone(), bias_table=loaded.bias_table.clone(),
                               last_bias_delta=loaded.last_bias_delta.clone(),
                               last_bias_weight=loaded.last_bias_weight.clone())
        TM._recompute_node(TSP, tree, torch.from_numpy(node.astype(np.int64)), torch.from_numpy(mask))
        got = tree.stats[:, n].numpy()
        assert np.array_equal(got[:, TM.S_VISITS], want[:, TM.S_VISITS])
        assert (np.abs(got - want) <= ULP_BOUND * np.maximum(np.abs(want), 1.0)).all(), (n, got, want)
        checked += int(mask.sum())
    assert checked >= 2 * B
