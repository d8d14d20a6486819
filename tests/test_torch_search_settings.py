"""Each search setting the port took in its selfplay slice, turned on alone
over `SearchParams()`, against JAX. Tinynet at float32 on both sides, the
JAX side's root draws passed to the port (tests/torch_parity.py).

* Graph search, the subtree value bias and the rootHintLoc argument act in
  every playout: the whole `run_search` is compared. Root visit counts, node
  counts and child links equal exactly, root values within 2e-4 (float32
  sums in another order over a whole search); the bias table within 1e-5.
* Root noise, sampled root symmetries and the root policy temperatures act
  only at the root: `init_tree` is compared (the search from a given root
  prior is the default profile's, held to JAX in tests/test_torch_search.py).
  The root prior and the root's stats row within 1e-6 (float32 exp, log and
  row sums in another order; the tinynet's forward differs in the last
  bits)."""

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
from torch_parity import (  # noqa: F401 (one_torch_thread: autouse fixture)
    assert_same_search,
    jax_search,
    one_torch_thread,
    recorded_gamma,
    symmetry_draws,
)

VISITS = 40
SEARCH_SETTINGS = {
    "useGraphSearch": dict(useGraphSearch=True),
    "subtreeValueBiasFactor": dict(subtreeValueBiasFactor=0.3, subtreeValueBiasWeightExponent=0.8),
}
ROOT_SETTINGS = {
    "rootNoiseEnabled": dict(rootNoiseEnabled=True),
    "rootNumSymmetriesToSample": dict(rootNumSymmetriesToSample=4),
    "rootPolicyTemperature": dict(rootPolicyTemperature=1.1, rootPolicyTemperatureEarly=1.25),
}


@pytest.mark.parametrize("name", list(SEARCH_SETTINGS) + list(ROOT_SETTINGS))
def test_settings_ported_in_this_slice_match_jax(name):
    kw = {**SEARCH_SETTINGS, **ROOT_SETTINGS}[name]
    jev, tev = _evals(TINYNET)
    jroots = _nth_legal_actions(GOLDEN_PLAN)
    if name in ROOT_SETTINGS:
        jsp = JaxParams(**kw)
        key = jax.random.PRNGKey(1)
        with recorded_gamma() as calls:
            jtree = jax.jit(lambda r, k: JM.init_tree(CFG, jsp, jev, r, 8, k))(jroots, key)
            jax.effects_barrier()
        k_eval, _ = jax.random.split(key)
        draws = TM.RootDraws(syms=symmetry_draws(CFG, jsp, k_eval, jroots.board.shape[0]),
                             gamma=torch.from_numpy(calls[0][1].copy()) if calls else None)
        assert (draws.syms is None) == (name != "rootNumSymmetriesToSample")
        assert bool(calls) == (name == "rootNoiseEnabled")
        ttree = TM.init_tree(TCFG, SearchParams(**kw), tev, _torch_roots(jroots), 8, draws=draws)
        for field in ("root_prior", "prior", "stats", "self_stats"):
            np.testing.assert_allclose(getattr(ttree, field).numpy(), np.asarray(getattr(jtree, field)),
                                       atol=1e-6, rtol=0, err_msg=field)
        return
    jtree, _, draws = jax_search(CFG, JaxParams(**kw), jev, jroots, VISITS, jax.random.PRNGKey(1))
    ttree = TM.run_search(TCFG, SearchParams(**kw), tev, _torch_roots(jroots), VISITS, device="cpu",
                          draws=draws)
    assert_same_search(jtree, ttree)
    if name == "subtreeValueBiasFactor":
        np.testing.assert_allclose(ttree.bias_table.numpy(), np.asarray(jtree.bias_table), atol=1e-5, rtol=1e-5)
        assert (ttree.bias_table[..., 1] > 0).any()


def test_root_hint_matches_jax():
    """rootHintLoc: the 2 % policy shift and the forced selection at the
    root, with a hint on two games and none on the third."""
    jev, tev = _evals(TINYNET)
    jroots = _nth_legal_actions(GOLDEN_PLAN)
    legal = np.asarray(jax.vmap(lambda s: JM.legal_mask_flat(CFG, s))(jroots))
    prior = np.asarray(jev(jroots, jax.random.PRNGKey(0)).policy)
    # the least likely legal move, so that the forcing shows
    hint = np.where(legal, prior, np.inf).argmin(-1)
    hint[2] = -1
    sp = dict(rootDesiredPerChildVisitsCoeff=2.0)
    jtree = jax.jit(lambda r, k: JM.run_search(CFG, JaxParams(**sp), jev, r, VISITS, k,
                                               root_hint=jnp.asarray(hint, jnp.int32)))(
        jroots, jax.random.PRNGKey(0))
    ttree = TM.run_search(TCFG, SearchParams(**sp), tev, _torch_roots(jroots), VISITS, device="cpu",
                          root_hint=torch.from_numpy(hint))
    assert_same_search(jtree, ttree)
    hv = TM.root_visit_counts(ttree)[torch.arange(2), torch.from_numpy(hint[:2])]
    assert (hv > 0).all(), "the hint moves were not visited"
