"""Tree-position recording of the PyTorch port (`selfplay/treerecord.py`)
against the JAX package's on the same tree: a JAX search tree converted with
`torch_tree`, the played and fork moves excluded at the root, one game not
recorded. Recorded states and validity equal exactly, policy and value
targets within 1e-6."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from katacoffee_tpu.selfplay import treerecord as JT
from katacoffee_tpu_torch.selfplay import treerecord as TT
from test_torch_finalize import to_torch
from test_torch_search import CFG, TCFG, _evals
from test_torch_selfplay_segment import JSP, assert_same_states, late_positions
from torch_parity import jax_search, one_torch_thread, torch_tree  # noqa: F401


@functools.lru_cache(maxsize=None)
def _searched_tree():
    """A JAX search tree; the uniform evaluator's equal priors give equal
    visit counts, which the recording's top-k breaks by index."""
    jev, _ = _evals("uniform")
    jroots = late_positions(4, seed=7, empty=2)
    jtree, _, _ = jax_search(CFG, JSP, jev, jroots, 40, jax.random.PRNGKey(9), max_nodes=20)
    return jtree


@pytest.mark.parametrize("threshold", [1, 4])
def test_record_tree_positions_matches_jax(threshold):
    jtree = _searched_tree()
    excl0 = jnp.asarray([-1, 3, 50, -1], jnp.int32)
    excl1 = jnp.asarray([-1, -1, 7, 20], jnp.int32)
    row_ok = jnp.asarray([True, True, True, False])
    want = jax.jit(lambda tr, a, b, ok: JT.record_tree_positions(CFG, tr, a, b, ok, threshold, 8))(
        jtree, excl0, excl1, row_ok)
    got = TT.record_tree_positions(TCFG, torch_tree(jtree), to_torch(excl0), to_torch(excl1), to_torch(row_ok),
                                   threshold, 8)
    assert_same_states(want[0], got[0], "recorded states")
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    for a, b in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    assert got[3][:3].any() and not got[3][3].any()
