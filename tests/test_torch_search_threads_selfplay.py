"""K playouts a round under the selfplay profile (`for_selfplay()`: graph
search, root noise and symmetries, forced playouts, the subtree value bias),
held to the JAX package as tests/test_torch_search_threads.py holds the
default profile."""

import pytest

from test_torch_search_threads import check_fresh_search
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("K", [2, 3])
def test_fresh_selfplay_search_with_k_playouts_a_round_matches_jax(K):
    check_fresh_search("selfplay", K)
