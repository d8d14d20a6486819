"""A forced collision of K playouts a round: K = 4 on late roots with two
legal moves, so that two rows of one game meet at one interior node. There
their edge visits are summed (`_count_path_edges`) and the union backup
counts both; the trees equal the JAX package's `_simulate_round`'s (the
tinynet at float32, `SearchParams()`, 16 playouts)."""

import jax
import torch

from katacoffee_tpu_torch.search import mcts as TM
from test_torch_search import CFG, TCFG, TINYNET, _evals, _nth_legal_actions, _torch_roots
from test_torch_search_threads import assert_same_tree, params
from torch_parity import jax_search, one_torch_thread  # noqa: F401 (autouse fixture)

# late roots with two legal moves each (the n-th legal action 12-14 times)
LATE_PLAN = [[(0, 14)], [(1, 14)], [(3, 12)], [(5, 13)]]


def test_two_playouts_meeting_at_an_interior_node_are_summed_and_backed_up_together(monkeypatch):
    jsp, tsp = params("default", numSearchThreads=4)
    jev, tev = _evals(TINYNET)
    jroots = _nth_legal_actions(LATE_PLAN)
    shared, edge_sums, backup_counts = [], [], []
    count_edges, recompute = TM._count_path_edges, TM._recompute_node

    def count_recording(tree, path, acts_f, leaf_depth, act_mask):
        # the (node, action) pairs two rows of one game passed at one level
        K = path.shape[0] // tree.stats.shape[0]
        passed = (torch.arange(path.shape[1])[None, :] < leaf_depth[:, None]) & act_mask[:, None]
        passed[:, 0] = False
        for r in range(path.shape[0]):
            for j in range(r + 1, (r // K + 1) * K):
                both = passed[r] & passed[j] & (path[r] == path[j]) & (acts_f[r] == acts_f[j])
                shared.extend((r // K, int(path[r, d]), int(acts_f[r, d])) for d in torch.nonzero(both).flatten())
        before = tree.edge_visits.clone()
        count_edges(tree, path, acts_f, leaf_depth, act_mask)
        for b, n, a in shared:
            edge_sums.append(int(tree.edge_visits[b, n, a] - before[b, n, a]))
        shared.clear()

    def recompute_recording(sp, tree, node, mask, cs_raw=None, lanes=None, visit_inc=1.0, bidx=None):
        if lanes is not None and isinstance(visit_inc, torch.Tensor):
            backup_counts.extend(int(v) for v in visit_inc[mask])
        return recompute(sp, tree, node, mask, cs_raw, lanes, visit_inc, bidx)

    monkeypatch.setattr(TM, "_count_path_edges", count_recording)
    monkeypatch.setattr(TM, "_recompute_node", recompute_recording)
    jtree, _, _ = jax_search(CFG, jsp, jev, jroots, 16, jax.random.PRNGKey(3))
    ttree = TM.run_search(TCFG, tsp, tev, _torch_roots(jroots), 16, device="cpu")
    assert_same_tree(jtree, ttree)
    # an interior edge two rows passed got both their visits, and an
    # interior node two or more rows passed was recomputed once with their count
    assert edge_sums and min(edge_sums) >= 2, edge_sums
    assert max(backup_counts) >= 2, backup_counts
