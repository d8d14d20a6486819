"""The port's perf-accounting counters (`katacoffee_tpu_torch.utils.perfcount`
and `run_search(with_diag=True)`) on the CPU, held to what JAX
tests/test_perfcount.py asserts of the JAX ones, and each count equal to
the JAX function's on the same cycle: the diag channel is a pure
observer (every tensor of the tree identical with it on), a fresh search
runs exactly num_sims rounds at occupancy 1, reused searches run at most as
many, and the counters reconcile (rows = B x rounds, at most one row a
delivered visit). `flops_accounting` counts FLOPs with FlopCounterMode (the
tiny net's forward at least its first convolution's, a 3-playout search at
least its four forwards') and reports no bytes; the CPU has no peaks."""

import numpy as np
import torch

from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
from katacoffee_tpu_torch.game.board import GameConfig, init_state
from katacoffee_tpu_torch.nn.features import extract_features
from katacoffee_tpu_torch.search import mcts
from katacoffee_tpu_torch.search.params import SearchParams
from katacoffee_tpu_torch.utils import perfcount
from test_torch_search import TINYNET
from torch_parity import jax_exported_net, one_torch_thread  # noqa: F401 (autouse fixture)

CFG = GameConfig(5, 5, 4)


def _leaves(tree):
    for x in tree:
        yield from (x if isinstance(x, tuple) else (x,))


def test_with_diag_is_a_pure_observer():
    sp = SearchParams.for_tests_v2()
    ev = mcts.uniform_eval_fn(CFG)
    B, V = 8, 40
    states = init_state(CFG, B, "cpu")
    t0 = mcts.run_search(CFG, sp, ev, states, V, 64, device="cpu")
    t1, diag = mcts.run_search(CFG, sp, ev, states, V, 64, device="cpu", with_diag=True)
    for a, b in zip(_leaves(t0), _leaves(t1), strict=True):
        assert torch.equal(a, b)
    assert int(diag["rounds"]) == V
    np.testing.assert_allclose(diag["start_visits"].numpy(), 1.0)


def test_search_counters_reconcile():
    c = perfcount.search_counters(CFG, SearchParams.for_tests_v2(), mcts.uniform_eval_fn(CFG), init_state,
                                  batch_size=8, num_sims=30, moves=4, seed=1, device="cpu")
    assert c["rounds_per_move"][0] == 30  # fresh search: one round per sim
    assert c["occupancy_per_move"][0] == 1.0
    # reuse engages: later moves start with reused visits, so rounds can
    # only shrink and delivered visits cost at most one row each
    assert all(r <= 30 for r in c["rounds_per_move"][1:])
    assert c["visits_per_nn_row"] >= 1.0
    assert c["nn_rows_submitted"] == 8 * sum(c["rounds_per_move"])
    assert all(0.0 < o <= 1.0 for o in c["occupancy_per_move"])
    assert c["visits_delivered"] == 8 * 30 * 4 and len(c["mean_reused_visits"]) == 4
    assert c["mean_reused_visits"][0] == 1.0 and max(c["mean_reused_visits"][1:]) > 1.0


def test_search_counters_match_jax():
    """The same cycle in both packages on the tiny net at float32
    (for_tests_v2(): no search or move choice draws anything) gives every
    count equal: rounds, occupancy, rows, delivered and reused visits. Only
    the wall times differ. The net's priors make the moves' subtrees differ,
    so reusing the wrong child shows in the counts."""
    import katacoffee_tpu.utils.perfcount as jax_perfcount
    from katacoffee_tpu.game.board import GameConfig as JaxConfig
    from katacoffee_tpu.game.board import init_state as jax_init_state
    from katacoffee_tpu.search import SearchParams as JaxParams
    from katacoffee_tpu.search import make_nn_eval_fn as jax_make_nn_eval_fn

    jcfg = JaxConfig(5, 5, 4)
    jnet, params = jax_exported_net(TINYNET)
    want = jax_perfcount.search_counters(jcfg, JaxParams.for_tests_v2(), jax_make_nn_eval_fn(jcfg, jnet, params),
                                         jax_init_state, batch_size=4, num_sims=24, moves=4, seed=2)
    net = load_exported_model(TINYNET, device="cpu", dtype=torch.float32)[0]
    got = perfcount.search_counters(CFG, SearchParams.for_tests_v2(), mcts.make_nn_eval_fn(CFG, net), init_state,
                                    batch_size=4, num_sims=24, moves=4, seed=2, device="cpu")
    walls = {"wall_s_reused_moves", "nn_rows_per_sec"}
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in walls} == {k: v for k, v in want.items() if k not in walls}
    assert max(got["mean_reused_visits"][1:]) > 1.0


def test_flops_accounting_counts_flops_and_no_bytes():
    net = load_exported_model(TINYNET, device="cpu", dtype=torch.float32)[0]
    B = 4
    states = init_state(CFG, B, "cpu")
    forward = lambda: net(*extract_features(CFG, states))  # noqa: E731
    ev = mcts.make_nn_eval_fn(CFG, net)
    segment = lambda: mcts.run_search(CFG, SearchParams(), ev, states, 3, device="cpu")  # noqa: E731
    out = perfcount.flops_accounting(segment, forward, B, seg_wall_s=0.5, device="cpu")
    per_row = out["nn_forward_flops_per_row"]
    # the root evaluation plus one a simulation, each a B-row forward, and
    # the search's own products
    assert per_row > 0 and 4 * B * per_row <= out["segment_flops"] < 5 * B * per_row
    assert out["segment_bytes_accessed"] is None and out["hbm_utilization_upper_bound"] is None
    assert out["device_kind"] == "cpu" and out["peak_bf16_flops"] == 0.0 and "mfu" not in out
    assert out["achieved_flops_per_s"] == round(out["segment_flops"] / 0.5, 1)
    # 3x3 convolutions dominate: 2 * 9 * C_in * C_out * 25 FLOPs a row each
    first = net.conv0.weight.shape
    assert per_row >= 2 * first[0] * first[1] * first[2] * first[3] * CFG.area
    assert perfcount.device_peaks("cpu") == (0.0, 0.0)
