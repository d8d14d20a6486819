"""Non-square boards through the port, held to the JAX package on the CPU
(JAX tests/test_rectangular.py's paths: the search, selfplay with the
randomized-symmetry profile, a train step with 4 symmetries, GTP's
`boardsize 5:7`). Two rectangles, 5x7 and 7x5 with win 4, x != y in both
orders, so that an axis swapped anywhere shows.

  * `run_search` under `SearchParams()` at 80 visits, with the uniform
    evaluator and with the tiny net (float32 on both sides), from the empty
    board and two positions reached by the n-th legal move: root visit
    counts, `children` and `node_count` equal, root values within 2e-4
    (tests/torch_parity.py `assert_same_search`), play-selection weights
    apart only by the ceil step of PERF.md section 2
    (tests/test_torch_search_threads.py `assert_policy_targets_match`);
  * a `for_selfplay()` segment (4 root symmetries of 4, Dirichlet noise,
    graph search) at B=8 with the tiny net, JAX's draws replayed, then
    `finalize_targets`: tests/test_torch_selfplay_segment.py's contract;
  * one train step of b1c6 (float32) on that segment's rows written and
    read back as a shard, symmetry augmentation on (JAX draws 4 symmetries
    on a rectangle) with JAX's draws injected: tests/test_torch_train_step.py's
    tolerance;
  * the GTP engine: `boardsize 5:7`, `play B C3 north`, `genmove white`,
    then `rectangular_boardsize 7 5` and on: every response identical to
    JAX's `GTPEngine` under the same seed and visits.

Each JAX configuration is compiled once in this file."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from katacoffee_tpu.command.gtp import GTPEngine as JaxGTPEngine
from katacoffee_tpu.dataio import trainingwrite as JW
from katacoffee_tpu.game import board as JB
from katacoffee_tpu.game import symmetry as JS
from katacoffee_tpu.nn import configs as JNC
from katacoffee_tpu.nn import features as JF
from katacoffee_tpu.nn import model as JNM
from katacoffee_tpu.search import mcts as JM
from katacoffee_tpu.search.params import SearchParams as JaxParams
from katacoffee_tpu.selfplay import actor as JA
from katacoffee_tpu.train import train as JT
from katacoffee_tpu_torch.command.gtp import GTPEngine
from katacoffee_tpu_torch.dataio import checkpoints as TC
from katacoffee_tpu_torch.dataio import trainingwrite as TW
from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
from katacoffee_tpu_torch.game import board as TB
from katacoffee_tpu_torch.game import symmetry as TS
from katacoffee_tpu_torch.nn import configs as TNC
from katacoffee_tpu_torch.nn import model as TNM
from katacoffee_tpu_torch.search import mcts as TM
from katacoffee_tpu_torch.search.params import SearchParams
from katacoffee_tpu_torch.selfplay import actor as TA
from katacoffee_tpu_torch.train import train as TT
from test_torch_finalize import assert_same_batch
from test_torch_search import GOLDEN_PLAN, TINYNET
from test_torch_search_threads import assert_policy_targets_match
from test_torch_selfplay_segment import (
    assert_same_states,
    assert_same_trajectory,
    jax_trajectory,
    port_settings,
    run_both,
)
from test_torch_train_step import close, jax_tree
from torch_parity import assert_same_search, jax_exported_net, jax_states, one_torch_thread  # noqa: F401

RECTS = {"5x7": (5, 7, 4), "7x5": (7, 5, 4)}
VISITS = 80


def cfgs(name):
    return JB.GameConfig(*RECTS[name]), TB.GameConfig(*RECTS[name])


def nth_legal_roots(tcfg, plan):
    """The port's roots on the CPU, one for each entry of `plan`: from the
    empty board, the n-th legal action played at each ply, as
    tests/test_torch_search.py `_nth_legal_actions` builds them on 5x5."""
    rows = []
    for moves in plan:
        s = TB.init_state(tcfg, 1, device="cpu")
        for rank, plies in moves:
            for _ in range(plies):
                legal = torch.nonzero(TB.legal_mask_flat(tcfg, s)[0]).flatten()
                s = TB.step(tcfg, s, legal[rank % len(legal)].view(1))
        rows.append(s)
    return TB.GameState(*(torch.cat(f) for f in zip(*rows)))


def late_roots(tcfg, batch, seed, empty=2):
    """`empty` empty boards, the rest 1-4 plies before the end of a random
    legal game (so that games end inside a segment)."""
    rng = np.random.default_rng(seed)
    rows = [TB.init_state(tcfg, 1, device="cpu") for _ in range(empty)]
    while len(rows) < batch:
        s, line = TB.init_state(tcfg, 1, device="cpu"), []
        while not bool(s.done[0]):
            line.append(s)
            legal = torch.nonzero(TB.legal_mask_flat(tcfg, s)[0]).flatten()
            s = TB.step(tcfg, s, legal[int(rng.integers(len(legal)))].view(1))
        rows.append(line[max(0, len(line) - int(rng.integers(1, 5)))])
    return TB.GameState(*(torch.cat(f) for f in zip(*rows)))


@functools.lru_cache(maxsize=None)
def tiny_nets():
    """(JAX net, params, the port's net), float32, of the 5x5 tiny net: a
    convolutional net, which runs on any board."""
    jnet, params = jax_exported_net(TINYNET)
    return jnet, params, load_exported_model(TINYNET, device="cpu", dtype=torch.float32)[0]


def evals(name, evaluator):
    jcfg, tcfg = cfgs(name)
    if evaluator == "uniform":
        return JM.uniform_eval_fn(jcfg), TM.uniform_eval_fn(tcfg)
    jnet, params, tnet = tiny_nets()
    return JM.make_nn_eval_fn(jcfg, jnet, params), TM.make_nn_eval_fn(tcfg, tnet)


def test_num_symmetries_as_jax():
    for shape in ((5, 5, 4), *RECTS.values(), (6, 4, 4)):
        assert TS.num_symmetries(TB.GameConfig(*shape)) == JS.num_symmetries(JB.GameConfig(*shape))
    assert [TS.num_symmetries(cfgs(n)[1]) for n in RECTS] == [4, 4]


@pytest.mark.parametrize("evaluator", ["uniform", "tinynet"])
@pytest.mark.parametrize("rect", list(RECTS))
def test_search_matches_jax(rect, evaluator):
    jcfg, tcfg = cfgs(rect)
    jev, tev = evals(rect, evaluator)
    troots = nth_legal_roots(tcfg, GOLDEN_PLAN)
    jsp, tsp = JaxParams(), SearchParams()
    jtree = jax.jit(lambda r, k: JM.run_search(jcfg, jsp, jev, r, VISITS, k))(jax_states(troots),
                                                                             jax.random.PRNGKey(0))
    ttree = TM.run_search(tcfg, tsp, tev, troots, VISITS, device="cpu")
    assert ttree.states.board.shape[-2:] == (tcfg.y_size, tcfg.x_size)
    assert ttree.prior.shape[-1] == tcfg.policy_size
    assert_same_search(jtree, ttree)
    assert (TM.root_visit_counts(ttree).sum(-1) == VISITS).all()
    assert_policy_targets_match(jsp, tsp, jtree, ttree)


@functools.lru_cache(maxsize=None)
def segment(rect):
    """JAX's and the port's for_selfplay() segment on the rectangle (B=8,
    16 visits, 6 moves, an empty board and seven late positions), the
    port's trees, and both packages' finalize_targets on the port's
    trajectory."""
    jcfg, tcfg = cfgs(rect)
    jev, tev = evals(rect, "tinynet")
    settings = JA.SelfplaySettings(num_sims=16)
    jstates = jax_states(late_roots(tcfg, 8, seed=sum(RECTS[rect]), empty=1))
    jout, tout, trees = run_both(jev, tev, settings, jstates, jax.random.PRNGKey(5), 6, cfgs=(jcfg, tcfg))
    jtraj, ttraj = jout[2], tout[2]
    jbatch = jax.jit(lambda tr: JA.finalize_targets(jcfg, settings, tr))(jax_trajectory(ttraj, jtraj))
    tbatch = TA.finalize_targets(tcfg, port_settings(settings), ttraj)
    return jout, tout, trees, jbatch, tbatch


@pytest.mark.parametrize("rect", list(RECTS))
def test_selfplay_segment_and_finalize_match_jax(rect):
    (jst, jep, jtraj), (tst, tep, ttraj), trees, jbatch, tbatch = segment(rect)
    _, tcfg = cfgs(rect)
    assert len(trees) == 6 and ttraj.final_board.shape[-2:] == (tcfg.y_size, tcfg.x_size)
    assert_same_trajectory(jtraj, ttraj, trees)
    assert_same_states(jst, tst, "new_states")
    assert np.array_equal(tep.numpy(), np.asarray(jep))
    # games ended inside the segment, and the root symmetries were drawn
    assert ttraj.done_after.any() and (trees[0].bias_table[..., 1] != 0).any()
    assert_same_batch(jbatch, tbatch)
    assert (tbatch.weight > 0).sum() >= 8


@pytest.mark.parametrize("rect", list(RECTS))
def test_train_step_on_the_segment_rows_matches_jax(rect):
    jcfg, tcfg = cfgs(rect)
    _, _, _, jbatch, tbatch = segment(rect)
    rows = TW.batch_to_arrays(tbatch, tcfg)
    # both writers tag a shard (x, y, win_len); its boards are [R, y, x]
    assert tuple(rows["board_shape"]) == (tcfg.x_size, tcfg.y_size, tcfg.win_len)
    assert np.array_equal(rows["board_shape"], JW.batch_to_arrays(jbatch, jcfg)["board_shape"])
    assert rows["board"].shape[1:] == (tcfg.y_size, tcfg.x_size)
    R = int(rows["weight"].shape[0])
    kw = dict(warmup_steps=1, symmetry_augment=True, learning_rate=0.05)
    jtc, ttc = JT.TrainConfig(**kw), TT.TrainConfig(**kw)
    spec = "b1c6"
    jmodel = JNM.CoffeeNet(dataclasses.replace(JNC.get_model_spec(spec), dtype=jnp.float32), win_len=4)
    tmodel = TNM.CoffeeNet(dataclasses.replace(TNC.get_model_spec(spec), dtype=torch.float32), 4)
    TNM.init_params(tmodel, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for p in tmodel.parameters():  # gates and biases nonzero
            p.add_(torch.from_numpy(rng.normal(0, 0.3 if p.ndim < 2 else 0.05, tuple(p.shape)).astype(np.float32)))
    tstate = TT.init_train_state(tmodel)
    # JAX's state from the port's (a template's shapes only: no JAX init)
    template = jax.eval_shape(lambda: JT.init_train_state(jmodel, jcfg, jtc, R, jax.random.PRNGKey(0)))
    jstate = serialization.from_state_dict(template, jax.tree_util.tree_map(jnp.asarray, TC.state_to_tree(tstate)))
    key = jax.random.PRNGKey(100 + R)
    syms = np.array(jax.random.randint(key, (R,), 0, JS.num_symmetries(jcfg)))
    assert set(syms) <= {0, 1, 2, 3} and len(set(syms)) > 1
    draws = TT.StepDraws(torch.from_numpy(syms), torch.from_numpy(np.array(JF.sample_history_levels(
        jax.random.fold_in(key, 0x415), R, jtc.history_keep_prob))))
    jstate, want = JT.make_train_step(jmodel, jcfg, jtc, R)(jstate, JW.rows_to_batch(rows, jcfg), key)
    tstate, got = TT.make_train_step(tcfg, ttc, R)(tstate, TW.rows_to_batch(rows, tcfg, "cpu"), draws=draws)
    assert set(got) == set(want)
    for k in want:
        close(want[k], got[k].detach(), k)
    jt, tt = TC.flatten(jax_tree(jstate)), TC.flatten(TC.state_to_tree(tstate))
    assert jt.keys() == tt.keys()
    for k in jt:
        close(jt[k], tt[k], k)
    assert np.isfinite(float(want["loss"])) and tstate.step == 1


GTP_SESSION = [
    "boardsize 5:7", "play B C3 north", "genmove white", "showboard", "kata-get-rules", "genmove black",
    "rectangular_boardsize 7 5", "play b B2 west", "genmove w", "showboard", "kata-raw-nn 0", "boardsize 5:20",
    "boardsize 1:7",
]


def test_gtp_boardsize_session_matches_jax():
    jeng = JaxGTPEngine(JB.GameConfig(5, 5, 4), JaxParams(valueWeightExponent=0.0), max_visits=4, seed=0)
    teng = GTPEngine(TB.GameConfig(5, 5, 4), SearchParams(valueWeightExponent=0.0), max_visits=4, seed=0,
                     device="cpu")
    replies = []
    for line in GTP_SESSION:
        want, got = jeng.handle(line), teng.handle(line)
        assert got == want, line
        replies.append(got[0])
    assert replies[:2] == ["=", "="] and replies[2].startswith("= ") and replies[8].startswith("= ")
    assert teng.cfg == TB.GameConfig(7, 5, 4) and replies[-1].startswith("?")
