"""The port's engine facade (`katacoffee_tpu_torch.program.engine.Engine`)
against the JAX package's on the tiny net at float32 on both sides, under
`for_tests_v2()` with rootSymmetryPruning (the GTP engine's search): the
moves `genmove` plays, the analysis rows (visits, order, PV,
is_symmetry_of, winrate, lcb), a ponder followed by a genmove that reuses
its tree, the serving cache's hit and miss counts and the tree-averaged
ownership. `search/timecontrols.py` and `game/io.py`, plain Python copied
into the port, are compared function for function on a grid of inputs.

The serving cache (`NNResultCache`, `make_cached_raw_forward_fn`) is held to
JAX tests/test_serving_cache.py's three contracts: hits and misses with the
rows returned exactly, a key that changes with the last move and with the
order of the earlier moves, and LRU eviction at capacity 2; then one state
sequence goes through JAX's cache and the port's, which count the same hits
and misses after every call.

The engines draw only in the move choice, at temperature 0 (the greedy
move), so the two are the same computation. Floats of the analysis rows are
held within 2e-4 (float32 sums of another order over a whole search, as
tests/torch_parity.py `assert_same_search`), the ownership maps within
1e-5."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katacoffee_tpu.game import io as jio
from katacoffee_tpu.program.engine import Engine as JaxEngine
from katacoffee_tpu.search import mcts as JM
from katacoffee_tpu.search import ownership as jown
from katacoffee_tpu.search import timecontrols as jtc
from katacoffee_tpu.search.params import SearchParams as JaxParams
from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
from katacoffee_tpu_torch.game import board as TB
from katacoffee_tpu_torch.game import io as tio
from katacoffee_tpu_torch.program.engine import Engine
from katacoffee_tpu_torch.search import mcts as TM
from katacoffee_tpu_torch.search import ownership as town
from katacoffee_tpu_torch.search import timecontrols as ttc
from katacoffee_tpu_torch.search.params import SearchParams
from test_torch_search import CFG, TCFG, TINYNET
from torch_parity import jax_exported_net, jax_states, one_torch_thread, torch_tree  # noqa: F401 (autouse fixture)

VISITS = 32
KW = dict(rootSymmetryPruning=True)


@functools.lru_cache(maxsize=None)
def _nets():
    """(JAX net, params, the port's net), float32."""
    jnet, params = jax_exported_net(TINYNET)
    return jnet, params, load_exported_model(TINYNET, device="cpu", dtype=torch.float32)[0]


def _engines():
    jnet, params, tnet = _nets()
    jeng = JaxEngine(CFG, dataclasses.replace(JaxParams.for_tests_v2(), **KW), JM.make_nn_eval_fn(CFG, jnet, params))
    teng = Engine(TCFG, dataclasses.replace(SearchParams.for_tests_v2(), **KW), TM.make_nn_eval_fn(TCFG, tnet),
                  device="cpu")
    return jeng, teng


def _assert_same_analysis(jres, tres):
    assert tres.root_visits == jres.root_visits
    assert abs(tres.root_winrate - jres.root_winrate) <= 2e-4
    assert len(tres.move_infos) == len(jres.move_infos) > 0
    for j, t in zip(jres.move_infos, tres.move_infos):
        assert (t.move, t.action, t.visits, t.order, t.pv, t.pv_visits, t.is_symmetry_of, t.symmetry) == (
            j.move, j.action, j.visits, j.order, j.pv, j.pv_visits, j.is_symmetry_of, j.symmetry)
        for k in ("winrate", "lcb", "utility", "prior", "weight"):
            assert abs(getattr(t, k) - getattr(j, k)) <= 2e-4, (t.move, k)


def test_genmove_and_analysis_match_jax():
    """Three genmoves from the empty board, then an analysis: on the empty
    board root symmetry pruning searches one move per orbit and the rows
    come back duplicated over the stabilizer."""
    jeng, teng = _engines()
    for ply in range(3):
        ja, jres = jeng.genmove(VISITS)
        ta, tres = teng.genmove(VISITS)
        assert ta == ja, ply
        _assert_same_analysis(jres, tres)
        if ply == 0:
            assert any(mi.is_symmetry_of for mi in tres.move_infos)
    assert teng.move_history == jeng.move_history
    _assert_same_analysis(jeng.analyze(VISITS, max_moves=4), teng.analyze(VISITS, max_moves=4))
    tree = teng.last_tree
    assert teng.print_tree(tree, max_depth=2).splitlines()[0] == jeng.print_tree(max_depth=2).splitlines()[0]


def test_ponder_then_genmove_reuses_the_tree_as_jax():
    """With reuse on (ponderingEnabled): a ponder of 48 visits in chunks of
    16, then a genmove of 32 visits starts from the pondered root (it does
    not search further) and plays the same move; after the move the tree
    is carried through it by advance_root, and the next genmove continues
    from the reused subtree."""
    jeng, teng = _engines()
    for eng in (jeng, teng):
        eng.reuse_enabled = True
        eng.min_reuse_cap = eng._bucket_cap(64)
    jdone = [d for _, d in jeng.ponder_stream(48, 16)]
    tdone = [d for _, d in teng.ponder_stream(48, 16)]
    assert tdone == jdone and tdone[-1] == 49
    ja, jres = jeng.genmove(VISITS)
    ta, tres = teng.genmove(VISITS)
    assert ta == ja and tres.root_visits == jres.root_visits == 49
    _assert_same_analysis(jres, tres)
    reused = int(teng._reuse[0].stats[0, 0, TM.S_VISITS])
    assert reused == int(np.asarray(jeng._reuse[0].visits[0, 0])) and reused > 1
    ja, jres = jeng.genmove(VISITS)
    ta, tres = teng.genmove(VISITS)
    assert ta == ja
    _assert_same_analysis(jres, tres)


def test_avoid_in_genmove_matches_jax():
    """genmove_analyze's avoid path: the root mask and the depth mask go
    through the streamed search."""
    jeng, teng = _engines()
    avoid_until = np.zeros((2, CFG.policy_size), np.int32)
    avoid_until[0, 12] = 2  # C3 north for black at depths 0-1
    avoid_until[1, :40] = 3
    avoid = avoid_until[0] > 0
    ja, jres = jeng.genmove(VISITS, avoid=avoid, avoid_until=avoid_until)
    ta, tres = teng.genmove(VISITS, avoid=avoid, avoid_until=avoid_until)
    assert ta == ja != 12
    _assert_same_analysis(jres, tres)


def test_nn_result_cache_counts_and_heads_match_jax():
    jnet, params, tnet = _nets()
    jcache = JM.make_cached_raw_forward_fn(CFG, jnet, params, capacity=3)
    tcache = TM.make_cached_raw_forward_fn(TCFG, tnet, capacity=3)
    jeng, teng = _engines()
    jstates, tstates = [jeng.state], [teng.state]
    for rank in (12, 5, 3):
        a = int(np.flatnonzero(teng.legal_actions())[rank])
        jeng.play(*jio.parse_loc(jio.action_to_string(a, CFG), CFG))
        teng.play(*tio.parse_loc(tio.action_to_string(a, TCFG), TCFG))
        jstates.append(jeng.state)
        tstates.append(teng.state)

    def batch_j(idx):
        return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[jstates[i] for i in idx])

    def batch_t(idx):
        return TM.GameState(*(torch.cat(f) for f in zip(*[tstates[i] for i in idx])))

    # capacity 3: [2, 3] evicts the least recently used row (1), so the
    # last [0] hits and [1] would miss
    for idx in ([0], [0], [0, 1], [1, 0], [2, 3], [0]):
        jout, tout = jcache(batch_j(idx)), tcache(batch_t(idx))
        for k in ("policy_logits", "value_logits", "ownership", "shortterm_error"):
            np.testing.assert_allclose(tout[k], np.asarray(jout[k]), atol=1e-5, rtol=0, err_msg=k)
        assert (tcache.hits, tcache.misses) == (jcache.hits, jcache.misses), idx
    assert (tcache.hits, tcache.misses) == (4, 5)


def _cache_states(actions_list):
    """The port's states on the CPU, one row for each action prefix, each
    reached from the empty board."""
    rows = []
    for actions in actions_list:
        st = TB.init_state(TCFG, 1, device="cpu")
        for a in actions:
            st = TB.step(TCFG, st, torch.tensor([a]))
        rows.append(st)
    return TB.GameState(*(torch.cat(f) for f in zip(*rows)))


def _with_ring(states, edits):
    """`states` with entries of the recent-move ring replaced: edits maps
    (row, slot) to a spot."""
    ring = states.recent_spots.clone()
    for (row, slot), spot in edits.items():
        ring[row, slot] = spot
    return states._replace(recent_spots=ring)


def _fake_forward(calls):
    """A forward that records its batch sizes and returns heads computed
    from the position (numpy, as the raw forwards return them)."""
    def forward(states):
        calls.append(int(states.board.shape[0]))
        s = np.asarray(states.board).sum(axis=(1, 2)).astype(np.float32)
        return {"policy_logits": np.tile(s[:, None], (1, TCFG.policy_size)),
                "value_logits": np.tile(s[:, None], (1, 3))}

    return forward


def test_cache_hits_and_exactness():
    calls = []
    cache = TM.NNResultCache(_fake_forward(calls), capacity=8)
    st = _cache_states([[0], [1], [2]])
    out1 = cache(st)
    assert cache.misses == 3 and cache.hits == 0 and calls == [3]
    out2 = cache(st)  # every row hits: no forward
    assert calls == [3] and cache.hits == 3
    for k in out1:
        np.testing.assert_array_equal(out1[k], out2[k])

    # the same stones and another last move: another key (the ring's slot 0
    # is the last move; built directly, since the line rule fixes the order)
    base = _cache_states([[0, 26]])
    st_a, st_b = _with_ring(base, {(0, 0): 1}), _with_ring(base, {(0, 0): 0})
    assert torch.equal(st_a.board, st_b.board)
    cache(st_a)
    n_calls = len(calls)
    cache(st_b)
    assert len(calls) == n_calls + 1, "another last move must miss"

    # the same stones and last move, the earlier moves in another order:
    # the features read recent moves 1-4, so another key
    st_c, st_d = _with_ring(st_a, {(0, 1): 5, (0, 2): 7}), _with_ring(st_a, {(0, 1): 7, (0, 2): 5})
    cache(st_c)
    n_calls = len(calls)
    cache(st_d)
    assert len(calls) == n_calls + 1, "another history order must miss"


def test_cache_lru_eviction():
    cache = TM.NNResultCache(lambda states: {"x": np.zeros((states.board.shape[0], 1))}, capacity=2)
    s0, s1, s2 = _cache_states([[0]]), _cache_states([[1]]), _cache_states([[2]])
    cache(s0)
    cache(s1)
    cache(s0)  # s0 becomes the most recent
    cache(s2)  # evicts s1, the least recent
    m = cache.misses
    cache(s0)
    assert cache.misses == m  # s0 is still cached
    cache(s1)
    assert cache.misses == m + 1  # s1 was evicted


def test_cached_raw_forward_is_the_direct_forward():
    """The tiny net behind the cache: the cached rows bit-equal to the
    direct forward's, the second query served from the host."""
    tnet = _nets()[2]
    direct = TM.make_raw_forward_fn(TCFG, tnet)
    cached = TM.make_cached_raw_forward_fn(TCFG, tnet)
    st = _cache_states([[3], [7]])
    want = direct(st)
    got1, got2 = cached(st), cached(st)
    assert cached.hits == 2 and cached.misses == 2
    for k in want:
        np.testing.assert_array_equal(want[k], got1[k])
        np.testing.assert_array_equal(got1[k], got2[k])


def test_cache_counts_match_jax_on_one_state_sequence():
    """One sequence of batches, with ring variants and evictions at
    capacity 2, through JAX's cache and the port's: the same hits and
    misses after every call, the same rows."""
    jcalls, tcalls = [], []
    jcache = JM.NNResultCache(_fake_forward(jcalls), capacity=2)
    tcache = TM.NNResultCache(_fake_forward(tcalls), capacity=2)
    base = _cache_states([[0, 26], [1], [2]])
    variants = [base, _with_ring(base, {(0, 0): 1}), _with_ring(base, {(0, 1): 5, (0, 2): 7}),
                _with_ring(base, {(0, 1): 7, (0, 2): 5})]

    def rows(v, idx):
        return variants[v].map(lambda x: x[list(idx)])

    sequence = [(0, [0]), (0, [0]), (0, [1, 2]), (1, [0]), (0, [0]), (2, [0]), (3, [0]), (2, [0]), (0, [2, 1]),
                (0, [1]), (0, [0, 1]), (3, [0])]
    for v, idx in sequence:
        st = rows(v, idx)
        jout, tout = jcache(jax_states(st)), tcache(st)
        assert (tcache.hits, tcache.misses) == (jcache.hits, jcache.misses), (v, idx)
        for k in jout:
            np.testing.assert_array_equal(tout[k], np.asarray(jout[k]))
    assert tcalls == jcalls and tcache.hits > 0 and tcache.misses > tcache.hits


def test_tree_ownership_matches_jax():
    """JAX's searched tree in both packages' ownership: the per-node maps
    from each package's raw forward, the proportion walk and the average
    and stdev over the root's subtree and over a child's."""
    jnet, params, tnet = _nets()
    jeng, _ = _engines()
    jeng.play(2, 2, 0)
    jtree = jeng.search(VISITS)
    ttree = torch_tree(jax.tree_util.tree_map(np.asarray, jtree))
    jmaps = jown.node_ownership_maps(JM.make_raw_forward_fn(CFG, jnet, params), jtree, 0)
    tmaps = town.node_ownership_maps(TM.make_raw_forward_fn(TCFG, tnet), ttree, 0)
    live = int(np.asarray(jtree.node_count)[0])
    np.testing.assert_allclose(tmaps[:live], jmaps[:live], atol=1e-5, rtol=0)
    child = int(np.flatnonzero(np.asarray(jtree.edge_visits[0, 0]))[0])
    node = int(np.asarray(jtree.children[0, 0, child]))
    for n in (0, node):
        javg, jstd = jown.tree_ownership(jtree, 0, jmaps, n, want_stdev=True)
        tavg, tstd = town.tree_ownership(ttree, 0, tmaps, n, want_stdev=True)
        np.testing.assert_allclose(tavg, javg, atol=1e-5, rtol=0)
        np.testing.assert_allclose(tstd, jstd, atol=1e-5, rtol=0)


def test_timecontrols_match_jax():
    """Every function of the copy against JAX's on a grid: the budget and
    clock updates of each system, the visit cap, the shaping, the early
    interpolation and the futility test."""
    systems = [
        ("none", (), {}),
        ("absolute", (60.0,), {}),
        ("fischer", (30.0, 5.0), {}),
        ("byo_yomi", (20.0, 5.0, 3), {}),
        ("byo_yomi", (0.0, 10.0, 4), dict(per_stone=True)),
    ]
    for name, args, kw in systems:
        make = {"none": lambda: None, "absolute": "absolute", "fischer": "fischer", "byo_yomi": "byo_yomi"}[name]
        if make is None or name == "none":
            j, t = jtc.TimeControls(), ttc.TimeControls()
        else:
            j, t = getattr(jtc.TimeControls, make)(*args, **kw), getattr(ttc.TimeControls, make)(*args, **kw)
        for used in (0.5, 3.0, 12.0, 25.0):
            for moves_left, lag in ((12, 0.2), (3, 1.0), (40, 0.0)):
                assert t.time_for_move(moves_left, lag) == j.time_for_move(moves_left, lag)
            j.update_after_move(used)
            t.update_after_move(used)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for budget in (math.inf, 0.0, 0.7, 3.2):
        for vps in (10.0, 250.0):
            assert ttc.visits_for_time(budget, vps, 400) == jtc.visits_for_time(budget, vps, 400)
    sps = [(JaxParams(), SearchParams()),
           *((dataclasses.replace(JaxParams(), **kw), dataclasses.replace(SearchParams(), **kw)) for kw in (
               dict(midgameTimeFactor=2.0, obviousMovesTimeFactor=0.5, overallocateTimeFactor=1.3),
               dict(futileVisitsThreshold=0.3, midgameTimeFactor=0.7)))]
    for jsp, tsp in sps:
        for turn in (0, 5, 40, 200):
            assert ttc.midgame_weight(tsp, turn, 25) == jtc.midgame_weight(jsp, turn, 25)
            for ent, sur in ((None, None), (0.1, 0.02), (2.0, 1.0)):
                assert ttc.shaped_time_budget(tsp, 4.0, turn, 25, ent, sur) == jtc.shaped_time_budget(
                    jsp, 4.0, turn, 25, ent, sur)
            assert ttc.interpolate_early(19.0, 0.8, 0.1, turn) == jtc.interpolate_early(19.0, 0.8, 0.1, turn)
        for counts, left, temp in (([10, 3, 1], 2.0, 0.0), ([10, 3, 1], 20.0, 0.5), ([4, 9], 1.0, 0.0), ([], 1.0, 0.0)):
            assert ttc.is_search_futile(tsp, counts, counts, left, temp) == jtc.is_search_futile(
                jsp, counts, counts, left, temp)
            if counts:
                assert ttc.num_visits_needed_to_be_non_futile(tsp, 10.0, temp) == \
                    jtc.num_visits_needed_to_be_non_futile(jsp, 10.0, temp)


@pytest.mark.parametrize("board", [(5, 5, 4), (9, 6, 5), (19, 19, 5)], ids=["5x5", "9x6", "19x19"])
def test_io_matches_jax(board):
    """The move and board strings, both ways, as JAX's on every action and
    on accepted and refused inputs."""
    from katacoffee_tpu.game.board import GameConfig as JCfg
    from katacoffee_tpu_torch.game.board import GameConfig as TCfg

    jc, tc = JCfg(*board), TCfg(*board)
    for a in range(jc.policy_size):
        for fn in ("action_to_string", "action_to_compact"):
            s = getattr(jio, fn)(a, jc)
            assert getattr(tio, fn)(a, tc) == s
            assert tio.parse_loc(s, tc) == jio.parse_loc(s, jc)
            assert tio.parse_action(s, tc) == jio.parse_action(s, jc) == a
    for s in ("C3 nw", "c3NE", "A1 n", "Z9 west", "C3", "3C north", "C3 up", "AA1 n", ""):
        outcomes = []
        for mod, cfg in ((jio, jc), (tio, tc)):
            try:
                outcomes.append(mod.parse_loc(s, cfg))
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1], s
    rng = np.random.default_rng(sum(board))
    b = rng.integers(0, 3, (board[1], board[0])).astype(np.int8)
    text = jio.board_to_string(b, jc)
    assert tio.board_to_string(b, tc) == text
    assert np.array_equal(tio.parse_board(text, tc), jio.parse_board(text, jc))
    assert tio.spot_to_string(-1, 0, tc) == jio.spot_to_string(-1, 0, jc)
    assert [tio.direction_to_string(d) for d in range(5)] == [jio.direction_to_string(d) for d in range(5)]
