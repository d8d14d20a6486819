"""The fused interior descent (`katacoffee_tpu_torch.ops.descend` and its
plain version `mcts._descend_interior_plain`), on the CPU.

The CUDA kernel runs only on the card, where chip_smoke.py holds it to the
plain version. Here its algorithm is emulated one game at a time in plain
numpy float32 (`_emulate`, lanes in order, the kernel's summation order and
constants, the first maximum on ties, and its stop and record rules) and held
to the plain version on trees taken mid-search: 5x5 with a tiny net (C = 20
candidate lanes) and 9x9 with the uniform evaluator (C = 36, more lanes than
a warp has threads), under three selection profiles and a depth cap, and
under the selfplay and gatekeeper profiles on trees that graph search
built, with transpositions, where descents stop at edge-visit catch-ups
(the gatekeeper's with fractional S_W rows from uncertainty weighting,
optimistic priors and the FPU visited-policy pow 1.0), and under the GTP
engine's profile (`for_tests_v2()`: noise pruning, so the scratch's rank_c
lane) with an `avoid_until` mask, on a game of which every lane is
forbidden (the mask is then ignored); with the catch-up leak's draws on
the graph-search trees; and in the rows mode of a round of K playouts a
game (row r walks game r // K, records its flat actions, writes no edge
visit), on a round's own inputs and on rows copied so that a game's rows
meet at every node, whose edge visits `_count_path_edges` then adds K
times. Leaf, depth,
caught, path, acts, edge visits and the scratch slots must be equal; the
scratch's stat rows also equal the JAX package's gather. The PUCT scores
agree within 1e-6, not exactly: the emulation sums the lanes in the order of
torch's CUDA reduction, the CPU plain version in its vectorized order, and a
division by a constant is the CUDA multiply by its reciprocal, each a
difference in the last bit of a float32 score of order one.
"""

import dataclasses
import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import katacoffee_tpu.ops.gather as JG
from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
from katacoffee_tpu_torch.game import board as TB
from katacoffee_tpu_torch.ops import _build, descend
from katacoffee_tpu_torch.search import mcts as TM
from katacoffee_tpu_torch.search.params import SearchParams
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINYNET = os.path.join(ROOT, "tests/goldens/tinynet")
F = np.float32

# the selection branches of tests/test_torch_search.py
SELECT_BRANCHES = dict(
    cpuctExploration=1.1,
    cpuctExplorationLog=0.4,
    cpuctUtilityStdevScale=0.85,
    cpuctUtilityStdevPrior=0.4,
    cpuctUtilityStdevPriorWeight=2.0,
    rootDesiredPerChildVisitsCoeff=2.0,
    rootFpuReductionMax=0.0,
)
PROFILES = {
    "default": {},
    "visited_policy": dict(SELECT_BRANCHES, fpuParentWeightByVisitedPolicy=True,
                           fpuParentWeightByVisitedPolicyPow=2.0),
    "parent_weight": dict(SELECT_BRANCHES, fpuParentWeight=0.5, fpuLossProp=0.1,
                          valueWeightExponent=0.0),
    "selfplay": dataclasses.asdict(SearchParams.for_selfplay()),
    "gatekeeper": dataclasses.asdict(SearchParams.for_gatekeeper()),
    "options": dataclasses.asdict(SearchParams.for_tests_v2()),
}
BOARDS = {"5x5": (TB.GameConfig(5, 5, 4), "tinynet"), "9x9": (TB.GameConfig(9, 9, 4), "uniform")}


# ---------------------------------------------------------------------------
# The kernel's algorithm, one game at a time
# ---------------------------------------------------------------------------


def _row_sum(x):
    """Sum of the lane values in the order of torch's CUDA sum over the last
    dim of a [B, C] tensor, which the kernel follows: block width
    w = min(last_pow2(C), 32), lane l adds lane l + w, then a tree over
    halving offsets."""
    C = len(x)
    w = min(32, 1 << (C.bit_length() - 1))
    v = [x[i] + (x[i + w] if i + w < C else F(0)) for i in range(w)]
    while len(v) > 1:
        h = len(v) // 2
        v = [v[i] + v[i + h] for i in range(h)]
    return v[0]


def _pow(x, e):
    special = {0.0: lambda: F(1), 1.0: lambda: x, 2.0: lambda: x * x, 3.0: lambda: x * x * x,
               0.5: lambda: np.sqrt(x), -0.5: lambda: F(1) / np.sqrt(x),
               -1.0: lambda: F(1) / x, -2.0: lambda: F(1) / (x * x)}
    return special[e]() if e in special else np.power(x, F(e))


def _scores(sp, ns, self_u, pr, w, live, q_child, forbid):
    """The PUCT scores of one node's lanes, as the kernel computes them:
    -inf on an illegal lane, and on a forbidden one where some legal lane is
    not forbidden."""
    C = len(pr)
    keep = any(pr[c] >= 0 and not forbid[c] for c in range(C))
    total_w = _row_sum(w)
    mass = _row_sum([max(pr[c], F(0)) if live[c] else F(0) for c in range(C)])
    factor = F(1)
    if sp.cpuctUtilityStdevScale != 0.0:
        w_sum, u = ns[1], ns[3]
        uu = u * u
        usq = max(ns[4], uu)
        num = (uu + F(sp.cpuctUtilityStdevPrior**2)) * F(sp.cpuctUtilityStdevPriorWeight) + usq * w_sum
        den = F(sp.cpuctUtilityStdevPriorWeight) + max(w_sum - F(1), F(1e-8))
        stdev = np.sqrt(max(num / den - uu, F(0)))
        stdev = F(sp.cpuctUtilityStdevPrior) if w_sum <= F(1) else stdev
        inv_prior = F(1) / F(sp.cpuctUtilityStdevPrior)
        factor = F(1) + F(sp.cpuctUtilityStdevScale) * (stdev * inv_prior - F(1))
    inv_base = F(1) / F(sp.cpuctExplorationBase)
    cpuct = F(sp.cpuctExploration) + F(sp.cpuctExplorationLog) * np.log(
        (total_w + F(sp.cpuctExplorationBase)) * inv_base)
    explore = cpuct * np.sqrt(total_w + F(0.01)) * factor
    parent_u = ns[3]
    if sp.fpuParentWeightByVisitedPolicy:
        avg_w = min(_pow(mass, sp.fpuParentWeightByVisitedPolicyPow), F(1))
        parent_u = avg_w * ns[3] + (F(1) - avg_w) * self_u
    elif sp.fpuParentWeight > 0.0:
        parent_u = F(sp.fpuParentWeight) * self_u + F(1.0 - sp.fpuParentWeight) * ns[3]
    fpu = parent_u - F(sp.fpuReductionMax) * np.sqrt(mass)
    fpu = fpu + (F(-sp.winLossUtilityFactor) - fpu) * F(sp.fpuLossProp)
    out = []
    for c in range(C):
        q = q_child[c] if live[c] else fpu
        v = explore * max(pr[c], F(0)) / (F(1) + w[c]) + q
        out.append(F(-np.inf) if pr[c] < 0 or (forbid[c] and keep) else v)
    return out


def _first_max(sel):
    """The kernel's warp argmax: the first maximum, as torch.argmax (lane 0
    when every score is -inf)."""
    best = 0
    for c in range(1, len(sel)):
        if sel[c] > sel[best]:
            best = c
    return best


def _emulate(cfg, sp, tree, node, depth, active, path, acts, scratch, avoid_until=None, leak_u=None, acts_f=None,
             pick=_first_max):
    """The kernel's descent over CPU tensors, updated in place through numpy
    views, choosing each level's lane with `pick(scores)`. As in the kernel,
    only the first node's fields (terminal flag, candidate row, stats row,
    own utility, and with `avoid_until` the player to move) are read from
    the tree; every later node's come with the child lane the level above
    chose (the mover alternates), and an edge visit is written as that
    lane's loaded count + 1, never read back. Under noise pruning each lane
    stores its policy rank. With `leak_u` [R, D + 1] a catch-up is let
    through where the row's draw at the node's depth is below the float32
    probability. With `acts_f` (the rows flag) row r walks game r // K's
    tree, records its flat actions there and writes no edge visit. Returns
    (leaf, leaf_depth, caught) and {(row, depth): scores} of each
    non-terminal level."""
    cand_tab = TM._cand_table_np(cfg.x_size, cfg.y_size, cfg.win_len)
    st = tree.states
    last_spot, last_dir = st.last_spot.numpy(), st.last_dir.numpy()
    term_t, children, prior = tree.is_terminal.numpy(), tree.children.numpy(), tree.prior.numpy()
    stats, self_stats, ev_t = tree.stats.numpy(), tree.self_stats.numpy(), tree.edge_visits.numpy()
    to_move, ranks = st.to_move.numpy(), tree.policy_rank.numpy()
    avoid = None if avoid_until is None else avoid_until.numpy()
    path_n, acts_n = path.numpy(), acts.numpy()
    acts_f_n = None if acts_f is None else acts_f.numpy()
    u = None if leak_u is None else leak_u.numpy()
    leak_prob = F(sp.graphSearchCatchUpLeakProb)
    cs_raw, prior_c, child_c, ev_c, rank_c = (x.numpy() for x in scratch)
    B, N, _ = children.shape
    R = node.shape[0]
    K = R // B
    D, C = child_c.shape[1:]
    leaf, leaf_depth = node.clone().numpy(), depth.clone().numpy()
    caught = np.zeros(R, bool)
    scores = {}

    def fields(b, n):
        """(terminal, candidate row, stats row, own utility) of node n."""
        spot, direction = int(last_spot[b, n]), int(last_dir[b, n])
        spot = cfg.area if spot < 0 or spot > cfg.area else spot
        return bool(term_t[b, n]), cand_tab[spot, min(max(direction, 0), 4)], stats[b, n], self_stats[b, n, TM.F_U]

    for r in range(R):
        b = r // K
        n, d, on = int(node[r]), int(depth[r]), bool(active[r])
        if on:
            term, cand, ns, self_u = fields(b, n)
            mover = int(to_move[b, n])
        while on:
            kids, pr, w, live, q_child, evs, cvis, lanes, forbid = [], [], [], [], [], [], [], [], []
            for c in range(C):
                a = int(cand[c])
                kid, evi, p = (int(children[b, n, a]), int(ev_t[b, n, a]), prior[b, n, a]) if a >= 0 else (-1, 0, F(-1))
                ev = F(evi)
                on_board = 0 <= kid < N
                raw = stats[b, kid] if on_board else np.zeros(8, F)
                cs_raw[r, d - 1, c], prior_c[r, d - 1, c] = raw, p
                child_c[r, d - 1, c], ev_c[r, d - 1, c] = kid, ev
                if sp.useNoisePruning:
                    rank_c[r, d - 1, c] = F(ranks[b, n, a]) if a >= 0 else F(1e6)
                forbid.append(avoid is not None and a >= 0 and int(avoid[b, min(max(mover - 1, 0), 1), a]) > d)
                is_live = kid >= 0 and ev > 0
                kids.append(kid)
                pr.append(p)
                live.append(is_live)
                w.append(raw[1] * (ev / max(raw[0], F(1))) if is_live else F(0))
                q_child.append(-raw[3])
                evs.append(evi)
                cvis.append(raw[0])
                lanes.append(fields(b, kid) if on_board else None)
            if term:
                break
            sel = _scores(sp, ns, self_u, pr, w, live, q_child, forbid)
            scores[(r, d)] = sel
            best = pick(sel)
            acts_n[r, d] = best
            if acts_f_n is not None:
                acts_f_n[r, d] = cand[best]
            leaked = u is not None and u[r, d] < leak_prob
            caught[r] = sp.useGraphSearch and kids[best] >= 0 and F(evs[best]) < cvis[best] - F(0.5) and not leaked
            if kids[best] < 0 or caught[r]:
                break
            if acts_f_n is None:
                ev_t[b, n, cand[best]] = evs[best] + 1
            path_n[r, d + 1] = kids[best]
            n, d, mover = kids[best], d + 1, 3 - mover
            term, cand, ns, self_u = lanes[best]
            on = d < D
        leaf[r], leaf_depth[r] = n, d
    return torch.from_numpy(leaf), torch.from_numpy(leaf_depth), torch.from_numpy(caught), scores


# ---------------------------------------------------------------------------
# Trees mid-search
# ---------------------------------------------------------------------------


def _random_roots(cfg, batch, seed, min_plies=0):
    """`batch` positions after min_plies..15 random legal plies."""
    rng = np.random.default_rng(seed)
    s = TB.init_state(cfg, batch, "cpu")
    plies = rng.integers(min_plies, 16, batch)
    for ply in range(int(plies.max())):
        legal = TB.legal_mask_flat(cfg, s).numpy()
        act = torch.from_numpy((rng.random(legal.shape) * legal).argmax(-1))
        new = TB.step(cfg, s, act)
        keep = torch.from_numpy(ply < plies)
        s = TB.GameState(*(
            torch.where(keep.reshape((batch,) + (1,) * (o.dim() - 1)), nw, o) for o, nw in zip(s, new)
        ))
    return s


def _eval_fn(cfg, evals):
    if evals == "uniform":
        return TM.uniform_eval_fn(cfg)
    return TM.make_nn_eval_fn(cfg, load_exported_model(TINYNET, device="cpu", dtype=torch.float32)[0])


@functools.lru_cache(maxsize=None)
def _mid_search_tree(board, graph=False, gating=False, options=False):
    """A tree 30 playouts in; with `graph`, 80 playouts in under the selfplay
    profile, whose graph search linked a transposition on 5x5; with
    `gating`, 150 playouts in (the gating visits) under the gatekeeper
    profile (graph search, uncertainty-weighted evaluations, so fractional
    S_W rows, and optimistic priors), from other roots (seed 0), on which
    it links transpositions on 5x5; with `options`, 80 playouts in under
    `for_tests_v2()` (noise pruning, so policy ranks in every node)."""
    cfg, evals = BOARDS[board]
    roots = _random_roots(cfg, 8, seed=0 if gating else len(board))
    sp = (SearchParams.for_tests_v2() if options else SearchParams.for_gatekeeper() if gating
          else SearchParams.for_selfplay() if graph else SearchParams())
    return TM.run_search(cfg, sp, _eval_fn(cfg, evals), roots, 150 if gating else 80 if graph else 30, device="cpu",
                         generator=torch.Generator().manual_seed(0))


def _avoid_until(tree, seed=3):
    """[B, 2, A] int32 avoid depths: about a third of each game's actions
    forbidden to either player until depth 1-3, and every action of game 0
    forbidden to both until depth 30 (so the mask is ignored there)."""
    rng = np.random.default_rng(seed)
    B, _, A = tree.children.shape
    until = rng.integers(1, 4, (B, 2, A)) * (rng.random((B, 2, A)) < 0.35)
    until[0] = 30
    return torch.from_numpy(until.astype(np.int32))


def _descent_inputs(board, sp, max_depth=None):
    """A copy of the mid-search tree after the root level of a playout, with
    a scratch filled with arbitrary valid lanes (as an earlier playout
    leaves it). Under graph search every interior edge with two or more
    visits loses one, as a transposition leaves an edge behind its child, so
    that descents stop at catch-ups; on the gatekeeper's tree only the edges
    out of every third node slot do, so that descents also go deeper (and
    on the options tree, which is not caught up)."""
    cfg, _ = BOARDS[board]
    base = _mid_search_tree(board, sp.useGraphSearch, sp.useUncertainty and not sp.useNoisePruning,
                            sp.useNoisePruning)
    tree = base._replace(edge_visits=base.edge_visits.clone())
    if sp.useGraphSearch and not sp.useNoisePruning:
        inner = tree.edge_visits[:, 1:]
        behind = inner >= 2
        if sp.useUncertainty:
            behind &= (torch.arange(1, inner.shape[1] + 1) % 3 == 0)[None, :, None]
        inner -= behind.to(inner.dtype)
    B, N, _ = tree.children.shape
    max_depth = cfg.area + 1 if max_depth is None else max_depth
    bidx = torch.arange(B)
    root_cs = TM._gather_child_stats(tree, bidx, torch.zeros(B, dtype=torch.int64))
    path, acts, _, node, depth, active, _ = TM._descend_root(sp, tree, root_cs, max_depth)
    rng = np.random.default_rng(7)
    scratch = TM.make_level_scratch(cfg, B, max_depth, "cpu")
    scratch.cs_raw.copy_(torch.from_numpy(rng.standard_normal(scratch.cs_raw.shape).astype(F)))
    scratch.prior_c.copy_(torch.from_numpy(rng.random(scratch.prior_c.shape).astype(F)))
    scratch.child_c.copy_(torch.from_numpy(rng.integers(-1, N, scratch.child_c.shape).astype(np.int32)))
    scratch.ev_c.copy_(torch.from_numpy(rng.integers(0, 5, scratch.ev_c.shape).astype(F)))
    scratch.rank_c.copy_(torch.from_numpy(rng.integers(0, 100, scratch.rank_c.shape).astype(F)))
    return cfg, tree, (node, depth, active, path, acts, scratch)


def _copy(tree, state):
    node, depth, active, path, acts, scratch = state
    return (tree._replace(edge_visits=tree.edge_visits.clone()), node, depth, active, path.clone(),
            acts.clone(), TM.LevelScratch(*(x.clone() for x in scratch)))


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


def _check_against_plain(board, profile, max_depth=None):
    sp = SearchParams(**PROFILES[profile])
    cfg, tree, state = _descent_inputs(board, sp, max_depth)
    avoid = _avoid_until(tree) if profile == "options" else None
    t_p, node, depth, active, path_p, acts_p, sc_p = _copy(tree, state)
    t_e, _, _, _, path_e, acts_e, sc_e = _copy(tree, state)
    leaf_p, ld_p, caught_p = TM._descend_interior_plain(cfg, sp, t_p, node, depth, active, path_p, acts_p,
                                                        sc_p, avoid)
    leaf_e, ld_e, caught_e, scores = _emulate(cfg, sp, t_e, node, depth, active, path_e, acts_e, sc_e, avoid)

    assert torch.equal(leaf_e, leaf_p) and torch.equal(ld_e, ld_p) and torch.equal(caught_e, caught_p)
    assert torch.equal(path_e, path_p) and torch.equal(acts_e, acts_p)
    assert torch.equal(t_e.edge_visits, t_p.edge_visits)
    for name, a, b in zip(TM.LevelScratch._fields, sc_e, sc_p):
        assert torch.equal(a, b), name

    # the scratch slots of this descent hold the JAX package's gather
    D = sc_p.child_c.shape[1]
    written = torch.zeros(sc_p.child_c.shape[:2], dtype=torch.bool)
    for b in range(node.shape[0]):
        if active[b]:
            hi = int(ld_p[b]) if int(ld_p[b]) < D else D - 1
            written[b, int(depth[b]) - 1: hi] = True
    assert written.any()
    want = np.asarray(JG._gather_rows_xla(
        jnp.asarray(tree.stats.numpy()), jnp.asarray(sc_p.child_c.reshape(node.shape[0], -1).numpy())
    )).reshape(sc_p.cs_raw.shape)
    assert np.array_equal(sc_p.cs_raw.numpy()[written.numpy()], want[written.numpy()])

    # the emulated scores against the plain version's, level by level
    levels = sorted({d for _, d in scores})
    assert levels, "no interior level was selected"
    bidx = torch.arange(node.shape[0])
    for d in levels:
        _, _, sel = TM._interior_level(cfg, sp, tree, bidx, path_p[:, d].clamp(min=0),
                                       torch.full_like(depth, d), avoid)
        for b in [b for b, dd in scores if dd == d]:
            np.testing.assert_allclose(np.asarray(scores[(b, d)]), sel[b].numpy(), rtol=0, atol=1e-6)
    if avoid is not None:
        # forbidden lanes were scored -inf on some level, and on game 0,
        # whose every lane is forbidden, the mask was ignored
        hit = [np.isneginf(scores[k]).sum() > 0 for k in scores if k[0] > 0]
        assert any(hit) and all(np.isfinite(scores[k]).any() for k in scores)
        assert any(k[0] == 0 for k in scores), "game 0 reached no interior level"
        assert (sc_p.rank_c < 1e6).any()
    return ld_p, leaf_p, caught_p, t_p


@pytest.mark.parametrize("profile", list(PROFILES))
@pytest.mark.parametrize("board", list(BOARDS))
def test_emulated_kernel_matches_plain_descent(board, profile):
    ld, _, caught, tree = _check_against_plain(board, profile)
    assert (ld >= 2).any(), "no game descended past the first interior level"
    if profile == "gatekeeper":
        w = tree.stats[..., TM.S_W][tree.stats[..., TM.S_VISITS] > 0]
        assert (w != torch.round(w)).float().mean() > 0.5, "the gating tree's S_W rows are not fractional"
    if profile in ("selfplay", "gatekeeper"):
        assert caught.any(), "no descent stopped at a catch-up"
    if profile in ("selfplay", "gatekeeper", "options"):
        kids = tree.children.to(torch.int64)
        b = torch.arange(kids.shape[0])[:, None, None].expand_as(kids)
        parents = torch.zeros(tree.stats.shape[:2], dtype=torch.int64).index_put_(
            (b[kids >= 0], kids[kids >= 0]), torch.ones_like(kids[kids >= 0]), accumulate=True
        )
        assert board != "5x5" or (parents > 1).any(), "graph search linked no transposition"


def test_emulated_kernel_matches_plain_descent_at_the_depth_cap():
    ld, _, _, _ = _check_against_plain("5x5", "default", max_depth=3)
    assert (ld == 3).any()


def test_search_with_the_emulated_kernel_equals_the_plain_search():
    """The kernel's algorithm in the whole search: every playout's interior
    descent emulated gives the plain CPU search's tree exactly (and that one
    equals JAX's visit counts, tests/test_torch_search.py). Late-game roots,
    so that descents end at terminal nodes too."""
    cfg, evals = BOARDS["5x5"]
    roots = _random_roots(cfg, 4, seed=11, min_plies=6)
    sp = SearchParams(**PROFILES["visited_policy"])
    plain = TM.run_search(cfg, sp, _eval_fn(cfg, evals), roots, 40, device="cpu")
    orig = TM._descend_interior
    try:
        TM._descend_interior = lambda *a, **kw: _emulate(*a, **kw)[:3]
        emulated = TM.run_search(cfg, sp, _eval_fn(cfg, evals), roots, 40, device="cpu")
    finally:
        TM._descend_interior = orig
    for name, a, b in zip(TM.Tree._fields, emulated, plain):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
    revisited_terminal = plain.is_terminal & (plain.stats[..., TM.S_VISITS] > 1)
    assert revisited_terminal.any(), "no descent ended at a terminal node"


def _outputs_equal(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i


@pytest.mark.parametrize("profile", ["selfplay", "gatekeeper"])
def test_emulated_kernel_matches_plain_descent_with_the_catch_up_leak(profile):
    """The leak flag: each row's uniform draw at the node's depth below the
    float32 probability lets a catch-up through. On the graph-search trees
    that stop at catch-ups, with leak probability 0.3 and random draws, the
    emulation equals the plain version, and some descent goes deeper than
    without the leak."""
    sp = dataclasses.replace(SearchParams(**PROFILES[profile]), graphSearchCatchUpLeakProb=0.3)
    cfg, tree, state = _descent_inputs("5x5", sp)
    B, D = state[0].shape[0], state[5].child_c.shape[1]
    u = torch.from_numpy(np.random.default_rng(9).random((B, D + 1)).astype(F))
    runs = []
    for fn in (TM._descend_interior_plain, lambda *a, **kw: _emulate(*a, **kw)[:3]):
        t, node, depth, active, path, acts, sc = _copy(tree, state)
        runs.append((*fn(cfg, sp, t, node, depth, active, path, acts, sc, leak_u=u), path, acts, t.edge_visits, *sc))
    _outputs_equal(runs[1], runs[0])
    t, node, depth, active, path, acts, sc = _copy(tree, state)
    closed = TM._descend_interior_plain(cfg, dataclasses.replace(sp, graphSearchCatchUpLeakProb=0.0), t, node, depth,
                                        active, path, acts, sc)
    assert (runs[0][1] > closed[1]).any(), "no descent leaked through a catch-up"


def _round_inputs(board, profile, K, leak, call=6):
    """The tree and the descent inputs of the `call`-th round of a search
    with K playouts a round (B = 8, 5x5 tinynet or 9x9 uniform), copied as
    `_simulate_round` hands them to the descent: (cfg, sp, tree, (node,
    depth, active, path, acts, scratch), acts_f, leak_u)."""
    cfg, evals = BOARDS[board]
    sp = dataclasses.replace(SearchParams(**PROFILES[profile]), numSearchThreads=K,
                             graphSearchCatchUpLeakProb=leak)
    seen = []

    def copying(c, sp_, tree, node, depth, active, path, acts, scratch, avoid_until=None, leak_u=None,
                acts_f=None):
        seen.append(1)
        if len(seen) == call:
            copying.got = (TM.Tree(*(x.map(torch.clone) if isinstance(x, tuple) else x.clone() for x in tree)),
                           tuple(x.clone() for x in (node, depth, active, path, acts))
                           + (TM.LevelScratch(*(x.clone() for x in scratch)),),
                           acts_f.clone(), None if leak_u is None else leak_u.clone())
        return TM._descend_interior_plain(c, sp_, tree, node, depth, active, path, acts, scratch, avoid_until,
                                          leak_u, acts_f)

    kept = TM._descend_interior
    TM._descend_interior = copying
    try:
        TM.run_search(cfg, sp, _eval_fn(cfg, evals), _random_roots(cfg, 8, seed=4), 2 * call * K, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    finally:
        TM._descend_interior = kept
    tree, state, acts_f, leak_u = copying.got
    return cfg, sp, tree, state, acts_f, leak_u


def _run_rows(fn, cfg, sp, tree, state, acts_f, leak_u):
    t, node, depth, active, path, acts, sc = _copy(tree, state)
    af = acts_f.clone()
    out = fn(cfg, sp, t, node, depth, active, path, acts, sc, leak_u=leak_u, acts_f=af)
    return (*out, path, acts, af, t.edge_visits, *sc)


@pytest.mark.parametrize("board,profile,K,leak", [("5x5", "selfplay", 4, 0.3), ("5x5", "options", 3, 0.0),
                                                  ("9x9", "default", 2, 0.0)])
def test_emulated_kernel_matches_plain_descent_on_the_rows_of_a_round(board, profile, K, leak):
    """The rows flag on a round's own inputs: row r walks game r // K's
    tree, its path, acts, flat actions (acts_f), scratch rows, leaf and
    catch-up its own, and no edge visit is written (the round counts them
    after the descent)."""
    cfg, sp, tree, state, acts_f, leak_u = _round_inputs(board, profile, K, leak)
    assert (leak_u is not None) == (leak > 0)
    want = _run_rows(TM._descend_interior_plain, cfg, sp, tree, state, acts_f, leak_u)
    got = _run_rows(lambda *a, **kw: _emulate(*a, **kw)[:3], cfg, sp, tree, state, acts_f, leak_u)
    _outputs_equal(got, want)
    assert torch.equal(want[6], tree.edge_visits)
    assert (want[1] >= 2).any(), "no row descended past the first interior level"
    R = state[0].shape[0]
    assert R == 8 * K and state[2].sum() > 8


def test_rows_of_one_game_at_one_node_count_every_edge_visit():
    """The forced collision at the row level: each game's descent inputs
    copied to K = 3 rows, so that the rows of a game meet at every node.
    Each row walks as the game's one-row descent does, and the round's
    integer count adds K visits to every edge the game's path passed."""
    sp = SearchParams()
    cfg, tree, state = _descent_inputs("5x5", sp)
    K = 3
    t1, node, depth, active, path, acts, sc = _copy(tree, state)
    one = TM._descend_interior_plain(cfg, sp, t1, node, depth, active, path, acts, sc)
    rows_state = tuple(x.repeat_interleave(K, 0) for x in state[:5]) + (
        TM.LevelScratch(*(x.repeat_interleave(K, 0) for x in state[5])),)
    acts_f = torch.zeros_like(rows_state[4])
    want = _run_rows(TM._descend_interior_plain, cfg, sp, tree, rows_state, acts_f, None)
    got = _run_rows(lambda *a, **kw: _emulate(*a, **kw)[:3], cfg, sp, tree, rows_state, acts_f, None)
    _outputs_equal(got, want)
    for i, (x, y) in enumerate(zip((*one, path, acts), want)):
        assert torch.equal(x.repeat_interleave(K, 0), y), i
    for x, y in zip(sc, want[7:]):
        assert torch.equal(x.repeat_interleave(K, 0), y)
    assert torch.equal(want[6], tree.edge_visits)
    counted = tree._replace(edge_visits=tree.edge_visits.clone())
    TM._count_path_edges(counted, want[3], want[5], want[1], rows_state[2] | True)
    added = t1.edge_visits - tree.edge_visits  # the one-row descent's interior edge visits
    assert added.sum() > 0 and torch.equal(counted.edge_visits - tree.edge_visits, K * added)


# the kernel's lane choice, and two wrong ones
PICKS = {
    "first_max": _first_max,
    "last_max": lambda sel: max(range(len(sel)), key=lambda c: (sel[c], c)),
    "runner_up": lambda sel: sorted(range(len(sel)), key=lambda c: (-sel[c], c))[1],
}


@pytest.mark.parametrize("pick", list(PICKS))
def test_chip_check_holds_the_descent_to_torch_argmax(pick):
    """chip_smoke.py's `compare_descent`, which holds the card's descent to
    the plain version, passes the kernel's algorithm and refuses it with the
    ties broken to the highest lane or with the runner-up lane taken. 9x9
    with the uniform evaluator: unvisited lanes tie exactly."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    sp = SearchParams()
    cfg, tree, state = _descent_inputs("9x9", sp)
    start_ev = tree.edge_visits.clone()
    t_p, node, depth, active, path_p, acts_p, sc_p = _copy(tree, state)
    t_e, _, _, _, path_e, acts_e, sc_e = _copy(tree, state)
    leaf_p, ld_p, caught_p = TM._descend_interior_plain(cfg, sp, t_p, node, depth, active, path_p, acts_p,
                                                        sc_p)
    leaf_e, ld_e, caught_e, _ = _emulate(cfg, sp, t_e, node, depth, active, path_e, acts_e, sc_e,
                                         pick=PICKS[pick])
    want = (leaf_p, ld_p, path_p, acts_p, t_p.edge_visits, *sc_p, caught_p)
    got = (leaf_e, ld_e, path_e, acts_e, t_e.edge_visits, *sc_e, caught_e)
    check = functools.partial(chip_smoke.compare_descent, f"9x9 {pick}", cfg, sp, tree, start_ev, state,
                              got, want)
    if pick == "first_max":
        assert check() == (0, 0.0)
    else:
        assert not torch.equal(acts_e, acts_p)
        with pytest.raises(AssertionError, match="another lane"):
            check()
    assert torch.equal(tree.edge_visits, start_ev)


def test_constants_are_rounded_as_torch_rounds_python_scalars():
    sp = SearchParams(**PROFILES["visited_policy"])
    floats, ints = descend.select_constants(sp)
    assert floats.dtype == np.float32 and ints.dtype == np.int32
    assert floats[3] == F(1) / F(sp.cpuctExplorationBase)
    assert floats[7] == F(sp.cpuctUtilityStdevPrior**2)
    # stdev factor on, fpu by visited policy, pow 2 = x * x, no graph, no rank lane, no avoid mask
    assert list(ints) == [1, 1, 3, 0, 0, 0]
    assert list(descend.select_constants(SearchParams.for_selfplay())[1]) == [0, 1, 3, 1, 0, 0]
    assert list(descend.select_constants(SearchParams.for_tests_v2(), forbid=True)[1]) == [1, 1, 2, 1, 1, 1]


def test_layout_constants_match_the_kernel_source():
    """The wrapper's argument layout (`_NUM_FLOATS`, `_NUM_INTS`,
    `_NUM_POINTERS`) is the one `descend_kernel.cu` declares, so the layout
    check at load time compares like with like."""
    import re

    src = descend.SOURCE.read_text()
    declared = {k: int(v) for k, v in re.findall(r"constexpr int (kNum\w+) = (\d+);", src)}
    assert declared == {"kNumFloats": descend._NUM_FLOATS, "kNumInts": descend._NUM_INTS,
                        "kNumPointers": descend._NUM_POINTERS}
    assert re.search(r"constexpr int kMaxTableBytes = (\d+);", src).group(1) == str(descend.MAX_TABLE_BYTES)
    floats, ints = descend.select_constants(SearchParams.for_selfplay())
    assert (floats.size, ints.size) == (descend._NUM_FLOATS, descend._NUM_INTS)


def test_cpu_tensors_take_the_plain_descent_without_a_launch():
    sp = SearchParams()
    cfg, tree, state = _descent_inputs("5x5", sp)
    t_a, node, depth, active, path_a, acts_a, sc_a = _copy(tree, state)
    t_b, _, _, _, path_b, acts_b, sc_b = _copy(tree, state)
    before = descend.descend_interior.launches
    got = TM._descend_interior(cfg, sp, t_a, node, depth, active, path_a, acts_a, sc_a)
    want = TM._descend_interior_plain(cfg, sp, t_b, node, depth, active, path_b, acts_b, sc_b)
    assert descend.descend_interior.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(t_a.edge_visits, t_b.edge_visits) and torch.equal(acts_a, acts_b)


def test_kernel_wrapper_refuses_what_it_does_not_take():
    """No fallback: CPU tensors, mixed devices, wrong dtypes and too many
    lanes raise in the wrapper; mixed devices also through the dispatcher."""
    sp = SearchParams()
    cfg, tree, state = _descent_inputs("5x5", sp)
    node, depth, active, path, acts, scratch = state
    cand = TM._cand_table_i16(cfg, torch.device("cpu"))
    with pytest.raises(ValueError, match="one CUDA device"):
        descend.descend_interior(sp, cand, tree, node, depth, active, path, acts, scratch)
    meta_node = torch.empty(node.shape, dtype=node.dtype, device="meta")
    with pytest.raises(ValueError, match="node on meta"):
        TM._descend_interior(cfg, sp, tree, meta_node, depth, active, path, acts, scratch)
    with pytest.raises(TypeError, match="acts"):
        descend.descend_interior(sp, cand, tree, node, depth, active, path, acts.to(torch.int32), scratch)
    with pytest.raises(ValueError, match="contiguous"):
        descend.descend_interior(sp, cand, tree, node, depth, active, path.t().contiguous().t(), acts,
                                 scratch)
    wide = TM.make_level_scratch(TB.GameConfig(16, 16, 5), node.shape[0], scratch.child_c.shape[1], "cpu")
    with pytest.raises(ValueError, match="candidate lanes"):
        descend.descend_interior(sp, cand, tree, node, depth, active, path, acts, wide)
    leak = SearchParams(useGraphSearch=True, graphSearchCatchUpLeakProb=0.1)
    with pytest.raises(ValueError, match="leak_u is needed"):
        descend.descend_interior(leak, cand, tree, node, depth, active, path, acts, scratch)
    u = torch.rand(node.shape[0], scratch.child_c.shape[1])  # one column short
    with pytest.raises(ValueError, match="leak_u must have shape"):
        descend.descend_interior(leak, cand, tree, node, depth, active, path, acts, scratch, leak_u=u)


@pytest.mark.parametrize("board", [(5, 5, 4), (7, 7, 5), (9, 6, 5), (15, 15, 5)],
                         ids=["5x5", "7x7w5", "9x6w5", "15x15"])
def test_int16_candidate_table_equals_the_table_and_fits_shared_memory(board):
    cfg = TB.GameConfig(*board)
    tab = TM._cand_table(cfg, torch.device("cpu"))
    flat = TM._cand_table_i16(cfg, torch.device("cpu"))
    C = 4 * max(cfg.x_size, cfg.y_size)
    assert flat.dtype == torch.int16 and flat.is_contiguous()
    assert flat.numel() * 2 == descend.table_bytes(cfg.area, C) and (flat.numel() * 2) % 16 == 0
    assert descend.table_bytes(cfg.area, C) <= descend.MAX_TABLE_BYTES
    assert torch.equal(flat[: tab.numel()].to(torch.int64), tab.reshape(-1))
    assert (flat[tab.numel():] == -1).all() and flat.numel() - tab.numel() < 8
    if board[0] <= 9:
        assert descend.table_bytes(cfg.area, C) <= 48 * 1024  # no opt-in to large shared memory


def test_kernel_wrapper_refuses_an_int32_table_and_one_above_shared_memory():
    sp = SearchParams()
    cfg, tree, state = _descent_inputs("5x5", sp)
    node, depth, active, path, acts, scratch = state
    wide = TM._cand_table(cfg, torch.device("cpu")).to(torch.int32).reshape(-1)
    with pytest.raises(TypeError, match="cand must be torch.int16"):
        descend.descend_interior(sp, wide, tree, node, depth, active, path, acts, scratch)
    # a 20x20 tree (area 400) with 60 lanes needs 240,600 bytes of table
    big = tree._replace(children=torch.full(tree.children.shape[:2] + (4 * 400,), -1, dtype=torch.int32))
    lanes = TM.make_level_scratch(TB.GameConfig(15, 15, 5), node.shape[0], scratch.child_c.shape[1], "cpu")
    table = torch.full((descend.table_bytes(400, 60) // 2,), -1, dtype=torch.int16)
    with pytest.raises(ValueError, match="shared memory"):
        descend.descend_interior(sp, table, big, node, depth, active, path, acts, lanes)


def test_cuda_search_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, _ = BOARDS["5x5"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.run_search(cfg, SearchParams(), TM.uniform_eval_fn(cfg), TB.init_state(cfg, 2, "cpu"), 2)


def test_descend_library_name_carries_the_source_hash():
    lib = _build.library_path(descend.SOURCE)
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith("descend_kernel-")
    assert lib != _build.library_path(_build.Path(__file__))
    assert "--fmad=false" in _build.NVCC_FLAGS and "--use_fast_math" not in _build.NVCC_FLAGS
