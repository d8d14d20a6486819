"""The PyTorch selfplay segment against JAX's `run_selfplay_segment`, with
every draw of the port derived from the JAX segment's key chain: the
searches' root symmetries and Dirichlet gamma samples (`symmetry_draws`, and
the gamma recorded by key), `select_moves`' and the opening move's Gumbel
noise (`jax.random.gumbel` on the keys that `jax.random.categorical` uses),
the opening lengths (`jax.random.exponential`).

b6c96 at float32 on both sides, B = 8, 32 visits, 6 moves from mid-game
positions and empty boards, so that games end and reset inside the segment
and reach the next search with `reuse_ok` False beside reused trees. JAX
runs a segment's first move through its reuse branch (a placeholder tree,
`reuse_ok` all False); the port searches a fresh tree, which the last test
shows is the same search.

Played actions, root visits, done, winner, episode ids and every state equal
exactly; raw policy and raw value within 1e-5; root values within 2e-4 (as
tests/torch_parity.py holds whole searches). Policy targets within 1e-5,
except for the rounding contract's ceil step (PERF.md section 2): the
play-selection weight of a non-best child is ceil(min(w, wanted)), and a
child weight w that lies within a few float32 ulps of an integer n rounds
to n + 1 in one package and to n in the other. So a row may differ only by
whole units at children whose weight lies within NEAR_INTEGER of an integer,
and the readouts on the same tree are equal. `finalize_targets` runs on the
port's trajectory in both packages, within the tolerances of
tests/test_torch_finalize.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from katacoffee_tpu.game import board as JB
from katacoffee_tpu.game import jitted
from katacoffee_tpu.search import mcts as JM
from katacoffee_tpu.search.params import SearchParams as JaxParams
from katacoffee_tpu.selfplay import actor as JA
from katacoffee_tpu_torch.game import board as TB
from katacoffee_tpu_torch.search import mcts as TM
from katacoffee_tpu_torch.search.params import SearchParams
from katacoffee_tpu_torch.selfplay import actor as TA
from katacoffee_tpu_torch.selfplay import forking as TF
from test_torch_finalize import assert_same_batch, to_torch
from test_torch_search import B6C96, CFG, TCFG, _evals
from torch_parity import jax_tree, one_torch_thread, recorded_gamma, symmetry_draws, torch_states  # noqa: F401

JSP, TSP = JaxParams.for_selfplay(), SearchParams.for_selfplay()
B = 8
MOVES = 6
VISITS = 32
EXACT = ("played_action", "root_visits", "done_after", "winner_after", "episode_id", "final_board", "policy_init",
         "fork_valid", "hint_first", "hint_action", "tree_pos_valid")
WITHIN_1E5 = ("raw_policy", "raw_value", "tree_pos_policy")
WITHIN_2E4 = ("root_wl", "root_draw", "tree_pos_value")
# a child weight this close to an integer may take the ceil step
NEAR_INTEGER = 1e-5


# ---------------------------------------------------------------------------
# The port's draws from the JAX segment's key chain
# ---------------------------------------------------------------------------


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def gamma_table(calls):
    """{key bytes: gamma sample} of the recorded jax.random.gamma calls."""
    return {np.asarray(k).tobytes(): torch.from_numpy(o.copy()) for k, o in calls}


def reuse_root_draws(cfg, jsp, k_search, batch, gammas):
    """The RootDraws of a JAX search on a reused tree (run_search :2422,
    advance_root :2671): symmetries from k_eval, the fresh root's gamma from
    k_noise1, the reused root's from k_noise2."""
    k_init, _ = jax.random.split(k_search)
    k_eval, k_noise1, k_noise2 = jax.random.split(k_init, 3)
    return TM.RootDraws(syms=symmetry_draws(cfg, jsp, k_eval, batch), gamma=gammas[np.asarray(k_noise1).tobytes()],
                        gamma_reused=gammas[np.asarray(k_noise2).tobytes()])


def fork_move_draws(key, batch, A):
    """The draws of JAX `_sample_fork_move(key)`."""
    k_mix, k_t1, k_t2, k_u = jax.random.split(key, 4)
    return TA.ForkMoveDraws(t(jax.random.uniform(k_mix, (batch,))),
                            *(t(jax.random.gumbel(k, (batch, A))) for k in (k_t1, k_t2, k_u)))


def pool_draws(key, fold, batch, K):
    """(uniform [B], Gumbel [B, K]) of a start or hint pool pick (actor.py
    :363 and :382)."""
    k1, k2 = jax.random.split(jax.random.fold_in(key, fold))
    return t(jax.random.uniform(k1, (batch,))), t(jax.random.gumbel(k2, (batch, K)))


def segment_draws(cfg, jsp, key, batch, num_moves, gammas, start_k=0, hint_k=0):
    """The SegmentDraws of JAX `run_selfplay_segment(rng=key)` with tree
    reuse on (actor.py :453 and :264)."""
    A = cfg.policy_size
    _, k_len0, rng = jax.random.split(key, 3)
    moves = []
    for key_t in jax.random.split(rng, num_moves):
        k_search, k_move, k_init_move, k_init_len = jax.random.split(key_t, 4)
        k_fork, k_forkmove = jax.random.split(jax.random.fold_in(key_t, 11))
        moves.append(TA.MoveDraws(
            search=reuse_root_draws(cfg, jsp, k_search, batch, gammas),
            select=t(jax.random.gumbel(k_move, (batch, A))),
            init_move=t(jax.random.gumbel(k_init_move, (batch, A))),
            init_len=t(jax.random.exponential(k_init_len, (batch,))),
            fork=t(jax.random.uniform(k_fork, (batch,))),
            fork_move=fork_move_draws(k_forkmove, batch, A),
            startpos=pool_draws(key_t, 7, batch, start_k) if start_k else None,
            hintpos=pool_draws(key_t, 9, batch, hint_k) if hint_k else None,
        ))
    return TA.SegmentDraws(init_len=t(jax.random.exponential(k_len0, (batch,))), moves=tuple(moves))


def port_settings(settings):
    return TA.SelfplaySettings(**dataclasses.asdict(settings))


def run_both(jev, tev, settings, jstates, key, num_moves, cfgs=(CFG, TCFG), **pools):
    """JAX's segment (jitted) and the port's with the derived draws on the
    CPU. `pools` holds JAX startpos_pool / hintpos_pool / fork_pool; the
    port gets them converted; `cfgs` holds the board (JAX's GameConfig, the
    port's). Returns (JAX result, port result, the port's search tree of
    each move)."""
    jcfg, tcfg = cfgs
    batch = jstates.board.shape[0]
    seg = jax.jit(lambda s, e, k, p: JA.run_selfplay_segment(jcfg, JSP, settings, jev, s, e, k, num_moves, **p))
    with recorded_gamma() as calls:
        jout = jax.block_until_ready(seg(jstates, jnp.zeros((batch,), jnp.int32), key, pools))
        jax.effects_barrier()
    tpools = {}
    for name, pool in pools.items():
        if name == "fork_pool":
            tpools[name] = TF.ForkPool(torch_states(pool.states), to_torch(pool.valid))
        else:
            tpools[name] = (torch_states(pool[0]),) + tuple(to_torch(x) for x in pool[1:])
    draws = segment_draws(jcfg, JSP, key, batch, num_moves, gamma_table(calls),
                          start_k=len(pools["startpos_pool"][1]) if "startpos_pool" in pools else 0,
                          hint_k=len(pools["hintpos_pool"][1]) if "hintpos_pool" in pools else 0)
    trees = []
    kept = TM.policy_target

    def recording(tree, sp):
        trees.append(tree)
        return kept(tree, sp)

    TM.policy_target = recording
    try:
        tout = TA.run_selfplay_segment(tcfg, TSP, port_settings(settings), tev, torch_states(jstates),
                                       torch.zeros((batch,), dtype=torch.int64), num_moves, device="cpu",
                                       draws=draws, **tpools)
    finally:
        TM.policy_target = kept
    return jout, tout, trees


def assert_same_states(jstates, tstates, label):
    for name, a, b in zip(TB.GameState._fields, tstates, jstates):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype)), f"{label}.{name}"


def assert_policy_targets_match(jtraj, ttraj, trees):
    """Policy targets within 1e-5, or apart only by the ceil step: JAX's row,
    scaled to some total, is the port's play-selection weights plus whole
    units at children whose weight lies within NEAR_INTEGER of an integer.
    On the port's own trees the two packages' readouts are equal."""
    jpt, tpt = np.asarray(jtraj.policy_target), ttraj.policy_target.numpy()
    stepped = 0
    for move, tree in enumerate(trees):
        v = TM.root_play_selection_weights(TSP, tree).numpy()
        jtree = jax_tree(tree)
        np.testing.assert_allclose(v, np.asarray(JM.root_play_selection_weights(JSP, jtree)), atol=1e-6, rtol=0)
        np.testing.assert_allclose(tpt[move], np.asarray(JM.policy_target(jtree, JSP)), atol=1e-6, rtol=0)
        w = TM._root_child_stats(tree)["w"].numpy()
        near = (w > 0) & (np.abs(w - np.round(w)) <= NEAR_INTEGER * np.maximum(np.abs(w), 1.0))
        for b in range(tpt.shape[1]):
            if np.abs(tpt[move, b] - jpt[move, b]).max() <= 1e-5:
                continue
            n = int(near[b].sum())
            ok = False
            for total in v[b].sum() + np.arange(-n, n + 1):
                d = jpt[move, b] * total - v[b]
                units = np.round(d)
                tol = 1e-5 * total + 1e-6
                if (np.abs(d - units) <= tol).all() and (np.abs(units) <= near[b]).all():
                    ok = True
                    break
            assert ok, (move, b, tpt[move, b][tpt[move, b] > 0], jpt[move, b][jpt[move, b] > 0], w[b][w[b] > 0])
            stepped += 1
    return stepped


def assert_same_trajectory(jtraj, ttraj, trees):
    for name in ("states", "fork_states", "tree_pos_states"):
        assert_same_states(getattr(jtraj, name), getattr(ttraj, name), name)
    for name in EXACT:
        a, b = getattr(ttraj, name).numpy(), np.asarray(getattr(jtraj, name))
        assert a.shape == b.shape and np.array_equal(a, b.astype(a.dtype)), (name, np.argwhere(a != b)[:5])
    for names, atol in ((WITHIN_1E5, 1e-5), (WITHIN_2E4, 2e-4)):
        for name in names:
            np.testing.assert_allclose(getattr(ttraj, name).numpy(), np.asarray(getattr(jtraj, name)), atol=atol,
                                       rtol=0, err_msg=name)
    return assert_policy_targets_match(jtraj, ttraj, trees)


def jax_trajectory(ttraj, like):
    """The port's Trajectory in the JAX package's types (those of `like`)."""
    def conv(t, j):
        if isinstance(j, JB.GameState):
            return JB.GameState(*(conv(a, b) for a, b in zip(t, j)))
        return jnp.asarray(t.numpy().astype(np.asarray(j).dtype))

    return JA.Trajectory(*(conv(t, j) for t, j in zip(ttraj, like)))


def late_positions(batch, seed, empty=2):
    """JAX states: `empty` empty boards, the rest 1-4 plies before the end
    of a random legal game (so that they end within the segment)."""
    rng = np.random.default_rng(seed)
    legal_fn, step_fn = jitted.legal_mask_flat_fn(CFG), jitted.step_fn(CFG)
    out = [JB.init_state(CFG) for _ in range(empty)]
    while len(out) < batch:
        s, line = JB.init_state(CFG), []
        while not bool(s.done):
            line.append(s)
            legal = np.flatnonzero(np.asarray(legal_fn(s)))
            s = step_fn(s, jnp.asarray(int(rng.choice(legal)), jnp.int32))
        out.append(line[max(0, len(line) - int(rng.integers(1, 5)))])
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *out)


# ---------------------------------------------------------------------------
# The segment at the default settings
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _default_segment():
    jev, tev = _evals(B6C96)
    settings = JA.SelfplaySettings(num_sims=VISITS)
    jstates = late_positions(B, seed=3)
    return (jev, tev, settings, jstates) + run_both(jev, tev, settings, jstates, jax.random.PRNGKey(21), MOVES)


def test_segment_matches_jax():
    *_, jstates, (jst, jep, jtraj), (tst, tep, ttraj), trees = _default_segment()
    assert len(trees) == MOVES
    assert_same_trajectory(jtraj, ttraj, trees)
    assert_same_states(jst, tst, "new_states")
    assert np.array_equal(tep.numpy(), np.asarray(jep))
    done = ttraj.done_after.numpy()
    # games ended and reset inside the segment, and a reset game searched
    # again (reuse_ok False beside reused trees); some openings were
    # policy-initialized
    assert done[:-1].any() and (ttraj.episode_id[-1] > 0).any()
    assert ttraj.policy_init.any()
    assert (ttraj.root_visits == VISITS + 1).all()


def test_finalize_on_the_segment_matches_jax():
    """Both packages' finalize_targets on the port's trajectory."""
    _, _, settings, _, (_, _, jtraj), (_, _, ttraj), _ = _default_segment()
    jbatch = jax.jit(lambda tr: JA.finalize_targets(CFG, settings, tr))(jax_trajectory(ttraj, jtraj))
    tbatch = TA.finalize_targets(TCFG, port_settings(settings), ttraj)
    assert_same_batch(jbatch, tbatch)
    assert (tbatch.weight > 0).any()


def test_first_move_fresh_search_equals_reuse_with_nothing_to_reuse():
    """The port's fresh first move against its reuse branch with `reuse_ok`
    all False on some other tree, under the same draws: the same tree."""
    _, tev, settings, jstates, _, (_, _, ttraj), _ = _default_segment()
    roots = torch_states(jstates)
    g = torch.Generator().manual_seed(1)
    draws = TM.RootDraws(syms=torch.argsort(torch.rand((B, 8), generator=g), -1)[:, :4],
                         gamma=torch._standard_gamma(torch.full((B, TCFG.policy_size), 0.3), generator=g),
                         gamma_reused=torch._standard_gamma(torch.full((B, TCFG.policy_size), 0.3), generator=g))
    nodes = port_settings(settings).nodes()
    other = TM.run_search(TCFG, TSP, tev, roots, 8, nodes, device="cpu", draws=draws)
    fresh = TM.run_search(TCFG, TSP, tev, roots, VISITS, nodes, device="cpu", draws=draws)
    reused = TM.run_search(TCFG, TSP, tev, roots, VISITS, nodes, device="cpu", draws=draws, reuse_tree=other,
                           reuse_actions=ttraj.played_action[0], reuse_ok=torch.zeros((B,), dtype=torch.bool))
    for name in TM.Tree._fields:
        a, b = getattr(fresh, name), getattr(reused, name)
        for x, y in zip(a if name == "states" else (a,), b if name == "states" else (b,)):
            assert torch.equal(x, y), name
