"""The lockstep selfplay actor, in PyTorch: B games advance one move at a
time, every move a batched search (`search/mcts.py`), finished games reset
in place so the batch stays full; then the training targets of the segment.

The port of `katacoffee_tpu/selfplay/actor.py`. JAX's `lax.scan` over the
moves is a Python loop here; a move's records are stacked to [T, B, ...] at
the end. Resets, openings and tree carry are tensor selects on the device:
the loop reads nothing back from the card beyond what the search reads.

Randomness: each move draws the search's root randomness, `select_moves`'
Gumbel noise, the policy-initialized opening move's Gumbel noise, the
opening lengths of games that reset, and, where enabled, the side-position,
start-position and hint-position draws. They come from the
`torch.Generator` the caller passes (on the segment's device), or are passed
in as tensors (`SegmentDraws`), as the tests pass the JAX package's draws:
`jax.random.categorical` is the argmax of logits plus Gumbel noise, so
injected noise reproduces it exactly.

A segment's first move searches a fresh tree. The JAX package runs it
through its reuse branch with a placeholder tree and `reuse_ok` all False,
which builds the same fresh root from the same draws (`RootDraws.gamma`) and
runs the same number of playouts, without evaluating a placeholder.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from katacoffee_tpu_torch.device import resolve_device
from katacoffee_tpu_torch.game.board import GameConfig, GameState, init_state, per_cell_max_run, step
from katacoffee_tpu_torch.search import mcts
from katacoffee_tpu_torch.search.mcts import F_DRAW, F_WL, S_DRAW, S_VISITS, S_WL
from katacoffee_tpu_torch.search.params import SearchParams
from katacoffee_tpu_torch.selfplay.forking import ForkPool
from katacoffee_tpu_torch.selfplay.treerecord import empty_tree_position_fields, record_tree_positions


@dataclasses.dataclass(frozen=True)
class SelfplaySettings:
    """Selfplay data settings: the JAX package's fields and defaults (the
    live subset of KataGo's PlaySettings)."""

    num_sims: int = 100
    max_nodes: int | None = None  # default max(64, node_budget_frac * num_sims + 2)
    node_budget_frac: float = 0.3
    # TD lambdas: lambda = 1 - 1 / (1 + area * c)
    td_coeffs: tuple = (0.176, 0.056, 0.016)
    # policy-initialized openings: ~Exponential() * area * prop moves from
    # the raw policy at the temperature; those rows get weight 0
    init_games_with_policy: bool = True
    policy_init_area_prop: float = 0.04
    policy_init_temperature: float = 1.0
    # surprise-weighted rows: this share of each episode's weight moves onto
    # the rows whose search result surprised the raw net
    policy_surprise_weight: float = 0.5
    value_surprise_weight: float = 0.1
    # fraction of episodes starting from a start-pool / hint-pool position
    startposes_prob: float = 0.0
    hintposes_prob: float = 0.0
    # side positions: per recorded move, the probability of forking the
    # position with a non-played move for a later side search
    side_position_prob: float = 0.0
    side_position_capacity: int = 128
    # whole-game forking (selfplay/forking.py)
    early_fork_game_prob: float = 0.0
    early_fork_game_expected_move_prop: float = 0.025
    fork_game_prob: float = 0.0
    fork_game_min_choices: int = 3
    early_fork_game_max_choices: int = 12
    fork_game_max_choices: int = 36
    fork_pool_capacity: int = 64
    # tree-position recording (selfplay/treerecord.py)
    record_tree_positions: bool = False
    record_tree_threshold: int = 0
    record_tree_target_weight: float = 0.0
    record_tree_capacity: int = 8
    # each move's search starts from the played child's subtree
    tree_reuse: bool = True

    def nodes(self) -> int:
        """The node capacity of a move's search."""
        return self.max_nodes or max(64, int(self.num_sims * self.node_budget_frac) + 2)


class Trajectory(NamedTuple):
    """Per-(move, game) records of a segment, leading dims [T, B]. States
    are the positions before each move."""

    states: GameState
    policy_target: torch.Tensor  # [T, B, A]
    played_action: torch.Tensor  # [T, B] int64
    root_wl: torch.Tensor  # [T, B] search win-loss, mover perspective
    root_draw: torch.Tensor  # [T, B]
    root_visits: torch.Tensor  # [T, B] int32
    done_after: torch.Tensor  # [T, B] the game ended on this move
    winner_after: torch.Tensor  # [T, B] int8, 0 draw or not ended
    final_board: torch.Tensor  # [T, B, Y, X] board after the move
    episode_id: torch.Tensor  # [T, B] int64 running episode counter per game
    raw_policy: torch.Tensor  # [T, B, A] the root's raw net policy
    raw_value: torch.Tensor  # [T, B, 3] the root's raw net win/loss/draw
    policy_init: torch.Tensor  # [T, B] the move was a policy-init opening move
    fork_states: GameState  # [T, B] side-position forks (after the fork move)
    fork_valid: torch.Tensor  # [T, B]
    hint_first: torch.Tensor  # [T, B] searched with a rootHintLoc
    hint_action: torch.Tensor  # [T, B] int64 that rootHintLoc, -1 none
    tree_pos_states: GameState  # [T, B, M] recorded tree positions (M = 0 when off)
    tree_pos_policy: torch.Tensor  # [T, B, M, A]
    tree_pos_value: torch.Tensor  # [T, B, M, 3]
    tree_pos_valid: torch.Tensor  # [T, B, M]


class TrainingBatch(NamedTuple):
    """Finalized training rows, flattened [R, ...]."""

    states: GameState
    policy_target: torch.Tensor  # [R, A]
    opponent_policy_target: torch.Tensor  # [R, A] the next turn's policy target
    value_target: torch.Tensor  # [R, 3] win/loss/draw one-hot, mover perspective
    td_value_targets: torch.Tensor  # [R, num_lambdas, 3] win/loss/draw probabilities
    ownership_target: torch.Tensor  # [R, Y, X] -1/0/+1 mover perspective
    line_target: torch.Tensor  # [R, Y, X] int32 final per-cell longest run
    futurepos_target: torch.Tensor  # [R, 2, Y, X] +-1/0 boards at +2 and +4 plies
    var_time_left_target: torch.Tensor  # [R] plies until the game ends
    shortterm_value_target: torch.Tensor  # [R] the next search's win-loss, mover perspective
    weight: torch.Tensor  # [R] 0 = masked or unfinished episode
    opponent_policy_weight: torch.Tensor  # [R] 0 on an episode's last row
    aux_weight: torch.Tensor  # [R] 1 for game rows, 0 for side rows


class ForkMoveDraws(NamedTuple):
    """The draws of `_sample_fork_move` for [B] games: `mix` [B] uniform
    picks the sampler, each sampler has its Gumbel noise [B, A]."""

    mix: torch.Tensor
    gumbel_t1: torch.Tensor
    gumbel_t2: torch.Tensor
    gumbel_uniform: torch.Tensor


class MoveDraws(NamedTuple):
    """One move's draws. `search` is the search's `RootDraws`; `select` [B,
    A] the Gumbel noise of `select_moves`, `init_move` [B, A] the opening
    move's; `init_len` [B] Exponential(1) draws for the opening lengths of
    the games that reset after this move. The rest are needed only where
    their setting is on: `fork` [B] uniform (side-position coin) and
    `fork_move`; `startpos` and `hintpos` as (uniform [B], Gumbel [B, K])
    over their pool."""

    search: mcts.RootDraws
    select: torch.Tensor
    init_move: torch.Tensor
    init_len: torch.Tensor
    fork: torch.Tensor | None = None
    fork_move: ForkMoveDraws | None = None
    startpos: tuple | None = None
    hintpos: tuple | None = None


class SegmentDraws(NamedTuple):
    """A segment's draws: `init_len` [B] Exponential(1) for the opening
    lengths of the games entering on an empty board, one MoveDraws a move."""

    init_len: torch.Tensor
    moves: tuple


class SideDraws(NamedTuple):
    """The draws of `run_side_segment` for C lanes: the search's RootDraws,
    `select` [C, A] Gumbel noise of the response move, `cont` [C] uniform
    (the continuation coin) and the continuation's fork move."""

    search: mcts.RootDraws
    select: torch.Tensor
    cont: torch.Tensor
    fork_move: ForkMoveDraws


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------


def _uniform(given, shape, generator, dev) -> torch.Tensor:
    if given is not None:
        return given.to(dev)
    return torch.rand(shape, generator=mcts._need_generator(generator, "selfplay"), device=dev)


def _exponential(given, shape, generator, dev) -> torch.Tensor:
    if given is not None:
        return given.to(dev)
    return torch.empty(shape, device=dev).exponential_(generator=mcts._need_generator(generator, "selfplay"))


def _gumbel(given, shape, generator, dev) -> torch.Tensor:
    """Gumbel noise: argmax(logits + noise) samples softmax(logits), as
    jax.random.categorical computes it."""
    if given is not None:
        return given.to(dev)
    e = _exponential(None, shape, generator, dev)
    return -torch.log(e.clamp(min=torch.finfo(torch.float32).tiny))


def _fork_move_draws(given, B, A, generator, dev) -> ForkMoveDraws:
    if given is not None:
        return ForkMoveDraws(*(x.to(dev) for x in given))
    return ForkMoveDraws(_uniform(None, (B,), generator, dev),
                         *(_gumbel(None, (B, A), generator, dev) for _ in range(3)))


def _sample_fork_move(raw_policy: torch.Tensor, ban_action: torch.Tensor, draws: ForkMoveDraws):
    """chooseRandomForkingMove (play.cpp:615-634): 70 % a temperature-1
    policy sample, 25 % temperature 2, 5 % uniform over legal moves, never
    the banned move (-1 bans nothing). `raw_policy` [B, A] is zero on
    illegal moves. Returns (action [B], ok [B]); ok is False where no legal
    move but the banned one exists."""
    A = raw_policy.shape[-1]
    banned = torch.arange(A, device=raw_policy.device)[None, :] == ban_action[:, None]
    p = torch.where(banned, 0.0, raw_policy)
    legal = p > 0
    ok = legal.any(-1)
    logits1 = torch.where(legal, torch.log(p.clamp(min=1e-30)), -math.inf)
    a1 = torch.argmax(logits1 + draws.gumbel_t1, dim=-1)
    a2 = torch.argmax(logits1 / 2.0 + draws.gumbel_t2, dim=-1)
    au = torch.argmax(torch.where(legal, 0.0, -math.inf) + draws.gumbel_uniform, dim=-1)
    r = draws.mix
    act = torch.where(r < 0.70, a1, torch.where(r < 0.95, a2, au))
    return torch.where(ok, act, 0), ok


def _init_len(cfg: GameConfig, settings: SelfplaySettings, given, B, generator, dev) -> torch.Tensor:
    """~Exponential() * area * prop opening moves (playutils.cpp:160-161)."""
    if not settings.init_games_with_policy:
        return torch.zeros((B,), dtype=torch.int64, device=dev)
    e = _exponential(given, (B,), generator, dev)
    return torch.floor(e * cfg.area * settings.policy_init_area_prop).to(torch.int64)


def _select_state(mask: torch.Tensor, a: GameState, b: GameState) -> GameState:
    """`a` where `mask` [B], else `b`."""
    B = mask.shape[0]
    return GameState(*(torch.where(mask.reshape((B,) + (1,) * (x.dim() - 1)), x, y) for x, y in zip(a, b)))


def _pool_pick(pool_states: GameState, probs, given, settings_prob, B, generator, dev):
    """(from_pool [B], picked states [B], idx [B]): with `settings_prob` a
    game takes a pool position sampled by `probs` [K]."""
    u, gumbel = (None, None) if given is None else given
    K = probs.shape[0]
    take = _uniform(u, (B,), generator, dev) < settings_prob
    logits = torch.log(probs.to(dev).clamp(min=1e-30))[None, :]
    idx = torch.argmax(logits + _gumbel(gumbel, (B, K), generator, dev), dim=-1)
    return take, pool_states.map(lambda x: x.to(dev)[idx]), idx


# ---------------------------------------------------------------------------
# The segment
# ---------------------------------------------------------------------------


@torch.no_grad()
def run_selfplay_segment(
    cfg: GameConfig,
    sp: SearchParams,
    settings: SelfplaySettings,
    eval_fn: mcts.EvalFn,
    states: GameState,
    episode_id: torch.Tensor,
    num_moves: int,
    *,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
    draws: SegmentDraws | None = None,
    startpos_pool: tuple | None = None,
    hintpos_pool: tuple | None = None,
    fork_pool: ForkPool | None = None,
):
    """Advance B games `num_moves` plies on `device` (default `cuda`; the
    evaluator must run there). Returns (new_states, new_episode_id,
    Trajectory), plus the drained ForkPool when `fork_pool` is given.

    `startpos_pool` = (states [K], probs [K]): with `startposes_prob` a
    resetting episode starts from a sampled pool position (no policy-init
    opening). `hintpos_pool` = (states [K], probs [K], hint_actions [K]):
    with `hintposes_prob` it starts from a hint position whose move is the
    rootHintLoc of its first search. `fork_pool`: resetting games pop queued
    fork positions first, in order, and skip every other start.

    Draws come from `draws` (one MoveDraws per move) or `generator`."""
    dev = resolve_device(device)
    st = states.map(lambda x: x.to(dev))
    ep = episode_id.to(dev, torch.int64)
    B = st.board.shape[0]
    A = cfg.policy_size
    max_nodes = settings.nodes()
    if draws is not None and len(draws.moves) != num_moves:
        raise ValueError(f"draws for {len(draws.moves)} moves, segment of {num_moves}")

    fresh_board = init_state(cfg, B, dev)
    init_left = torch.where(
        st.num_turns == 0,
        _init_len(cfg, settings, None if draws is None else draws.init_len, B, generator, dev), 0)
    hint = torch.full((B,), -1, dtype=torch.int64, device=dev)
    prev_tree, prev_action, reuse_ok = None, None, None
    pool_valid = None if fork_pool is None else fork_pool.valid.to(dev)
    recs = []
    for t in range(num_moves):
        d = None if draws is None else draws.moves[t]
        reuse = {} if prev_tree is None else dict(reuse_tree=prev_tree, reuse_actions=prev_action,
                                                  reuse_ok=reuse_ok)
        tree = mcts.run_search(cfg, sp, eval_fn, st, settings.num_sims, max_nodes, device=dev,
                               generator=generator, draws=None if d is None else d.search, root_hint=hint,
                               **reuse)
        pt = mcts.policy_target(tree, sp)
        raw_policy = tree.prior[:, 0].clamp(min=0.0)
        selfs = tree.self_stats[:, 0]  # the root's raw net evaluation
        raw_draw = selfs[:, F_DRAW].clamp(0.0, 1.0)
        raw_wl = selfs[:, F_WL]
        raw_value = torch.stack([
            ((1.0 - raw_draw + raw_wl) * 0.5).clamp(1e-6, 1.0),
            ((1.0 - raw_draw - raw_wl) * 0.5).clamp(1e-6, 1.0),
            raw_draw.clamp(min=1e-6),
        ], dim=-1)

        action = mcts.select_moves(cfg, sp, tree, generator=generator, gumbel=None if d is None else d.select)
        is_init = init_left > 0
        if settings.init_games_with_policy:
            # the opening move straight from the tempered raw policy
            logits = torch.where(
                raw_policy > 0, torch.log(raw_policy.clamp(min=1e-30)) / settings.policy_init_temperature,
                -math.inf)
            noise = _gumbel(None if d is None else d.init_move, (B, A), generator, dev)
            action = torch.where(is_init, torch.argmax(logits + noise, dim=-1), action)
        nxt = step(cfg, st, action)

        # side positions (play.cpp:1328-1345), before tree recording: the
        # fork move is a root exclusion there
        if settings.side_position_prob > 0.0:
            fm_draws = _fork_move_draws(None if d is None else d.fork_move, B, A, generator, dev)
            fork_move, fork_ok = _sample_fork_move(raw_policy, action, fm_draws)
            fork_st = step(cfg, st, fork_move)
            coin = _uniform(None if d is None else d.fork, (B,), generator, dev)
            fork_valid = (coin < settings.side_position_prob) & ~is_init & fork_ok & ~fork_st.done
        else:
            fork_move = torch.full((B,), -1, dtype=torch.int64, device=dev)
            fork_valid = torch.zeros((B,), dtype=torch.bool, device=dev)
            fork_st = st
        rec = dict(
            states=st, policy_target=pt, played_action=action, root_wl=tree.stats[:, 0, S_WL],
            root_draw=tree.stats[:, 0, S_DRAW], root_visits=(tree.stats[:, 0, S_VISITS] + 0.5).to(torch.int32),
            done_after=nxt.done, winner_after=nxt.winner, final_board=nxt.board, episode_id=ep,
            raw_policy=raw_policy, raw_value=raw_value, policy_init=is_init, fork_states=fork_st,
            fork_valid=fork_valid, hint_first=hint >= 0, hint_action=hint,
        )
        if settings.record_tree_positions and settings.record_tree_target_weight > 0:
            tp = record_tree_positions(
                cfg, tree, exclude0=action, exclude1=torch.where(fork_valid, fork_move, -1), row_ok=~is_init,
                threshold=settings.record_tree_threshold, capacity=settings.record_tree_capacity)
            rec.update(tree_pos_states=tp[0], tree_pos_policy=tp[1], tree_pos_value=tp[2], tree_pos_valid=tp[3])
        else:
            rec.update(empty_tree_position_fields(cfg, tree.states, B))
        recs.append(rec)

        # reset finished games: an empty board, a start or hint position, or
        # a queued fork
        fresh = fresh_board
        from_startpos = torch.zeros((B,), dtype=torch.bool, device=dev)
        if startpos_pool is not None and settings.startposes_prob > 0.0:
            from_startpos, picked, _ = _pool_pick(startpos_pool[0], startpos_pool[1],
                                                  None if d is None else d.startpos, settings.startposes_prob,
                                                  B, generator, dev)
            fresh = _select_state(from_startpos, picked, fresh)
        from_hintpos = torch.zeros((B,), dtype=torch.bool, device=dev)
        hint_new = torch.full((B,), -1, dtype=torch.int64, device=dev)
        if hintpos_pool is not None and settings.hintposes_prob > 0.0:
            from_hintpos, picked, idx = _pool_pick(hintpos_pool[0], hintpos_pool[1],
                                                   None if d is None else d.hintpos, settings.hintposes_prob,
                                                   B, generator, dev)
            fresh = _select_state(from_hintpos, picked, fresh)
            hint_new = torch.where(from_hintpos, hintpos_pool[2].to(dev, torch.int64)[idx], -1)
        use_fork = torch.zeros((B,), dtype=torch.bool, device=dev)
        if fork_pool is not None:
            # the game with reset rank r takes the r-th valid pool entry
            vrank = torch.cumsum(pool_valid.to(torch.int64), 0) - 1
            rrank = torch.cumsum(nxt.done.to(torch.int64), 0) - 1
            use_fork = nxt.done & (rrank < pool_valid.sum())
            assign = pool_valid[None, :] & (vrank[None, :] == rrank[:, None])  # [B, Kf]
            entry = assign.to(torch.uint8).argmax(1)
            fresh = _select_state(use_fork, fork_pool.states.map(lambda x: x.to(dev)[entry]), fresh)
            pool_valid = pool_valid & ~(vrank < nxt.done.sum())
            hint_new = torch.where(use_fork, -1, hint_new)
        st = _select_state(nxt.done, fresh, nxt)
        ep = ep + nxt.done.to(torch.int64)
        # policy-init openings are not for start, hint or forked episodes
        new_len = _init_len(cfg, settings, None if d is None else d.init_len, B, generator, dev)
        init_left = torch.where(nxt.done, torch.where(from_startpos | from_hintpos | use_fork, 0, new_len),
                                (init_left - 1).clamp(min=0))
        # a hint applies at the hint position itself, the episode's first search
        hint = torch.where(nxt.done, hint_new, -1)
        if settings.tree_reuse:
            # the next move reuses the played child's subtree, except where
            # the episode just reset
            prev_tree, prev_action, reuse_ok = tree, action, ~nxt.done

    traj = Trajectory(**{
        name: (GameState(*(torch.stack(f) for f in zip(*(r[name] for r in recs)))) if name.endswith("states")
               else torch.stack([r[name] for r in recs]))
        for name in Trajectory._fields
    })
    if fork_pool is not None:
        return st, ep, traj, ForkPool(fork_pool.states, pool_valid)
    return st, ep, traj


# ---------------------------------------------------------------------------
# Training targets
# ---------------------------------------------------------------------------


@torch.no_grad()
def finalize_targets(cfg: GameConfig, settings: SelfplaySettings, traj: Trajectory) -> TrainingBatch:
    """The segment's training rows, [T * B] flattened, on the trajectory's
    device (play.cpp:1431-1459 and trainingwrite.cpp:400-561 semantics),
    back-filled by a reverse pass over the moves:
      * the final result (win/loss/draw one-hot) for each row's mover;
      * TD(lambda) value targets mixing later search values with the result;
      * final-board ownership and per-cell longest line, mover perspective;
      * the boards 2 and 4 plies on, plies left, the next search's value;
      * weight 0 on rows of episodes that do not end in the segment and on
        policy-init opening rows; surprise reweighting within each episode.
    """
    T, B = traj.played_action.shape
    dev = traj.played_action.device
    Y, X = cfg.y_size, cfg.x_size
    lambdas = [1.0 - 1.0 / (1.0 + cfg.area * c) for c in settings.td_coeffs]
    L = len(lambdas)
    mover = traj.states.to_move.to(torch.int64)  # [T, B]

    # a hint row's value is skewed by the hint's forced playouts: it takes
    # the next search's value, seen from this mover (play.cpp:1465-1470)
    wl_in, draw_in = traj.root_wl, traj.root_draw
    if settings.hintposes_prob > 0.0:
        wl_next = torch.cat([wl_in[1:], wl_in[-1:]], dim=0)
        draw_next = torch.cat([draw_in[1:], draw_in[-1:]], dim=0)
        use_next = traj.hint_first & ~traj.done_after
        wl_in = torch.where(use_next, -wl_next, wl_in)
        draw_in = torch.where(use_next, draw_next, draw_in)

    # the reverse pass; the carry describes row t + 1's episode
    zb = torch.zeros((B,), dtype=torch.float32, device=dev)
    board0 = torch.zeros((B, Y, X), dtype=traj.final_board.dtype, device=dev)
    valid = torch.zeros((B,), dtype=torch.bool, device=dev)
    z_next, next_wl = zb, zb
    td_next = [zb] * L
    td_draw_next = [zb] * L
    steps = torch.zeros((B,), dtype=torch.int64, device=dev)
    fboard, a1, a2, a3 = board0, board0, board0, board0
    next_pt = torch.zeros((B, cfg.policy_size), dtype=torch.float32, device=dev)
    outs = [None] * T
    for t in range(T - 1, -1, -1):
        done_t = traj.done_after[t]
        winner_t = traj.winner_after[t].to(torch.int64)
        wl_t, draw_t, board_after = wl_in[t], draw_in[t], traj.final_board[t]
        z_end = torch.where(winner_t == 0, 0.0, torch.where(winner_t == mover[t], 1.0, -1.0))
        draw_end = (winner_t == 0).to(torch.float32)
        z = torch.where(done_t, z_end, -z_next)
        td = [torch.where(done_t, z_end, (1.0 - lam) * wl_t + lam * -td_next[i]) for i, lam in enumerate(lambdas)]
        td_draw = [torch.where(done_t, draw_end, (1.0 - lam) * draw_t + lam * td_draw_next[i])
                   for i, lam in enumerate(lambdas)]
        row_valid = done_t | (~done_t & valid)
        steps_here = torch.where(done_t, 1, steps + 1)
        dmask = done_t[:, None, None]
        fb = torch.where(dmask, board_after, fboard)
        outs[t] = dict(
            valid=row_valid, z=z, td=torch.stack(td, -1), td_draw=torch.stack(td_draw, -1), steps=steps_here,
            final_board=fb, next_policy=next_pt, opp_weight=~done_t & row_valid,
            shortterm=torch.where(done_t, z_end, -next_wl),
            fut1=torch.where(dmask, board_after, a1),  # +2 plies from the row's state
            fut2=torch.where(dmask, board_after, a3),  # +4 plies
        )
        valid, z_next, td_next, td_draw_next, steps, fboard = row_valid, z, td, td_draw, steps_here, fb
        next_pt, next_wl = traj.policy_target[t], wl_t
        a1, a2, a3 = board_after, torch.where(dmask, board_after, a1), torch.where(dmask, board_after, a2)
    outs = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    valid, z, fb = outs["valid"], outs["z"], outs["final_board"]
    vt = torch.stack([(z > 0.5).to(torch.float32), (z < -0.5).to(torch.float32),
                      (z.abs() <= 0.5).to(torch.float32)], dim=-1)
    mover_b = mover[..., None, None].to(fb.dtype)

    def signed(board):
        return torch.where(board == mover_b, 1.0, torch.where(board == 0, 0.0, -1.0))

    own = signed(fb)
    lines = torch.where(fb != 0, per_cell_max_run(cfg, fb), 0).to(torch.int32)
    futurepos = torch.stack([signed(outs["fut1"]), signed(outs["fut2"])], dim=2)
    weight = (valid & ~traj.policy_init).to(torch.float32)

    # surprise reweighting per (game, episode) (play.cpp:1501-1570): the
    # episode keeps its total weight, policy_surprise_weight of it goes to
    # rows by KL(search || raw policy), value_surprise_weight by KL(result ||
    # raw value). Per-row episode totals are masked sums over the moves of
    # the same game: no scattered adds, so the card gives the same bits on
    # every run.
    psw, vsw0 = settings.policy_surprise_weight, settings.value_surprise_weight
    if psw > 0.0 or vsw0 > 0.0:
        pt_ = traj.policy_target
        ps = torch.where(
            pt_ > 0, pt_ * (torch.log(pt_.clamp(min=1e-30)) - torch.log(traj.raw_policy.clamp(min=1e-30))), 0.0
        ).sum(-1)
        vs = -(vt * torch.log(traj.raw_value.clamp(min=1e-30))).sum(-1) + (vt * torch.log(vt.clamp(min=1e-30))).sum(-1)
        ps, vs = ps.clamp(min=0.0), vs.clamp(min=0.0)
        same = (traj.episode_id[:, None, :] == traj.episode_id[None, :, :]).to(torch.float32)  # [T, T', B]

        def episode_total(x):  # [T, B]: the sum of x over the row's episode
            return (same * x[None, :, :]).sum(1)

        Wd, PSP, VSP = episode_total(weight), episode_total(weight * ps), episode_total(weight * vs)
        # value surprise fades out where the episode had almost none (play.cpp:1527-1532)
        vsw = vsw0 * (VSP / Wd.clamp(min=1e-8) / 0.010).clamp(max=1.0)
        new_w = ((1.0 - psw - vsw) * weight + psw * (weight * ps) * Wd / PSP.clamp(min=1e-10)
                 + vsw * (weight * vs) * Wd / VSP.clamp(min=1e-10))
        # only episodes with enough rows are reweighted
        weight = torch.where(Wd >= 1.0, new_w, weight)

    def flat(x):
        return x.reshape((T * B,) + x.shape[2:])

    # (wl, draw) TD pairs to win/loss/draw probabilities
    td_wl = outs["td"]  # [T, B, L]
    td_d = outs["td_draw"].clamp(0.0, 1.0)
    td_probs = torch.stack([((1.0 - td_d + td_wl) / 2.0).clamp(0.0, 1.0), ((1.0 - td_d - td_wl) / 2.0).clamp(0.0, 1.0),
                            td_d], dim=-1)
    td_probs = td_probs / td_probs.sum(-1, keepdim=True).clamp(min=1e-8)

    return TrainingBatch(
        states=traj.states.map(flat),
        policy_target=flat(traj.policy_target),
        opponent_policy_target=flat(outs["next_policy"]),
        value_target=flat(vt),
        td_value_targets=flat(td_probs),
        ownership_target=flat(own),
        line_target=flat(lines),
        futurepos_target=flat(futurepos),
        var_time_left_target=flat(outs["steps"].to(torch.float32)),
        shortterm_value_target=flat(outs["shortterm"]),
        weight=flat(weight),
        opponent_policy_weight=flat(outs["opp_weight"].to(torch.float32) * weight),
        aux_weight=torch.ones((T * B,), dtype=torch.float32, device=dev),
    )


# ---------------------------------------------------------------------------
# Side positions (play.cpp:1254, 1328-1345, 1578-1665)
# ---------------------------------------------------------------------------


class SideState(NamedTuple):
    """Pending side positions carried from one segment to the next (the
    reference's sidePositionsToSearch queue)."""

    states: GameState  # [C]
    valid: torch.Tensor  # [C] bool


def init_side_state(cfg: GameConfig, capacity: int, device: str | torch.device | None = None) -> SideState:
    """An empty side queue of `capacity` lanes on `device` (default `cuda`)."""
    dev = resolve_device(device)
    return SideState(states=init_state(cfg, capacity, dev),
                     valid=torch.zeros((capacity,), dtype=torch.bool, device=dev))


@torch.no_grad()
def run_side_segment(
    cfg: GameConfig,
    sp: SearchParams,
    settings: SelfplaySettings,
    eval_fn: mcts.EvalFn,
    side: SideState,
    traj: Trajectory,
    *,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
    draws: SideDraws | None = None,
) -> tuple[SideState, TrainingBatch]:
    """Search the queued side positions, carried ones first and then the
    segment's new forks, C = side capacity at once, in one batched search on
    `device` (default `cuda`), and emit their rows: the side search's policy
    target, its root value as value and TD targets, no opponent-policy and no
    game-outcome targets. Then sample the continuations (play.cpp:1634-1660):
    the search's response plus a new fork move, kept with probability 0.25
    for the next segment's side batch. Draws come from `draws` or
    `generator`."""
    dev = resolve_device(device)
    C = side.valid.shape[0]
    A = cfg.policy_size
    flat_states = traj.fork_states.map(lambda x: x.to(dev).reshape((-1,) + x.shape[2:]))
    all_states = GameState(*(torch.cat([a.to(dev), b], 0) for a, b in zip(side.states, flat_states)))
    all_valid = torch.cat([side.valid.to(dev), traj.fork_valid.to(dev).reshape(-1)])
    order = torch.argsort((~all_valid).to(torch.uint8), stable=True)[:C]
    states_c = all_states.map(lambda x: x[order])
    valid_c = all_valid[order]

    tree = mcts.run_search(cfg, sp, eval_fn, states_c, settings.num_sims, settings.nodes(), device=dev,
                           generator=generator, draws=None if draws is None else draws.search)
    pt = mcts.policy_target(tree, sp)
    wl = tree.stats[:, 0, S_WL]
    draw = tree.stats[:, 0, S_DRAW].clamp(0.0, 1.0)
    vt = torch.stack([((1.0 - draw + wl) * 0.5).clamp(0.0, 1.0), ((1.0 - draw - wl) * 0.5).clamp(0.0, 1.0), draw],
                     dim=-1)
    vt = vt / vt.sum(-1, keepdim=True).clamp(min=1e-8)
    L = len(settings.td_coeffs)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    Y, X = cfg.y_size, cfg.x_size
    batch = TrainingBatch(
        states=states_c,
        policy_target=pt,
        opponent_policy_target=zeros(C, A),
        value_target=vt,
        td_value_targets=vt[:, None, :].expand(C, L, 3).clone(),
        ownership_target=zeros(C, Y, X),
        line_target=zeros(C, Y, X, dtype=torch.int32),
        futurepos_target=zeros(C, 2, Y, X),
        var_time_left_target=zeros(C),
        shortterm_value_target=zeros(C),
        weight=valid_c.to(torch.float32),
        opponent_policy_weight=zeros(C),
        aux_weight=zeros(C),
    )

    response = mcts.select_moves(cfg, sp, tree, generator=generator, gumbel=None if draws is None else draws.select)
    nxt = step(cfg, states_c, response)
    res = eval_fn(nxt)
    fm_draws = _fork_move_draws(None if draws is None else draws.fork_move, C, A, generator, dev)
    fork2, ok2 = _sample_fork_move(res.policy, torch.full((C,), -1, dtype=torch.int64, device=dev), fm_draws)
    st2 = step(cfg, nxt, fork2)
    cont = _uniform(None if draws is None else draws.cont, (C,), generator, dev)
    keep = valid_c & (cont < 0.25) & ~nxt.done & ok2 & ~st2.done
    return SideState(states=st2, valid=keep), batch
