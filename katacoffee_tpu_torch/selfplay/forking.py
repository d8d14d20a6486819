"""Whole-game forking for opening diversity (KataGo's Play::maybeForkGame,
play.cpp:1741-1827) and hint-position forks (maybeHintForkGame,
play.cpp:1830-1866), in PyTorch.

The port of `katacoffee_tpu/selfplay/forking.py`. When a game finishes, with
probability `early_fork_prob` a move index ~ floor(Exponential() * area *
early_fork_move_prop) is drawn (else with `fork_prob` a uniform index over
the game); from that position a random number of random legal moves
(with replacement) are tried, the one the value net likes best for the mover
is played, and the position is queued. Resetting games of the selfplay
segment pop queued positions before anything else and skip policy-initialized
openings.

The candidates are found on the host in a finalized trajectory window
(`extract_fork_candidates`, numpy); the value-net choice is one batched
evaluation over all candidates and lanes (`choose_fork_moves`); the queue is
a fixed-capacity `ForkPool` that `actor.run_selfplay_segment` consumes on
the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from katacoffee_tpu_torch.device import resolve_device
from katacoffee_tpu_torch.game.board import GameConfig, GameState, init_state, legal_mask_flat, step
from katacoffee_tpu_torch.search import mcts


class ForkPool(NamedTuple):
    """Queued fork start positions (the reference's ForkData::forks)."""

    states: GameState  # [Kf]
    valid: torch.Tensor  # [Kf] bool


class ForkChoiceDraws(NamedTuple):
    """The draws of `choose_fork_moves` for K candidates: `choices` [K]
    uniform sets each candidate's number of tried moves, `lanes` [K, lanes,
    A] is the Gumbel noise that samples the tried moves."""

    choices: torch.Tensor
    lanes: torch.Tensor


def init_fork_pool(cfg: GameConfig, capacity: int, device: str | torch.device | None = None) -> ForkPool:
    """An empty pool of `capacity` slots on `device` (default `cuda`)."""
    dev = resolve_device(device)
    return ForkPool(states=init_state(cfg, capacity, dev), valid=torch.zeros((capacity,), dtype=torch.bool,
                                                                            device=dev))


@torch.no_grad()
def choose_fork_moves(
    cfg: GameConfig,
    eval_fn,
    states: GameState,
    valid: torch.Tensor,
    max_choices: torch.Tensor,
    forced: torch.Tensor,
    *,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
    draws: ForkChoiceDraws | None = None,
    min_choices: int = 3,
    num_lanes: int = 36,
) -> ForkPool:
    """The value-net fork-move choice (play.cpp:1779-1822) for K candidate
    positions `states` [K] on `device` (default `cuda`): each tries
    numChoices, uniform in [min_choices, max_choices[k]], legal moves drawn
    uniformly with replacement, evaluates every child in one batch and plays
    the move whose child is best for the mover. `forced` [K] >= 0 plays that
    move instead (hint forks; invalid if illegal). A child that ends the game
    is dropped. Draws come from `draws` or `generator` (on `device`)."""
    dev = resolve_device(device)
    states = states.map(lambda x: x.to(dev))
    valid, max_choices, forced = valid.to(dev), max_choices.to(dev), forced.to(dev, torch.int64)
    K = valid.shape[0]
    A = cfg.policy_size
    if draws is None:
        g = mcts._need_generator(generator, "choose_fork_moves")
        u = torch.rand((K,), generator=g, device=dev)
        gumbel = -torch.log(torch.empty((K, num_lanes, A), device=dev).exponential_(generator=g)
                            .clamp(min=torch.finfo(torch.float32).tiny))
    else:
        u, gumbel = draws.choices.to(dev), draws.lanes.to(dev)

    legal = legal_mask_flat(cfg, states)  # [K, A]
    any_legal = legal.any(-1)
    span = (max_choices - min_choices + 1).clamp(min=1)
    num_choices = min_choices + torch.floor(u * span.to(torch.float32)).to(torch.int64)

    logits = torch.where(legal, 0.0, -torch.inf)
    lane_moves = torch.argmax(logits[:, None, :] + gumbel, dim=-1)  # [K, lanes]
    lane_moves = torch.where(any_legal[:, None], lane_moves, 0)
    lane_ok = torch.arange(num_lanes, device=dev)[None, :] < num_choices[:, None]

    rep = states.map(lambda x: x[:, None].expand((K, num_lanes) + x.shape[1:]).reshape((K * num_lanes,) + x.shape[1:]))
    res = eval_fn(step(cfg, rep, lane_moves.reshape(-1)))
    # the child's mover is the opponent: the mover's value is -child wl
    score = torch.where(lane_ok, (-res.wl).reshape(K, num_lanes), -torch.inf)
    kidx = torch.arange(K, device=dev)
    chosen = lane_moves[kidx, torch.argmax(score, dim=-1)]

    use_forced = forced >= 0
    forced_safe = forced.clamp(min=0)
    move = torch.where(use_forced, forced_safe, chosen)
    fork_states = step(cfg, states, move)
    ok = valid & ~fork_states.done & torch.where(use_forced, legal[kidx, forced_safe], any_legal)
    return ForkPool(states=fork_states, valid=ok)


def extract_fork_candidates(
    cfg: GameConfig,
    traj,
    rng: np.random.Generator,
    early_fork_prob: float = 0.04,
    early_fork_move_prop: float = 0.025,
    fork_prob: float = 0.01,
    early_max_choices: int = 12,
    fork_max_choices: int = 36,
):
    """Host-side scan of a finalized trajectory window [T, B] for fork
    candidates: the per-finished-game draws of maybeForkGame
    (play.cpp:1752-1768) and the hint-fork condition of maybeHintForkGame
    (play.cpp:1836-1841), over the episodes that lie wholly inside the
    window. Returns (flat_idx, max_choices, forced) numpy arrays, flat_idx
    indexing the [T * B]-flattened rows of the fork-from positions, or None
    when there is no candidate."""
    done = traj.done_after.cpu().numpy()
    ep = traj.episode_id.cpu().numpy()
    nturns = traj.states.num_turns.cpu().numpy()
    played = traj.played_action.cpu().numpy()
    hint_action = traj.hint_action.cpu().numpy()
    T, B = done.shape
    area = cfg.x_size * cfg.y_size

    idxs, maxcs, forceds = [], [], []
    for b in range(B):
        t = 0
        while t < T:
            e = ep[t, b]
            end = None
            for u in range(t, T):
                if ep[u, b] != e:
                    break
                if done[u, b]:
                    end = u
                    break
            if end is None:
                break  # the unfinished tail
            started_inside = t > 0 or nturns[t, b] == 0
            length = end - t + 1
            if started_inside:
                # a hint episode that did not open with its hint move
                ha = int(hint_action[t, b])
                if ha >= 0 and int(played[t, b]) != ha:
                    idxs.append(t * B + b)
                    maxcs.append(0)
                    forceds.append(ha)
                if rng.random() < early_fork_prob:
                    m = int(np.floor(rng.exponential() * early_fork_move_prop * area))
                    if m < length:
                        idxs.append((t + m) * B + b)
                        maxcs.append(early_max_choices)
                        forceds.append(-1)
                elif fork_prob > 0 and rng.random() < fork_prob:
                    m = int(rng.integers(length))
                    idxs.append((t + m) * B + b)
                    maxcs.append(fork_max_choices)
                    forceds.append(-1)
            t = end + 1
    if not idxs:
        return None
    return np.asarray(idxs, np.int64), np.asarray(maxcs, np.int32), np.asarray(forceds, np.int32)


@torch.no_grad()
def refill_pool(pool: ForkPool, new: ForkPool) -> ForkPool:
    """`new`'s valid entries placed into `pool`'s free slots, in order
    (what does not fit is dropped). Returns a new pool on `pool`'s device."""
    dev = pool.valid.device
    free = torch.nonzero(~pool.valid)[:, 0]
    src = torch.nonzero(new.valid.to(dev))[:, 0][: len(free)]
    dst = free[: len(src)]
    states = []
    for old, add in zip(pool.states, new.states):
        out = old.clone()
        out[dst] = add.to(dev)[src]
        states.append(out)
    valid = pool.valid.clone()
    valid[dst] = True
    return ForkPool(states=GameState(*states), valid=valid)
