"""Batched match runner: two bots, B games in lockstep on one GPU.

The port of `katacoffee_tpu/program/match.py` (the reference's `MatchPairer`
and the gatekeeper and match game loops, `cpp/program/play.h:145-192`,
`cpp/command/gatekeeper.cpp:451-545`). Colors alternate strictly in Coffee
(no pass), so the batch is split into two static halves, bot A black in the
first and bot B black in the second: at every ply each half needs exactly
one bot's search. Each ply runs `run_search` then `select_moves` once per
bot on its half (max_nodes = visits + 2). Finished games keep stepping as
no-ops and stay in the searched batch, as in JAX, until every game has ended
or the turn cap (area + 2) is hit; unfinished games count as draws. The host
reads the `done` flags once per ply.

Randomness: each bot draws from its own `torch.Generator` on the device,
seeded from `seed`; `draws(ply, half)` instead hands in the Gumbel noise
[half, A] of the move choice of half 0 (A black) or half 1 (B black) at a
ply, as the tests do with the JAX package's key chain (per ply
`rng, ka, kb = split(rng, 3)`, then `k1, k2 = split(k)` and the noise of
`categorical(k2, .)`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from katacoffee_tpu_torch.device import resolve_device
from katacoffee_tpu_torch.game.board import GameConfig, init_state, step
from katacoffee_tpu_torch.search.mcts import run_search, select_moves
from katacoffee_tpu_torch.search.params import SearchParams

MatchDraws = Callable[[int, int], torch.Tensor]


@dataclasses.dataclass
class MatchResult:
    games: int
    wins_a: int
    wins_b: int
    draws: int
    move_records: list  # per game: list of flat actions
    black_was_a: np.ndarray  # [B] bool
    winners: np.ndarray | None = None  # [B] 0 draw / 1 black / 2 white
    # games not yet ended at the start of each ply that was searched
    live_per_ply: list = dataclasses.field(default_factory=list)

    @property
    def score_a(self) -> float:
        return (self.wins_a + 0.5 * self.draws) / max(self.games, 1)


def run_match(
    cfg: GameConfig,
    sp_a: SearchParams,
    sp_b: SearchParams,
    eval_a,
    eval_b,
    num_games: int,
    num_visits: int,
    seed: int = 0,
    max_moves: int | None = None,
    record_moves: bool = False,
    *,
    device: str | torch.device | None = None,
    draws: MatchDraws | None = None,
) -> MatchResult:
    """Play `num_games` (rounded up to even) games on `device` (default
    `cuda`; both evaluators must run there), half with A as black. The bots
    may differ in both evaluator and SearchParams."""
    dev = resolve_device(device)
    B = num_games + (num_games % 2)
    half = B // 2
    max_moves = max_moves or (cfg.area + 2)
    bots = {
        "a": (sp_a, eval_a, torch.Generator(device=dev).manual_seed(2 * seed)),
        "b": (sp_b, eval_b, torch.Generator(device=dev).manual_seed(2 * seed + 1)),
    }

    def move(bot, states, ply, which):
        sp, eval_fn, generator = bots[bot]
        tree = run_search(cfg, sp, eval_fn, states, num_visits, device=dev, generator=generator)
        gumbel = None if draws is None else draws(ply, which)
        return select_moves(cfg, sp, tree, generator=generator, gumbel=gumbel)

    states = init_state(cfg, B, dev)
    black_was_a = np.zeros((B,), bool)
    black_was_a[:half] = True
    played, live_masks, live_per_ply = [], [], []
    for ply in range(max_moves):
        done = states.done.cpu().numpy()
        if done.all():
            break
        live_per_ply.append(int((~done).sum()))
        # ply parity decides which bot holds the color to move in each half:
        # half 0 (A black) needs A on even plies, half 1 (B black) the reverse
        first, second = ("a", "b") if ply % 2 == 0 else ("b", "a")
        acts = torch.cat([
            move(first, states.map(lambda x: x[:half]), ply, 0),
            move(second, states.map(lambda x: x[half:]), ply, 1),
        ])
        acts = torch.where(states.done, 0, acts)
        if record_moves:
            played.append(acts)
            live_masks.append(~done)
        states = step(cfg, states, acts)

    done = states.done.cpu().numpy()
    # unfinished games (turn cap) count as draws, like hitTurnLimit rows
    winner = np.where(done, states.winner.cpu().numpy(), 0)
    a_color = np.where(black_was_a, 1, 2)
    moves_by_game: list[list[int]] = [[] for _ in range(B)]
    if played:
        acts_np = torch.stack(played).cpu().numpy()
        for t, live in enumerate(live_masks):
            for g in np.flatnonzero(live):
                moves_by_game[g].append(int(acts_np[t, g]))
    return MatchResult(
        games=B,
        wins_a=int((winner == a_color).sum()),
        wins_b=int(((winner != 0) & (winner != a_color)).sum()),
        draws=int((winner == 0).sum()),
        move_records=moves_by_game if record_moves else [],
        black_was_a=black_was_a,
        winners=winner,
        live_per_ply=live_per_ply,
    )


def match_sgfs(cfg: GameConfig, result: MatchResult, name_a: str, name_b: str) -> list[str]:
    """SGF texts of the recorded games (record_moves=True)."""
    from katacoffee_tpu_torch.dataio.sgf import write_sgf

    out = []
    for g, actions in enumerate(result.move_records):
        moves = []
        pla = 1
        for a in actions:
            d, spot = a // cfg.area, a % cfg.area
            moves.append((spot % cfg.x_size, spot // cfg.x_size, d, pla))
            pla = 3 - pla
        is_a_black = bool(result.black_was_a[g])
        bn = name_a if is_a_black else name_b
        wn = name_b if is_a_black else name_a
        winner = int(result.winners[g]) if result.winners is not None else None
        out.append(write_sgf(cfg.x_size, cfg.y_size, cfg.win_len, moves, bn, wn, winner=winner))
    return out
