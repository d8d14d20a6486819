"""NN input features: the port of `katacoffee_tpu/nn/features.py`
`extract_features`, batched. The layout is frozen at 18 spatial planes plus
1 global feature:

  ch 0      on-board (all ones)
  ch 1, 2   stones of player to move / opponent
  ch 3-6    last move, one-hot over its direction, at its spot
  ch 7-10   moves 2, 3, 4, 5 ago, spot only
  ch 11-14  legal moves for the player to move, per direction
  ch 15-17  stones in a maximal same-color run of exact length
            win_len-1, win_len-2, win_len-3
  global 0  win_len
"""

from __future__ import annotations

import torch

from katacoffee_tpu_torch.game.board import (
    D_NONE,
    NUM_DIRECTIONS,
    GameConfig,
    GameState,
    exact_run_mask,
    legal_mask,
)

NUM_FEATURES_SPATIAL = 18
NUM_FEATURES_GLOBAL = 1


def mask_history_state(state: GameState, keep: torch.Tensor) -> GameState:
    """Each row's visible move history cut to its last `keep` (0..5) moves,
    `keep` a [B] integer tensor (JAX features.py:48, batched). The state is
    rewritten, not just the planes: the last move constrains legality, so
    keep == 0 clears last_spot and last_dir too, as a position set up
    without history has them; keep >= 1 keeps the last move and hides the
    moves further back."""
    keep = keep.to(state.recent_spots.device)
    vis = torch.arange(state.recent_spots.shape[1], device=keep.device)[None, :] < keep[:, None]
    has_last = keep > 0
    return state._replace(
        last_spot=torch.where(has_last, state.last_spot, -1),
        last_dir=torch.where(has_last, state.last_dir, D_NONE),
        recent_spots=torch.where(vis, state.recent_spots, -1),
        recent_dirs=torch.where(vis, state.recent_dirs, D_NONE),
    )


def sample_history_levels(
    n: int,
    keep_prob: float = 0.98,
    *,
    generator: torch.Generator | None = None,
    uniforms: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-row history depths [n] in 0..5 with the reference's chained draw
    (JAX features.py:73): depth >= k with probability keep_prob^k. The [n, 5]
    uniforms are drawn from `generator` (on its device) or given."""
    if uniforms is None:
        if generator is None:
            raise ValueError("sample_history_levels needs a generator or the uniforms")
        uniforms = torch.rand((n, 5), generator=generator, device=generator.device)
    return torch.cumprod((uniforms < keep_prob).to(torch.int32), dim=1).sum(dim=1)


def extract_features(cfg: GameConfig, state: GameState):
    """(spatial [B, 18, Y, X] float32, global [B, 1] float32) for the player
    to move."""
    Y, X = cfg.y_size, cfg.x_size
    area = cfg.area
    bsz = state.board.shape[0]
    dev = state.board.device
    bidx = torch.arange(bsz, device=dev)
    pla = state.to_move[:, None, None]
    opp = 3 - pla

    board = state.board
    onboard = torch.ones((bsz, 1, Y, X), dtype=torch.float32, device=dev)
    own = (board == pla).to(torch.float32)[:, None]
    other = (board == opp).to(torch.float32)[:, None]

    # ch 3-6: last move one-hot by direction at its spot
    last = torch.zeros((bsz, NUM_DIRECTIONS, area), dtype=torch.float32, device=dev)
    spot0 = state.recent_spots[:, 0]
    last[bidx, state.recent_dirs[:, 0].clamp(max=NUM_DIRECTIONS - 1), spot0.clamp(min=0)] = (
        spot0 >= 0
    ).to(torch.float32)

    # ch 7-10: moves 2..5 ago, spot only
    hist = torch.zeros((bsz, 4, area), dtype=torch.float32, device=dev)
    for k in range(1, 5):
        spot_k = state.recent_spots[:, k]
        hist[bidx, k - 1, spot_k.clamp(min=0)] = (spot_k >= 0).to(torch.float32)

    legal = legal_mask(cfg, state).to(torch.float32)
    lines = torch.stack(
        [
            exact_run_mask(cfg, board, L).to(torch.float32)
            for L in range(cfg.win_len - 1, cfg.win_len - 4, -1)
        ],
        dim=1,
    )
    spatial = torch.cat(
        [
            onboard, own, other,
            last.reshape(bsz, NUM_DIRECTIONS, Y, X),
            hist.reshape(bsz, 4, Y, X),
            legal, lines,
        ],
        dim=1,
    )
    glob = torch.full((bsz, NUM_FEATURES_GLOBAL), float(cfg.win_len), device=dev)
    return spatial, glob
