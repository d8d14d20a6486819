"""Maximum-likelihood Elo fitting: the port's copy of
`katacoffee_tpu/utils/elo.py` (numpy only, copied whole so the port imports
nothing of the JAX package). Equivalent of the reference's
`cpp/core/elo.{h,cpp}` (ComputeElos) and `python/elo.py`: given pairwise
win/loss/draw records, fit each player's Elo by MLE under the logistic model
P(i beats j) = 1 / (1 + 10^((e_j - e_i)/400)), with a weak prior anchoring the
scale (prior pseudo-games against Elo 0, as the reference's priorGames), and
report per-player standard deviations from the observed Fisher information.
Draws count as half a win + half a loss for each side (elo.py convention)."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

_LOG10_OVER_400 = math.log(10.0) / 400.0


class EloResult(NamedTuple):
    players: list
    elos: np.ndarray  # [P]
    stdevs: np.ndarray  # [P]

    def as_dict(self) -> dict:
        return {p: (float(e), float(s)) for p, e, s in zip(self.players, self.elos, self.stdevs)}


def compute_elos(
    records,
    prior_games: float = 2.0,
    tolerance: float = 1e-7,
    max_iters: int = 10000,
) -> EloResult:
    """records: iterable of (winner_name, loser_name) or
    (player_a, player_b, wins_a, wins_b, draws). Returns MLE Elos.
    """
    # Accumulate a win matrix w[i, j] = (possibly fractional) wins of i over j.
    players: list = []
    index: dict = {}

    def pid(name):
        if name not in index:
            index[name] = len(players)
            players.append(name)
        return index[name]

    pairs: dict[tuple, float] = {}
    for rec in records:
        if len(rec) == 2:
            a, b = pid(rec[0]), pid(rec[1])
            pairs[(a, b)] = pairs.get((a, b), 0.0) + 1.0
        else:
            a, b, wa, wb, dr = rec
            ia, ib = pid(a), pid(b)
            pairs[(ia, ib)] = pairs.get((ia, ib), 0.0) + wa + 0.5 * dr
            pairs[(ib, ia)] = pairs.get((ib, ia), 0.0) + wb + 0.5 * dr

    P = len(players)
    if P == 0:
        return EloResult([], np.zeros(0), np.zeros(0))
    w = np.zeros((P, P))
    for (i, j), n in pairs.items():
        w[i, j] += n

    # Prior: each player has prior_games/2 wins and losses vs a virtual
    # anchor at Elo 0 (keeps the problem bounded and sets the scale).
    elos = np.zeros(P)
    games = w + w.T  # games between i and j

    def grad_hess(elos):
        # full log-likelihood gradient/Hessian in elo units
        diff = elos[:, None] - elos[None, :]
        p_win = 1.0 / (1.0 + np.power(10.0, -diff / 400.0))
        g = _LOG10_OVER_400 * ((w * (1.0 - p_win)).sum(1) - (w.T * p_win).sum(1))
        q = games * p_win * (1.0 - p_win)  # information per pair
        H = (_LOG10_OVER_400**2) * q  # off-diagonal (∂²/∂e_i∂e_j > 0... sign below)
        H = H - np.diag(q.sum(1) * (_LOG10_OVER_400**2) + H.diagonal())
        # prior vs anchor at Elo 0
        p0 = 1.0 / (1.0 + np.power(10.0, -elos / 400.0))
        g += _LOG10_OVER_400 * (prior_games / 2.0 - prior_games * p0)
        H[np.diag_indices(P)] -= (_LOG10_OVER_400**2) * prior_games * p0 * (1.0 - p0)
        return g, H

    for _ in range(max_iters):
        g, H = grad_hess(elos)
        try:
            delta = -np.linalg.solve(H, g)
        except np.linalg.LinAlgError:
            delta = -g / np.minimum(H.diagonal(), -1e-12)
        delta = np.clip(delta, -400.0, 400.0)
        elos = elos + delta
        if np.max(np.abs(delta)) < tolerance * 400.0:
            break

    _, H = grad_hess(elos)
    stdevs = 1.0 / np.sqrt(np.maximum(-H.diagonal(), 1e-12))
    return EloResult(players, elos, stdevs)
