"""Training losses: the port of `katacoffee_tpu/train/losses.py`, the same
ten weighted terms, masks and metrics.

  policy CE (1.0), opponent-reply policy CE (0.15), optimistic policy CE
  (0.15, weighted toward rows that went well for the mover), value CE (1.20),
  3 TD-value CEs (1.20), ownership CE (1.5, board mean), futurepos (0.25),
  longest-line per-cell CE (0.5, board mean), variance-time huber (0.0003),
  shortterm value error huber (2.0).

Features are derived from each row's stored game state, after the history
masking, then the row's dihedral symmetry moves features and targets
together. Both augmentations take their draws as tensors (`syms` [R],
`levels` [R]); `train.train` draws them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from katacoffee_tpu_torch.game import symmetry as S
from katacoffee_tpu_torch.game.board import GameConfig
from katacoffee_tpu_torch.nn.features import extract_features, mask_history_state
from katacoffee_tpu_torch.selfplay.actor import TrainingBatch


def _ce(logits: torch.Tensor, target_probs: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return -(target_probs * F.log_softmax(logits, dim=dim)).sum(dim=dim)


def _huber(pred: torch.Tensor, target: torch.Tensor, delta: float) -> torch.Tensor:
    err = pred - target
    a = err.abs()
    return torch.where(a <= delta, 0.5 * err * err, delta * (a - 0.5 * delta))


def _binary_ce(logit: torch.Tensor, target_pm1: torch.Tensor) -> torch.Tensor:
    """2-class CE of a tanh-scaled logit against a -1..1 target."""
    p = (target_pm1 + 1.0) * 0.5
    return -(p * F.logsigmoid(2.0 * logit) + (1.0 - p) * F.logsigmoid(-2.0 * logit))


def compute_losses(
    cfg: GameConfig,
    model,
    batch: TrainingBatch,
    syms: torch.Tensor | None = None,
    levels: torch.Tensor | None = None,
    weight_sum: torch.Tensor | None = None,
):
    """(total loss, metrics dict of 0-d tensors), JAX losses.py:43. `levels`
    [R] cuts each row's visible history before feature extraction (no
    masking if None); `syms` [R] applies a dihedral symmetry per row to the
    features and every spatial target (none if None). Every weighted mean
    divides by the batch's weight sum, or by `weight_sum` where given: a
    rank of a data-parallel step passes the sum over every rank's rows, so
    that its loss and metrics are its share of the global batch's."""
    states = batch.states
    if levels is not None:
        states = mask_history_state(states, levels)
    spatial, glob = extract_features(cfg, states)

    policy_target = batch.policy_target
    opp_target = batch.opponent_policy_target
    ownership = batch.ownership_target
    futurepos = batch.futurepos_target
    lines = batch.line_target
    if syms is not None:
        spatial = S.apply_features(syms, spatial)
        policy_target = S.apply_policy(cfg, syms, policy_target)
        opp_target = S.apply_policy(cfg, syms, opp_target)
        ownership = S.apply_plane(syms, ownership)
        futurepos = S.apply_plane(syms, futurepos)
        lines = S.apply_plane(syms, lines)

    out = model(spatial, glob)
    w = batch.weight
    wsum = torch.clamp(w.sum() if weight_sum is None else weight_sum, min=1e-8)

    def wmean(x, weights=w):
        return (x * weights).sum() / wsum

    # policy CE; rows with all-zero targets contribute 0
    pt_ok = policy_target.sum(-1) > 0
    loss_policy = wmean(torch.where(pt_ok, _ce(out["policy_logits"], policy_target), 0.0))
    opp_ok = opp_target.sum(-1) > 0
    loss_opp = 0.15 * wmean(
        torch.where(opp_ok, _ce(out["opponent_policy_logits"], opp_target), 0.0),
        weights=w * batch.opponent_policy_weight,
    )
    # optimistic policy: the policy target, weighted toward rows whose game
    # went well for the mover (final win squared, draws half) or whose
    # shortterm outcome beat the net's own prediction by ~1.5 sigma; side
    # rows (aux_weight 0) excluded
    st_probs = F.softmax(out["td_value_logits"][:, 2, :], dim=-1)
    st_predv = (st_probs[:, 0] - st_probs[:, 1]).detach()
    st_realv = batch.td_value_targets[:, 2, 0] - batch.td_value_targets[:, 2, 1]
    win_eff = batch.value_target[:, 0] + 0.5 * batch.value_target[:, 2]
    excess = (st_realv - st_predv) / torch.sqrt(torch.clamp(out["shortterm_error"], min=0.0).detach() + 1e-4)
    optimism_w = torch.clamp(win_eff * win_eff + torch.sigmoid((excess - 1.5) * 3.0), 0.0, 1.0) * batch.aux_weight
    loss_opt = 0.15 * wmean(
        torch.where(pt_ok, _ce(out["optimistic_policy_logits"], policy_target), 0.0),
        weights=w * optimism_w,
    )

    loss_value = 1.20 * wmean(_ce(out["value_logits"], batch.value_target))
    loss_td = 1.20 * wmean(_ce(out["td_value_logits"], batch.td_value_targets).sum(-1))

    # game-outcome aux targets do not exist for side rows: aux_weight masks them
    wa = w * batch.aux_weight
    loss_own = 1.5 * wmean(_binary_ce(out["ownership"], ownership).mean(dim=(-1, -2)), weights=wa)
    fut_ce = _binary_ce(out["futurepos"], futurepos)
    # the further-out channel weighs less
    fut_ce = fut_ce[:, 0].mean(dim=(-1, -2)) + 0.6 * fut_ce[:, 1].mean(dim=(-1, -2))
    loss_fut = 0.25 * wmean(fut_ce, weights=wa)

    # longest line, per cell over 0..win_len, one-hot to the HEAD's class
    # count: a mixed-size net's head is sized for the largest win_len
    n_classes = out["line_logits"].shape[1]
    line_t = torch.clamp(lines, 0, min(cfg.win_len, n_classes - 1)).to(torch.int64)
    classes = torch.arange(n_classes, device=line_t.device)[None, :, None, None]
    line_onehot = (line_t[:, None] == classes).to(torch.float32)
    loss_line = 0.5 * wmean(_ce(out["line_logits"], line_onehot, dim=1).mean(dim=(-1, -2)), weights=wa)

    loss_vtl = 0.0003 * wmean(_huber(out["var_time_left"], batch.var_time_left_target, delta=100.0), weights=wa)

    # shortterm value error: huber toward the realized squared error of the
    # short-horizon (index 2) TD prediction
    sqerr = torch.square(st_predv - st_realv) + 1e-8
    loss_sterr = 2.0 * wmean(_huber(out["shortterm_error"], sqerr, delta=0.4), weights=wa)

    total = (loss_policy + loss_opp + loss_opt + loss_value + loss_td + loss_own + loss_fut + loss_line + loss_vtl
             + loss_sterr)
    metrics = {
        "loss": total,
        "loss_policy": loss_policy,
        "loss_opponent_policy": loss_opp,
        "loss_optimistic_policy": loss_opt,
        "loss_value": loss_value,
        "loss_td_value": loss_td,
        "loss_ownership": loss_own,
        "loss_futurepos": loss_fut,
        "loss_line": loss_line,
        "loss_var_time": loss_vtl,
        "loss_shortterm_error": loss_sterr,
        # torch.argmax takes the first maximal index, as jnp.argmax does
        "policy_acc1": wmean(
            (torch.argmax(out["policy_logits"], -1) == torch.argmax(policy_target, -1)).to(torch.float32)),
        "value_acc1": wmean(
            (torch.argmax(out["value_logits"], -1) == torch.argmax(batch.value_target, -1)).to(torch.float32)),
        "weight_sum": w.sum(),
    }
    return total, metrics
