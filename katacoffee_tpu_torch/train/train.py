"""The training step: the port of `katacoffee_tpu/train/train.py`, on one
device (`make_train_step`) or data-parallel over the ranks of a process
group (`make_sharded_train_step`).

The optimizer is optax's chain in the JAX package (train.py:111-137),
computed with torch's multi-tensor ops in the same order and rounding:

  1. clip_by_global_norm(grad_clip): g unchanged when |g| < grad_clip, else
     (g / |g|) * grad_clip (no epsilon, unlike clip_grad_norm_);
  2. + weight_decay * p on conv and dense kernels (`weight`, ndim > 1);
  3. nesterov trace: t' = g + momentum * t, u = g + momentum * t';
  4. u * -lr(count), the stepwise schedule keyed on count * batch_size
     samples or the linear one, lr scaled by batch_size / batch_scale;
  5. u * output_head_lr_scale on the policy and value heads;
then p += u, count += 1, step += 1, ema = ema * ema_decay + p * (1 - ema_decay).
Unlike the JAX step the state is updated in place: the model's parameters,
the trace and the EMA tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from katacoffee_tpu_torch.game import symmetry as S
from katacoffee_tpu_torch.game.board import GameConfig
from katacoffee_tpu_torch.nn.features import sample_history_levels
from katacoffee_tpu_torch.nn.model import CoffeeNet, init_params
from katacoffee_tpu_torch.parallel import mesh
from katacoffee_tpu_torch.selfplay.actor import TrainingBatch
from katacoffee_tpu_torch.train.losses import compute_losses


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 0.02  # LR at batch_scale samples/step; scaled by batch
    batch_scale: float = 256.0
    momentum: float = 0.9
    weight_decay: float = 3e-5
    grad_clip: float = 8.0
    warmup_steps: int = 100
    ema_decay: float = 0.999
    symmetry_augment: bool = True
    # random history masking (nn/features.py mask_history_state)
    history_mask: bool = True
    history_keep_prob: float = 0.98
    # "stepwise": the reference's stepped warmup keyed on samples seen,
    # 1/5 -> 1/3 -> 1/2 -> 1/1.4 -> 1 (thresholds scaled by
    # warmup_samples_scale); "linear": a warmup_steps ramp
    lr_schedule: str = "stepwise"
    warmup_samples_scale: float = 1.0
    # the output heads train at this fraction of the LR
    output_head_lr_scale: float = 0.5


# (samples_threshold, scale) pairs; above the last threshold the scale is 1
_FIXUP_WARMUP_STEPS = (
    (1_000_000, 1.0 / 5.0),
    (2_000_000, 1.0 / 3.0),
    (4_000_000, 1.0 / 2.0),
    (6_000_000, 1.0 / 1.4),
)
_INT32_MAX = 2**31 - 1


def warmup_scale_at(samples: float, samples_scale: float = 1.0) -> float:
    """The stepped warmup's scale at a global sample count (JAX train.py:64)."""
    for threshold, scale in _FIXUP_WARMUP_STEPS:
        if samples < threshold * samples_scale:
            return scale
    return 1.0


def current_lr(tc: TrainConfig, batch_size: int, step: int) -> float:
    """Host-side view of the scheduled LR at a step, for the metrics files
    (JAX train.py:140)."""
    lr = tc.learning_rate * (batch_size / tc.batch_scale)
    if tc.lr_schedule == "stepwise":
        return lr * warmup_scale_at(step * batch_size, tc.warmup_samples_scale)
    return lr * min(1.0, step / max(tc.warmup_steps, 1))


def scheduled_lr(tc: TrainConfig, batch_size: int, count: int) -> float:
    """The learning rate the step applies at schedule count `count`, in
    float32 as optax's schedule computes it (JAX train.py:116-132)."""
    lr = tc.learning_rate * (batch_size / tc.batch_scale)
    f32 = np.float32
    if tc.lr_schedule == "stepwise":
        samples = f32(count) * f32(batch_size)
        thresholds = np.asarray([t * tc.warmup_samples_scale for t, _ in _FIXUP_WARMUP_STEPS], np.float32)
        scales = np.asarray([s for _, s in _FIXUP_WARMUP_STEPS] + [1.0], np.float32)
        return float(f32(lr) * scales[int((samples >= thresholds).sum())])
    if tc.lr_schedule == "linear":
        # optax.linear_schedule(0, lr, warmup_steps)
        steps = tc.warmup_steps
        if steps <= 0:
            return float(f32(lr))
        frac = f32(1) - f32(min(max(count, 0), steps)) / f32(steps)
        return float(f32(-lr) * frac + f32(lr))
    raise ValueError(f"unknown lr_schedule {tc.lr_schedule!r}")


def is_decayed(name: str, p: torch.Tensor) -> bool:
    """Weight decay applies to conv and dense kernels only, not biases or
    ReZero gates (JAX train.py:100 `_decay_mask`)."""
    return name.endswith(".weight") and p.dim() > 1


def is_output_head(name: str) -> bool:
    """The policy and value heads, which train at output_head_lr_scale
    (JAX train.py:71 `_is_output_head`)."""
    return name.startswith(("policy_head.", "value_head."))


@dataclasses.dataclass
class TrainState:
    """The JAX TrainState (params, opt_state, ema_params, step) for a torch
    model: the parameters live in `model`; `trace` (the nesterov momentum,
    optax's opt_state[2][0]) and `ema` are keyed by parameter name; `count`
    is the schedule's count (opt_state[2][1]) and `step` the steps taken,
    which differ in a run that resumed from another's parameters."""

    model: CoffeeNet
    trace: dict[str, torch.Tensor]
    ema: dict[str, torch.Tensor]
    count: int = 0
    step: int = 0


def init_train_state(model: CoffeeNet, generator: torch.Generator | None = None) -> TrainState:
    """A fresh state for `model` (JAX train.py:149): its parameters drawn by
    `nn.model.init_params` from `generator` (kept as they are without one),
    a zero trace, the EMA a copy of the parameters."""
    if generator is not None:
        init_params(model, generator)
    with torch.no_grad():
        params = dict(model.named_parameters())
        return TrainState(model, {k: torch.zeros_like(p) for k, p in params.items()},
                          {k: p.detach().clone() for k, p in params.items()})


class StepDraws(NamedTuple):
    """A step's augmentation draws: a dihedral symmetry [R] and a history
    depth [R] per row, None where that augmentation is off."""

    syms: torch.Tensor | None
    levels: torch.Tensor | None


def draw_augmentation(cfg: GameConfig, tc: TrainConfig, n: int, generator: torch.Generator | None) -> StepDraws:
    """The draws of one step for n rows, from `generator` (on its device)."""
    if (tc.symmetry_augment or tc.history_mask) and generator is None:
        raise ValueError("an augmenting train step needs a generator or injected draws")
    syms = levels = None
    if tc.symmetry_augment:
        syms = torch.randint(0, S.num_symmetries(cfg), (n,), generator=generator, device=generator.device)
    if tc.history_mask:
        levels = sample_history_levels(n, tc.history_keep_prob, generator=generator)
    return StepDraws(syms, levels)


@torch.no_grad()
def apply_gradients(tc: TrainConfig, batch_size: int, state: TrainState, grads: list[torch.Tensor]) -> torch.Tensor:
    """optax's chain on `grads` (in `named_parameters` order), then the
    parameter, count, step and EMA updates, in place. Returns the global
    norm of the raw gradients. No host sync: the clip is a device select."""
    names, params = zip(*state.model.named_parameters())
    g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    trigger = g_norm < tc.grad_clip
    one = torch.ones((), device=g_norm.device)
    g = torch._foreach_div(grads, torch.where(trigger, one, g_norm))
    torch._foreach_mul_(g, torch.where(trigger, one, torch.full_like(one, tc.grad_clip)))

    decayed = [i for i, (n, p) in enumerate(zip(names, params)) if is_decayed(n, p)]
    torch._foreach_add_([g[i] for i in decayed], torch._foreach_mul([params[i] for i in decayed], tc.weight_decay))

    trace = [state.trace[n] for n in names]
    torch._foreach_mul_(trace, tc.momentum)
    torch._foreach_add_(trace, g)  # t' = g + momentum * t
    u = torch._foreach_mul(trace, tc.momentum)
    torch._foreach_add_(u, g)  # nesterov: u = g + momentum * t'
    torch._foreach_mul_(u, -scheduled_lr(tc, batch_size, state.count))
    torch._foreach_mul_([u[i] for i, n in enumerate(names) if is_output_head(n)], tc.output_head_lr_scale)
    torch._foreach_add_(list(params), u)
    state.count = min(state.count + 1, _INT32_MAX)
    state.step += 1

    ema = [state.ema[n] for n in names]
    torch._foreach_mul_(ema, tc.ema_decay)
    torch._foreach_add_(ema, torch._foreach_mul(list(params), 1.0 - tc.ema_decay))
    return g_norm


def make_train_step(cfg: GameConfig, tc: TrainConfig, batch_size: int):
    """The single-device train step (JAX train.py:164):
    `step(state, batch, generator=None, draws=None, mark=None)` updates
    `state` in place and returns (state, metrics of 0-d tensors). The
    augmentation draws come from `generator` or are given as `draws`
    (StepDraws). `mark(part)`, if given, is called after "forward+loss",
    "backward" and "optimizer+EMA" (for timing the parts)."""
    return _make_step(cfg, tc, batch_size, None)


def make_sharded_train_step(cfg: GameConfig, tc: TrainConfig, batch_size: int, world: int):
    """The data-parallel train step over a process group of `world` ranks
    (JAX train.py:193 `make_sharded_train_step`), called as
    `make_train_step`'s on every rank with the rank's batch_size/world rows:
    each rank runs forward and backward on its rows, every weighted mean
    divided by the weight sum over all ranks' rows; the float32 gradients
    and the metrics are summed over the ranks (one all-reduce each), so the
    global-norm clip, the optimizer (with the global batch_size's learning
    rate) and the EMA see the global batch's, and every rank's parameters,
    trace, EMA and count stay bit-identical. Injected `draws` are the
    global batch's, and each rank takes its block (`rank_rows`), as JAX
    draws them for the global batch; a `generator` draws the rank's own."""
    if batch_size % world:
        raise ValueError(f"a batch of {batch_size} rows does not divide over {world} ranks")
    return _make_step(cfg, tc, batch_size, world)


def _make_step(cfg: GameConfig, tc: TrainConfig, batch_size: int, world: int | None):
    def train_step(state: TrainState, batch: TrainingBatch, generator: torch.Generator | None = None,
                   draws: StepDraws | None = None, mark: Callable[[str], None] | None = None):
        rows = batch.weight.shape[0]
        weight_sum = None
        if world is not None:
            rank, size = mesh.world()
            if size != world or rows * world != batch_size:
                raise ValueError(f"the step is for {world} ranks of {batch_size // world} rows; this rank has "
                                 f"{rows} of a world of {size}")
            if draws is not None:
                draws = StepDraws(*(None if d is None else mesh.rank_rows(d, rank, world) for d in draws))
            weight_sum = mesh.all_reduce_sum(batch.weight.sum())
        if draws is None:
            draws = draw_augmentation(cfg, tc, rows, generator)
        model = state.model
        for p in model.parameters():
            p.grad = None
        with torch.enable_grad():  # whatever the caller's grad mode
            loss, metrics = compute_losses(cfg, model, batch, syms=draws.syms if tc.symmetry_augment else None,
                                           levels=draws.levels if tc.history_mask else None, weight_sum=weight_sum)
            if mark:
                mark("forward+loss")
            loss.backward()
        if mark:
            mark("backward")
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in model.parameters()]
        metrics = {k: v.detach() for k, v in metrics.items()}
        if world is not None:
            grads = _summed_over_ranks(grads)
            keys = sorted(metrics)
            metrics = dict(zip(keys, _summed_over_ranks([metrics[k] for k in keys])))
        metrics["grad_norm"] = apply_gradients(tc, batch_size, state, grads)
        for p in model.parameters():
            p.grad = None
        if mark:
            mark("optimizer+EMA")
        return state, metrics

    return train_step


def _summed_over_ranks(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """`tensors` summed over the ranks by one all-reduce of their
    concatenation."""
    flat = mesh.all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors]))
    return [x.view_as(t) for x, t in zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]
