"""Search performance accounting, the port of `katacoffee_tpu/utils/perfcount.py`
(the NNEvaluator stats role, `cpp/neuralnet/nneval.h:171-176`: NN rows,
batches and batch occupancy). The lockstep search submits one full-width
NN forward per simulate round, so the counters are:

  * submitted NN rows  = B x rounds (every round evaluates the whole batch,
    masked games included: the price of lockstep);
  * delivered visits   = B x num_sims per move;
  * occupancy          = mean per-game visit deficit / max deficit, the
    share of submitted rows that belong to games still short of their
    visit target (tree reuse gives games different deficits; the max gates
    the round count).

The JAX module adds XLA's cost model (`compiled.cost_analysis()`, FLOPs
and bytes accessed of a compiled program). Eager PyTorch has no compiled
program to ask, so `cost_analysis` is not ported: `flops_accounting`
counts FLOPs with `torch.utils.flop_counter.FlopCounterMode` around one
call instead, and reports no bytes. Every wall time ends in a device
synchronisation."""

from __future__ import annotations

import time
from typing import Any

import torch
from torch.utils.flop_counter import FlopCounterMode

from katacoffee_tpu_torch.device import resolve_device
from katacoffee_tpu_torch.game.board import step
from katacoffee_tpu_torch.search import mcts

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit: 989 TFLOP/s bf16,
# 3.35 TB/s HBM3.
PEAK_FLOPS = {"h100": 989e12}
PEAK_HBM_BYTES = {"h100": 3.35e12}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_kind(device: str | torch.device | None = None) -> str:
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def device_peaks(device: str | torch.device | None = None) -> tuple[float, float]:
    """(bf16 FLOP/s, HBM bytes/s) of the device from its name's data sheet;
    (0.0, 0.0) for the CPU or a card not in the table."""
    kind = device_kind(device).lower()
    for k, v in PEAK_FLOPS.items():
        if k in kind:
            return v, PEAK_HBM_BYTES[k]
    return 0.0, 0.0


@torch.no_grad()
def search_counters(
    cfg,
    sp,
    eval_fn,
    init_state_fn,
    batch_size: int,
    num_sims: int,
    moves: int = 10,
    seed: int = 0,
    node_budget_frac: float = 0.3,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Run `moves` consecutive searches with tree reuse at the bench
    operating point on `device` (default `cuda`), collecting each move's
    diag (rounds, start visits) from run_search(with_diag=True). Returns the
    JAX function's counters and a synchronised wall time.

    The selfplay actor's search -> select -> step move cycle without the
    training data, as the JAX function runs it: a first move, then `moves` -
    1 timed reused ones. The JAX function first runs one untimed pair to
    compile both; eager torch compiles nothing, so that pair is not run.
    `init_state_fn(cfg, B, device)` makes the roots; the searches and move
    choices draw from a generator seeded with `seed + 1`, the JAX
    function's key of its measured moves."""
    dev = resolve_device(device)
    B = batch_size
    max_nodes = max(64, int(num_sims * node_budget_frac) + 2)

    def first_move(states, g):
        tree, diag = mcts.run_search(cfg, sp, eval_fn, states, num_sims, max_nodes, device=dev, generator=g,
                                     with_diag=True)
        action = mcts.select_moves(cfg, sp, tree, generator=g)
        return step(cfg, states, torch.where(states.done, 0, action)), tree, action, diag

    def next_move(states, tree, prev_action, g):
        tree, diag = mcts.run_search(cfg, sp, eval_fn, states, num_sims, device=dev, generator=g,
                                     reuse_tree=tree, reuse_actions=prev_action, reuse_ok=~states.done,
                                     with_diag=True)
        action = mcts.select_moves(cfg, sp, tree, generator=g)
        return step(cfg, states, torch.where(states.done, 0, action)), tree, action, diag

    states = init_state_fn(cfg, B, dev)
    per_move = []
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    s, t, a, d = first_move(states, g)
    _sync(dev)  # fence: keep the fresh search out of the timed window
    t0 = time.perf_counter()
    per_move.append(d)
    for _ in range(moves - 1):
        s, t, a, d = next_move(s, t, a, g)
        per_move.append(d)
    _sync(dev)
    wall_reused = time.perf_counter() - t0  # moves-1 reused searches

    rounds = [int(d["rounds"]) for d in per_move]
    deficits = [torch.clamp(num_sims + 1.0 - d["start_visits"], min=0.0) for d in per_move]
    occ = [float(df.mean() / torch.clamp(df.max(), min=1.0)) for df in deficits]
    total_rounds = sum(rounds)
    visits_delivered = B * num_sims * moves
    rows_submitted = B * total_rounds
    reuse_saved = [float((num_sims + 1.0 - df).mean()) for df in deficits]
    return {
        "batch_size": B,
        "num_sims": num_sims,
        "moves": moves,
        "rounds_per_move": rounds,
        "occupancy_per_move": [round(o, 4) for o in occ],
        "mean_occupancy_reused": round(sum(occ[1:]) / max(len(occ) - 1, 1), 4),
        "nn_rows_submitted": rows_submitted,
        "visits_delivered": visits_delivered,
        "visits_per_nn_row": round(visits_delivered / max(rows_submitted, 1), 4),
        "mean_reused_visits": [round(r, 1) for r in reuse_saved],
        "wall_s_reused_moves": round(wall_reused, 3),
        "nn_rows_per_sec": round(B * sum(rounds[1:]) / wall_reused, 1),
    }


def count_flops(fn) -> int:
    """FLOPs of one call of `fn()` as torch's FlopCounterMode counts them:
    the operators it has formulas for (convolutions, matrix products,
    attention), not elementwise work."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def flops_accounting(
    segment,
    forward,
    nn_rows: int,
    seg_wall_s: float,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """FLOP accounting for one selfplay segment, `segment()`, and the bare
    NN forward at the same batch width, `forward()` over `nn_rows` rows,
    each called once under FlopCounterMode. `seg_wall_s` must be a
    synchronised wall time of ONE segment. The JAX function's byte counts
    come from XLA's cost model, which eager torch lacks:
    `segment_bytes_accessed` and `hbm_utilization_upper_bound` are None."""
    seg_flops = count_flops(segment)
    nn_flops = count_flops(forward)
    peak_flops, peak_hbm = device_peaks(device)
    out = {
        "segment_flops": seg_flops,
        "segment_bytes_accessed": None,
        "nn_forward_flops_per_row": nn_flops / max(nn_rows, 1),
        "device_kind": device_kind(device),
        "peak_bf16_flops": peak_flops,
        "peak_hbm_bytes_per_s": peak_hbm,
        "hbm_utilization_upper_bound": None,
    }
    if seg_flops and seg_wall_s > 0:
        achieved = seg_flops / seg_wall_s
        out["achieved_flops_per_s"] = round(achieved, 1)
        if peak_flops:
            out["mfu"] = round(achieved / peak_flops, 5)
    return out
