"""Batched array-of-trees MCTS with KataGo semantics, in PyTorch.

The port of `katacoffee_tpu/search/mcts.py` for a fresh tree and the default
`SearchParams()` profile: B independent searches advance in lockstep, one
playout per game per simulation, so the NN forward always sees a full [B]
batch. Node statistics are packed in `Tree.stats [B, N, 8]`. On the card
two hand-written CUDA kernels carry the search: the interior levels of each
playout's descent are one launch of `ops.descend.descend_interior` (the
child-stats gather fused in), and the root's full-width child-stats gather
and the readouts go through `ops.gather.gather_rows`. CPU tensors take the
plain torch versions.

What the slice implements (file:line cites are the JAX package's):
  * PUCT selection with FPU, the cpuct log term, the parent-utility stdev
    factor and root forced playouts (`_select_action`, :1030), and its
    compact-lane form for interior nodes (`_selection_compact`, from
    `_select_action_compact`, :712);
  * value aggregation with value-based downweighting (`_recompute_node`,
    :2205);
  * one playout (`_simulate_once`, :1167): descent (the root level at full
    width, interior levels on the <= 4*max(X,Y) candidate lanes of the
    node's last-move line), expansion (step, NN eval, node allocation) and
    backup, with the root child-stats cache carried across simulations;
  * `run_search` on a fresh tree (:2371) and the root readouts.

What it does not implement raises NotImplementedError naming the setting:
graph search, root noise, sampled root symmetries, subtree value bias, noise
pruning, uncertainty weighting, root policy temperature and optimism, root
symmetry pruning, parallel playouts, tree reuse, root hints, avoid masks and
randomized eval symmetries. With those off the search draws no random
numbers, so it is deterministic.

Tensors of a `Tree` are updated in place. Perspective convention: node
utilities are stored from the viewpoint of the player to move at that node
(negamax).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from katacoffee_tpu_torch.device import resolve_device
from katacoffee_tpu_torch.game.board import (
    GameConfig,
    GameState,
    _line_tables_np,
    legal_mask_flat,
    situation_hash,
    step,
)
from katacoffee_tpu_torch.nn.features import extract_features
from katacoffee_tpu_torch.ops.descend import descend_interior
from katacoffee_tpu_torch.ops.gather import gather_rows
from katacoffee_tpu_torch.search.params import SearchParams

_EPS = 1e-8

# Channel layout of Tree.stats [B, N, NUM_STATS] (negamax perspective).
S_VISITS, S_W, S_WSQ, S_U, S_USQ, S_WL, S_DRAW, S_PAD = range(8)
NUM_STATS = 8
# Channel layout of Tree.self_stats [B, N, 4]: the node's own evaluation.
F_U, F_WL, F_DRAW, F_W = range(4)
NUM_SELF = 4


class Tree(NamedTuple):
    """Array-of-trees state. Leading dims: [B, N] (games x node slots).
    Every field of the JAX package's Tree is kept; the ones of mechanisms
    this slice does not run hold their neutral values."""

    states: GameState  # fields [B, N, ...]
    stats: torch.Tensor  # [B, N, 8] f32, S_* channels
    self_stats: torch.Tensor  # [B, N, 4] f32, F_* channels
    prior: torch.Tensor  # [B, N, A] f32 raw policy; illegal moves = -1
    root_prior: torch.Tensor  # [B, A] f32 root policy; -1 illegal
    children: torch.Tensor  # [B, N, A] int32 child index or -1
    edge_visits: torch.Tensor  # [B, N, A] int32 per-edge visit counts
    parent: torch.Tensor  # [B, N] int64
    parent_action: torch.Tensor  # [B, N] int64
    is_terminal: torch.Tensor  # [B, N] bool
    node_count: torch.Tensor  # [B] int64
    sit_hash: torch.Tensor  # [B, N, 2] int64 words of the uint32 situation hash
    policy_rank: torch.Tensor  # [B, 1, 1] int32 (noise pruning off)
    bias_key: torch.Tensor  # [B, N] int64
    last_bias_delta: torch.Tensor  # [B, N] f32
    last_bias_weight: torch.Tensor  # [B, N] f32
    bias_table: torch.Tensor  # [B, 1, 2] f32 (subtree value bias off)
    root_hint: torch.Tensor  # [B] int64, -1 = none


class EvalResult(NamedTuple):
    """What an evaluator returns for a batch of states."""

    policy: torch.Tensor  # [B, A] probabilities over legal moves
    utility: torch.Tensor  # [B] mover perspective
    wl: torch.Tensor  # [B] win minus loss
    draw: torch.Tensor  # [B]
    shortterm_error: torch.Tensor  # [B]


EvalFn = Callable[[GameState], EvalResult]


# ---------------------------------------------------------------------------
# Supported settings
# ---------------------------------------------------------------------------


def _check_supported(sp: SearchParams) -> None:
    unsupported = {
        "useGraphSearch": sp.useGraphSearch,
        "rootNoiseEnabled": sp.rootNoiseEnabled,
        "rootNumSymmetriesToSample>1": sp.rootNumSymmetriesToSample > 1,
        "subtreeValueBiasFactor!=0": sp.subtreeValueBiasFactor != 0.0,
        "useNoisePruning": sp.useNoisePruning,
        "useUncertainty": sp.useUncertainty,
        "rootPolicyTemperature!=1": sp.rootPolicyTemperature != 1.0,
        "rootPolicyTemperatureEarly!=1": sp.rootPolicyTemperatureEarly != 1.0,
        "policyOptimism!=0": sp.policyOptimism != 0.0,
        "rootPolicyOptimism!=0": sp.rootPolicyOptimism != 0.0,
        "rootSymmetryPruning": sp.rootSymmetryPruning,
        "numSearchThreads>1": sp.numSearchThreads > 1,
    }
    for flag, on in unsupported.items():
        if on:
            raise NotImplementedError(f"katacoffee_tpu_torch search: {flag} is not ported yet")


# ---------------------------------------------------------------------------
# Evaluators
# ---------------------------------------------------------------------------


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis, written as jax.nn.softmax computes it."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _masked_softmax(logits: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """Softmax over the legal entries, 0 elsewhere (and everywhere when no
    entry is legal)."""
    return torch.where(legal, _softmax(torch.where(legal, logits, -math.inf)), 0.0)


def uniform_eval_fn(cfg: GameConfig) -> EvalFn:
    """Uniform prior over legal moves, zero value (deterministic)."""

    def fn(states: GameState) -> EvalResult:
        legal = legal_mask_flat(cfg, states)
        cnt = legal.sum(-1, keepdim=True).clamp(min=1)
        policy = legal.to(torch.float32) / cnt
        b = policy.shape[0]
        zeros = torch.zeros((b,), dtype=torch.float32, device=policy.device)
        return EvalResult(
            policy=policy, utility=zeros, wl=zeros, draw=zeros,
            shortterm_error=torch.full_like(zeros, 0.5),
        )

    return fn


def make_nn_eval_fn(cfg: GameConfig, model, symmetry_randomize: bool = False) -> EvalFn:
    """Wrap a CoffeeNet into an EvalFn: features, forward, softmax of the
    policy over legal moves, utility = P(win) - P(loss). The states must lie
    on the model's device."""
    if symmetry_randomize:
        raise NotImplementedError("katacoffee_tpu_torch search: symmetry_randomize is not ported yet")

    @torch.no_grad()
    def fn(states: GameState) -> EvalResult:
        spatial, glob = extract_features(cfg, states)
        out = model(spatial, glob)
        legal = legal_mask_flat(cfg, states)
        probs = _softmax(out["value_logits"])
        utility = probs[:, 0] - probs[:, 1]
        return EvalResult(
            policy=_masked_softmax(out["policy_logits"], legal),
            utility=utility,
            wl=utility,
            draw=probs[:, 2],
            shortterm_error=out["shortterm_error"],
        )

    return fn


# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------


def _eval_weight(sp: SearchParams, shortterm_error: torch.Tensor) -> torch.Tensor:
    """computeWeightFromNNOutput with uncertainty weighting off (useUncertainty
    is refused by _check_supported): weight 1."""
    return torch.ones_like(shortterm_error)


def _terminal_utility(states: GameState) -> torch.Tensor:
    """Utility of a finished game for the player to move: -1 if there is a
    winner (the previous mover), 0 on a draw."""
    return torch.where(states.winner == 0, 0.0, -1.0).to(torch.float32)


def _stats_row(visits, w, wsq, u, usq, wl, draw):
    return torch.stack([visits, w, wsq, u, usq, wl, draw, torch.zeros_like(w)], dim=-1)


def _gather_child_stats(tree: Tree, bidx, node) -> torch.Tensor:
    """Raw stat rows of every child of `node`: [B, A, 8], zero rows for
    missing children."""
    return gather_rows(tree.stats, tree.children[bidx, node])


def _edge_stats_from_raw(tree: Tree, bidx, node, cs_raw, child_row=None, evis_row=None) -> dict:
    """Per-action child stats with edge-scaled weights: w = childWeightSum *
    edgeVisits / max(childVisits, 1), parent perspective. `child_row` /
    `evis_row` supply compact lane views instead of the node's full rows."""
    child = tree.children[bidx, node] if child_row is None else child_row
    evis = (tree.edge_visits[bidx, node] if evis_row is None else evis_row).to(torch.float32)
    scale = evis / cs_raw[..., S_VISITS].clamp(min=1.0)
    live = (child >= 0) & (evis > 0)
    w = torch.where(live, cs_raw[..., S_W] * scale, 0.0)
    wsq = torch.where(live, cs_raw[..., S_WSQ] * scale * scale, 0.0)
    u = torch.where(live, -cs_raw[..., S_U], 0.0)
    usq = torch.where(live, cs_raw[..., S_USQ], 0.0)
    wl = torch.where(live, -cs_raw[..., S_WL], 0.0)
    draw = torch.where(live, cs_raw[..., S_DRAW], 0.0)
    return dict(live=live, w=w, wsq=wsq, u=u, usq=usq, wl=wl, draw=draw, evis=evis)


def _child_edge_stats(tree: Tree, bidx, node) -> dict:
    return _edge_stats_from_raw(tree, bidx, node, _gather_child_stats(tree, bidx, node))


# ---------------------------------------------------------------------------
# Compact action lanes (interior nodes)
#
# Every interior node's legal moves lie on the line through its last move's
# spot along its direction: at most max(X, Y) spots x 4 directions = C lanes
# (20 on 5x5, against A = 100). Interior levels of descent and backup run on
# those lanes; storage stays full width.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _cand_table_np(x_size: int, y_size: int, win_len: int) -> np.ndarray:
    """[area+1, 5, C] int64: flat candidate actions for a node whose last
    move was (spot, dir), -1 padded, in ascending flat order so that an
    argmax over lanes breaks ties like one over flat actions. Rows with no
    last move (spot=area or dir=4) are all -1."""
    _, lastline, _, _ = _line_tables_np(x_size, y_size, win_len)
    area = x_size * y_size
    C = 4 * max(x_size, y_size)
    tab = np.full((area + 1, 5, C), -1, np.int64)
    for s in range(area):
        for d in range(4):
            spots = np.nonzero(lastline[s, d])[0]
            acts = [dp * area + int(sp) for dp in range(4) for sp in spots]
            if len(acts) > C:
                raise AssertionError((s, d, len(acts), C))
            tab[s, d, : len(acts)] = acts
    return tab


@functools.lru_cache(maxsize=None)
def _cand_table(cfg: GameConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_cand_table_np(cfg.x_size, cfg.y_size, cfg.win_len)).to(device)


@functools.lru_cache(maxsize=None)
def _cand_table_i32(cfg: GameConfig, device: torch.device) -> torch.Tensor:
    """The candidate table as the descent kernel reads it."""
    return _cand_table(cfg, device).to(torch.int32).contiguous()


def _cand_lanes(cfg: GameConfig, states: GameState, bidx, node):
    """(cand [B, C] flat actions with -1 pad, valid [B, C]) for the nodes'
    last-move lines."""
    tab = _cand_table(cfg, node.device)
    s = states.last_spot[bidx, node]
    d = states.last_dir[bidx, node]
    cand = tab[torch.where(s < 0, cfg.area, s), d.clamp(0, 4)]
    return cand, cand >= 0


def _compact_row(row: torch.Tensor, cand: torch.Tensor, valid: torch.Tensor, fill) -> torch.Tensor:
    """[B, C] entries of a full [B, A] row at the candidate lanes, `fill` on
    padding lanes. An index gather: exact for every dtype."""
    return torch.where(valid, row.gather(1, cand.clamp(min=0)), fill)


def _stdev_factor(sp: SearchParams, node_stats: torch.Tensor) -> torch.Tensor:
    """parentUtilityStdevFactor (searchexplorehelpers.cpp:262-285)."""
    if sp.cpuctUtilityStdevScale == 0.0:
        return torch.ones_like(node_stats[:, S_W])
    w_sum = node_stats[:, S_W]
    u = node_stats[:, S_U]
    usq = torch.maximum(node_stats[:, S_USQ], u * u)
    var_prior = sp.cpuctUtilityStdevPrior**2
    pw = sp.cpuctUtilityStdevPriorWeight
    stdev = torch.sqrt(
        torch.clamp(
            ((u * u + var_prior) * pw + usq * w_sum) / (pw + torch.clamp(w_sum - 1.0, min=_EPS))
            - u * u,
            min=0.0,
        )
    )
    stdev = torch.where(w_sum <= 1.0, sp.cpuctUtilityStdevPrior, stdev)
    return 1.0 + sp.cpuctUtilityStdevScale * (stdev / sp.cpuctUtilityStdevPrior - 1.0)


def _explore_scaling(sp: SearchParams, total_child_w, node_stats) -> torch.Tensor:
    """cpuct(W) * sqrt(W + 0.01) * stdev factor (searchexplorehelpers.cpp:9-25)."""
    cpuct = sp.cpuctExploration + sp.cpuctExplorationLog * torch.log(
        (total_child_w + sp.cpuctExplorationBase) / sp.cpuctExplorationBase
    )
    return cpuct * torch.sqrt(total_child_w + 0.01) * _stdev_factor(sp, node_stats)


def _fpu_parent_utility(sp: SearchParams, node_stats, self_u, mass_visited) -> torch.Tensor:
    parent_u = node_stats[:, S_U]
    if sp.fpuParentWeightByVisitedPolicy:
        avg_w = torch.clamp(mass_visited**sp.fpuParentWeightByVisitedPolicyPow, max=1.0)
        return avg_w * parent_u + (1.0 - avg_w) * self_u
    if sp.fpuParentWeight > 0.0:
        return sp.fpuParentWeight * self_u + (1.0 - sp.fpuParentWeight) * parent_u
    return parent_u


def _selection_compact(sp: SearchParams, prior, cs: dict, node_stats, self_u) -> torch.Tensor:
    """PUCT scores [B, C] over compact lanes with the non-root semantics of
    _select_action, -inf on illegal lanes; the chosen lane is their argmax."""
    child_w = cs["w"]
    has_child = cs["live"]
    explore_scaling = _explore_scaling(sp, child_w.sum(-1), node_stats)
    legal_prior = prior.clamp(min=0.0)
    mass_visited = torch.where(has_child, legal_prior, 0.0).sum(-1)
    parent_u = _fpu_parent_utility(sp, node_stats, self_u, mass_visited)
    fpu = parent_u - sp.fpuReductionMax * torch.sqrt(mass_visited)
    fpu = fpu + (-sp.winLossUtilityFactor - fpu) * sp.fpuLossProp
    q = torch.where(has_child, cs["u"], fpu[:, None])
    selection = explore_scaling[:, None] * legal_prior / (1.0 + child_w) + q
    return torch.where(prior < 0, -math.inf, selection)


def _select_action(sp: SearchParams, tree: Tree, node, is_root, cs=None) -> torch.Tensor:
    """Vectorized selectBestChildToDescend (searchexplorehelpers.cpp:304-451)
    for nodes [B]; `is_root` [B] bool. Returns the chosen action [B]."""
    B = node.shape[0]
    bidx = torch.arange(B, device=node.device)
    prior = torch.where(is_root[:, None], tree.root_prior, tree.prior[bidx, node])
    if cs is None:
        cs = _child_edge_stats(tree, bidx, node)
    child_w = cs["w"]
    has_child = cs["live"]
    node_stats = tree.stats[bidx, node]
    total_child_w = child_w.sum(-1)
    explore_scaling = _explore_scaling(sp, total_child_w, node_stats)

    legal_prior = prior.clamp(min=0.0)
    mass_visited = torch.where(has_child, legal_prior, 0.0).sum(-1)
    parent_u = _fpu_parent_utility(sp, node_stats, tree.self_stats[bidx, node, F_U], mass_visited)
    red_max = torch.where(is_root, sp.rootFpuReductionMax, sp.fpuReductionMax).to(torch.float32)
    loss_prop = torch.where(is_root, sp.rootFpuLossProp, sp.fpuLossProp).to(torch.float32)
    fpu = parent_u - red_max * torch.sqrt(mass_visited)
    fpu = fpu + (-sp.winLossUtilityFactor - fpu) * loss_prop

    q = torch.where(has_child, cs["u"], fpu[:, None])
    selection = explore_scaling[:, None] * legal_prior / (1.0 + child_w) + q
    selection = torch.where(prior < 0, -math.inf, selection)
    if sp.rootDesiredPerChildVisitsCoeff > 0.0:
        # root forced playouts (searchexplorehelpers.cpp:150)
        forced = torch.sqrt(sp.rootDesiredPerChildVisitsCoeff * legal_prior * total_child_w[:, None])
        force = has_child & (child_w < forced) & (child_w > 0.0) & is_root[:, None]
        selection = torch.where(force, math.inf, selection)
    return torch.argmax(selection, dim=-1)


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def init_tree(cfg: GameConfig, sp: SearchParams, eval_fn: EvalFn, root_states: GameState,
              max_nodes: int) -> Tree:
    """Allocate trees and evaluate the roots (beginSearch without reuse),
    under one root symmetry (`_root_eval` with k = 1)."""
    _check_supported(sp)
    return _tree_from_root_eval(cfg, sp, root_states, eval_fn(root_states), max_nodes)


def _make_root_prior(policy, legal) -> torch.Tensor:
    """Root policy with temperature 1, no noise, no hint, no avoid mask and
    no symmetry pruning: the NN policy on legal moves, -1 elsewhere."""
    return torch.where(legal, policy, -1.0)


def _tree_from_root_eval(cfg: GameConfig, sp: SearchParams, root_states: GameState,
                         res: EvalResult, max_nodes: int) -> Tree:
    B = root_states.board.shape[0]
    N = max_nodes
    A = cfg.policy_size
    dev = root_states.board.device

    states = root_states.map(lambda x: x[:, None].expand((B, N) + x.shape[1:]).clone())
    legal = legal_mask_flat(cfg, root_states)
    raw_prior = torch.where(legal, res.policy, -1.0)
    root_prior = _make_root_prior(res.policy, legal)

    root_term = root_states.done
    term_util = _terminal_utility(root_states)
    u0 = torch.where(root_term, term_util, res.utility)
    wl0 = torch.where(root_term, term_util, res.wl)
    d0 = torch.where(root_term, (root_states.winner == 0).to(torch.float32), res.draw)
    w0 = torch.where(root_term, 1.0, _eval_weight(sp, res.shortterm_error))
    one = torch.ones((B,), dtype=torch.float32, device=dev)

    def rows(width, dtype, fill, first):
        t = torch.full((B, N) + width, fill, dtype=dtype, device=dev)
        if first is not None:
            t[:, 0] = first
        return t

    return Tree(
        states=states,
        stats=rows((NUM_STATS,), torch.float32, 0.0, _stats_row(one, w0, w0 * w0, u0, u0 * u0, wl0, d0)),
        self_stats=rows((NUM_SELF,), torch.float32, 0.0, torch.stack([u0, wl0, d0, w0], dim=-1)),
        prior=rows((A,), torch.float32, 0.0, raw_prior),
        root_prior=root_prior,
        children=rows((A,), torch.int32, -1, None),
        edge_visits=rows((A,), torch.int32, 0, None),
        parent=rows((), torch.int64, -1, None),
        parent_action=rows((), torch.int64, -1, None),
        is_terminal=rows((), torch.bool, False, root_term),
        node_count=torch.ones((B,), dtype=torch.int64, device=dev),
        sit_hash=rows((2,), torch.int64, 0, situation_hash(cfg, root_states)),
        policy_rank=torch.zeros((B, 1, 1), dtype=torch.int32, device=dev),
        bias_key=rows((), torch.int64, 0, None),
        last_bias_delta=rows((), torch.float32, 0.0, None),
        last_bias_weight=rows((), torch.float32, 0.0, None),
        bias_table=torch.zeros((B, 1, 2), dtype=torch.float32, device=dev),
        root_hint=torch.full((B,), -1, dtype=torch.int64, device=dev),
    )


# ---------------------------------------------------------------------------
# One simulation for all B games
# ---------------------------------------------------------------------------


class LevelScratch(NamedTuple):
    """The compact lanes of each interior level of one playout, kept for its
    backup: slot d-1 holds the lanes of the path's node at depth d (for one
    level, the same fields without the D axis). Allocated once per search by
    `make_level_scratch`. A slot that a game did not reach in this playout
    holds an earlier playout's lanes or the initial fill, so every node index
    the backup derives from it is a real node or -1."""

    cs_raw: torch.Tensor  # [B, D, C, 8] f32 the children's raw stat rows, 0 if missing
    prior_c: torch.Tensor  # [B, D, C] f32 raw prior, -1 on padding lanes
    child_c: torch.Tensor  # [B, D, C] int32 child index, -1 missing
    ev_c: torch.Tensor  # [B, D, C] f32 edge visits


def make_level_scratch(cfg: GameConfig, batch: int, max_depth: int, device) -> LevelScratch:
    """Scratch for `max_depth` levels: child_c -1, the rest 0 (the
    counterpart of the JAX package's `make_sim_scratch`)."""
    C = 4 * max(cfg.x_size, cfg.y_size)
    shape = (batch, max_depth, C)
    return LevelScratch(
        cs_raw=torch.zeros(shape + (NUM_STATS,), dtype=torch.float32, device=device),
        prior_c=torch.zeros(shape, dtype=torch.float32, device=device),
        child_c=torch.full(shape, -1, dtype=torch.int32, device=device),
        ev_c=torch.zeros(shape, dtype=torch.float32, device=device),
    )


def _interior_level(cfg, sp: SearchParams, tree: Tree, bidx, node):
    """One interior level for nodes [B] (`bidx` = arange(B)): the candidate
    actions [B, C], the node's compact lanes as a LevelScratch of [B, C]
    fields, and the PUCT scores [B, C]."""
    cand, valid = _cand_lanes(cfg, tree.states, bidx, node)
    child_c = _compact_row(tree.children[bidx, node], cand, valid, -1)
    ev_c = _compact_row(tree.edge_visits[bidx, node], cand, valid, 0).to(torch.float32)
    prior_c = _compact_row(tree.prior[bidx, node], cand, valid, -1.0)
    cs_raw = gather_rows(tree.stats, child_c)
    cs = _edge_stats_from_raw(tree, bidx, node, cs_raw, child_row=child_c, evis_row=ev_c)
    selection = _selection_compact(
        sp, prior_c, cs, tree.stats[bidx, node], tree.self_stats[bidx, node, F_U]
    )
    return cand, LevelScratch(cs_raw, prior_c, child_c, ev_c), selection


def _descend_root(sp: SearchParams, tree: Tree, root_cs: torch.Tensor, max_depth: int):
    """The root level of descent, at full width from the carried root child
    stats. Returns (path, acts) [B, max_depth + 1] for the playout, the
    root's action act0 [B], and (node, depth, active) [B] after the level;
    the traversed root edge is counted in `tree.edge_visits`."""
    B = root_cs.shape[0]
    dev = root_cs.device
    bidx = torch.arange(B, device=dev)
    zero = torch.zeros((B,), dtype=torch.int64, device=dev)
    path = torch.full((B, max_depth + 1), -1, dtype=torch.int64, device=dev)
    path[:, 0] = 0
    acts = torch.zeros((B, max_depth + 1), dtype=torch.int64, device=dev)

    root_term = tree.is_terminal[:, 0]
    cs0 = _edge_stats_from_raw(tree, bidx, zero, root_cs)
    act0 = _select_action(sp, tree, zero, torch.ones_like(root_term), cs=cs0)
    child0 = tree.children[bidx, 0, act0]
    move_on0 = ~root_term & (child0 >= 0)
    tree.edge_visits[bidx, 0, act0] += move_on0.to(torch.int32)
    node = torch.where(move_on0, child0.clamp(min=0).to(torch.int64), zero)
    depth = move_on0.to(torch.int64)
    path[:, 1] = torch.where(move_on0, node, path[:, 1])
    active = move_on0 & (1 < max_depth)
    return path, acts, act0, node, depth, active


def _descend_interior_plain(cfg, sp: SearchParams, tree: Tree, node, depth, active, path, acts,
                            scratch: LevelScratch):
    """The interior levels of descent on compact lanes, all B games in lock
    step with one host sync per level, from (node, depth, active) after the
    root level down to the leaf. Per level and active game: the lanes go to
    `scratch` slot depth-1, the chosen lane to `acts[depth]` (also where the
    child is missing), and on moving on the edge visit to
    `tree.edge_visits` and the child to `path`; all in place. Stops at a
    terminal node, a missing child or depth == max_depth (the scratch's D).
    Returns (leaf, leaf_depth) [B]."""
    B = node.shape[0]
    bidx = torch.arange(B, device=node.device)
    max_depth = scratch.child_c.shape[1]
    while bool(active.any()):
        term = tree.is_terminal[bidx, node]
        cand, lanes, selection = _interior_level(cfg, sp, tree, bidx, node)
        slot = (depth - 1).clamp(min=0)
        for buf, val in zip(scratch, lanes):
            keep = active.reshape((B,) + (1,) * (val.dim() - 1))
            buf[bidx, slot] = torch.where(keep, val, buf[bidx, slot])

        act_c = torch.argmax(selection, dim=-1)
        child = lanes.child_c[bidx, act_c]
        flat_act = cand[bidx, act_c]  # -1 only where the lane is not active
        move_on = active & ~term & (child >= 0)
        rec = active & ~term
        acts[bidx, torch.where(rec, depth, max_depth)] = torch.where(rec, act_c, acts[:, max_depth])
        tree.edge_visits[bidx, node, flat_act.clamp(min=0)] += move_on.to(torch.int32)
        node = torch.where(move_on, child.clamp(min=0).to(torch.int64), node)
        depth = torch.where(move_on, depth + 1, depth)
        path[bidx, torch.where(move_on, depth, 0)] = torch.where(move_on, node, path[:, 0])
        active = move_on & (depth < max_depth)
    return node, depth


def _descend_interior(cfg, sp: SearchParams, tree: Tree, node, depth, active, path, acts,
                      scratch: LevelScratch):
    """The interior descent: `_descend_interior_plain` on CPU tensors, else
    one launch of the fused CUDA kernel (`ops.descend.descend_interior`),
    which raises on anything it does not take. No fallback."""
    if tree.stats.device.type == "cpu" and node.device.type == "cpu":
        return _descend_interior_plain(cfg, sp, tree, node, depth, active, path, acts, scratch)
    cand = _cand_table_i32(cfg, node.device)
    return descend_interior(sp, cand, tree, node, depth, active, path, acts, scratch)


def _simulate_once(cfg, sp: SearchParams, eval_fn: EvalFn, tree: Tree, max_depth: int,
                   root_cs: torch.Tensor, scratch: LevelScratch) -> torch.Tensor:
    """One playout per game, updating `tree` in place. `root_cs` [B, A, 8]
    is the root's child-stats gather carried across the simulations of one
    search: only the root child this playout went through changes, so it is
    patched here (in place) and returned. `scratch` holds the interior
    levels' lanes from the descent to the backup."""
    B, N, A = tree.prior.shape
    dev = tree.stats.device
    bidx = torch.arange(B, device=dev)
    C = 4 * max(cfg.x_size, cfg.y_size)
    zero = torch.zeros((B,), dtype=torch.int64, device=dev)

    # ---------------- Descent ----------------
    path, acts, act0, node, depth, active = _descend_root(sp, tree, root_cs, max_depth)
    leaf, leaf_depth = _descend_interior(cfg, sp, tree, node, depth, active, path, acts, scratch)
    # the stopping edge's flat action: the root's, or the recorded lane
    # mapped through the leaf's candidate table
    leaf_cand, _ = _cand_lanes(cfg, tree.states, bidx, leaf)
    flat_stop = leaf_cand[bidx, acts[bidx, leaf_depth].clamp(0, C - 1)]
    action = torch.where(leaf_depth == 0, act0, flat_stop).clamp(0, A - 1)
    depth_capped = leaf_depth >= max_depth
    action = torch.where(depth_capped, 0, action)
    leaf_is_terminal = tree.is_terminal[bidx, leaf]
    leaf_terminal = leaf_is_terminal & ~depth_capped
    expanding = ~leaf_is_terminal & ~depth_capped

    # ---------------- Expansion ----------------
    new_states = step(cfg, tree.states.map(lambda x: x[bidx, leaf]), action)
    res = eval_fn(new_states)

    new_idx = tree.node_count.clone()  # node_count is advanced in place below
    do_alloc = expanding & (new_idx < N)
    overflow = expanding & (new_idx >= N)

    new_terminal = new_states.done
    term_util = _terminal_utility(new_states)
    legal = legal_mask_flat(cfg, new_states)
    new_prior = torch.where(legal, res.policy, -1.0)
    u_new = torch.where(new_terminal, term_util, res.utility)
    wl_new = torch.where(new_terminal, term_util, res.wl)
    d_new = torch.where(new_terminal, (new_states.winner == 0).to(torch.float32), res.draw)
    w_new = torch.where(new_terminal, 1.0, _eval_weight(sp, res.shortterm_error))

    slot = torch.where(do_alloc, new_idx, 0)  # slot-0 writes keep the old row

    def upd(arr, val):
        m = do_alloc.reshape((B,) + (1,) * (val.dim() - 1))
        arr[bidx, slot] = torch.where(m, val.to(arr.dtype), arr[bidx, slot])

    for full, new in zip(tree.states, new_states):
        upd(full, new)
    one = torch.ones((B,), dtype=torch.float32, device=dev)
    upd(tree.stats, _stats_row(one, w_new, w_new * w_new, u_new, u_new * u_new, wl_new, d_new))
    upd(tree.self_stats, torch.stack([u_new, wl_new, d_new, w_new], dim=-1))
    upd(tree.prior, new_prior)
    upd(tree.parent, leaf)
    upd(tree.parent_action, action)
    upd(tree.is_terminal, new_terminal)
    tree.children[bidx, leaf, action] = torch.where(
        do_alloc, new_idx.to(torch.int32), tree.children[bidx, leaf, action]
    )
    tree.node_count.add_(do_alloc.to(torch.int64))
    edge_inc = do_alloc.to(torch.int32)
    tree.edge_visits[bidx, leaf, action] += edge_inc

    # terminal leaf (or full tree): re-add its stored value incrementally
    revisit = leaf_terminal | overflow
    leaf_row = tree.stats[bidx, leaf]
    leaf_self = tree.self_stats[bidx, leaf]
    lw = leaf_self[:, F_W]
    old_ws = leaf_row[:, S_W]
    new_ws = old_ws + lw
    inv = 1.0 / new_ws.clamp(min=_EPS)
    lu = leaf_self[:, F_U]
    revisit_row = _stats_row(
        leaf_row[:, S_VISITS] + 1.0,
        new_ws,
        leaf_row[:, S_WSQ] + lw * lw,
        (leaf_row[:, S_U] * old_ws + lu * lw) * inv,
        (leaf_row[:, S_USQ] * old_ws + lu * lu * lw) * inv,
        (leaf_row[:, S_WL] * old_ws + leaf_self[:, F_WL] * lw) * inv,
        (leaf_row[:, S_DRAW] * old_ws + leaf_self[:, F_DRAW] * lw) * inv,
    )
    tree.stats[bidx, leaf] = torch.where(revisit[:, None], revisit_row, leaf_row)

    # ---------------- Backup ----------------
    # Recompute the path bottom-up. A terminal/overflow revisit starts at the
    # leaf's parent; an expansion starts at the stopping node. Interior
    # levels reuse the descent's saved lanes (the scratch), patched with what
    # this playout changed: the new child link, the edge visits, the path
    # child's stats.
    limit = torch.where(revisit | depth_capped, leaf_depth - 1, leaf_depth)
    new_child = torch.where(do_alloc, new_idx, -1).to(torch.int32)
    for lvl in range(int(limit.max()), 0, -1):
        n = path[:, lvl]
        on_path = (lvl <= limit) & (n >= 0) & (lvl <= leaf_depth)
        cs_raw, _, child_c, ev_c = (x[:, lvl - 1] for x in scratch)  # views: patches land
        pa = acts[:, lvl]
        at_stop = leaf_depth == lvl
        child_c[bidx, pa] = torch.where(at_stop & (new_child >= 0), new_child, child_c[bidx, pa])
        ev_c[bidx, pa] += torch.where(
            at_stop, edge_inc.to(torch.float32), (lvl < leaf_depth).to(torch.float32)
        )
        pchild = child_c[bidx, pa]
        prow = tree.stats[bidx, pchild.clamp(min=0).to(torch.int64)]
        cs_raw[bidx, pa] = torch.where((pchild >= 0)[:, None], prow, cs_raw[bidx, pa])
        _recompute_node(sp, tree, n, on_path, cs_raw=cs_raw, lanes=(child_c, ev_c))

    # root level, full width, from the carried root child stats
    rchild = tree.children[bidx, 0, act0]
    rrow = tree.stats[bidx, rchild.clamp(min=0).to(torch.int64)]
    root_cs[bidx, act0] = torch.where((rchild >= 0)[:, None], rrow, root_cs[bidx, act0])
    _recompute_node(sp, tree, zero, limit >= 0, cs_raw=root_cs)
    return root_cs


def _norm_cdf(z):
    return 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))


def _recompute_node(sp: SearchParams, tree: Tree, node, mask, cs_raw=None, lanes=None) -> None:
    """recomputeNodeStats for nodes [B] where `mask` (searchupdatehelpers.cpp:
    152-337): aggregate the child edges with value-based downweighting and
    add the node's own eval; one row write per node. `cs_raw` [B, A', 8]
    supplies the children's raw stat rows; `lanes` = (child_row, evis_row)
    supplies compact [B, C] lane views for interior nodes."""
    B = node.shape[0]
    bidx = torch.arange(B, device=node.device)
    if cs_raw is None:
        cs_raw = _gather_child_stats(tree, bidx, node)
    child_row, evis_row = (None, None) if lanes is None else lanes
    cs = _edge_stats_from_raw(tree, bidx, node, cs_raw, child_row=child_row, evis_row=evis_row)
    cw, cu, cwl, cdraw, cusq, cwsq = cs["w"], cs["u"], cs["wl"], cs["draw"], cs["usq"], cs["wsq"]
    total_w = cw.sum(-1)

    if sp.valueWeightExponent > 0:
        # downweightBadChildrenAndNormalizeWeight (searchupdatehelpers.cpp:368+)
        simple_value = torch.where(
            total_w > 0, (cu * cw).sum(-1) / total_w.clamp(min=_EPS), 0.0
        )
        precision = 1.5 * torch.sqrt(cw.clamp(min=_EPS))
        stdev = torch.sqrt(1e-8 + 1.0 / precision)
        z = (cu - simple_value[:, None]) / stdev
        p = _norm_cdf(z) + 1e-4
        w_adj = cw * torch.pow(p, sp.valueWeightExponent)
        w_adj_sum = w_adj.sum(-1)
        factor = torch.where(w_adj_sum > 0, total_w / w_adj_sum.clamp(min=_EPS), 0.0)
        w_adj = w_adj * factor[:, None]
    else:
        w_adj = cw

    scaling = torch.where(cw > 0, w_adj / cw.clamp(min=_EPS), 0.0)
    selfs = tree.self_stats[bidx, node]
    self_w = selfs[:, F_W]
    self_u = selfs[:, F_U]
    child_w_total = w_adj.sum(-1)
    util_children_sum = (w_adj * cu).sum(-1)

    weight_sum = child_w_total + self_w
    inv = 1.0 / weight_sum.clamp(min=_EPS)
    old_row = tree.stats[bidx, node]
    new_row = _stats_row(
        old_row[:, S_VISITS] + 1.0,
        weight_sum,
        (scaling * scaling * cwsq).sum(-1) + self_w * self_w,
        (util_children_sum + self_w * self_u) * inv,
        ((w_adj * cusq).sum(-1) + self_w * self_u * self_u) * inv,
        ((w_adj * cwl).sum(-1) + self_w * selfs[:, F_WL]) * inv,
        ((w_adj * cdraw).sum(-1) + self_w * selfs[:, F_DRAW]) * inv,
    )
    tree.stats[bidx, node] = torch.where(mask[:, None], new_row, old_row)


# ---------------------------------------------------------------------------
# Whole search
# ---------------------------------------------------------------------------


@torch.no_grad()
def run_search(
    cfg: GameConfig,
    sp: SearchParams,
    eval_fn: EvalFn,
    root_states: GameState,
    num_sims: int,
    max_nodes: int | None = None,
    *,
    device: str | torch.device | None = None,
    reuse_tree: Tree | None = None,
    root_hint: torch.Tensor | None = None,
    root_avoid: torch.Tensor | None = None,
    avoid_until: torch.Tensor | None = None,
) -> Tree:
    """runWholeSearch on a fresh tree: exactly `num_sims` playouts for each
    of the B games (the root ends at num_sims + 1 visits), on `device`
    (default `cuda`; the root states are moved there). The evaluator must
    run on the same device. Tree reuse, root hints and avoid masks are not
    ported yet and raise."""
    for name, arg in (("reuse_tree", reuse_tree), ("root_hint", root_hint),
                      ("root_avoid", root_avoid), ("avoid_until", avoid_until)):
        if arg is not None:
            raise NotImplementedError(f"katacoffee_tpu_torch search: {name} is not ported yet")
    _check_supported(sp)
    dev = resolve_device(device)
    root_states = root_states.map(lambda x: x.to(dev))
    if max_nodes is None:
        max_nodes = num_sims + 2
    max_depth = cfg.area + 1

    tree = init_tree(cfg, sp, eval_fn, root_states, max_nodes)
    B = tree.stats.shape[0]
    root_cs = _gather_child_stats(
        tree, torch.arange(B, device=dev), torch.zeros((B,), dtype=torch.int64, device=dev)
    )
    scratch = make_level_scratch(cfg, B, max_depth, dev)
    for _ in range(num_sims):
        root_cs = _simulate_once(cfg, sp, eval_fn, tree, max_depth, root_cs, scratch)
    return tree


# ---------------------------------------------------------------------------
# Results (searchresults.cpp)
# ---------------------------------------------------------------------------


def _root_child_stats(tree: Tree) -> dict:
    B = tree.children.shape[0]
    dev = tree.children.device
    return _child_edge_stats(
        tree, torch.arange(B, device=dev), torch.zeros((B,), dtype=torch.int64, device=dev)
    )


def root_visit_counts(tree: Tree) -> torch.Tensor:
    """[B, A] root edge-visit counts."""
    return tree.edge_visits[:, 0, :]


@torch.no_grad()
def root_values(tree: Tree) -> dict:
    """Root aggregate values from the root mover's perspective, plus
    per-child values [B, A] (parent perspective, 0 for missing edges)."""
    cs = _root_child_stats(tree)
    return {
        "root_utility": tree.stats[:, 0, S_U],
        "root_wl": tree.stats[:, 0, S_WL],
        "root_draw": tree.stats[:, 0, S_DRAW],
        "child_utility": cs["u"],
        "child_wl": cs["wl"],
        "child_draw": cs["draw"],
        "root_visits": (tree.stats[:, 0, S_VISITS] + 0.5).to(torch.int32),
    }


def _root_explore_scaling(sp: SearchParams, tree: Tree, cs: dict) -> torch.Tensor:
    """Root exploreScaling, as _select_action computes it during descent."""
    return _explore_scaling(sp, cs["w"].sum(-1), tree.stats[:, 0])


@torch.no_grad()
def root_play_selection_weights(sp: SearchParams, tree: Tree, cs: dict | None = None) -> torch.Tensor:
    """Root play-selection values [B, A]: edge-scaled child weights with the
    retrospective over-visited reduction (getPlaySelectionValues,
    searchresults.cpp:110-186, and getReducedPlaySelectionWeight,
    searchexplorehelpers.cpp:209-242)."""
    A = tree.children.shape[-1]
    if cs is None:
        cs = _root_child_stats(tree)
    w = cs["w"]
    u = cs["u"]
    evis = cs["evis"]
    live = cs["live"] & (w > 0)
    legal_prior = tree.root_prior.clamp(min=0.0)

    g = w * (evis - 1.0).clamp(min=0.0) / evis.clamp(min=1.0) + 2.0 * legal_prior
    g = torch.where(live, g, -math.inf)
    best = torch.argmax(g, dim=-1)
    onehot_best = torch.nn.functional.one_hot(best, A).to(torch.bool)
    any_live = live.any(-1)

    scaling = _root_explore_scaling(sp, tree, cs)

    def take(x):
        return x.gather(1, best[:, None])

    best_sel = scaling[:, None] * take(legal_prior) / (1.0 + take(w)) + take(u)
    denom = best_sel - u
    wanted = torch.where(
        denom > 0, scaling[:, None] * legal_prior / denom.clamp(min=_EPS) - 1.0, math.inf
    )
    reduced = torch.ceil(torch.minimum(w, wanted.clamp(min=0.0)))
    out = torch.where(onehot_best | ~any_live[:, None], w, reduced)
    return torch.where(live, out, 0.0)
