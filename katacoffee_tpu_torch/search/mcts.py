"""Batched array-of-trees MCTS with KataGo semantics, in PyTorch.

The port of `katacoffee_tpu/search/mcts.py`: B independent searches advance
in lockstep, one playout per game per simulation, so the NN forward always
sees a full [B] batch. Node statistics are packed in `Tree.stats [B, N, 8]`.
On the card two hand-written CUDA kernels carry the search: the interior
levels of each playout's descent are one launch of
`ops.descend.descend_interior` (the child-stats gather and the graph-search
catch-up fused in), and the root's full-width child-stats gather and the
readouts go through `ops.gather.gather_rows`. CPU tensors take the plain
torch versions.

What the port implements (file:line cites are the JAX package's):
  * PUCT selection with FPU, the cpuct log term, the parent-utility stdev
    factor, root forced playouts and the rootHintLoc forcing
    (`_select_action`, :1030), and its compact-lane form for interior nodes
    (`_selection_compact`, from `_select_action_compact`, :712);
  * the evaluator (`make_nn_eval_fn`, :359), with a random symmetry per
    evaluated row where `symmetry_randomize` is set, and its optimistic
    policy (`policy_opt`), which policyOptimism / rootPolicyOptimism blend
    into new nodes' and the root's priors (`_blend_policy`, :499); the
    serving forward with every head (`make_raw_forward_fn`, :279) and its
    exact-keyed cache (`NNResultCache`, :293) for GTP's protocol surfaces;
  * uncertainty-weighted evaluations (useUncertainty: `_eval_weight`, :514),
    so node weights are fractional;
  * the root prior (`_make_root_prior`, :938): the early-game policy
    temperature, Dirichlet noise, the hint's 2 % shift, the avoid mask
    `root_avoid` and root symmetry pruning (`_root_symmetry_prune`, :909);
    the root evaluation averaged over sampled symmetries (`_root_eval`,
    :442);
  * the depth-limited avoid mask `avoid_until` [B, 2, A] (avoidMoveUntilByLoc)
    at the root (`_select_action`'s `forbid`) and in the descent (the
    compact `forbid_c` lanes, :1318);
  * graph search: transposition links by situation hash, the edge-visit
    catch-up (`want_catch_at`, :1209) and maxPlayoutDepthProp;
  * value aggregation with noise pruning (policy-ordered prefix sums over
    `Tree.policy_rank`, :2243), value-based downweighting, the root-noise
    weight subtraction and the subtree value bias (`_recompute_node`,
    :2205);
  * one playout (`_simulate_once`, :1167) with its `active` mask and the
    catch-up leak (graphSearchCatchUpLeakProb, :1209-1220), and K playouts a
    round for numSearchThreads = K > 1 (`_simulate_round`, :1653): the root
    selections sequenced over in-flight visits and virtual losses, the
    interior levels of the B*K rows in one descent, one batched evaluation,
    the expansions in playout order and the union backup; the whole search
    on a fresh or a reused tree (`run_search`, :2371; `advance_root`, :2643;
    `continue_search`, :2561) and the readouts (`select_moves` with LCB and
    temperatures, :2976; `policy_target`, :3057);
  * the evaluators `uniform_eval_fn` and `gaussian_prior_eval_fn` (:244).

Randomness: a search draws at its root (the sampled symmetries and the
Dirichlet noise; `select_moves` draws its Gumbel noise), once a playout or
round for the catch-up leak, and in a symmetry-randomizing or gaussian
evaluator. Every draw comes from the `torch.Generator` the caller passes, on
the search's device, or is passed in (`RootDraws`, `draw_leak`, `gumbel`,
`draw_syms`, `draw_normals`), as the tests do with the JAX package's draws;
a drawing call with neither raises ValueError. `run_search` refuses
numSearchThreads > 1 with maxPlayoutDepthProp < 1 under graph search, as the
JAX package does.

Rounding: the port rounds as torch does, not as XLA does (torch's
`pow(x, 0.5)` is a square root, row sums add in another order), so a
recomputed stats row agrees with JAX's within a few float32 ulps and a
descent may part from JAX's only where JAX's two best scores tie (PERF.md
section 2).

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
from katacoffee_tpu_torch.game import symmetry as S
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

# Subtree-value-bias table slots per game (hashed (mover, prev, prev2) keys,
# as the JAX package keys them; collisions blur the bias, a heuristic).
BIAS_SLOTS = 16384

# Channel layout of Tree.stats [B, N, NUM_STATS] (negamax perspective).
S_VISITS, S_W, S_WSQ, S_U, S_USQ, S_WL, S_DRAW, S_PAD = range(8)
NUM_STATS = 8
# Channel layout of Tree.self_stats [B, N, 4]: the node's own evaluation.
F_U, F_WL, F_DRAW, F_W = range(4)
NUM_SELF = 4


class Tree(NamedTuple):
    """Array-of-trees state. Leading dims: [B, N] (games x node slots).
    Every field of the JAX package's Tree is kept."""

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
    policy_rank: torch.Tensor  # [B, N, A] int32 each action's place in the node's policy-descending
    #   order (useNoisePruning); a [B, 1, 1] dummy with noise pruning off
    bias_key: torch.Tensor  # [B, N] int64 subtree-value-bias slot
    last_bias_delta: torch.Tensor  # [B, N] f32 the node's last table contribution
    last_bias_weight: torch.Tensor  # [B, N] f32
    bias_table: torch.Tensor  # [B, K, 2] f32 (deltaUtilitySum, weightSum); K = 1 with the bias off
    root_hint: torch.Tensor  # [B] int64 rootHintLoc action, -1 = none


class EvalResult(NamedTuple):
    """What an evaluator returns for a batch of states."""

    policy: torch.Tensor  # [B, A] probabilities over legal moves
    utility: torch.Tensor  # [B] mover perspective
    wl: torch.Tensor  # [B] win minus loss
    draw: torch.Tensor  # [B]
    shortterm_error: torch.Tensor  # [B]
    # the optimistic policy head's probabilities [B, A], or None where the
    # evaluator has none; the search blends them in per policyOptimism /
    # rootPolicyOptimism (`_blend_policy`)
    policy_opt: torch.Tensor | None = None


EvalFn = Callable[[GameState], EvalResult]


class RootDraws(NamedTuple):
    """A search's root draws, passed in instead of drawn from the generator
    (the tests pass the JAX package's): `syms` [B, k] the k distinct root
    symmetries of each game (rootNumSymmetriesToSample), `gamma` [B, A] the
    gamma sample of the Dirichlet noise in the new root prior, and
    `gamma_reused` [B, A] the one in a reused root's prior (`advance_root`).
    A field left None is drawn from the generator when it is needed."""

    syms: torch.Tensor | None = None
    gamma: torch.Tensor | None = None
    gamma_reused: torch.Tensor | None = None


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


def gaussian_prior_eval_fn(cfg: GameConfig, generator: torch.Generator | None = None,
                           draw_normals: Callable[[int], tuple[torch.Tensor, torch.Tensor]] | None = None
                           ) -> EvalFn:
    """The reference's randomized debugSkipNeuralNet (JAX
    `gaussian_prior_eval_fn`, mcts.py:244-276): per evaluation, policy
    logits N(0, 1) at the first `area` (dir-NORTH) entries and 0 at the
    others, softmaxed over the legal moves; utility softmax(0.2 N(0, 1)
    [2])[0] - [1], with wl = utility, draw 0 and shortterm error 0.5 ln 2.
    The normals, ([B, area], [B, 2]), come from `generator` (on the states'
    device) or from `draw_normals(B)`, as the tests pass the JAX package's."""
    if draw_normals is None:
        generator = _need_generator(generator, "gaussian_prior_eval_fn")

    def fn(states: GameState) -> EvalResult:
        legal = legal_mask_flat(cfg, states)
        b, a = legal.shape
        dev = legal.device
        if draw_normals is not None:
            pol, val = (x.to(device=dev, dtype=torch.float32) for x in draw_normals(b))
        else:
            pol = torch.randn((b, cfg.area), generator=generator, device=dev)
            val = torch.randn((b, 2), generator=generator, device=dev)
        logits = torch.zeros((b, a), dtype=torch.float32, device=dev)
        logits[:, : cfg.area] = pol
        wl2 = _softmax(val * 0.2)
        utility = wl2[:, 0] - wl2[:, 1]
        return EvalResult(
            policy=_masked_softmax(logits, legal), utility=utility, wl=utility,
            draw=torch.zeros_like(utility), shortterm_error=torch.full_like(utility, 0.5 * math.log(2.0)),
        )

    return fn


def make_nn_eval_fn(
    cfg: GameConfig,
    model,
    policy_optimism: float = 0.0,
    symmetry_randomize: bool = False,
    generator: torch.Generator | None = None,
    draw_syms: Callable[[int], torch.Tensor] | None = None,
) -> EvalFn:
    """Wrap a CoffeeNet into an EvalFn: features, forward, softmax of the
    policy over legal moves, utility = P(win) - P(loss), and the softmax of
    the optimistic policy head as `policy_opt`. The states must lie on the
    model's device. `policy_optimism` > 0 blends the optimistic logits into
    the policy's linearly (the JAX package's eval-level knob; the search's
    policyOptimism / rootPolicyOptimism blend `policy_opt` per node instead).

    `symmetry_randomize` evaluates each row under a random dihedral symmetry
    and inverts it on the policy logits (the reference NNEvaluator's
    nnRandomize; JAX `make_nn_eval_fn`, mcts.py:359-401): the symmetries
    [B], in [0, num_symmetries(cfg)), come from `generator` (on the model's
    device) or from `draw_syms(B)`, as the tests pass the JAX package's.
    They stay on the device: no host sync."""
    nsym = S.num_symmetries(cfg)
    if symmetry_randomize and draw_syms is None:
        generator = _need_generator(generator, "symmetry_randomize")

    @torch.no_grad()
    def fn(states: GameState) -> EvalResult:
        spatial, glob = extract_features(cfg, states)
        if symmetry_randomize:
            B = spatial.shape[0]
            syms = (draw_syms(B) if draw_syms is not None else
                    torch.randint(0, nsym, (B,), generator=generator, device=spatial.device)).to(spatial.device)
            spatial = S.apply_features(syms, spatial)
        out = model(spatial, glob)
        if symmetry_randomize:
            inv = S.invert(syms)
            for k in ("policy_logits", "optimistic_policy_logits"):
                out[k] = S.apply_policy(cfg, inv, out[k])
        logits = out["policy_logits"]
        if policy_optimism > 0.0:
            logits = (1.0 - policy_optimism) * logits + policy_optimism * out["optimistic_policy_logits"]
        legal = legal_mask_flat(cfg, states)
        probs = _softmax(out["value_logits"])
        utility = probs[:, 0] - probs[:, 1]
        return EvalResult(
            policy=_masked_softmax(logits, legal),
            utility=utility,
            wl=utility,
            draw=probs[:, 2],
            shortterm_error=out["shortterm_error"],
            policy_opt=_masked_softmax(out["optimistic_policy_logits"], legal),
        )

    return fn


def make_raw_forward_fn(cfg: GameConfig, model):
    """Full forward over a batch of GameStates on the model's device,
    returning every head of the net as float32 numpy arrays (JAX
    `make_raw_forward_fn`, mcts.py:279): the source of GTP's kata-raw-nn and
    of the ownership reports. The search's EvalFn drops the auxiliary heads;
    this serving path keeps them. States on another device (a position the
    GTP engine keeps on the host) are copied to the model's."""
    dev = next(model.parameters()).device

    @torch.no_grad()
    def fn(states: GameState) -> dict:
        out = model(*extract_features(cfg, states.map(lambda x: x.to(dev))))
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    return fn


class NNResultCache:
    """Serving-side NN result cache (JAX `NNResultCache`, mcts.py:293; the
    reference's NNCacheTable, `cpp/neuralnet/nneval.h:18-42`) for the
    protocol surfaces, which ask again for positions they asked for before
    (kata-raw-nn, ownership over a tree that grew).

    Keyed exactly, as the JAX cache is: the board's bytes, the player to
    move and the whole recent-move ring (the features read recent moves
    1-4, so the same board and last move reached in another order is
    another input). LRU by dict insertion order. A batch whose every row
    hits returns the stacked cached rows and runs nothing on the device;
    any miss forwards the whole batch once and stores every row."""

    def __init__(self, forward, capacity: int = 4096):
        self._forward = forward
        self._capacity = capacity
        self._store: dict = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _keys(states: GameState) -> list[tuple]:
        board, to_move, spots, dirs = (x.cpu().numpy() for x in (
            states.board, states.to_move, states.recent_spots, states.recent_dirs))
        return [(board[i].tobytes(), int(to_move[i]), spots[i].tobytes(), dirs[i].tobytes())
                for i in range(board.shape[0])]

    def __call__(self, states: GameState) -> dict:
        keys = self._keys(states)
        cached = [self._store.get(k) for k in keys]
        if all(c is not None for c in cached):
            self.hits += len(keys)
            for k in keys:  # refresh the LRU order
                self._store[k] = self._store.pop(k)
            return {name: np.stack([c[name] for c in cached]) for name in cached[0]}
        self.misses += len(keys)
        out = self._forward(states)
        for i, k in enumerate(keys):
            self._store.pop(k, None)
            self._store[k] = {name: v[i] for name, v in out.items()}
        while len(self._store) > self._capacity:
            self._store.pop(next(iter(self._store)))
        return out


def make_cached_raw_forward_fn(cfg: GameConfig, model, capacity: int = 4096) -> NNResultCache:
    """`make_raw_forward_fn` behind an `NNResultCache`, as the gtp command
    serves it."""
    return NNResultCache(make_raw_forward_fn(cfg, model), capacity)


def _need_generator(generator, what: str) -> torch.Generator:
    if generator is None:
        raise ValueError(f"katacoffee_tpu_torch search: {what} draws random numbers; pass a torch.Generator")
    return generator


def _root_eval(cfg, sp: SearchParams, eval_fn: EvalFn, states: GameState, generator=None,
               syms: torch.Tensor | None = None) -> EvalResult:
    """Root evaluation under rootNumSymmetriesToSample = k: k distinct
    dihedral symmetries per game (`syms` [B, k], else the first k of a
    random permutation drawn from `generator`), the root evaluated under
    each, both policies transformed back, and every output averaged (a None
    `policy_opt` stays None)."""
    k = min(int(sp.rootNumSymmetriesToSample), S.num_symmetries(cfg))
    if k <= 1:
        return eval_fn(states)
    if syms is None:
        g = _need_generator(generator, "rootNumSymmetriesToSample > 1")
        B = states.board.shape[0]
        syms = torch.argsort(
            torch.rand((B, S.num_symmetries(cfg)), generator=g, device=states.board.device), dim=-1
        )[:, :k]
    acc = None
    for j in range(k):
        sym = syms[:, j].to(states.board.device)
        res = eval_fn(S.apply_state(cfg, sym, states))
        inv = S.invert(sym)
        res = res._replace(policy=S.apply_policy(cfg, inv, res.policy))
        if res.policy_opt is not None:
            res = res._replace(policy_opt=S.apply_policy(cfg, inv, res.policy_opt))
        acc = res if acc is None else EvalResult(*(None if a is None else a + b for a, b in zip(acc, res)))
    return EvalResult(*(None if a is None else a / k for a in acc))


# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------


def _blend_policy(res: EvalResult, optimism: float) -> torch.Tensor:
    """policyOptimism (searchparams.h:30; JAX `_blend_policy`, mcts.py:499):
    the normalized geometric interpolation of the raw and optimistic
    policies, which equals blending the two heads' logits linearly before
    the softmax. The raw policy where the evaluator has no optimistic head
    or the optimism is 0."""
    if res.policy_opt is None or optimism == 0.0:
        return res.policy
    lp = torch.log(res.policy.clamp(min=1e-30))
    lo = torch.log(res.policy_opt.clamp(min=1e-30))
    b = torch.where(res.policy > 0, torch.exp((1.0 - optimism) * lp + optimism * lo), 0.0)
    return b / b.sum(-1, keepdim=True).clamp(min=1e-30)


def _eval_weight(sp: SearchParams, shortterm_error: torch.Tensor) -> torch.Tensor:
    """computeWeightFromNNOutput (searchupdatehelpers.cpp:103-121; JAX
    mcts.py:514): with useUncertainty, uncertaintyCoeff over the scaled
    short-term error plus uncertaintyCoeff / uncertaintyMaxWeight, so at
    most uncertaintyMaxWeight; else 1."""
    if not sp.useUncertainty:
        return torch.ones_like(shortterm_error)
    err = sp.winLossUtilityFactor * shortterm_error
    if sp.uncertaintyExponent != 1.0:
        err = torch.pow(err.clamp(min=0.0), sp.uncertaintyExponent)
    baseline = sp.uncertaintyCoeff / sp.uncertaintyMaxWeight
    # a true division, as JAX's (torch's scalar / tensor multiplies by the
    # reciprocal)
    return torch.full_like(err, sp.uncertaintyCoeff) / (err + baseline)


def _terminal_utility(states: GameState) -> torch.Tensor:
    """Utility of a finished game for the player to move: -1 if there is a
    winner (the previous mover), 0 on a draw."""
    return torch.where(states.winner == 0, 0.0, -1.0).to(torch.float32)


def _stats_row(visits, w, wsq, u, usq, wl, draw):
    return torch.stack([visits, w, wsq, u, usq, wl, draw, torch.zeros_like(w)], dim=-1)


def _policy_ranks(raw_prior: torch.Tensor) -> torch.Tensor:
    """[B, A] int32: each action's place in the policy-descending order (0 =
    the highest policy; JAX `_policy_ranks`, mcts.py:538). Both sorts are
    stable, as jnp.argsort is: illegal moves (-1, clamped to 1e-30) and
    equal priors keep their action order."""
    order = torch.argsort(-raw_prior.clamp(min=1e-30), dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True).to(torch.int32)


def _bias_keys(cfg: GameConfig, states: GameState) -> torch.Tensor:
    """[B] subtree-value-bias table slot from (mover of the last move, the
    last move, the move before it): the JAX package's uint32
    multiply-and-shift hash, in int64 with the product cut to 32 bits."""
    sentinel = 4 * cfg.area  # no move
    s0, s1 = states.recent_spots[..., 0], states.recent_spots[..., 1]
    a0 = torch.where(s0 >= 0, states.recent_dirs[..., 0].clamp(max=3) * cfg.area + s0, sentinel)
    a1 = torch.where(s1 >= 0, states.recent_dirs[..., 1].clamp(max=3) * cfg.area + s1, sentinel)
    mover = (3 - states.to_move.to(torch.int64)) - 1
    k = (a0 * (sentinel + 1) + a1) * 2 + mover
    return (((k * 2654435761) & 0xFFFFFFFF) >> 18) % BIAS_SLOTS


def _bias_avg(sp: SearchParams, tree: Tree, bidx, key) -> torch.Tensor:
    """factor * the entry's average where the entry has weight
    (addLeafValue)."""
    entry = tree.bias_table[bidx, key]  # [B, 2]
    return torch.where(
        entry[:, 1] > 0.001, sp.subtreeValueBiasFactor * entry[:, 0] / entry[:, 1].clamp(min=1e-9), 0.0
    )


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
    return dict(live=live, w=w, wsq=wsq, u=u, usq=usq, wl=wl, draw=draw, evis=evis,
                cvis=cs_raw[..., S_VISITS])


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
def _cand_table_i16(cfg: GameConfig, device: torch.device) -> torch.Tensor:
    """The candidate table as the descent kernel copies it into shared
    memory: int16 (every flat action is below 4 * area <= 900 for the boards
    it takes), flattened, -1 padded to a multiple of 16 bytes."""
    flat = _cand_table_np(cfg.x_size, cfg.y_size, cfg.win_len).reshape(-1)
    if flat.max() >= 2**15:
        raise ValueError(f"the candidate table of a {cfg.x_size}x{cfg.y_size} board does not fit int16")
    padded = np.concatenate([flat, np.full((-flat.size) % 8, -1, np.int64)]).astype(np.int16)
    return torch.from_numpy(padded).to(device)


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


def _avoid(selection, prior, forbid) -> torch.Tensor:
    """The avoid mask applied last (JAX mcts.py:1141-1146, :763-765): a
    forbidden move scores -inf, so no forcing rule picks it, unless the mask
    would leave the node no legal move, where it is ignored."""
    if forbid is None:
        return selection
    keep = ((prior >= 0.0) & ~forbid).any(-1)
    return torch.where(forbid & keep[:, None], -math.inf, selection)


def _selection_compact(sp: SearchParams, prior, cs: dict, node_stats, self_u, forbid=None) -> torch.Tensor:
    """PUCT scores [B, C] over compact lanes with the non-root semantics of
    _select_action, -inf on illegal lanes and on the lanes `forbid` [B, C]
    masks (`_avoid`); the chosen lane is their argmax."""
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
    return _avoid(torch.where(prior < 0, -math.inf, selection), prior, forbid)


def _select_action(sp: SearchParams, tree: Tree, node, is_root, cs=None, forbid=None) -> torch.Tensor:
    """Vectorized selectBestChildToDescend (searchexplorehelpers.cpp:304-451)
    for nodes [B]; `is_root` [B] bool; `forbid` [B, A] the avoided moves
    (`_avoid`). `cs` may carry `force_w`, the child weights without the
    virtual losses of a K round, for the forced-playout test (JAX
    :1109-1118). Returns the chosen action [B]."""
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
        fw = cs.get("force_w", child_w)
        forced = torch.sqrt(sp.rootDesiredPerChildVisitsCoeff * legal_prior * total_child_w[:, None])
        force = has_child & (fw < forced) & (fw > 0.0) & is_root[:, None]
        selection = torch.where(force, math.inf, selection)
    # rootHintLoc forced selection (searchexplorehelpers.cpp:155-168): the
    # hint move is forced while its weight (plus about one visit's worth)
    # trails 80% of the heaviest sibling's; a no-op where root_hint is -1
    hint_safe = tree.root_hint.clamp(min=0)
    has_hint = (tree.root_hint >= 0) & is_root
    pwpv = node_stats[:, S_W] / node_stats[:, S_VISITS].clamp(min=1.0)
    hint_w = child_w[bidx, hint_safe]
    avg_wpv = (hint_w + pwpv) / (cs["cvis"][bidx, hint_safe] + 1.0)
    force_hint = has_hint & (hint_w + avg_wpv < 0.8 * child_w.amax(-1)) & (prior[bidx, hint_safe] >= 0)
    selection[bidx, hint_safe] = torch.where(force_hint, math.inf, selection[bidx, hint_safe])
    return torch.argmax(_avoid(selection, prior, forbid), dim=-1)


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def init_tree(cfg: GameConfig, sp: SearchParams, eval_fn: EvalFn, root_states: GameState,
              max_nodes: int, *, generator: torch.Generator | None = None, draws: RootDraws | None = None,
              turn_number: torch.Tensor | None = None, root_hint: torch.Tensor | None = None,
              root_avoid: torch.Tensor | None = None) -> Tree:
    """Allocate trees and evaluate the roots (beginSearch without reuse).
    `turn_number` [B] drives the early-game temperature (default the roots'
    num_turns); `root_hint` [B] is each game's rootHintLoc action (-1 none);
    `root_avoid` [B, A] bool the root moves avoided (`_make_root_prior`).
    Root draws come from `draws` or `generator`."""
    draws = RootDraws() if draws is None else draws
    res = _root_eval(cfg, sp, eval_fn, root_states, generator, draws.syms)
    return _tree_from_root_eval(cfg, sp, root_states, res, max_nodes, generator=generator,
                                gamma=draws.gamma, turn_number=turn_number, root_hint=root_hint,
                                root_avoid=root_avoid)


def _add_dirichlet_noise(sp: SearchParams, policy, legal, generator=None, gamma=None) -> torch.Tensor:
    """KataGo's alpha allocation, half uniform and half shaped by the excess
    log-policy, then the Dirichlet mix (searchhelpers.cpp
    computeDirichletAlphaDistribution, addDirichletNoise). `gamma` [B, A] is
    the gamma sample at those alphas, else drawn from `generator`."""
    legal_f = legal.to(torch.float32)
    n_legal = legal_f.sum(-1, keepdim=True).clamp(min=1.0)
    logp = torch.log(policy.clamp(max=0.01) + 1e-20)
    log_mean = torch.where(legal, logp, 0.0).sum(-1, keepdim=True) / n_legal
    excess = torch.where(legal, (logp - log_mean).clamp(min=0.0), 0.0)
    excess_sum = excess.sum(-1, keepdim=True)
    shaped = torch.where(excess_sum > 0, excess / excess_sum.clamp(min=1e-20), legal_f / n_legal)
    alpha = (0.5 * legal_f / n_legal + 0.5 * shaped) * sp.rootDirichletNoiseTotalConcentration
    if gamma is None:
        g = _need_generator(generator, "rootNoiseEnabled")
        gamma = torch._standard_gamma(alpha.clamp(min=1e-10), generator=g)
    gamma = torch.where(legal & (alpha > 0), gamma.to(policy.device), 0.0)
    noise = gamma / gamma.sum(-1, keepdim=True).clamp(min=1e-20)
    w = sp.rootDirichletNoiseWeight
    return torch.where(legal, noise * w + policy * (1.0 - w), 0.0)


@functools.lru_cache(maxsize=None)
def _sym_action_table(cfg: GameConfig, device: torch.device) -> torch.Tensor:
    """[nsym, A] int64: each action's image under each symmetry (JAX
    `_sym_action_table`, mcts.py:885)."""
    return torch.from_numpy(S.action_table(cfg).astype(np.int64)).to(device)


def _root_symmetry_prune(cfg: GameConfig, states: GameState, prior: torch.Tensor) -> torch.Tensor:
    """rootSymmetryPruning (JAX `_root_symmetry_prune`, mcts.py:909): every
    legal move that is not the least action of its orbit under the
    symmetries fixing the root position (board and last move) gets -1, so
    one move of each orbit is searched (8 times fewer on the empty
    board)."""
    A = prior.shape[-1]
    stab = S.stabilizer_mask(cfg, states)  # [B, nsym], the identity always in
    table = _sym_action_table(cfg, prior.device)
    min_img = torch.where(stab[:, :, None], table[None], A).amin(1)
    canonical = min_img >= torch.arange(A, device=prior.device)[None, :]
    return torch.where(canonical, prior, -1.0)


def _make_root_prior(cfg: GameConfig, sp: SearchParams, policy, legal, root_states: GameState,
                     generator=None, gamma=None, turn_number=None, root_hint=None,
                     root_avoid=None) -> torch.Tensor:
    """Root policy (searchhelpers.cpp maybeAddPolicyNoiseAndTemp): the
    early-game interpolated temperature, Dirichlet noise, and the
    rootHintLoc shift of 2 % of the legal mass onto the hint move
    (searchhelpers.cpp:206-218); then the avoided moves `root_avoid` [B, A]
    made illegal, unless that leaves a game no legal move (the mask is then
    ignored), and root symmetry pruning, which never prunes the hint move;
    -1 on illegal moves."""
    if turn_number is None:
        turn_number = root_states.num_turns
    turn_number = turn_number.to(torch.float32)
    if sp.rootPolicyTemperature != 1.0 or sp.rootPolicyTemperatureEarly != 1.0:
        frac = 0.5 ** (turn_number / sp.chosenMoveTemperatureHalflife)
        temp = sp.rootPolicyTemperature + frac * (sp.rootPolicyTemperatureEarly - sp.rootPolicyTemperature)
        logp = torch.log(policy.clamp(min=1e-30)) / temp[:, None]
        policy = torch.where(legal, _softmax(torch.where(legal, logp, -math.inf)), 0.0)
    if sp.rootNoiseEnabled:
        policy = _add_dirichlet_noise(sp, policy, legal, generator, gamma)
    if root_hint is not None:
        bidx = torch.arange(policy.shape[0], device=policy.device)
        hint_safe = root_hint.clamp(min=0)
        hint_legal = (root_hint >= 0) & legal[bidx, hint_safe]
        prop = 0.02
        shifted = policy * (1.0 - prop)
        shifted[bidx, hint_safe] += torch.where(legal, policy, 0.0).sum(-1) * prop
        policy = torch.where(hint_legal[:, None], shifted, policy)
    if root_avoid is not None:
        masked = legal & ~root_avoid.to(device=legal.device, dtype=torch.bool)
        legal = torch.where(masked.any(-1, keepdim=True), masked, legal)
        policy = torch.where(legal, policy, 0.0)
    out = torch.where(legal, policy, -1.0)
    if sp.rootSymmetryPruning:
        pruned = _root_symmetry_prune(cfg, root_states, out)
        if root_hint is not None:
            bidx = torch.arange(out.shape[0], device=out.device)
            hint_safe = root_hint.clamp(min=0)
            restore = (root_hint >= 0) & (out[bidx, hint_safe] >= 0)
            pruned[bidx, hint_safe] = torch.where(restore, out[bidx, hint_safe], pruned[bidx, hint_safe])
        out = pruned
    return out


def _tree_from_root_eval(cfg: GameConfig, sp: SearchParams, root_states: GameState, res: EvalResult,
                         max_nodes: int, *, generator=None, gamma=None, turn_number=None,
                         root_hint=None, root_avoid=None) -> Tree:
    B = root_states.board.shape[0]
    N = max_nodes
    A = cfg.policy_size
    dev = root_states.board.device
    if root_hint is None:
        root_hint = torch.full((B,), -1, dtype=torch.int64, device=dev)
    root_hint = root_hint.to(device=dev, dtype=torch.int64)

    states = root_states.map(lambda x: x[:, None].expand((B, N) + x.shape[1:]).clone())
    legal = legal_mask_flat(cfg, root_states)
    root_policy = _blend_policy(res, sp.rootPolicyOptimism)
    raw_prior = torch.where(legal, root_policy, -1.0)
    root_prior = _make_root_prior(cfg, sp, root_policy, legal, root_states, generator, gamma, turn_number,
                                  root_hint, root_avoid)

    root_term = root_states.done
    term_util = _terminal_utility(root_states)
    u0 = torch.where(root_term, term_util, res.utility)
    wl0 = torch.where(root_term, term_util, res.wl)
    d0 = torch.where(root_term, (root_states.winner == 0).to(torch.float32), res.draw)
    w0 = torch.where(root_term, 1.0, _eval_weight(sp, res.shortterm_error))
    one = torch.ones((B,), dtype=torch.float32, device=dev)
    use_bias = sp.subtreeValueBiasFactor != 0.0

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
        policy_rank=(rows((A,), torch.int32, 0, _policy_ranks(raw_prior)) if sp.useNoisePruning
                     else torch.zeros((B, 1, 1), dtype=torch.int32, device=dev)),
        bias_key=rows((), torch.int64, 0, _bias_keys(cfg, root_states) if use_bias else None),
        last_bias_delta=rows((), torch.float32, 0.0, None),
        last_bias_weight=rows((), torch.float32, 0.0, None),
        bias_table=torch.zeros((B, BIAS_SLOTS if use_bias else 1, 2), dtype=torch.float32, device=dev),
        root_hint=root_hint,
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
    rank_c: torch.Tensor  # [B, D, C] f32 policy rank (useNoisePruning; else untouched), 1e6 on padding lanes


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
        rank_c=torch.zeros(shape, dtype=torch.float32, device=device),
    )


def _interior_level(cfg, sp: SearchParams, tree: Tree, bidx, node, depth=None, avoid_until=None):
    """One interior level for the nodes [R] of rows whose games are `bidx`
    [R] (arange(B), or each game K times over in a K round) at `depth` [R]:
    the candidate actions [R, C], the node's compact lanes as a LevelScratch
    of [R, C] fields (rank_c None with noise pruning off), and the PUCT
    scores [R, C]. `avoid_until` [B, 2, A] forbids, for the player to move
    at the node, the actions whose entry exceeds the depth (`forbid_c`, JAX
    mcts.py:1318-1323)."""
    cand, valid = _cand_lanes(cfg, tree.states, bidx, node)
    child_c = _compact_row(tree.children[bidx, node], cand, valid, -1)
    ev_c = _compact_row(tree.edge_visits[bidx, node], cand, valid, 0).to(torch.float32)
    prior_c = _compact_row(tree.prior[bidx, node], cand, valid, -1.0)
    rank_c = None
    if sp.useNoisePruning:
        rank_c = _compact_row(tree.policy_rank[bidx, node].to(torch.float32), cand, valid, 1e6)
    forbid_c = None
    if avoid_until is not None:
        pidx = (tree.states.to_move[bidx, node].to(torch.int64) - 1).clamp(0, 1)
        forbid_c = _compact_row(avoid_until[bidx, pidx], cand, valid, 0) > depth[:, None]
    # a K round's rows of one game gather from its stats as one [B, K * C] row
    cs_raw = gather_rows(tree.stats, child_c.reshape(tree.stats.shape[0], -1)).reshape(child_c.shape + (NUM_STATS,))
    cs = _edge_stats_from_raw(tree, bidx, node, cs_raw, child_row=child_c, evis_row=ev_c)
    selection = _selection_compact(
        sp, prior_c, cs, tree.stats[bidx, node], tree.self_stats[bidx, node, F_U], forbid_c
    )
    return cand, LevelScratch(cs_raw, prior_c, child_c, ev_c, rank_c), selection


def _want_catch(sp: SearchParams, ev, cvis, has_child, leak=None) -> torch.Tensor:
    """The edge-visit catch-up test of graph search (search.cpp:1169-1206):
    the chosen edge has fewer visits than its child, so the playout claims
    an edge visit there instead of descending, unless `leak` [B] (the
    catch-up leak, `_leaked`) lets it through. `ev` and `cvis` are the
    edge's visits and the child's S_VISITS, both float32."""
    if not sp.useGraphSearch:
        return torch.zeros_like(has_child)
    want = has_child & (ev < cvis - 0.5)
    return want if leak is None else want & ~leak


def _leaked(sp: SearchParams, leak_u: torch.Tensor | None, rows, depth):
    """graphSearchCatchUpLeakProb (JAX :1215-1219, :1745-1748, :1853-1857):
    [R] True where row `rows` leaks through a catch-up at node depth
    `depth`, from one playout's uniform draws `leak_u` [R, D + 1], compared
    in float32 as the JAX package compares; None without a leak."""
    if leak_u is None:
        return None
    col = depth.clamp(max=leak_u.shape[1] - 1) if isinstance(depth, torch.Tensor) else depth
    return leak_u[rows, col] < float(np.float32(sp.graphSearchCatchUpLeakProb))


def _leak_source(sp: SearchParams, generator=None, draw_leak=None):
    """A function (rows, cols, device) -> the uniform draws [rows, cols]
    float32 of one playout's (K = 1) or round's catch-up leak, from
    `draw_leak(rows, cols)` where given, else from `generator`; None without
    a leak. Raises without either."""
    if not (sp.useGraphSearch and sp.graphSearchCatchUpLeakProb > 0.0):
        return None
    if draw_leak is not None:
        return lambda rows, cols, dev: draw_leak(rows, cols).to(device=dev, dtype=torch.float32)
    g = _need_generator(generator, "graphSearchCatchUpLeakProb > 0")
    return lambda rows, cols, dev: torch.rand((rows, cols), generator=g, device=dev)


def _descend_root(sp: SearchParams, tree: Tree, root_cs: torch.Tensor, max_depth: int, act_mask=None,
                  avoid_until=None, leak_u=None):
    """The root level of descent, at full width from the carried root child
    stats. Returns (path, acts) [B, max_depth + 1] for the playout, the
    root's action act0 [B], (node, depth, walk) [B] after the level (`walk`:
    the games whose interior descent goes on) and the root's catch-up
    [B]. The traversed root edge of each game in `act_mask` (default all)
    is counted in `tree.edge_visits`. `avoid_until` [B, 2, A] forbids the
    root mover the actions whose entry is above 0 (`forbid0`); `leak_u`
    [B, max_depth + 1] are the playout's leak draws (column 0 here)."""
    B = root_cs.shape[0]
    dev = root_cs.device
    bidx = torch.arange(B, device=dev)
    zero = torch.zeros((B,), dtype=torch.int64, device=dev)
    path = torch.full((B, max_depth + 1), -1, dtype=torch.int64, device=dev)
    path[:, 0] = 0
    acts = torch.zeros((B, max_depth + 1), dtype=torch.int64, device=dev)

    root_term = tree.is_terminal[:, 0]
    cs0 = _edge_stats_from_raw(tree, bidx, zero, root_cs)
    forbid0 = None
    if avoid_until is not None:
        pidx0 = (tree.states.to_move[:, 0].to(torch.int64) - 1).clamp(0, 1)
        forbid0 = avoid_until[bidx, pidx0] > 0
    act0 = _select_action(sp, tree, zero, torch.ones_like(root_term), cs=cs0, forbid=forbid0)
    child0 = tree.children[bidx, 0, act0].to(torch.int64)
    has_child0 = child0 >= 0
    catch0 = _want_catch(
        sp, tree.edge_visits[bidx, 0, act0].to(torch.float32), tree.stats[bidx, child0.clamp(min=0), S_VISITS],
        has_child0, _leaked(sp, leak_u, bidx, 0),
    ) & ~root_term
    move_on0 = ~root_term & has_child0 & ~catch0
    walk = move_on0 if act_mask is None else move_on0 & act_mask
    tree.edge_visits[bidx, 0, act0] += walk.to(torch.int32)
    node = torch.where(move_on0, child0.clamp(min=0), zero)
    depth = move_on0.to(torch.int64)
    path[:, 1] = torch.where(move_on0, node, path[:, 1])
    return path, acts, act0, node, depth, walk & (1 < max_depth), catch0


def _descend_interior_plain(cfg, sp: SearchParams, tree: Tree, node, depth, active, path, acts,
                            scratch: LevelScratch, avoid_until=None, leak_u=None, acts_f=None):
    """The interior levels of descent on compact lanes, all rows in lock
    step with one host sync per level, from (node, depth, active) after the
    root level down to the leaf. A row is a game's playout: B rows, or in a
    K round (`acts_f` given) R = B * K rows, row r of game r // K. Per level
    and active row: the lanes go to `scratch` slot depth-1 (rank_c only with
    noise pruning), the chosen lane to `acts[depth]` (also where the child
    is missing or caught up), and on moving on the child to `path`; all in
    place. One row a game counts the edge visit in `tree.edge_visits` as it
    moves on; a K round records the lane's flat action in `acts_f[depth]`
    instead and counts no edge visit (`_count_path_edges` adds them after
    the descent: two rows of a game may pass one edge, and no level reads an
    edge another level writes, the DAG being graded). `avoid_until` [B, 2,
    A] masks lanes (`_interior_level`); `leak_u` [R, D + 1] are the leak
    draws (`_leaked`). Stops at a terminal node, a missing child, a
    graph-search catch-up or depth == max_depth (the scratch's D). Returns
    (leaf, leaf_depth, caught) [R]."""
    R = node.shape[0]
    K = R // tree.stats.shape[0]
    ridx = torch.arange(R, device=node.device)
    bidx = torch.div(ridx, K, rounding_mode="floor") if K > 1 else ridx
    max_depth = scratch.child_c.shape[1]
    caught = torch.zeros_like(active)
    while bool(active.any()):
        term = tree.is_terminal[bidx, node]
        cand, lanes, selection = _interior_level(cfg, sp, tree, bidx, node, depth, avoid_until)
        slot = (depth - 1).clamp(min=0)
        for buf, val in zip(scratch, lanes):
            if val is None:
                continue
            keep = active.reshape((R,) + (1,) * (val.dim() - 1))
            buf[ridx, slot] = torch.where(keep, val, buf[ridx, slot])

        act_c = torch.argmax(selection, dim=-1)
        child = lanes.child_c[ridx, act_c]
        flat_act = cand[ridx, act_c]  # -1 only where the lane is not active
        rec = active & ~term
        catch = rec & _want_catch(sp, lanes.ev_c[ridx, act_c], lanes.cs_raw[ridx, act_c, S_VISITS], child >= 0,
                                  _leaked(sp, leak_u, ridx, depth))
        move_on = rec & (child >= 0) & ~catch
        at = torch.where(rec, depth, max_depth)
        acts[ridx, at] = torch.where(rec, act_c, acts[:, max_depth])
        if acts_f is None:
            tree.edge_visits[bidx, node, flat_act.clamp(min=0)] += move_on.to(torch.int32)
        else:
            acts_f[ridx, at] = torch.where(rec, flat_act, acts_f[:, max_depth])
        node = torch.where(move_on, child.clamp(min=0).to(torch.int64), node)
        depth = torch.where(move_on, depth + 1, depth)
        path[ridx, torch.where(move_on, depth, 0)] = torch.where(move_on, node, path[:, 0])
        caught |= catch
        active = move_on & (depth < max_depth)
    return node, depth, caught


def _count_path_edges(tree: Tree, path, acts_f, leaf_depth, act_mask) -> None:
    """A K round's interior edge visits, in one integer scatter-add after
    its descent: row r (game r // K) passed the edge (path[r, d],
    acts_f[r, d]) for 1 <= d < leaf_depth[r], counted where `act_mask` [R].
    Integer adds give the same counts in any order."""
    B, N, A = tree.edge_visits.shape
    R, W = path.shape
    d = torch.arange(W, device=path.device)[None, :]
    game = torch.div(torch.arange(R, device=path.device), R // B, rounding_mode="floor")[:, None]
    moved = (d >= 1) & (d < leaf_depth[:, None]) & act_mask[:, None]
    flat = (game * N + path.clamp(min=0)) * A + acts_f.clamp(0, A - 1)
    tree.edge_visits.view(-1).index_add_(0, flat.reshape(-1), moved.reshape(-1).to(torch.int32))


def _descend_interior(cfg, sp: SearchParams, tree: Tree, node, depth, active, path, acts,
                      scratch: LevelScratch, avoid_until=None, leak_u=None, acts_f=None):
    """The interior descent: `_descend_interior_plain` on CPU tensors, else
    one launch of the fused CUDA kernel (`ops.descend.descend_interior`),
    which raises on anything it does not take. No fallback."""
    if tree.stats.device.type == "cpu" and node.device.type == "cpu":
        return _descend_interior_plain(cfg, sp, tree, node, depth, active, path, acts, scratch, avoid_until,
                                       leak_u, acts_f)
    cand = _cand_table_i16(cfg, node.device)
    return descend_interior(sp, cand, tree, node, depth, active, path, acts, scratch, avoid_until, leak_u, acts_f)


def _hash_lookup(tree: Tree, new_hash, expanding):
    """Graph search's transposition lookup: (found, index) [B] of the first
    allocated node whose situation hash equals `new_hash` [B, 2]."""
    N = tree.stats.shape[1]
    slot_valid = torch.arange(N, device=new_hash.device)[None, :] < tree.node_count[:, None]
    hmatch = slot_valid & (tree.sit_hash == new_hash[:, None, :]).all(-1)
    return hmatch.any(1) & expanding, hmatch.to(torch.uint8).argmax(1)


def _simulate_once(cfg, sp: SearchParams, eval_fn: EvalFn, tree: Tree, max_depth: int,
                   root_cs: torch.Tensor, scratch: LevelScratch, active: torch.Tensor | None = None,
                   avoid_until: torch.Tensor | None = None, leak_u: torch.Tensor | None = None) -> torch.Tensor:
    """One playout per game, updating `tree` in place; a game outside
    `active` [B] (default all) changes nothing. `root_cs` [B, A, 8] is the
    root's child-stats gather carried across the simulations of one search:
    only the root child this playout went through changes, so it is patched
    here (in place) and returned. `scratch` holds the interior levels' lanes
    from the descent to the backup. `avoid_until` [B, 2, A] int32: the
    player p may not play action a at depth d while avoid_until[b, p-1, a]
    > d (avoidMoveUntilByLoc). `leak_u` [B, max_depth + 1]: the playout's
    catch-up leak draws (`_leaked`), None without a leak."""
    B, N, A = tree.prior.shape
    dev = tree.stats.device
    bidx = torch.arange(B, device=dev)
    C = 4 * max(cfg.x_size, cfg.y_size)
    zero = torch.zeros((B,), dtype=torch.int64, device=dev)
    act_mask = torch.ones((B,), dtype=torch.bool, device=dev) if active is None else active

    # ---------------- Descent ----------------
    path, acts, act0, node, depth, walk, caught0 = _descend_root(sp, tree, root_cs, max_depth, active, avoid_until,
                                                                 leak_u)
    leaf, leaf_depth, caught = _descend_interior(cfg, sp, tree, node, depth, walk, path, acts, scratch,
                                                 avoid_until, leak_u=leak_u)
    caught = (caught | caught0) & act_mask
    # the stopping edge's flat action: the root's, or the recorded lane
    # mapped through the leaf's candidate table
    leaf_cand, _ = _cand_lanes(cfg, tree.states, bidx, leaf)
    flat_stop = leaf_cand[bidx, acts[bidx, leaf_depth].clamp(0, C - 1)]
    action = torch.where(leaf_depth == 0, act0, flat_stop).clamp(0, A - 1)
    # a depth-capped playout counted its last edge in the descent; it
    # expands nothing and backs up from its last node
    depth_capped = (leaf_depth >= max_depth) & act_mask
    action = torch.where(depth_capped, 0, action)
    leaf_is_terminal = tree.is_terminal[bidx, leaf]
    leaf_terminal = leaf_is_terminal & act_mask & ~depth_capped
    expanding = ~leaf_is_terminal & ~caught & ~depth_capped & act_mask

    # ---------------- Expansion ----------------
    new_states = step(cfg, tree.states.map(lambda x: x[bidx, leaf]), action)
    new_child, edge_inc, revisit = _expand(cfg, sp, tree, leaf, action, new_states, eval_fn(new_states), expanding,
                                           caught, leaf_terminal)

    # ---------------- Backup ----------------
    # Recompute the path bottom-up. A terminal/overflow revisit starts at the
    # leaf's parent; an expansion, link or catch-up starts at the stopping
    # node. Interior levels reuse the descent's saved lanes (the scratch),
    # patched with what this playout changed: the new child link, the edge
    # visits, the path child's stats.
    limit = torch.where(revisit | depth_capped, leaf_depth - 1, leaf_depth)
    for lvl in range(int(torch.where(act_mask, limit, 0).max()), 0, -1):
        n = path[:, lvl]
        on_path = (lvl <= limit) & (n >= 0) & (lvl <= leaf_depth) & act_mask
        cs_raw, prior_c, child_c, ev_c, rank_c = (x[:, lvl - 1] for x in scratch)  # views: patches land
        pa = acts[:, lvl]
        at_stop = leaf_depth == lvl
        child_c[bidx, pa] = torch.where(at_stop & (new_child >= 0), new_child, child_c[bidx, pa])
        ev_c[bidx, pa] += torch.where(
            at_stop, edge_inc.to(torch.float32), (lvl < leaf_depth).to(torch.float32)
        )
        pchild = child_c[bidx, pa]
        prow = tree.stats[bidx, pchild.clamp(min=0).to(torch.int64)]
        cs_raw[bidx, pa] = torch.where((pchild >= 0)[:, None], prow, cs_raw[bidx, pa])
        _recompute_node(sp, tree, n, on_path, cs_raw=cs_raw, lanes=(child_c, ev_c, prior_c, rank_c))

    # root level, full width, from the carried root child stats
    rchild = tree.children[bidx, 0, act0]
    rrow = tree.stats[bidx, rchild.clamp(min=0).to(torch.int64)]
    root_cs[bidx, act0] = torch.where((rchild >= 0)[:, None], rrow, root_cs[bidx, act0])
    _recompute_node(sp, tree, zero, (limit >= 0) & act_mask, cs_raw=root_cs)
    return root_cs


def _expand(cfg, sp: SearchParams, tree: Tree, leaf, action, new_states: GameState, res: EvalResult, expanding,
            caught, leaf_terminal, child_now=None):
    """One playout's expansion for each game [B], in place: where
    `expanding`, link the stopping edge (leaf, action) to the node of the
    same situation (graph search) or to `child_now` (the child a playout
    earlier in the round made there, K round), else allocate a slot for
    `new_states` with its evaluation `res`; count the stopping edge's visit
    (a new or linked edge is traversed once, a catch-up claims one,
    search.cpp:1199); and re-add a terminal leaf's value, or a leaf's when
    the tree is full (a revisit). Returns (new_child [B] int32, the linked
    child or -1; edge_inc [B] int32; revisit [B])."""
    B, N, A = tree.prior.shape
    dev = tree.stats.device
    bidx = torch.arange(B, device=dev)
    use_bias = sp.subtreeValueBiasFactor != 0.0
    if sp.useGraphSearch:
        new_hash = situation_hash(cfg, new_states)
        found, found_idx = _hash_lookup(tree, new_hash, expanding)
    else:
        found = torch.zeros_like(expanding)
        found_idx = torch.zeros((B,), dtype=torch.int64, device=dev)
    if child_now is not None:
        has_now = child_now >= 0
        found = (found | has_now) & expanding
        found_idx = torch.where(has_now, child_now.to(torch.int64), found_idx)

    new_idx = tree.node_count.clone()  # node_count is advanced in place below
    capacity_ok = new_idx < N
    do_alloc = expanding & ~found & capacity_ok
    do_link = expanding & found
    overflow = expanding & ~found & ~capacity_ok

    new_terminal = new_states.done
    term_util = _terminal_utility(new_states)
    legal = legal_mask_flat(cfg, new_states)
    new_prior = torch.where(legal, _blend_policy(res, sp.policyOptimism), -1.0)
    u_raw = torch.where(new_terminal, term_util, res.utility)
    wl_new = torch.where(new_terminal, term_util, res.wl)
    d_new = torch.where(new_terminal, (new_states.winner == 0).to(torch.float32), res.draw)
    w_new = torch.where(new_terminal, 1.0, _eval_weight(sp, res.shortterm_error))
    if use_bias:
        new_keys = _bias_keys(cfg, new_states)
        # addLeafValue: bias the initial utility toward the table entry
        u_init = u_raw + torch.where(new_terminal, 0.0, _bias_avg(sp, tree, bidx, new_keys))
    else:
        u_init = u_raw

    slot = torch.where(do_alloc, new_idx, 0)  # slot-0 writes keep the old row

    def upd(arr, val):
        m = do_alloc.reshape((B,) + (1,) * (val.dim() - 1))
        arr[bidx, slot] = torch.where(m, val.to(arr.dtype), arr[bidx, slot])

    for full, new in zip(tree.states, new_states):
        upd(full, new)
    one = torch.ones((B,), dtype=torch.float32, device=dev)
    upd(tree.stats, _stats_row(one, w_new, w_new * w_new, u_init, u_init * u_init, wl_new, d_new))
    upd(tree.self_stats, torch.stack([u_raw, wl_new, d_new, w_new], dim=-1))
    upd(tree.prior, new_prior)
    if sp.useNoisePruning:
        upd(tree.policy_rank, _policy_ranks(new_prior))
    upd(tree.parent, leaf)
    upd(tree.parent_action, action)
    upd(tree.is_terminal, new_terminal)
    if sp.useGraphSearch:
        upd(tree.sit_hash, new_hash)
    if use_bias:
        upd(tree.bias_key, new_keys)
    new_child = torch.where(do_link, found_idx, new_idx)
    linked = do_alloc | do_link
    tree.children[bidx, leaf, action] = torch.where(
        linked, new_child.to(torch.int32), tree.children[bidx, leaf, action]
    )
    tree.node_count.add_(do_alloc.to(torch.int64))
    edge_inc = (linked | caught).to(torch.int32)
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
    return torch.where(linked, new_child, -1).to(torch.int32), edge_inc, revisit


def make_round_scratch(cfg: GameConfig, batch: int, threads: int, max_depth: int, device) -> LevelScratch:
    """Scratch of a K round (JAX `make_round_scratch`, :1645): the
    LevelScratch of its B * K rows, row b * K + k for playout k of game b."""
    return make_level_scratch(cfg, batch * threads, max_depth, device)


def _simulate_round(cfg, sp: SearchParams, eval_fn: EvalFn, tree: Tree, max_depth: int, K: int,
                    root_cs: torch.Tensor, scratch: LevelScratch, active: torch.Tensor | None = None,
                    avoid_until: torch.Tensor | None = None, leak_u: torch.Tensor | None = None) -> torch.Tensor:
    """K playouts per game in one round (numSearchThreads = K; JAX
    `_simulate_round`, :1653-2199), updating `tree` in place. Slot k of game
    b is row b * K + k; `active` [B, K] masks slots (default all), `scratch`
    is a `make_round_scratch`, `leak_u` [B * K, max_depth + 1] the round's
    leak draws, `root_cs` as in `_simulate_once` (patched and returned).

    The root selections run in playout order over the in-flight root edge
    visits, each earlier claim adding a virtual loss (weight 1 at
    -winLossUtilityFactor; the forced-playout test sees the weights without
    them). Below the root the B * K rows descend in one interior descent
    with no sight of each other's edge visits, which are counted after it
    (the DAG is graded, so rows meet only at one level). One evaluation
    serves the B * K leaves; the expansions then run in playout order, a
    later playout linking to a child an earlier one made. The union backup
    recomputes each distinct path node once a level, the first playout at
    it counting every playout that passed it, from its saved lanes patched
    with fresh reads of every lane some playout changed there; then the
    root once, with the count of the round's playouts."""
    B, N, A = tree.prior.shape
    BK = B * K
    dev = tree.stats.device
    bidx = torch.arange(B, device=dev)
    bidx2 = bidx.repeat_interleave(K)  # the game of each row
    zero = torch.zeros((B,), dtype=torch.int64, device=dev)
    act_mask = torch.ones((B, K), dtype=torch.bool, device=dev) if active is None else active
    am_flat = act_mask.reshape(BK)
    D = max_depth

    # ---------------- Root level: K selections in order ----------------
    root_term = tree.is_terminal[:, 0]
    ev_root = tree.edge_visits[:, 0].clone()  # with this round's in-flight visits
    forbid0 = None
    if avoid_until is not None:
        pidx0 = (tree.states.to_move[:, 0].to(torch.int64) - 1).clamp(0, 1)
        forbid0 = avoid_until[bidx, pidx0] > 0
    claimed = torch.zeros((B, A), dtype=torch.float32, device=dev)
    ones_b = torch.ones((B,), dtype=torch.bool, device=dev)
    act0, node1, move_on0, catch0 = [], [], [], []
    for k in range(K):
        cs0 = _edge_stats_from_raw(tree, bidx, zero, root_cs, evis_row=ev_root)
        if k > 0:
            # virtual losses on the edges earlier playouts of the round claimed
            w0, q0 = cs0["w"], cs0["u"]
            wv = w0 + claimed
            qv = torch.where(claimed > 0, (w0 * q0 - claimed * sp.winLossUtilityFactor) / wv.clamp(min=_EPS), q0)
            cs0 = dict(cs0, w=wv, u=qv, live=cs0["live"] | (claimed > 0), force_w=w0)
        a0 = _select_action(sp, tree, zero, ones_b, cs=cs0, forbid=forbid0)
        child0 = tree.children[bidx, 0, a0].to(torch.int64)
        has0 = child0 >= 0
        wc0 = _want_catch(sp, ev_root[bidx, a0].to(torch.float32), tree.stats[bidx, child0.clamp(min=0), S_VISITS],
                          has0, _leaked(sp, leak_u, bidx * K + k, 0))
        mo0 = ~(root_term | wc0 | ~has0)
        ev_root[bidx, a0] += (mo0 & act_mask[:, k]).to(torch.int32)
        claimed[bidx, a0] += act_mask[:, k].to(torch.float32)
        act0.append(a0)
        node1.append(torch.where(mo0, child0.clamp(min=0), 0))
        move_on0.append(mo0)
        catch0.append(wc0 & ~root_term)
    act0, node1, move_on0, catch0 = (torch.stack(x, dim=1).reshape(BK) for x in (act0, node1, move_on0, catch0))
    tree.edge_visits[:, 0] = ev_root

    # ---------------- Interior levels: the B * K rows at once ----------------
    path = torch.full((BK, D + 1), -1, dtype=torch.int64, device=dev)
    path[:, 0] = 0
    path[:, 1] = torch.where(move_on0, node1, -1)
    acts = torch.zeros((BK, D + 1), dtype=torch.int64, device=dev)
    acts_f = torch.zeros((BK, D + 1), dtype=torch.int64, device=dev)
    acts_f[:, 0] = act0
    leaf_f, leaf_depth_f, caught_f = _descend_interior(
        cfg, sp, tree, node1, move_on0.to(torch.int64), move_on0 & (1 < D), path, acts, scratch, avoid_until,
        leak_u=leak_u, acts_f=acts_f)
    _count_path_edges(tree, path, acts_f, leaf_depth_f, am_flat)
    leaf = leaf_f.reshape(B, K)
    leaf_depth = leaf_depth_f.reshape(B, K)
    action = acts_f[torch.arange(BK, device=dev), leaf_depth_f].clamp(0, A - 1).reshape(B, K)
    caught = (caught_f | catch0).reshape(B, K) & act_mask
    leaf_terminal = tree.is_terminal[bidx[:, None], leaf] & act_mask

    # ---------------- One evaluation, then the expansions in order ----------------
    new_states = step(cfg, tree.states.map(lambda x: x[bidx2, leaf_f]), action.reshape(BK))
    res = eval_fn(new_states)

    def slice_k(x, k):
        return x.reshape((B, K) + x.shape[1:])[:, k]

    new_child, edge_inc, revisit = [], [], []
    for k in range(K):
        leaf_k, action_k = leaf[:, k], action[:, k]
        expanding = ~tree.is_terminal[bidx, leaf_k] & ~caught[:, k] & act_mask[:, k]
        out = _expand(cfg, sp, tree, leaf_k, action_k, new_states.map(lambda x: slice_k(x, k)),
                      EvalResult(*(None if x is None else slice_k(x, k) for x in res)), expanding, caught[:, k],
                      leaf_terminal[:, k], child_now=tree.children[bidx, leaf_k, action_k])
        for acc, x in zip((new_child, edge_inc, revisit), out):
            acc.append(x)
    revisit = torch.stack(revisit, dim=1)

    # ---------------- Union backup ----------------
    limit = torch.where(revisit, leaf_depth - 1, leaf_depth)
    limit_f = limit.reshape(BK)
    C = scratch.child_c.shape[2]
    for lvl in range(int(torch.where(act_mask, limit, 0).max()), 0, -1):
        nodes_f = path[:, lvl]
        on_path = ((lvl <= limit_f) & (nodes_f >= 0) & (lvl <= leaf_depth_f) & am_flat).reshape(B, K)
        nodes = nodes_f.reshape(B, K)
        cs_raw, prior_c, child_c, ev_c, rank_c = (x[:, lvl - 1] for x in scratch)  # views: patches land
        cs3, child3, ev3 = cs_raw.view(B, K, C, NUM_STATS), child_c.view(B, K, C), ev_c.view(B, K, C)
        pa_c = acts[:, lvl].reshape(B, K)
        pa_f = acts_f[:, lvl].clamp(0, A - 1).reshape(B, K)
        # same[b, k, j]: playout j passed row k's node at this level
        same = on_path[:, None, :] & (nodes[:, :, None] == nodes[:, None, :])
        # every lane some playout changed at row k's node, read afresh; the
        # playouts that changed one lane took one action, so any of them
        # (the first) gives its fresh reads
        n_j = nodes.clamp(min=0)
        fresh_child = tree.children[bidx[:, None], n_j, pa_f]  # [B, K] at each j's node and action
        fresh_ev = tree.edge_visits[bidx[:, None], n_j, pa_f].to(torch.float32)
        hit = same[..., None] & (pa_c[:, None, :, None] == torch.arange(C, device=dev))  # [B, k, j, C]
        j_at = hit.to(torch.int8).argmax(2)  # [B, k, C]
        patched = hit.any(2)
        child_at = torch.gather(fresh_child[:, None, :].expand(B, K, K), 2, j_at)
        child3.copy_(torch.where(patched, child_at, child3))
        ev3.copy_(torch.where(patched, torch.gather(fresh_ev[:, None, :].expand(B, K, K), 2, j_at), ev3))
        prow = tree.stats[bidx[:, None, None], child_at.clamp(min=0).to(torch.int64)]
        cs3.copy_(torch.where((patched & (child_at >= 0))[..., None], prow, cs3))
        # the first playout at a node recomputes it, counting all that passed
        first = on_path & ~(same & torch.ones((K, K), dtype=torch.bool, device=dev).tril(-1)).any(-1)
        cnt = same.sum(-1).to(torch.float32)
        # the other rows name the root, whose row they write back unchanged
        node_w = torch.where(first, nodes, 0).reshape(BK)
        _recompute_node(sp, tree, node_w, first.reshape(BK), cs_raw=cs_raw, lanes=(child_c, ev_c, prior_c, rank_c),
                        visit_inc=cnt.reshape(BK), bidx=bidx2)

    # root level, full width, once, with the round's count
    root_on = (limit >= 0) & act_mask
    for k in range(K):
        a0 = act0.reshape(B, K)[:, k]
        rchild = tree.children[bidx, 0, a0]
        rrow = tree.stats[bidx, rchild.clamp(min=0).to(torch.int64)]
        root_cs[bidx, a0] = torch.where((root_on[:, k] & (rchild >= 0))[:, None], rrow, root_cs[bidx, a0])
    _recompute_node(sp, tree, zero, root_on.any(-1), cs_raw=root_cs, visit_inc=root_on.sum(-1).to(torch.float32))
    return root_cs


def _norm_cdf(z):
    return 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))


def _recompute_node(sp: SearchParams, tree: Tree, node, mask, cs_raw=None, lanes=None, visit_inc=1.0,
                    bidx=None) -> None:
    """recomputeNodeStats for nodes [R] where `mask` (searchupdatehelpers.cpp:
    152-337): aggregate the child edges with noise pruning, the root-noise
    weight subtraction and value-based downweighting, update the subtree
    value bias entry, and add the node's (biased) own eval; one row write
    per node, its visits raised by `visit_inc` (a float or [R]: the
    playouts that passed the node). `cs_raw` [R, A', 8] supplies the
    children's raw stat rows; `lanes` = (child_row, evis_row, prior_row,
    rank_row) supplies compact [R, C] lane views for interior nodes, which
    are never the root. `bidx` [R] maps the rows to their games (default
    one row a game); rows of one game are then K contiguous rows, at most
    one of them masked in at a node, and the rows masked out must name the
    root (their writes put its row back unchanged). Their bias-table adds,
    which may share an entry, are summed in row order (JAX's scatter-add)
    and written once a row, each row of an entry writing the same sum."""
    R = node.shape[0]
    rows_per_game = 1 if bidx is None else R // tree.stats.shape[0]
    if bidx is None:
        bidx = torch.arange(R, device=node.device)
    if cs_raw is None:
        cs_raw = _gather_child_stats(tree, bidx, node)
    child_row, evis_row, prior_row, rank_row = (None,) * 4 if lanes is None else lanes
    cs = _edge_stats_from_raw(tree, bidx, node, cs_raw, child_row=child_row, evis_row=evis_row)
    cw, cu, cwl, cdraw, cusq, cwsq = cs["w"], cs["u"], cs["wl"], cs["draw"], cs["usq"], cs["wsq"]

    cw_used = cw
    if sp.useNoisePruning:
        # pruneNoiseWeight, the JAX package's vectorized form (mcts.py:2243-
        # 2271): exclusive prefix sums in policy-descending order, as masked
        # sums over the predecessors of each action (rank[a'] < rank[a]);
        # the ranks of a compact lane subset keep their order
        raw_prior = (tree.prior[bidx, node] if lanes is None else prior_row).clamp(min=1e-30)
        rank = tree.policy_rank[bidx, node] if lanes is None else rank_row
        before = rank[:, :, None] < rank[:, None, :]  # [B, A', A]: a' precedes a

        def prefix(x):
            return torch.where(before, x[:, :, None], 0.0).sum(1)

        cum_w, cum_uw, cum_p = prefix(cw), prefix(cw * cu), prefix(raw_prior)
        gap = cum_uw / cum_w.clamp(min=_EPS) - cu
        share = cum_w * raw_prior / cum_p.clamp(min=1e-30)
        excess = (cw - 2.0 * share).clamp(min=0.0)
        sub = torch.where((gap > 0) & (cum_w > 0),
                          excess * (1.0 - torch.exp(-gap / sp.noisePruneUtilityScale)), 0.0)
        if sp.noisePruningCap < 1e30:
            sub = sub.clamp(max=sp.noisePruningCap)
        cw_used = cw - sub
    elif lanes is None and sp.rootNoiseEnabled and (sp.chosenMoveSubtract > 0 or sp.chosenMovePrune > 0):
        # root noise subtraction without noise pruning (searchupdatehelpers.cpp:199-209)
        max_w = cw.amax(-1)
        subtract = (max_w / 64.0).clamp(max=sp.chosenMoveSubtract)
        prune = (max_w / 64.0).clamp(max=sp.chosenMovePrune)
        w_adj0 = (cw - subtract[:, None]).clamp(min=0.0)
        w_adj0 = torch.where(cw < prune[:, None], 0.0, w_adj0)
        cw_used = torch.where((node == 0)[:, None], w_adj0, cw)
    total_w = cw_used.sum(-1)

    if sp.valueWeightExponent > 0:
        # downweightBadChildrenAndNormalizeWeight (searchupdatehelpers.cpp:368+)
        simple_value = torch.where(
            total_w > 0, (cu * cw_used).sum(-1) / total_w.clamp(min=_EPS), 0.0
        )
        precision = 1.5 * torch.sqrt(cw_used.clamp(min=_EPS))
        stdev = torch.sqrt(1e-8 + 1.0 / precision)
        z = (cu - simple_value[:, None]) / stdev
        p = _norm_cdf(z) + 1e-4
        w_adj = cw_used * torch.pow(p, sp.valueWeightExponent)
        w_adj_sum = w_adj.sum(-1)
        factor = torch.where(w_adj_sum > 0, total_w / w_adj_sum.clamp(min=_EPS), 0.0)
        w_adj = w_adj * factor[:, None]
    else:
        w_adj = cw_used

    scaling = torch.where(cw > 0, w_adj / cw.clamp(min=_EPS), 0.0)
    selfs = tree.self_stats[bidx, node]
    self_w = selfs[:, F_W]
    self_u = selfs[:, F_U]
    child_w_total = w_adj.sum(-1)
    util_children_sum = (w_adj * cu).sum(-1)

    if sp.subtreeValueBiasFactor != 0.0:
        # subtree value bias (searchupdatehelpers.cpp:254-285): the table
        # entry holds this node's last contribution differentially
        orig_total = cw.sum(-1)
        key = tree.bias_key[bidx, node]
        util_children = util_children_sum / child_w_total.clamp(min=_EPS)
        w_b = torch.pow(orig_total.clamp(min=0.0), sp.subtreeValueBiasWeightExponent)
        delta = (util_children - self_u) * w_b
        do_upd = mask & (orig_total > 1e-10)
        last_d = tree.last_bias_delta[bidx, node]
        last_w = tree.last_bias_weight[bidx, node]
        add = torch.stack([torch.where(do_upd, delta - last_d, 0.0), torch.where(do_upd, w_b - last_w, 0.0)], dim=-1)
        if rows_per_game == 1:
            tree.bias_table[bidx, key] += add
        else:
            K = rows_per_game
            keys, adds = key.reshape(-1, K), add.reshape(-1, K, 2)
            total = tree.bias_table[bidx, key]
            for j in range(K):
                same = (keys[:, j, None] == keys).reshape(R)
                total = total + torch.where(same[:, None], adds[:, j].repeat_interleave(K, dim=0), 0.0)
            tree.bias_table[bidx, key] = total
        tree.last_bias_delta[bidx, node] = torch.where(do_upd, delta, last_d)
        tree.last_bias_weight[bidx, node] = torch.where(do_upd, w_b, last_w)
        self_u = self_u + torch.where(tree.is_terminal[bidx, node], 0.0, _bias_avg(sp, tree, bidx, key))

    weight_sum = child_w_total + self_w
    inv = 1.0 / weight_sum.clamp(min=_EPS)
    old_row = tree.stats[bidx, node]
    new_row = _stats_row(
        old_row[:, S_VISITS] + visit_inc,
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


def _max_depth(cfg: GameConfig, sp: SearchParams) -> int:
    """The descent depth bound: area + 1, cut by maxPlayoutDepthProp under
    graph search (a truncated playout claims its last edge visit, the
    catch-up bookkeeping)."""
    max_depth = cfg.area + 1
    if sp.useGraphSearch and sp.maxPlayoutDepthProp < 1.0:
        max_depth = max(2, min(max_depth, int(round(max_depth * sp.maxPlayoutDepthProp))))
    return max_depth


def _root_child_stats_raw(tree: Tree) -> torch.Tensor:
    B = tree.stats.shape[0]
    dev = tree.stats.device
    return _gather_child_stats(
        tree, torch.arange(B, device=dev), torch.zeros((B,), dtype=torch.int64, device=dev)
    )


def _threads(sp: SearchParams) -> int:
    return max(1, int(sp.numSearchThreads))


def _round_runner(cfg, sp: SearchParams, eval_fn: EvalFn, tree: Tree, avoid_until=None, leak=None):
    """A function that runs one round of every game, `_simulate_once` or
    `_simulate_round` with numSearchThreads = K > 1, on an active mask
    ([B], or [B, K] slots; None for all). Its rounds share one root gather
    and one scratch, made here. `leak` is a `_leak_source`."""
    B = tree.stats.shape[0]
    dev = tree.stats.device
    K = _threads(sp)
    max_depth = _max_depth(cfg, sp)
    root_cs = _root_child_stats_raw(tree)
    scratch = make_round_scratch(cfg, B, K, max_depth, dev)

    def one_round(active):
        leak_u = None if leak is None else leak(B * K, max_depth + 1, dev)
        if K == 1:
            _simulate_once(cfg, sp, eval_fn, tree, max_depth, root_cs, scratch, active, avoid_until, leak_u)
        else:
            _simulate_round(cfg, sp, eval_fn, tree, max_depth, K, root_cs, scratch, active, avoid_until, leak_u)

    return one_round


def _run_to_target(cfg, sp: SearchParams, eval_fn: EvalFn, tree: Tree, target, max_rounds: int,
                   avoid_until=None, leak=None) -> int:
    """Rounds until every root has `target` visits (a float or [B]), at
    most `max_rounds`; a game at its target changes nothing, and in a K
    round a game gets only as many playout slots as it lacks visits. Returns
    the rounds run. A round adds at most K visits to a root, so the rounds
    that the largest deficit needs are run before the host reads the visits
    again."""
    K = _threads(sp)
    one_round = _round_runner(cfg, sp, eval_fn, tree, avoid_until, leak)
    slots = torch.arange(K, device=tree.stats.device)[None, :]
    rounds = 0
    while rounds < max_rounds:
        need = math.ceil(float((target - tree.stats[:, 0, S_VISITS]).max()))
        if need <= 0:
            break
        for _ in range(min(-(-need // K), max_rounds - rounds)):
            deficit = target - tree.stats[:, 0, S_VISITS]
            one_round(deficit > 0 if K == 1 else slots < deficit[:, None])
            rounds += 1
    return rounds


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
    generator: torch.Generator | None = None,
    draws: RootDraws | None = None,
    draw_leak: Callable[[int, int], torch.Tensor] | None = None,
    reuse_tree: Tree | None = None,
    reuse_actions: torch.Tensor | None = None,
    reuse_ok: torch.Tensor | None = None,
    root_hint: torch.Tensor | None = None,
    root_avoid: torch.Tensor | None = None,
    avoid_until: torch.Tensor | None = None,
    with_diag: bool = False,
):
    """runWholeSearch (search.cpp:361-509) on `device` (default `cuda`; the
    root states are moved there). The evaluator must run on the same device.

    Without `reuse_tree`: exactly `num_sims` playouts per game (the root
    ends at num_sims + 1 visits), in ceil(num_sims / K) rounds of K =
    numSearchThreads playouts (the last round's slots past num_sims idle).
    With `reuse_tree` (the previous move's tree), `reuse_actions` [B] (the
    move each game played) and `reuse_ok` [B] (False where reuse is invalid,
    such as a reset game): the tree is re-rooted at the played child
    (`advance_root`) and rounds run until every root has num_sims + 1
    visits, at most `num_sims` of them.

    `root_hint` [B] is each game's rootHintLoc action (-1 none); `root_avoid`
    [B, A] bool masks root moves (avoidMoves/allowMoves; a mask that leaves
    a game no legal move is ignored); `avoid_until` [B, 2, A] int32 gates the
    descent: player p may not take action a at depth d while
    avoid_until[b, p-1, a] > d (avoidMoveUntilByLoc). The random draws come
    from `draws` (the root's) and `draw_leak(rows, cols)` (each playout's or
    round's catch-up leak, [rows, cols] uniform) where given, else from
    `generator`, a torch.Generator on `device`; a search that needs one and
    has neither raises. numSearchThreads > 1 with maxPlayoutDepthProp < 1
    under graph search raises NotImplementedError, as in the JAX package.
    With `with_diag` it also returns {"rounds": rounds run, "start_visits":
    [B] root visits before them}."""
    K = _threads(sp)
    if K > 1 and sp.useGraphSearch and sp.maxPlayoutDepthProp < 1.0:
        raise NotImplementedError("maxPlayoutDepthProp < 1 requires numSearchThreads == 1")
    leak = _leak_source(sp, generator, draw_leak)
    dev = resolve_device(device)
    root_states = root_states.map(lambda x: x.to(dev))
    if root_hint is not None:
        root_hint = root_hint.to(device=dev, dtype=torch.int64)
    if avoid_until is not None:
        avoid_until = avoid_until.to(device=dev, dtype=torch.int32)
    if reuse_tree is None:
        if max_nodes is None:
            max_nodes = num_sims + 2
        tree = init_tree(cfg, sp, eval_fn, root_states, max_nodes, generator=generator, draws=draws,
                         root_hint=root_hint, root_avoid=root_avoid)
        B = tree.stats.shape[0]
        rounds = -(-num_sims // K)
        one_round = _round_runner(cfg, sp, eval_fn, tree, avoid_until, leak)
        slots = torch.arange(K, device=dev)[None, :].expand(B, K)
        for r in range(rounds):
            # the last round hands out only the rest of the budget
            one_round(None if K == 1 else r * K + slots < num_sims)
        start_visits = torch.ones((B,), dtype=torch.float32, device=dev)
    else:
        if reuse_actions is None:
            raise ValueError("katacoffee_tpu_torch search: reuse_tree needs reuse_actions")
        tree = advance_root(cfg, sp, eval_fn, reuse_tree, reuse_actions.to(dev), root_states,
                            generator=generator, draws=draws,
                            reuse_ok=None if reuse_ok is None else reuse_ok.to(dev), root_hint=root_hint,
                            root_avoid=root_avoid)
        start_visits = tree.stats[:, 0, S_VISITS].clone()
        rounds = _run_to_target(cfg, sp, eval_fn, tree, float(num_sims + 1), num_sims, avoid_until, leak)
    if with_diag:
        return tree, {"rounds": rounds, "start_visits": start_visits}
    return tree


@torch.no_grad()
def continue_search(cfg: GameConfig, sp: SearchParams, eval_fn: EvalFn, tree: Tree, max_more_sims: int,
                    target_visits, avoid_until: torch.Tensor | None = None, *,
                    generator: torch.Generator | None = None,
                    draw_leak: Callable[[int, int], torch.Tensor] | None = None) -> Tree:
    """Continue a search at the same root until each game's root has
    `target_visits` visits (a float or [B]), at most `max_more_sims` more
    rounds (playouts, with numSearchThreads = 1): the interruptible half of
    the search loop. The tree must have the node capacity for the final
    target. `avoid_until` [B, 2, A], `generator` and `draw_leak` as in
    `run_search`. Updates `tree` in place and returns it."""
    leak = _leak_source(sp, generator, draw_leak)
    dev = tree.stats.device
    target = torch.as_tensor(target_visits, dtype=torch.float32, device=dev)
    if avoid_until is not None:
        avoid_until = avoid_until.to(device=dev, dtype=torch.int32)
    _run_to_target(cfg, sp, eval_fn, tree, target, max_more_sims, avoid_until, leak)
    return tree


@torch.no_grad()
def advance_root(cfg: GameConfig, sp: SearchParams, eval_fn: EvalFn, tree: Tree, actions: torch.Tensor,
                 root_states: GameState, *, generator: torch.Generator | None = None,
                 draws: RootDraws | None = None, reuse_ok: torch.Tensor | None = None,
                 turn_number: torch.Tensor | None = None, root_hint: torch.Tensor | None = None,
                 root_avoid: torch.Tensor | None = None) -> Tree:
    """Re-root each game's tree at the child reached by `actions` [B], the
    reference's beginSearch tree reuse (search.cpp:262-331), as a compaction:
    the nodes reachable from the new root along first-parent chains, within
    the JAX package's fixed number of chain steps, move to the front with
    the new root at slot 0; the rest are freed and give back freeProp of
    their subtree-value-bias contribution (search.cpp:773-786). Games whose
    played child does not exist, or where `reuse_ok` [B] is False, get a
    fresh root from a batched evaluation of `root_states`. Both root priors
    are re-tempered and re-noised, as beginSearch does (`draws.gamma` for
    the fresh one, `draws.gamma_reused` for the reused one), and `root_avoid`
    [B, A] masks both (`_make_root_prior`). Index gathers
    replace the JAX package's one-hot matmuls; the payloads are integers or
    exact copies, so the result is the same. Returns a new Tree."""
    B, N = tree.stats.shape[:2]
    dev = tree.stats.device
    bidx = torch.arange(B, device=dev)
    nidx = torch.arange(N, device=dev)
    draws = RootDraws() if draws is None else draws
    res = _root_eval(cfg, sp, eval_fn, root_states, generator, draws.syms)
    fresh = _tree_from_root_eval(cfg, sp, root_states, res, N, generator=generator, gamma=draws.gamma,
                                 turn_number=turn_number, root_hint=root_hint, root_avoid=root_avoid)

    new_root = tree.children[bidx, 0, actions.to(torch.int64)].to(torch.int64)
    has = new_root >= 0
    if reuse_ok is not None:
        has = has & reuse_ok
    new_root_safe = new_root.clamp(min=0)

    # reachability from the new root: step i looks (i + 1) parents up from
    # every node, as the JAX package's loop does (it covers chains of up to
    # 15 steps at 5x5)
    valid_slot = nidx[None, :] < tree.node_count[:, None]
    reach = nidx[None, :] == new_root_safe[:, None]
    ptr = tree.parent
    for _ in range(max(1, int(cfg.area + 1).bit_length())):
        ptr_safe = ptr.clamp(min=0)
        reach = reach | ((ptr >= 0) & reach.gather(1, ptr_safe))
        ptr = torch.where(ptr >= 0, tree.parent.gather(1, ptr_safe), -1)
    kept = reach & valid_slot

    # stable permutation: the new root first, then the other kept nodes
    key = torch.where(nidx[None, :] == new_root_safe[:, None], 0, torch.where(kept, 1, 2))
    order = torch.argsort(key, dim=1, stable=True)  # [B, N] old index of each new slot
    inv = torch.empty_like(order).scatter_(1, order, nidx[None, :].expand(B, N).contiguous())
    live = nidx[None, :] < kept.sum(1)[:, None]

    def g(x):
        return x[bidx[:, None], order]

    ch_g = g(tree.children).to(torch.int64)
    ch_vals = ch_g.clamp(min=0)
    child_kept = (ch_g >= 0) & kept[bidx[:, None, None], ch_vals]
    ch_new = torch.where(child_kept & live[:, :, None], inv[bidx[:, None, None], ch_vals], -1)
    par_g = g(tree.parent)
    par_vals = par_g.clamp(min=0)
    par_new = torch.where((par_g >= 0) & kept[bidx[:, None], par_vals] & live, inv[bidx[:, None], par_vals], -1)
    par_new[:, 0] = -1  # the new root has no parent

    table = tree.bias_table
    last_bd, last_bw = tree.last_bias_delta, tree.last_bias_weight
    if sp.subtreeValueBiasFactor != 0.0:
        # freed nodes give back freeProp of their last table contribution
        dropped = valid_slot & ~kept
        fp = sp.subtreeValueBiasFreeProp
        table = table.index_put(
            (bidx[:, None].expand(B, N), tree.bias_key),
            torch.stack([torch.where(dropped, -fp * last_bd, 0.0), torch.where(dropped, -fp * last_bw, 0.0)],
                        dim=-1),
            accumulate=True,
        )
        last_bd = torch.where(live, g(last_bd), 0.0)
        last_bw = torch.where(live, g(last_bw), 0.0)

    # the reused root's prior comes afresh from `res`, the new root's
    # evaluation; its self_stats keep the original leaf eval
    reused_prior = g(tree.prior)
    reused_prior[:, 0] = fresh.prior[:, 0]
    reused_raw = fresh.prior[:, 0]
    reused_root_prior = _make_root_prior(cfg, sp, reused_raw.clamp(min=0.0), reused_raw >= 0, root_states,
                                         generator, draws.gamma_reused, turn_number, root_hint, root_avoid)
    reused_rank = tree.policy_rank
    if sp.useNoisePruning:
        # the reused root's ranks come afresh from `res`, as its prior does
        reused_rank = g(tree.policy_rank)
        reused_rank[:, 0] = fresh.policy_rank[:, 0]
    reused = Tree(
        states=tree.states.map(g),
        stats=torch.where(live[:, :, None], g(tree.stats), 0.0),
        self_stats=torch.where(live[:, :, None], g(tree.self_stats), 0.0),
        prior=reused_prior,
        root_prior=reused_root_prior,
        children=ch_new.to(torch.int32),
        edge_visits=torch.where(ch_new >= 0, g(tree.edge_visits), 0),
        parent=par_new,
        parent_action=g(tree.parent_action),
        is_terminal=live & g(tree.is_terminal),
        node_count=kept.sum(1),
        sit_hash=g(tree.sit_hash),
        policy_rank=reused_rank,
        bias_key=g(tree.bias_key) if sp.subtreeValueBiasFactor != 0.0 else tree.bias_key,
        last_bias_delta=last_bd,
        last_bias_weight=last_bw,
        bias_table=table,
        root_hint=fresh.root_hint,
    )

    def merge(r, f):
        return torch.where(has.reshape((B,) + (1,) * (r.dim() - 1)), r, f)

    return Tree(
        states=GameState(*(merge(r, f) for r, f in zip(reused.states, fresh.states))),
        **{name: merge(getattr(reused, name), getattr(fresh, name)) for name in Tree._fields if name != "states"},
    )


# ---------------------------------------------------------------------------
# Results (searchresults.cpp)
# ---------------------------------------------------------------------------


def host_tree(tree: Tree, lane: int | None = None) -> dict:
    """The tree's arrays as numpy under the JAX Tree's view names, one copy
    a field: every game ([B, N, ...]), or game `lane`'s alone ([N, ...])."""
    pick = (lambda x: x) if lane is None else (lambda x: x[lane])
    stats = pick(tree.stats).cpu()
    return {
        "children": pick(tree.children).cpu().numpy(),
        "edge_visits": pick(tree.edge_visits).cpu().numpy(),
        "visits": (stats[..., S_VISITS] + 0.5).to(torch.int32).numpy(),
        "weight_sum": stats[..., S_W].numpy(),
        "weight_sq_sum": stats[..., S_WSQ].numpy(),
        "utility_avg": stats[..., S_U].numpy(),
        "utility_sq_avg": stats[..., S_USQ].numpy(),
        "wl_avg": stats[..., S_WL].numpy(),
        "draw_avg": stats[..., S_DRAW].numpy(),
        "self_weight": pick(tree.self_stats)[..., F_W].cpu().numpy(),
        "is_terminal": pick(tree.is_terminal).cpu().numpy(),
        "prior": pick(tree.prior).cpu().numpy(),
        "root_prior": pick(tree.root_prior).cpu().numpy(),
    }


def _root_child_stats(tree: Tree) -> dict:
    B = tree.children.shape[0]
    dev = tree.children.device
    return _child_edge_stats(
        tree, torch.arange(B, device=dev), torch.zeros((B,), dtype=torch.int64, device=dev)
    )


def root_visit_counts(tree: Tree) -> torch.Tensor:
    """[B, A] root edge-visit counts."""
    return tree.edge_visits[:, 0, :]


def root_child_weights(tree: Tree) -> torch.Tensor:
    """[B, A] edge-scaled child weights at the root."""
    return _root_child_stats(tree)["w"]


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


def _child_utility_stdev(tree: Tree, cs: dict | None = None):
    """Per-root-child utility, its stdev for LCB (weight-based precision) and
    weight, [B, A] each; missing children get utility -1e30 and stdev
    1e30."""
    if cs is None:
        cs = _root_child_stats(tree)
    u = cs["u"]
    var = (cs["usq"] - u * u).clamp(min=1e-8)
    ess = torch.where(cs["wsq"] > 0, cs["w"] * cs["w"] / cs["wsq"].clamp(min=_EPS), 1.0)
    stdev = torch.sqrt(var / ess.clamp(min=1.0))
    return torch.where(cs["live"], u, -1e30), torch.where(cs["live"], stdev, 1e30), cs["w"]


@torch.no_grad()
def select_moves(cfg: GameConfig, sp: SearchParams, tree: Tree, generator: torch.Generator | None = None,
                 gumbel: torch.Tensor | None = None, turn_number: torch.Tensor | None = None) -> torch.Tensor:
    """getChosenMoveLoc (searchresults.cpp): the move of each game [B] from
    its play-selection weights, with the LCB boost (useLcbForSelection) and
    the chosenMove* temperature decaying with the turn number. Sampling is
    argmax(logits + Gumbel noise), as jax.random.categorical computes it;
    the noise [B, A] is `gumbel`, else drawn from `generator`. A near-zero
    temperature takes the greedy move; a game with no weighted child takes
    the highest root prior."""
    legal = tree.root_prior >= 0
    v, logits, temp = chosen_move_logits(cfg, sp, tree, turn_number)
    if gumbel is None:
        g = _need_generator(generator, "select_moves")
        gumbel = -torch.log(torch.empty(v.shape, device=v.device).exponential_(generator=g))
    sampled = torch.argmax(logits + gumbel.to(v.device), dim=-1)
    choice = torch.where(temp <= 1e-3, torch.argmax(v, dim=-1), sampled)
    fallback = torch.argmax(torch.where(legal, tree.root_prior, -math.inf), dim=-1)
    return torch.where((v > 0).any(-1), choice, fallback)


@torch.no_grad()
def chosen_move_logits(cfg: GameConfig, sp: SearchParams, tree: Tree, turn_number: torch.Tensor | None = None):
    """What `select_moves` samples from: (v [B, A] the pruned play-selection
    values, logits [B, A] = log(v) / temperature, -inf where v is 0, and the
    temperature [B])."""
    A = tree.children.shape[-1]
    legal = tree.root_prior >= 0
    cs = _root_child_stats(tree)
    w_sel = root_play_selection_weights(sp, tree, cs)
    if sp.useLcbForSelection:
        # the weight blend of getPlaySelectionValues (searchresults.cpp:188-233):
        # the best-LCB eligible child's weight is raised to
        # max_i ((radius_i + excess_i) / (radius_i + 0.2 excess_i))^2 w_i
        u, stdev, _ = _child_utility_stdev(tree, cs)
        w = w_sel
        radius = sp.lcbStdevs * stdev
        lcb = u - radius
        eligible = (w > 0) & (w >= sp.minVisitPropForLCB * w.amax(-1, keepdim=True))
        lcb_elig = torch.where(eligible, lcb, -math.inf)
        best_idx = torch.argmax(lcb_elig, dim=-1)
        excess = lcb_elig.amax(-1, keepdim=True) - lcb
        rf = (radius + excess) / (radius + 0.2 * excess).clamp(min=_EPS)
        onehot_best = torch.nn.functional.one_hot(best_idx, A).to(torch.bool)
        lbound = torch.where((excess >= 0) & ~onehot_best & (w > 0), rf * rf * w, 0.0)
        boosted = torch.maximum(w.gather(1, best_idx[:, None]), lbound.amax(-1, keepdim=True))
        w_sel = torch.where(onehot_best & eligible.any(-1)[:, None], boosted, w)

    if turn_number is None:
        turn_number = tree.states.num_turns[:, 0]
    frac = 0.5 ** (turn_number.to(torch.float32) / sp.chosenMoveTemperatureHalflife)
    temp = sp.chosenMoveTemperature + frac * (sp.chosenMoveTemperatureEarly - sp.chosenMoveTemperature)
    temp = temp.clamp(min=1e-4)

    v = (w_sel - sp.chosenMoveSubtract).clamp(min=0.0)
    v = torch.where(w_sel < sp.chosenMovePrune, 0.0, v)
    v = torch.where(legal, v, 0.0)
    logits = torch.where(v > 0, torch.log(v.clamp(min=1e-30)) / temp[:, None], -math.inf)
    return v, logits, temp


@torch.no_grad()
def policy_target(tree: Tree, sp: SearchParams) -> torch.Tensor:
    """Training policy target (extractPolicyTarget, play.cpp:635): the root
    play-selection weights, normalized, whose over-visited reduction removes
    the weight that forced playouts and root noise drove into non-best
    children."""
    v = root_play_selection_weights(sp, tree)
    total = v.sum(-1, keepdim=True)
    return torch.where(total > 0, v / total.clamp(min=_EPS), 0.0)
