"""Tree-position recording: extra training rows from interior search-tree
nodes (KataGo's `recordTreePositions`, play.cpp:710-855), in PyTorch.

The port of `katacoffee_tpu/selfplay/treerecord.py`, with its semantics:
  * after a move's search, the tree is walked to depth <= 5 following the
    pla/opp "always best" flag alternation: at a node with flags (p, o),
    child i gets (o, p and i is the child with the most visits); the walk
    goes on only where a flag is set and the child's node visits reach the
    threshold;
  * a node is recorded when its p flag is set, it is not the root and it has
    a child;
  * at the root the played move and this turn's side-position fork move are
    left out of the walk;
  * a recorded position becomes a side-position-style row: the node's
    edge-scaled child weights, normalized, as the policy target, its
    searched value as the value target.

As in the JAX package the walk runs level by level with a fixed frontier
(`frontier_cap`) and a fixed number of rows per game and move (`capacity`);
what does not fit is dropped, lowest visits first. Ties between equal visit
counts go to the lower index, as `jax.lax.top_k` breaks them.
"""

from __future__ import annotations

import torch

from katacoffee_tpu_torch.game.board import GameConfig, GameState
from katacoffee_tpu_torch.search import mcts
from katacoffee_tpu_torch.search.mcts import S_DRAW, S_WL, Tree

MAX_RECORD_DEPTH = 5  # play.cpp:833
FRONTIER_CAP = 8  # nodes a level carries on to the next


def _top_k(x: torch.Tensor, k: int):
    """The k largest entries of the last axis, largest first, equal values
    in index order (as jax.lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _pad(x: torch.Tensor, width: int, value) -> torch.Tensor:
    """`x` [B, w] padded with `value` to [B, width]."""
    if x.shape[-1] >= width:
        return x
    fill = torch.full((x.shape[0], width - x.shape[-1]), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=-1)


@torch.no_grad()
def record_tree_positions(
    cfg: GameConfig,
    tree: Tree,
    exclude0: torch.Tensor,
    exclude1: torch.Tensor,
    row_ok: torch.Tensor,
    threshold: int,
    capacity: int,
    frontier_cap: int = FRONTIER_CAP,
):
    """Up to `capacity` recorded interior positions per game of a finished
    search tree: (states [B, M], policy [B, M, A], value [B, M, 3] win/loss/
    draw from the node mover's view, valid [B, M]). `exclude0` / `exclude1`
    [B] are root actions left out (-1 none); `row_ok` [B] False records
    nothing for that game."""
    B, N, A = tree.children.shape
    M = capacity
    F = frontier_cap
    dev = tree.children.device
    bidx = torch.arange(B, device=dev)
    lanes = torch.arange(A, device=dev)
    has_child_map = (tree.children >= 0).any(-1)  # [B, N]

    f_nodes = torch.zeros((B, F), dtype=torch.int64, device=dev)
    f_p = torch.zeros((B, F), dtype=torch.bool, device=dev)
    f_p[:, 0] = True
    f_o = f_p.clone()
    f_alive = torch.zeros((B, F), dtype=torch.bool, device=dev)
    f_alive[:, 0] = row_ok

    rec_ids, rec_vis = [], []
    for depth in range(1, MAX_RECORD_DEPTH + 1):
        width = 1 if depth == 1 else F
        cand = ([], [], [], [], [])  # node, p, o, keep, visits
        for w in range(width):
            n_w = f_nodes[:, w]
            cs = mcts._child_edge_stats(tree, bidx, n_w)
            child = tree.children[bidx, n_w]
            has = child >= 0
            cvis = cs["cvis"]  # the child's node visits
            best = torch.argmax(torch.where(has, cvis, -1.0), dim=-1)
            new_p = f_o[:, w, None].expand(B, A)
            new_o = f_p[:, w, None] & (lanes[None, :] == best[:, None])
            keep = f_alive[:, w, None] & has & (cvis >= float(threshold)) & (new_p | new_o)
            if depth == 1:
                keep = keep & ~((lanes[None, :] == exclude0[:, None]) | (lanes[None, :] == exclude1[:, None]))
            for acc, val in zip(cand, (child.clamp(min=0).to(torch.int64), new_p, new_o, keep, cvis)):
                acc.append(val)
        c_node, c_p, c_o, c_keep, c_vis = (torch.cat(x, dim=-1) for x in cand)

        # record the kept p-flagged candidates that have children: top M by visits
        rvis = torch.where(c_keep & c_p, c_vis, -1.0)
        top_v, top_i = _top_k(rvis, min(M, rvis.shape[-1]))
        top_ids = c_node.gather(1, top_i)
        top_ok = (top_v >= 0) & has_child_map[bidx[:, None], top_ids]
        rec_ids.append(_pad(top_ids, M, 0))
        rec_vis.append(_pad(torch.where(top_ok, top_v, -1.0), M, -1.0))
        if depth == MAX_RECORD_DEPTH:
            break
        # the next frontier: the top F kept candidates by visits
        nf_v, nf_i = _top_k(torch.where(c_keep, c_vis, -1.0), min(F, c_vis.shape[-1]))
        f_nodes = _pad(c_node.gather(1, nf_i), F, 0)
        f_p = _pad(c_p.gather(1, nf_i), F, False)
        f_o = _pad(c_o.gather(1, nf_i), F, False)
        f_alive = _pad(nf_v >= 0, F, False)

    all_ids = torch.cat(rec_ids, dim=-1)  # [B, 5M]
    all_vis = torch.cat(rec_vis, dim=-1)
    sel_v, sel = _top_k(all_vis, M)
    ids = all_ids.gather(1, sel)
    valid = sel_v >= 0
    ids_safe = torch.where(valid, ids, 0)

    # policy target: each node's normalized edge-scaled child weights
    pts = []
    for m in range(M):
        w = mcts._child_edge_stats(tree, bidx, ids_safe[:, m])["w"]
        tot = w.sum(-1, keepdim=True)
        pts.append(torch.where(tot > 0, w / tot.clamp(min=1e-12), 0.0))
    policy = torch.stack(pts, dim=1)  # [B, M, A]
    valid = valid & (policy.sum(-1) > 0)

    # value target: the node's searched value, node-mover perspective
    node_stats = tree.stats[bidx[:, None], ids_safe]  # [B, M, 8]
    wl = node_stats[..., S_WL]
    draw = node_stats[..., S_DRAW].clamp(0.0, 1.0)
    win = ((1.0 - draw + wl) * 0.5).clamp(0.0, 1.0)
    loss = ((1.0 - draw - wl) * 0.5).clamp(0.0, 1.0)
    value = torch.stack([win, loss, draw], dim=-1)
    value = value / value.sum(-1, keepdim=True).clamp(min=1e-8)

    states = tree.states.map(lambda x: x[bidx[:, None], ids_safe])
    return states, policy, value, valid


def empty_tree_position_fields(cfg: GameConfig, tree_states: GameState, batch: int) -> dict:
    """The Trajectory's tree-position fields with no rows (recording off)."""
    dev = tree_states.board.device
    return dict(
        tree_pos_states=tree_states.map(lambda x: x.new_empty((batch, 0) + x.shape[2:])),
        tree_pos_policy=torch.zeros((batch, 0, cfg.policy_size), dtype=torch.float32, device=dev),
        tree_pos_value=torch.zeros((batch, 0, 3), dtype=torch.float32, device=dev),
        tree_pos_valid=torch.zeros((batch, 0), dtype=torch.bool, device=dev),
    )


def tree_position_rows(cfg: GameConfig, settings, traj):
    """A Trajectory's recorded tree positions as side-position-style
    training rows [T * B * M]: the node's policy target, its value as the
    value and TD targets, weight `record_tree_target_weight` on valid rows,
    no opponent-policy and no game-outcome targets."""
    from katacoffee_tpu_torch.selfplay.actor import TrainingBatch

    T, B, M = traj.tree_pos_valid.shape
    R = T * B * M
    Y, X = cfg.y_size, cfg.x_size
    L = len(settings.td_coeffs)
    dev = traj.tree_pos_valid.device

    def flat(x):
        return x.reshape((R,) + x.shape[3:])

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    vt = flat(traj.tree_pos_value)
    return TrainingBatch(
        states=traj.tree_pos_states.map(flat),
        policy_target=flat(traj.tree_pos_policy),
        opponent_policy_target=zeros(R, cfg.policy_size),
        value_target=vt,
        td_value_targets=vt[:, None, :].expand(R, L, 3).clone(),
        ownership_target=zeros(R, Y, X),
        line_target=zeros(R, Y, X, dtype=torch.int32),
        futurepos_target=zeros(R, 2, Y, X),
        var_time_left_target=zeros(R),
        shortterm_value_target=zeros(R),
        weight=flat(traj.tree_pos_valid).to(torch.float32) * float(settings.record_tree_target_weight),
        opponent_policy_weight=zeros(R),
        aux_weight=zeros(R),
    )
