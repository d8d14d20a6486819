"""Tree-averaged ownership maps (analysis/GTP protocol surface): the port of
`katacoffee_tpu/search/ownership.py`.

The reference averages each visited node's NN ownership map over the search
tree, weighting a node against its children by its own NN weight vs the
children's squared child-weights, with sublinear depth cutoffs
(`Search::getAverageTreeOwnership` / `traverseTreeForOwnership`,
reference cpp/search/searchresults.cpp:1566-1745). The maps are not stored
in the tree: they are recomputed on demand with one batched forward pass
over the node states (`Tree.states` is [B, N, ...]), so the search's hot
path carries no [B, N, area] ownership buffer.

The proportion recursion runs on host numpy: a per-query frontend
computation over one game's small tree, not a hot path.

Perspective: per-node maps come out of the net in that node's mover
perspective; they are sign-aligned to the ROOT mover before averaging, so
the returned map is root-mover perspective (the reference emits
white-perspective and flips at output, searchresults.cpp:1753-1760).
"""

from __future__ import annotations

import numpy as np

from katacoffee_tpu_torch.search.mcts import host_tree


def node_ownership_maps(raw_forward, tree, i: int) -> np.ndarray:
    """[N, area] net ownership (tanh'd) for every node slot of game `i`,
    sign-aligned to the root mover. One batched forward over the node
    states; slots beyond node_count are garbage and must be masked by the
    caller's proportion vector (which is 0 there). `raw_forward` returns
    the net's heads as numpy arrays (`mcts.make_raw_forward_fn`, or its
    cache)."""
    states_i = tree.states.map(lambda x: x[i])
    heads = raw_forward(states_i)
    own = np.tanh(np.asarray(heads["ownership"], np.float32))
    own = own.reshape(own.shape[0], -1)
    to_move = states_i.to_move.cpu().numpy()
    sign = np.where(to_move == to_move[0], 1.0, -1.0).astype(np.float32)
    return own * sign[:, None]


def ownership_props(
    children: np.ndarray,  # [N, A] int32 child index or -1
    edge_visits: np.ndarray,  # [N, A] int32
    visits: np.ndarray,  # [N] int
    weight_sum: np.ndarray,  # [N] f32
    self_weight: np.ndarray,  # [N] f32 node's own NN weight
    is_terminal: np.ndarray,  # [N] bool (no NN output -> not accumulated)
    node: int = 0,
) -> np.ndarray:
    """Per-node accumulation proportions for the subtree rooted at `node`
    (sums to 1 over accumulated nodes). Host re-design of the reference's
    traverseTreeForOwnership (searchresults.cpp:1616-1745): each node keeps
    desiredProp * selfNNWeight / (childrenWeightSum + selfNNWeight) for its
    own map and splits the rest over children proportionally to
    childWeight^2, stopping at desiredProp < minProp (sublinear in visits)
    and dropping branches below pruneProp; unaccumulated branches (terminal
    nodes, cycles back onto the path) return their proportion to the
    parent's own map."""
    n = children.shape[0]
    props = np.zeros(n, np.float64)
    min_prop = 0.5 / max(1.0, float(visits[node])) ** 0.75
    prune_prop = min_prop * 0.01
    path: set[int] = set()

    def traverse(nd: int, desired: float) -> bool:
        if is_terminal[nd]:
            return False
        if desired < min_prop:
            props[nd] += desired
            return True
        ch = children[nd]
        live = np.nonzero(ch >= 0)[0]
        if live.size == 0:
            props[nd] += desired
            return True
        if nd in path:
            # cycle in the graph: treat as base case (searchresults.cpp:1652)
            props[nd] += desired
            return True
        path.add(nd)
        cidx = ch[live]
        cw = weight_sum[cidx] * (
            edge_visits[nd, live] / np.maximum(visits[cidx], 1)
        ).astype(np.float64)
        rel_sum = float(np.sum(cw * cw))
        w_sum = float(np.sum(cw))
        parent_w = max(float(self_weight[nd]), 1e-10)
        from_children = desired * w_sum / (w_sum + parent_w)
        self_prop = desired * parent_w / (w_sum + parent_w)
        if from_children <= 0.0 or rel_sum <= 0.0:
            self_prop += from_children
        else:
            for k in range(live.size):
                d_child = float(cw[k]) * float(cw[k]) / rel_sum * from_children
                if d_child < prune_prop:
                    self_prop += d_child
                elif not traverse(int(cidx[k]), d_child):
                    self_prop += d_child
        path.discard(nd)
        props[nd] += self_prop
        return True

    traverse(int(node), 1.0)
    return props


def tree_ownership(
    tree,
    i: int,
    own_maps: np.ndarray,
    node: int = 0,
    want_stdev: bool = False,
    host: dict | None = None,
) -> tuple[np.ndarray, np.ndarray | None]:
    """(average[area], stdev[area] or None) over the subtree of game `i`
    rooted at `node`, using precomputed per-node maps from
    node_ownership_maps. stdev is the proportion-weighted standard
    deviation across the search, searchresults.cpp:1587-1612. `host` is
    game i's arrays as `mcts.host_tree` copies them, where the caller has
    them already; without it they are copied here."""
    h = host if host is not None else host_tree(tree, i)
    props = ownership_props(
        h["children"], h["edge_visits"], h["visits"], h["weight_sum"], h["self_weight"], h["is_terminal"], node
    )
    total = props.sum()
    if total <= 0.0:
        # fully-terminal subtree: no NN maps anywhere — report zeros
        area = own_maps.shape[1]
        return np.zeros(area), (np.zeros(area) if want_stdev else None)
    props = props / total
    avg = props @ own_maps
    if not want_stdev:
        return avg, None
    sq = props @ (own_maps * own_maps)
    stdev = np.sqrt(np.maximum(sq - avg * avg, 0.0))
    return avg, stdev
