"""Opening book for Coffee on the GPU: the port of `katacoffee_tpu/book/book.py`,
a symmetry-reduced position DAG with search values, expanded by batched
searches on `device` (default `cuda`).

The book is the JAX package's, field for field and byte for byte in its JSON
(reference roles: `cpp/book/book.{h,cpp}`, `cpp/command/genbook.cpp`):
  * a node's key is the canonical situation hash over the dihedral
    symmetries: the minimum of the hex strings of the two uint32 words of
    each image, the lowest symmetry on a tie;
  * node values from search (winloss from the node mover's perspective,
    visits), edges by raw action in the canonical orientation;
  * frontier priority = path probability x exp(-wl_cost/scale), widening of
    expanded nodes with leftover policy mass, the recursive negamax values of
    `recompute`, the JSON file and the static HTML export are plain Python,
    copied.

What runs on the card is `Book.expand`: each round's frontier, padded as the
JAX book pads it (to a power of two of at least 8, repeating the last key),
is ONE `mcts.run_search`, whose root readouts come to the host in one copy.
Where the JAX book steps each added edge alone and keys each new state with
8 `apply_state` + `situation_hash` calls and 8 host reads, the port steps all
of a round's chosen children in one batched `step` and keys them in one
stacked call over every symmetry, read to the host once. The edges are still
merged in the JAX book's order (nodes in frontier order, each node's moves in
visit order), so `_add_state`'s max/min merges see the same sequence.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from katacoffee_tpu_torch.device import resolve_device
from katacoffee_tpu_torch.game import io as gio
from katacoffee_tpu_torch.game import symmetry as S
from katacoffee_tpu_torch.game.board import D_NONE, GameConfig, GameState, init_state, situation_hash, step
from katacoffee_tpu_torch.search import mcts
from katacoffee_tpu_torch.search.params import SearchParams


class _Image(NamedTuple):
    """A state's canonical key and image, read to the host."""

    key: str
    sym: int  # the symmetry mapping the state to its canonical image
    board: list  # [Y][X] ints
    to_move: int
    last_spot: int
    last_dir: int
    num_turns: int
    done: bool
    winner: int


def _canonical_images(cfg: GameConfig, states: GameState) -> list[_Image]:
    """The canonical key and image of each state of a batch [M]: every
    symmetry's image of every state in one stacked `apply_state` and
    `situation_hash`, then one host read. The key of an image is the hex of
    its two uint32 hash words; the canonical one is the least, the lowest
    symmetry on a tie (JAX `_canonical_key`'s strict `<`)."""
    M = states.board.shape[0]
    nsym = S.num_symmetries(cfg)
    area = cfg.area
    syms = torch.arange(nsym, device=states.board.device).repeat(M)  # row m * nsym + s
    imgs = S.apply_state(cfg, syms, states.map(lambda x: x.repeat_interleave(nsym, dim=0)))
    cols = [situation_hash(cfg, imgs), imgs.board.reshape(M * nsym, area).to(torch.int64)]
    cols += [x.to(torch.int64)[:, None] for x in (imgs.to_move, imgs.last_spot, imgs.last_dir, imgs.num_turns,
                                                  imgs.done, imgs.winner)]
    host = torch.cat(cols, dim=1).cpu().numpy().reshape(M, nsym, -1)
    out = []
    for m in range(M):
        keys = [f"{int(host[m, s, 0]):08x}{int(host[m, s, 1]):08x}" for s in range(nsym)]
        best = min(range(nsym), key=lambda s: (keys[s], s))
        row = host[m, best]
        f = row[2 + area:]
        out.append(_Image(keys[best], best, row[2:2 + area].reshape(cfg.y_size, cfg.x_size).tolist(), int(f[0]),
                          int(f[1]), int(f[2]), int(f[3]), bool(f[4]), int(f[5])))
    return out


def _canonical_key(cfg: GameConfig, state: GameState) -> tuple[str, int]:
    """(canonical hash hex, symmetry mapping state->canonical) of a one-game
    batch [1]."""
    img = _canonical_images(cfg, state)[0]
    return img.key, img.sym


def _node_states(cfg: GameConfig, nodes: list, device: torch.device) -> GameState:
    """The nodes' positions as a batch [len(nodes)] on `device`, each built
    as JAX `BookNode.state` builds one: the empty board's state with the
    board, player to move and turn number replaced, and the last move (also
    as the newest recent move) where there is one. The stone hash stays the
    empty board's: the search's hashes are relative to its roots."""
    base = init_state(cfg, len(nodes), device)
    scal = torch.tensor([[n.to_move, n.last_spot, n.last_dir, n.num_turns] for n in nodes], dtype=torch.int64,
                        device=device)
    has_last = scal[:, 1] >= 0
    spot = torch.where(has_last, scal[:, 1], -1)
    direction = torch.where(has_last, scal[:, 2], D_NONE)
    return base._replace(
        board=torch.tensor(np.array([n.board for n in nodes], np.int8), device=device),
        to_move=scal[:, 0].to(torch.int8),
        num_turns=scal[:, 3],
        last_spot=spot,
        last_dir=direction,
        recent_spots=torch.cat([spot[:, None], base.recent_spots[:, 1:]], dim=1),
        recent_dirs=torch.cat([direction[:, None], base.recent_dirs[:, 1:]], dim=1),
    )


@dataclasses.dataclass
class BookNode:
    key: str
    board: list  # [Y][X] ints, canonical orientation
    to_move: int
    last_spot: int
    last_dir: int
    num_turns: int
    winloss: float = 0.0  # mover perspective, from search
    draw: float = 0.0
    visits: int = 0
    path_prob: float = 0.0  # max product of priors from the root
    # accumulated utility sacrificed against the best sibling on the
    # cheapest root path reaching this node (biggestWLCostFromRoot role)
    wl_cost: float = 0.0
    expanded: bool = False
    # policy mass of legal moves not yet in edges (widening priority)
    unexpanded_mass: float = 1.0
    # recursive book value (recomputeNodeValues); None until recompute()
    book_wl: float | None = None
    rec_visits: int = 0  # recursive subtree visits
    edges: dict = dataclasses.field(default_factory=dict)  # action -> (child key, prior, visits)

    def state(self, cfg: GameConfig, device: str | torch.device | None = None) -> GameState:
        """This position as a one-game batch [1] on `device` (default
        `cuda`)."""
        return _node_states(cfg, [self], resolve_device(device))


class Book:
    def __init__(self, cfg: GameConfig, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.nodes: dict[str, BookNode] = {}
        self.root_key = self._add_state(init_state(cfg, 1, self.device), path_prob=1.0)

    def _merge(self, img: _Image, path_prob: float, wl_cost: float) -> str:
        """Add a keyed image as a node, or merge into the node of its key:
        the larger path probability, the smaller cost."""
        node = self.nodes.get(img.key)
        if node is not None:
            node.path_prob = max(node.path_prob, path_prob)
            node.wl_cost = min(node.wl_cost, wl_cost)
            return img.key
        self.nodes[img.key] = BookNode(
            key=img.key,
            board=img.board,
            to_move=img.to_move,
            last_spot=img.last_spot,
            last_dir=img.last_dir,
            num_turns=img.num_turns,
            path_prob=path_prob,
            wl_cost=wl_cost,
        )
        return img.key

    def _add_state(self, state: GameState, path_prob: float, wl_cost: float = 0.0) -> str:
        """Add the position of a one-game batch [1]; returns its key."""
        return self._merge(_canonical_images(self.cfg, state)[0], path_prob, wl_cost)

    # ------------------------------------------------------------------

    # frontier priority = reach probability discounted by the line's
    # accumulated utility sacrifice (exp(-wl_cost/scale) — the documented
    # simplification of the reference's per-node cost model, book.cpp:
    # costPerMove × move-prob compounding × biggestWLCostFromRoot penalty)
    COST_SCALE = 0.15
    # Widening (bonusPerExcessUnexpandedPolicy role): an expanded node
    # re-enters the frontier at priority × WIDEN_FACTOR × unexpanded policy
    # mass, once that mass exceeds MIN_WIDEN_MASS. Expanding it again adds
    # the next-best moves the first pass cut off.
    WIDEN_FACTOR = 0.25
    MIN_WIDEN_MASS = 0.05

    def _priority(self, n: BookNode) -> float:
        p = n.path_prob * math.exp(-max(n.wl_cost, 0.0) / self.COST_SCALE)
        if n.expanded:
            p *= self.WIDEN_FACTOR * n.unexpanded_mass
        return p

    def frontier(self, limit: int, widen: bool = True) -> list[str]:
        """Expansion candidates ranked by reach-probability × line-quality
        (see _priority): unexpanded nodes, plus (with `widen`) expanded
        nodes whose unexpanded policy mass still exceeds MIN_WIDEN_MASS."""
        cand = [
            n
            for n in self.nodes.values()
            if not n.expanded
            or (widen and n.edges and n.unexpanded_mass > self.MIN_WIDEN_MASS)
        ]
        cand.sort(key=lambda n: -self._priority(n))
        return [n.key for n in cand[:limit]]

    def expand(
        self,
        keys: list[str],
        sp: SearchParams,
        eval_fn,
        num_visits: int,
        generator: torch.Generator | None = None,
        top_k: int = 4,
        min_prior: float = 0.02,
    ):
        """Expand the given nodes with ONE batched search call on the
        book's device; `generator` (on that device) gives the search's root
        draws where its settings take any."""
        if not keys:
            return
        cfg = self.cfg
        A = cfg.policy_size
        # pad to the JAX book's stable batch sizes (the same searched lanes)
        n_real = len(keys)
        pad = (-n_real) % max(8, 1 << (n_real - 1).bit_length()) if n_real > 1 else 0
        keys_padded = list(keys) + [keys[-1]] * pad
        states = _node_states(cfg, [self.nodes[k] for k in keys_padded], self.device)
        tree = mcts.run_search(cfg, sp, eval_fn, states, num_visits, device=self.device, generator=generator)
        vals = mcts.root_values(tree)
        # one host copy of the round's readouts (visit counts are exact in float32)
        host = torch.cat([mcts.root_visit_counts(tree).to(torch.float32), tree.prior[:, 0].clamp(min=0.0),
                          vals["child_utility"], vals["child_wl"], vals["root_wl"][:, None],
                          vals["root_draw"][:, None]], dim=1).cpu().numpy()
        rv = host[:, :A].astype(np.int32)  # [B, A]
        priors = host[:, A:2 * A]
        child_u = host[:, 2 * A:3 * A]  # parent persp.
        child_wl = host[:, 3 * A:4 * A]  # parent persp.
        wl = host[:, 4 * A]
        draw = host[:, 4 * A + 1]

        # which moves each node keeps (top moves by search visits, at least
        # min_prior or visited): (new edge?, action) in visit order
        plans = []
        for i, k in enumerate(keys):
            node = self.nodes[k]
            had_edges = len(node.edges)
            events, added = [], 0
            for a in np.argsort(-rv[i]):
                a = int(a)
                if added >= top_k or rv[i][a] <= 0:
                    break
                if a in node.edges:  # widening pass: keep, refresh visits
                    events.append((False, a))
                    continue
                # low-prior moves still enter the book if the search actually
                # spent visits on them
                if priors[i][a] < min_prior and rv[i][a] < 2 and (added > 0 or had_edges):
                    continue
                events.append((True, a))
                added += 1
            plans.append((had_edges, added, events))
        # every new edge's child in one batched step, keyed in one call
        new = [(i, a) for i, (_, _, events) in enumerate(plans) for fresh, a in events if fresh]
        images = iter(())
        if new:
            rows = torch.tensor([i for i, _ in new], device=self.device)
            acts = torch.tensor([a for _, a in new], device=self.device)
            images = iter(_canonical_images(cfg, step(cfg, states.map(lambda x: x[rows]), acts)))

        for i, k in enumerate(keys):
            node = self.nodes[k]
            had_edges, added, events = plans[i]
            node.winloss = float(wl[i])
            node.draw = float(draw[i])
            node.visits += num_visits
            node.expanded = True
            # best searched child utility (parent perspective) anchors the
            # per-edge sacrifice for the cost model
            visited = rv[i] > 0
            best_u = float(child_u[i][visited].max()) if visited.any() else 0.0
            for fresh, a in events:
                if not fresh:
                    ckey, pr, v0 = node.edges[a]
                    node.edges[a] = (ckey, pr, max(v0, int(rv[i][a])))
                    continue
                img = next(images)
                child_prob = node.path_prob * max(float(priors[i][a]), 1e-3)
                child_cost = node.wl_cost + max(best_u - float(child_u[i][a]), 0.0)
                ckey = self._merge(img, child_prob, child_cost)
                child = self.nodes[ckey]
                if img.done:
                    child.expanded = True  # terminal: nothing to expand
                    child.unexpanded_mass = 0.0
                    child.winloss = -1.0 if img.winner else 0.0
                elif not child.expanded and child.visits == 0:
                    # seed with the parent search's estimate of this child
                    # (thisValuesNotInBook role) until its own search runs
                    child.winloss = -float(child_wl[i][a])  # child-mover persp.
                node.edges[a] = (ckey, float(priors[i][a]), int(rv[i][a]))
            # remaining policy mass not in the book (widening priority);
            # a pass that adds nothing retires the node from the frontier
            mass = 1.0 - sum(pr for _, pr, _ in node.edges.values())
            node.unexpanded_mass = max(0.0, mass) if (added or not had_edges) else 0.0

    # ------------------------------------------------------------------

    def recompute(self):
        """Recursive book values (recomputeEverything → recomputeNodeValues,
        book.cpp:941-955,1277-1380): negamax each node's winloss over its
        expanded children's book values, floored by the node's own search
        value (an unexpanded move may be better than every edge — the
        reference's thisValuesNotInBook floor). Every Coffee move adds a
        stone, so num_turns strictly increases along edges and descending
        num_turns is a valid reverse-topological order over the DAG. Also
        accumulates recursive subtree visits (recursiveValues.visits;
        shared transpositions double-count, as in the reference)."""
        for n in sorted(self.nodes.values(), key=lambda m: -m.num_turns):
            best = None
            rec = n.visits
            for ckey, _, _ in n.edges.values():
                child = self.nodes[ckey]
                cv = -(child.book_wl if child.book_wl is not None else child.winloss)
                best = cv if best is None else max(best, cv)
                rec += child.rec_visits
            n.book_wl = n.winloss if best is None else max(n.winloss, best)
            n.rec_visits = rec

    def best_line(self, max_len: int = 10) -> list[tuple[str, int]]:
        """Greedy most-visited line from the root: [(node key, action)]."""
        out = []
        key = self.root_key
        seen = set()
        for _ in range(max_len):
            node = self.nodes[key]
            if not node.edges or key in seen:
                break
            seen.add(key)
            a = max(node.edges, key=lambda a: node.edges[a][2])
            out.append((key, a))
            key = node.edges[a][0]
        return out

    def check(self) -> list[str]:
        """Consistency check (the reference's checkbook): every edge target
        exists; winloss in range; root reachable sizes."""
        errors = []
        for k, node in self.nodes.items():
            for a, (ckey, prior, visits) in node.edges.items():
                if ckey not in self.nodes:
                    errors.append(f"{k}: edge {a} -> missing node {ckey}")
                if not (0 <= a < self.cfg.policy_size):
                    errors.append(f"{k}: bad action {a}")
            if not (-1.0001 <= node.winloss <= 1.0001):
                errors.append(f"{k}: winloss out of range {node.winloss}")
            if node.book_wl is not None:
                # recursive value must dominate the negamax of the children
                for a, (ckey, _, _) in node.edges.items():
                    child = self.nodes.get(ckey)
                    if child is not None and child.book_wl is not None:
                        if node.book_wl < -child.book_wl - 1e-6:
                            errors.append(
                                f"{k}: book_wl {node.book_wl:.4f} < negamax of"
                                f" edge {a} ({-child.book_wl:.4f})"
                            )
        if self.root_key not in self.nodes:
            errors.append("missing root")
        return errors

    # ------------------------------------------------------------------

    def save(self, path: str):
        data = {
            "version": 1,
            "game": "coffee",
            "x_size": self.cfg.x_size,
            "y_size": self.cfg.y_size,
            "win_len": self.cfg.win_len,
            "root": self.root_key,
            "nodes": {
                k: {
                    **{f: getattr(n, f) for f in (
                        "board", "to_move", "last_spot", "last_dir", "num_turns",
                        "winloss", "draw", "visits", "path_prob", "wl_cost",
                        "expanded", "unexpanded_mass", "book_wl", "rec_visits",
                    )},
                    "edges": {str(a): list(e) for a, e in n.edges.items()},
                }
                for k, n in self.nodes.items()
            },
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)

    @staticmethod
    def load(path: str, device: str | torch.device | None = None) -> "Book":
        """The book saved at `path`, its searches on `device` (default
        `cuda`)."""
        with open(path) as f:
            data = json.load(f)
        cfg = GameConfig(data["x_size"], data["y_size"], data["win_len"])
        book = Book(cfg, device)
        book.nodes = {}
        for k, nd in data["nodes"].items():
            node = BookNode(
                key=k,
                board=nd["board"],
                to_move=nd["to_move"],
                last_spot=nd["last_spot"],
                last_dir=nd["last_dir"],
                num_turns=nd["num_turns"],
                winloss=nd["winloss"],
                draw=nd["draw"],
                visits=nd["visits"],
                path_prob=nd["path_prob"],
                wl_cost=nd.get("wl_cost", 0.0),
                expanded=nd["expanded"],
                unexpanded_mass=nd.get("unexpanded_mass", 0.0 if nd["expanded"] else 1.0),
                book_wl=nd.get("book_wl"),
                rec_visits=nd.get("rec_visits", 0),
                edges={int(a): tuple(e) for a, e in nd["edges"].items()},
            )
            book.nodes[k] = node
        book.root_key = data["root"]
        return book

    # ------------------------------------------------------------------

    def _board_svg(self, n, last: tuple | None = None) -> str:
        """Static SVG board (bookcssjs.cpp's rendered-board role): grid,
        stones, and an optional last-move marker with its direction arrow."""
        cfg = self.cfg
        CELL = 36
        w, h = cfg.x_size * CELL, cfg.y_size * CELL
        parts = [
            f'<svg class="board" viewBox="0 0 {w} {h}" width="{w}" height="{h}">',
            f'<rect width="{w}" height="{h}" fill="#e8c98a"/>',
        ]
        for x in range(cfg.x_size):
            parts.append(
                f'<line x1="{x*CELL+CELL//2}" y1="{CELL//2}" x2="{x*CELL+CELL//2}" '
                f'y2="{h-CELL//2}" stroke="#7a5c2e"/>'
            )
        for y in range(cfg.y_size):
            parts.append(
                f'<line x1="{CELL//2}" y1="{y*CELL+CELL//2}" x2="{w-CELL//2}" '
                f'y2="{y*CELL+CELL//2}" stroke="#7a5c2e"/>'
            )
        for y in range(cfg.y_size):
            for x in range(cfg.x_size):
                c = n.board[y][x]
                if c == 0:
                    continue
                fill = "#111" if c == 1 else "#fafafa"
                parts.append(
                    f'<circle cx="{x*CELL+CELL//2}" cy="{y*CELL+CELL//2}" '
                    f'r="{CELL//2-3}" fill="{fill}" stroke="#444"/>'
                )
        if last is not None:
            lx, ly, ld = last
            cx, cy = lx * CELL + CELL // 2, ly * CELL + CELL // 2
            parts.append(
                f'<circle cx="{cx}" cy="{cy}" r="{CELL//5}" fill="none" '
                'stroke="#d03020" stroke-width="2"/>'
            )
            # direction ray: N (col), W (row), NW, NE — the move's line claim
            dx, dy = {0: (0, -1), 1: (-1, 0), 2: (-1, -1), 3: (1, -1)}[ld]
            parts.append(
                f'<line x1="{cx}" y1="{cy}" x2="{cx+dx*CELL//2}" '
                f'y2="{cy+dy*CELL//2}" stroke="#d03020" stroke-width="2"/>'
            )
        parts.append("</svg>")
        return "".join(parts)

    def _pv(self, n, keys: set, max_len: int = 8) -> list:
        """Best-line walk through book edges by visits (bookcssjs's PV
        display role). Returns [(move string, node key or None), ...]."""
        out = []
        cur = n
        seen = {n.key}
        for _ in range(max_len):
            if not cur.edges:
                break
            a, (ckey, _, _) = max(cur.edges.items(), key=lambda kv: kv[1][2])
            out.append((gio.action_to_string(a, self.cfg), ckey if ckey in keys else None))
            if ckey not in keys or ckey in seen:
                break
            seen.add(ckey)
            cur = self.nodes[ckey]
        return out

    def export_html(self, out_dir: str, max_nodes: int = 2000):
        """Static HTML browser — the writebook / bookcssjs.cpp role
        (the reference's `cpp/book/bookcssjs.cpp` renders navigable board
        pages with per-move values): one page per node with an SVG board
        (last-move marker + direction ray), per-move child BOOK values /
        priors / visits with links, the principal variation, parent-position
        links, and a depth-sorted index. Pure static output (no server);
        a small inline script gives table sorting like the reference's JS."""
        os.makedirs(out_dir, exist_ok=True)
        cfg = self.cfg
        nodes = sorted(self.nodes.values(), key=lambda n: -n.path_prob)[:max_nodes]
        keys = {n.key for n in nodes}
        parents: dict = {}
        for n in nodes:
            for a, (ckey, _, _) in n.edges.items():
                if ckey in keys:
                    parents.setdefault(ckey, []).append((n.key, a))
        css = (
            "body{font-family:sans-serif;margin:2em;max-width:60em}"
            "svg.board{margin:0.5em 0}"
            "table.m{border-collapse:collapse;margin-top:1em}"
            "table.m td,table.m th{border:1px solid #ccc;padding:4px 10px;"
            "text-align:right}"
            "table.m td:first-child{text-align:left}"
            "th{cursor:pointer;background:#f4f4f4}"
            ".pv{color:#555}.nav{margin-top:1em}"
            ".good{color:#0a7a0a}.bad{color:#c02020}"
        )
        sort_js = (
            "function srt(t,c){const b=t.tBodies[0];const r=[...b.rows];"
            "const d=t.dataset['s'+c]!=='1';t.dataset['s'+c]=d?'1':'0';"
            "r.sort((x,y)=>{const a=parseFloat(x.cells[c].dataset.v||x.cells[c].textContent)||0,"
            "e=parseFloat(y.cells[c].dataset.v||y.cells[c].textContent)||0;"
            "return d?e-a:a-e});r.forEach(w=>b.appendChild(w));}"
        )
        with open(os.path.join(out_dir, "style.css"), "w") as f:
            f.write(css)
        for n in nodes:
            moves = []
            for a, (ckey, prior, visits) in sorted(
                n.edges.items(), key=lambda kv: -kv[1][2]
            ):
                mv = gio.action_to_string(a, cfg)
                link = f'<a href="{ckey}.html">{mv}</a>' if ckey in keys else mv
                child = self.nodes.get(ckey)
                if child is not None:
                    cwl = child.book_wl if child.book_wl is not None else child.winloss
                    # negate: child values are child-mover perspective
                    wl_here = -cwl
                    cls = "good" if wl_here > 0.05 else ("bad" if wl_here < -0.05 else "")
                    wl_cell = f'<td class="{cls}" data-v="{wl_here:.4f}">{wl_here:+.3f}</td>'
                    draw_cell = f"<td>{child.draw:.3f}</td>"
                else:
                    wl_cell = '<td data-v="0">—</td>'
                    draw_cell = "<td>—</td>"
                moves.append(
                    f"<tr><td>{link}</td>{wl_cell}{draw_cell}"
                    f"<td>{prior:.3f}</td><td>{visits}</td></tr>"
                )
            mover = "black (●)" if n.to_move == 1 else "white (○)"
            pv = self._pv(n, keys)
            pv_html = " ".join(
                f'<a href="{k}.html">{mv}</a>' if k else mv for mv, k in pv
            )
            up = parents.get(n.key, [])
            up_html = " · ".join(
                f'<a href="{pk}.html">&larr; {gio.action_to_string(a, cfg)}</a>'
                for pk, a in up[:6]
            )
            html = (
                "<!DOCTYPE html><html><head>"
                '<link rel="stylesheet" href="style.css">'
                f"<script>{sort_js}</script>"
                "<title>KataCoffee book</title></head><body>"
                f"<h2>Position {n.key[:12]}</h2>"
                + self._board_svg(n)
                + f"<p>to move: {mover} · winloss {n.winloss:+.3f}"
                + (f" · book {n.book_wl:+.3f}" if n.book_wl is not None else "")
                + f" · draw {n.draw:.3f} "
                f"· visits {n.visits} · reach-prob {n.path_prob:.4f}</p>"
                + (f'<p class="pv">PV: {pv_html}</p>' if pv else "")
                + '<table class="m" id="mt"><thead><tr>'
                + "".join(
                    f'<th onclick="srt(document.getElementById(\'mt\'),{i})">{h}</th>'
                    for i, h in enumerate(
                        ("move", "winloss", "draw", "prior", "visits")
                    )
                )
                + "</tr></thead><tbody>"
                + "".join(moves)
                + "</tbody></table>"
                + '<p class="nav">'
                + (up_html + " · " if up_html else "")
                + f'<a href="{self.root_key}.html">root</a> · '
                + '<a href="list.html">all positions</a></p>'
                + "</body></html>"
            )
            with open(os.path.join(out_dir, f"{n.key}.html"), "w") as f:
                f.write(html)
        # depth/probability-sorted index of every exported position
        rows = "".join(
            f'<tr><td><a href="{n.key}.html">{n.key[:12]}</a></td>'
            f"<td>{int(np.sum(np.asarray(n.board) != 0))}</td>"
            f"<td>{'●' if n.to_move == 1 else '○'}</td>"
            f"<td>{(n.book_wl if n.book_wl is not None else n.winloss):+.3f}</td>"
            f"<td>{n.path_prob:.4f}</td><td>{n.visits}</td></tr>"
            for n in nodes
        )
        with open(os.path.join(out_dir, "list.html"), "w") as f:
            f.write(
                "<!DOCTYPE html><html><head>"
                '<link rel="stylesheet" href="style.css"></head><body>'
                "<h2>Book positions</h2>"
                '<table class="m"><thead><tr><th>key</th><th>stones</th>'
                "<th>to move</th><th>winloss(mover)</th><th>reach-prob</th>"
                "<th>visits</th>"
                "</tr></thead><tbody>" + rows + "</tbody></table></body></html>"
            )
        with open(os.path.join(out_dir, "index.html"), "w") as f:
            f.write(
                f'<!DOCTYPE html><html><head><meta http-equiv="refresh" '
                f'content="0; url={self.root_key}.html"></head></html>'
            )


def build_book(
    cfg: GameConfig,
    sp: SearchParams,
    eval_fn,
    num_rounds: int,
    batch_size: int,
    num_visits: int,
    seed: int = 0,
    log=print,
    device: str | torch.device | None = None,
) -> Book:
    """`num_rounds` expansion rounds of up to `batch_size` frontier nodes
    each, then `recompute`. The searches' root draws come from one
    `torch.Generator` seeded with `seed` (the JAX book splits a key a
    round)."""
    book = Book(cfg, device)
    generator = torch.Generator(device=book.device).manual_seed(seed)
    for r in range(num_rounds):
        frontier = book.frontier(batch_size)
        if not frontier:
            break
        book.expand(frontier, sp, eval_fn, num_visits, generator)
        log(f"book: round {r}: expanded {len(frontier)}, total nodes {len(book.nodes)}")
    book.recompute()
    return book
