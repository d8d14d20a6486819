"""Host engine facade: one interactive game driving the batched search, the
port of `katacoffee_tpu/program/engine.py`.

The role of the reference's `AsyncBot` + `Search` root management +
`GTPEngine` internals (`cpp/search/asyncbot.{h,cpp}`, `cpp/command/gtp.cpp:
318-534`): hold a position, validate and play moves, run a search from the
current position (a B=1 array-of-trees search, `search.mcts`), extract the
chosen move, the analysis rows and the PVs (searchresults.cpp
getAnalysisData, a PV walk by edge visits).

Where the JAX engine compiles one search per visit count and bucketed node
capacity, the port calls `run_search`, `continue_search` and `advance_root`
eagerly with the same node capacities (`_bucket_cap`), so a filled tree
behaves alike. Random draws (the move choice's Gumbel noise, root noise and
sampled root symmetries where the search params ask for them) come from one
`torch.Generator` on the engine's device, seeded from `seed`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from katacoffee_tpu_torch.device import resolve_device
from katacoffee_tpu_torch.game import io as gio
from katacoffee_tpu_torch.game import symmetry as S
from katacoffee_tpu_torch.game.board import GameConfig, GameState, init_state, legal_mask_flat, step
from katacoffee_tpu_torch.search import mcts
from katacoffee_tpu_torch.search.params import SearchParams


@dataclasses.dataclass
class MoveInfo:
    """Per-candidate analysis row (the reference's AnalysisData,
    search/analysisdata.h)."""

    action: int
    move: str
    visits: int
    winrate: float  # from the root player's perspective, in [0,1]
    draw_prob: float
    utility: float
    lcb: float
    prior: float
    order: int
    pv: list[str]
    # visits of each PV node / PV edge (searchresults.cpp:798-801 pvVisits /
    # pvEdgeVisits; emitted by the analysis engine under includePVVisits)
    pv_visits: list[int] = dataclasses.field(default_factory=list)
    pv_edge_visits: list[int] = dataclasses.field(default_factory=list)
    # edge-scaled child weight (kata-analyze `weight`, gtp.cpp:878)
    weight: float = 0.0
    # the child's node slot in the search tree (for per-move subtree
    # statistics such as movesOwnership)
    node: int = -1
    # under rootSymmetryPruning, rows are re-expanded over the root
    # stabilizer: a duplicate names its searched original and the symmetry
    # that maps original -> this move (searchresults.cpp:986-1012)
    is_symmetry_of: str | None = None
    symmetry: int = 0


@dataclasses.dataclass
class AnalysisResult:
    root_visits: int
    root_winrate: float  # root player's perspective, [0,1]
    root_draw_prob: float
    root_utility: float
    move_infos: list[MoveInfo]


class IllegalMoveError(ValueError):
    pass


def _warm_kernels(dev: torch.device) -> None:
    """Builds and loads both search kernels on a CUDA device, so that no
    search the engine times pays their build (the JAX engine's first search
    pays the compile instead)."""
    if dev.type == "cuda":
        from katacoffee_tpu_torch.ops import descend, gather

        descend.load_kernel()
        gather.load_kernel()


class Engine:
    """One game + search on `device` (default `cuda`). `eval_fn` is an
    mcts.EvalFn on that device; None = uniform priors (the reference's
    "random" model sentinel before any net exists)."""

    def __init__(
        self,
        cfg: GameConfig,
        search_params: SearchParams,
        eval_fn: mcts.EvalFn | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        self.cfg = cfg
        self.sp = search_params
        self.device = resolve_device(device)
        self.eval_fn = eval_fn if eval_fn is not None else mcts.uniform_eval_fn(cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.visits_per_second: float | None = None  # measured, for time controls
        # the most recent search's tree ([1, N] tensors): read by the GTP
        # frontend for tree-averaged ownership right after a search
        self.last_tree: mcts.Tree | None = None
        # Ponder/tree-reuse state (the AsyncBot ponder + beginSearch tree
        # reuse roles, cpp/search/asyncbot.cpp ponder path + search.cpp:
        # 262-331): a retained search tree rooted at the current position,
        # advanced through every played move, consumed by the next
        # search/genmove as a head start. Only populated when the frontend
        # enables it (ponderingEnabled), so the default path is a fresh
        # search every time.
        self.reuse_enabled = False
        self._reuse: tuple[mcts.Tree, int] | None = None  # (tree, node cap)
        # node-capacity floor for reuse-path searches, so a genmove tree is
        # big enough for the follow-up ponder budget (the frontend sets this
        # to bucket(max(maxVisits, ponder visits)))
        self.min_reuse_cap = 0
        self.clear_board()

    # ------------------------------------------------------------------
    # Position management
    # ------------------------------------------------------------------

    def clear_board(self):
        self.state: GameState = init_state(self.cfg, 1, self.device)
        self.move_history: list[tuple[int, int, int, int]] = []  # (x, y, d, pla)
        self._state_stack: list[GameState] = []
        self.last_tree = None
        self._reuse = None

    def set_position(self, board: np.ndarray, to_move: int, last_move: tuple[int, int, int] | None = None):
        """Arbitrary position (GTP set_position / SGF placements). History
        beyond the optional last move is unknown -> empty recent-move planes,
        like the reference setting up a Board without a BoardHistory."""
        base = init_state(self.cfg, 1, self.device)
        board = torch.from_numpy(np.asarray(board, np.int8)).to(self.device)[None]
        nstones = int((board != 0).sum())
        st = base._replace(
            board=board,
            to_move=torch.full_like(base.to_move, to_move),
            num_turns=torch.full_like(base.num_turns, nstones),
        )
        if last_move is not None:
            x, y, d = last_move
            spot = y * self.cfg.x_size + x
            recent_spots, recent_dirs = st.recent_spots.clone(), st.recent_dirs.clone()
            recent_spots[:, 0] = spot
            recent_dirs[:, 0] = d
            st = st._replace(
                last_spot=torch.full_like(st.last_spot, spot),
                last_dir=torch.full_like(st.last_dir, d),
                recent_spots=recent_spots,
                recent_dirs=recent_dirs,
            )
        self.state = st
        self.move_history = []
        self._state_stack = []
        self._reuse = None

    def set_search_params(self, sp: SearchParams):
        """Swap the search parameters mid-game (GTP kata-set-param); the
        retained tree is dropped, position and clock state are kept."""
        self.sp = sp
        self._reuse = None

    def set_to_move(self, pla: int):
        """Override the player to move at the current position (the
        reference's GTPEngine analyze-for-either-player and out-of-order
        `play` support re-root the search this way)."""
        self.state = self.state._replace(to_move=torch.full_like(self.state.to_move, pla))
        self._reuse = None

    def stone_count(self) -> int:
        """Stones on the current board (Board::isEmpty role for the GTP
        handicap-command validation, gtp.cpp:2751)."""
        return int((self.state.board != 0).sum())

    def legal_actions(self) -> np.ndarray:
        return legal_mask_flat(self.cfg, self.state)[0].cpu().numpy()

    def is_legal(self, x: int, y: int, d: int) -> bool:
        a = d * self.cfg.area + y * self.cfg.x_size + x
        return bool(self.legal_actions()[a])

    def play(self, x: int, y: int, d: int, pla: int | None = None):
        """Validate and play. `pla` if given must match the player to move
        (GTP allows playing for either side; the reference errors on
        out-of-turn play for Coffee since legality depends on move order)."""
        if pla is not None and pla != self.to_move:
            turn = "black" if self.to_move == 1 else "white"
            raise IllegalMoveError(f"it is {turn}'s turn")
        if not self.is_legal(x, y, d):
            raise IllegalMoveError(f"illegal move {gio.loc_to_string(x, y, d, self.cfg)}")
        a = d * self.cfg.area + y * self.cfg.x_size + x
        self._state_stack.append(self.state)
        mover = self.to_move
        action = torch.tensor([a], dtype=torch.int64, device=self.device)
        self.state = step(self.cfg, self.state, action)
        self.move_history.append((x, y, d, mover))
        if self._reuse is not None:
            if self.game_over:
                self._reuse = None
            else:
                # carry the retained tree through the played move (beginSearch
                # tree reuse, search.cpp:262-331; a fresh root evaluation
                # inside advance_root where the child was never expanded)
                tree, cap = self._reuse
                tree = mcts.advance_root(self.cfg, self.sp, self.eval_fn, tree, action, self.state,
                                         generator=self.generator, turn_number=self.state.num_turns)
                self._reuse = (tree, cap)

    def undo(self):
        if not self._state_stack:
            raise ValueError("nothing to undo")
        self.state = self._state_stack.pop()
        self.move_history.pop()
        self._reuse = None

    @property
    def game_over(self) -> bool:
        return bool(self.state.done[0])

    @property
    def winner(self) -> int:
        return int(self.state.winner[0])

    @property
    def to_move(self) -> int:
        return int(self.state.to_move[0])

    def board(self) -> np.ndarray:
        return self.state.board[0].cpu().numpy()

    def showboard(self) -> str:
        return gio.board_to_string(self.board(), self.cfg)

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start(self, cap: int, avoid=None, avoid_until=None) -> mcts.Tree:
        """A tree of `cap` node slots holding the evaluated root (0
        playouts), the first half of the streamed search."""
        return mcts.run_search(self.cfg, self.sp, self.eval_fn, self.state, 0, cap, device=self.device,
                               generator=self.generator, root_avoid=avoid, avoid_until=avoid_until)

    def _continue(self, tree: mcts.Tree, cap: int, target: int, avoid_until=None) -> mcts.Tree:
        """Playouts until the root has `target` visits, at most `cap`."""
        return mcts.continue_search(self.cfg, self.sp, self.eval_fn, tree, cap, float(target), avoid_until,
                                     generator=self.generator)

    def _mask(self, a, dtype) -> torch.Tensor | None:
        return None if a is None else torch.from_numpy(np.asarray(a).astype(dtype)).to(self.device)[None]

    def search(
        self,
        max_visits: int,
        avoid: np.ndarray | None = None,
        avoid_until: np.ndarray | None = None,
    ) -> mcts.Tree:
        if self.game_over:
            raise ValueError("game is over")
        _warm_kernels(self.device)
        t0 = time.monotonic()
        if self.reuse_enabled and avoid is None and avoid_until is None:
            # Tree-reuse path (pondering enabled): start from the retained
            # tree when one exists and continue to the total visit target:
            # reused visits count toward the budget exactly as the
            # reference's maxVisits does, which is where pondering buys
            # genmove latency. A fresh search runs at the same bucketed
            # capacity, so that its tree is reusable by the following
            # ponder/genmove.
            cap = max(self._bucket_cap(max_visits), self.min_reuse_cap)
            if self._reuse is not None and self._reuse[1] >= self._bucket_cap(max_visits):
                tree, cap = self._reuse
            else:
                tree = self._start(cap)
            tree = self._continue(tree, cap, max_visits + 1)
            self._sync()
            self.last_tree = tree
            self._reuse = (tree, cap)
            return tree
        if avoid is not None or avoid_until is not None:
            # search_stream keeps visits_per_second per chunk itself
            tree = None
            for tree, _ in self.search_stream(max_visits, max_visits, avoid=avoid, avoid_until=avoid_until):
                pass
            return tree
        tree = mcts.run_search(self.cfg, self.sp, self.eval_fn, self.state, max_visits, device=self.device,
                               generator=self.generator)
        self._sync()
        self.last_tree = tree
        dt = max(time.monotonic() - t0, 1e-6)
        # running visits/s (the kernels are built before t0)
        if max_visits >= 8 and self.visits_per_second is not None:
            self.visits_per_second = 0.7 * self.visits_per_second + 0.3 * (max_visits / dt)
        elif max_visits >= 8:
            self.visits_per_second = max_visits / dt
        return tree

    # ------------------------------------------------------------------
    # Chunked / streaming search (the interruptible-search role: the
    # reference's search threads poll shouldStop + report kata-analyze
    # intervals, gtp.cpp kata-analyze + searchtimehelpers.cpp stop
    # conditions; here the host checks between chunks)
    # ------------------------------------------------------------------

    @staticmethod
    def _bucket_cap(max_visits: int) -> int:
        return 1 << max(6, int(max_visits + 2 - 1).bit_length())

    def ponder_stream(self, max_visits: int, interval_visits: int = 64):
        """Background search of the current position in chunks, so that the
        caller can poll for new input between them (the reference's ponder
        thread, AsyncBot::ponder, asyncbot.cpp): the host runs short
        `continue_search` chunks while idle and stops between chunks.

        Yields (tree, total_root_visits) after every chunk. The tree is
        retained in `self._reuse`; a later `search`/`genmove` at this
        position starts from it, and `play` advances it through moves, so
        ponder visits directly cut the next genmove's latency (KataGo's
        ponder + tree-reuse semantics: maxVisits counts reused visits too,
        search.cpp beginSearch)."""
        if self.game_over:
            return
        cap = max(self._bucket_cap(max_visits), self.min_reuse_cap)
        if self._reuse is not None and self._reuse[1] >= cap:
            tree, cap = self._reuse
        else:
            tree = self._start(cap)
            self._reuse = (tree, cap)
        done = int(tree.stats[0, 0, mcts.S_VISITS] + 0.5)
        self.last_tree = tree
        yield tree, done
        while done <= max_visits:
            target = min(done + max(int(interval_visits), 1), max_visits + 1)
            tree = self._continue(tree, cap, target)
            done = int(tree.stats[0, 0, mcts.S_VISITS] + 0.5)
            self._reuse = (tree, cap)
            self.last_tree = tree
            yield tree, done
            if done >= target and done > max_visits:
                break

    def search_stream(
        self,
        max_visits: int,
        interval_visits: int,
        avoid: np.ndarray | None = None,
        stop_check=None,
        avoid_until: np.ndarray | None = None,
    ):
        """Generator yielding (tree, visits_so_far) every `interval_visits`
        root visits until `max_visits`. `avoid` [A] bool masks root moves
        (avoidMoves/allowMoves); `avoid_until` [2,A] int32 extends the
        restriction into the descent: action a is excluded for player p at
        depth d while avoid_until[p-1, a] > d (avoidMoveUntilByLoc,
        searchexplorehelpers.cpp:395-421). `stop_check(tree, visits_so_far,
        visits_left)` returning True ends the search early (time management /
        futile visits)."""
        if self.game_over:
            raise ValueError("game is over")
        _warm_kernels(self.device)
        plain = avoid is None and avoid_until is None
        if plain and self._reuse is not None and self._reuse[1] >= self._bucket_cap(max_visits):
            # resume from the pondered/retained tree (see search())
            tree, cap = self._reuse
        elif plain and self.reuse_enabled:
            tree = None
            cap = max(self._bucket_cap(max_visits), self.min_reuse_cap)
        else:
            tree, cap = None, self._bucket_cap(max_visits)
        avoid_t = self._mask(avoid, bool)
        until_t = self._mask(avoid_until, np.int32)
        if tree is None:
            tree = self._start(cap, avoid_t, until_t)
            done = 1  # the root eval counts as one visit
        else:
            done = int(tree.stats[0, 0, mcts.S_VISITS] + 0.5)
            if done > max_visits:
                # ponder already met the budget: report the tree as-is
                self.last_tree = tree
                yield tree, done - 1
                return
        while done <= max_visits:
            target = min(done + max(int(interval_visits), 1), max_visits + 1)
            t0 = time.monotonic()
            tree = self._continue(tree, cap, target, until_t)
            self._sync()
            dt = max(time.monotonic() - t0, 1e-6)
            added = target - done
            if added >= 8 and self.visits_per_second is not None:
                self.visits_per_second = 0.7 * self.visits_per_second + 0.3 * (added / dt)
            elif added >= 8:
                self.visits_per_second = added / dt
            done = target
            self.last_tree = tree
            if self.reuse_enabled and plain:
                self._reuse = (tree, cap)
            yield tree, done - 1
            if stop_check is not None and done <= max_visits:
                if stop_check(tree, done - 1, max_visits + 1 - done):
                    break

    def root_policy_entropy(self, tree: mcts.Tree) -> float:
        """Entropy of the root's raw policy prior (getPolicySurprise context,
        searchresults.cpp; used by the obvious-move time discount)."""
        p = tree.prior[0, 0].cpu().numpy()
        p = np.where(p > 0, p, 0.0)
        s = p.sum()
        if s <= 0:
            return 0.0
        p = p / s
        return float(-(p[p > 0] * np.log(p[p > 0])).sum())

    def root_policy_surprise(self, tree: mcts.Tree) -> float:
        """KL(search visit distribution || raw policy prior) at the root:
        the reference's getPolicySurprise (searchresults.cpp:1447-1480)."""
        p = tree.prior[0, 0].cpu().numpy()
        ev = tree.edge_visits[0, 0].cpu().numpy().astype(np.float64)
        t = ev.sum()
        if t <= 0:
            return 0.0
        q = ev / t
        p = np.where(p > 0, p, 1e-30)
        p = p / p.sum()
        mask = q > 0
        return float((q[mask] * np.log(q[mask] / p[mask])).sum())

    def _choose(self, tree: mcts.Tree) -> int:
        return int(mcts.select_moves(self.cfg, self.sp, tree, generator=self.generator)[0])

    def _play_action(self, action: int):
        area = self.cfg.area
        d, spot = action // area, action % area
        self.play(spot % self.cfg.x_size, spot // self.cfg.x_size, d)

    def genmove_stream(
        self,
        max_visits: int,
        interval_visits: int,
        stop_check=None,
        avoid: np.ndarray | None = None,
        play: bool = True,
        on_report=None,
        avoid_until: np.ndarray | None = None,
    ) -> tuple[int, AnalysisResult]:
        """genmove over the chunked search: runs `search_stream` (so the host
        can apply time-management stop conditions via `stop_check` and emit
        kata-analyze interval reports via `on_report(tree, visits)`), then
        chooses and optionally plays the move (runWholeSearchAndGetMove +
        shouldStop polling)."""
        tree = None
        for tree, done in self.search_stream(
            max_visits, interval_visits, avoid=avoid, stop_check=stop_check, avoid_until=avoid_until,
        ):
            if on_report is not None:
                on_report(tree, done)
        action = self._choose(tree)
        result = self._extract_analysis(tree, avoid=avoid)
        if play:
            self._play_action(action)
        return action, result

    def genmove(
        self,
        max_visits: int,
        play: bool = True,
        avoid: np.ndarray | None = None,
        avoid_until: np.ndarray | None = None,
    ) -> tuple[int, AnalysisResult]:
        """Search + choose a move (getChosenMoveLoc semantics). Returns
        (flat action, analysis). Plays the move onto the board if `play`.
        `avoid` masks root moves (genmove_analyze avoid/allow);
        `avoid_until` [2,A] extends the restriction into the descent
        (avoidMoveUntilByLoc, see search_stream)."""
        tree = self.search(max_visits, avoid=avoid, avoid_until=avoid_until)
        action = self._choose(tree)
        result = self._extract_analysis(tree, avoid=avoid)
        if play:
            self._play_action(action)
        return action, result

    def analyze(
        self,
        max_visits: int,
        max_moves: int = 16,
        pv_len: int = 8,
        avoid: np.ndarray | None = None,
        avoid_until: np.ndarray | None = None,
    ) -> AnalysisResult:
        tree = self.search(max_visits, avoid=avoid, avoid_until=avoid_until)
        return self._extract_analysis(tree, max_moves=max_moves, pv_len=pv_len, avoid=avoid)

    # ------------------------------------------------------------------
    # Analysis extraction (searchresults.cpp getAnalysisData equivalents)
    # ------------------------------------------------------------------

    def _extract_analysis(self, tree: mcts.Tree, max_moves: int = 16, pv_len: int = 8,
                          avoid: np.ndarray | None = None) -> AnalysisResult:
        cfg = self.cfg
        h = mcts.host_tree(tree, 0)
        children, visits, edge_visits = h["children"], h["visits"], h["edge_visits"]
        wl, draw, util, usq = h["wl_avg"], h["draw_avg"], h["utility_avg"], h["utility_sq_avg"]
        wsum, wsq, prior = h["weight_sum"], h["weight_sq_sum"], h["root_prior"]

        root_child = children[0]  # [A]
        rows = []
        for a in np.where(root_child >= 0)[0]:
            ci = root_child[a]
            # per-edge visits: under transpositions a child's own visits can
            # exceed this root's exploration of it (childWeight scaling,
            # searchnode.h:59-64)
            v = int(edge_visits[0, a])
            escale = v / max(int(visits[ci]), 1)
            if v <= 0:
                continue
            # parent (root) perspective = negate child's mover values
            u = -float(util[ci])
            child_wl = -float(wl[ci])
            d_prob = float(draw[ci])
            var = max(float(usq[ci]) - float(util[ci]) ** 2, 1e-8)
            w = float(wsum[ci]) * escale
            ess = w * w / max(float(wsq[ci]) * escale, 1e-12)
            stdev = (var / max(ess, 1.0)) ** 0.5
            lcb = u - self.sp.lcbStdevs * stdev
            pv, pv_visits, pv_edge_visits = self._pv(children, visits, edge_visits, int(ci), int(a), v, pv_len)
            rows.append(
                MoveInfo(
                    action=int(a),
                    move=gio.action_to_string(int(a), cfg),
                    visits=v,
                    winrate=0.5 * (1.0 + child_wl),
                    draw_prob=d_prob,
                    utility=u,
                    lcb=lcb,
                    prior=float(max(prior[a], 0.0)),
                    order=0,
                    pv=pv,
                    pv_visits=pv_visits,
                    pv_edge_visits=pv_edge_visits,
                    weight=w,
                    node=int(ci),
                )
            )
        rows.sort(key=lambda r: (-r.visits, -r.utility))
        rows = self._duplicate_for_symmetries(rows, avoid)
        for i, r in enumerate(rows):
            r.order = i
        return AnalysisResult(
            root_visits=int(visits[0]),
            root_winrate=0.5 * (1.0 + float(wl[0])),
            root_draw_prob=float(draw[0]),
            root_utility=float(util[0]),
            move_infos=rows[:max_moves],
        )

    def print_tree(
        self,
        tree: mcts.Tree | None = None,
        max_depth: int = 3,
        min_visits: int = 1,
        max_children: int = 10,
        branch: list[int] | None = None,
    ) -> str:
        """Recursive search-tree dump, the role of the reference's
        Search::printTree (searchresults.cpp:1032+), behind GTP
        genmove_debug/search_debug. Per node: move, edge/node visits, winrate
        and utility from the root player's perspective, prior, weight sum;
        children sorted by edge visits. `branch` descends along the given
        flat actions first."""
        tree = tree if tree is not None else self.last_tree
        if tree is None:
            return "(no search tree)"
        cfg = self.cfg
        h = mcts.host_tree(tree, 0)
        children, edge_visits, visits = h["children"], h["edge_visits"], h["visits"]
        wl, util, wsum, prior = h["wl_avg"], h["utility_avg"], h["weight_sum"], h["prior"]

        node, sign = 0, 1.0  # sign: +1 when node mover == root mover
        lines = []
        if branch:
            for a in branch:
                ci = int(children[node][a])
                if ci < 0:
                    return f"(branch move {gio.action_to_string(int(a), cfg)} not in tree)"
                lines.append(f"branch: {gio.action_to_string(int(a), cfg)}")
                node, sign = ci, -sign

        def node_line(nd, s, label, edge_v):
            w = 0.5 * (1.0 + s * float(wl[nd]))
            u = s * float(util[nd])
            return f"{label} v={edge_v}/{int(visits[nd])} wr={w:.3f} u={u:+.3f} w={float(wsum[nd]):.1f}"

        lines.append(node_line(node, sign, "root:", int(visits[node])))

        def recurse(nd, s, depth, indent):
            if depth >= max_depth:
                return
            ev = edge_visits[nd]
            ch = children[nd]
            live = np.nonzero((ch >= 0) & (ev >= min_visits) & (ev > 0))[0]
            order = live[np.argsort(-ev[live], kind="stable")][:max_children]
            pr = prior[nd]
            for a in order:
                ci = int(ch[a])
                mv = gio.action_to_string(int(a), cfg)
                p = max(float(pr[a]), 0.0)
                lines.append(node_line(ci, -s, f"{indent}{mv:14s}", int(ev[a])) + f" p={p:.3f}")
                recurse(ci, -s, depth + 1, indent + "  ")

        recurse(node, sign, 0, "  ")
        return "\n".join(lines)

    def _duplicate_for_symmetries(self, rows: list[MoveInfo], avoid: np.ndarray | None) -> list[MoveInfo]:
        """Under rootSymmetryPruning, the search only visits one move per
        root-stabilizer orbit; re-expand the analysis rows over the orbit so
        consumers see every equivalent move, tagging duplicates with
        isSymmetryOf (getAnalysisData duplicateForSymmetries,
        searchresults.cpp:986-1015). Originals claim their orbit first (rows
        arrive sorted), PVs are symmetry-mapped, avoided moves skipped."""
        if not self.sp.rootSymmetryPruning or not rows:
            return rows
        stab = S.stabilizer(self.cfg, self.state)[0]
        if len(stab) <= 1:
            return rows
        table = S.action_table(self.cfg)  # [nsym, A]
        cfg = self.cfg

        def map_move_str(ms: str, s: int) -> str:
            x, y, d = gio.parse_loc(ms, cfg)
            return gio.action_to_string(int(table[s, d * cfg.area + y * cfg.x_size + x]), cfg)

        done: set[int] = set()
        out: list[MoveInfo] = []
        for mi in rows:
            for s in stab:
                sym_a = int(table[s, mi.action])
                if sym_a in done:
                    continue
                if avoid is not None and bool(np.asarray(avoid)[sym_a]):
                    continue
                done.add(sym_a)
                if s == 0:
                    out.append(mi)
                    continue
                out.append(
                    dataclasses.replace(
                        mi,
                        action=sym_a,
                        move=gio.action_to_string(sym_a, cfg),
                        pv=[map_move_str(m, s) for m in mi.pv],
                        is_symmetry_of=mi.move,
                        symmetry=s,
                    )
                )
        return out

    def _pv(
        self,
        children: np.ndarray,
        visits: np.ndarray,
        edge_visits: np.ndarray,
        node: int,
        first_action: int,
        first_edge_visits: int,
        pv_len: int,
    ) -> tuple[list[str], list[int], list[int]]:
        """Principal variation: follow max-edge-visits from `node`, tracking
        node/edge visits per step (searchresults.cpp appendPV + the
        pvVisits/pvEdgeVisits arrays it fills at :798-801)."""
        pv = [gio.action_to_string(first_action, self.cfg)]
        pv_visits = [int(visits[node])]
        pv_edge_visits = [int(first_edge_visits)]
        for _ in range(pv_len - 1):
            ch = children[node]
            ev = edge_visits[node]
            live = np.where((ch >= 0) & (ev > 0))[0]
            if live.size == 0:
                break
            best = live[np.argmax(ev[live])]
            pv.append(gio.action_to_string(int(best), self.cfg))
            node = int(ch[best])
            pv_visits.append(int(visits[node]))
            pv_edge_visits.append(int(ev[best]))
        return pv, pv_visits, pv_edge_visits
