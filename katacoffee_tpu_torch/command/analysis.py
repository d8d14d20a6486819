"""JSON-lines analysis engine: the port of `katacoffee_tpu/command/analysis.py`
(`AnalysisEngine`, `main`), searching on `device` (default `cuda`).

The frontend role of the reference's `cpp/command/analysis.cpp` (protocol
`docs/Analysis_Engine.md:1-60`): JSON queries on stdin (one per line), JSON
results on stdout. The positions of a query's `analyzeTurns` are the lanes
of ONE batched `run_search`, and the queue worker merges COMPATIBLE pending
queries (same board/rules, visit budget and resolved SearchParams;
non-streaming) into that one call, padding the lane count to a power of two
with idle `init_state` lanes, as the JAX engine does to reuse its compiled
shapes. Every lane carries its own `root_avoid` row and `avoid_until` rows.
Where the JAX engine compiles one search per (config, batch, visits,
params) and one pair per streaming node-capacity bucket, the port calls
`run_search` and `continue_search` eagerly at the same node capacities.

Query fields, actions and result fields are the JAX engine's (its module
docstring lists them): moves, initialStones, initialPlayer, board size and
rules, analyzeTurns, maxVisits (top level or in overrideSettings),
analysisPVLen, includeOwnership / includeOwnershipStdev /
includeMovesOwnership / includeMovesOwnershipStdev, includePolicy,
includePVVisits, rootPolicyTemperature / rootFpuReductionMax,
overrideSettings, avoidMoves / allowMoves, reportDuringSearchEvery,
priority / priorities; the actions query_version, clear_cache, terminate
and terminate_all. Random draws come from one `torch.Generator` on the
engine's device, seeded from `seed`.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import select
import sys
import time

import numpy as np
import torch

from katacoffee_tpu_torch import __version__ as VERSION
from katacoffee_tpu_torch.device import resolve_device
from katacoffee_tpu_torch.game import io as gio
from katacoffee_tpu_torch.game import symmetry as gsym
from katacoffee_tpu_torch.game.board import GameConfig, GameState, init_state, situation_hash, step
from katacoffee_tpu_torch.program.engine import _warm_kernels
from katacoffee_tpu_torch.program.setup import load_search_params
from katacoffee_tpu_torch.search import mcts, ownership
from katacoffee_tpu_torch.search.params import SearchParams
from katacoffee_tpu_torch.utils.config import ConfigParser
from katacoffee_tpu_torch.utils.logger import Logger

_SP_FIELDS = frozenset(f.name for f in dataclasses.fields(SearchParams))


def _parse_player(s: str) -> int:
    s = s.lower()
    if s in ("b", "black"):
        return 1
    if s in ("w", "white"):
        return 2
    raise ValueError(f"could not parse player: {s}")


def _cat(states: list[GameState]) -> GameState:
    """Batches of game states, one after the other along the batch axis."""
    return GameState(*(torch.cat(xs) for xs in zip(*states)))


def _query_cfg(query: dict) -> GameConfig:
    rules = query.get("rules", "coffee")
    win_len = int(rules.get("winLen", 4)) if isinstance(rules, dict) else 4
    return GameConfig(int(query.get("boardXSize", 5)), int(query.get("boardYSize", 5)), win_len)


def _query_visits(query: dict, default: int) -> int:
    # maxVisits may come top-level or via overrideSettings (the form the
    # reference's own analysis test queries use, tests/analysis/basic.txt)
    override = query.get("overrideSettings", {}) or {}
    return int(override.get("maxVisits", query.get("maxVisits", default)))


class AnalysisEngine:
    def __init__(
        self,
        search_params: SearchParams,
        eval_fn_factory=None,
        default_visits: int = 100,
        logger=None,
        raw_forward_factory=None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        """`eval_fn_factory(cfg) -> EvalFn` on `device` (None = uniform
        priors). `raw_forward_factory(cfg) -> (states -> model head dict)`
        enables the ownership output and the root's raw-net fields (None =
        omitted, as with debugSkipNeuralNet in the reference)."""
        self.device = resolve_device(device)
        self.sp = search_params
        self.factory = eval_fn_factory or mcts.uniform_eval_fn
        self.raw_forward_factory = raw_forward_factory
        self.default_visits = default_visits
        self.logger = logger
        # analysis.cpp:127-130 logging toggles (set from config in main())
        self.log_all_requests = False
        self.log_all_responses = False
        self.log_errors_and_warnings = True
        self.log_search_info = False
        self._eval_cache: dict[GameConfig, mcts.EvalFn] = {}
        self._raw_cache: dict[GameConfig, object] = {}
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # device-call counter (observability + tests of cross-query batching)
        self.num_search_calls = 0
        # streaming state: the smoothed visits/s that sizes a chunk, the
        # input poll between chunks and the in-flight query's terminate flag
        self._vps = 200.0
        self._poll_input = None
        self._current_qid = None
        self._current_terminated = False

    def _raw_forward(self, cfg: GameConfig):
        if self.raw_forward_factory is None:
            return None
        fn = self._raw_cache.get(cfg)
        if fn is None:
            fn = self.raw_forward_factory(cfg)
            self._raw_cache[cfg] = fn
        return fn

    def _eval_fn(self, cfg: GameConfig):
        fn = self._eval_cache.get(cfg)
        if fn is None:
            fn = self.factory(cfg)
            self._eval_cache[cfg] = fn
        return fn

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _query_params(self, query: dict) -> SearchParams:
        """Per-query SearchParams: overrideSettings may set ANY field
        (analysis.cpp applies Setup::loadParams over the per-query config;
        unknown keys are an error per the reference), plus the two top-level
        shorthands rootPolicyTemperature / rootFpuReductionMax."""
        override = dict(query.get("overrideSettings") or {})
        override.pop("maxVisits", None)  # handled as the visit budget
        for k in ("rootPolicyTemperature", "rootFpuReductionMax"):
            if k in query:
                override[k] = query[k]
        if not override:
            return self.sp
        bad = sorted(set(override) - _SP_FIELDS)
        if bad:
            raise ValueError(f"unknown overrideSettings key {bad[0]!r}")
        c = ConfigParser(
            text="",
            overrides={k: (str(v).lower() if isinstance(v, bool) else str(v)) for k, v in override.items()},
        )
        return load_search_params(c, self.sp)

    def _root_hashes(self, cfg: GameConfig, states: GameState) -> list[tuple[str, str]]:
        """(thisHash, symHash) hex strings of every state of the batch: the
        root situation hash and the minimum over its dihedral orbit
        (searchresults.cpp:1944-1958), in one host copy."""
        words = torch.stack(
            [situation_hash(cfg, gsym.apply_state(cfg, s, states)) for s in range(gsym.num_symmetries(cfg))]
        ).cpu().numpy()  # [nsym, B, 2], the uint32 words as int64
        out = []
        for b in range(words.shape[1]):
            strs = [f"{int(w[0]):08X}{int(w[1]):08X}" for w in words[:, b]]
            out.append((strs[0], min(strs)))
        return out

    def _parse_restrictions(self, query: dict, cfg: GameConfig):
        """avoidMoves/allowMoves -> per-player untilDepth array [2,A] int32
        (avoidMoveUntilByLocBlack/White, analysis.cpp:1030-1091): action a is
        excluded for player p while untilDepth > descent depth. avoidMoves
        entries assign their untilDepth to the listed moves; allowMoves (one
        entry only, exclusive with avoidMoves) fills the player's row with
        untilDepth then zeroes the listed moves. Returns None when the query
        carries no restrictions."""
        has_avoid = bool(query.get("avoidMoves"))
        has_allow = bool(query.get("allowMoves"))
        if not (has_avoid or has_allow):
            return None
        if has_avoid and has_allow:
            raise ValueError("cannot specify both allowMoves and avoidMoves")
        key_name, is_allow = ("allowMoves", True) if has_allow else ("avoidMoves", False)
        entries = query[key_name]
        if is_allow and len(entries) > 1:
            raise ValueError("currently allowMoves only allows one entry")
        until_by_loc = np.zeros((2, cfg.policy_size), np.int32)
        for entry in entries:
            pla = _parse_player(entry["player"])
            until = int(entry.get("untilDepth", 1))
            if until < 1:
                raise ValueError("untilDepth must be a positive integer")
            locs = []
            for mstr in entry["moves"]:
                x, y, d = gio.parse_loc(mstr, cfg)
                locs.append(d * cfg.area + y * cfg.x_size + x)
            if is_allow:
                until_by_loc[pla - 1, :] = until
                until_by_loc[pla - 1, locs] = 0
            else:
                until_by_loc[pla - 1, locs] = until
        return until_by_loc

    # ------------------------------------------------------------------

    def handle_query(self, query: dict):
        action = query.get("action")
        qid = query.get("id")
        if action == "query_version":
            return [{"id": qid, "action": "query_version", "version": VERSION}]
        if action == "clear_cache":
            self._eval_cache.clear()
            return [{"id": qid, "action": "clear_cache"}]
        if action in ("terminate", "terminate_all"):
            # when called directly (not through run()'s queue) there is
            # nothing pending to stop; echo the query per the protocol
            return [dict(query)]
        if qid is None:
            return [{"error": "missing id", "field": "id"}]

        try:
            return self._analyze_query(query)
        except (ValueError, KeyError, IndexError) as e:
            return [{"id": qid, "error": str(e)}]

    def _batch_key(self, query: dict) -> tuple:
        """(config, visit budget, resolved SearchParams): queries with equal
        keys can share one batched search. Raises on a malformed query."""
        return _query_cfg(query), _query_visits(query, self.default_visits), self._query_params(query)

    def _batch_compatible(self, query: dict, key0: tuple) -> bool:
        """Cheap pre-check (no position replay): can `query` share one
        batched device call with a query of batch key `key0`? Compatible =
        same board/rules config, visit budget, and resolved SearchParams,
        and not a streaming query."""
        if query.get("action") or query.get("reportDuringSearchEvery") is not None:
            return False
        try:
            rules = query.get("rules", "coffee")
            if isinstance(rules, str) and rules.lower() not in ("coffee", ""):
                return False
            return self._batch_key(query) == key0
        except (ValueError, KeyError, TypeError):
            return False

    def _prepare(self, query: dict) -> dict:
        """Everything before the device call: parse the query, replay the
        moves, split turns into pre-answered (errors, finished positions)
        and live-search lanes. Raises on malformed queries."""
        qid = query["id"]
        x_size = int(query.get("boardXSize", 5))
        y_size = int(query.get("boardYSize", 5))
        rules = query.get("rules", "coffee")
        win_len = 4
        if isinstance(rules, dict):
            win_len = int(rules.get("winLen", 4))
        elif isinstance(rules, str) and rules.lower() not in ("coffee", ""):
            raise ValueError(f"unknown rules {rules!r}")
        cfg = GameConfig(x_size, y_size, win_len)

        moves = query.get("moves", [])
        initial_stones = query.get("initialStones", [])
        initial_player = query.get("initialPlayer")
        max_visits = _query_visits(query, self.default_visits)
        sp_q = self._query_params(query)
        analyze_turns = query.get("analyzeTurns", [len(moves)])

        # build the position before each requested turn (B=1 states)
        board = np.zeros((cfg.y_size, cfg.x_size), np.int8)
        for pla_s, loc_s in initial_stones:
            x, y = gio.parse_spot(loc_s, cfg)
            board[y, x] = _parse_player(pla_s)
        st = init_state(cfg, 1, self.device)
        if initial_stones:
            st = st._replace(board=torch.from_numpy(board).to(self.device)[None])
        if initial_player is not None:
            st = st._replace(to_move=torch.full_like(st.to_move, _parse_player(initial_player)))

        states_by_turn: list[GameState] = [st]
        for pla_s, loc_s in moves:
            x, y, d = gio.parse_loc(loc_s, cfg)
            pla = _parse_player(pla_s)
            if pla != int(st.to_move[0]):
                # tolerate out-of-order colors by overriding to_move (the
                # reference errors; GUIs send alternating colors in practice)
                st = st._replace(to_move=torch.full_like(st.to_move, pla))
            a = d * cfg.area + y * cfg.x_size + x
            st = step(cfg, st, torch.tensor([a], dtype=torch.int64, device=self.device))
            states_by_turn.append(st)

        turns = [t for t in analyze_turns if 0 <= t < len(states_by_turn)]
        bad = [t for t in analyze_turns if not (0 <= t < len(states_by_turn))]
        pre = [{"id": qid, "turnNumber": t, "error": "turn out of range"} for t in bad]
        done = torch.cat([s.done for s in states_by_turn]).tolist()
        live = [t for t in turns if not done[t]]
        for t in turns:
            if done[t]:
                pre.append({"id": qid, "turnNumber": t, "noResults": True, "isDuringSearch": False})

        until_by_loc = self._parse_restrictions(query, cfg)
        avoid = np.zeros((len(live), cfg.policy_size), bool)
        avoid_until = np.zeros((len(live), 2, cfg.policy_size), np.int32)
        if until_by_loc is not None:
            avoid_until[:] = until_by_loc
            movers = torch.cat([states_by_turn[t].to_move for t in live]).tolist() if live else []
            for i, mover in enumerate(movers):
                avoid[i] = until_by_loc[mover - 1] > 0

        return {
            "query": query,
            "qid": qid,
            "cfg": cfg,
            "sp": sp_q,
            "max_visits": max_visits,
            "pre": pre,
            "live": live,
            "states_by_turn": states_by_turn,
            "avoid": avoid,
            "avoid_until": avoid_until,
            "report_every": query.get("reportDuringSearchEvery"),
        }

    def _log_search(self, qids, lanes: int, batch: str, visits: int, cfg: GameConfig):
        if self.logger is not None and self.log_search_info:
            self.logger.write(f"Search: queries={qids} lanes={lanes} {batch} visits={visits}"
                              f" board={cfg.x_size}x{cfg.y_size}w{cfg.win_len}")

    def _run_batch(self, preps: list[dict]) -> list[list[dict]]:
        """ONE batched device call over every live lane of every prep
        (all preps must share cfg / visit budget / SearchParams — the
        cross-QUERY batching role of the reference's numAnalysisThreads
        analysis threads, analysis.cpp:106-191: concurrent queries become
        lanes of one search). With several preps the lane count pads to a
        power of two (idle init_state lanes, with no restriction), as the
        JAX engine pads to reuse its compiled shapes; the padding lanes are
        searched like the others. Returns per-prep result lists, pre-answers
        included."""
        cfg = preps[0]["cfg"]
        sp_q = preps[0]["sp"]
        max_visits = preps[0]["max_visits"]
        lane_states = [p["states_by_turn"][t] for p in preps for t in p["live"]]
        lanes = len(lane_states)
        batch = lanes if len(preps) == 1 else max(1 << (lanes - 1).bit_length(), 1)
        pad = batch - lanes
        roots = _cat(lane_states + ([init_state(cfg, pad, self.device)] if pad else []))
        avoid = np.zeros((batch, cfg.policy_size), bool)
        avoid_until = np.zeros((batch, 2, cfg.policy_size), np.int32)
        row = 0
        for p in preps:
            n = len(p["live"])
            avoid[row: row + n] = p["avoid"]
            avoid_until[row: row + n] = p["avoid_until"]
            row += n
        self.num_search_calls += 1
        self._log_search([p["qid"] for p in preps], lanes, f"batch={batch}", max_visits, cfg)
        tree = mcts.run_search(
            cfg, sp_q, self._eval_fn(cfg), roots, max_visits, device=self.device, generator=self.generator,
            root_avoid=torch.from_numpy(avoid).to(self.device),
            avoid_until=torch.from_numpy(avoid_until).to(self.device),
        )
        extracted = self._extract_lanes(
            cfg, tree, sp_q, [(p["qid"], t, p["query"], p["states_by_turn"][t], p["avoid"][i])
                              for p in preps for i, t in enumerate(p["live"])])
        out: list[list[dict]] = []
        offset = 0
        for p in preps:
            n = len(p["live"])
            out.append(list(p["pre"]) + extracted[offset: offset + n])
            offset += n
        return out

    def _analyze_query(self, query: dict):
        prep = self._prepare(query)
        qid = prep["qid"]
        cfg = prep["cfg"]
        sp_q = prep["sp"]
        max_visits = prep["max_visits"]
        results = prep["pre"]
        live = prep["live"]
        if not live:
            return results

        report_every = prep["report_every"]
        if report_every is None:
            return self._run_batch([prep])[0]

        states_by_turn = prep["states_by_turn"]
        roots = _cat([states_by_turn[t] for t in live])
        avoid_t = torch.from_numpy(prep["avoid"]).to(self.device)
        until_t = torch.from_numpy(prep["avoid_until"]).to(self.device)
        lanes = [(qid, t, query, states_by_turn[t], prep["avoid"][i]) for i, t in enumerate(live)]

        # ---- streaming: interim isDuringSearch=true reports per chunk ----
        # every query concludes with exactly ONE isDuringSearch=false report
        # per turn, even when terminated mid-search (Analysis_Engine.md:316)
        def gen():
            yield from results
            _warm_kernels(self.device)
            # one node capacity a bucket serves every visit budget up to it
            # (the JAX engine's compiled-shape bucket)
            cap = 1 << max(6, int(max_visits + 2 - 1).bit_length())
            ev = self._eval_fn(cfg)
            self.num_search_calls += 1
            self._log_search([qid], len(live), "streaming", max_visits, cfg)
            tree = mcts.run_search(cfg, sp_q, ev, roots, 0, cap, device=self.device, generator=self.generator,
                                   root_avoid=avoid_t, avoid_until=until_t)
            done = 1
            vps = self._vps
            while done <= max_visits:
                if self._poll_input is not None:
                    self._poll_input()  # pick up terminate actions arriving mid-search
                if self._current_terminated:
                    break  # report partial results below
                chunk = max(8, int(float(report_every) * vps))
                target = min(done + chunk, max_visits + 1)
                t0 = time.monotonic()
                tree = mcts.continue_search(cfg, sp_q, ev, tree, cap, float(target), until_t,
                                            generator=self.generator)
                self._sync()
                dt = max(time.monotonic() - t0, 1e-6)
                vps = 0.7 * vps + 0.3 * ((target - done) / dt)
                self._vps = vps
                done = target
                if done <= max_visits:
                    for r in self._extract_lanes(cfg, tree, sp_q, lanes):
                        r["isDuringSearch"] = True
                        yield r
            for r in self._extract_lanes(cfg, tree, sp_q, lanes):
                r["isDuringSearch"] = False
                yield r

        return gen()

    def _dup_infos(self, infos, cfg, state, avoid_row, sp):
        """Re-expand analysis rows over the root stabilizer when
        rootSymmetryPruning concentrated the search on orbit representatives
        (getAnalysisData duplicateForSymmetries, searchresults.cpp:986-1015):
        duplicates carry isSymmetryOf, symmetry-mapped PVs and per-move
        ownership maps; avoided moves are skipped."""
        if not sp.rootSymmetryPruning or not infos:
            return infos
        stab = gsym.stabilizer(cfg, state)[0]
        if len(stab) <= 1:
            return infos
        table = gsym.action_table(cfg)

        def act(ms: str) -> int:
            x, y, d = gio.parse_loc(ms, cfg)
            return d * cfg.area + y * cfg.x_size + x

        done: set[int] = set()
        out = []
        for info in infos:
            a0 = act(info["move"])
            for s in stab:
                sa = int(table[s, a0])
                if sa in done:
                    continue
                if avoid_row is not None and bool(avoid_row[sa]):
                    continue
                done.add(sa)
                if s == 0:
                    out.append(info)
                    continue
                d2 = dict(info)
                d2["move"] = gio.action_to_compact(sa, cfg)
                d2["pv"] = [gio.action_to_compact(int(table[s, act(m)]), cfg) for m in info["pv"]]
                d2["isSymmetryOf"] = info["move"]
                shape = (cfg.y_size, cfg.x_size)
                for k in ("ownership", "ownershipStdev"):
                    if k in info:
                        # the JAX engine maps the plane as float32 (x64 off)
                        plane = torch.from_numpy(np.asarray(info[k], np.float32).reshape(shape))
                        d2[k] = [float(v) for v in gsym.apply_plane(s, plane).reshape(-1).numpy()]
                out.append(d2)
        return out

    def _extract_lanes(self, cfg, tree, sp, lanes) -> list[dict]:
        """One report per lane: `lanes` lists (qid, turn, query, root state,
        avoid row) for the tree's games 0, 1, ... (padding lanes after them
        get none). The tree's arrays, the root hashes and the raw net's root
        heads are each read to the host once for the whole batch."""
        host = mcts.host_tree(tree)
        roots = _cat([lane[3] for lane in lanes])
        hashes = self._root_hashes(cfg, roots)
        raw = self._raw_forward(cfg)
        heads = raw(roots) if raw is not None else None
        return [
            self._extract(qid, turn, cfg, tree, i, {k: v[i] for k, v in host.items()}, query, state, sp, avoid_row,
                          hashes[i], None if heads is None else {k: heads[k][i] for k in ("shortterm_error",
                                                                                          "var_time_left")})
            for i, (qid, turn, query, state, avoid_row) in enumerate(lanes)
        ]

    def _extract(self, qid, turn, cfg, tree, i, lane, query, state, sp, avoid_row, hashes, heads) -> dict:
        """Game i's report from `lane`, its arrays as `mcts.host_tree` copies
        them; `tree` (on the device) serves the ownership forward only."""
        children = lane["children"]
        visits = lane["visits"]
        edge_visits = lane["edge_visits"]
        wl = lane["wl_avg"]
        util = lane["utility_avg"]
        usq = lane["utility_sq_avg"]
        wsum = lane["weight_sum"]
        wsq = lane["weight_sq_sum"]
        prior = lane["root_prior"]

        # tree-averaged ownership maps, computed once per report when any
        # ownership option is on and a model is attached (search/ownership.py)
        own_maps = None
        want_own = bool(query.get("includeOwnership"))
        want_own_std = bool(query.get("includeOwnershipStdev"))
        want_mv_own = bool(query.get("includeMovesOwnership"))
        want_mv_std = bool(query.get("includeMovesOwnershipStdev"))
        if want_own or want_own_std or want_mv_own or want_mv_std:
            raw = self._raw_forward(cfg)
            if raw is not None:
                own_maps = ownership.node_ownership_maps(raw, tree, i)

        pv_cap = int(query.get("analysisPVLen", 10))
        infos = []
        root_child = children[0]
        for a in np.where(root_child >= 0)[0]:
            ci = root_child[a]
            v = int(edge_visits[0, a])
            if v <= 0:
                continue
            escale = v / max(int(visits[ci]), 1)
            u = -float(util[ci])
            var = max(float(usq[ci]) - float(util[ci]) ** 2, 1e-8)
            w = float(wsum[ci]) * escale
            ess = w * w / max(float(wsq[ci]) * escale, 1e-12)
            lcb_u = u - sp.lcbStdevs * (var / max(ess, 1.0)) ** 0.5
            # PV by max edge visits, with per-step node/edge visit counts
            # (searchresults.cpp:798-801 pvVisits/pvEdgeVisits)
            pv = [gio.action_to_compact(int(a), cfg)]
            pv_visits = [int(visits[ci])]
            pv_edge_visits = [v]
            node = int(ci)
            for _ in range(max(pv_cap - 1, 0)):
                ch = children[node]
                ev = edge_visits[node]
                live_a = np.where((ch >= 0) & (ev > 0))[0]
                if live_a.size == 0:
                    break
                best = live_a[np.argmax(ev[live_a])]
                pv.append(gio.action_to_compact(int(best), cfg))
                node = int(ch[best])
                pv_visits.append(int(visits[node]))
                pv_edge_visits.append(int(ev[best]))
            info = {
                "move": gio.action_to_compact(int(a), cfg),
                "visits": v,
                "weight": w,
                "winrate": 0.5 * (1.0 - float(wl[ci])),
                "prior": float(max(prior[a], 0.0)),
                "lcb": 0.5 * (1.0 + lcb_u),
                "utility": u,
                "utilityLcb": lcb_u,
                "pv": pv,
            }
            if query.get("includePVVisits"):
                info["pvVisits"] = pv_visits
                info["pvEdgeVisits"] = pv_edge_visits
            if own_maps is not None and (want_mv_own or want_mv_std):
                avg_m, std_m = ownership.tree_ownership(tree, i, own_maps, node=int(ci), want_stdev=want_mv_std,
                                                        host=lane)
                if want_mv_own:
                    info["ownership"] = [float(x) for x in avg_m]
                if want_mv_std:
                    info["ownershipStdev"] = [float(x) for x in std_m]
            infos.append(info)
        infos.sort(key=lambda r: (-r["visits"], -r["utility"]))
        infos = self._dup_infos(infos, cfg, state, avoid_row, sp)
        for order, r in enumerate(infos):
            r["order"] = order

        to_move = int(state.to_move[0])
        this_hash, sym_hash = hashes
        root_info = {
            "currentPlayer": "B" if to_move == 1 else "W",
            "visits": int(visits[0]),
            "weight": float(wsum[0]),
            "winrate": 0.5 * (1.0 + float(wl[0])),
            "utility": float(util[0]),
            "thisHash": this_hash,
            "symHash": sym_hash,
        }
        if heads is not None:
            # the raw net's own root uncertainty heads
            # (searchresults.cpp:1936-1942 rawStWrError/rawVarTimeLeft)
            root_info["rawStWrError"] = 0.5 * float(heads["shortterm_error"])
            root_info["rawVarTimeLeft"] = float(heads["var_time_left"])
        result = {
            "id": qid,
            "turnNumber": turn,
            "isDuringSearch": False,
            "moveInfos": infos,
            "rootInfo": root_info,
        }
        if query.get("includePolicy"):
            result["policy"] = [float(max(p, -1.0)) for p in prior]
        if own_maps is not None and (want_own or want_own_std):
            # tree-averaged ownership over the whole search, root-mover
            # perspective, row-major (searchresults.cpp:1983-2000)
            avg, std = ownership.tree_ownership(tree, i, own_maps, node=0, want_stdev=want_own_std, host=lane)
            if want_own:
                result["ownership"] = [float(v) for v in avg]
            if want_own_std:
                result["ownershipStdev"] = [float(v) for v in std]
        return result

    # ------------------------------------------------------------------
    # query scheduling (the reference's priority-ordered analysis threads,
    # analysis.cpp: highest `priority` first, FIFO within a priority; here a
    # single worker pops from a heap, and available input is drained between
    # queries / between streaming chunks so terminate actions take effect)
    # ------------------------------------------------------------------

    def _query_priority(self, query: dict, emit) -> int | None:
        if query.get("action"):
            return 0  # control actions keep FIFO order at default priority
        prios = query.get("priorities")
        if prios is not None:
            turns = query.get("analyzeTurns")
            if turns is None or len(prios) != len(turns):
                emit({
                    "id": query.get("id"),
                    "error": "priorities must be the same length as analyzeTurns",
                    "field": "priorities",
                })
                return None
            # deviation: all turns of a query run as ONE batched search, so
            # the query schedules at its highest per-turn priority
            return int(max(prios))
        return int(query.get("priority", 0))

    def _apply_terminate(self, query: dict, pending: list, emit):
        """terminate / terminate_all (Analysis_Engine.md:294-333): remove
        matching pending queries (each removed turn answers with
        noResults=true), flag a matching in-flight streamed query to stop
        after its current chunk, and echo the action query back. A
        turnNumbers restriction on the IN-FLIGHT query is ignored (its turns
        are lanes of one batched search) — pending queries honor it."""
        action = query["action"]
        tid = query.get("terminateId")
        if action == "terminate" and tid is None:
            emit({"id": query.get("id"), "error": "missing terminateId", "field": "terminateId"})
            return
        turns = query.get("turnNumbers")
        turnset = set(turns) if turns is not None else None
        kept = []
        for item in pending:
            q = item[2]
            if action == "terminate" and q.get("id") != tid:
                kept.append(item)
                continue
            qturns = q.get("analyzeTurns", [len(q.get("moves", []))])
            cut = [t for t in qturns if turnset is None or t in turnset]
            rest = [t for t in qturns if turnset is not None and t not in turnset]
            for t in cut:
                emit({"id": q.get("id"), "turnNumber": t, "isDuringSearch": False, "noResults": True})
            if rest:
                q2 = dict(q)
                q2["analyzeTurns"] = rest
                kept.append((item[0], item[1], q2))
        pending[:] = kept
        heapq.heapify(pending)
        cur = self._current_qid
        if cur is not None and (action == "terminate_all" or cur == tid):
            if turnset is None:
                self._current_terminated = True
        emit(dict(query))

    def run(self, infile=None, outfile=None):
        infile = infile or sys.stdin
        outfile = outfile or sys.stdout

        def emit(obj):
            line = json.dumps(obj)
            outfile.write(line + "\n")
            outfile.flush()
            if self.logger is not None:
                # analysis.cpp:241-261: error/warning responses log with
                # 'Error: '/'Warning: ' prefixes; 'Response: ' is the
                # log_all_responses echo of ordinary responses.
                if self.log_errors_and_warnings and "error" in obj:
                    self.logger.write("Error: " + line)
                elif self.log_errors_and_warnings and "warning" in obj:
                    self.logger.write("Warning: " + line)
                elif self.log_all_responses:
                    self.logger.write("Response: " + line)

        pending: list = []
        seq = 0
        interactive = infile is sys.stdin
        eof = False
        self._current_qid = None
        self._current_terminated = False

        def ingest(line: str):
            nonlocal seq
            line = line.strip()
            if not line:
                return
            if self.logger is not None and self.log_all_requests:
                self.logger.write("Request: " + line)
            try:
                query = json.loads(line)
            except json.JSONDecodeError as e:
                emit({"error": f"bad json: {e}"})
                return
            if query.get("action") in ("terminate", "terminate_all"):
                self._apply_terminate(query, pending, emit)
                return
            prio = self._query_priority(query, emit)
            if prio is None:
                return
            heapq.heappush(pending, (-prio, seq, query))
            seq += 1

        def drain_available():
            nonlocal eof
            if not interactive or eof:
                return
            try:
                while select.select([infile], [], [], 0)[0]:
                    line = infile.readline()
                    if line == "":
                        eof = True
                        return
                    ingest(line)
            except (OSError, ValueError):
                pass

        if not interactive:
            # scripts/files: ingest everything up front so priorities order
            # the whole batch of queries (deterministic, like the reference
            # queueing faster than its analysis threads drain)
            for line in infile:
                ingest(line)

        while True:
            drain_available()
            if not pending:
                if interactive and not eof:
                    line = infile.readline()  # block for more input
                    if line == "":
                        eof = True
                        continue
                    ingest(line)
                    continue
                break
            _, _, query = heapq.heappop(pending)

            # ---- cross-query batching: absorb compatible pending queries
            # into one device call (the reference's numAnalysisThreads
            # in-flight positions; here, lanes of one search) ----
            group = [query]
            if (
                query.get("action") is None
                and query.get("id") is not None
                and query.get("reportDuringSearchEvery") is None
                and pending
            ):
                try:
                    key0 = self._batch_key(query)
                except (ValueError, KeyError, TypeError):
                    key0 = None
                if key0 is not None:
                    rest = []
                    est_lanes = len(query.get("analyzeTurns", [0]))
                    for item in sorted(pending):
                        q2 = item[2]
                        if (
                            len(group) < 32
                            and est_lanes < 256
                            and q2.get("id") is not None
                            and self._batch_compatible(q2, key0)
                        ):
                            group.append(q2)
                            est_lanes += len(q2.get("analyzeTurns", [0]))
                        else:
                            rest.append(item)
                    pending[:] = rest
                    heapq.heapify(pending)

            if len(group) > 1:
                preps = []
                for q in group:
                    try:
                        p = self._prepare(q)
                    except (ValueError, KeyError, IndexError) as e:
                        emit({"id": q.get("id"), "error": str(e)})
                        continue
                    for r in p["pre"]:
                        emit(r)  # errors / finished-position answers
                    if p["live"]:
                        preps.append(p)
                if preps:
                    for p, per_query in zip(preps, self._run_batch(preps)):
                        for r in per_query[len(p["pre"]):]:  # pre already emitted
                            emit(r)
                continue

            self._current_qid = query.get("id")
            self._current_terminated = False
            self._poll_input = drain_available
            try:
                for result in self.handle_query(query):
                    emit(result)
            except (ValueError, KeyError, IndexError) as e:
                emit({"id": query.get("id"), "error": str(e)})
            finally:
                self._current_qid = None
                self._poll_input = None


def main(argv, search_params=None, eval_fn_factory=None, *, device: str | torch.device | None = None, **kw):
    """Entry for `python -m katacoffee_tpu_torch analysis` (JAX
    analysis.py:915): the engine over stdin/stdout on `device` (default
    `cuda`), its search params and logging from `-config` /
    `-override-config`."""
    import argparse

    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch analysis")
    ap.add_argument("-config", default=None)
    ap.add_argument("-override-config", default=None)
    args, _ = ap.parse_known_args(argv)

    sp = search_params or SearchParams.for_tests_v2()
    engine_kw = {}
    if args.config or args.override_config:
        c = ConfigParser(args.config, overrides=args.override_config) if args.config else ConfigParser(text="")
        if args.override_config and not args.config:
            c.apply_overrides(args.override_config)
        sp = load_search_params(c, sp)
        kw.setdefault("default_visits", c.get_int("maxVisits", 100))
        # logging + determinism surface (analysis.cpp:111-130): logFile /
        # logDir / logDirDated / logToStderr sinks, per-line toggles, and
        # forDeterministicTesting pinning the engine seed
        # analysis.cpp:116-118: logToStderrDefault=true for the analysis
        # engine — errors/warnings must reach stderr even with no sink keys.
        kw.setdefault("logger", Logger.from_config(c, default_to_stderr=True))
        engine_kw["log_all_requests"] = c.get_bool("logAllRequests", False)
        engine_kw["log_all_responses"] = c.get_bool("logAllResponses", False)
        engine_kw["log_errors_and_warnings"] = c.get_bool("logErrorsAndWarnings", True)
        engine_kw["log_search_info"] = c.get_bool("logSearchInfo", False)
        if not c.get_bool("forDeterministicTesting", False):
            import secrets

            kw.setdefault("seed", secrets.randbits(30))
        c.get_int("numAnalysisThreads", 1)  # accepted for compat: concurrent
        # queries batch into one device call here (see _run_batch)
        c.warn_unused(Logger(log_to_stderr=True))
    engine = AnalysisEngine(sp, eval_fn_factory, device=device, **kw)
    for k, v in engine_kw.items():
        setattr(engine, k, v)
    engine.run()
