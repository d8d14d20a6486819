"""GTP protocol engine for Coffee: the port of `katacoffee_tpu/command/gtp.py`
(`GTPEngine`, `main`), over the port's engine on `device` (default `cuda`).

The frontend role of the reference's `cpp/command/gtp.cpp` (GTPEngine,
gtp.cpp:318-534; command list gtp.cpp:20-100; protocol notes
`docs/GTP_Extensions.md`): a stdin/stdout GTP loop driving the host Engine,
so the framework can play on GTP servers (iggamecenter per the reference
README goal) and in GUIs.

Coffee moves on the wire are "<SPOT> <DIRECTION>", e.g. `play B C3 northwest`
and genmove responds `= C3 northwest` (GameIO::locToString, board.cpp:594).
Go-only commands (handicap, komi effects) are accepted-but-inert or report
errors exactly where meaningless; komi is stored and echoed for GUI
compatibility (the reference does the same for Coffee — komi has no effect).

lz-analyze/kata-analyze stream interval reports like the reference (the
search runs in chunks; between chunks the host emits an `info` line
and polls stdin so a newline or the next command stops the analysis —
gtp.cpp kata-analyze semantics). Deviation (documented): the analysis is
bounded by maxVisits rather than running forever; GUIs that stop analysis by
sending the next command see identical behavior. avoid/allow build the
per-player avoidMoveUntilByLoc depth arrays exactly like gtp.cpp:1591-1686
and gate the in-tree descent (searchexplorehelpers.cpp:395-421), with the
root mover's depth-0 row doubling as the root prior mask.
"""

from __future__ import annotations

import dataclasses
import io
import select
import sys
import time

import numpy as np

import torch

from katacoffee_tpu_torch import __version__ as VERSION
from katacoffee_tpu_torch.device import resolve_device
from katacoffee_tpu_torch.game import io as gio
from katacoffee_tpu_torch.game.board import GameConfig
from katacoffee_tpu_torch.program.engine import Engine, IllegalMoveError
from katacoffee_tpu_torch.search.params import SearchParams
from katacoffee_tpu_torch.search.timecontrols import (
    TimeControls,
    interpolate_early,
    is_search_futile,
    shaped_time_budget,
    visits_for_time,
)

KNOWN_COMMANDS = [
    "protocol_version",
    "name",
    "version",
    "known_command",
    "list_commands",
    "quit",
    "boardsize",
    "rectangular_boardsize",
    "clear_board",
    "set_position",
    "komi",
    "get_komi",
    "play",
    "undo",
    "kata-get-rules",
    "kata-set-rule",
    "kata-set-rules",
    "kata-get-param",
    "kata-set-param",
    "kata-list-params",
    "kgs-rules",
    "genmove",
    "genmove_debug",
    "search_debug",
    "clear_cache",
    "showboard",
    "fixed_handicap",
    "place_free_handicap",
    "set_free_handicap",
    "time_settings",
    "kgs-time_settings",
    "time_left",
    "kata-list_time_settings",
    "kata-time_settings",
    "final_score",
    "final_status_list",
    "loadsgf",
    "printsgf",
    "lz-genmove_analyze",
    "kata-genmove_analyze",
    "lz-analyze",
    "kata-analyze",
    "kata-raw-nn",
    "cputime",
    "gomill-cpu_time",
    "kata-benchmark",
    "debug_moves",
    "stop",
]


_GENMOVE_CMDS = {
    "genmove", "genmove_debug", "genmove_analyze",
    "lz-genmove_analyze", "kata-genmove_analyze",
}


def _is_genmove_line(line: str) -> bool:
    toks = line.split()
    if toks and toks[0].isdigit():  # optional GTP id prefix
        toks = toks[1:]
    return bool(toks) and toks[0] in _GENMOVE_CMDS


def _parse_player(s: str) -> int:
    s = s.lower()
    if s in ("b", "black"):
        return 1
    if s in ("w", "white"):
        return 2
    raise ValueError(f"could not parse player: {s}")


class GTPEngine:
    def __init__(
        self,
        cfg: GameConfig,
        search_params: SearchParams,
        eval_fn=None,
        max_visits: int = 100,
        logger=None,
        name: str = "KataCoffee-TPU",
        seed: int = 0,
        raw_fwd=None,
        ponder_enabled: bool = False,
        max_visits_pondering: int | None = None,
        device: str | torch.device | None = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.sp = search_params
        self.eval_fn = eval_fn
        self.max_visits = max_visits
        self.logger = logger
        self.name = name
        self.seed = seed
        # full-head forward (states -> dict of numpy heads, on the engine's
        # device) for kata-raw-nn and the ownership output; None (no model)
        # omits ownership like the reference with debugSkipNeuralNet
        self.raw_fwd = raw_fwd
        self.komi = 0.0
        # Pondering (gtp_example.cfg:290-296 ponderingEnabled /
        # maxVisitsPondering; AsyncBot ponder path): after a genmove reply,
        # keep searching the current position in visit chunks while stdin is
        # idle; the retained tree is advanced through played moves and the
        # next genmove resumes from it (tree reuse), cutting its latency.
        # maxVisitsPondering bounds the node arrays the chunks run in (the
        # reference's is time-bounded instead; a visit bound is what a
        # fixed node capacity allows). Default 4x the move budget.
        self.ponder_enabled = bool(ponder_enabled)
        self.max_visits_pondering = int(max_visits_pondering or 4 * max_visits)
        self._ponder_last = 0  # root visits reached by the last ponder
        self.engine = self._new_engine()
        self.time_controls = {1: TimeControls(), 2: TimeControls()}
        self.cpu_time = 0.0
        self._io = None  # (infile, outfile) while run() is active
        self._cmd_id = ""
        self._already_responded = False
        # gtp.cpp `logAllGTPCommunication` (gtp_example.cfg:30): log every
        # controller line and engine response to the configured sinks
        self.log_all_gtp = True

    def _new_engine(self) -> Engine:
        eng = Engine(self.cfg, self.sp, self.eval_fn, seed=self.seed, device=self.device)
        if self.ponder_enabled:
            eng.reuse_enabled = True
            eng.min_reuse_cap = Engine._bucket_cap(
                max(self.max_visits, self.max_visits_pondering)
            )
        return eng

    def _maybe_ponder(self, infile) -> int:
        """Run ponder chunks on the current position until new input arrives
        (select-polled between chunks), the ponder visit budget is
        met, or the game is over. Returns the root visit count reached (0 if
        pondering did not run). Called by run() after a genmove response —
        the reference's `bot->ponder()` site (gtp.cpp genmove handling)."""
        if not self.ponder_enabled or self.engine.game_over:
            return 0

        def input_waiting() -> bool:
            try:
                r, _, _ = select.select([infile], [], [], 0.0)
                return bool(r)
            except (OSError, ValueError, io.UnsupportedOperation):
                # not a selectable stream (e.g. a StringIO in a test):
                # treat input as always-pending so pondering never blocks
                return True

        done = 0
        for _tree, done in self.engine.ponder_stream(
            self.max_visits_pondering, interval_visits=max(1, self.max_visits // 4)
        ):
            if input_waiting():
                break
        return done

    def log(self, msg: str):
        if self.logger is not None:
            self.logger.write(msg)

    # ------------------------------------------------------------------

    def _lag_buffer(self) -> float:
        """Configured lagBuffer (searchparams.h:151 role) or the default
        safety margin when unset."""
        return self.sp.lagBuffer if self.sp.lagBuffer > 0 else 0.2

    def _visit_budget(self, pla: int) -> int:
        """Clock -> shaped time budget -> visit target for this move, or
        max_visits under no time pressure (the recomputeSearchTimeLimit ->
        visit-cap adapter, shared by genmove and genmove_analyze)."""
        budget = self.time_controls[pla].time_for_move(lag_buffer=self._lag_buffer())
        vps = self.engine.visits_per_second
        if budget == float("inf") or vps is None:
            return self.max_visits
        turn = len(self.engine.move_history)
        shaped = shaped_time_budget(self.sp, budget, turn, self.cfg.area)
        return visits_for_time(shaped, vps, self.max_visits)

    def _genmove(self, pla: int, debug: bool = False, play: bool = True) -> str:
        if pla != self.engine.to_move:
            raise IllegalMoveError("genmove for the player not to move")
        if self.engine.game_over:
            return "resign"  # no legal moves for us (game already decided)
        tc = self.time_controls[pla]
        budget = tc.time_for_move(lag_buffer=self._lag_buffer())
        vps = self.engine.visits_per_second
        t0 = time.monotonic()
        if budget == float("inf") or vps is None:
            action, result = self.engine.genmove(self.max_visits, play=play)
        else:
            # recomputeSearchTimeLimit's shaping (searchtimehelpers.cpp:37-140)
            # adapted to the visit-bounded engine: budget -> shaped budget ->
            # visit target, with the obvious-move discount and futile-visits
            # stop re-evaluated between chunks.
            sp = self.sp
            turn = len(self.engine.move_history)
            shaped = shaped_time_budget(sp, budget, turn, self.cfg.area)
            target = visits_for_time(shaped, vps, self.max_visits)
            chunk = max(8, target // 4)
            temp = interpolate_early(
                sp.chosenMoveTemperatureHalflife,
                sp.chosenMoveTemperatureEarly,
                sp.chosenMoveTemperature,
                turn,
            )

            def stop_check(tree, done, left):
                if sp.obviousMovesTimeFactor < 1.0:
                    ent = self.engine.root_policy_entropy(tree)
                    sur = self.engine.root_policy_surprise(tree)
                    shaped2 = shaped_time_budget(sp, budget, turn, self.cfg.area, ent, sur)
                    if done >= visits_for_time(shaped2, vps, self.max_visits):
                        return True
                if sp.futileVisitsThreshold > 0:
                    ev = tree.edge_visits[0, 0].cpu().numpy()
                    counts = ev[ev > 0].tolist()
                    if is_search_futile(sp, counts, counts, float(left), temp):
                        return True
                return False

            action, result = self.engine.genmove_stream(
                target, chunk, stop_check=stop_check, play=play
            )
        dt = time.monotonic() - t0
        self.cpu_time += dt
        self.time_controls[pla].update_after_move(dt)
        if debug:
            for mi in result.move_infos[:8]:
                print(
                    f"{mi.move}: v={mi.visits} wr={mi.winrate:.3f} "
                    f"prior={mi.prior:.3f} pv={' '.join(mi.pv)}",
                    file=sys.stderr,
                )
            # recursive tree dump (the reference's printTree behind
            # genmove_debug/search_debug, gtp.cpp searchPrint role)
            print(self.engine.print_tree(max_depth=2), file=sys.stderr)
        return gio.action_to_string(action, self.cfg)

    def _parse_analyze_args(self, args: list[str]) -> dict:
        """Parse lz-analyze/kata-analyze args (gtp.cpp parseAnalyzeCommand):
        [player] [interval-centiseconds] plus keyed options interval N,
        avoid/allow PLAYER MOVES UNTILDEPTH, minmoves/maxmoves N (other
        kata keys are accepted and ignored). avoid/allow build per-player
        untilDepth arrays exactly like gtp.cpp:1591-1686: `avoid` assigns
        UNTILDEPTH to the listed moves; `allow` fills the player's whole
        row with UNTILDEPTH then zeroes the listed moves; a player may not
        mix allow with avoid or receive two allows."""
        pla = self.engine.to_move
        interval = None  # seconds between reports
        avoid_until = np.zeros((2, self.cfg.policy_size), np.int32)
        got_avoid = [False, False]
        got_allow = [False, False]
        have_restrictions = False
        maxmoves = 16
        ownership = False
        ownership_stdev = False
        moves_ownership = False
        moves_ownership_stdev = False
        pv_visits = False
        pv_edge_visits = False
        toks = list(args)
        i = 0
        if toks and toks[0].lower() in ("b", "black", "w", "white"):
            pla = _parse_player(toks[0])
            i = 1
        while i < len(toks):
            t = toks[i].lower()
            if t == "interval" and i + 1 < len(toks):
                interval = float(toks[i + 1]) / 100.0
                i += 2
            elif t in ("avoid", "allow") and i + 3 < len(toks):
                p2 = _parse_player(toks[i + 1])
                locs = []
                for mstr in toks[i + 2].split(","):
                    if not mstr.strip():
                        continue
                    x, y, d = gio.parse_loc(mstr, self.cfg)
                    locs.append(d * self.cfg.area + y * self.cfg.x_size + x)
                until = int(toks[i + 3])
                if until < 1:
                    raise ValueError("untilDepth must be a positive integer")
                row = p2 - 1
                if (t == "allow" and (got_avoid[row] or got_allow[row])) or (
                    t == "avoid" and got_allow[row]
                ):
                    raise ValueError(
                        "cannot mix allow with avoid/allow for the same player"
                    )
                if t == "allow":
                    avoid_until[row, :] = until
                    avoid_until[row, locs] = 0
                    got_allow[row] = True
                else:
                    avoid_until[row, locs] = until
                    got_avoid[row] = True
                have_restrictions = True
                i += 4
            elif t in ("minmoves", "maxmoves") and i + 1 < len(toks):
                if t == "maxmoves":
                    maxmoves = int(toks[i + 1])
                i += 2
            elif t == "ownership" and i + 1 < len(toks):
                ownership = toks[i + 1].lower() == "true"
                i += 2
            elif t == "pvvisits" and i + 1 < len(toks):
                pv_visits = toks[i + 1].lower() == "true"
                i += 2
            elif t == "pvedgevisits" and i + 1 < len(toks):
                pv_edge_visits = toks[i + 1].lower() == "true"
                i += 2
            elif t == "ownershipstdev" and i + 1 < len(toks):
                ownership_stdev = toks[i + 1].lower() == "true"
                i += 2
            elif t == "movesownership" and i + 1 < len(toks):
                moves_ownership = toks[i + 1].lower() == "true"
                i += 2
            elif t == "movesownershipstdev" and i + 1 < len(toks):
                moves_ownership_stdev = toks[i + 1].lower() == "true"
                i += 2
            elif t == "rootinfo" and i + 1 < len(toks):
                i += 2  # accepted, not reported (newer-KataGo option; N/A here)
            elif t.replace(".", "", 1).isdigit() and interval is None:
                interval = float(t) / 100.0  # bare CENTISECONDS shorthand
                i += 1
            else:
                raise ValueError(f"could not parse analyze argument {toks[i]!r}")
        # the root mover's depth-0 restriction doubles as the root prior mask
        avoid = (avoid_until[pla - 1] > 0) if have_restrictions else None
        return {
            "pla": pla, "interval": interval, "avoid": avoid,
            "avoid_until": avoid_until if have_restrictions else None,
            "maxmoves": maxmoves, "ownership": ownership,
            "ownership_stdev": ownership_stdev,
            "moves_ownership": moves_ownership,
            "moves_ownership_stdev": moves_ownership_stdev,
            "pv_visits": pv_visits, "pv_edge_visits": pv_edge_visits,
        }

    def _run_analyze(self, spec: dict, genmove: bool = False) -> str:
        """Run (and stream, when an interval is set) an analysis; returns the
        response text for one-shot mode or "" after writing a streamed
        response itself. With `genmove`, finishes by choosing + playing a
        move (lz/kata-genmove_analyze)."""
        pla = spec["pla"]
        flipped_from = None
        if pla != self.engine.to_move and not genmove:
            # analyze from the other player's perspective (reference supports
            # this by re-rooting with the requested player to move); restored
            # after the analysis so the game state is untouched
            flipped_from = self.engine.to_move
            self.engine.set_to_move(pla)
        try:
            return self._run_analyze_inner(spec, genmove)
        finally:
            if flipped_from is not None:
                self.engine.set_to_move(flipped_from)

    def _run_analyze_inner(self, spec: dict, genmove: bool) -> str:
        pla = spec["pla"]
        interval = spec["interval"]
        # genmove_analyze obeys the clock exactly like genmove
        visits = self._visit_budget(pla) if genmove else self.max_visits
        infile, outfile = self._io if self._io is not None else (None, None)
        if interval is None or outfile is None:
            if genmove:
                t0 = time.monotonic()
                action, result = self.engine.genmove(
                    visits, play=True, avoid=spec["avoid"],
                    avoid_until=spec["avoid_until"],
                )
                dt = time.monotonic() - t0
                self.cpu_time += dt
                self.time_controls[pla].update_after_move(dt)
                return self._analyze_response(
                    result, spec, self.engine.last_tree
                ) + f"\nplay {gio.action_to_compact(action, self.cfg)}"
            result = self.engine.analyze(
                self.max_visits, max_moves=spec["maxmoves"], avoid=spec["avoid"],
                avoid_until=spec["avoid_until"],
            )
            return self._analyze_response(result, spec, self.engine.last_tree)

        # ---- streaming: write the GTP response directly ----
        outfile.write("=" + self._cmd_id + "\n")
        outfile.flush()

        def stdin_ready() -> bool:
            if infile is not sys.stdin:
                return False
            try:
                return bool(select.select([infile], [], [], 0)[0])
            except (OSError, ValueError):
                return False

        vps = self.engine.visits_per_second or 200.0
        chunk = max(8, int(interval * vps))
        interrupted = False

        def stop_check(tree, done, left):
            nonlocal interrupted
            if stdin_ready():
                interrupted = True
                return True
            return False

        def report(tree, done):
            result = self.engine._extract_analysis(
                tree, max_moves=spec["maxmoves"], avoid=spec["avoid"]
            )
            outfile.write(self._analyze_response(result, spec, tree) + "\n")
            outfile.flush()

        if genmove:
            t0 = time.monotonic()
            action, result = self.engine.genmove_stream(
                visits, chunk, stop_check=stop_check,
                avoid=spec["avoid"], play=True, on_report=report,
                avoid_until=spec["avoid_until"],
            )
            dt = time.monotonic() - t0
            self.cpu_time += dt
            self.time_controls[pla].update_after_move(dt)
            outfile.write(f"play {gio.action_to_compact(action, self.cfg)}\n")
        else:
            tree = None
            for tree, done in self.engine.search_stream(
                self.max_visits, chunk, avoid=spec["avoid"], stop_check=stop_check,
                avoid_until=spec["avoid_until"],
            ):
                report(tree, done)
        outfile.write("\n")
        outfile.flush()
        self._already_responded = True
        return ""

    def _raw_nn(self, which: str) -> str:
        """`kata-raw-nn SYMMETRY` (0-7 or 'all'): the raw net evaluation of
        the current position under the given dihedral symmetry, inverse-
        transformed back to board orientation (gtp.cpp:1474-1546 rawNN,
        Coffee-adapted: win/loss/draw replaces win/loss/noResult+score, the
        policy prints one grid per direction, there is no pass). Without a
        model, falls back to a 2-visit search brief (debugSkipNeuralNet
        role)."""
        if self.raw_fwd is None:
            result = self.engine.analyze(2)
            lines = [f"winrate {result.root_winrate:.6f}", "policy"]
            prior = {mi.move: mi.prior for mi in result.move_infos}
            lines.extend(f"{m.replace(' ', '')} {p:.6f}" for m, p in prior.items())
            return "\n".join(lines)

        from katacoffee_tpu_torch.game import symmetry as S
        from katacoffee_tpu_torch.game.board import legal_mask_flat
        from katacoffee_tpu_torch.search.mcts import _softmax

        cfg = self.cfg
        nsym = S.num_symmetries(cfg)
        if which.lower() == "all":
            syms = list(range(nsym))
        else:
            syms = [int(which)]
            if not 0 <= syms[0] < nsym:
                raise ValueError(f"symmetry must be 0-{nsym - 1} or 'all'")
        # the position's symmetries and legal mask on the host: a position
        # the cache holds then runs nothing on the device
        state = self.engine.state.map(lambda x: x.cpu())
        to_move = self.engine.to_move
        blocks = []
        for sym in syms:
            st = S.apply_state(cfg, sym, state)
            heads = self.raw_fwd(st)
            # policy: legal-masked softmax in the transformed frame, then
            # inverted back so grids align with the real board
            legal = legal_mask_flat(cfg, st).cpu()
            logits = torch.where(legal, torch.from_numpy(heads["policy_logits"]), -torch.inf)
            pol = torch.where(legal, _softmax(logits), -1.0)
            pol = S.apply_policy(cfg, S.invert(sym), pol)[0].numpy()
            probs = _softmax(torch.from_numpy(heads["value_logits"][0])).numpy()
            win, loss, draw = float(probs[0]), float(probs[1]), float(probs[2])
            if to_move == 1:  # black to move: mover -> white perspective
                win, loss = loss, win
            own = np.tanh(S.apply_plane(S.invert(sym), torch.from_numpy(heads["ownership"][0])).numpy())
            if to_move == 1:
                own = -own
            out = [
                f"symmetry {sym}",
                f"whiteWin {win:.6f}",
                f"whiteLoss {loss:.6f}",
                f"whiteDraw {draw:.6f}",
                f"varTimeLeft {float(heads['var_time_left'][0]):.3f}",
                f"shorttermWinlossError {float(heads['shortterm_error'][0]):.3f}",
            ]
            for d in range(4):
                out.append(f"policy {gio.direction_to_string(d)}")
                grid = pol[d * cfg.area : (d + 1) * cfg.area].reshape(cfg.y_size, cfg.x_size)
                for row in grid:
                    out.append(" ".join("     NAN" if p < 0 else f"{p:8.6f}" for p in row))
            out.append("whiteOwnership")
            for row in own:
                out.append(" ".join(f"{v:9.7f}" for v in row))
            blocks.append("\n".join(out))
        return "\n\n".join(blocks)

    def _tree_own_maps(self, tree) -> "np.ndarray | None":
        """Per-node net ownership maps for the last search's tree (game 0),
        root-mover perspective — None when no model is attached or no tree
        is available (search/ownership.py)."""
        if self.raw_fwd is None or tree is None:
            return None
        from katacoffee_tpu_torch.search import ownership as town

        return town.node_ownership_maps(self.raw_fwd, tree, 0)

    def _ownership_suffix(self, spec: dict, tree, own_maps) -> str:
        """' ownership v1..vN [ownershipStdev v1..vN]' — TREE-AVERAGED maps
        (the reference's getAverageTreeOwnership, gtp.cpp:826-833 /
        searchresults.cpp:1566-1612), root-mover perspective, row-major.
        Empty when no model is attached."""
        want = spec.get("ownership")
        want_std = spec.get("ownership_stdev")
        if not (want or want_std) or own_maps is None:
            return ""
        from katacoffee_tpu_torch.search import ownership as town

        avg, std = town.tree_ownership(tree, 0, own_maps, 0, want_stdev=bool(want_std))
        s = ""
        if want:
            s += " ownership " + " ".join(f"{v:.4f}" for v in avg)
        if want_std:
            s += " ownershipStdev " + " ".join(f"{v:.4f}" for v in std)
        return s

    def _analyze_response(self, result, spec: dict, tree=None) -> str:
        """Full analyze report: info blocks + whole-search ownership suffix.
        Computes the per-node ownership maps at most once per report."""
        own_maps = None
        if tree is not None and (
            spec.get("ownership") or spec.get("ownership_stdev")
            or spec.get("moves_ownership") or spec.get("moves_ownership_stdev")
        ):
            own_maps = self._tree_own_maps(tree)
        return self._analyze_line(result, spec, tree, own_maps) + self._ownership_suffix(
            spec, tree, own_maps
        )

    def _analyze_line(self, result, spec: dict | None = None, tree=None, own_maps=None) -> str:
        """One `info` report in lz/kata-analyze format (gtp.cpp:864-937;
        utilityLcb/weight per the kata variant, pvVisits/pvEdgeVisits per
        GTP_Extensions.md, movesOwnership[Stdev] = per-move subtree-averaged
        ownership when requested)."""
        parts = []
        spec = spec or {}
        want_mv = spec.get("moves_ownership")
        want_mv_std = spec.get("moves_ownership_stdev")
        for mi in result.move_infos:
            mv = gio.action_to_compact(mi.action, self.cfg)
            pv = " ".join(
                gio.loc_to_compact(*gio.parse_loc(m, self.cfg), self.cfg) for m in mi.pv
            )
            sym_of = (
                " isSymmetryOf "
                + gio.loc_to_compact(*gio.parse_loc(mi.is_symmetry_of, self.cfg), self.cfg)
                if mi.is_symmetry_of
                else ""
            )
            line = (
                f"info move {mv} visits {mi.visits} "
                f"winrate {mi.winrate:.6f} prior {mi.prior:.6f} lcb {max(min(mi.lcb*0.5+0.5,1.0),0.0):.6f} "
                f"utility {mi.utility:.6f} utilityLcb {mi.lcb:.6f} "
                f"weight {mi.weight:.3f}{sym_of} order {mi.order} "
                f"pv {pv}"
            )
            if spec.get("pv_visits"):
                line += " pvVisits " + " ".join(str(v) for v in mi.pv_visits)
            if spec.get("pv_edge_visits"):
                line += " pvEdgeVisits " + " ".join(str(v) for v in mi.pv_edge_visits)
            if own_maps is not None and (want_mv or want_mv_std) and mi.node >= 0:
                from katacoffee_tpu_torch.search import ownership as town

                avg_m, std_m = town.tree_ownership(
                    tree, 0, own_maps, node=mi.node, want_stdev=bool(want_mv_std)
                )
                if mi.symmetry:
                    # duplicated row: its map is the original subtree's map
                    # transformed by the duplicating symmetry
                    from katacoffee_tpu_torch.game import symmetry as S

                    shape = (self.cfg.y_size, self.cfg.x_size)
                    avg_m = S.apply_plane(mi.symmetry, torch.from_numpy(avg_m.reshape(shape))).numpy().reshape(-1)
                    if std_m is not None:
                        std_m = S.apply_plane(mi.symmetry, torch.from_numpy(std_m.reshape(shape))).numpy().reshape(-1)
                if want_mv:
                    line += " movesOwnership " + " ".join(f"{v:.4f}" for v in avg_m)
                if want_mv_std:
                    line += " movesOwnershipStdev " + " ".join(f"{v:.4f}" for v in std_m)
            parts.append(line)
        return " ".join(parts)

    # ------------------------------------------------------------------

    def handle(self, line: str):
        """Process one GTP line. Returns (response_str or None-for-quit)."""
        line = line.split("#", 1)[0].strip()
        if not line:
            return ""
        pieces = line.split()
        cmd_id = ""
        if pieces[0].isdigit():
            cmd_id = pieces[0]
            pieces = pieces[1:]
            if not pieces:
                return (f"?{cmd_id} no command", False)
        cmd, args = pieces[0], pieces[1:]

        self._cmd_id = cmd_id
        self._already_responded = False
        try:
            ok, resp, quit_ = self._dispatch(cmd, args)
        except (ValueError, IllegalMoveError) as e:
            ok, resp, quit_ = False, str(e), False
        except OSError as e:  # loadsgf/printsgf file errors (gtp.cpp responds "?")
            ok, resp, quit_ = False, f"could not open file: {e}", False
        if self._already_responded:
            return ""  # streamed commands write their own response

        prefix = ("=" if ok else "?") + cmd_id
        out = f"{prefix} {resp}".rstrip() if resp else prefix
        return (out, quit_)

    def _dispatch(self, cmd: str, args: list[str]):
        cfg = self.cfg
        ok, resp, quit_ = True, "", False

        if cmd == "protocol_version":
            resp = "2"
        elif cmd == "name":
            resp = self.name
        elif cmd == "version":
            resp = VERSION
        elif cmd == "known_command":
            resp = "true" if args and args[0] in KNOWN_COMMANDS else "false"
        elif cmd == "list_commands":
            resp = "\n".join(KNOWN_COMMANDS)
        elif cmd == "quit":
            quit_ = True
        elif cmd in ("boardsize", "rectangular_boardsize"):
            if len(args) == 1 and ":" in args[0]:
                x, y = (int(v) for v in args[0].split(":"))
            elif len(args) == 1:
                x = y = int(args[0])
            elif len(args) == 2:
                x, y = int(args[0]), int(args[1])
            else:
                raise ValueError("expected boardsize X, X:Y, or X Y")
            if not (2 <= x <= 19 and 2 <= y <= 19):
                raise ValueError("unacceptable size")
            self.cfg = GameConfig(x, y, self.cfg.win_len)
            self.engine = self._new_engine()
        elif cmd == "clear_board":
            self.engine.clear_board()
        elif cmd == "set_position":
            if len(args) % 2 != 0:
                raise ValueError("expected <COLOR> <VERTEX> pairs")
            board = np.zeros((self.cfg.y_size, self.cfg.x_size), np.int8)
            for i in range(0, len(args), 2):
                pla = _parse_player(args[i])
                x, y = gio.parse_spot(args[i + 1], self.cfg)
                if board[y, x] != 0:
                    raise ValueError("Illegal stone placements - overlapping stones")
                board[y, x] = pla
            self.engine.set_position(board, to_move=1)
        elif cmd == "komi":
            self.komi = float(args[0])  # stored only; komi has no effect in Coffee
        elif cmd == "get_komi":
            resp = str(self.komi)
        elif cmd == "play":
            if len(args) < 2:
                raise ValueError("expected: play <COLOR> <SPOT> <DIRECTION>")
            pla = _parse_player(args[0])
            x, y, d = gio.parse_loc(" ".join(args[1:]), self.cfg)
            self.engine.play(x, y, d, pla)
        elif cmd == "undo":
            self.engine.undo()
        elif cmd == "kata-get-rules":
            resp = f'{{"game":"coffee","winLen":{self.cfg.win_len}}}'
        elif cmd in ("kata-set-rules", "kata-set-rule"):
            # only the winLen rule exists; accept "coffee" or winLen updates
            if cmd == "kata-set-rule" and len(args) == 2 and args[0] == "winLen":
                self.cfg = GameConfig(self.cfg.x_size, self.cfg.y_size, int(args[1]))
                self.engine = self._new_engine()
            elif cmd == "kata-set-rules" and args and args[0].lower() != "coffee":
                raise ValueError("only coffee rules are supported")
        elif cmd == "kgs-rules":
            # gtp.cpp:2186-2199: KGS rules names map to Go rulesets, which do
            # not exist in Coffee; the argument is validated like the
            # reference and then accepted-but-inert (komi-style), since every
            # KGS ruleset plays identically under Coffee rules
            if not args:
                raise ValueError("Expected one argument kgs-rules")
            if args[0].lower() not in ("chinese", "aga", "new_zealand", "japanese"):
                raise ValueError(f"Unknown rules '{args[0]}'")
        elif cmd in ("fixed_handicap", "place_free_handicap"):
            # gtp.cpp:2738-2776 argument validation, then: Coffee has no
            # handicap placement (no star points, no free placement without
            # a direction), so a well-formed request is itself an error
            if len(args) != 1:
                raise ValueError(
                    f"Expected one argument for {cmd} but got '{' '.join(args)}'"
                )
            try:
                n = int(args[0])
            except ValueError:
                raise ValueError(f"Could not parse number of handicap stones: '{args[0]}'")
            if n < 2:
                raise ValueError(f"Number of handicap stones less than 2: '{args[0]}'")
            if self.engine.move_history or self.engine.stone_count() > 0:
                raise ValueError("Board is not empty")
            raise ValueError("Handicap is not supported in coffee")
        elif cmd == "set_free_handicap":
            if self.engine.move_history or self.engine.stone_count() > 0:
                raise ValueError("Board is not empty")
            raise ValueError("Handicap is not supported in coffee")
        elif cmd == "kata-list-params":
            # maxVisits plus every SearchParams field (a superset of the
            # reference's dynamic-param list, gtp.cpp kata-set-param)
            resp = "\n".join(["maxVisits"] + [f.name for f in dataclasses.fields(SearchParams)])
        elif cmd == "kata-get-param":
            name = args[0] if args else ""
            if name == "maxVisits":
                resp = str(self.max_visits)
            elif hasattr(self.sp, name) and not name.startswith("_"):
                v = getattr(self.sp, name)
                resp = str(v).lower() if isinstance(v, bool) else str(v)
            else:
                raise ValueError(f"unknown param {name}")
        elif cmd == "kata-set-param":
            if len(args) != 2:
                raise ValueError("expected: kata-set-param PARAM VALUE")
            name, value = args
            if name == "maxVisits":
                self.max_visits = int(value)
            elif any(f.name == name for f in dataclasses.fields(SearchParams)):
                from katacoffee_tpu_torch.program.setup import load_search_params
                from katacoffee_tpu_torch.utils.config import ConfigParser

                c = ConfigParser(text="", overrides={name: value})
                self.sp = load_search_params(c, self.sp)
                # swap the params on the engine (state is kept)
                self.engine.set_search_params(self.sp)
            else:
                raise ValueError(f"unknown param {name}")
        elif cmd in ("genmove", "genmove_debug", "search_debug"):
            pla = _parse_player(args[0]) if args else self.engine.to_move
            resp = self._genmove(
                pla, debug=cmd != "genmove", play=cmd != "search_debug"
            )
        elif cmd in ("genmove_analyze", "lz-genmove_analyze", "kata-genmove_analyze"):
            # bare genmove_analyze is dispatched but NOT listed in
            # list_commands, exactly like the reference (gtp.cpp:79,2680)
            spec = self._parse_analyze_args(args)
            if spec["pla"] != self.engine.to_move:
                raise IllegalMoveError("genmove for the player not to move")
            resp = self._run_analyze(spec, genmove=True)
        elif cmd in ("analyze", "lz-analyze", "kata-analyze"):
            # bare analyze dispatched-but-unlisted (gtp.cpp:82,3034)
            spec = self._parse_analyze_args(args)
            resp = self._run_analyze(spec)
        elif cmd == "clear_cache":
            self.engine = self._new_engine()
        elif cmd == "showboard":
            resp = "\n" + self.engine.showboard()
        elif cmd == "time_settings":
            main, byo, stones = float(args[0]), float(args[1]), int(args[2])
            for pla in (1, 2):
                if stones == 0 and byo == 0:
                    self.time_controls[pla] = TimeControls.absolute(main)
                elif stones == 0:
                    self.time_controls[pla] = TimeControls()  # no time limits
                else:
                    # standard GTP time_settings is Canadian overtime
                    self.time_controls[pla] = TimeControls.byo_yomi(
                        main, byo / max(stones, 1), stones, per_stone=True
                    )
        elif cmd == "kgs-time_settings":
            system = args[0]
            if system == "none":
                tc = TimeControls()
            elif system == "absolute":
                tc = TimeControls.absolute(float(args[1]))
            elif system == "byoyomi":
                tc = TimeControls.byo_yomi(float(args[1]), float(args[2]), int(args[3]))
            elif system == "canadian":
                tc = TimeControls.byo_yomi(
                    float(args[1]), float(args[2]) / max(int(args[3]), 1),
                    int(args[3]), per_stone=True,
                )
            else:
                raise ValueError(f"unknown time system {system}")
            for pla in (1, 2):
                self.time_controls[pla] = dataclasses.replace(tc)
        elif cmd == "kata-list_time_settings":
            resp = "none absolute fischer byoyomi"
        elif cmd == "kata-time_settings":
            system = args[0]
            if system == "fischer":
                tc = TimeControls.fischer(float(args[1]), float(args[2]))
            elif system == "absolute":
                tc = TimeControls.absolute(float(args[1]))
            elif system == "byoyomi":
                tc = TimeControls.byo_yomi(float(args[1]), float(args[2]), int(args[3]))
            else:
                tc = TimeControls()
            for pla in (1, 2):
                self.time_controls[pla] = dataclasses.replace(tc)
        elif cmd == "time_left":
            # GTP: time_left <color> <time> <stones>; stones > 0 means the
            # player is in overtime. Canadian (per_stone) reports the time
            # remaining for ALL the stones; Japanese byo-yomi reports the
            # per-period time with `stones` periods left.
            pla = _parse_player(args[0])
            tc = self.time_controls[pla]
            stones = int(args[2]) if len(args) > 2 else 0
            t = max(float(args[1]), 0.0)
            if stones > 0 and tc.system == "byo_yomi":
                tc.main_time_left = 0.0
                tc.in_overtime = True
                tc.periods_left = stones
                if tc.per_stone:
                    # Canadian: t covers all remaining stones of the block
                    tc.period_time = t / stones
                elif tc.period_time == 0:
                    tc.period_time = t
            else:
                tc.main_time_left = float(args[1])
        elif cmd == "kata-debug-print-tc":
            resp = repr(self.time_controls)
        elif cmd == "final_score":
            if not self.engine.game_over:
                resp = "0"
            elif self.engine.winner == 1:
                resp = "B+"
            elif self.engine.winner == 2:
                resp = "W+"
            else:
                resp = "0"
        elif cmd == "final_status_list":
            resp = ""  # no dead-stone concept in Coffee
        elif cmd == "printsgf":
            from katacoffee_tpu_torch.dataio.sgf import write_sgf

            winner = self.engine.winner if self.engine.game_over else None
            text = write_sgf(
                self.cfg.x_size,
                self.cfg.y_size,
                self.cfg.win_len,
                self.engine.move_history,
                "black",
                "white",
                winner=winner,
            )
            if args:
                with open(args[0], "w") as f:
                    f.write(text + "\n")
            else:
                resp = text
        elif cmd == "loadsgf":
            from katacoffee_tpu_torch.dataio.sgf import parse_sgf_file

            sgf = parse_sgf_file(args[0])
            x, y = sgf.board_size()
            self.cfg = GameConfig(x, y, sgf.win_len())
            self.engine = self._new_engine()
            moves = sgf.moves()
            pls = sgf.placements()
            if pls:
                # AB/AW setup stones (custom start positions, sgf.cpp role):
                # an arbitrary position with no move history
                board = np.zeros((y, x), np.int8)
                for px, py, ppla in pls:
                    board[py, px] = ppla
                self.engine.set_position(board, moves[0][3] if moves else 1)
            upto = int(args[1]) if len(args) > 1 else len(moves)
            for mx, my, md, mpla in moves[:upto]:
                self.engine.play(mx, my, md, mpla)
        elif cmd == "kata-raw-nn":
            resp = self._raw_nn(args[0] if args else "0")
        elif cmd in ("cputime", "gomill-cpu_time"):
            resp = f"{self.cpu_time:.4f}"
        elif cmd == "kata-benchmark":
            # one fresh search at batch 1 from the initial position under
            # this engine's params and net, timed after an untimed warm-up
            # (command/benchmark.py)
            from katacoffee_tpu_torch.command.benchmark import benchmark_search

            visits = int(args[0]) if args else 100
            warmups = {}
            rate = benchmark_search(self.cfg, self.sp, self.engine.eval_fn, batch_sizes=(1,), num_visits=visits,
                                    reps=1, device=self.device, log=lambda _: None,
                                    generator=self.engine.generator, warmups=warmups)[1]
            resp = f"visits/s {rate:.1f} (first call {warmups[1]:.2f}s incl kernel build)"
        elif cmd == "debug_moves":
            resp = " ".join(gio.loc_to_string(x, y, d, cfg) for x, y, d, _ in self.engine.move_history)
        elif cmd == "stop":
            pass  # searches are synchronous; nothing to stop
        else:
            ok, resp = False, "unknown command"
        return ok, resp, quit_

    def run(self, infile=None, outfile=None):
        infile = infile or sys.stdin
        outfile = outfile or sys.stdout
        self._io = (infile, outfile)
        # read one line at a time (no iterator read-ahead): the streaming
        # analyze's select()-based interrupt check must see commands that
        # arrive while an analysis is running
        for line in iter(infile.readline, ""):
            if self.log_all_gtp and line.strip():
                self.log("Controller: " + line.strip())
            result = self.handle(line)
            if result == "":
                continue
            out, quit_ = result
            if self.log_all_gtp:
                self.log("Response: " + out)
            outfile.write(out + "\n\n")
            outfile.flush()
            if quit_:
                break
            if self.ponder_enabled and out.startswith("=") and _is_genmove_line(line):
                # reference gtp.cpp: bot->ponder() right after the genmove
                # reply; here: chunked background search until the next
                # command arrives (see _maybe_ponder)
                v = self._maybe_ponder(infile)
                self._ponder_last = v
                if v and self.log_all_gtp:
                    self.log(f"Pondered to {v} visits")


def main(argv: list[str], cfg=None, search_params=None, eval_fn=None, device=None, **kw):
    """Entry for `python -m katacoffee_tpu_torch gtp`: -config /
    -override-config map to the game config and SearchParams through
    program/setup.py (Setup::loadParams role); the engine runs on `device`
    (default `cuda`, which raises without a GPU)."""
    import argparse

    from katacoffee_tpu_torch.program.setup import load_game_config, load_search_params
    from katacoffee_tpu_torch.utils.config import ConfigParser
    from katacoffee_tpu_torch.utils.logger import Logger

    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch gtp")
    ap.add_argument("-config", default=None)
    ap.add_argument("-override-config", default=None)
    args, _ = ap.parse_known_args(argv)

    sp = search_params or SearchParams.for_tests_v2()
    max_visits = kw.pop("max_visits", 100)
    if args.config or args.override_config:
        c = ConfigParser(args.config, overrides=args.override_config) if args.config else ConfigParser(text="")
        if args.override_config and not args.config:
            c.apply_overrides(args.override_config)
        cfg = cfg or load_game_config(c)
        sp = load_search_params(c, sp)
        max_visits = c.get_int("maxVisits", max_visits)
        # ponderingEnabled / maxVisitsPondering (gtp_example.cfg:290-296);
        # maxTimePondering accepted for compatibility: chunked pondering
        # stops on input arrival, so the visit bound is the binding one
        kw.setdefault("ponder_enabled", c.get_bool("ponderingEnabled", False))
        if c.contains("maxVisitsPondering"):
            kw.setdefault(
                "max_visits_pondering", c.get_int("maxVisitsPondering", 0) or None
            )
        c.get_float("maxTimePondering", 0.0)
        c.get_bool("logToStdoutInsteadOfFile", False)  # accepted for compat
        # gtp.cpp logging surface: logFile/logDir/logDirDated sinks plus
        # logAllGTPCommunication / logSearchInfo toggles
        kw.setdefault("logger", Logger.from_config(c))
        log_all_gtp = c.get_bool("logAllGTPCommunication", True)
        c.get_bool("logSearchInfo", False)  # accepted (search dumps are
        # available via genmove_debug / kata-analyze rather than the log)
        c.warn_unused(Logger(log_to_stderr=True))
    else:
        log_all_gtp = True
    cfg = cfg or GameConfig(5, 5, 4)
    eng = GTPEngine(cfg, sp, eval_fn, max_visits=max_visits, device=device, **kw)
    eng.log_all_gtp = log_all_gtp
    eng.run()
