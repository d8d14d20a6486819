"""The port's JSON analysis engine (`katacoffee_tpu_torch.command.analysis`)
against the JAX package's on the tiny net at float32 on both sides, under
`for_tests_v2()`, through `run()` on one script: a 4-turn query with every
ownership, policy and PV-visit field; three compatible queries with avoid
and allow rows, one of which forbids every legal move, merged into one
padded batch; rootSymmetryPruning by overrideSettings on the empty board
(isSymmetryOf rows) and an unknown key; priorities and a terminate of a
subset of turns; a streamed query (its final report); the root's
rawStWrError and rawVarTimeLeft.

Neither engine draws under `for_tests_v2()`, so the two run the same
search. Visits, orders, moves, PVs, hashes and isSymmetryOf are held equal;
the other floats within 2e-4 (float32 sums of another order over a whole
search, as tests/test_torch_engine.py), the ownership maps within 1e-5. A
streamed query's interim reports depend on the wall clock in both
packages: only their count rule is checked. One JAX engine serves the
module, so each of its search shapes compiles once."""

import functools
import io
import json
import os

import numpy as np
import pytest
import torch

from katacoffee_tpu.command.analysis import AnalysisEngine as JaxAnalysisEngine
from katacoffee_tpu.search import mcts as JM
from katacoffee_tpu.search.params import SearchParams as JaxParams
from katacoffee_tpu_torch.command.analysis import AnalysisEngine
from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
from katacoffee_tpu_torch.dataio.sgf import parse_sgf
from katacoffee_tpu_torch.game import io as gio
from katacoffee_tpu_torch.game.board import GameConfig, init_state, legal_mask_flat, step
from katacoffee_tpu_torch.search import mcts as TM
from katacoffee_tpu_torch.search.params import SearchParams
from test_torch_search import TINYNET
from torch_parity import jax_exported_net, one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_SGFS = os.path.join(ROOT, "tests/goldens/ref_sgfs/ref_000.sgfs")
TCFG = GameConfig(5, 5, 4)
FLOAT_TOL = 2e-4
OWNERSHIP_TOL = 1e-5
EXACT = ("move", "visits", "order", "pv", "pvVisits", "pvEdgeVisits", "isSymmetryOf", "thisHash", "symHash",
         "currentPlayer", "turnNumber", "id", "isDuringSearch", "noResults", "error", "action", "terminateId")


def game_moves(k: int) -> list[list[str]]:
    """Game k of tests/goldens/ref_sgfs/ref_000.sgfs (one a line) as the
    analysis protocol's [player, compact move] pairs."""
    with open(REF_SGFS) as f:
        line = f.read().splitlines()[k]
    return [["B" if pla == 1 else "W", gio.loc_to_compact(x, y, d, TCFG)] for x, y, d, pla in
            parse_sgf(line).moves()]


def legal_moves(moves: list[list[str]]) -> tuple[list[str], list[str]]:
    """(legal, illegal) compact moves after `moves`, in action order."""
    st = init_state(TCFG, 1, "cpu")
    for _, m in moves:
        x, y, d = gio.parse_loc(m, TCFG)
        st = step(TCFG, st, torch.tensor([d * TCFG.area + y * TCFG.x_size + x]))
    legal = legal_mask_flat(TCFG, st)[0].numpy()
    return ([gio.action_to_compact(int(a), TCFG) for a in np.flatnonzero(legal)],
            [gio.action_to_compact(int(a), TCFG) for a in np.flatnonzero(~legal)])


def script() -> list[dict]:
    every = dict(includeOwnership=True, includeOwnershipStdev=True, includeMovesOwnership=True,
                 includePolicy=True, includePVVisits=True)
    g5, g6, g7 = game_moves(5)[:5], game_moves(6)[:4], game_moves(7)[:4]
    legal5, legal6, (legal7, illegal7) = legal_moves(g5)[0], legal_moves(g6)[0], legal_moves(g7)
    mover5 = "B" if len(g5) % 2 == 0 else "W"
    mover6 = "B" if len(g6) % 2 == 0 else "W"
    mover7 = "B" if len(g7) % 2 == 0 else "W"
    return [
        {"id": "turns", "moves": game_moves(3)[:3], "analyzeTurns": [0, 1, 2, 3], "maxVisits": 24, **every},
        {"id": "pr", "moves": game_moves(4)[:4], "analyzeTurns": [1, 2, 4], "priorities": [1, 5, 2],
         "maxVisits": 24, "includePolicy": True},
        {"action": "terminate", "id": "t", "terminateId": "pr", "turnNumbers": [2]},
        {"id": "avoid", "moves": g5, "maxVisits": 16,
         "avoidMoves": [{"player": mover5, "moves": legal5[:3], "untilDepth": 3}]},
        {"id": "allow", "moves": g6, "maxVisits": 16, "includePVVisits": True,
         "allowMoves": [{"player": mover6, "moves": legal6[-2:], "untilDepth": 2}]},
        {"id": "nolegal", "moves": g7, "maxVisits": 16,
         "allowMoves": [{"player": mover7, "moves": illegal7[:1], "untilDepth": 1}]},
        {"id": "sym", "maxVisits": 16, "overrideSettings": {"rootSymmetryPruning": True},
         "includeOwnership": True, "includeMovesOwnership": True},
        {"id": "badkey", "maxVisits": 16, "overrideSettings": {"noSuchSetting": 1}},
        {"id": "stream", "moves": game_moves(8)[:3], "maxVisits": 16, "reportDuringSearchEvery": 1e-9},
    ], legal7


@functools.lru_cache(maxsize=None)
def outputs() -> tuple[list[dict], list[dict], dict]:
    """(JAX's reports, the port's, facts of the script), each engine run
    once over the script."""
    jnet, params = jax_exported_net(TINYNET)
    tnet = load_exported_model(TINYNET, device="cpu", dtype=torch.float32)[0]
    queries, legal7 = script()
    text = "\n".join(json.dumps(q) for q in queries) + "\n"
    jeng = JaxAnalysisEngine(JaxParams.for_tests_v2(), lambda cfg: JM.make_nn_eval_fn(cfg, jnet, params),
                             raw_forward_factory=lambda cfg: JM.make_raw_forward_fn(cfg, jnet, params))
    teng = AnalysisEngine(SearchParams.for_tests_v2(), lambda cfg: TM.make_nn_eval_fn(cfg, tnet),
                          raw_forward_factory=lambda cfg: TM.make_cached_raw_forward_fn(cfg, tnet), device="cpu")
    reports = []
    for eng in (jeng, teng):
        out = io.StringIO()
        eng.run(io.StringIO(text), out)
        reports.append([json.loads(line) for line in out.getvalue().splitlines()])
    facts = {"queries": {q.get("id"): q for q in queries}, "legal7": legal7,
             "calls": (jeng.num_search_calls, teng.num_search_calls)}
    return reports[0], reports[1], facts


def assert_close(j, t, path="", tol=FLOAT_TOL):
    """JSON values equal, floats within `tol` (OWNERSHIP_TOL under the
    ownership keys), the EXACT keys equal."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(t) == set(j), (path, sorted(j), sorted(t))
        for k in j:
            if k in EXACT:
                assert t[k] == j[k], (path, k, j[k], t[k])
            else:
                assert_close(j[k], t[k], f"{path}.{k}", OWNERSHIP_TOL if k.startswith("ownership") else tol)
    elif isinstance(j, list):
        assert isinstance(t, list) and len(t) == len(j), (path, len(j), len(t))
        for n, (a, b) in enumerate(zip(j, t)):
            assert_close(a, b, f"{path}[{n}]", tol)
    elif isinstance(j, float):
        assert abs(t - j) <= tol, (path, j, t)
    else:
        assert t == j, (path, j, t)


def finals(reports):
    return [r for r in reports if not r.get("isDuringSearch")]


def test_reports_match_jax():
    """Every report but the streamed interim ones, in order: the same keys,
    the same moves, visits, orders, PVs and hashes, floats in bound."""
    jrep, trep, _ = outputs()
    assert len(finals(trep)) == len(finals(jrep))
    for j, t in zip(finals(jrep), finals(trep)):
        assert_close(j, t, str(j.get("id")))


def test_the_script_ran_as_scheduled():
    """pr (priority 5) runs first and absorbs turns (same budget and
    params): one call padded from 6 lanes to 8; the three restricted
    queries one call padded to 4; sym and stream one call each, badkey an
    error; pr's terminated turn answers noResults."""
    jrep, trep, facts = outputs()
    assert facts["calls"] == (4, 4)
    ids = [(r.get("id"), r.get("turnNumber")) for r in finals(trep) if "moveInfos" in r]
    assert ids[:6] == [("pr", 1), ("pr", 4), ("turns", 0), ("turns", 1), ("turns", 2), ("turns", 3)]
    assert [r for r in trep if r.get("id") == "pr" and r.get("turnNumber") == 2] == [
        {"id": "pr", "turnNumber": 2, "isDuringSearch": False, "noResults": True}]
    (bad,) = [r for r in trep if r.get("id") == "badkey"]
    assert bad == {"id": "badkey", "error": "unknown overrideSettings key 'noSuchSetting'"}


def test_restrictions_hold_per_lane():
    """In the merged batch each lane keeps its own rows: avoid's moves get
    no row, allow's rows lie in its two moves, and nolegal's mask (every
    legal move forbidden) is ignored."""
    _, trep, facts = outputs()
    by_id = {r["id"]: r for r in finals(trep) if "moveInfos" in r}
    avoided = set(facts["queries"]["avoid"]["avoidMoves"][0]["moves"])
    assert by_id["avoid"]["moveInfos"] and not {mi["move"] for mi in by_id["avoid"]["moveInfos"]} & avoided
    allowed = set(facts["queries"]["allow"]["allowMoves"][0]["moves"])
    assert {mi["move"] for mi in by_id["allow"]["moveInfos"]} <= allowed
    assert {mi["move"] for mi in by_id["nolegal"]["moveInfos"]} <= set(facts["legal7"])
    assert sum(mi["visits"] for mi in by_id["nolegal"]["moveInfos"]) == 16


def test_symmetry_rows_and_raw_heads():
    """sym's rows come back duplicated over the empty board's stabilizer
    (with mapped ownership); every report with a net carries the raw
    heads."""
    _, trep, _ = outputs()
    (sym,) = [r for r in finals(trep) if r.get("id") == "sym"]
    dups = [mi for mi in sym["moveInfos"] if "isSymmetryOf" in mi]
    assert dups and all(len(mi["ownership"]) == 25 for mi in dups)
    for r in finals(trep):
        if "rootInfo" in r:
            assert r["rootInfo"]["rawStWrError"] > 0 and r["rootInfo"]["rawVarTimeLeft"] > 0


def test_streamed_query_reports():
    """At least one interim report, then exactly one final one, as JAX's
    tests/test_frontends.py test_report_during_search counts them."""
    jrep, trep, _ = outputs()
    for rep in (jrep, trep):
        stream = [r for r in rep if r.get("id") == "stream"]
        assert sum(r["isDuringSearch"] for r in stream) >= 1
        assert [r["isDuringSearch"] for r in stream].count(False) == 1
        assert stream[-1]["rootInfo"]["visits"] >= 16
