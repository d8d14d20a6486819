"""The port's analysis engine (`katacoffee_tpu_torch.command.analysis`, on
the CPU) over the golden scripts of tests/test_analysis_goldens.py, with the
same arguments (uniform priors, `SearchParams(valueWeightExponent=0.0)`, 8
visits), against the same `tests/goldens/analysis_*.expected` files, which
the JAX engine reproduces byte for byte. Every stat is exact there, so the
port must match byte for byte, signed zeros and float reprs included.
Nothing here writes a golden: a missing one fails.

Then the protocol checks of the JAX package's tests/test_frontends.py
(TestAnalysisEngine, TestAnalysisAvoidAndStreaming) and
tests/test_ownership.py (cross-query batching) on the port, without JAX."""

import io
import json
import os

import pytest
import torch

from katacoffee_tpu_torch.command.analysis import AnalysisEngine
from katacoffee_tpu_torch.game.board import GameConfig, init_state, step
from katacoffee_tpu_torch.search.params import SearchParams
from katacoffee_tpu_torch.utils.logger import Logger
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
SP = SearchParams(valueWeightExponent=0.0)
CFG = GameConfig(5, 5, 4)


def make(visits: int = 8) -> AnalysisEngine:
    return AnalysisEngine(SP, default_visits=visits, device="cpu")


def run_script(name: str) -> str:
    out = io.StringIO()
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        make().run(f, out)
    return out.getvalue()


def run_lines(eng: AnalysisEngine, lines: list) -> list[dict]:
    out = io.StringIO()
    eng.run(io.StringIO("\n".join(x if isinstance(x, str) else json.dumps(x) for x in lines) + "\n"), out)
    return [json.loads(line) for line in out.getvalue().splitlines()]


@pytest.mark.parametrize("script", ["analysis_basic.txt", "analysis_errors.txt", "analysis_avoidallow.txt"])
def test_analysis_golden(script):
    with open(os.path.join(GOLDEN_DIR, script.replace(".txt", ".expected"))) as f:
        expected = f.read()
    assert run_script(script) == expected


def test_avoid_allow_respected():
    """Avoided moves receive no visits; allow restricts the root to the
    listed moves; an avoid for WHITE leaves black's root prior alone."""
    results = [json.loads(line) for line in run_script("analysis_avoidallow.txt").splitlines()]
    by_id = {r["id"]: r for r in results if "id" in r}
    assert all(not mi["move"].startswith("C3") for mi in by_id["a0"]["moveInfos"])
    assert {mi["move"] for mi in by_id["a1"]["moveInfos"]} <= {"A1NE", "C3W"}
    # C3 N is flat action 0*25 + 2*5 + 2 = 12
    assert by_id["a2"]["policy"][12] > 0.0


def test_cross_query_batching():
    """Compatible pending queries merge into ONE device call; an
    incompatible budget stays separate (tests/test_ownership.py:367)."""
    eng = make()
    rows = run_lines(eng, [
        '{"id":"a","maxVisits":8}',
        '{"id":"b","moves":[["B","C3 N"]],"maxVisits":8}',
        '{"id":"c","maxVisits":8,"analyzeTurns":[0]}',
        '{"id":"d","maxVisits":16}',
    ])
    assert {r["id"] for r in rows if "moveInfos" in r} == {"a", "b", "c", "d"}
    assert eng.num_search_calls == 2
    for r in rows:
        if "moveInfos" in r:
            assert r["rootInfo"]["visits"] >= 8


def test_version_action():
    (r,) = make().handle_query({"id": "q", "action": "query_version"})
    assert r == {"id": "q", "action": "query_version", "version": "0.1.0"}


def test_basic_query():
    results = make().handle_query({
        "id": "foo", "moves": [["B", "C3 north"], ["W", "C5 west"]], "boardXSize": 5, "boardYSize": 5,
        "rules": "coffee", "analyzeTurns": [0, 1, 2], "maxVisits": 8,
    })
    by_turn = {r["turnNumber"]: r for r in results}
    assert set(by_turn) == {0, 1, 2}
    for r in results:
        assert r["id"] == "foo" and r["moveInfos"]
        assert r["moveInfos"][0]["visits"] > 0 and 0 <= r["moveInfos"][0]["winrate"] <= 1
        assert r["rootInfo"]["currentPlayer"] in ("B", "W")
    # turn 1: white constrained to column C
    assert all(mi["move"].startswith("C") for mi in by_turn[1]["moveInfos"])


def test_initial_stones_and_policy():
    (r,) = make().handle_query({
        "id": "b", "moves": [], "initialStones": [["B", "C3"]], "initialPlayer": "W", "boardXSize": 5,
        "boardYSize": 5, "rules": {"winLen": 4}, "includePolicy": True, "maxVisits": 4,
    })
    assert r["rootInfo"]["currentPlayer"] == "W"
    assert len(r["policy"]) == CFG.policy_size


def test_include_pv_visits():
    eng = make()
    (r,) = eng.handle_query({"id": "pvv", "moves": [["B", "C3 north"]], "includePVVisits": True, "maxVisits": 32})
    for mi in r["moveInfos"]:
        assert len(mi["pvVisits"]) == len(mi["pvEdgeVisits"]) == len(mi["pv"])
        assert mi["pvEdgeVisits"][0] == mi["visits"]
        assert all(nv >= ev for nv, ev in zip(mi["pvVisits"], mi["pvEdgeVisits"]))
    (r2,) = eng.handle_query({"id": "pvv2", "moves": [["B", "C3 north"]], "maxVisits": 8})
    assert "pvVisits" not in r2["moveInfos"][0]


def test_errors():
    eng = make()
    (r,) = eng.handle_query({"id": "x", "moves": [["B", "Z9 north"]]})
    assert "error" in r
    assert eng.handle_query({"id": "y", "moves": [], "analyzeTurns": [5]})[0]["error"] == "turn out of range"


def test_jsonl_run():
    rows = run_lines(make(), [json.dumps({"id": "a", "moves": [], "maxVisits": 4}), "not json"])
    assert any("error" in r and "bad json" in r["error"] for r in rows)
    assert any(r.get("id") == "a" and "moveInfos" in r for r in rows)


def test_logging_toggles(tmp_path):
    """logAllRequests / logAllResponses / logSearchInfo and the error
    prefix write to the configured log file (analysis.cpp:127-130)."""
    eng = make()
    log_path = tmp_path / "analysis.log"
    eng.logger = Logger()
    eng.logger.add_file(str(log_path))
    eng.log_all_requests = eng.log_all_responses = eng.log_search_info = True
    run_lines(eng, [{"id": "a", "moves": [], "maxVisits": 4}, {"id": "bad", "moves": [["B", "Z9 north"]]}])
    text = log_path.read_text()
    assert 'Request: {"id": "a"' in text
    assert "Search: queries=['a'] lanes=1 batch=1 visits=4 board=5x5w4" in text
    assert 'Response: {"id": "a"' in text and '"moveInfos"' in text
    assert 'Error: {"id": "bad"' in text


def test_avoid_and_allow_json():
    eng = make(16)
    (r,) = eng.handle_query({"id": "q", "moves": [["B", "C3N"]], "maxVisits": 16,
                             "avoidMoves": [{"player": "W", "moves": ["C4N"], "untilDepth": 1}]})
    assert r["moveInfos"] and all(mi["move"] != "C4N" for mi in r["moveInfos"])
    (r,) = eng.handle_query({"id": "q", "moves": [["B", "C3N"]], "maxVisits": 16,
                             "allowMoves": [{"player": "W", "moves": ["C4N"], "untilDepth": 1}]})
    assert [mi["move"] for mi in r["moveInfos"]] == ["C4N"]


def test_report_during_search():
    results = list(make(16).handle_query({"id": "q", "moves": [["B", "C3N"]], "maxVisits": 24,
                                          "reportDuringSearchEvery": 1e-9}))
    assert len([r for r in results if r.get("isDuringSearch")]) >= 1
    finals = [r for r in results if r.get("isDuringSearch") is False and "moveInfos" in r]
    assert len(finals) == 1 and finals[0]["rootInfo"]["visits"] == 25


def test_terminate_stops_a_streamed_query_after_its_chunk():
    """A terminate_all arriving during a streamed query's search flags it;
    the query then reports its partial tree once."""
    eng = make(16)
    calls = []

    def poll():
        calls.append(1)
        if len(calls) == 2:
            eng._apply_terminate({"action": "terminate_all", "id": "t"}, [], lambda obj: None)

    eng._poll_input, eng._current_qid = poll, "q"
    results = list(eng.handle_query({"id": "q", "maxVisits": 64, "reportDuringSearchEvery": 1e-9}))
    finals = [r for r in results if r.get("isDuringSearch") is False]
    assert len(finals) == 1 and 9 <= finals[0]["rootInfo"]["visits"] < 65


def test_priorities_order_and_mismatch():
    """Higher priority first, FIFO within one; priorities of the wrong
    length answer an error."""
    rows = run_lines(make(), [
        {"id": "low", "maxVisits": 4, "priority": -1},
        {"id": "mid", "moves": [["B", "C3 N"]], "maxVisits": 6},
        {"id": "high", "maxVisits": 5, "priority": 3},
        {"id": "bad", "analyzeTurns": [0], "priorities": [1, 2]},
    ])
    assert rows[0] == {"id": "bad", "error": "priorities must be the same length as analyzeTurns",
                       "field": "priorities"}
    assert [r["id"] for r in rows[1:]] == ["high", "mid", "low"]


def test_root_hashes_are_uint32_words():
    """The port keeps the situation hash's two uint32 words as int64: over
    every position of a reference game and its symmetries none goes
    negative or past 32 bits, so thisHash is two 8-digit hex words; symHash
    is the least over the dihedral orbit."""
    from katacoffee_tpu_torch.command.analysis import _cat
    from katacoffee_tpu_torch.dataio.sgf import parse_sgf
    from katacoffee_tpu_torch.game import symmetry as S
    from katacoffee_tpu_torch.game.board import situation_hash

    with open(os.path.join(GOLDEN_DIR, "ref_sgfs/ref_000.sgfs")) as f:
        game = parse_sgf(f.readline())
    st = init_state(CFG, 1, "cpu")
    states = [st]
    for x, y, d, _ in game.moves():
        st = step(CFG, st, torch.tensor([d * CFG.area + y * CFG.x_size + x]))
        states.append(st)
    roots = _cat(states)
    words = torch.stack([situation_hash(CFG, S.apply_state(CFG, s, roots)) for s in range(8)])
    assert int(words.min()) >= 0 and int(words.max()) < 1 << 32
    hashes = make()._root_hashes(CFG, roots)
    assert len(hashes) == len(states) > 10
    for (this, sym), w in zip(hashes, words[0]):
        assert this == f"{int(w[0]):08X}{int(w[1]):08X}" and len(sym) == 16 and sym <= this
    assert hashes[0][0] == "2C57A5D35C165946"  # the empty board, analysis_errors.expected
