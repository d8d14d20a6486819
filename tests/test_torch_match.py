"""The port's match runner, gatekeeper, Elo fit and SGF summary against the
JAX package's, on the CPU.

One JAX match is played (tinynet, the candidate, against the b6c96
`run-s4800`, both at float32; 8 games at 16 visits under
`for_gatekeeper()`, seed 0), and the port replays it with JAX's Gumbel
draws injected (per ply `rng, ka, kb = split(rng, 3)`, per half
`k1, k2 = split(k)`, the noise of `categorical(k2, .)`). Exact: the move
records, winners and tally, and the SGF texts. `gate_one` runs in both
packages on the same base-dir layout (the JAX side's match is that one
match, its arguments checked; at one threshold the port's plays it anew
with the same draws): the same decision, the same directories moved, the
same SGFs, at a threshold that rejects and one that promotes. `compute_elos` equals JAX's
on fixed records (the same numpy code), and `collect_results` equals JAX's
(which replays through its native rules core) on the gate's SGFs.
"""

import dataclasses
import functools
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import katacoffee_tpu.command.gatekeeper as JG
from katacoffee_tpu.command.summarize_sgfs import collect_results as jax_collect
from katacoffee_tpu.program import match as JPM
from katacoffee_tpu.search.params import SearchParams as JaxParams
from katacoffee_tpu.utils import Logger as JaxLogger
from katacoffee_tpu.utils.elo import compute_elos as jax_elos
from katacoffee_tpu_torch.command import gatekeeper as TG
from katacoffee_tpu_torch.command.summarize_sgfs import collect_results
from katacoffee_tpu_torch.program import match as TPM
from katacoffee_tpu_torch.search.params import SearchParams
from katacoffee_tpu_torch.utils.elo import compute_elos
from katacoffee_tpu_torch.utils.logger import Logger
from test_torch_search import CFG, ROOT, TCFG, TINYNET, _evals
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

CHAMPION = os.path.join(ROOT, "artifacts/flagship_b6c96/models/run-s4800")
GAMES, VISITS, SEED = 8, 16, 0


@functools.lru_cache(maxsize=None)
def _draws():
    """{(ply, half): gumbel [half, A]} of JAX's run_match key chain."""
    rng = jax.random.PRNGKey(SEED)
    out = {}
    for ply in range(CFG.area + 2):
        rng, ka, kb = jax.random.split(rng, 3)
        for half, k in enumerate((ka, kb)):
            _, k2 = jax.random.split(k)
            out[ply, half] = torch.from_numpy(
                np.asarray(jax.random.gumbel(k2, (GAMES // 2, CFG.policy_size))).copy())
    return out


def draws(ply, half):
    return _draws()[ply, half]


@functools.lru_cache(maxsize=None)
def _jax_match():
    jev_a, _ = _evals(TINYNET)
    jev_b, _ = _evals(CHAMPION)
    sp = JaxParams.for_gatekeeper()
    return JPM.run_match(CFG, sp, sp, jev_a, jev_b, num_games=GAMES, num_visits=VISITS, seed=SEED,
                         record_moves=True)


@functools.lru_cache(maxsize=None)
def _port_match(**kw):
    _, tev_a = _evals(TINYNET)
    _, tev_b = _evals(CHAMPION)
    sp = SearchParams.for_gatekeeper()
    return TPM.run_match(TCFG, sp, sp, tev_a, tev_b, num_games=GAMES, num_visits=VISITS, seed=SEED,
                         record_moves=True, device="cpu", draws=draws, **kw)


def test_run_match_matches_jax_with_its_draws():
    want = _jax_match()
    got = _port_match()
    assert got.move_records == want.move_records
    assert np.array_equal(got.winners, want.winners)
    assert np.array_equal(got.black_was_a, want.black_was_a)
    assert (got.games, got.wins_a, got.wins_b, got.draws) == (want.games, want.wins_a, want.wins_b, want.draws)
    assert got.score_a == want.score_a
    # the records differ across games (the move temperature), every game
    # ended, and the live counts follow the records
    assert len({tuple(m) for m in got.move_records}) == GAMES
    assert got.live_per_ply[0] == GAMES and len(got.live_per_ply) == max(len(m) for m in got.move_records)
    assert got.live_per_ply == [sum(len(m) > t for m in got.move_records) for t in range(len(got.live_per_ply))]
    assert TPM.match_sgfs(TCFG, got, "tinynet", "run-s4800") == JPM.match_sgfs(CFG, want, "tinynet", "run-s4800")


def test_run_match_turn_cap_counts_unfinished_games_as_draws():
    want = _jax_match()
    got = _port_match(max_moves=6)
    assert [len(m) for m in got.move_records] == [6] * GAMES
    assert got.move_records == [m[:6] for m in want.move_records]
    assert (got.wins_a, got.wins_b, got.draws) == (0, 0, GAMES) and (got.winners == 0).all()


def test_compute_elos_matches_jax():
    records = [("a", "b", 7, 2, 1), ("b", "c", 3, 3, 4), ("a", "c", 9, 0, 1), ("c", "d", 5, 4, 0), ("d", "b"),
               ("b", "d")]
    for prior in (2.0, 0.5):
        want, got = jax_elos(records, prior_games=prior), compute_elos(records, prior_games=prior)
        assert got.players == want.players
        assert np.array_equal(got.elos, want.elos) and np.array_equal(got.stdevs, want.stdevs)
        assert got.as_dict() == want.as_dict()
    assert compute_elos([]).players == []


def _layout(base, champion=True):
    os.makedirs(os.path.join(base, "models"))
    os.makedirs(os.path.join(base, "modelstobetested"))
    shutil.copytree(TINYNET, os.path.join(base, "modelstobetested", "tinynet"))
    if champion:
        shutil.copytree(CHAMPION, os.path.join(base, "models", "run-s4800"))


def _listing(base):
    return sorted(os.path.relpath(os.path.join(r, f), base) for r, _, fs in os.walk(base) for f in fs)


def _float32_loader(path, device=None):
    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model

    return load_exported_model(path, device=device, dtype=torch.float32)


@pytest.mark.parametrize("required,promoted", [(0.5, False), (0.1, True)])
def test_gate_one_matches_jax(tmp_path, monkeypatch, required, promoted):
    """At the rejecting threshold the port's gate plays its match (its nets
    loaded by gate_one at float32, JAX's draws injected); at the promoting
    one both packages' gates are handed the match already compared."""
    want_match = _jax_match()
    assert (want_match.score_a >= 0.1) and (want_match.score_a < 0.5)

    def jax_run_match(cfg, sp_a, sp_b, ev_a, ev_b, **kw):
        assert sp_a == sp_b == JaxParams.for_gatekeeper()
        assert kw == dict(num_games=GAMES, num_visits=VISITS, seed=SEED, record_moves=True)
        return want_match

    def port_run_match(cfg, sp_a, sp_b, ev_a, ev_b, **kw):
        assert sp_a == sp_b == SearchParams.for_gatekeeper()
        assert kw == dict(num_games=GAMES, num_visits=VISITS, seed=SEED, record_moves=True,
                          device=torch.device("cpu"))
        if promoted:
            return _port_match()
        return TPM.run_match(cfg, sp_a, sp_b, ev_a, ev_b, draws=draws, **kw)

    monkeypatch.setattr(JG, "run_match", jax_run_match)
    monkeypatch.setattr(TG, "run_match", port_run_match)
    monkeypatch.setattr(TG, "load_exported_model", _float32_loader)
    jgc = JG.GatekeeperConfig(num_games=GAMES, num_visits=VISITS, required_candidate_win_prop=required, seed=SEED)
    tgc = TG.GatekeeperConfig(**dataclasses.asdict(jgc))
    jbase, tbase = str(tmp_path / "jax"), str(tmp_path / "port")
    for base in (jbase, tbase):
        _layout(base)
    cand = "modelstobetested/tinynet"
    assert JG.gate_one(jbase, os.path.join(jbase, cand), CFG, jgc, JaxLogger()) is promoted
    assert TG.gate_one(tbase, os.path.join(tbase, cand), TCFG, tgc, Logger(), device="cpu") is promoted
    assert _listing(tbase) == _listing(jbase)
    assert os.path.isdir(os.path.join(tbase, "models" if promoted else "rejectedmodels", "tinynet"))
    sgfs = sorted(os.listdir(os.path.join(tbase, "gatekeepersgfs", "tinynet")))
    assert len(sgfs) == GAMES
    for name in sgfs:
        rel = os.path.join("gatekeepersgfs", "tinynet", name)
        assert open(os.path.join(tbase, rel)).read() == open(os.path.join(jbase, rel)).read()

    # collect_results on the gate's SGFs: the port replays them with its own
    # rules, JAX with its native core
    sgf_dir = os.path.join(tbase, "gatekeepersgfs")
    want = jax_collect([sgf_dir])
    assert collect_results([sgf_dir], device="cpu") == want
    assert collect_results([sgf_dir], validate=False) == want
    assert sum(w + l + d for _, _, w, l, d in want) == GAMES


def test_gate_one_without_a_champion_promotes_as_jax(tmp_path):
    jbase, tbase = str(tmp_path / "jax"), str(tmp_path / "port")
    for base in (jbase, tbase):
        _layout(base, champion=False)
    cand = "modelstobetested/tinynet"
    assert JG.gate_one(jbase, os.path.join(jbase, cand), CFG, JG.GatekeeperConfig(), JaxLogger())
    assert TG.gate_one(tbase, os.path.join(tbase, cand), TCFG, TG.GatekeeperConfig(), Logger(), device="cpu")
    assert _listing(tbase) == _listing(jbase) == ["models/tinynet/model.json", "models/tinynet/model.npz"]


def test_collect_results_skips_what_jax_skips(tmp_path):
    """An illegal move, a move after the game's end, a game without RE and
    an unreadable file are skipped; an unfinished game keeps its RE tag."""
    from katacoffee_tpu_torch.dataio.sgf import write_sgf

    m = _jax_match()
    first = m.move_records[0]
    moves = [((a % 25) % 5, (a % 25) // 5, a // 25, 1 + i % 2) for i, a in enumerate(first)]
    games = {
        "ok": write_sgf(5, 5, 4, moves, "x", "y", winner=int(m.winners[0])),
        "illegal": write_sgf(5, 5, 4, moves[:3] + [moves[1]], "x", "y", winner=1),
        "after_end": write_sgf(5, 5, 4, moves + [moves[-1]], "x", "y", winner=1),
        "no_result": write_sgf(5, 5, 4, moves, "x", "y", winner=None),
        "unfinished": write_sgf(5, 5, 4, moves[:4], "x", "z", winner=2),
        "empty": write_sgf(5, 5, 4, [], "z", "y", winner=0),
        "wrong_result": write_sgf(5, 5, 4, moves, "x", "y", winner=3 - int(m.winners[0]) if m.winners[0] else 1),
    }
    for name, text in games.items():
        (tmp_path / f"{name}.sgf").write_text(text)
    (tmp_path / "broken.sgf").write_text("(;FF[4]SZ[5]B[zz")
    want = jax_collect([str(tmp_path)])
    assert collect_results([str(tmp_path)], device="cpu") == want
    assert collect_results([str(tmp_path)], validate=False) == jax_collect([str(tmp_path)], validate=False)


# Games the native rules core refuses at their first move and the replay
# must skip before it indexes the legal mask: an off-board spot (5, 0) that
# a flat index would alias to (0, 1), the empty move (-1, -1, D_NONE), and a
# spot (25, 25) whose flat index lies past the mask.
@pytest.mark.parametrize("moves", ["B[fab];W[bba]", "B[];W[dea]", "B[zzd]"],
                         ids=["off_board", "empty_move", "past_the_mask"])
def test_collect_results_skips_off_board_moves_as_jax(tmp_path, moves):
    (tmp_path / "g.sgf").write_text(f"(;FF[4]GM[1]SZ[5]WLL[4]PB[x]PW[y]RE[B+];{moves})")
    want = jax_collect([str(tmp_path)])
    assert want == []
    assert collect_results([str(tmp_path)], device="cpu") == want

