"""The port's SGF module (`katacoffee_tpu_torch/dataio/sgf.py`) and start
positions (`selfplay/startposes.py`) against the JAX package's: `write_sgf`
text byte-equal for random legal games (with placements, winners, names to
escape and comments), `parse_sgf` equal on those texts and on hand-written
edge cases, and `load_startposes` equal field for field, probabilities and
hints included, on a directory of such games and a placements-only setup.

JAX's `load_startposes` jits a new `step` on every call; the test hands it
the cached `jitted.step_fn` instead (the same function), so JAX compiles
once for the file."""

import os

import jax
import numpy as np
import pytest
import torch

from katacoffee_tpu.dataio import sgf as JS
from katacoffee_tpu.game import board as JB
from katacoffee_tpu.game import jitted
from katacoffee_tpu.selfplay import startposes as JP
from katacoffee_tpu_torch.dataio import sgf as TS
from katacoffee_tpu_torch.game import board as TB
from katacoffee_tpu_torch.selfplay import startposes as TP
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

CFG = JB.GameConfig(5, 5, 4)
TCFG = TB.GameConfig(5, 5, 4)


def random_games(cfg, n, seed, max_plies=None):
    """[(moves [(x, y, d, pla)], winner or None)] of random legal games
    played with the port's rules, each to its end or `max_plies`."""
    rng = np.random.default_rng(seed)
    s = TB.init_state(cfg, n, "cpu")
    moves = [[] for _ in range(n)]
    ply = 0
    while not bool(s.done.all()) and (max_plies is None or ply < max_plies):
        legal = TB.legal_mask_flat(cfg, s).numpy()
        acts = np.zeros(n, np.int64)
        for b in range(n):
            if not bool(s.done[b]):
                a = int(rng.choice(np.flatnonzero(legal[b])))
                acts[b] = a
                d, spot = divmod(a, cfg.area)
                moves[b].append((spot % cfg.x_size, spot // cfg.x_size, d, int(s.to_move[b])))
        s = TB.step(cfg, s, torch.from_numpy(acts))
        ply += 1
    return [(m, int(s.winner[b]) if bool(s.done[b]) else None) for b, m in enumerate(moves)]


def write_both(*args, **kw):
    return JS.write_sgf(*args, **kw), TS.write_sgf(*args, **kw)


def assert_same_tree(j, t):
    assert [n.props for n in t.nodes] == [n.props for n in j.nodes]
    assert len(t.children) == len(j.children)
    for a, b in zip(j.children, t.children):
        assert_same_tree(a, b)


def assert_same_sgf(text):
    j, t = JS.parse_sgf(text), TS.parse_sgf(text)
    assert_same_tree(j, t)
    assert t.moves() == j.moves() and t.placements() == j.placements()
    assert t.board_size() == j.board_size() and t.win_len() == j.win_len() and t.result() == j.result()
    return t


@pytest.mark.parametrize("shape,seed", [((5, 5, 4), 0), ((7, 5, 4), 1), ((9, 9, 5), 2)])
def test_write_and_parse_random_games_match_jax(shape, seed):
    cfg = TB.GameConfig(*shape)
    rng = np.random.default_rng(seed)
    games = random_games(cfg, 6, seed) + random_games(cfg, 2, seed + 10, max_plies=9)  # 2 unfinished
    for i, (moves, winner) in enumerate(games):
        cells = rng.permutation(cfg.area)[:3]
        placements = [(int(c) % cfg.x_size, int(c) // cfg.x_size, 1 + k % 2) for k, c in enumerate(cells)]
        kw = dict(
            black_name="b]l\\ack" if i == 1 else "model-a", white_name="model-b", winner=winner,
            is_resignation=i == 3, placements=placements if i % 3 == 0 else (),
            comments={0: "first", 2: "x]y"} if i == 2 else None, root_comment="root" if i == 4 else None,
        )
        jtext, ttext = write_both(cfg.x_size, cfg.y_size, cfg.win_len, moves, **kw)
        assert ttext == jtext
        t = assert_same_sgf(ttext)
        assert [m[:3] for m in t.moves()] == [m[:3] for m in moves]
    jtext, ttext = write_both(5, 5, 4, [(0, 0, 0, 1)], winner=0)  # a draw
    assert ttext == jtext and "RE[0]" in ttext


@pytest.mark.parametrize("text", [
    "(;FF[4]GM[Coffee]SZ[5]WLL[4];B[aab];W[bbc](;B[ccd];W[dda])(;B[eea]))",  # variations: first child
    "( ; FF[4] SZ[6:5] WLL[3]\n AB[aa][bb] AW[cc] ; B[ddA] ; W[] )",  # whitespace, dir case, empty move
    "(;C[a \\] b \\\\ c]PB[x]RE[W+R];B[aaa])",
    "(;SZ[5];B[aaa]C[one]C[two];W[bba])",
])
def test_parse_edge_cases_match_jax(text):
    assert_same_sgf(text)


@pytest.mark.parametrize("text", ["", "(;B[aaa]", "(;B[aa", "x(;B[aaa])", "(;B[aaaa])", "(;B[a!a])",
                                  "(;AB[abc])"])
def test_malformed_sgf_fails_the_same(text):
    def outcome(mod):
        try:
            s = mod.parse_sgf(text)
            return ("ok", s.moves(), s.placements())
        except ValueError as e:
            return ("error", str(e))

    assert outcome(TS) == outcome(JS)


@pytest.fixture(scope="module")
def sgf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("startposes")
    (d / "sub").mkdir()
    for i, (moves, winner) in enumerate(random_games(TCFG, 5, seed=7)):
        where = d / "sub" if i % 2 else d
        (where / f"g{i}.sgf").write_text(TS.write_sgf(5, 5, 4, moves, winner=winner) + "\n")
    # an unfinished game, a placements-only setup, and files to skip
    moves, _ = random_games(TCFG, 1, seed=8, max_plies=6)[0]
    (d / "h_unfinished.sgf").write_text(TS.write_sgf(5, 5, 4, moves))
    (d / "i_setup.sgf").write_text(TS.write_sgf(5, 5, 4, [], placements=[(0, 0, 1), (1, 2, 2), (4, 4, 1)]))
    (d / "j_other_size.sgf").write_text(TS.write_sgf(7, 5, 4, [(0, 0, 0, 1)]))
    (d / "k_broken.sgf").write_text("(;SZ[5];B[aa")
    (d / "notes.txt").write_text("not an sgf")
    return str(d)


def jax_startposes(*args, **kw):
    step1 = jitted.step_fn(CFG)
    jit = jax.jit
    jax.jit = lambda f: step1
    try:
        return JP.load_startposes(*args, **kw)
    finally:
        jax.jit = jit


@pytest.mark.parametrize("kw", [dict(), dict(turn_weight_lambda=0.5, with_hints=True),
                                dict(turn_weight_lambda=0.5, max_positions=17),
                                dict(with_hints=True, max_positions=9)], ids=str)
def test_load_startposes_matches_jax(sgf_dir, kw):
    want = jax_startposes(CFG, sgf_dir, **kw)
    got = TP.load_startposes(TCFG, sgf_dir, device="cpu", **kw)
    assert len(got) == len(want) == (3 if kw.get("with_hints") else 2)
    for name, a, b in zip(TB.GameState._fields, got[0], want[0]):
        b = np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a.numpy(), b.astype(a.numpy().dtype)), name
    assert got[1].dtype == torch.float32 and np.array_equal(got[1].numpy(), want[1])
    if kw.get("with_hints"):
        assert np.array_equal(got[2].numpy(), want[2]) and (got[2] >= 0).any()
    if "max_positions" in kw:
        assert got[0].board.shape[0] == kw["max_positions"]
    else:
        assert got[0].board.shape[0] > 20 and (got[0].num_turns == 3).any()  # the setup is in
        assert len(got) == 2 or (got[2] < 0).any()


def test_load_startposes_of_one_setup_and_of_nothing(sgf_dir, tmp_path):
    setup = [os.path.join(sgf_dir, "i_setup.sgf")]
    want, got = jax_startposes(CFG, setup), TP.load_startposes(TCFG, setup, device="cpu")
    assert np.array_equal(got[0].board.numpy(), np.asarray(want[0].board))
    assert int(got[0].num_turns[0]) == int(want[0].num_turns[0]) == 3
    assert got[1].tolist() == [1.0]
    none = [os.path.join(sgf_dir, "j_other_size.sgf"), os.path.join(sgf_dir, "k_broken.sgf")]
    assert TP.load_startposes(TCFG, none, device="cpu") is None and jax_startposes(CFG, none) is None
    assert TP.load_startposes(TCFG, str(tmp_path), device="cpu") is None
