"""The port's selfplay command (`katacoffee_tpu_torch/command/selfplay.py`)
against the JAX package's: `extract_episodes` on a JAX segment's
trajectory; one flush window against JAX's sequence of public functions
(`finalize_targets`, `TrainingDataWriter.add_batch`, `tree_position_rows`,
the fork candidates padded to the pool with `choose_fork_moves` and
`refill_pool`, `extract_episodes`, `write_sgf`, composed as
katacoffee_tpu/command/selfplay.py:333-396 composes them) on the same
window and numpy fork generator, the fork choice's draws and evaluation
symmetries derived from JAX's `fkey`; `find_latest_model`; and whole daemon
runs of the port on the CPU whose every shard JAX reads.

Shards compare by their rows: integer fields exactly, float16 fields within
one float16 step (finalize_targets agrees within 1e-6, tests/test_torch_finalize.py),
float32 fields within 1e-5 (weights relative). SGFs compare by their text.
The daemon's own games are not JAX's: its draws come from a torch.Generator."""

import dataclasses
import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katacoffee_tpu.command import selfplay as JC
from katacoffee_tpu.dataio import checkpoints as JK
from katacoffee_tpu.dataio import trainingwrite as JW
from katacoffee_tpu.dataio.sgf import write_sgf as jax_write_sgf
from katacoffee_tpu.game import board as JB
from katacoffee_tpu.nn.model import CoffeeNet as JaxNet
from katacoffee_tpu.search import mcts as JM
from katacoffee_tpu.selfplay import actor as JA
from katacoffee_tpu.selfplay import forking as JF
from katacoffee_tpu.selfplay import treerecord as JT
from katacoffee_tpu_torch.command import selfplay as TC
from katacoffee_tpu_torch.dataio import checkpoints as TK
from katacoffee_tpu_torch.dataio import trainingwrite as TW
from katacoffee_tpu_torch.dataio.sgf import parse_sgf_file
from katacoffee_tpu_torch.search import mcts as TM
from katacoffee_tpu_torch.selfplay import forking as TF
from test_torch_finalize import torch_traj
from test_torch_search import CFG, ROOT, TCFG, TINYNET, _tinynets
from test_torch_selfplay_segment import JSP, assert_same_states, port_settings
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

A = CFG.policy_size
BATCH, MOVES = 8, 24
SETTINGS = JA.SelfplaySettings(
    num_sims=8, early_fork_game_prob=0.5, fork_game_prob=0.5, record_tree_positions=True, record_tree_threshold=3,
    record_tree_target_weight=0.25, record_tree_capacity=4, fork_pool_capacity=16,
)
F16 = ("policy_target", "opponent_policy_target", "value_target", "td_value_targets")


@functools.lru_cache(maxsize=None)
def _jax_segment():
    """A JAX segment of 24 moves from empty boards (uniform evaluator, 8
    visits): games end, reset and end again inside it."""
    states = jax.vmap(lambda _: JB.init_state(CFG))(jnp.arange(BATCH))
    seg = jax.jit(lambda s, e, k: JA.run_selfplay_segment(CFG, JSP, SETTINGS, JM.uniform_eval_fn(CFG), s, e, k,
                                                          MOVES))
    _, _, traj = seg(states, jnp.zeros((BATCH,), jnp.int32), jax.random.PRNGKey(21))
    return jax.tree_util.tree_map(np.asarray, traj)


def test_extract_episodes_matches_jax():
    jtraj = _jax_segment()
    want = JC.extract_episodes(CFG, jtraj)
    got = TC.extract_episodes(TCFG, torch_traj(jtraj))
    assert got == want and len(want) >= BATCH
    # an episode that began before the window is not written
    cut = jax.tree_util.tree_map(lambda x: x[3:], jtraj)
    assert TC.extract_episodes(TCFG, torch_traj(cut)) == JC.extract_episodes(CFG, cut)


def jax_flush(jtraj, writer, sgf_dir, fork_rng, jev, model_name, seg):
    """selfplay.py:333-396 composed from JAX's public functions. Returns
    (rows, games, pool, fkey, fork candidates)."""
    s = SETTINGS
    rows = writer.add_batch(jax.jit(lambda t: JA.finalize_targets(CFG, s, t))(jtraj))
    rows += writer.add_batch(JT.tree_position_rows(CFG, s, jtraj))
    pool = JF.init_fork_pool(CFG, s.fork_pool_capacity)
    cands = JF.extract_fork_candidates(
        CFG, jtraj, fork_rng, early_fork_prob=s.early_fork_game_prob,
        early_fork_move_prop=s.early_fork_game_expected_move_prop, fork_prob=s.fork_game_prob,
        early_max_choices=s.early_fork_game_max_choices, fork_max_choices=s.fork_game_max_choices)
    Kf = s.fork_pool_capacity
    flat_idx, maxcs, forceds = (a[:Kf] for a in cands)
    k = len(flat_idx)
    pad = Kf - k
    flat = jax.tree_util.tree_map(lambda x: np.asarray(x).reshape((-1,) + x.shape[2:]), jtraj.states)
    cstates = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.concatenate([x[flat_idx], np.broadcast_to(x[:1], (pad,) + x.shape[1:])])), flat)
    cvalid = jnp.asarray(np.arange(Kf) < k)
    cmax = jnp.asarray(np.concatenate([maxcs, np.zeros(pad, np.int32)]))
    cforce = jnp.asarray(np.concatenate([forceds, np.full(pad, -1, np.int32)]))
    fkey = jnp.asarray(fork_rng.integers(0, 2**31, size=2, dtype=np.uint32))
    lanes = max(s.early_fork_game_max_choices, s.fork_game_max_choices)
    new = jax.jit(lambda st, v, m, f, key: JF.choose_fork_moves(
        CFG, jev, st, v, m, f, key, min_choices=s.fork_game_min_choices, num_lanes=lanes))(
        cstates, cvalid, cmax, cforce, fkey)
    pool = JF.refill_pool(pool, new)
    episodes = JC.extract_episodes(CFG, jtraj)
    for i, (moves, winner) in enumerate(episodes):
        with open(os.path.join(sgf_dir, f"seg{seg:06d}_{i:04d}.sgf"), "w") as f:
            f.write(jax_write_sgf(5, 5, 4, moves, model_name, model_name, winner=winner) + "\n")
    return rows, len(episodes), pool, fkey, k


def read_rows(d):
    shards = list(JW.iter_shards(d))
    assert shards
    data = [JW.read_npz_rows(p) for p in shards]
    return {k: np.concatenate([x[k] for x in data]) for k in data[0] if k not in ("schema_version", "board_shape")}


def assert_same_rows(want, got):
    assert want.keys() == got.keys()
    for k in want:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k in F16:
            np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32), atol=1e-3, rtol=1e-3, err_msg=k)
        elif k in ("weight", "opponent_policy_weight"):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=k)
        elif b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=k)
        else:
            assert np.array_equal(a, b), k


def test_flush_window_matches_jax_sequence(tmp_path, monkeypatch):
    jtraj = _jax_segment()
    model, params, tnet = _tinynets()
    jnet = JaxNet(dataclasses.replace(model.spec, dtype=jnp.float32), win_len=CFG.win_len)
    jev = JM.make_nn_eval_fn(CFG, jnet, params, symmetry_randomize=True)
    names = iter(range(10**6))
    monkeypatch.setattr(JW.secrets, "token_hex", lambda n: f"{next(names):0{2 * n}x}")
    dirs = {p: tmp_path / p for p in ("jax_sgfs", "port_sgfs")}
    for d in dirs.values():
        d.mkdir()
    jwriter = JW.TrainingDataWriter(str(tmp_path / "jax_tdata"), CFG, 50)
    rows, games, jpool, fkey, k = jax_flush(jtraj, jwriter, str(dirs["jax_sgfs"]), np.random.default_rng(5), jev,
                                            "net-a", 3)
    jwriter.flush()
    assert k > 0 and rows > 0

    # the port: the same window as two segments, its draws from fkey
    k_n, k_lanes, k_eval = jax.random.split(fkey, 3)
    Kf, lanes = SETTINGS.fork_pool_capacity, SETTINGS.fork_game_max_choices
    syms = torch.from_numpy(np.asarray(jax.random.randint(k_eval, (Kf * lanes,), 0, 8)).astype(np.int64))
    tev = TM.make_nn_eval_fn(TCFG, tnet, symmetry_randomize=True, draw_syms=lambda n: syms[:n])
    draws = TF.ForkChoiceDraws(choices=torch.from_numpy(np.array(jax.random.uniform(k_n, (Kf,)))),
                               lanes=torch.from_numpy(np.array(jax.random.gumbel(k_lanes, (Kf, lanes, A)))))
    ttraj = torch_traj(jtraj)
    halves = [type(ttraj)(*(x.map(lambda y, a=a, b=b: y[a:b]) if isinstance(x, tuple) else x[a:b] for x in ttraj))
              for a, b in ((0, 10), (10, MOVES))]
    twriter = TW.TrainingDataWriter(str(tmp_path / "port_tdata"), TCFG, 50)
    walls = {}
    res = TC.flush_window(TCFG, port_settings(SETTINGS), halves, twriter, eval_fn=tev,
                          fork_pool=TF.init_fork_pool(TCFG, Kf, "cpu"), fork_rng=np.random.default_rng(5),
                          sgf_dir=str(dirs["port_sgfs"]), model_name="net-a", seg=3, device="cpu", fork_draws=draws,
                          walls=walls)
    twriter.flush()
    assert (res.rows, res.games) == (rows, games)
    assert set(walls) == {"finalize", "write", "forks", "sgfs"}
    assert_same_rows(read_rows(str(tmp_path / "jax_tdata")), read_rows(str(tmp_path / "port_tdata")))
    assert_same_states(jpool.states, res.fork_pool.states, "fork pool")
    assert np.array_equal(res.fork_pool.valid.numpy(), np.asarray(jpool.valid)) and res.fork_pool.valid.any()
    sgfs = sorted(os.listdir(dirs["jax_sgfs"]))
    assert len(sgfs) == games and sgfs == sorted(os.listdir(dirs["port_sgfs"])) and sgfs[0] == "seg000003_0000.sgf"
    for n in sgfs:
        assert (dirs["port_sgfs"] / n).read_text() == (dirs["jax_sgfs"] / n).read_text()


def test_find_latest_model_matches_jax(tmp_path):
    models = tmp_path / "models"
    models.mkdir()
    assert TK.find_latest_model(str(models)) is None and JK.find_latest_model(str(models)) is None
    assert TK.find_latest_model(str(tmp_path / "none")) is None

    def export(name, export_time, files=("model.npz", "model.json")):
        d = models / name
        d.mkdir()
        for f in files:
            shutil.copy(os.path.join(TINYNET, f), d / f)
        if "model.json" in files and export_time is not None:
            meta = json.loads((d / "model.json").read_text())
            meta["export_time"] = export_time
            (d / "model.json").write_text(json.dumps(meta))

    export("a", 100.0)
    export("b", 300.0)
    export("c_incomplete", 900.0, files=("model.json",))
    export(".hidden", 950.0)
    export("d_broken", None)
    (models / "d_broken" / "model.json").write_text("{not json")
    assert TK.find_latest_model(str(models)) == JK.find_latest_model(str(models)) == str(models / "b")
    export("e_no_time", 0.0)  # falls back to model.npz's mtime, newer than any export_time above
    assert TK.find_latest_model(str(models)) == JK.find_latest_model(str(models)) == str(models / "e_no_time")
    assert TK.is_complete_model_dir(str(models / "a")) and not TK.is_complete_model_dir(str(models / "c_incomplete"))


def _export_tinynet(models, name, export_time):
    d = models / name
    d.mkdir(parents=True)
    shutil.copy(os.path.join(TINYNET, "model.npz"), d / "model.npz")
    meta = json.loads(open(os.path.join(TINYNET, "model.json")).read())
    meta.update(name=name, export_time=export_time)
    (d / "model.json").write_text(json.dumps(meta))


def jax_reads_everything(base):
    """Every shard under base/selfplay read by JAX's reader and rows_to_batch;
    returns {model: rows}."""
    out = {}
    for model in sorted(os.listdir(os.path.join(base, "selfplay"))):
        rows = 0
        for path in JW.iter_shards(os.path.join(base, "selfplay", model, "tdata")):
            data = JW.read_npz_rows(path)
            batch = JW.rows_to_batch(data, CFG)
            n = data["weight"].shape[0]
            assert batch.states.board.shape == (n, 5, 5) and (data["weight"] > 0).all()
            assert np.isin(data["board"], (0, 1, 2)).all() and np.isin(data["to_move"], (1, 2)).all()
            rows += n
        out[model] = rows
    return out


def test_daemon_swaps_models_between_segments(tmp_path, monkeypatch):
    """A CPU daemon run, B=8, tinynet in models/, two 24-move segments with
    a newer model dropped in between: rows and SGFs land in both models'
    dirs, side positions and forks included, and JAX reads every shard.
    Every evaluation of the run (the segments' searches, the side searches
    and the fork choice) goes through a symmetry-randomizing evaluator."""
    _export_tinynet(tmp_path / "models", "net-a", 100.0)
    made, used = [], {"segment": [], "side": [], "forks": []}

    def record(site, fn, index):
        def call(*args, **kw):
            used[site].append(args[index])
            out = fn(*args, **kw)
            if site == "segment" and len(used[site]) == 1:
                _export_tinynet(tmp_path / "models", "net-b", 200.0)
            return out
        return call

    def make_eval(*args, **kw):
        assert kw.get("symmetry_randomize") and kw.get("generator") is not None
        made.append(make(*args, **kw))
        return made[-1]

    make = TC.make_nn_eval_fn
    monkeypatch.setattr(TC, "make_nn_eval_fn", make_eval)
    monkeypatch.setattr(TC, "run_selfplay_segment", record("segment", TC.run_selfplay_segment, 3))
    monkeypatch.setattr(TC, "run_side_segment", record("side", TC.run_side_segment, 3))
    monkeypatch.setattr(TC, "choose_fork_moves", record("forks", TC.choose_fork_moves, 1))
    spc = TC.SelfplayConfig(batch_size=BATCH, num_sims=8, moves_per_segment=MOVES, segments_per_flush=1,
                            max_segments=2, seed=3, side_position_prob=0.1, early_fork_game_prob=0.5,
                            fork_game_prob=0.5)
    walls = {}
    total = TC.run_selfplay_daemon(str(tmp_path), TCFG, TC.SearchParams.for_selfplay(), spc, device="cpu",
                                   walls=walls)
    assert len(walls["segment"]) == 2 and len(walls["side"]) == 2 and len(made) == 2
    assert len(used["segment"]) == len(used["side"]) == 2 and used["forks"]
    assert all(any(ev is m for m in made) for evs in used.values() for ev in evs)
    assert used["segment"][0] is made[0] and used["segment"][1] is made[1]
    rows = jax_reads_everything(str(tmp_path))
    assert set(rows) == {"net-a", "net-b"} and all(rows.values()) and sum(rows.values()) == total
    for model in rows:
        sgfs = sorted((tmp_path / "selfplay" / model / "sgfs").iterdir())
        assert sgfs
        for p in sgfs:
            sgf = parse_sgf_file(str(p))
            assert sgf.root.get("PB") == model and sgf.result() in ("B+", "W+", "0") and sgf.moves()


def test_daemon_random_model_and_max_rows(tmp_path):
    """With models/ empty the daemon plays the uniform evaluator as
    "random"; max_rows stops it after the first window that reaches it."""
    spc = TC.SelfplayConfig(batch_size=BATCH, num_sims=4, moves_per_segment=MOVES, segments_per_flush=1,
                            max_segments=5, max_rows=1, seed=1, side_position_prob=0.0, early_fork_game_prob=0.0,
                            fork_game_prob=0.0, write_sgfs=False)
    walls = {}
    total = TC.run_selfplay_daemon(str(tmp_path), TCFG, TC.SearchParams.for_selfplay(), spc, device="cpu",
                                   walls=walls)
    assert len(walls["segment"]) == 1 and total >= 1
    assert jax_reads_everything(str(tmp_path)) == {"random": total}
    assert not os.listdir(tmp_path / "selfplay" / "random" / "sgfs")


def test_main_with_a_config_and_overrides(tmp_path):
    _export_tinynet(tmp_path / "out" / "models", "net-c", 100.0)
    cfg = tmp_path / "selfplay.cfg"
    cfg.write_text("@include " + os.path.join(ROOT, "configs", "selfplay.cfg") + "\nunusedKey = 1\n")
    TC.main(["-output-dir", str(tmp_path / "out"), "-config", str(cfg), "-override-config",
             f"numParallelGames={BATCH},maxVisits=4,movesPerSegment={MOVES},segmentsPerFlush=1,maxSegments=1,"
             "sidePositionProb=0.1"], device="cpu")
    log = (tmp_path / "out" / "selfplay.log").read_text()
    assert "using model net-c" in log and "unused config key: unusedKey" in log and "rows/s" in log
    assert jax_reads_everything(str(tmp_path / "out"))["net-c"] > 0
    with pytest.raises(SystemExit):
        TC.main([], device="cpu")  # -output-dir is required
