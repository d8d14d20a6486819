"""The port's training-data shards (`katacoffee_tpu_torch/dataio/trainingwrite.py`)
and shuffler (`dataio/shuffle.py`) against the JAX package's: one
numpy-built TrainingBatch written by both writers gives shards equal key for
key in dtype, shape and value (schema v2, weight-0 rows dropped, split at
`max_rows_per_file`, no temporary file left); each package reads the other's
shards and a v1 shard; `shuffle_data` writes the same chunks from the same
directory and seed. Shard names are random in both packages: the tests draw
them from a counter so that shards pair up by name."""

import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katacoffee_tpu.dataio import shuffle as JSH
from katacoffee_tpu.dataio import trainingwrite as JW
from katacoffee_tpu.game import board as JB
from katacoffee_tpu.selfplay import actor as JA
from katacoffee_tpu_torch.dataio import shuffle as TSH
from katacoffee_tpu_torch.dataio import trainingwrite as TW
from katacoffee_tpu_torch.game import board as TB
from katacoffee_tpu_torch.selfplay import actor as TA
from test_torch_finalize import to_torch
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

CFG = JB.GameConfig(5, 5, 4)
TCFG = TB.GameConfig(5, 5, 4)
A = CFG.policy_size


def numpy_batch(seed: int, rows: int = 40) -> JA.TrainingBatch:
    """A TrainingBatch of random numpy rows, about a quarter with weight 0."""
    rng = np.random.default_rng(seed)
    Y, X = CFG.y_size, CFG.x_size

    def probs(*shape):
        p = rng.random(shape).astype(np.float32)
        return (p / p.sum(-1, keepdims=True)).astype(np.float32)

    states = JB.GameState(
        board=rng.integers(0, 3, (rows, Y, X)).astype(np.int8),
        to_move=rng.integers(1, 3, rows).astype(np.int8),
        last_spot=rng.integers(-1, CFG.area, rows).astype(np.int32),
        last_dir=rng.integers(0, 5, rows).astype(np.int32),
        done=np.zeros(rows, bool),
        winner=np.zeros(rows, np.int8),
        num_turns=rng.integers(0, 25, rows).astype(np.int32),
        recent_spots=rng.integers(-1, CFG.area, (rows, 6)).astype(np.int32),
        recent_dirs=rng.integers(0, 5, (rows, 6)).astype(np.int32),
        stone_hash=rng.integers(0, 2**32, (rows, 2), dtype=np.uint64).astype(np.uint32),
    )
    weight = np.where(rng.random(rows) < 0.25, 0.0, rng.uniform(0.1, 2.0, rows)).astype(np.float32)
    return JA.TrainingBatch(
        states=states,
        policy_target=probs(rows, A),
        opponent_policy_target=probs(rows, A),
        value_target=np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)],
        td_value_targets=probs(rows, 3, 3),
        ownership_target=rng.integers(-1, 2, (rows, Y, X)).astype(np.float32),
        line_target=rng.integers(0, 5, (rows, Y, X)).astype(np.int32),
        futurepos_target=rng.integers(-1, 2, (rows, 2, Y, X)).astype(np.float32),
        var_time_left_target=rng.integers(1, 20, rows).astype(np.float32),
        shortterm_value_target=rng.uniform(-1, 1, rows).astype(np.float32),
        weight=weight,
        opponent_policy_weight=weight * (rng.random(rows) < 0.8),
        aux_weight=(rng.random(rows) < 0.7).astype(np.float32),
    )


def as_jax(b):
    return JA.TrainingBatch(*(JB.GameState(*map(jnp.asarray, x)) if isinstance(x, JB.GameState) else jnp.asarray(x)
                              for x in b))


def as_torch(b):
    return TA.TrainingBatch(*(TB.GameState(*map(to_torch, x)) if isinstance(x, JB.GameState) else to_torch(x)
                              for x in b))


@pytest.fixture
def counted_names(monkeypatch):
    """Shard names from a counter (restartable per writer) instead of random."""
    counter = [itertools.count()]

    def restart():
        counter[0] = itertools.count()

    monkeypatch.setattr(JW.secrets, "token_hex", lambda n: f"{next(counter[0]):0{2 * n}x}")
    return restart


def write_both(tmp_path, batches, max_rows, restart):
    dirs = {}
    for name, mod, conv in (("jax", JW, as_jax), ("port", TW, as_torch)):
        restart()
        d = tmp_path / name
        w = mod.TrainingDataWriter(str(d), CFG if name == "jax" else TCFG, max_rows)
        added = [w.add_batch(conv(b)) for b in batches]
        w.flush()
        dirs[name] = (str(d), added, w.total_rows_written)
    return dirs


@pytest.mark.parametrize("max_rows", [1000, 7])
def test_shards_are_equal_key_for_key(tmp_path, counted_names, max_rows):
    batches = [numpy_batch(0), numpy_batch(1, rows=13)]
    dirs = write_both(tmp_path, batches, max_rows, counted_names)
    (jd, jadded, jtotal), (td, tadded, ttotal) = dirs["jax"], dirs["port"]
    kept = [int((b.weight > 0).sum()) for b in batches]
    assert tadded == jadded == kept and ttotal == jtotal == sum(kept)
    names = sorted(os.listdir(td))
    assert names == sorted(os.listdir(jd)) and not any(n.endswith(".tmp") for n in names)
    assert len(names) == -(-sum(kept) // max_rows)
    for n in names:
        with np.load(os.path.join(jd, n)) as zj, np.load(os.path.join(td, n)) as zt:
            assert sorted(zt.files) == sorted(zj.files)
            for k in zj.files:
                assert zt[k].dtype == zj[k].dtype and zt[k].shape == zj[k].shape, k
                assert np.array_equal(zt[k], zj[k]), k
            assert zt["schema_version"].tolist() == [2] and zt["weight"].shape[0] <= max_rows
            assert (zt["weight"] > 0).all()


def assert_same_read_batch(jbatch, tbatch):
    for name, t, j in zip(JA.TrainingBatch._fields, tbatch, jbatch):
        if name == "states":
            for sname, a, b in zip(TB.GameState._fields, t, j):
                assert np.array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype)), sname
            continue
        assert t.shape == j.shape and np.array_equal(t.numpy(), np.asarray(j).astype(t.numpy().dtype)), name


def test_each_package_reads_the_others_shards(tmp_path, counted_names):
    dirs = write_both(tmp_path, [numpy_batch(2)], 1000, counted_names)
    (jpath,), (tpath,) = (list(JW.iter_shards(dirs[n][0])) for n in ("jax", "port"))
    assert list(TW.iter_shards(dirs["port"][0])) == [tpath]
    from_port = JW.read_npz_rows(tpath)  # JAX reads the port's shard
    from_jax = TW.read_npz_rows(jpath)  # the port reads JAX's
    assert from_port.keys() == from_jax.keys()
    for k in from_jax:
        assert np.array_equal(from_port[k], from_jax[k]), k
    jbatch = JW.rows_to_batch(from_port, CFG)
    tbatch = TW.rows_to_batch(from_jax, TCFG, device="cpu")
    assert_same_read_batch(jbatch, tbatch)
    assert tbatch.states.board.dtype == torch.int8 and tbatch.policy_target.dtype == torch.float32


def test_v1_shards_read_with_aux_weight_one_and_other_versions_fail(tmp_path):
    arrays = TW.batch_to_arrays(as_torch(numpy_batch(3)), TCFG)
    v1 = {k: v for k, v in arrays.items() if k != "aux_weight"}
    v1["schema_version"] = np.asarray([1], np.int32)
    np.savez_compressed(tmp_path / "v1.npz", **v1)
    got, want = TW.read_npz_rows(str(tmp_path / "v1.npz")), JW.read_npz_rows(str(tmp_path / "v1.npz"))
    assert np.array_equal(got["aux_weight"], want["aux_weight"]) and (got["aux_weight"] == 1).all()
    assert_same_read_batch(JW.rows_to_batch(want, CFG), TW.rows_to_batch(got, TCFG, device="cpu"))
    v3 = dict(arrays, schema_version=np.asarray([3], np.int32))
    np.savez_compressed(tmp_path / "v3.npz", **v3)
    for mod in (TW, JW):
        with pytest.raises(ValueError, match="schema version 3"):
            mod.read_npz_rows(str(tmp_path / "v3.npz"))


def test_shuffle_data_and_window_match_jax(tmp_path, counted_names):
    for rows in (0, 100, 250_000, 250_001, 1_000_000, 37_000_000):
        for kw in (dict(), dict(min_rows=50, expand_window_per_row=0.6, taper_window_exponent=0.8)):
            assert TSH.compute_window_size(rows, **kw) == JSH.compute_window_size(rows, **kw)
    src = tmp_path / "tdata"
    w = TW.TrainingDataWriter(str(src), TCFG, 9)
    for seed in range(4):
        w.add_batch(as_torch(numpy_batch(10 + seed)))
    w.flush()
    kw = dict(min_rows=40, expand_window_per_row=0.5, chunk_rows=16, seed=5, val_prop=0.2, keep_target_rows=70)
    outs = {}
    for name, mod in (("jax", JSH), ("port", TSH)):
        counted_names()
        d = tmp_path / f"shuffled_{name}"
        outs[name] = (mod.shuffle_data([str(src), str(tmp_path / "missing")], str(d), **kw), d)
    (jstats, jd), (tstats, td) = outs["jax"], outs["port"]
    assert tstats == jstats and tstats["chunks"] > 1 and tstats["val_chunks"] >= 1
    for sub in ("", "val"):
        names = sorted(n for n in os.listdir(jd / sub) if n.endswith(".npz"))
        assert names and names == sorted(n for n in os.listdir(td / sub) if n.endswith(".npz"))
        for n in names:
            with np.load(jd / sub / n) as zj, np.load(td / sub / n) as zt:
                assert sorted(zt.files) == sorted(zj.files)
                for k in zj.files:
                    assert zt[k].dtype == zj[k].dtype and np.array_equal(zt[k], zj[k]), (n, k)
