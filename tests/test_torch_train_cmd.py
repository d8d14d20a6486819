"""The port's trainer command (`katacoffee_tpu_torch/command/train.py`),
`validate` and `checkpoint dump` against the JAX package's, on the CPU.

- `_batch_iterator` draws the JAX iterator's numpy stream: the same rows in
  the same order over 2 epochs.
- The whole slice: JAX `run_training` and the port's, each 4 steps from one
  JAX-written checkpoint on the same shuffled shards (b2c16 with the trunk
  in float32 in both packages, patched in this test only; augmentation off,
  so no threefry draw is needed; a checkpoint, val metrics and an export
  every 2 steps). The same files; checkpoints, metrics lines and exported
  weights within |d| <= 1e-5 * max(|x|, 1) per leaf (float32 gradients
  summed in another order, as in tests/test_torch_train_step.py).
- `validate` prints the JAX command's keys and values (within 1e-5
  relative, after both round to 6 decimals); `checkpoint dump` prints the
  same text.
- `run_training_mixed` over two board sizes runs, checkpoints and exports.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katacoffee_tpu.command import checkpoint as JCK
from katacoffee_tpu.command import train as JCT
from katacoffee_tpu.command import validate as JV
from katacoffee_tpu.dataio import checkpoints as JC
from katacoffee_tpu.game import board as JB
from katacoffee_tpu.nn import configs as JNC
from katacoffee_tpu.nn import model as JNM
from katacoffee_tpu.train import train as JT
from katacoffee_tpu_torch.command import checkpoint as TCK
from katacoffee_tpu_torch.command import train as TCT
from katacoffee_tpu_torch.command import validate as TV
from katacoffee_tpu_torch.dataio import checkpoints as TC
from katacoffee_tpu_torch.game import board as TB
from katacoffee_tpu_torch.nn import configs as TNC
from katacoffee_tpu_torch.train import train as TT
from katacoffee_tpu_torch.utils.logger import Logger
from torch_parity import one_torch_thread, training_rows, write_shard  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "artifacts/flagship_b6c96/train/run/checkpoint.ckpt")
CFG = JB.GameConfig(5, 5, 4)
TCFG = TB.GameConfig(5, 5, 4)
TOL = 1e-5


def close(want, got, what):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert want.shape == got.shape, what
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    err = float(np.abs(want - got).max(initial=0.0))
    assert err <= TOL * scale, f"{what}: |d| {err} > {TOL} * {scale}"


def f32_specs(monkeypatch):
    """Both packages build every spec with a float32 trunk."""
    jget, tget = JNC.get_model_spec, TNC.get_model_spec
    jspec = lambda name: dataclasses.replace(jget(name), dtype=jnp.float32)  # noqa: E731
    tspec = lambda name: dataclasses.replace(tget(name), dtype=torch.float32)  # noqa: E731
    monkeypatch.setattr(JCT, "get_model_spec", jspec)
    monkeypatch.setattr(JNC, "get_model_spec", jspec)
    monkeypatch.setattr(TCT, "get_model_spec", tspec)
    monkeypatch.setattr(TC, "get_model_spec", tspec)


def shuffled_data(base, sizes=(40, 25), val=20, seed=0):
    for i, n in enumerate(sizes):
        write_shard(os.path.join(base, "shuffleddata"), training_rows(CFG, n, seed + i), f"shuffled_{i:05d}")
    if val:
        write_shard(os.path.join(base, "shuffleddata", "val"), training_rows(CFG, val, seed + 99), "shuffled_v")


def test_batch_iterator_yields_the_jax_rows_in_order(tmp_path):
    shuffled_data(str(tmp_path), sizes=(40, 25, 9), val=0)
    d = str(tmp_path / "shuffleddata")
    want = JCT._batch_iterator(d, 8, np.random.default_rng(5))
    got = TCT._batch_iterator(d, 8, np.random.default_rng(5), TCFG, torch.device("cpu"))
    epochs = []
    for _ in range(2 * (5 + 3 + 1)):
        (we, wb), (ge, gb) = next(want), next(got)
        assert we == ge
        epochs.append(ge)
        for w, g in zip(jax.tree_util.tree_leaves(wb), jax.tree_util.tree_leaves(tuple(gb))):
            assert np.array_equal(np.asarray(w), g.numpy())
    assert epochs[0] == 0 and epochs[-1] == 1 and next(got)[0] == 2


def test_batch_iterator_waits_without_shards(tmp_path):
    os.makedirs(tmp_path / "shuffleddata")
    it = TCT._batch_iterator(str(tmp_path / "shuffleddata"), 8, np.random.default_rng(0), TCFG,
                             torch.device("cpu"))
    assert next(it) == (None, None)


def files_under(base):
    out = []
    for d, _, names in os.walk(base):
        out += [os.path.relpath(os.path.join(d, n), base) for n in names]
    return sorted(out)


def test_run_training_matches_jax(tmp_path, monkeypatch):
    f32_specs(monkeypatch)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for d in (jdir, tdir):
        shuffled_data(d)
    # the starting checkpoint: JAX's fresh b2c16 state with its gates and
    # biases moved off zero, written by JAX at step 10
    jmodel = JNM.CoffeeNet(JNC.get_model_spec("b2c16"), win_len=4)
    kw = dict(symmetry_augment=False, history_mask=False, warmup_samples_scale=1e-5, learning_rate=0.05)
    state = JT.init_train_state(jmodel, CFG, JT.TrainConfig(**kw), 16, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    state = state._replace(params=jax.tree_util.tree_map(
        lambda x: x + rng.normal(0, 0.2 if x.ndim < 2 else 0.05, x.shape).astype(np.float32), state.params))
    os.makedirs(os.path.join(jdir, "train", "run"))
    JC.save_checkpoint(os.path.join(jdir, "train", "run", "checkpoint.ckpt"), state, extra={"train_step": 10})
    shutil.copytree(os.path.join(jdir, "train"), os.path.join(tdir, "train"))

    trc = dict(model="b2c16", batch_size=16, max_steps=4, checkpoint_every=2, steps_per_export=2, seed=3)
    quiet = Logger()
    assert JCT.run_training(jdir, CFG, JT.TrainConfig(**kw), JCT.TrainerConfig(use_mesh=False, **trc), quiet) == 4
    assert TCT.run_training(tdir, TCFG, TT.TrainConfig(**kw), TCT.TrainerConfig(**trc), quiet, device="cpu") == 4

    assert files_under(jdir) == files_under(tdir)
    assert {"modelstobetested/run-s12/model.npz", "modelstobetested/run-s14/model.json",
            "train/run/checkpoint.ckpt.prev", "train/run/metrics_val.json"} <= set(files_under(tdir))
    ckpt = "train/run/checkpoint.ckpt"
    for name in (ckpt, ckpt + ".prev"):
        (jm, jblob), (tm, tblob) = (TC.read_raw(os.path.join(d, name)) for d in (jdir, tdir))
        assert jm["train_step"] == tm["train_step"]
        jt, tt = TC.flatten(TC.flaxbytes.decode(jblob)), TC.flatten(TC.flaxbytes.decode(tblob))
        assert jt.keys() == tt.keys()
        for k in jt:
            assert jt[k].dtype == tt[k].dtype, k
            close(jt[k], tt[k], f"{name} {k}")
    # the state's own step and count start at JAX's 0; the meta carries the run's
    assert int(tt["step"]) == 4 and int(tt["opt_state/2/1/count"]) == 4 and tm["train_step"] == 14
    for name in ("metrics_train.json", "metrics_val.json"):
        lines = [[json.loads(x) for x in open(os.path.join(d, "train", "run", name))] for d in (jdir, tdir)]
        assert len(lines[0]) == len(lines[1]) == (1 if name == "metrics_train.json" else 3)
        for jl, tl in zip(*lines):
            assert jl.keys() == tl.keys()
            for k in jl:
                if k != "time":
                    close(jl[k], tl[k], f"{name} {k}")
    for step in (12, 14):
        rel = f"modelstobetested/run-s{step}"
        with np.load(os.path.join(jdir, rel, "model.npz")) as a, np.load(os.path.join(tdir, rel, "model.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                close(a[k], b[k], f"{rel} {k}")
        jmeta, tmeta = (json.load(open(os.path.join(d, rel, "model.json"))) for d in (jdir, tdir))
        jmeta.pop("export_time"), tmeta.pop("export_time")
        assert jmeta == tmeta


def test_validate_prints_what_jax_prints(tmp_path, monkeypatch, capsys):
    f32_specs(monkeypatch)
    shuffled_data(str(tmp_path), sizes=(30, 20), val=0)
    data = str(tmp_path / "shuffleddata")
    model = os.path.join(ROOT, "artifacts/flagship_b6c96/models/run-s5200")
    for argv in ([model, data], [model, data, data, "-max-rows", "45"]):
        assert JV.main(argv) == 0
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert TV.main(argv, device="cpu") == 0
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert want.keys() == got.keys() and want["rows"] == got["rows"] and want["model"] == got["model"]
        for k, v in want.items():
            if isinstance(v, float):
                assert abs(v - got[k]) <= 1e-5 * max(abs(v), 1.0) + 1e-6, k
    empty = tmp_path / "empty"
    empty.mkdir()
    assert TV.main([model, str(empty)], device="cpu") == 1
    assert json.loads(capsys.readouterr().out) == {"error": "no rows found"}


def test_checkpoint_dump_and_edit_print_what_jax_prints(tmp_path, capsys):
    for argv in (["dump", "-checkpoint", FLAGSHIP], ["dump", "-checkpoint", FLAGSHIP, "-shapes"]):
        assert JCK.main(argv) == 0
        want = capsys.readouterr().out
        assert TCK.main(argv) == 0
        assert capsys.readouterr().out == want
    path = str(tmp_path / "checkpoint.ckpt")
    shutil.copy(FLAGSHIP, path)
    assert TCK.main(["edit", "-checkpoint", path, "-set", "train_step=7", "-set", "note=x"]) == 0
    meta, blob = TC.read_raw(path)
    assert meta["train_step"] == 7 and meta["note"] == "x" and blob == TC.read_raw(FLAGSHIP)[1]


def test_checkpoint_export_writes_the_ema_weights(tmp_path, capsys):
    out = str(tmp_path / "models")
    argv = ["export", "-checkpoint", FLAGSHIP, "-model", "b6c96", "-out-dir", out]
    assert TCK.main(argv, device="cpu") == 0
    assert TCK.main(argv + ["-raw-params", "-name", "raw"], device="cpu") == 0
    tree = TC.flaxbytes.decode(TC.read_raw(FLAGSHIP)[1])
    for name, field in (("export-s5200", "ema_params"), ("raw", "params")):
        want = TC.flatten(tree[field])
        with np.load(os.path.join(out, name, "model.npz")) as z:
            assert sorted(z.files) == sorted(want)
            assert all(np.array_equal(z[k], want[k]) for k in z.files)
        meta = json.load(open(os.path.join(out, name, "model.json")))
        assert meta["train_step"] == 5200 and meta["model"] == "b6c96"


def test_run_training_mixed_over_two_sizes(tmp_path):
    """One net on 5x5 win 4 and 6x6 win 5: steps drawn over both sizes, the
    line head sized for win 5, a checkpoint and an export."""
    base = str(tmp_path)
    cfgs = [TB.GameConfig(5, 5, 4), TB.GameConfig(6, 6, 5)]
    for i, c in enumerate(cfgs):
        rows = training_rows(JB.GameConfig(c.x_size, c.y_size, c.win_len), 24, seed=50 + i)
        write_shard(os.path.join(base, "shuffleddata", f"{c.x_size}x{c.y_size}w{c.win_len}"), rows, "s0")
    trc = TCT.TrainerConfig(model="b1c6", batch_size=8, max_steps=6, checkpoint_every=3, steps_per_export=3)
    steps = TCT.run_training_mixed(base, cfgs, TT.TrainConfig(), trc, Logger(), device="cpu")
    assert steps == 6
    lines = [json.loads(x) for x in open(os.path.join(base, "train", "run", "metrics_train.json"))]
    assert lines[0]["step"] == 1 and lines[0]["size"] in ("5x5w4", "6x6w5")
    assert all(np.isfinite(v) for m in lines for k, v in m.items() if k != "size")
    model, cfg, meta = TC.load_exported_model(os.path.join(base, "modelstobetested", "run-s6"), "cpu")
    assert (cfg.win_len, meta["train_step"]) == (5, 6) and model.value_head.conv3.weight.shape[0] == 6
    state, meta = TC.load_checkpoint(os.path.join(base, "train", "run", "checkpoint.ckpt"),
                                     TT.init_train_state(model.float()))
    assert (state.step, meta["train_step"]) == (6, 6)
    with pytest.raises(FileNotFoundError):
        TCT.run_training_mixed(str(tmp_path / "none"), cfgs, TT.TrainConfig(), trc, Logger(), device="cpu")
