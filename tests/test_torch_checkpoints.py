"""The port's trainer checkpoints and model export
(`katacoffee_tpu_torch/dataio/checkpoints.py`, msgpack codec
`dataio/flaxbytes.py`) against the JAX package's, in both directions.

- The codec re-encodes the flagship checkpoint's blob byte for byte and
  decodes it to the arrays flax's `msgpack_restore` gives; every msgpack
  form it writes is msgpack-python's.
- A checkpoint the port writes is read by JAX `load_checkpoint` into equal
  arrays; one JAX writes resumes in the port and its next 2 steps agree
  with JAX's within |d| <= 1e-5 * max(|x|, 1) per leaf (float32 sums in
  another order, as in tests/test_torch_train_step.py).
- `params_to_jax` inverts `params_from_jax` bitwise, for every model spec.
- A model the port exports is loaded by JAX `load_exported_model` with the
  same bits, and both nets' heads agree within 1e-4 in float32.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from katacoffee_tpu.dataio import checkpoints as JC
from katacoffee_tpu.dataio import trainingwrite as JW
from katacoffee_tpu.game import board as JB
from katacoffee_tpu.nn import configs as JNC
from katacoffee_tpu.nn import features as JF
from katacoffee_tpu.nn import model as JNM
from katacoffee_tpu.train import train as JT
from katacoffee_tpu_torch.dataio import checkpoints as TC
from katacoffee_tpu_torch.dataio import flaxbytes
from katacoffee_tpu_torch.dataio import trainingwrite as TW
from katacoffee_tpu_torch.game import board as TB
from katacoffee_tpu_torch.nn import configs as TNC
from katacoffee_tpu_torch.nn import model as TNM
from katacoffee_tpu_torch.train import train as TT
from torch_parity import one_torch_thread, training_rows  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "artifacts/flagship_b6c96/train/run/checkpoint.ckpt")
RUN_S5200 = os.path.join(ROOT, "artifacts/flagship_b6c96/models/run-s5200")
CFG = JB.GameConfig(5, 5, 4)
TCFG = TB.GameConfig(5, 5, 4)
TOL = 1e-5


def blob_of(path):
    return TC.read_raw(path)[1]


def jax_tree(state):
    return jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(state))


def flat_leaves(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_codec_reencodes_the_flagship_blob_byte_for_byte():
    meta, blob = TC.read_raw(FLAGSHIP)
    assert meta["train_step"] == 5200
    tree = flaxbytes.decode(blob)
    assert flaxbytes.encode(tree) == blob
    want = flat_leaves(serialization.msgpack_restore(blob))
    got = TC.flatten(tree)
    assert got.keys() == want.keys() and len(got) == 176
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
    assert tree["opt_state"]["0"] == {} and tree["opt_state"]["1"] == {"inner_state": {}}
    assert int(tree["opt_state"]["2"]["1"]["count"]) == 2400 and int(tree["step"]) == 5200


VALUES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63, -1, -32, -33, -128, -129, -32768,
          -32769, -2**31, -2**31 - 1, -2**63, 1.5, -0.0, True, False, None, "", "a" * 31, "b" * 32, "c" * 300,
          "d" * 70000, "é", b"", b"x" * 300, b"y" * 70000, list(range(15)), list(range(16)), [1, "a"],
          list(range(70000)), {str(i): i for i in range(15)}, {str(i): {"x": [i]} for i in range(16)},
          {str(i): i for i in range(70000)}, np.float32(3.5), np.int64(-7), np.bool_(True),
          np.zeros((2, 3), np.int16), np.arange(5, dtype=np.uint8), np.zeros(0, np.float32),
          np.ones((1,), np.float64), np.zeros((2,), np.float32), np.zeros((), np.int32), np.ones((3, 90), np.int8)]


@pytest.mark.parametrize("value", VALUES, ids=lambda v: type(v).__name__ + str(np.shape(v)))
def test_codec_writes_and_reads_what_msgpack_does(value):
    want = msgpack.packb(value, use_bin_type=True, default=serialization._msgpack_ext_pack, strict_types=True)
    got = flaxbytes.encode(value)
    assert got == want
    back = flaxbytes.decode(got)
    ref = msgpack.unpackb(want, ext_hook=serialization._msgpack_ext_unpack, raw=False, strict_map_key=False)
    if isinstance(value, (np.ndarray, np.generic)):
        assert type(back) is type(ref) and back.dtype == ref.dtype and np.array_equal(back, ref)
    else:
        assert back == ref


def test_codec_refuses_what_flax_would_chunk(monkeypatch):
    monkeypatch.setattr(flaxbytes, "MAX_CHUNK_SIZE", 64)
    assert flaxbytes.encode({"a": np.zeros(16, np.float32)})
    with pytest.raises(ValueError, match="MAX_CHUNK_SIZE"):
        flaxbytes.encode({"a": np.zeros(17, np.float32)})
    with pytest.raises(TypeError):
        flaxbytes.encode({"a": object()})
    with pytest.raises(ValueError):
        flaxbytes.decode(b"\x92\x01")  # truncated


def test_flagship_resaved_by_the_port_keeps_its_bytes(tmp_path):
    model = TNM.CoffeeNet(TNC.get_model_spec("b6c96"), 4)
    state, meta = TC.load_checkpoint(FLAGSHIP, TT.init_train_state(model))
    assert (state.count, state.step, meta["train_step"]) == (2400, 5200, 5200)
    path = str(tmp_path / "checkpoint.ckpt")
    TC.save_checkpoint(path, state, extra={"train_step": 5200})
    assert blob_of(path) == blob_of(FLAGSHIP)
    TC.save_checkpoint(path, state, extra={"train_step": 5201})
    assert TC.read_raw(path + ".prev")[0]["train_step"] == 5200 and TC.read_raw(path)[0]["train_step"] == 5201
    assert sorted(os.listdir(tmp_path)) == ["checkpoint.ckpt", "checkpoint.ckpt.prev"]


def test_port_checkpoint_is_read_by_jax(tmp_path):
    """A fresh port state with a nonzero trace, count and step, saved by the
    port and read by JAX `load_checkpoint` into equal arrays."""
    model = TNM.CoffeeNet(TNC.get_model_spec("b2c16"), 4)
    state = TT.init_train_state(model, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    state.trace = {k: torch.randn(v.shape, generator=g) for k, v in state.trace.items()}
    state.ema = {k: v + 0.5 for k, v in state.ema.items()}
    state.count, state.step = 17, 1234
    path = str(tmp_path / "checkpoint.ckpt")
    TC.save_checkpoint(path, state, extra={"train_step": 1234})
    jmodel = JNM.CoffeeNet(JNC.get_model_spec("b2c16"), win_len=4)
    template = JT.init_train_state(jmodel, CFG, JT.TrainConfig(), 8, jax.random.PRNGKey(0))
    jstate, meta = JC.load_checkpoint(path, template)
    assert meta["train_step"] == 1234
    want = TC.flatten(TC.state_to_tree(state))
    got = TC.flatten(jax_tree(jstate))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert int(jstate.step) == 1234 and int(jstate.opt_state[2][1].count) == 17


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX state after one step (nonzero trace), saved by JAX, loaded by
    the port; then 2 more steps on each side agree."""
    tc = dict(grad_clip=1.0, warmup_samples_scale=1e-5, learning_rate=0.05)
    jtc, ttc = JT.TrainConfig(**tc), TT.TrainConfig(**tc)
    spec = dataclasses.replace(JNC.get_model_spec("b2c16"), dtype=jnp.float32)
    jmodel = JNM.CoffeeNet(spec, win_len=4)
    jstate = JT.init_train_state(jmodel, CFG, jtc, 24, jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    jstate = jstate._replace(params=jax.tree_util.tree_map(
        lambda x: x + rng.normal(0, 0.2 if x.ndim < 2 else 0.05, x.shape).astype(np.float32), jstate.params))
    jstep = JT.make_train_step(jmodel, CFG, jtc, 24)

    def batch_and_draws(i):
        rows = training_rows(CFG, 24, seed=30 + i)
        key = jax.random.PRNGKey(40 + i)
        draws = TT.StepDraws(torch.from_numpy(np.array(jax.random.randint(key, (24,), 0, 8))),
                             torch.from_numpy(np.array(JF.sample_history_levels(jax.random.fold_in(key, 0x415), 24,
                                                                                jtc.history_keep_prob))))
        return rows, key, draws

    rows, key, _ = batch_and_draws(0)
    jstate, _ = jstep(jstate, JW.rows_to_batch(rows, CFG), key)
    path = str(tmp_path / "checkpoint.ckpt")
    JC.save_checkpoint(path, jstate, extra={"train_step": 1})
    tmodel = TNM.CoffeeNet(dataclasses.replace(TNC.get_model_spec("b2c16"), dtype=torch.float32), 4)
    tstate, meta = TC.load_checkpoint(path, TT.init_train_state(tmodel, torch.Generator().manual_seed(0)))
    assert meta["train_step"] == 1 and tstate.count == tstate.step == 1
    assert float(torch.stack([t.abs().max() for t in tstate.trace.values()]).max()) > 0
    tstep = TT.make_train_step(TCFG, ttc, 24)
    for i in (1, 2):
        rows, key, draws = batch_and_draws(i)
        jstate, want = jstep(jstate, JW.rows_to_batch(rows, CFG), key)
        tstate, got = tstep(tstate, TW.rows_to_batch(rows, TCFG, "cpu"), draws=draws)
        for k in want:
            w, g = float(want[k]), float(got[k])
            assert abs(w - g) <= TOL * max(abs(w), 1.0), (i, k, w, g)
        jt, tt = TC.flatten(jax_tree(jstate)), TC.flatten(TC.state_to_tree(tstate))
        for k in jt:
            d = float(np.abs(jt[k].astype(np.float64) - tt[k]).max(initial=0.0))
            assert d <= TOL * max(float(np.abs(jt[k]).max(initial=0.0)), 1.0), (i, k, d)
    assert tstate.step == 3


def test_params_to_jax_inverts_params_from_jax_bitwise():
    with np.load(os.path.join(RUN_S5200, "model.npz")) as z:
        flat = {k: z[k] for k in z.files}
    back = TC.params_to_jax(TC.params_from_jax(flat))
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape and back[k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("name", TNC.model_names())
def test_keys_and_shapes_round_trip_for_every_spec(name):
    """The port's state dict maps onto JAX init_params' flat keys and shapes
    (the nbt specs' alpha_inner_* included) and back."""
    shapes = jax.eval_shape(lambda: JNM.init_params(JNM.CoffeeNet(JNC.get_model_spec(name), win_len=4), CFG,
                                                    jax.random.PRNGKey(0)))
    want = {k: tuple(v.shape) for k, v in flat_leaves(shapes).items()}
    with torch.device("meta"):
        model = TNM.CoffeeNet(TNC.get_model_spec(name), 4)
    got = {TC._jax_key(n): p for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for n, p in model.named_parameters():
        k = TC._jax_key(n)
        t = tuple(p.shape)
        assert ((t[2], t[3], t[1], t[0]) if p.dim() == 4 else t[::-1] if p.dim() == 2 else t) == want[k], k
        assert TC._torch_key(k) == n
    if "nbt" in name:
        assert any("alpha_inner_1" in k for k in got)


def test_port_export_is_read_by_jax(tmp_path, monkeypatch):
    model, cfg, meta = TC.load_exported_model(RUN_S5200, "cpu", dtype=torch.float32)
    out = TC.export_model(str(tmp_path), "run-s5201", dict(model.named_parameters()), meta["model"], cfg,
                          extra={"train_step": 5201})
    assert sorted(os.listdir(tmp_path)) == ["run-s5201"] and TC.is_complete_model_dir(out)
    assert TC.find_latest_model(str(tmp_path)) == out
    with np.load(os.path.join(RUN_S5200, "model.npz")) as a, np.load(os.path.join(out, "model.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    f32 = dataclasses.replace(JNC.get_model_spec("b6c96"), dtype=jnp.float32)
    monkeypatch.setattr(JNC, "get_model_spec", lambda name: f32)
    jmodel, params, jcfg, jmeta = JC.load_exported_model(out)
    assert (jcfg.x_size, jcfg.y_size, jcfg.win_len, jmeta["train_step"], jmeta["model"]) == (5, 5, 4, 5201, "b6c96")
    rng = np.random.default_rng(0)
    spatial = (rng.random((6, 18, 5, 5)) < 0.3).astype(np.float32)
    glob = np.full((6, 1), 4.0, np.float32)
    want = jmodel.apply(params, jnp.asarray(spatial), jnp.asarray(glob))
    with torch.no_grad():
        got = model(torch.from_numpy(spatial), torch.from_numpy(glob))
    for k in want:
        np.testing.assert_allclose(np.asarray(want[k]), got[k].numpy(), atol=1e-4, rtol=0, err_msg=k)
