"""The port's reference-model import (`katacoffee_tpu_torch.nn.refmodel`)
against the JAX package's and against the reference binary's fixtures, on
the CPU, with the random-weights b6c96 that refbuild_patches/make_model.py
writes (seeded; the reference's .bin.gz ModelDesc format).

  * load -> save gives the bytes JAX's save_ref_model writes;
  * the port's features + forward + the reference's postprocessing match
    tests/goldens/refnn/*.json (the repaired reference binary's own
    NNEvaluator output) at tests/test_refmodel.py's tolerances: policy
    rtol 2e-3 / atol 2e-6, win and loss probabilities atol 2e-5, varTimeLeft
    and shorttermWinlossError rtol 2e-4, ownership atol 2e-5;
  * the forward against JAX's ref_forward within 1e-5 on every head (both
    float32; cuDNN-style and XLA convolutions sum in other orders);
  * the line features equal JAX's on random boards and boards with crossing
    runs;
  * the eval fn, with and without symmetry_randomize (JAX's symmetries
    injected), against JAX's within 1e-5;
  * the forward turns TF32 off for its own convolutions and products and
    restores the caller's settings.
"""

import functools
import gzip
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katacoffee_tpu.game import board as JB
from katacoffee_tpu.nn import refmodel as JR
from katacoffee_tpu_torch.game.board import GameConfig, init_state, legal_mask_flat, step
from katacoffee_tpu_torch.nn import refmodel as TR
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = sorted((REPO / "tests" / "goldens" / "refnn").glob("*.json"))
TOL = 1e-5


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("refmodel")
    subprocess.run([sys.executable, str(REPO / "refbuild_patches" / "make_model.py")], cwd=d, check=True,
                   capture_output=True)
    return str(d / "models" / "coffee-b6c96-random.bin.gz")


@pytest.fixture(scope="module")
def models(model_path):
    return JR.load_ref_model(model_path), TR.load_ref_model(model_path)


def test_load_save_matches_jax_bytes(models, tmp_path):
    jm, tm = models
    JR.save_ref_model(jm, str(tmp_path / "jax.bin.gz"))
    TR.save_ref_model(tm, str(tmp_path / "port.bin.gz"))
    data = gzip.open(tmp_path / "port.bin.gz").read()
    assert data == gzip.open(tmp_path / "jax.bin.gz").read()
    again = TR.load_ref_model(str(tmp_path / "port.bin.gz"))
    TR.save_ref_model(again, str(tmp_path / "again.bin.gz"))
    assert gzip.open(tmp_path / "again.bin.gz").read() == data
    assert (again.name, again.version, again.policy_channels) == (jm.name, jm.version, jm.policy_channels)


def _replay(cfg, moves):
    st = init_state(cfg, 1, "cpu")
    for mx, my, d in moves:
        st = step(cfg, st, torch.tensor([d * cfg.area + my * cfg.x_size + mx]))
    return st


@pytest.mark.parametrize("path", FIXTURES, ids=[p.stem for p in FIXTURES])
def test_forward_matches_the_reference_binary(path, models):
    tm = models[1]
    data = json.loads(path.read_text())
    cfg = GameConfig(data["x"], data["y"], data["win_len"])
    for fx in data["fixtures"]:
        st = _replay(cfg, fx["moves"])
        out = {k: v[0].numpy() for k, v in TR.ref_forward(tm, *TR.ref_compat_features(cfg, st)).items()}
        legal = legal_mask_flat(cfg, st)[0].numpy()
        ref_policy = np.asarray(fx["policy"], np.float32)
        assert ref_policy.shape == (cfg.policy_size,)
        assert np.array_equal(legal, ref_policy >= 0.0), fx["moves"]
        lg = np.where(legal, out["policy_logits"], -np.inf)
        p = np.exp(lg - lg[legal].max())
        p = p / p[legal].sum()
        np.testing.assert_allclose(p[legal], ref_policy[legal], rtol=2e-3, atol=2e-6)
        vl = out["value_logits"]
        wl = np.exp(vl[:2] - vl[:2].max())
        wl = wl / wl.sum()
        mover_is_white = len(fx["moves"]) % 2 == 1
        white_win = wl[0] if mover_is_white else wl[1]
        np.testing.assert_allclose(white_win, fx["whiteWinProb"], atol=2e-5)
        np.testing.assert_allclose(1.0 - white_win, fx["whiteLossProb"], atol=2e-5)
        sv = out["sv"]
        np.testing.assert_allclose(np.logaddexp(0.0, sv[3]) * 40.0, fx["varTimeLeft"], rtol=2e-4)
        np.testing.assert_allclose(np.logaddexp(0.0, sv[4] * 0.5) * 0.5, fx["shorttermWinlossError"], rtol=2e-4)
        own = np.tanh(out["ownership"].reshape(-1))
        if not mover_is_white:
            own = -own
        np.testing.assert_allclose(own, np.asarray(fx["ownership"], np.float32), atol=2e-5)


def _boards(cfg, n: int, seed: int) -> np.ndarray:
    """Random boards, then boards with crossing horizontal and vertical
    runs of each length (win_len - 3 .. win_len - 1) through one stone."""
    rng = np.random.default_rng(seed)
    out = list(rng.integers(0, 3, size=(n, cfg.y_size, cfg.x_size)).astype(np.int8))
    for length in range(max(cfg.win_len - 3, 1), cfg.win_len):
        for pla in (1, 2):
            b = np.zeros((cfg.y_size, cfg.x_size), np.int8)
            y, x = cfg.y_size // 2, cfg.x_size // 2
            b[y, x:x + length] = pla
            b[y - 1:y - 1 + length, x + 1] = pla
            b[0, 0], b[-1, -1] = 3 - pla, pla
            out.append(b)
    return np.stack(out)


@pytest.mark.parametrize("shape", [(5, 5, 4), (7, 7, 5), (9, 6, 5)])
def test_line_features_match_jax(shape):
    cfg = GameConfig(*shape)
    boards = _boards(cfg, 24, seed=sum(shape))
    got = TR.ref_compat_line_features(cfg, torch.from_numpy(boards)).numpy()
    jline = jax.jit(functools.partial(JR.ref_compat_line_features, JB.GameConfig(*shape)))
    want = np.stack([np.asarray(jline(jnp.asarray(b))) for b in boards])
    assert np.array_equal(got, want) and want[24:].sum() > 0


def _states(cfg, n: int, seed: int):
    """n random mid-game positions (random legal plies), port and JAX."""
    from katacoffee_tpu.game.board import init_state as jax_init

    rng = np.random.default_rng(seed)
    st = init_state(cfg, n, "cpu")
    for _ in range(6):
        legal = legal_mask_flat(cfg, st).numpy()
        acts = [int(rng.choice(np.flatnonzero(row))) if row.any() else 0 for row in legal]
        st = step(cfg, st, torch.tensor(acts))
    base = jax.vmap(lambda _: jax_init(JB.GameConfig(*cfg)))(jnp.arange(n))
    dtypes = {f: getattr(base, f).dtype for f in base._fields}
    jst = base._replace(**{f: jnp.asarray(getattr(st, f).numpy(), dtypes[f]) for f in base._fields})
    return st, jst


def test_forward_matches_jax(models):
    jm, tm = models
    cfg = GameConfig(5, 5, 4)
    st, jst = _states(cfg, 8, seed=1)
    spatial, glob = TR.ref_compat_features(cfg, st)
    jspatial, jglob = jax.vmap(functools.partial(JR.ref_compat_features, JB.GameConfig(5, 5, 4)))(jst)
    np.testing.assert_array_equal(spatial.numpy(), np.asarray(jspatial))
    np.testing.assert_array_equal(glob.numpy(), np.asarray(jglob))
    got = TR.ref_forward(tm, spatial, glob)
    want = jax.jit(lambda s, g: JR.ref_forward(jm, s, g))(jspatial, jglob)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=TOL, err_msg=k)


def test_forward_turns_tf32_off_inside_and_restores_it(models, monkeypatch):
    """Every convolution and product of the forward runs with TF32 off
    whatever the caller set (PyTorch's default for cuDNN is on), and the
    caller's settings come back afterwards."""
    _, tm = models
    cfg = GameConfig(5, 5, 4)
    seen = []
    kept = TR._conv
    monkeypatch.setattr(TR, "_conv", lambda x, w: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)) or kept(x, w))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    st, _ = _states(cfg, 2, seed=3)
    TR.ref_forward(tm, *TR.ref_compat_features(cfg, st))
    assert seen and set(seen) == {(False, False)}
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("randomize", [False, True])
def test_eval_fn_matches_jax(models, randomize):
    jm, tm = models
    cfg = GameConfig(5, 5, 4)
    st, jst = _states(cfg, 8, seed=2)
    key = jax.random.PRNGKey(7)
    want = jax.jit(JR.make_ref_eval_fn(JB.GameConfig(5, 5, 4), jm, symmetry_randomize=randomize))(jst, key)
    syms = torch.from_numpy(np.array(jax.random.randint(key, (8,), 0, 8)))
    got = TR.make_ref_eval_fn(cfg, tm, symmetry_randomize=randomize, draw_syms=lambda b: syms)(st)
    for f in ("policy", "utility", "wl", "draw", "shortterm_error"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=0, atol=TOL,
                                   err_msg=f)
    assert got.policy_opt is None and bool((got.draw == 0).all())
    np.testing.assert_allclose(got.policy.sum(-1).numpy(), 1.0, rtol=1e-5)
    if randomize:
        plain = TR.make_ref_eval_fn(cfg, tm)(st)
        assert not torch.allclose(plain.policy, got.policy, atol=1e-3)
        with pytest.raises(ValueError, match="generator or draw_syms"):
            TR.make_ref_eval_fn(cfg, tm, symmetry_randomize=True)
