"""The port's child-stats row gather (`katacoffee_tpu_torch.ops.gather`)
against the JAX package's: `gather_rows_plain` equals the XLA one-hot einsum
and the Pallas kernel (run by the Pallas interpreter, as tests/test_ops.py
runs it) exactly, missing (-1) and out-of-range children included. The CUDA
kernel itself is held against `gather_rows_plain` on the card by
chip_smoke.py; here only its CPU path and its build rules run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import katacoffee_tpu.ops.gather as G
from katacoffee_tpu_torch.ops import _build
from katacoffee_tpu_torch.ops.gather import SOURCE, gather_rows, gather_rows_plain
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

SHAPES = [(16, 64, 8, 24), (8, 130, 8, 100)]


def _pallas_interpret(table, idx):
    B, N, S = table.shape
    A = idx.shape[1]
    A_pad = -(-A // 128) * 128
    idx = jnp.pad(idx, ((0, 0), (0, A_pad - A)))
    tb, ca = G._tiling(B, A_pad, N)
    out = pl.pallas_call(
        G._gather_kernel,
        grid=(B // tb, A_pad // ca),
        in_specs=[
            pl.BlockSpec((tb, ca), lambda i, j: (i, j)),
            pl.BlockSpec((tb, N, S), lambda i, j: (i, 0, 0)),
        ],
        out_specs=pl.BlockSpec((tb, ca, S), lambda i, j: (i, j, 0)),
        out_shape=jax.ShapeDtypeStruct((B, A_pad, S), jnp.float32),
        interpret=True,
    )(idx, table)
    return out[:, :A]


def _inputs(shape, seed, missing):
    B, N, S, A = shape
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((B, N, S)).astype(np.float32)
    idx = rng.integers(0, N, (B, A)).astype(np.int32)
    if missing:
        idx[rng.random((B, A)) < 0.3] = -1
        idx[rng.random((B, A)) < 0.05] = N + 2
    return table, idx


@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_xla_and_pallas_exactly(shape, missing):
    table, idx = _inputs(shape, seed=shape[0], missing=missing)
    got = gather_rows_plain(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    xla = np.asarray(G._gather_rows_xla(jnp.asarray(table), jnp.asarray(idx)))
    pallas = np.asarray(_pallas_interpret(jnp.asarray(table), jnp.asarray(idx)))
    assert np.array_equal(got, xla)
    assert np.array_equal(got, pallas)
    if missing:
        assert not got[idx < 0].any() and not got[idx >= shape[1]].any()


def test_cpu_tensors_take_the_plain_version_without_counting():
    table, idx = _inputs(SHAPES[0], seed=3, missing=True)
    before = gather_rows.launches
    got = gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert gather_rows.launches == before
    assert torch.equal(got, gather_rows_plain(torch.from_numpy(table), torch.from_numpy(idx)))


def test_kernel_library_name_follows_the_source(tmp_path):
    a = tmp_path / "k.cu"
    a.write_text("// one\n")
    first = _build.library_path(a)
    a.write_text("// two\n")
    assert _build.library_path(a) != first
    assert _build.library_path(SOURCE).parent == _build.BUILD_DIR


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No fallback: without a CUDA compiler, loading the kernel raises."""
    if _build.shutil.which("nvcc") or _build.os.access("/usr/local/cuda/bin/nvcc", _build.os.X_OK):
        pytest.skip("a CUDA toolkit is installed here")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("// empty\n")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_library(src)
