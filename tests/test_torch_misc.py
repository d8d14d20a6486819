"""The port's misc commands (`katacoffee_tpu_torch.command.misc`) against the
JAX package's, on the CPU, with the same arguments: demoplay and
dataminesgfs on the tiny net at float32 in both packages (each command's
model loader patched to float32; 16 visits or fewer) and samplesgfs, on six
games of tests/goldens/ref_sgfs/ref_000.sgfs; the start-position commands
are in tests/test_torch_misc_startposes.py, which shares these helpers.

No search of these commands draws anything (`for_tests_v2()`). Every printed integer and move is equal and every file written byte
for byte the same; each printed decimal (3 digits) within 2e-3 of JAX's,
the float32 search floats agreeing within 2e-4 (tests/test_torch_engine.py)
and the last printed digit rounding either way."""

import contextlib
import io
import os
import re

import pytest
import torch

import katacoffee_tpu.dataio.checkpoints as jax_checkpoints
import katacoffee_tpu_torch.dataio.checkpoints as port_checkpoints
from katacoffee_tpu.command import misc as jax_misc
from katacoffee_tpu_torch import cli
from katacoffee_tpu_torch.command import misc
from torch_parity import jax_exported_net, one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINYNET = os.path.join(ROOT, "tests/goldens/tinynet")
REF_SGFS = os.path.join(ROOT, "tests/goldens/ref_sgfs/ref_000.sgfs")
DECIMAL_TOL = 2e-3
_DECIMAL = re.compile(r"([-+]?\d+\.\d+)")


@pytest.fixture(autouse=True)
def float32_models(monkeypatch):
    """Both packages' exported-model loaders return the model at float32."""
    import json

    from katacoffee_tpu.game.board import GameConfig as JaxConfig

    def jax_load(model_dir):
        net, params = jax_exported_net(model_dir)
        with open(os.path.join(model_dir, "model.json")) as f:
            meta = json.load(f)
        return net, params, JaxConfig(meta["x_size"], meta["y_size"], meta["win_len"]), meta

    kept = port_checkpoints.load_exported_model
    monkeypatch.setattr(jax_checkpoints, "load_exported_model", jax_load)
    monkeypatch.setattr(port_checkpoints, "load_exported_model",
                        lambda model_dir, device=None: kept(model_dir, device, torch.float32))


@pytest.fixture(scope="module")
def sgf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("sgfs")
    with open(REF_SGFS) as f:
        lines = f.read().splitlines()
    for k in range(6):
        (d / f"g{k}.sgf").write_text(lines[k] + "\n")
    return str(d)


def _run(fn, argv, **kw) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(argv, **kw)
    return out.getvalue()


def _both(name: str, argv: list[str], tmp_path, **port_kw) -> tuple[str, str]:
    """(JAX's output, the port's) of `name` run with `argv`, where OUT
    names each run's own output dir (printed as OUT)."""
    outs = []
    for tag, fn, kw in (("jax", getattr(jax_misc, f"main_{name}"), {}),
                        ("port", getattr(misc, f"main_{name}"), {"device": "cpu", **port_kw})):
        d = str(tmp_path / tag)
        outs.append(_run(fn, [a.replace("OUT", d) for a in argv], **kw).replace(d, "OUT"))
    return outs[0], outs[1]


def assert_same_text(got: str, want: str) -> None:
    g, w = _DECIMAL.split(got), _DECIMAL.split(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        if i % 2 == 0:
            assert a == b, (a, b)
        else:
            assert len(a) - a.index(".") == len(b) - b.index("."), (a, b)
            assert abs(float(a) - float(b)) <= DECIMAL_TOL, (a, b)


def assert_same_files(tmp_path) -> int:
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n
    return len(names)


def test_demoplay_matches_jax(tmp_path):
    want, got = _both("demoplay", ["-model", TINYNET, "-visits", "8"], tmp_path)
    assert_same_text(got, want)
    assert got.startswith("model: tinynet\n=== game 1 ===\n") and "\nresult: " in got and "visits 9)" in got


def test_dataminesgfs_matches_jax(tmp_path, sgf_dir):
    argv = [sgf_dir, "-out-dir", "OUT", "-model", TINYNET, "-visits", "12", "-batch-size", "8", "-sample-prob",
            "0.5", "-max-positions", "12", "-seed", "3"]
    want, got = _both("dataminesgfs", argv, tmp_path)
    assert got == want and got.startswith("mined ")
    assert assert_same_files(tmp_path) == int(got.split()[1]) > 0


def test_dataminesgfs_reads_only_the_games_it_needs(tmp_path, monkeypatch):
    """Forty games where the first few fill -max-positions: the port, reading
    and replaying 2 games at a time, writes JAX's output and files and
    parses at most the chunk that filled its candidates, where JAX parses
    up to the game that filled them."""
    import katacoffee_tpu.dataio.sgf as jax_sgf

    d = tmp_path / "sgfs"
    d.mkdir()
    with open(REF_SGFS) as f:
        lines = f.read().splitlines()
    for k in range(40):
        (d / f"g{k:02d}.sgf").write_text(lines[k] + "\n")
    parsed = {"jax": 0, "port": 0}

    def counting(tag, parse):
        def fn(path):
            parsed[tag] += 1
            return parse(path)
        return fn

    monkeypatch.setattr(jax_sgf, "parse_sgf_file", counting("jax", jax_sgf.parse_sgf_file))
    monkeypatch.setattr(misc, "parse_sgf_file", counting("port", misc.parse_sgf_file))
    monkeypatch.setattr(misc, "REPLAY_CHUNK", 2)
    argv = [str(d), "-out-dir", "OUT", "-visits", "4", "-batch-size", "8", "-sample-prob", "0.5",
            "-max-positions", "30", "-seed", "5"]
    want, got = _both("dataminesgfs", argv, tmp_path)
    assert got == want and assert_same_files(tmp_path) == int(got.split()[1])
    assert int(got.split()[5]) >= 30
    assert 0 < parsed["jax"] <= parsed["port"] < parsed["jax"] + 2 and parsed["port"] >= 4


def test_samplesgfs_matches_jax(tmp_path, sgf_dir):
    want, got = _both("samplesgfs", [sgf_dir, "-out-dir", "OUT", "-sample-prob", "0.3", "-seed", "1"], tmp_path)
    assert got == want and assert_same_files(tmp_path) == int(got.split()[1]) > 0


def test_cli_runs_the_misc_and_book_commands(monkeypatch, capsys):
    """Each of the ten subcommands reaches its main_<cmd>(argv); runtests
    runs pytest over tests/; serve and contribute, ported since, reach
    their mains too."""
    from katacoffee_tpu_torch.command import genbook

    seen = []
    for module, names in ((misc, cli._MISC_COMMANDS), (genbook, cli._BOOK_COMMANDS)):
        for cmd in names:
            monkeypatch.setattr(module, f"main_{cmd}", lambda argv, cmd=cmd: seen.append((cmd, argv)))
    commands = cli._MISC_COMMANDS + cli._BOOK_COMMANDS
    for cmd in commands:
        assert cli.main([cmd, "-x", cmd]) == 0
    assert seen == [(c, ["-x", c]) for c in commands] and len(commands) == 10
    calls = []
    monkeypatch.setattr("subprocess.call", lambda args: calls.append(args) or 0)
    assert cli.main(["runtests", "-k", "board"]) == 0
    assert calls[0][1:] == ["-m", "pytest", "tests/", "-q", "-k", "board"]
    from katacoffee_tpu_torch.distributed import client

    monkeypatch.setattr(client, "main_serve", lambda argv: seen.append(("serve", argv)))
    monkeypatch.setattr(client, "main", lambda argv: seen.append(("contribute", argv)))
    for cmd in ("serve", "contribute"):
        assert cli.main([cmd, "-x"]) == 0 and seen[-1] == (cmd, ["-x"])
