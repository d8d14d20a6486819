"""The port's small frontends against the JAX package's: `evalsgf` on a
position of tests/goldens/ref_sgfs/ref_000.sgfs with the tiny net (its
trunk in bfloat16 in both packages, as tests/test_torch_gtp_goldens.py runs
it), `genconfig -noninteractive` without a model, and the CLI's `version`
and `printclockinfo`.

evalsgf prints the board, the root line, the rows and a tree dump. Every
integer and move must be equal; each printed decimal (3 digits) within
2e-3 of JAX's, as bfloat16 convolutions round differently under XLA and
torch (PERF.md section 2)."""

import os
import re

from katacoffee_tpu import cli as jax_cli
from katacoffee_tpu.command import evalsgf as jax_evalsgf
from katacoffee_tpu.command import genconfig as jax_genconfig
from katacoffee_tpu_torch import cli
from katacoffee_tpu_torch.command import evalsgf, genconfig
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINYNET = os.path.join(ROOT, "tests/goldens/tinynet")
REF_SGFS = os.path.join(ROOT, "tests/goldens/ref_sgfs/ref_000.sgfs")
DECIMAL_TOL = 2e-3
_DECIMAL = re.compile(r"([-+]?\d+\.\d+)")


def _game_file(tmp_path, k: int) -> str:
    with open(REF_SGFS) as f:
        line = f.read().splitlines()[k]
    path = tmp_path / f"game{k}.sgf"
    path.write_text(line + "\n")
    return str(path)


def test_evalsgf_matches_jax(tmp_path, capsys):
    argv = [_game_file(tmp_path, 1), "-move-num", "6", "-visits", "16", "-model", TINYNET, "-print-tree-depth", "2"]
    jax_evalsgf.main(list(argv))
    want = capsys.readouterr().out
    evalsgf.main(list(argv), device="cpu")
    got = capsys.readouterr().out
    assert "root: visits 17 " in got and "  pv: " not in got and " pv: " in got
    g, w = _DECIMAL.split(got), _DECIMAL.split(want)
    assert len(g) == len(w) > 20
    for i, (a, b) in enumerate(zip(g, w)):
        if i % 2 == 0:
            assert a == b, (a, b)
        else:
            assert len(a) - a.index(".") == len(b) - b.index("."), (a, b)
            assert abs(float(a) - float(b)) <= DECIMAL_TOL, (a, b)


def test_evalsgf_at_a_finished_game(tmp_path, capsys):
    """At the end of a game the command prints the board and the winner and
    searches nothing."""
    argv = [_game_file(tmp_path, 0)]
    jax_evalsgf.main(list(argv))
    want = capsys.readouterr().out
    evalsgf.main(list(argv), device="cpu")
    got = capsys.readouterr().out
    assert got == want and "game over, winner: " in got


def test_genconfig_noninteractive_matches_jax(tmp_path, capsys):
    jax_genconfig.main(["-output", str(tmp_path / "jax.cfg"), "-noninteractive"])
    genconfig.main(["-output", str(tmp_path / "port.cfg"), "-noninteractive", "-target-seconds-per-move", "3"],
                   device="cpu")
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == f"wrote {tmp_path / 'port.cfg'}"
    assert (tmp_path / "port.cfg").read_bytes() == (tmp_path / "jax.cfg").read_bytes()


def test_version_and_printclockinfo(capsys):
    assert cli.main(["version"]) == 0
    port = capsys.readouterr().out
    assert jax_cli.main(["version"]) == 0
    assert port == capsys.readouterr().out == "0.1.0\n"
    assert cli.main(["printclockinfo"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert jax_cli.main(["printclockinfo"]) == 0
    jlines = capsys.readouterr().out.splitlines()
    assert lines[:2] == jlines[:2] and lines[0].startswith("Clock: time.monotonic (")
    assert float(lines[1].split(": ")[1]) > 0 and int(lines[2].split(": ")[1]) > 0
