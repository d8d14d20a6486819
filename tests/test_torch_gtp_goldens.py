"""The port's GTP engine (`katacoffee_tpu_torch.command.gtp.GTPEngine`, on
the CPU) over the golden scripts of tests/test_gtp_goldens.py, with the same
arguments, against the same `tests/goldens/gtp_*.expected` files, which the
JAX engine reproduces byte for byte (that test runs JAX live on the same
input). Nothing here writes a golden.

The eight scripts without a net (uniform priors, 8 visits) must come out
byte for byte. `gtp_model.txt` drives the checked-in tiny net, whose trunk
runs in bfloat16 in both packages: XLA and torch round its convolutions
differently, so the printed floats of the net's outputs may differ. There,
and only there, every token that is a decimal number (the kata-raw-nn
whiteWin/whiteLoss/whiteDraw, policy and whiteOwnership grids, and the
kata-analyze winrate, prior, lcb, utility, utilityLcb, ownership,
ownershipStdev and movesOwnership values) is held within MODEL_ABS_TOL of
the golden's, with the same number of printed decimals; every other byte
(moves, visits, orders, PVs, weights, the boards, the layout) must be equal
(PERF.md section 2)."""

import io
import os
import re

import pytest

from katacoffee_tpu_torch.command.gtp import GTPEngine
from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
from katacoffee_tpu_torch.game.board import GameConfig
from katacoffee_tpu_torch.search.mcts import make_nn_eval_fn, make_raw_forward_fn
from katacoffee_tpu_torch.search.params import SearchParams
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
SCRIPTS = [
    "gtp_basic.txt",
    "gtp_time.txt",
    "gtp_set_position.txt",
    "gtp_rules.txt",
    "gtp_printsgf.txt",
    "gtp_errors.txt",
    "gtp_analyze.txt",
    "gtp_handicap.txt",
]
# the largest difference seen is 1.0e-4 (a whiteOwnership cell, 0.3115116
# against JAX's 0.3116130); bfloat16 keeps 8 bits of mantissa
MODEL_ABS_TOL = 2e-4
_DECIMAL = re.compile(r"(-?\d+\.\d+)")


def _run(name: str, cfg=GameConfig(5, 5, 4), **kw) -> str:
    eng = GTPEngine(cfg, SearchParams(valueWeightExponent=0.0), max_visits=8, seed=0, device="cpu", **kw)
    out = io.StringIO()
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        eng.run(f, out)
    return out.getvalue()


def _expected(name: str) -> str:
    with open(os.path.join(GOLDEN_DIR, name.replace(".txt", ".expected"))) as f:
        return f.read()


@pytest.mark.parametrize("script", SCRIPTS)
def test_gtp_golden(script):
    assert _run(script) == _expected(script)


def test_gtp_model_golden():
    model, cfg, _ = load_exported_model(os.path.join(GOLDEN_DIR, "tinynet"), device="cpu")
    got = _run("gtp_model.txt", cfg, eval_fn=make_nn_eval_fn(cfg, model), raw_fwd=make_raw_forward_fn(cfg, model))
    want = _expected("gtp_model.txt")
    g, w = _DECIMAL.split(got), _DECIMAL.split(want)
    assert len(g) == len(w)
    worst = 0.0
    for i, (a, b) in enumerate(zip(g, w)):
        if i % 2 == 0:
            assert a == b, (a, b)
        else:
            assert len(a.split(".")[1]) == len(b.split(".")[1]), (a, b)
            worst = max(worst, abs(float(a) - float(b)))
    assert worst <= MODEL_ABS_TOL
    assert len(g) > 400  # the grids and analysis rows were compared
