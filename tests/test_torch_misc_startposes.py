"""The port's start-position commands (`katacoffee_tpu_torch.command.misc`
viewstartposes, trystartposes and sampleinitializations) against the JAX
package's, on the CPU, with the same arguments and the helpers of
tests/test_torch_misc.py: trystartposes and sampleinitializations on the
tiny net at float32 in both packages (16 visits), viewstartposes on six
games of tests/goldens/ref_sgfs/ref_000.sgfs.

trystartposes' search draws nothing (`for_tests_v2()`), and
sampleinitializations gets the JAX command's draws injected (the
exponential lengths and each ply's Gumbel noise, derived from its key
chain). Every printed integer and move is equal; each printed decimal (3
digits) within 2e-3 of JAX's (test_torch_misc.py's rule)."""

import re

import jax
import numpy as np
import torch

from katacoffee_tpu_torch.command import misc
from test_torch_misc import TINYNET, _both, assert_same_text, float32_models, sgf_dir  # noqa: F401 (fixtures)
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)


def test_viewstartposes_and_trystartposes_match_jax(tmp_path, sgf_dir):
    for argv in (["-start-poses-dir", sgf_dir, "-turn-weight-lambda", "0.05"],
                 ["-start-poses-dir", sgf_dir, "-idx", "7"]):
        want, got = _both("viewstartposes", argv, tmp_path)
        assert got == want and "hint " in got
    want, got = _both("trystartposes", ["-start-poses-dir", sgf_dir, "-model", TINYNET, "-visits", "16",
                                        "-max-positions", "8"], tmp_path)
    assert_same_text(got, want)
    assert got.endswith("tried 8 positions at 16 visits\n")


def _jax_init_draws(seed: int, num: int, area: int, area_prop: float) -> misc.InitDraws:
    """The JAX command's draws from its key chain: the exponential lengths
    from k_len, then each ply's categorical noise, gumbel(k_move, [B, A])."""
    key = jax.random.PRNGKey(seed)
    k_len, key = jax.random.split(key)
    exp = np.array(jax.random.exponential(k_len, (num,)))
    gumbels = []
    for _ in range(int(np.floor(exp * area * area_prop).astype(int).max())):
        key, _k_eval, k_move = jax.random.split(key, 3)
        gumbels.append(torch.from_numpy(np.array(jax.random.gumbel(k_move, (num, 4 * area)))))
    return misc.InitDraws(torch.from_numpy(exp), lambda t: gumbels[t])


def test_sampleinitializations_matches_jax_with_its_draws(tmp_path):
    argv = ["-model", TINYNET, "-num", "4", "-evaluate", "-area-prop", "0.12", "-seed", "2"]
    want, got = _both("sampleinitializations", argv, tmp_path, draws=_jax_init_draws(2, 4, 25, 0.12))
    assert_same_text(got, want)
    lengths = [int(x) for x in re.findall(r"initialization \d: (\d+) opening moves", got)]
    assert len(lengths) == 4 and max(lengths) >= 2 and got.count("raw wl ") == 4
