"""The port's synchronous loop and the gatekeeper, match, loop,
summarize_sgfs and benchmark subcommands, on the CPU.

`run_loop` runs one tiny cycle from a base dir whose models/ holds tinynet
(selfplay B=8 at 8 visits, 4 b1c6 train steps at B=16, a 4-game gate at 4
visits) and must leave shards, a shuffle, a checkpoint, and an export gated
into models/ or rejectedmodels/ with its SGFs. The `main` functions of the
gatekeeper and the loop parse configs/gatekeeper.cfg and configs/loop.cfg
(with overrides) into the same settings as the JAX package's; `match`,
`summarize_sgfs` and `benchmark` run small on the CPU, `summarize_sgfs`
printing what JAX's prints on the match's SGFs; the CLI dispatches the five
subcommands; `program/setup.py` reads configs into the same SearchParams and
GameConfig as JAX's.
"""

import dataclasses
import os
import shutil

import pytest
import torch

from katacoffee_tpu.command import gatekeeper as JG
from katacoffee_tpu.command import loop as JL
from katacoffee_tpu.command import summarize_sgfs as JS
from katacoffee_tpu_torch import cli
from katacoffee_tpu_torch.command import benchmark as TBM
from katacoffee_tpu_torch.command import gatekeeper as TG
from katacoffee_tpu_torch.command import loop as TL
from katacoffee_tpu_torch.command import match as TMC
from katacoffee_tpu_torch.command import summarize_sgfs as TS
from katacoffee_tpu_torch.dataio.checkpoints import is_complete_model_dir
from katacoffee_tpu_torch.game.board import GameConfig
from test_torch_search import ROOT, TINYNET
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

GATE_CFG = os.path.join(ROOT, "configs/gatekeeper.cfg")
LOOP_CFG = os.path.join(ROOT, "configs/loop.cfg")


def test_run_loop_one_tiny_cycle(tmp_path):
    base = str(tmp_path)
    os.makedirs(os.path.join(base, "models"))
    shutil.copytree(TINYNET, os.path.join(base, "models", "tinynet"))
    lc = TL.LoopConfig(num_cycles=1, rows_per_cycle=60, selfplay_batch=8, selfplay_visits=8, moves_per_segment=8,
                       train_steps_per_cycle=4, train_batch=16, model="b1c6", gate_games=4, gate_visits=4,
                       shuffle_min_rows=100, seed=3)
    TL.run_loop(base, GameConfig(5, 5, 4), lc, device="cpu")

    tdata = os.path.join(base, "selfplay", "tinynet", "tdata")
    assert any(n.endswith(".npz") for n in os.listdir(tdata))
    assert any(n.endswith(".npz") for n in os.listdir(os.path.join(base, "shuffleddata")))
    assert os.path.isfile(os.path.join(base, "train", "run", "checkpoint.ckpt"))
    assert os.listdir(os.path.join(base, "modelstobetested")) == []
    gated = [d for root in ("models", "rejectedmodels") if os.path.isdir(os.path.join(base, root))
             for d in os.listdir(os.path.join(base, root))]
    assert sorted(gated) == ["run-s4", "tinynet"]
    where = "models" if "run-s4" in os.listdir(os.path.join(base, "models")) else "rejectedmodels"
    assert is_complete_model_dir(os.path.join(base, where, "run-s4"))
    assert len(os.listdir(os.path.join(base, "gatekeepersgfs", "run-s4"))) == 4


def _captured_main(monkeypatch, module, name, argv, **kw):
    seen = {}
    monkeypatch.setattr(module, name, lambda *args, **kwargs: seen.update(args=args, kwargs=kwargs))
    module.main(argv, **kw)
    return seen


@pytest.mark.parametrize("overrides", [None, "numGamesPerGating=16,maxVisits=32,seed=4"])
def test_gatekeeper_main_parses_as_jax(monkeypatch, tmp_path, overrides):
    argv = ["-base-dir", str(tmp_path), "-config", GATE_CFG, "-quit-if-no-candidates"]
    argv += ["-override-config", overrides] if overrides else []
    want = _captured_main(monkeypatch, JG, "run_gatekeeper", argv)
    got = _captured_main(monkeypatch, TG, "run_gatekeeper", argv, device="cpu")
    (jbase, jcfg, jgc, _), (tbase, tcfg, tgc, _) = want["args"], got["args"]
    assert tbase == jbase and tuple(tcfg) == tuple(jcfg)
    assert dataclasses.asdict(tgc) == dataclasses.asdict(jgc)
    assert got["kwargs"] == {"once": True, "device": torch.device("cpu")} and want["kwargs"] == {"once": True}
    if overrides:
        assert (tgc.num_games, tgc.num_visits, tgc.seed) == (16, 32, 4)


@pytest.mark.parametrize("overrides", [None, "numCycles=2,gateGames=8,useGatekeeper=false,model=b1c6"])
def test_loop_main_parses_as_jax(monkeypatch, tmp_path, overrides):
    argv = ["-base-dir", str(tmp_path), "-config", LOOP_CFG]
    argv += ["-override-config", overrides] if overrides else []
    want = _captured_main(monkeypatch, JL, "run_loop", argv)
    got = _captured_main(monkeypatch, TL, "run_loop", argv, device="cpu")
    assert tuple(got["args"][1]) == tuple(want["args"][1])
    assert dataclasses.asdict(got["args"][2]) == dataclasses.asdict(want["args"][2])
    assert got["kwargs"] == {"device": torch.device("cpu")}


def test_gatekeeper_main_quits_without_candidates(tmp_path):
    TG.main(["-base-dir", str(tmp_path), "-config", GATE_CFG, "-quit-if-no-candidates"], device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["models", "modelstobetested"]


def test_match_main_and_summarize_sgfs_print_what_jax_prints(tmp_path, capsys):
    sgf_dir = str(tmp_path / "sgfs")
    records, elos = TMC.main([TINYNET, "random", "-games-per-pair", "4", "-visits", "4", "-sgf-dir", sgf_dir,
                              "-seed", "1"], device="cpu")
    assert len(records) == 1 and records[0][:2] == ("random", "tinynet") and sum(records[0][2:]) == 4
    assert sorted(elos.players) == ["random", "tinynet"]
    assert len(os.listdir(os.path.join(sgf_dir, "random_vs_tinynet"))) == 4
    capsys.readouterr()
    JS.main([sgf_dir])
    want = capsys.readouterr().out
    TS.main([sgf_dir], device="cpu")
    assert capsys.readouterr().out == want
    assert "total games: 4" in want
    TS.main([sgf_dir, "-no-validate"])
    assert capsys.readouterr().out == want
    TS.main([str(tmp_path / "none")], device="cpu")
    assert capsys.readouterr().out == "no results found\n"


def test_benchmark_main_reports_each_batch_size(capsys):
    out = TBM.main(["-model", TINYNET, "-visits", "4", "-batch-sizes", "1,3"], device="cpu")
    assert sorted(out) == [1, 3] and all(v > 0 for v in out.values())
    text = capsys.readouterr().out
    assert "model: tinynet" in text and "best: batch" in text


def test_cli_runs_the_gating_subcommands(capsys, monkeypatch):
    """`gatekeeper`, `match`, `loop`, `summarize_sgfs` and `benchmark`
    dispatch to their commands' main (each stubbed to echo its arguments)
    and are listed in the help; `serve`, the last JAX subcommand ported,
    dispatches too, and a name no package has exits 2."""
    from katacoffee_tpu_torch.command import benchmark, gatekeeper, loop, match, summarize_sgfs

    assert cli.main(["--help"]) == 0
    out = capsys.readouterr().out
    seen = []
    for module in (gatekeeper, match, loop, summarize_sgfs, benchmark):
        cmd = module.__name__.rsplit(".", 1)[1]
        assert cmd in out
        monkeypatch.setattr(module, "main", lambda argv, cmd=cmd: seen.append((cmd, argv)))
        assert cli.main([cmd, "-x", cmd]) == 0
    gating = ("gatekeeper", "match", "loop", "summarize_sgfs", "benchmark")
    assert seen == [(c, ["-x", c]) for c in gating] and set(gating) <= set(cli._COMMANDS)
    from katacoffee_tpu_torch.distributed import client

    monkeypatch.setattr(client, "main_serve", lambda argv: seen.append(("serve", argv)))
    assert cli.main(["serve", "-x"]) == 0 and seen[-1] == ("serve", ["-x"])
    assert cli.main(["serves"]) == 2
    assert "serves is not ported" in capsys.readouterr().err


@pytest.mark.parametrize("text", ["", "xSize = 6\nwinLen = 3\nuseUncertainty = false\npolicyOptimism = 0.5\n"
                                      "rootNumSymmetriesToSample = 2\ncpuctExploration = 1.3\n"])
def test_setup_loads_configs_as_jax(text):
    """`program/setup.py`: every SearchParams field a config key, over the
    gatekeeper profile's defaults, and the game config, as JAX's."""
    from katacoffee_tpu.program import setup as JSU
    from katacoffee_tpu.search.params import SearchParams as JaxParams
    from katacoffee_tpu.utils import ConfigParser as JaxConfig
    from katacoffee_tpu_torch.program import setup as TSU
    from katacoffee_tpu_torch.search.params import SearchParams
    from katacoffee_tpu_torch.utils.config import ConfigParser

    want = JSU.load_search_params(JaxConfig(text=text), JaxParams.for_gatekeeper())
    got = TSU.load_search_params(ConfigParser(text=text), SearchParams.for_gatekeeper())
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tuple(TSU.load_game_config(ConfigParser(text=text))) == tuple(JSU.load_game_config(JaxConfig(text=text)))
    if text:
        assert (got.policyOptimism, got.useUncertainty, got.rootNumSymmetriesToSample) == (0.5, False, 2)
    ev, mcfg, name = TSU.load_eval_fn(GameConfig(), TINYNET, device="cpu")
    assert name == "tinynet" and tuple(mcfg) == (5, 5, 4) and ev is not None
    assert TSU.load_eval_fn(GameConfig(), None, device="cpu")[2] == "random"
