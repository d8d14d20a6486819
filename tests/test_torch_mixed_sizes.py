"""Mixed board sizes through the port (the bSizes role of the reference's
GameInitializer), held to JAX tests/test_mixed_sizes.py's contract on the
CPU: the port's selfplay command (`command/selfplay.py` `main`) with
bSizes 4,5, bSizeRelProbs 1,2 and bWinLens 3,4 takes the
`run_mixed_selfplay` branch and writes per-size data dirs
`tdata_<X>x<Y>w<W>`, whose shards JAX's `iter_shards` finds and whose rows
carry `board_shape` (x, y, w) (as both packages' writers tag a shard;
tests/test_torch_rectangular.py tells the axes apart) and boards [y, x];
the 5x5 quota is twice the 4x4 one; the port's `shuffle_data` per size and
`run_training_mixed` for 12 steps train one net on both shapes; the export
loads and runs on both.

Beside it, with no search run: the settings the two packages' `main`
parse from one config file, and the per-size `SelfplayConfig`s their
`run_mixed_selfplay` hands the daemon over two passes (seeds
`seed + 1009 * pass + 101 * i`), are equal."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from katacoffee_tpu.command import selfplay as JS
from katacoffee_tpu.dataio.trainingwrite import iter_shards as jax_iter_shards
from katacoffee_tpu.game.board import GameConfig as JCfg
from katacoffee_tpu_torch.command import selfplay as TS
from katacoffee_tpu_torch.command import train as TT
from katacoffee_tpu_torch.command.train import TrainerConfig, run_training_mixed
from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
from katacoffee_tpu_torch.dataio.shuffle import shuffle_data
from katacoffee_tpu_torch.game.board import GameConfig, init_state
from katacoffee_tpu_torch.nn.features import extract_features
from katacoffee_tpu_torch.train.train import TrainConfig
from katacoffee_tpu_torch.utils.logger import Logger
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

CONFIG = """
bSizes = 4,5
bSizeRelProbs = 1,2
bWinLens = 3,4
rowsPerPass = 300
maxPasses = 1
numParallelGames = 8
maxVisits = 8
movesPerSegment = 10
segmentsPerFlush = 1
seed = 1
"""
EXPECTED = {"4x4w3": (4, 4, 3), "5x5w4": (5, 5, 4)}


def _write_config(tmp_path) -> str:
    path = os.path.join(str(tmp_path), "mixed.cfg")
    with open(path, "w") as f:
        f.write(CONFIG)
    return path


def test_main_and_run_mixed_selfplay_hand_the_daemon_what_jax_does(tmp_path, monkeypatch):
    config = _write_config(tmp_path)
    seen = {}

    def recorder(name):
        def run_mixed(base_dir, size_configs, sp, spc, logger, rows_per_pass, max_passes, **kw):
            seen[name] = ([tuple(c) + (p,) for c, p in size_configs], dataclasses.asdict(spc), rows_per_pass,
                          max_passes)
            return 0
        return run_mixed

    monkeypatch.setattr(JS, "run_mixed_selfplay", recorder("jax"))
    monkeypatch.setattr(TS, "run_mixed_selfplay", recorder("port"))
    JS.main(["-output-dir", str(tmp_path / "j"), "-config", config])
    TS.main(["-output-dir", str(tmp_path / "t"), "-config", config], device="cpu")
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == [(4, 4, 3, 1.0), (5, 5, 4, 2.0)] and seen["port"][2:] == (300, 1)
    monkeypatch.undo()

    calls = {"jax": [], "port": []}

    def daemon(name):
        def run(base_dir, cfg, sp, spc, logger, **kw):
            calls[name].append((tuple(cfg), dataclasses.asdict(spc)))
            return 7
        return run

    monkeypatch.setattr(JS, "run_selfplay_daemon", daemon("jax"))
    monkeypatch.setattr(TS, "run_selfplay_daemon", daemon("port"))
    spc = dict(batch_size=8, num_sims=8, moves_per_segment=10, segments_per_flush=1, seed=5, max_segments=3)
    sizes = [((4, 4, 3), 1.0), ((5, 5, 4), 2.0), ((7, 5, 4), 0.5)]
    jrows = JS.run_mixed_selfplay("b", [(JCfg(*c), p) for c, p in sizes], None, JS.SelfplayConfig(**spc), Logger(),
                                  rows_per_pass=350, max_passes=2)
    trows = TS.run_mixed_selfplay("b", [(GameConfig(*c), p) for c, p in sizes], None, TS.SelfplayConfig(**spc),
                                  Logger(), rows_per_pass=350, max_passes=2, device="cpu")
    assert trows == jrows == 7 * 6
    assert calls["port"] == calls["jax"]
    got = [(c, s["data_tag"], s["max_rows"], s["max_segments"], s["seed"]) for c, s in calls["port"]]
    assert got == [(c, "{}x{}w{}".format(*c), max(int(350 * p / 3.5), 1), None, 5 + 1009 * pss + 101 * i)
                   for pss in range(2) for i, (c, p) in enumerate(sizes)]


def test_mixed_selfplay_command_then_shuffle_and_training(tmp_path, monkeypatch):
    base = str(tmp_path)
    TS.main(["-output-dir", base, "-config", _write_config(tmp_path)], device="cpu")

    counts = {}
    for tag, (x, y, w) in EXPECTED.items():
        d = os.path.join(base, "selfplay", "random", "tdata_" + tag)
        shards = list(jax_iter_shards(d))
        assert shards, f"no shards for {tag}"
        n = 0
        for s in shards:
            with np.load(s) as z:
                assert tuple(z["board_shape"]) == (x, y, w), tag
                assert z["board"].shape[1:] == (y, x)
                assert z["policy_target"].shape[1] == 4 * x * y
                n += int(z["weight"].shape[0])
        counts[tag] = n
    # the 5x5 quota is twice the 4x4 one
    assert counts["5x5w4"] > counts["4x4w3"] > 0

    for tag in EXPECTED:
        stats = shuffle_data([os.path.join(base, "selfplay", "random", "tdata_" + tag)],
                             os.path.join(base, "shuffleddata", tag), min_rows=10**9, seed=0)
        assert stats["rows_out"] == counts[tag]

    # one net, its parameters and optimizer shared, stepped on both shapes
    tc = TrainConfig(warmup_steps=2, symmetry_augment=False)
    trc = TrainerConfig(model="b1c6", batch_size=16, max_steps=12, steps_per_export=10**9, checkpoint_every=10**9,
                        max_epochs_per_data=10**9, seed=0)
    cfgs = [GameConfig(*c) for c in EXPECTED.values()]
    stepped = {}
    kept = TT.make_train_step

    def counted(cfg, *args):
        step = kept(cfg, *args)

        def run(state, batch, generator):
            assert batch.states.board.shape[1:] == (cfg.y_size, cfg.x_size)
            stepped[cfg] = stepped.get(cfg, 0) + 1
            return step(state, batch, generator)
        return run

    monkeypatch.setattr(TT, "make_train_step", counted)
    assert run_training_mixed(base, cfgs, tc, trc, Logger(), device="cpu") == 12
    assert set(stepped) == set(cfgs) and sum(stepped.values()) == 12
    # metrics are written at step 1 and every 50th: the first step's size
    with open(os.path.join(base, "train", "run", "metrics_train.json")) as f:
        metrics = [json.loads(line) for line in f]
    assert [m["step"] for m in metrics] == [1] and metrics[0]["size"] in EXPECTED
    assert np.isfinite(metrics[0]["loss"])

    d = os.path.join(base, "modelstobetested")
    model = load_exported_model(os.path.join(d, sorted(os.listdir(d))[-1]), device="cpu")[0]
    for cfg in cfgs:
        with torch.no_grad():
            out = model(*extract_features(cfg, init_state(cfg, 2, device="cpu")))
        assert out["policy_logits"].shape == (2, cfg.policy_size)
        assert torch.isfinite(out["policy_logits"]).all()


@pytest.mark.parametrize("key", ["bSizeRelProbs", "bWinLens"])
def test_misaligned_size_lists_are_refused_as_jax_refuses_them(tmp_path, key):
    config = _write_config(tmp_path)
    with open(config, "a") as f:  # a later line of a key replaces the earlier
        f.write(f"{key} = 1,2,3\n")
    errors = []
    for main, kw in ((JS.main, {}), (TS.main, {"device": "cpu"})):
        with pytest.raises(ValueError) as err:
            main(["-output-dir", str(tmp_path / "o"), "-config", config], **kw)
        errors.append(str(err.value))
    assert errors[0] == errors[1] == "bSizes, bSizeRelProbs, bWinLens must align"
