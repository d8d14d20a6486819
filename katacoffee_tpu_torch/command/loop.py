"""Synchronous training loop: selfplay -> shuffle -> train -> export ->
gate, cycle after cycle. Selfplay and training use every visible GPU, one
rank each, where their batch divides over them (as the JAX loop shards
over every chip through `use_mesh`); the gate runs on one.

The port of `katacoffee_tpu/command/loop.py` (the single-process form of the
reference's `python/selfplay/synchronous_loop.sh`): the cycle runs as
function calls of the port's own commands, `run_selfplay_daemon`,
`shuffle_data`, `run_training(export_to=...)` and `run_gatekeeper(once=True)`,
on the same on-disk layout (`selfplay/<model>/tdata`, `shuffleddata/`,
`modelstobetested/`, `models/`, `rejectedmodels/`), so each stage can also
run as its own subcommand against the same base dir, and the JAX package's
commands read what this one writes. The defaults scale the reference
loop's operating point (synchronous_loop.sh:57-66) down to Coffee; every
knob is a config key.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from katacoffee_tpu_torch.command.gatekeeper import GatekeeperConfig, run_gatekeeper
from katacoffee_tpu_torch.command.selfplay import SelfplayConfig, run_selfplay_daemon
from katacoffee_tpu_torch.command.train import TrainerConfig, run_training
from katacoffee_tpu_torch.dataio.shuffle import shuffle_data
from katacoffee_tpu_torch.device import refuse_multi_host, resolve_device
from katacoffee_tpu_torch.game.board import GameConfig
from katacoffee_tpu_torch.search.params import SearchParams
from katacoffee_tpu_torch.train.train import TrainConfig
from katacoffee_tpu_torch.utils.config import ConfigParser
from katacoffee_tpu_torch.utils.logger import Logger


@dataclasses.dataclass
class LoopConfig:
    num_cycles: int = 10
    rows_per_cycle: int = 20000
    selfplay_batch: int = 256
    selfplay_visits: int = 600
    moves_per_segment: int = 16
    train_steps_per_cycle: int = 300
    train_batch: int = 128
    model: str = "b6c96"
    gate_games: int = 50
    gate_visits: int = 100
    use_gatekeeper: bool = True
    shuffle_min_rows: int = 50000
    val_prop: float = 0.05
    seed: int = 0
    # stepped-warmup sample thresholds scaled for Coffee loop runs: 0.02
    # ramps 1/5 -> 1 over the first ~120k samples instead of the
    # reference's 6M (tuned to big Go runs)
    warmup_samples_scale: float = 0.02
    learning_rate: float = 0.02


def run_loop(base_dir: str, cfg: GameConfig, lc: LoopConfig, logger: Logger | None = None, *,
             device: str | torch.device | None = None) -> None:
    """`lc.num_cycles` cycles on `device` (default `cuda`)."""
    dev = resolve_device(device)
    logger = logger or Logger(log_to_stdout=True)
    os.makedirs(base_dir, exist_ok=True)
    sp = SearchParams.for_selfplay()

    for cycle in range(lc.num_cycles):
        logger.write(f"=== loop cycle {cycle} ===")

        # 1. selfplay with the newest promoted model
        spc = SelfplayConfig(
            batch_size=lc.selfplay_batch,
            num_sims=lc.selfplay_visits,
            moves_per_segment=lc.moves_per_segment,
            max_rows=lc.rows_per_cycle,
            seed=lc.seed + cycle,
        )
        run_selfplay_daemon(base_dir, cfg, sp, spc, logger, device=dev)

        # 2. shuffle everything generated so far (power-law window)
        data_dirs = []
        sp_root = os.path.join(base_dir, "selfplay")
        if os.path.isdir(sp_root):
            for name in os.listdir(sp_root):
                d = os.path.join(sp_root, name, "tdata")
                if os.path.isdir(d):
                    data_dirs.append(d)
        stats = shuffle_data(data_dirs, os.path.join(base_dir, "shuffleddata"), min_rows=lc.shuffle_min_rows,
                             seed=lc.seed + cycle, val_prop=lc.val_prop)
        logger.write(f"shuffle: {stats}")

        # 3. train and export a candidate
        tc = TrainConfig(learning_rate=lc.learning_rate, warmup_samples_scale=lc.warmup_samples_scale)
        trc = TrainerConfig(
            model=lc.model,
            batch_size=lc.train_batch,
            max_steps=lc.train_steps_per_cycle,
            steps_per_export=10**9,  # one export, at the end of the cycle
            seed=lc.seed,
        )
        export_to = "modelstobetested" if lc.use_gatekeeper else "models"
        run_training(base_dir, cfg, tc, trc, logger, export_to=export_to, device=dev)

        # 4. gate the candidate (optional, like the loop's gatekeeper flag)
        if lc.use_gatekeeper:
            gc = GatekeeperConfig(num_games=lc.gate_games, num_visits=lc.gate_visits, seed=lc.seed + cycle)
            run_gatekeeper(base_dir, cfg, gc, logger, once=True, device=dev)


def main(argv, *, device: str | torch.device | None = None) -> None:
    """Entry for `python -m katacoffee_tpu_torch loop` (JAX loop.py:117):
    the same flags and config keys, on `device` (default `cuda`)."""
    refuse_multi_host("loop")
    dev = resolve_device(device)
    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch loop")
    ap.add_argument("-base-dir", required=True)
    ap.add_argument("-config", default=None)
    ap.add_argument("-override-config", default=None)
    args = ap.parse_args(argv)
    c = ConfigParser(args.config, overrides=args.override_config) if args.config else ConfigParser(text="")
    if args.override_config and not args.config:
        c.apply_overrides(args.override_config)
    cfg = GameConfig(c.get_int("xSize", 5), c.get_int("ySize", 5), c.get_int("winLen", 4))
    lc = LoopConfig(
        num_cycles=c.get_int("numCycles", 10),
        rows_per_cycle=c.get_int("rowsPerCycle", 20000),
        selfplay_batch=c.get_int("numParallelGames", 256),
        selfplay_visits=c.get_int("selfplayVisits", 600),
        train_steps_per_cycle=c.get_int("trainStepsPerCycle", 300),
        train_batch=c.get_int("batchSize", 128),
        model=c.get_string("model", "b6c96"),
        gate_games=c.get_int("gateGames", 50),
        gate_visits=c.get_int("gateVisits", 100),
        use_gatekeeper=c.get_bool("useGatekeeper", True),
        seed=c.get_int("seed", 0),
        warmup_samples_scale=c.get_float("warmupSamplesScale", 0.02),
        learning_rate=c.get_float("learningRate", 0.02),
    )
    logger = Logger(log_to_stdout=True)
    c.warn_unused(logger)
    run_loop(args.base_dir, cfg, lc, logger, device=dev)
