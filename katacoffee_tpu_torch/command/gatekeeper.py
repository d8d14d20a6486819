"""Gatekeeper: candidate-vs-champion gating, on one GPU.

The port of `katacoffee_tpu/command/gatekeeper.py` (the reference's
`cpp/command/gatekeeper.cpp`): poll `<base>/modelstobetested/` for candidate
models, play each against the newest model in `<base>/models/` under
`SearchParams.for_gatekeeper()`, and promote it (move its directory into
`models/`) or reject it (into `rejectedmodels/`) on the match score
(gatekeeper.cpp:147-160, game loop :451-545); the candidate wins ties. The
first candidate, with no champion yet, is promoted unconditionally. The
default operating point is the reference gatekeeper config's, 200 games at
150 visits (cpp/configs/training/gatekeeper1.cfg:20-49), played by the
batched lockstep runner (`program/match.py`).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import time

import torch

from katacoffee_tpu_torch.dataio.checkpoints import find_latest_model, is_complete_model_dir, load_exported_model
from katacoffee_tpu_torch.device import refuse_multi_host, resolve_device
from katacoffee_tpu_torch.game.board import GameConfig
from katacoffee_tpu_torch.program.match import match_sgfs, run_match
from katacoffee_tpu_torch.search.mcts import make_nn_eval_fn, uniform_eval_fn
from katacoffee_tpu_torch.search.params import SearchParams
from katacoffee_tpu_torch.utils.config import ConfigParser
from katacoffee_tpu_torch.utils.logger import Logger


@dataclasses.dataclass
class GatekeeperConfig:
    num_games: int = 200
    num_visits: int = 150
    required_candidate_win_prop: float = 0.5  # score (wins + draws/2) fraction
    write_sgfs: bool = True
    seed: int = 0


def _load_eval(model_dir: str | None, cfg: GameConfig, dev: torch.device):
    if model_dir is None:
        return uniform_eval_fn(cfg), "random"
    model, mcfg, meta = load_exported_model(model_dir, device=dev)
    if mcfg != cfg:
        raise ValueError(f"{model_dir} is for {mcfg}, gatekeeper runs {cfg}")
    return make_nn_eval_fn(cfg, model), meta["name"]


def gate_one(
    base_dir: str,
    candidate_dir: str,
    cfg: GameConfig,
    gc: GatekeeperConfig,
    logger: Logger,
    *,
    device: str | torch.device | None = None,
) -> bool:
    """Test one candidate on `device` (default `cuda`). Returns True if
    promoted."""
    dev = resolve_device(device)
    champion_dir = find_latest_model(os.path.join(base_dir, "models"))
    cand_name = os.path.basename(candidate_dir)

    if champion_dir is None:
        # the first net: promoted unconditionally (the reference's selfplay
        # starts from "random"; any net beats no net)
        shutil.move(candidate_dir, os.path.join(base_dir, "models", cand_name))
        logger.write(f"gatekeeper: {cand_name} promoted (no champion yet)")
        return True

    eval_cand, _ = _load_eval(candidate_dir, cfg, dev)
    eval_champ, champ_name = _load_eval(champion_dir, cfg, dev)
    # the reference's gating operating point: no root noise, nonzero move
    # temperatures for openings that differ across games, in-tree
    # policyOptimism, uncertainty weighting (gatekeeper1.cfg)
    sp = SearchParams.for_gatekeeper()

    t0 = time.monotonic()
    result = run_match(cfg, sp, sp, eval_cand, eval_champ, num_games=gc.num_games, num_visits=gc.num_visits,
                       seed=gc.seed, record_moves=gc.write_sgfs, device=dev)
    dt = time.monotonic() - t0
    logger.write(f"gatekeeper: {cand_name} vs {champ_name}: {result.wins_a}-{result.wins_b}-{result.draws} "
                 f"(score {result.score_a:.3f}) in {dt:.1f}s")

    if gc.write_sgfs:
        sgf_dir = os.path.join(base_dir, "gatekeepersgfs", cand_name)
        os.makedirs(sgf_dir, exist_ok=True)
        for i, text in enumerate(match_sgfs(cfg, result, cand_name, champ_name)):
            with open(os.path.join(sgf_dir, f"game{i:04d}.sgf"), "w") as f:
                f.write(text + "\n")

    # the candidate wins ties (gatekeeper.cpp:568-569: rejected only when the
    # champion strictly outscores it)
    promoted = result.score_a >= gc.required_candidate_win_prop
    dest_root = "models" if promoted else "rejectedmodels"
    os.makedirs(os.path.join(base_dir, dest_root), exist_ok=True)
    shutil.move(candidate_dir, os.path.join(base_dir, dest_root, cand_name))
    logger.write(f"gatekeeper: {cand_name} {'PROMOTED' if promoted else 'rejected'}")
    return promoted


def run_gatekeeper(
    base_dir: str,
    cfg: GameConfig,
    gc: GatekeeperConfig,
    logger: Logger | None = None,
    poll_seconds: float = 10.0,
    once: bool = False,
    *,
    device: str | torch.device | None = None,
) -> int:
    """The poll loop on `device` (default `cuda`); `once` processes the
    current backlog and returns. Returns the number of candidates
    processed."""
    dev = resolve_device(device)
    logger = logger or Logger(log_to_stdout=True)
    test_dir = os.path.join(base_dir, "modelstobetested")
    os.makedirs(test_dir, exist_ok=True)
    os.makedirs(os.path.join(base_dir, "models"), exist_ok=True)
    processed = 0
    while True:
        candidates = sorted(
            d for d in os.listdir(test_dir)
            if not d.startswith(".") and is_complete_model_dir(os.path.join(test_dir, d))
        )
        if not candidates:
            if once:
                return processed
            time.sleep(poll_seconds)
            continue
        for cand in candidates:
            gate_one(base_dir, os.path.join(test_dir, cand), cfg, gc, logger, device=dev)
            processed += 1


def main(argv, *, device: str | torch.device | None = None) -> None:
    """Entry for `python -m katacoffee_tpu_torch gatekeeper` (JAX
    gatekeeper.py:136): the same flags and config keys, on `device`
    (default `cuda`)."""
    refuse_multi_host("gatekeeper")
    dev = resolve_device(device)
    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch gatekeeper")
    ap.add_argument("-base-dir", required=True)
    ap.add_argument("-config", default=None)
    ap.add_argument("-override-config", default=None)
    ap.add_argument("-quit-if-no-candidates", action="store_true")
    args = ap.parse_args(argv)
    c = ConfigParser(args.config, overrides=args.override_config) if args.config else ConfigParser(text="")
    if args.override_config and not args.config:
        c.apply_overrides(args.override_config)
    cfg = GameConfig(c.get_int("xSize", 5), c.get_int("ySize", 5), c.get_int("winLen", 4))
    gc = GatekeeperConfig(
        num_games=c.get_int("numGamesPerGating", 200),
        num_visits=c.get_int("maxVisits", 150),
        required_candidate_win_prop=c.get_float("requiredCandidateWinProp", 0.5),
        seed=c.get_int("seed", 0),
    )
    logger = Logger(log_to_stdout=True)
    c.warn_unused(logger)
    run_gatekeeper(args.base_dir, cfg, gc, logger, once=args.quit_if_no_candidates, device=dev)
