"""Match command: round-robin games between exported models and an Elo
report, on one GPU.

The port of `katacoffee_tpu/command/match.py` (the reference's
`cpp/command/match.cpp`, match.cpp:29-364, with its Elo summarizer
`python/summarize_sgfs.py` / `python/elo.py`): every pair of bots plays a
batched lockstep match (`program/match.py`); the records feed the
maximum-likelihood Elo fit (`utils/elo.py`).
"""

from __future__ import annotations

import argparse
import itertools
import os

import torch

from katacoffee_tpu_torch.device import refuse_multi_host, resolve_device
from katacoffee_tpu_torch.game.board import GameConfig
from katacoffee_tpu_torch.program.match import match_sgfs, run_match
from katacoffee_tpu_torch.search.mcts import make_nn_eval_fn, uniform_eval_fn
from katacoffee_tpu_torch.search.params import SearchParams
from katacoffee_tpu_torch.utils.elo import compute_elos
from katacoffee_tpu_torch.utils.logger import Logger


def run_round_robin(
    cfg: GameConfig,
    bots: dict[str, object],  # name -> eval_fn
    num_games_per_pair: int,
    num_visits: int,
    sp: SearchParams | None = None,
    seed: int = 0,
    sgf_dir: str | None = None,
    logger: Logger | None = None,
    *,
    device: str | torch.device | None = None,
):
    """Every pair of `bots` plays `num_games_per_pair` games on `device`
    (default `cuda`). Returns (records, EloResult): records are (a, b,
    wins_a, wins_b, draws) per pair."""
    dev = resolve_device(device)
    logger = logger or Logger(log_to_stdout=True)
    # the reference's match operating point (match_example.cfg): no root
    # noise, early-move temperature 0.60 -> 0.20 so that the games of a
    # batched pairing diverge
    sp = sp or SearchParams.for_match()
    records = []
    names = sorted(bots)
    for i, (a, b) in enumerate(itertools.combinations(names, 2)):
        result = run_match(cfg, sp, sp, bots[a], bots[b], num_games=num_games_per_pair, num_visits=num_visits,
                           seed=seed + i, record_moves=sgf_dir is not None, device=dev)
        records.append((a, b, result.wins_a, result.wins_b, result.draws))
        logger.write(f"match: {a} vs {b}: {result.wins_a}-{result.wins_b}-{result.draws}")
        if sgf_dir is not None:
            pair_dir = os.path.join(sgf_dir, f"{a}_vs_{b}")
            os.makedirs(pair_dir, exist_ok=True)
            for g, text in enumerate(match_sgfs(cfg, result, a, b)):
                with open(os.path.join(pair_dir, f"game{g:04d}.sgf"), "w") as f:
                    f.write(text + "\n")
    elos = compute_elos(records)
    for name, (e, s) in sorted(elos.as_dict().items(), key=lambda kv: -kv[1][0]):
        logger.write(f"elo: {name:30s} {e:+8.1f} ± {s:.1f}")
    return records, elos


def main(argv, *, device: str | torch.device | None = None):
    """Entry for `python -m katacoffee_tpu_torch match` (JAX match.py:64):
    the same arguments, on `device` (default `cuda`). Returns what
    run_round_robin returns."""
    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model

    refuse_multi_host("match")
    dev = resolve_device(device)
    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch match")
    ap.add_argument("models", nargs="+", help="exported model dirs; 'random' = uniform priors")
    ap.add_argument("-games-per-pair", type=int, default=50)
    ap.add_argument("-visits", type=int, default=150)
    ap.add_argument("-sgf-dir", default=None)
    ap.add_argument("-seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = GameConfig(5, 5, 4)
    bots = {}
    for m in args.models:
        if m == "random":
            bots["random"] = None  # resolved once the config is known
        else:
            model, cfg, meta = load_exported_model(m, device=dev)
            bots[meta["name"]] = make_nn_eval_fn(cfg, model)
    if "random" in bots:
        bots["random"] = uniform_eval_fn(cfg)
    return run_round_robin(cfg, bots, args.games_per_pair, args.visits, seed=args.seed, sgf_dir=args.sgf_dir,
                           device=dev)
