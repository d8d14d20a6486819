"""genconfig: generate a GTP config interactively (or from flags), the port
of `katacoffee_tpu/command/genconfig.py`; its benchmark step runs on
`device` (default `cuda`).

The role of the reference's `katago genconfig` (`cpp/program/gtpconfig.cpp`,
`cpp/command/benchmark.cpp` genconfig path): ask a few questions, write a
ready-to-use config file, optionally benchmarking to pick the visit budget.
"""

from __future__ import annotations

import argparse
import sys

import torch


def _ask(prompt: str, default: str, interactive: bool) -> str:
    if not interactive:
        return default
    sys.stdout.write(f"{prompt} [{default}]: ")
    sys.stdout.flush()
    line = sys.stdin.readline().strip()
    return line or default


def main(argv, *, device: str | torch.device | None = None):
    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch genconfig")
    ap.add_argument("-output", required=True)
    ap.add_argument("-model", default=None, help="exported model dir (for the benchmark step)")
    ap.add_argument("-noninteractive", action="store_true")
    ap.add_argument("-target-seconds-per-move", type=float, default=2.0)
    args = ap.parse_args(argv)
    interactive = not args.noninteractive and sys.stdin.isatty()

    x = int(_ask("Board x size", "5", interactive))
    y = int(_ask("Board y size", "5", interactive))
    wl = int(_ask("Win length", "4", interactive))
    secs = float(_ask("Target seconds per move", str(args.target_seconds_per_move), interactive))

    visits = 400
    if args.model:
        # measure visits/s like the reference's benchmark-driven genconfig
        from katacoffee_tpu_torch.command.benchmark import benchmark_search
        from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
        from katacoffee_tpu_torch.search.mcts import make_nn_eval_fn
        from katacoffee_tpu_torch.search.params import SearchParams

        model, cfg, _ = load_exported_model(args.model, device=device)
        eval_fn = make_nn_eval_fn(cfg, model)
        results = benchmark_search(
            cfg, SearchParams.for_tests_v2(), eval_fn, batch_sizes=(1,), num_visits=200,
            device=device, log=lambda *a: None,
        )
        vps = results[1]
        visits = max(16, int(vps * secs))
        print(f"measured {vps:.0f} visits/s at batch 1 -> maxVisits {visits}")

    ponder = _ask(
        "Ponder on the opponent's turn (uses device time between moves)",
        "false", interactive,
    ).strip().lower() in ("true", "yes", "y", "1")

    text = f"""# Generated by katacoffee genconfig
xSize = {x}
ySize = {y}
winLen = {wl}
maxVisits = {visits}
# Search the opponent's turn in the background and reuse the tree
# (gtp_example.cfg:290 ponderingEnabled)
ponderingEnabled = {str(ponder).lower()}
maxVisitsPondering = {visits * 2}
useLcbForSelection = true
useGraphSearch = true
useNoisePruning = true
useUncertainty = true
subtreeValueBiasFactor = 0.45
subtreeValueBiasWeightExponent = 0.85
"""
    with open(args.output, "w") as f:
        f.write(text)
    print(f"wrote {args.output}")
