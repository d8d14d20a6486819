"""Subcommand dispatch for the port, `python -m katacoffee_tpu_torch <cmd>`
(the JAX package's `katacoffee_tpu/cli.py`). The ported subcommands are
`selfplay`, `shuffle`, `train`, `validate`, `checkpoint`, `gatekeeper`,
`match`, `loop`, `summarize_sgfs`, `benchmark`, `gtp`, `analysis`,
`evalsgf`, `genconfig`, `genbook`, `writebook`, `checkbook`, `booktoposes`,
`demoplay`, `samplesgfs`, `dataminesgfs`, `viewstartposes`,
`trystartposes`, `sampleinitializations`, `runtests`, `serve`,
`contribute`, `version` and `printclockinfo`; any other exits non-zero and
says so."""

from __future__ import annotations

import argparse
import sys

from katacoffee_tpu_torch import __version__

_HELP = f"""KataCoffee on PyTorch and CUDA v{__version__}.

Usage: python -m katacoffee_tpu_torch <subcommand> [args]

  selfplay -output-dir DIR [-config FILE] [-override-config k=v,...]
               training-data daemon on the GPU: polls DIR/models, writes
               DIR/selfplay/<model>/{{tdata,sgfs}}
  shuffle DATA_DIR... -out-dir DIR [-min-rows N] [-val-prop P] [-seed S]
               power-law window of the newest rows, shuffled into chunks
  train -base-dir DIR [-config FILE] [-override-config k=v,...]
               trainer on the GPU: DIR/shuffleddata -> DIR/train/<run>,
               exports DIR/modelstobetested/<run>-s<step>
  validate MODEL_DIR DATA_DIR... [-max-rows N]
               loss metrics of an exported model over training rows
  checkpoint dump|edit|export ...
               inspect, edit or export a trainer checkpoint
  gatekeeper -base-dir DIR [-config FILE] [-override-config k=v,...]
             [-quit-if-no-candidates]
               candidate-vs-champion gating on the GPU: DIR/modelstobetested
               -> DIR/models or DIR/rejectedmodels, SGFs in DIR/gatekeepersgfs
  match MODEL_DIR|random ... [-games-per-pair N] [-visits V] [-sgf-dir D]
        [-seed S]
               round-robin matches between exported models, MLE Elos
  loop -base-dir DIR [-config FILE] [-override-config k=v,...]
               the synchronous selfplay -> shuffle -> train -> gate loop
  summarize_sgfs SGF_DIR... [-prior-games G] [-no-validate]
               tally SGF results (replayed on the GPU) and fit MLE Elos
  benchmark [-model MODEL_DIR] [-visits V] [-batch-sizes 1,16,64,256]
               search visits/s over game-batch sizes
  gtp [-config FILE] [-override-config k=v,...] [-model MODEL_DIR]
               GTP engine on stdin/stdout, searching on the GPU (uniform
               priors without -model)
  analysis [-config FILE] [-override-config k=v,...] [-model MODEL_DIR]
               JSON-lines analysis engine on stdin/stdout: a query's turns,
               and compatible queries together, as one batched search on
               the GPU
  evalsgf SGF [-move-num N] [-visits V] [-model MODEL_DIR]
          [-print-tree-depth D] [-print-branch 'MOVE ...']
               search one SGF position on the GPU, print the rows and PVs
  genconfig -output FILE [-model MODEL_DIR] [-noninteractive]
            [-target-seconds-per-move S]
               write a GTP config (maxVisits from a visits/s benchmark on
               the GPU with -model)
  genbook -out BOOK.json [-model MODEL_DIR] [-rounds R] [-batch-size B]
          [-visits V] [-resume] [-seed S]
               grow an opening book, each round one batched search on the GPU
  writebook BOOK.json -out-dir DIR [-max-nodes N]
               static HTML pages of the book
  checkbook BOOK.json
               consistency check of the book
  booktoposes BOOK.json -out-dir DIR [-min-turns T]
               the book's positions as SGF start positions
  demoplay [-model MODEL_DIR] [-visits V] [-games G] [-seed S]
               watch the engine play itself on the GPU
  samplesgfs SGF_DIR... -out-dir DIR [-sample-prob P] [-min-turn T]
             [-max-turn T] [-seed S]
               sample SGF prefixes into a startposes dir
  dataminesgfs SGF_DIR... -out-dir DIR [-model MODEL_DIR] [-visits V]
               [-batch-size B] [-sample-prob P] [-max-positions N]
               [-surprise-threshold F] [-seed S]
               keep the SGF positions a batched search finds surprising
  viewstartposes -start-poses-dir DIR [-min-weight W] [-idx I]
                 [-turn-weight-lambda L]
               print start positions, their weights and hints
  trystartposes -start-poses-dir DIR [-model MODEL_DIR] [-visits V]
                [-min-weight W] [-max-positions N]
               one batched search over start positions, the chosen moves
  sampleinitializations [-model MODEL_DIR] [-num N] [-evaluate]
                        [-area-prop P] [-temperature T] [-seed S]
               policy-sampled openings as the selfplay actor makes them
  runtests [PYTEST_ARGS...]
               pytest tests/ -q
  serve -base-dir DIR [-host H] [-port P] [-selfplay-visits V]
        [-parallel-games B] [-rating-game-prob P] [-rating-visits V]
        [-rating-games G] [-certfile F -keyfile K]
               the contribution bus's training server: hands out selfplay
               and rating tasks and models, stores uploads under DIR
  contribute -server URL [-cache-dir DIR] [-max-cycles N] [-seed S]
             [-cafile F]
               volunteer selfplay on the GPU against a training server
  version      print the version
  printclockinfo
               print the monotonic clock's resolution

selfplay, train and loop use every visible GPU, one process each, where
the batch divides over them; under torchrun --nproc-per-node N, selfplay
and train run one rank a process.
"""


# subcommands whose command module's main(argv) runs them
_COMMANDS = ("gatekeeper", "match", "loop", "summarize_sgfs", "benchmark", "evalsgf", "genconfig")
# subcommands run by command/genbook.py's and command/misc.py's main_<cmd>(argv)
_BOOK_COMMANDS = ("genbook", "writebook", "checkbook", "booktoposes")
_MISC_COMMANDS = ("demoplay", "samplesgfs", "dataminesgfs", "viewstartposes", "trystartposes",
                  "sampleinitializations")


def _shuffle(args: list[str]) -> int:
    from katacoffee_tpu_torch.dataio.shuffle import shuffle_data

    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch shuffle")
    ap.add_argument("data_dirs", nargs="+")
    ap.add_argument("-out-dir", required=True)
    ap.add_argument("-min-rows", type=int, default=250000)
    ap.add_argument("-expand-window-per-row", type=float, default=0.4)
    ap.add_argument("-taper-window-exponent", type=float, default=0.65)
    ap.add_argument("-keep-target-rows", type=int, default=None)
    ap.add_argument("-val-prop", type=float, default=0.0)
    ap.add_argument("-seed", type=int, default=None)
    a = ap.parse_args(args)
    print(shuffle_data(a.data_dirs, a.out_dir, min_rows=a.min_rows, expand_window_per_row=a.expand_window_per_row,
                       taper_window_exponent=a.taper_window_exponent, keep_target_rows=a.keep_target_rows,
                       val_prop=a.val_prop, seed=a.seed))
    return 0


def _gtp(args: list[str]) -> int:
    """`gtp [-model MODEL_DIR] ...`: the net's evaluator and its cached
    full-head forward (kata-raw-nn, ownership) from the exported model,
    both on the GPU (JAX cli.py:73-96)."""
    from katacoffee_tpu_torch.command.gtp import main as gtp_main

    if "-model" not in args:
        gtp_main(args)
        return 0
    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.search.mcts import make_cached_raw_forward_fn, make_nn_eval_fn

    i = args.index("-model")
    model_dir = args[i + 1]
    args = args[:i] + args[i + 2:]
    model, cfg, _ = load_exported_model(model_dir)
    gtp_main(args, cfg=cfg, eval_fn=make_nn_eval_fn(cfg, model), raw_fwd=make_cached_raw_forward_fn(cfg, model))
    return 0


def _analysis(args: list[str]) -> int:
    """`analysis [-model MODEL_DIR] ...`: an evaluator factory and a cached
    full-head forward factory (ownership, the root's raw heads) over the
    exported model, both on the GPU (JAX cli.py:97-120)."""
    from katacoffee_tpu_torch.command.analysis import main as analysis_main

    if "-model" not in args:
        analysis_main(args)
        return 0
    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.search.mcts import make_cached_raw_forward_fn, make_nn_eval_fn

    i = args.index("-model")
    model_dir = args[i + 1]
    args = args[:i] + args[i + 2:]
    model = load_exported_model(model_dir)[0]
    analysis_main(args, eval_fn_factory=lambda cfg: make_nn_eval_fn(cfg, model),
                  raw_forward_factory=lambda cfg: make_cached_raw_forward_fn(cfg, model))
    return 0


def _printclockinfo() -> int:
    """misc.cpp:564-575 role: sanity-print the engine's timing clock."""
    import time

    info = time.get_clock_info("monotonic")
    print(f"Clock: time.monotonic ({info.implementation})")
    print(f"Resolution in seconds: {info.resolution}")
    print(f"Ticks since epoch: {time.monotonic_ns()}")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(_HELP)
        return 0
    cmd, args = argv[0], argv[1:]
    if cmd == "selfplay":
        from katacoffee_tpu_torch.command.selfplay import main as selfplay_main

        selfplay_main(args)
        return 0
    if cmd == "shuffle":
        return _shuffle(args)
    if cmd == "train":
        from katacoffee_tpu_torch.command.train import main as train_main

        train_main(args)
        return 0
    if cmd == "validate":
        from katacoffee_tpu_torch.command.validate import main as validate_main

        return validate_main(args)
    if cmd == "checkpoint":
        from katacoffee_tpu_torch.command.checkpoint import main as checkpoint_main

        return checkpoint_main(args)
    if cmd == "gtp":
        return _gtp(args)
    if cmd == "analysis":
        return _analysis(args)
    if cmd == "version":
        print(__version__)
        return 0
    if cmd == "printclockinfo":
        return _printclockinfo()
    if cmd in _COMMANDS:
        import importlib

        importlib.import_module(f"katacoffee_tpu_torch.command.{cmd}").main(args)
        return 0
    if cmd in _BOOK_COMMANDS:
        from katacoffee_tpu_torch.command import genbook

        return getattr(genbook, f"main_{cmd}")(args) or 0
    if cmd in _MISC_COMMANDS:
        from katacoffee_tpu_torch.command import misc

        getattr(misc, f"main_{cmd}")(args)
        return 0
    if cmd in ("serve", "contribute"):
        from katacoffee_tpu_torch.distributed import client

        (client.main_serve if cmd == "serve" else client.main)(args)
        return 0
    if cmd == "runtests":
        import subprocess

        return subprocess.call([sys.executable, "-m", "pytest", "tests/", "-q"] + args)
    print(f"katacoffee_tpu_torch: {cmd} is not ported (or unknown); python -m katacoffee_tpu {cmd} runs the JAX "
          f"package's\n\n{_HELP}", file=sys.stderr)
    return 2
