"""Subcommand dispatch for the port, `python -m katacoffee_tpu_torch <cmd>`
(the JAX package's `katacoffee_tpu/cli.py`). Only `selfplay` is ported; any
other subcommand exits non-zero and says so."""

from __future__ import annotations

import sys

from katacoffee_tpu_torch import __version__

_HELP = f"""KataCoffee on PyTorch and CUDA v{__version__}.

Usage: python -m katacoffee_tpu_torch <subcommand> [args]

  selfplay -output-dir DIR [-config FILE] [-override-config k=v,...]
               training-data daemon on the GPU: polls DIR/models, writes
               DIR/selfplay/<model>/{{tdata,sgfs}}

Every other subcommand of `python -m katacoffee_tpu` is not ported yet.
"""


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
    print(f"katacoffee_tpu_torch: {cmd} is not ported (or unknown); python -m katacoffee_tpu {cmd} runs the JAX "
          f"package's\n\n{_HELP}", file=sys.stderr)
    return 2
