"""evalsgf: analyze one position from an SGF file, the port of
`katacoffee_tpu/command/evalsgf.py` over the port's `Engine` on `device`
(default `cuda`).

The role of the reference's `cpp/command/evalsgf.cpp`: load an SGF, go to a
move number, run a search there, print the board, the chosen move, and the
top analysis rows with PVs.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from katacoffee_tpu_torch.dataio.sgf import parse_sgf_file
from katacoffee_tpu_torch.device import resolve_device
from katacoffee_tpu_torch.game import io as gio
from katacoffee_tpu_torch.game.board import GameConfig
from katacoffee_tpu_torch.program.engine import Engine
from katacoffee_tpu_torch.search.mcts import make_nn_eval_fn
from katacoffee_tpu_torch.search.params import SearchParams


def main(argv, *, device: str | torch.device | None = None):
    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch evalsgf")
    ap.add_argument("sgf")
    ap.add_argument("-move-num", type=int, default=-1, help="analyze before this move (default: end)")
    ap.add_argument("-visits", type=int, default=400)
    ap.add_argument("-model", default=None)
    ap.add_argument(
        "-print-tree-depth", type=int, default=0,
        help="dump the search tree to this depth (evalsgf.cpp printTree role)",
    )
    ap.add_argument(
        "-print-branch", default=None,
        help="space-separated moves (e.g. 'C3N C4N') to descend before dumping",
    )
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    sgf = parse_sgf_file(args.sgf)
    x, y = sgf.board_size()
    cfg = GameConfig(x, y, sgf.win_len())
    sp = SearchParams.for_tests_v2()

    eval_fn = None
    if args.model:
        from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model

        model, cfg, _ = load_exported_model(args.model, device=dev)
        eval_fn = make_nn_eval_fn(cfg, model)

    eng = Engine(cfg, sp, eval_fn, device=dev)
    moves = sgf.moves()
    pls = sgf.placements()
    if pls:
        board = np.zeros((cfg.y_size, cfg.x_size), np.int8)
        for px, py, ppla in pls:
            board[py, px] = ppla
        eng.set_position(board, moves[0][3] if moves else 1)
    upto = args.move_num if args.move_num >= 0 else len(moves)
    for mx, my, md, mpla in moves[:upto]:
        eng.play(mx, my, md, mpla)

    print(eng.showboard())
    print(f"to move: {'black' if eng.to_move == 1 else 'white'}")
    if eng.game_over:
        print(f"game over, winner: {eng.winner}")
        return
    result = eng.analyze(args.visits)
    print(
        f"root: visits {result.root_visits} winrate {result.root_winrate:.3f} "
        f"draw {result.root_draw_prob:.3f} utility {result.root_utility:+.3f}"
    )
    for mi in result.move_infos[:10]:
        print(
            f"  {mi.move:16s} v={mi.visits:6d} wr={mi.winrate:.3f} "
            f"prior={mi.prior:.3f} lcb={mi.lcb:+.3f} pv: {' -> '.join(mi.pv[:6])}"
        )
    if args.print_tree_depth > 0 or args.print_branch:
        branch = None
        if args.print_branch:
            branch = []
            for ms in args.print_branch.split():
                bx, by, bd = gio.parse_loc(ms, cfg)
                branch.append(bd * cfg.area + by * cfg.x_size + bx)
        print(eng.print_tree(max_depth=max(args.print_tree_depth, 1), branch=branch))
