"""Book commands: genbook / writebook / checkbook / booktoposes, the port of
`katacoffee_tpu/command/genbook.py` (the CLI role of the reference's
`cpp/command/genbook.cpp`). `genbook` searches on `device` (default
`cuda`); the other three read and write files, and load the book onto
`device` as `Book.load` does."""

from __future__ import annotations

import argparse
import os

import torch

from katacoffee_tpu_torch.book import Book, build_book
from katacoffee_tpu_torch.dataio.sgf import write_sgf
from katacoffee_tpu_torch.game.board import GameConfig
from katacoffee_tpu_torch.search.mcts import make_nn_eval_fn, uniform_eval_fn
from katacoffee_tpu_torch.search.params import SearchParams

Device = str | torch.device | None


def main_genbook(argv, *, device: Device = None):
    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch genbook")
    ap.add_argument("-out", required=True, help="book JSON path")
    ap.add_argument("-model", default=None)
    ap.add_argument("-rounds", type=int, default=10)
    ap.add_argument("-batch-size", type=int, default=64)
    ap.add_argument("-visits", type=int, default=300)
    ap.add_argument("-resume", action="store_true")
    ap.add_argument("-seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = GameConfig(5, 5, 4)
    if args.model:
        from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model

        model, cfg, _ = load_exported_model(args.model, device)
        eval_fn = make_nn_eval_fn(cfg, model)
    else:
        eval_fn = uniform_eval_fn(cfg)

    if args.resume and os.path.exists(args.out):
        book = Book.load(args.out, device)
        generator = torch.Generator(device=book.device).manual_seed(args.seed + 1)
        for r in range(args.rounds):
            frontier = book.frontier(args.batch_size)
            if not frontier:
                break
            book.expand(frontier, SearchParams.for_tests_v2(), eval_fn, args.visits, generator)
            print(f"book: round {r}: +{len(frontier)} -> {len(book.nodes)} nodes")
        book.recompute()
    else:
        book = build_book(
            cfg,
            SearchParams.for_tests_v2(),
            eval_fn,
            num_rounds=args.rounds,
            batch_size=args.batch_size,
            num_visits=args.visits,
            seed=args.seed,
            device=device,
        )
    book.save(args.out)
    print(f"saved {len(book.nodes)} nodes to {args.out}")


def main_writebook(argv, *, device: Device = None):
    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch writebook")
    ap.add_argument("book")
    ap.add_argument("-out-dir", required=True)
    ap.add_argument("-max-nodes", type=int, default=2000)
    args = ap.parse_args(argv)
    book = Book.load(args.book, device)
    book.export_html(args.out_dir, max_nodes=args.max_nodes)
    print(f"wrote HTML for up to {args.max_nodes} of {len(book.nodes)} nodes to {args.out_dir}")


def main_checkbook(argv, *, device: Device = None):
    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch checkbook")
    ap.add_argument("book")
    args = ap.parse_args(argv)
    book = Book.load(args.book, device)
    errors = book.check()
    for e in errors:
        print("ERROR:", e)
    print(f"{len(book.nodes)} nodes, {sum(len(n.edges) for n in book.nodes.values())} edges, "
          f"{len(errors)} errors")
    return 1 if errors else 0


def main_booktoposes(argv, *, device: Device = None):
    """Dump book positions as SGF start positions (booktoposes)."""
    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch booktoposes")
    ap.add_argument("book")
    ap.add_argument("-out-dir", required=True)
    ap.add_argument("-min-turns", type=int, default=1)
    args = ap.parse_args(argv)
    book = Book.load(args.book, device)
    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    for key, node in book.nodes.items():
        if node.num_turns < args.min_turns:
            continue
        placements = [
            (x, y, node.board[y][x])
            for y in range(book.cfg.y_size)
            for x in range(book.cfg.x_size)
            if node.board[y][x] != 0
        ]
        text = write_sgf(
            book.cfg.x_size, book.cfg.y_size, book.cfg.win_len, [],
            "book", "book", placements=placements,
            root_comment=f"bookNode={key},toMove={node.to_move},"
                         f"lastSpot={node.last_spot},lastDir={node.last_dir}",
        )
        with open(os.path.join(args.out_dir, f"{key}.sgf"), "w") as f:
            f.write(text + "\n")
        n += 1
    print(f"wrote {n} start positions to {args.out_dir}")
