"""summarize_sgfs: scan SGF dirs, tally results per player pairing, fit Elos.

The port of `katacoffee_tpu/command/summarize_sgfs.py` (the reference's
`python/summarize_sgfs.py` + `python/elo.py`): point it at match or
gatekeeper SGF directories and get a result table and a maximum-likelihood
Elo table. With `validate` every game is replayed through the port's own
rules (`game/board.py`), all games of one board size batched in lockstep on
the given device: a game with an illegal move (or a move after its end) is
skipped, and a game that ends takes its result from the replay. Without it,
or for a game the replay leaves unfinished, the result is the RE tag (what
the JAX package does where its native rules core is not built).
"""

from __future__ import annotations

import argparse
import os

import torch

from katacoffee_tpu_torch.dataio.sgf import parse_sgf_file
from katacoffee_tpu_torch.utils.elo import compute_elos

_RESULTS = {1: "B+", 2: "W+", 0: "0"}


def _replay(games: list, device: torch.device) -> list:
    """[(x, y, win_len, moves)] of one board size -> per game None (an
    illegal move) or the replayed result ("B+", "W+", "0", or None where the
    game has not ended)."""
    from katacoffee_tpu_torch.game.board import GameConfig, init_state, legal_mask_flat, step

    x, y, win_len, _ = games[0]
    cfg = GameConfig(x, y, win_len)
    # a spot off the board or a direction outside 0-3 (the empty move's
    # (-1, -1, D_NONE) too) is illegal, as the native rules core's is_legal
    # has it; such a game is not replayed, so every flat action below is in
    # range of the legal mask
    off = [any(not (0 <= mx < x and 0 <= my < y and 0 <= d < 4) for mx, my, d, _ in m) for _, _, _, m in games]
    moves = [[] if bad else [d * cfg.area + my * x + mx for mx, my, d, _ in m]
             for bad, (_, _, _, m) in zip(off, games)]
    G, T = len(games), max(len(m) for m in moves)
    if T == 0:
        return [False if bad else None for bad in off]  # no game ended without a move
    lengths = torch.tensor([len(m) for m in moves], device=device)
    acts = torch.tensor([m + [0] * (T - len(m)) for m in moves], device=device)
    rows = torch.arange(G, device=device)
    ok = ~torch.tensor(off, dtype=torch.bool, device=device)
    s = init_state(cfg, G, device)
    for t in range(T):
        live = t < lengths
        ok &= legal_mask_flat(cfg, s)[rows, acts[:, t]] | ~live
        s = step(cfg, s, torch.where(live & ok, acts[:, t], 0))
    ok, done, winner = ok.cpu().tolist(), s.done.cpu().tolist(), s.winner.cpu().tolist()
    return [(_RESULTS[w] if d else None) if k else False for k, d, w in zip(ok, done, winner)]


def collect_results(sgf_dirs: list[str], validate: bool = True, *,
                    device: str | torch.device | None = None) -> list[tuple]:
    """Returns records [(black, white, wins_b, wins_w, draws)] aggregated per
    (black, white) pairing. `validate` replays on `device` (default
    `cuda`)."""
    parsed = []
    skipped = 0
    for d in sgf_dirs:
        for root, _dirs, files in os.walk(d):
            for name in sorted(files):
                if not name.endswith(".sgf"):
                    continue
                try:
                    sgf = parse_sgf_file(os.path.join(root, name))
                    pb = sgf.root.get("PB") or "black"
                    pw = sgf.root.get("PW") or "white"
                    re = sgf.result()
                    game = (*sgf.board_size(), sgf.win_len(), sgf.moves()) if validate and re is not None else None
                except (ValueError, OSError):
                    skipped += 1
                    continue
                if re is None:
                    skipped += 1
                    continue
                parsed.append([pb, pw, re, game])

    if validate and parsed:
        from katacoffee_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        by_size: dict[tuple, list] = {}
        for rec in parsed:
            by_size.setdefault(rec[3][:3], []).append(rec)
        for recs in by_size.values():
            for rec, replayed in zip(recs, _replay([r[3] for r in recs], dev)):
                if replayed is False:
                    rec[2] = None
                elif replayed is not None:
                    rec[2] = replayed

    tally: dict[tuple, list] = {}
    for pb, pw, re, _ in parsed:
        if re is None:
            skipped += 1
            continue
        t = tally.setdefault((pb, pw), [0, 0, 0])
        if re.startswith("B+"):
            t[0] += 1
        elif re.startswith("W+"):
            t[1] += 1
        else:
            t[2] += 1
    records = [(pb, pw, t[0], t[1], t[2]) for (pb, pw), t in sorted(tally.items())]
    if skipped:
        print(f"skipped {skipped} unreadable/invalid SGFs")
    return records


def main(argv, *, device: str | torch.device | None = None) -> None:
    """Entry for `python -m katacoffee_tpu_torch summarize_sgfs` (JAX
    summarize_sgfs.py:75): the same arguments; the replay runs on `device`
    (default `cuda`; `-no-validate` needs none)."""
    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch summarize_sgfs")
    ap.add_argument("sgf_dirs", nargs="+")
    ap.add_argument("-prior-games", type=float, default=2.0)
    ap.add_argument("-no-validate", action="store_true")
    args = ap.parse_args(argv)

    records = collect_results(args.sgf_dirs, validate=not args.no_validate, device=device)
    if not records:
        print("no results found")
        return
    total = 0
    for pb, pw, wb, ww, dr in records:
        total += wb + ww + dr
        print(f"{pb} (B) vs {pw} (W): {wb}-{ww}-{dr}")
    print(f"total games: {total}")
    elos = compute_elos(records, prior_games=args.prior_games)
    print()
    print(f"{'player':30s} {'elo':>8s} {'stdev':>7s}")
    for name, (e, s) in sorted(elos.as_dict().items(), key=lambda kv: -kv[1][0]):
        print(f"{name:30s} {e:8.1f} {s:7.1f}")
