"""The port's opening book (`katacoffee_tpu_torch.book`) and its commands
against the JAX package's, on the CPU.

A book built by both packages on the tiny net at float32, under
`for_tests_v2()` (graph search, noise pruning, uncertainty, subtree bias;
no root draws), batch 4 (a round of more than one node pads to 8), 16
visits and 3 rounds: the same node keys in the same order, boards, movers,
last moves, visits, expanded flags, edges (action, child key, visits) and
`best_line`; winloss, draw, path_prob, wl_cost, book_wl and the edge priors
within 2e-4 (float32 sums of another order over a whole search, as
tests/test_torch_engine.py). Keys are compared on states whose symmetric
images tie. A book JAX saved loads and saves back to the same bytes, and
exports the same HTML files byte for byte. The four commands run with the
same arguments without a net (uniform priors, exact in both packages): the
same output, and genbook's book (one round, then one -resume round) byte
for byte.
Each JAX search shape compiles once in this module."""

import contextlib
import filecmp
import functools
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katacoffee_tpu.book import Book as JaxBook
from katacoffee_tpu.book import book as JBK
from katacoffee_tpu.book import build_book as jax_build_book
from katacoffee_tpu.command import genbook as jax_genbook
from katacoffee_tpu.game import board as JB
from katacoffee_tpu.search import mcts as JM
from katacoffee_tpu.search.params import SearchParams as JaxParams
from katacoffee_tpu_torch.book import Book, build_book
from katacoffee_tpu_torch.book import book as TBK
from katacoffee_tpu_torch.command import genbook
from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
from katacoffee_tpu_torch.game import symmetry as TS
from katacoffee_tpu_torch.game.board import GameConfig, init_state, step
from katacoffee_tpu_torch.search import mcts as TM
from katacoffee_tpu_torch.search.params import SearchParams
from torch_parity import jax_exported_net, one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINYNET = os.path.join(ROOT, "tests/goldens/tinynet")
CFG = GameConfig(5, 5, 4)
JCFG = JB.GameConfig(5, 5, 4)
FLOAT_TOL = 2e-4
FLOATS = ("winloss", "draw", "path_prob", "wl_cost", "book_wl")
EXACT = ("board", "to_move", "last_spot", "last_dir", "num_turns", "visits", "expanded", "rec_visits")


@functools.lru_cache(maxsize=None)
def books():
    """(JAX's book, the port's), each built once on the tiny net at float32."""
    jnet, params = jax_exported_net(TINYNET)
    tnet = load_exported_model(TINYNET, device="cpu", dtype=torch.float32)[0]
    quiet = lambda *a: None  # noqa: E731
    jb = jax_build_book(JCFG, JaxParams.for_tests_v2(), JM.make_nn_eval_fn(JCFG, jnet, params), 3, 4, 16, log=quiet)
    tb = build_book(CFG, SearchParams.for_tests_v2(), TM.make_nn_eval_fn(CFG, tnet), 3, 4, 16, log=quiet,
                    device="cpu")
    return jb, tb


def test_book_matches_jax():
    jb, tb = books()
    assert tb.root_key == jb.root_key and list(tb.nodes) == list(jb.nodes) and len(tb.nodes) > 8
    assert tb.best_line() == jb.best_line() and len(tb.best_line()) >= 2
    assert sum(len(n.edges) for n in tb.nodes.values()) > 8
    worst = 0.0
    for k, j in jb.nodes.items():
        t = tb.nodes[k]
        assert [getattr(t, f) for f in EXACT] == [getattr(j, f) for f in EXACT], k
        assert [(a, e[0], e[2]) for a, e in t.edges.items()] == [(a, e[0], e[2]) for a, e in j.edges.items()], k
        for a, e in j.edges.items():
            worst = max(worst, abs(t.edges[a][1] - e[1]))
        assert abs(t.unexpanded_mass - j.unexpanded_mass) <= FLOAT_TOL
        for f in FLOATS:
            worst = max(worst, abs(getattr(t, f) - getattr(j, f)))
    assert worst <= FLOAT_TOL
    assert tb.check() == [] and jb.check() == []
    assert tb.frontier(8) == jb.frontier(8)


def _tied_positions():
    """(port [1] state, JAX state) pairs, many with symmetric images that
    tie (positions fixed by some symmetries): the empty board, a first stone
    at the centre in each direction and in a corner, and random legal
    openings of 1-6 plies that start at the centre or on a diagonal."""
    from katacoffee_tpu.game.board import init_state as jax_init
    from katacoffee_tpu.game.board import step as jax_step
    from katacoffee_tpu_torch.game.board import legal_mask_flat

    rng = np.random.default_rng(5)
    seqs = [[], [12], [25 + 12], [50 + 12], [75 + 12], [0], [50], [50 + 24]]
    seqs += [[int(rng.choice([12, 37, 62, 87, 50, 56, 68]))] for _ in range(8)]
    pairs = []
    for k, seq in enumerate(seqs):
        t, j = init_state(CFG, 1, "cpu"), jax_init(JCFG)
        for i in range(len(seq) + (1 + k % 6 if k >= 8 else 0)):
            a = seq[i] if i < len(seq) else int(rng.choice(np.flatnonzero(legal_mask_flat(CFG, t)[0].numpy())))
            t, j = step(CFG, t, torch.tensor([a])), jax_step(JCFG, j, jnp.asarray(a, jnp.int32))
            if bool(t.done[0]):
                break
        pairs.append((t, j))
    return pairs


def test_canonical_key_matches_jax_on_tied_images():
    pairs = _tied_positions()
    tied = 0
    want = [JBK._canonical_key(JCFG, j) for _, j in pairs]
    for (t, _), key in zip(pairs, want):
        assert TBK._canonical_key(CFG, t) == key
        imgs = TBK._canonical_images(CFG, t.map(lambda x: x.repeat_interleave(8, 0)))
        keys = {TBK._canonical_images(CFG, TS.apply_state(CFG, s, t))[0].key for s in range(8)}
        tied += len(keys) < 8
        assert len({i.key for i in imgs}) == 1 and keys == {imgs[0].key}
    assert tied >= 5
    # the batched keys of all positions at once equal the one-by-one keys
    stacked = TBK._canonical_images(CFG, type(pairs[0][0])(*(torch.cat(f) for f in zip(*(p[0] for p in pairs)))))
    assert [(i.key, i.sym) for i in stacked] == want


def test_save_and_load_match_jax(tmp_path):
    jb, tb = books()
    jb.save(str(tmp_path / "jax.json"))
    tb.save(str(tmp_path / "port.json"))
    loaded = Book.load(str(tmp_path / "jax.json"), device="cpu")
    loaded.save(str(tmp_path / "again.json"))
    assert (tmp_path / "again.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    want, got = json.loads((tmp_path / "jax.json").read_text()), json.loads((tmp_path / "port.json").read_text())
    assert list(got) == list(want) and list(got["nodes"]) == list(want["nodes"])
    for k, n in want["nodes"].items():
        assert list(got["nodes"][k]) == list(n) and list(got["nodes"][k]["edges"]) == list(n["edges"])
    assert loaded.check() == [] and JaxBook.load(str(tmp_path / "port.json")).check() == []


def test_export_html_matches_jax(tmp_path):
    jb, tb = books()
    jb.export_html(str(tmp_path / "jax"))
    tb.export_html(str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert len(os.listdir(tmp_path / "jax")) == len(jb.nodes) + 3
    # the same book exports the same bytes
    jb.save(str(tmp_path / "jax.json"))
    Book.load(str(tmp_path / "jax.json"), device="cpu").export_html(str(tmp_path / "same"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert filecmp.cmpfiles(tmp_path / "jax", tmp_path / "same", names, shallow=False)[0] == names


def _run(fn, argv, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv, **kw)
    return rc, out.getvalue()


def test_book_commands_match_jax(tmp_path):
    """genbook without a net (1 round, then 1 -resume round), writebook,
    checkbook and booktoposes with the same arguments: the same output and
    files, the book byte for byte."""
    outs = {}
    for name, mod, kw in (("jax", jax_genbook, {}), ("port", genbook, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        book = str(d / "book.json")
        got = [_run(mod.main_genbook, ["-out", book, "-rounds", "1", "-batch-size", "4", "-visits", "8"], **kw),
               _run(mod.main_genbook, ["-out", book, "-rounds", "1", "-batch-size", "4", "-visits", "8",
                                       "-resume"], **kw),
               _run(mod.main_writebook, [book, "-out-dir", str(d / "html"), "-max-nodes", "5"], **kw),
               _run(mod.main_checkbook, [book], **kw),
               _run(mod.main_booktoposes, [book, "-out-dir", str(d / "poses")], **kw)]
        outs[name] = [(rc, text.replace(str(d), "D")) for rc, text in got]
    assert outs["port"] == outs["jax"]
    assert outs["port"][1][1].startswith("book: round 0: +") and outs["port"][3][0] == 0
    assert (tmp_path / "port/book.json").read_bytes() == (tmp_path / "jax/book.json").read_bytes()
    for sub in ("html", "poses"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert names and sorted(os.listdir(tmp_path / "port" / sub)) == names
        assert filecmp.cmpfiles(tmp_path / "jax" / sub, tmp_path / "port" / sub, names, shallow=False)[0] == names


def test_book_entry_points_refuse_the_cpu_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Book(CFG)
