"""Parity of the PyTorch symmetry module (`katacoffee_tpu_torch.game.symmetry`)
with the JAX one: on random positions at 5x5 and 9x9 (8 symmetries) and on a
6x4 board (4 symmetries), every transform is equal bit for bit, for one
symmetry for the whole batch and for one symmetry per game. There is no
tolerance: the transforms move values and recompute integer hashes."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katacoffee_tpu.game import board as JB
from katacoffee_tpu.game import symmetry as JS
from katacoffee_tpu.nn.features import extract_features as jax_features
from katacoffee_tpu_torch.game import board as TB
from katacoffee_tpu_torch.game import symmetry as TS
from katacoffee_tpu_torch.nn.features import extract_features
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

BOARDS = {"5x5": (5, 5, 4), "9x9": (9, 9, 4), "6x4": (6, 4, 4)}


@functools.lru_cache(maxsize=None)
def _positions(board, batch=12, seed=3):
    """Torch states after 0..12 random legal plies, and the same as a JAX
    batch."""
    cfg = TB.GameConfig(*BOARDS[board])
    rng = np.random.default_rng(seed)
    s = TB.init_state(cfg, batch, "cpu")
    plies = rng.integers(0, 13, batch)
    for ply in range(12):
        legal = TB.legal_mask_flat(cfg, s).numpy()
        act = torch.from_numpy((rng.random(legal.shape) * legal).argmax(-1))
        new = TB.step(cfg, s, act)
        keep = torch.from_numpy(ply < plies)
        s = TB.GameState(*(torch.where(keep.view(-1, *[1] * (o.dim() - 1)), n, o) for o, n in zip(s, new)))
    js = JB.GameState(*(
        jnp.asarray(x.numpy().astype(np.uint32 if name == "stone_hash" else
                                     np.int32 if x.dtype == torch.int64 else x.numpy().dtype))
        for name, x in s._asdict().items()
    ))
    return cfg, JB.GameConfig(*BOARDS[board]), s, js


def _same(t, j, what):
    j = np.asarray(j)
    assert np.array_equal(t.numpy(), j.astype(np.int64) if j.dtype in (np.uint32, np.int32) else j), what


@pytest.mark.parametrize("board", list(BOARDS))
def test_every_transform_matches_jax(board):
    tcfg, jcfg, ts, js = _positions(board)
    nsym = TS.num_symmetries(tcfg)
    assert nsym == JS.num_symmetries(jcfg) == (8 if board != "6x4" else 4)
    assert np.array_equal(TS.action_table(tcfg), JS.action_table(jcfg))
    rng = np.random.default_rng(1)
    policy = rng.random((ts.board.shape[0], tcfg.policy_size)).astype(np.float32)
    actions = rng.integers(0, tcfg.policy_size, (ts.board.shape[0],))
    t_sp, _ = extract_features(tcfg, ts)
    j_sp, _ = jax.vmap(functools.partial(jax_features, jcfg))(js)
    for s in range(nsym):
        assert TS.dir_perm(s) == JS.dir_perm(s) and TS.invert(s) == JS.invert(s)
        for t in range(nsym):
            assert TS.compose(s, t) == JS.compose(s, t)
        jstate = jax.vmap(lambda st, s=s: JS.apply_state(jcfg, s, st))(js)
        tstate = TS.apply_state(tcfg, s, ts)
        for name in TB.GameState._fields:
            _same(getattr(tstate, name), getattr(jstate, name), (s, name))
        _same(TS.apply_policy(tcfg, s, torch.from_numpy(policy)), JS.apply_policy(jcfg, s, jnp.asarray(policy)),
              (s, "policy"))
        _same(TS.apply_action(tcfg, s, torch.from_numpy(actions)),
              JS.apply_action(jcfg, s, jnp.asarray(actions, jnp.int32)), (s, "action"))
        _same(TS.apply_spot(tcfg, s, ts.recent_spots), JS.apply_spot(jcfg, s, js.recent_spots), (s, "spot"))
        _same(TS.apply_direction(s, ts.recent_dirs), JS.apply_direction(s, js.recent_dirs), (s, "direction"))
        _same(TS.apply_features(s, t_sp), JS.apply_features(s, j_sp), (s, "features"))
        _same(TS.apply_plane(s, ts.board), JS.apply_plane(s, js.board), (s, "plane"))


@pytest.mark.parametrize("board", list(BOARDS))
def test_one_symmetry_per_game_equals_the_batch_transforms(board):
    """A [B] tensor of symmetries transforms each game as its own int."""
    tcfg, _, ts, _ = _positions(board)
    B = ts.board.shape[0]
    syms = torch.arange(B) % TS.num_symmetries(tcfg)
    policy = torch.rand((B, tcfg.policy_size), generator=torch.Generator().manual_seed(0))
    actions = torch.randint(0, tcfg.policy_size, (B,), generator=torch.Generator().manual_seed(1))
    per_row = TS.apply_state(tcfg, syms, ts)
    for b in range(B):
        s = int(syms[b])
        one = TS.apply_state(tcfg, s, ts.map(lambda x: x[b: b + 1]))
        for name in TB.GameState._fields:
            assert torch.equal(getattr(per_row, name)[b: b + 1], getattr(one, name)), (b, name)
        assert torch.equal(TS.apply_policy(tcfg, syms, policy)[b], TS.apply_policy(tcfg, s, policy[b: b + 1])[0])
        assert torch.equal(TS.apply_action(tcfg, syms, actions)[b], TS.apply_action(tcfg, s, actions[b: b + 1])[0])
        back = TS.apply_policy(tcfg, TS.invert(syms), TS.apply_policy(tcfg, syms, policy))
        assert torch.equal(back, policy)


@pytest.mark.parametrize("board", ["5x5", "6x4"])
def test_stabilizer_matches_jax(board):
    tcfg, jcfg, ts, js = _positions(board, batch=6, seed=0)
    # the empty board is fixed by every symmetry
    want = [JS.stabilizer(jcfg, jax.tree_util.tree_map(lambda x, b=b: x[b], js)) for b in range(6)]
    assert TS.stabilizer(tcfg, ts) == want
    assert TS.stabilizer(tcfg, TB.init_state(tcfg, 1, "cpu")) == [list(range(TS.num_symmetries(tcfg)))]


def test_transposes_on_a_rectangle_and_random_symmetries():
    tcfg, _, ts, _ = _positions("6x4")
    with pytest.raises(ValueError, match="square"):
        TS.apply_state(tcfg, 4, ts)
    with pytest.raises(ValueError, match="square"):
        TS.apply_policy(tcfg, torch.full((ts.board.shape[0],), 5), torch.zeros(ts.board.shape[0], 96))
    g = torch.Generator().manual_seed(0)
    draws = TS.random_symmetry(g, (4000,))
    assert draws.min() == 0 and draws.max() == 7 and torch.bincount(draws).min() > 400
    assert torch.equal(TS.random_symmetry(torch.Generator().manual_seed(5), (9,)),
                       TS.random_symmetry(torch.Generator().manual_seed(5), (9,)))
