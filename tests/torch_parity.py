"""Helpers shared by the tests of the PyTorch port: a fixture that keeps
torch on one CPU thread, and, for the tests that hold the search
(`katacoffee_tpu_torch.search.mcts`) to the JAX one under the selfplay
profile, the JAX search run with its root draws recorded, those draws handed
to the port as `RootDraws`, and trees converted between the two packages.

The JAX search draws at the root and, with graphSearchCatchUpLeakProb > 0,
once a playout or round for the catch-up leak (`leak_draws` replays those
from the key chain). At the root it draws the
root symmetries from `k_pick` and the Dirichlet noise's gamma sample from
`k_noise`, both split off the search key (`run_search` :2422 `k_init`;
`init_tree` :797 `k_eval`, `k_noise`; `_root_eval` :460 `k_pick`; for a
reused tree `advance_root` :2671 `k_eval`, `k_noise1`, `k_noise2`). The
symmetries are derived here from that key chain. The gamma sample depends
on the alphas the JAX search computes, so `jax.random.gamma` is wrapped to
record what it returns (through a debug callback, which runs under jit), and
the key it was called with is checked against the chain."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katacoffee_tpu.game import symmetry as JS
from katacoffee_tpu.search import mcts as JM
from katacoffee_tpu_torch.game import board as TB
from katacoffee_tpu_torch.search import mcts as TM


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Runs a test module's torch ops on one CPU thread, then restores the
    count. The tests' tensors are tiny, and pytest-xdist runs several
    workers at once: torch's thread pool in each of them only contends for
    the cores (the port's tests took about 2.4x as long with it). Imported by
    every tests/test_torch_*.py module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_GAMMA_SINKS = []  # the lists of the open recorded_gamma blocks


@contextlib.contextmanager
def recorded_gamma():
    """Wraps jax.random.gamma; yields the list of (key, sample) numpy pairs
    of its calls, recorded when they run (also under jit, and by a function
    compiled inside an earlier block, whose callback writes to the list of
    the block open when it runs)."""
    calls = []
    orig = jax.random.gamma

    def gamma(key, a, *args, **kw):
        out = orig(key, a, *args, **kw)
        jax.debug.callback(lambda k, o: _GAMMA_SINKS[-1].append((np.asarray(k), np.asarray(o))), key, out)
        return out

    jax.random.gamma = gamma
    _GAMMA_SINKS.append(calls)
    try:
        yield calls
    finally:
        _GAMMA_SINKS.pop()
        jax.random.gamma = orig


def symmetry_draws(cfg, jsp, k_eval, batch):
    """[B, k] root symmetries `_root_eval` draws from `k_eval`, or None."""
    nsym = JS.num_symmetries(cfg)
    k = min(int(jsp.rootNumSymmetriesToSample), nsym)
    if k <= 1:
        return None
    k_pick, _ = jax.random.split(k_eval)
    perm = np.asarray(jnp.argsort(jax.random.uniform(k_pick, (batch, nsym)), axis=-1))
    return torch.from_numpy(perm[:, :k].copy())


def _gamma_draw(calls, i, key):
    assert np.array_equal(calls[i][0], np.asarray(key)), "the gamma sample is not the key chain's"
    return torch.from_numpy(calls[i][1].copy())


@functools.lru_cache(maxsize=None)
def _jitted_search(cfg, jsp, jev, visits, max_nodes):
    """JAX `run_search` with `with_diag`, jitted once for each
    configuration, so that the cases of a file that share one compile it
    once (the roots' shapes and the reuse arguments' structure are part of
    the jitted function's own cache key)."""
    return jax.jit(lambda r, k, kw: JM.run_search(cfg, jsp, jev, r, visits, k, max_nodes=max_nodes, with_diag=True,
                                                  **kw))


def jax_search(cfg, jsp, jev, jroots, visits, key, max_nodes=None, **reuse):
    """JAX `run_search` with `with_diag`, jitted, and the `TM.RootDraws`
    that reproduce its root draws in the port. `reuse` holds reuse_tree,
    reuse_actions, reuse_ok."""
    B = jroots.board.shape[0]
    with recorded_gamma() as calls:
        jtree, diag = jax.block_until_ready(_jitted_search(cfg, jsp, jev, visits, max_nodes)(jroots, key, reuse))
        jax.effects_barrier()
    k_init, _ = jax.random.split(key)
    noise = jsp.rootNoiseEnabled
    if reuse.get("reuse_tree") is None:
        k_eval, k_noise = jax.random.split(k_init)
        draws = TM.RootDraws(syms=symmetry_draws(cfg, jsp, k_eval, B),
                             gamma=_gamma_draw(calls, 0, k_noise) if noise else None)
    else:
        k_eval, k_noise1, k_noise2 = jax.random.split(k_init, 3)
        draws = TM.RootDraws(syms=symmetry_draws(cfg, jsp, k_eval, B),
                             gamma=_gamma_draw(calls, 0, k_noise1) if noise else None,
                             gamma_reused=_gamma_draw(calls, 1, k_noise2) if noise else None)
    assert len(calls) == (0 if not noise else 1 if reuse.get("reuse_tree") is None else 2)
    return jtree, diag, draws


def round_keys(key):
    """The keys of the rounds of a search loop that starts from `key`: each
    round splits (round key, the rest)."""
    while True:
        k, key = jax.random.split(key)
        yield k


def leak_draws(key, K):
    """`draw_leak` replaying the leak draws of JAX's rounds from `key`."""
    keys = round_keys(key)

    def draw(rows, cols):
        k_leak = jax.random.split(next(keys), 3)[0]
        k_u = jax.random.fold_in(jax.random.fold_in(k_leak, 0), 1) if K == 1 else jax.random.fold_in(k_leak, 1)
        return torch.from_numpy(np.array(jax.random.uniform(k_u, (rows, cols))))

    return draw


def torch_states(jstates):
    """A JAX GameState batch as the port's (uint32 and int32 as int64)."""
    def conv(x):
        x = np.asarray(x)
        return torch.from_numpy(x.astype(np.int64) if x.dtype in (np.uint32, np.int32) else x.copy())

    return TB.GameState(*(conv(x) for x in jstates))


def torch_tree(jtree):
    """A JAX Tree as the port's (integer fields as the port holds them)."""
    fields = {}
    for name in TM.Tree._fields:
        x = getattr(jtree, name)
        if name == "states":
            fields[name] = torch_states(x)
            continue
        x = np.asarray(x)
        t = torch.from_numpy(x.copy())
        if name in ("children", "edge_visits", "policy_rank"):
            t = t.to(torch.int32)
        elif x.dtype in (np.int32, np.uint32):
            t = torch.from_numpy(x.astype(np.int64))
        fields[name] = t
    return TM.Tree(**fields)


def jax_states(tstates):
    """The port's GameState batch as JAX's (the JAX package's dtypes)."""
    return JM.GameState(*(
        jnp.asarray(x.numpy().astype(np.uint32 if name == "stone_hash" else
                                     np.int32 if x.dtype == torch.int64 else x.numpy().dtype))
        for name, x in tstates._asdict().items()
    ))


def jax_tree(ttree):
    """The port's Tree as a JAX Tree (the JAX package's dtypes)."""
    fields = {}
    for name in TM.Tree._fields:
        x = getattr(ttree, name)
        if name == "states":
            fields[name] = jax_states(x)
        elif name == "sit_hash":
            fields[name] = jnp.asarray(x.numpy().astype(np.uint32))
        elif x.dtype == torch.int64:
            fields[name] = jnp.asarray(x.numpy().astype(np.int32))
        else:
            fields[name] = jnp.asarray(x.numpy())
    return JM.Tree(**fields)


def assert_same_search(jtree, ttree):
    """Root visit counts, node counts and child links equal; root values
    within 2e-4 (float32 sums of another order over a whole search)."""
    jv = np.asarray(JM.root_visit_counts(jtree))
    tv = TM.root_visit_counts(ttree).numpy()
    assert np.array_equal(tv, jv), (tv[tv != jv], jv[tv != jv])
    assert np.array_equal(ttree.node_count.numpy(), np.asarray(jtree.node_count))
    assert np.array_equal(ttree.children.numpy(), np.asarray(jtree.children))
    jr, tr = JM.root_values(jtree), TM.root_values(ttree)
    for k in jr:
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]), atol=2e-4, rtol=0, err_msg=k)


def training_rows(cfg, rows: int, seed: int, zero_policy: float = 0.1, side: float = 0.2) -> dict:
    """A shard's row dict (schema v2, the writers' dtypes) of random rows:
    boards and move histories from the seed, about `zero_policy` of the rows
    with all-zero policy targets and `side` of them side rows (aux_weight 0,
    game-outcome targets zero)."""
    rng = np.random.default_rng(seed)
    Y, X, A = cfg.y_size, cfg.x_size, 4 * cfg.y_size * cfg.x_size

    def probs(*shape, sparse=0.0):
        p = rng.random(shape) * (rng.random(shape) >= 0.5)
        p[..., 0] += 1e-3
        p = p / p.sum(-1, keepdims=True)
        if sparse:
            p[rng.random(shape[0]) < sparse] = 0.0
        return p.astype(np.float16)

    recent = rng.integers(-1, cfg.area, (rows, 6))
    # a shorter history is cut from the back, as in a real game
    depth = rng.integers(0, 7, rows)
    recent = np.where(np.arange(6)[None] < depth[:, None], recent, -1)
    aux = (rng.random(rows) >= side).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, rows).astype(np.float32)
    return {
        "schema_version": np.asarray([2], np.int32),
        "board_shape": np.asarray([cfg.x_size, cfg.y_size, cfg.win_len], np.int32),
        "board": rng.integers(0, 3, (rows, Y, X)).astype(np.int8),
        "to_move": rng.integers(1, 3, rows).astype(np.int8),
        "recent_spots": recent.astype(np.int16),
        "recent_dirs": np.where(recent >= 0, rng.integers(0, 4, (rows, 6)), 4).astype(np.int8),
        "num_turns": rng.integers(0, 25, rows).astype(np.int16),
        "policy_target": probs(rows, A, sparse=zero_policy),
        "opponent_policy_target": probs(rows, A, sparse=zero_policy),
        "value_target": np.eye(3, dtype=np.float16)[rng.integers(0, 3, rows)],
        "td_value_targets": probs(rows, 3, 3),
        "ownership": (rng.integers(-1, 2, (rows, Y, X)) * aux[:, None, None]).astype(np.int8),
        "line_target": (rng.integers(0, cfg.win_len + 1, (rows, Y, X)) * aux[:, None, None]).astype(np.int8),
        "futurepos": rng.integers(-1, 2, (rows, 2, Y, X)).astype(np.int8),
        "var_time_left": (rng.integers(1, 20, rows) * aux).astype(np.float32),
        "shortterm_value": rng.uniform(-1, 1, rows).astype(np.float32),
        "weight": weight,
        "opponent_policy_weight": weight * (rng.random(rows) < 0.8),
        "aux_weight": aux,
    }


def write_shard(directory, rows: dict, name: str) -> str:
    """`rows` as `<directory>/<name>.npz`, as the writers store a shard."""
    import os

    os.makedirs(directory, exist_ok=True)
    path = os.path.join(str(directory), name + ".npz")
    np.savez_compressed(path, **rows)
    return path


def jax_exported_net(model_dir: str, dtype=jnp.float32):
    """(JAX CoffeeNet with its trunk in `dtype`, params) of an exported
    model, the params nested from model.npz by their keys: the tree JAX
    `load_exported_model` builds, without its initialisation of a template
    (about 11 s on one core)."""
    import dataclasses
    import json
    import os

    from katacoffee_tpu.nn.configs import get_model_spec
    from katacoffee_tpu.nn.model import CoffeeNet
    from katacoffee_tpu_torch.dataio.checkpoints import nest

    with open(os.path.join(model_dir, "model.json")) as f:
        meta = json.load(f)
    spec = dataclasses.replace(get_model_spec(meta["model"]), dtype=dtype)
    with np.load(os.path.join(model_dir, "model.npz")) as z:
        params = nest({k: jnp.asarray(z[k], jnp.float32) for k in z.files})
    return CoffeeNet(spec, win_len=meta["win_len"]), params
