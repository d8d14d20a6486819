"""The port's several-GPU layer (`katacoffee_tpu_torch/parallel/mesh.py`, the
sharded train step, the daemon and the trainer over ranks) against the JAX
package's mesh, on the CPU.

- A real two-process gloo world (`tests/torch_parallel_worker.py`, torch
  and the port only): the ranks run `make_sharded_train_step` on the tiny
  net (float32) for two steps, each rank on its block of a global batch of
  32 rows whose halves have different weight sums, with the JAX key's
  draws for the global batch; JAX `make_sharded_train_step` over
  `make_data_mesh(2)` of the virtual CPU mesh runs the same steps here.
  Parameters, trace, EMA, count, grad_norm and every metric agree within
  |d| <= 1e-5 * max(|x|, 1) a leaf (tests/test_torch_train_step.py's
  bound), and the two ranks' states and metrics are bit-equal. Then the
  same world runs the selfplay daemon at B=8 (4 games a rank), 6 visits:
  both ranks return the row total of the shards on disk, the SGF names are
  distinct, and JAX's reader reads every shard.
- `launch_local` spawns a world of two ranks on this host.
- `_batch_iterator(stride=2, offset=r)` gives rank r JAX's rows.
- A B=8 search equals the searches of its two halves of 4 (JAX
  `test_sharded_search_matches_single_device`'s contract): no coupling
  between games.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from katacoffee_tpu.command import train as JCT
from katacoffee_tpu.dataio import trainingwrite as JW
from katacoffee_tpu.game.board import GameConfig
from katacoffee_tpu.nn import features as JF
from katacoffee_tpu.parallel import make_data_mesh
from katacoffee_tpu.train import train as JT
from katacoffee_tpu_torch.command import train as TCT
from katacoffee_tpu_torch.dataio import checkpoints as TC
from katacoffee_tpu_torch.dataio import trainingwrite as TW
from katacoffee_tpu_torch.game import board as TB
from katacoffee_tpu_torch.parallel import mesh
from katacoffee_tpu_torch.search import mcts as TM
from katacoffee_tpu_torch.search.params import SearchParams
from torch_parity import jax_exported_net, one_torch_thread, training_rows, write_shard  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINYNET = os.path.join(ROOT, "tests", "goldens", "tinynet")
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
CFG = GameConfig(5, 5, 4)
TCFG = TB.GameConfig(5, 5, 4)
ROWS = 32
STEPS = 2
TOL = 1e-5
TC_KW = dict(grad_clip=1.0, warmup_samples_scale=ROWS * 1.5 / 1e6, history_keep_prob=0.7, learning_rate=0.05)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def close(want, got, what):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert want.shape == got.shape, what
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    err = float(np.abs(want - got).max(initial=0.0))
    assert err <= TOL * scale, f"{what}: |d| {err} > {TOL} * {scale}"


def step_rows(i: int) -> dict:
    """Step i's global batch: its second half weighs three times its first,
    so the halves' weight sums differ."""
    rows = training_rows(CFG, ROWS, seed=40 + i)
    for k in ("weight", "opponent_policy_weight"):
        rows[k][ROWS // 2:] *= 3.0
    return rows


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two workers' outputs, and the keys their draws came from."""
    tmp = tmp_path_factory.mktemp("world")
    batches = [step_rows(i) for i in range(STEPS)]
    keys = [jax.random.PRNGKey(200 + i) for i in range(STEPS)]
    inputs = {k: np.stack([b[k] for b in batches]) for k in TW._ROW_KEYS}
    inputs["syms"] = np.stack([np.asarray(jax.random.randint(k, (ROWS,), 0, 8)) for k in keys])
    inputs["levels"] = np.stack([np.asarray(JF.sample_history_levels(jax.random.fold_in(k, 0x415), ROWS,
                                                                      TC_KW["history_keep_prob"])) for k in keys])
    inputs["tc"] = np.asarray(json.dumps(TC_KW))
    np.savez(tmp / "inputs.npz", **inputs)
    os.makedirs(tmp / "selfplay" / "models")
    os.symlink(TINYNET, tmp / "selfplay" / "models" / "tinynet")

    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(tmp / "inputs.npz"), str(tmp)], cwd=ROOT,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("the torch ranks timed out:\n" + "\n".join(logs))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return tmp, batches, keys


def test_sharded_step_matches_jax_and_ranks_are_bit_equal(world):
    tmp, batches, keys = world
    got = [dict(np.load(tmp / f"train_rank{r}.npz")) for r in range(2)]
    assert got[0].keys() == got[1].keys()
    for k in got[0]:
        assert np.array_equal(got[0][k], got[1][k]), k

    jmodel, params = jax_exported_net(TINYNET)
    jtc = JT.TrainConfig(**TC_KW)
    opt = JT.make_optimizer(jtc, ROWS)
    jstate = JT.TrainState(params, opt.init(params), jax.tree_util.tree_map(lambda x: x.copy(), params),
                           jax.numpy.zeros((), jax.numpy.int32))
    step_fn, shard_batch, place_state = JT.make_sharded_train_step(jmodel, CFG, jtc, ROWS, make_data_mesh(2))
    jstate = place_state(jstate)
    clipped = 0
    for i, (rows, key) in enumerate(zip(batches, keys)):
        jstate, metrics = step_fn(jstate, shard_batch(JW.rows_to_batch(rows, CFG)), key)
        want = TC.flatten(jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(jstate)))
        mine = {k[len(f"step{i}/"):]: v for k, v in got[0].items() if k.startswith(f"step{i}/")}
        assert {k for k in mine if not k.startswith("metric/")} == set(want)
        for k, v in want.items():
            close(v, mine[k], f"step {i} {k}")
        assert {k[len("metric/"):] for k in mine if k.startswith("metric/")} == set(metrics)
        for k, v in metrics.items():
            close(v, mine[f"metric/{k}"], f"step {i} metric {k}")
        clipped += float(metrics["grad_norm"]) >= jtc.grad_clip
    assert clipped >= 1
    halves = [batches[0]["weight"][:ROWS // 2].sum(), batches[0]["weight"][ROWS // 2:].sum()]
    assert halves[1] > 2 * halves[0]


def test_daemon_over_two_ranks_sums_rows_and_names_sgfs_apart(world):
    tmp = world[0]
    totals = [json.load(open(tmp / f"selfplay_rank{r}.json"))["rows"] for r in range(2)]
    out = tmp / "selfplay" / "selfplay" / "tinynet"
    shards = list(JW.iter_shards(str(out / "tdata")))
    on_disk = 0
    for path in shards:
        data = JW.read_npz_rows(path)
        batch = JW.rows_to_batch(data, CFG)
        assert batch.policy_target.shape == (data["weight"].shape[0], CFG.policy_size)
        on_disk += data["weight"].shape[0]
    assert totals[0] == totals[1] == on_disk > 0 and len(shards) == 2
    sgfs = sorted(os.listdir(out / "sgfs"))
    assert sgfs and len(set(sgfs)) == len(sgfs)
    assert {n.split("_")[1] for n in sgfs} == {"rank0", "rank1"}


def test_launch_local_runs_a_world_of_two():
    sys.path.insert(0, os.path.dirname(WORKER))
    import torch_parallel_worker

    assert mesh.launch_local(torch_parallel_worker.probe, 2, 5, device="cpu") == [(0, 2, 15), (1, 2, 15)]


def test_batch_iterator_strides_as_jax(tmp_path):
    for i, n in enumerate((45, 30, 61)):
        write_shard(tmp_path, training_rows(CFG, n, seed=60 + i), f"shard{i}")
    for r in range(2):
        want = JCT._batch_iterator(str(tmp_path), 8, np.random.default_rng(5), stride=2, offset=r)
        got = TCT._batch_iterator(str(tmp_path), 8, np.random.default_rng(5), TCFG, torch.device("cpu"), stride=2,
                                  offset=r)
        for _ in range(20):  # across the first epoch's end (16 batches of 8)
            (we, wb), (ge, gb) = next(want), next(got)
            assert we == ge
            assert np.array_equal(np.asarray(wb.weight), gb.weight.numpy())
            assert np.array_equal(np.asarray(wb.states.board), gb.states.board.numpy())
            assert np.array_equal(np.asarray(wb.policy_target), gb.policy_target.numpy())


def test_search_of_a_batch_equals_the_searches_of_its_halves():
    model = TC.load_exported_model(TINYNET, "cpu", dtype=torch.float32)[0]
    sp = SearchParams(valueWeightExponent=0.0, useGraphSearch=False)
    ev = TM.make_nn_eval_fn(TCFG, model)
    states = TB.init_state(TCFG, 8, "cpu")
    # distinct roots: each game one move in
    legal = TB.legal_mask_flat(TCFG, states)[0].nonzero()[:, 0]
    states = TB.step(TCFG, states, legal[torch.arange(8) * 9])
    whole = TM.run_search(TCFG, sp, ev, states, 20, device="cpu").edge_visits
    halves = torch.cat([TM.run_search(TCFG, sp, ev, states.map(lambda x: x[h * 4:(h + 1) * 4]), 20,
                                      device="cpu").edge_visits for h in range(2)])
    assert torch.equal(whole, halves)
