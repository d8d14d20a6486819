"""Kill and resume of the port's selfplay daemon and trainer, JAX
tests/test_loop_faults.py's two contracts with the port's entry points: each
runs as a real subprocess on the CPU, in a process group of its own, that
imports only `katacoffee_tpu_torch`, and is ended by SIGKILL to the group.

  * the daemon (`command/selfplay.py` `run_selfplay_daemon`, small shards
    through `max_rows_per_file`, so that a kill can land while a shard is
    written): every visible shard loads whole, its row keys of one length;
    a leftover `.junk.npz.tmp` is invisible to the port's `iter_shards` and
    to JAX's; a second daemon adds shards to the same tree; the port's
    `shuffle_data` over the combined tree gives at least the rows seen
    before the kill, and JAX's `shuffle_data` gives as many over the same
    directory (the format both read);
  * the trainer (`command/train.py` `run_training`, a checkpoint every 5
    steps): killed after `checkpoint.ckpt.prev` exists, at a moment when
    both generations are on disk (the group is stopped, the files looked
    at, then killed); both load with the port's `load_checkpoint` and with
    JAX's (the port writes the JAX format), five steps apart; a bounded
    rerun resumes from the persisted step and ends at `step_at_kill + 5`.
"""

import functools
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np

from katacoffee_tpu.dataio.checkpoints import load_checkpoint as jax_load_checkpoint
from katacoffee_tpu.dataio.shuffle import shuffle_data as jax_shuffle_data
from katacoffee_tpu.dataio.trainingwrite import iter_shards as jax_iter_shards
from katacoffee_tpu.game.board import GameConfig as JCfg
from katacoffee_tpu.nn.configs import get_model_spec as jax_model_spec
from katacoffee_tpu.nn.model import CoffeeNet as JaxNet
from katacoffee_tpu.train import TrainConfig as JaxTrainConfig
from katacoffee_tpu.train import init_train_state as jax_init_train_state
from katacoffee_tpu_torch.command.selfplay import SelfplayConfig, run_selfplay_daemon
from katacoffee_tpu_torch.dataio.checkpoints import load_checkpoint
from katacoffee_tpu_torch.dataio.shuffle import shuffle_data
from katacoffee_tpu_torch.dataio.trainingwrite import iter_shards
from katacoffee_tpu_torch.game.board import GameConfig
from katacoffee_tpu_torch.nn.configs import get_model_spec
from katacoffee_tpu_torch.nn.model import CoffeeNet
from katacoffee_tpu_torch.search.params import SearchParams
from katacoffee_tpu_torch.train.train import init_train_state
from katacoffee_tpu_torch.utils.logger import Logger
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META_KEYS = {"schema_version", "board_shape"}  # one a file, not one a row

SELFPLAY_CODE = """
import sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from katacoffee_tpu_torch.command.selfplay import SelfplayConfig, run_selfplay_daemon
from katacoffee_tpu_torch.game.board import GameConfig
from katacoffee_tpu_torch.search.params import SearchParams
from katacoffee_tpu_torch.utils.logger import Logger

spc = SelfplayConfig(batch_size=8, num_sims=8, moves_per_segment=8, segments_per_flush=1, max_segments=1000,
                     max_rows_per_file=24, seed={seed})
run_selfplay_daemon({base!r}, GameConfig(5, 5, 4), SearchParams.for_selfplay(), spc, Logger(), device="cpu")
"""

TRAIN_CODE = """
import sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from katacoffee_tpu_torch.command.train import TrainerConfig, run_training
from katacoffee_tpu_torch.game.board import GameConfig
from katacoffee_tpu_torch.train.train import TrainConfig
from katacoffee_tpu_torch.utils.logger import Logger

tc = TrainConfig(warmup_steps=2, symmetry_augment=False)
trc = TrainerConfig(model="b1c6", batch_size=16, max_steps={steps}, steps_per_export=10**9, checkpoint_every=5,
                    max_epochs_per_data=10**9, seed=0)
run_training({base!r}, GameConfig(5, 5, 4), tc, trc, Logger(log_to_stdout=True), device="cpu")
print("TRAIN_DONE")
"""


def _spawn(code: str):
    # setsid in the child: a process group of its own, so the kill cannot
    # reach the test (os.setsid as a preexec_fn would fork the test process,
    # which runs JAX's threads)
    return subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)


def _kill(proc) -> None:
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait(timeout=60)


def _wait_for(proc, cond, desc, timeout=300, poll=0.1):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return
        if proc.poll() is not None:
            raise AssertionError(f"the process ended before {desc}: {proc.stdout.read()[-3000:]}")
        time.sleep(poll)
    raise TimeoutError(f"timed out waiting for {desc}")


def _rows(shard) -> int:
    """The shard's row count; every row key of one length."""
    with np.load(shard) as z:
        lengths = {k: z[k].shape[0] for k in z.files if k not in META_KEYS}
    assert len(set(lengths.values())) == 1, f"ragged shard {shard}: {lengths}"
    return next(iter(lengths.values()))


def test_selfplay_daemon_sigkill_leaves_no_partial_shards(tmp_path):
    base = str(tmp_path)
    tdata = os.path.join(base, "selfplay", "random", "tdata")

    proc = _spawn(SELFPLAY_CODE.format(repo=REPO, base=base, seed=1))
    try:
        # the first shards, then SIGKILL to the group mid-run (no signal
        # handler runs, nothing is flushed)
        _wait_for(proc, lambda: os.path.isdir(tdata) and len(list(iter_shards(tdata))) >= 2, "the first shards")
    finally:
        _kill(proc)

    shards = list(iter_shards(tdata))
    assert shards and list(jax_iter_shards(tdata)) == shards
    total_rows = sum(_rows(s) for s in shards)
    assert total_rows > 0

    # a temp file left by a kill mid-write is invisible to both readers
    junk = os.path.join(tdata, ".junk.npz.tmp")
    with open(junk, "wb") as f:
        f.write(b"half a shard")
    assert junk not in list(iter_shards(tdata)) and junk not in list(jax_iter_shards(tdata))

    # a fresh daemon writes into the same tree
    proc2 = _spawn(SELFPLAY_CODE.format(repo=REPO, base=base, seed=2))
    try:
        _wait_for(proc2, lambda: len(list(iter_shards(tdata))) > len(shards), "a shard after the resume")
    finally:
        _kill(proc2)

    combined = list(iter_shards(tdata))
    assert set(shards) < set(combined) and list(jax_iter_shards(tdata)) == combined
    rows = sum(_rows(s) for s in combined)
    stats = shuffle_data([tdata], os.path.join(base, "shuffleddata"), min_rows=10**9, seed=0)
    assert stats["rows_out"] >= total_rows
    jstats = jax_shuffle_data([tdata], os.path.join(base, "shuffleddata_jax"), min_rows=10**9, seed=0)
    assert jstats["rows_out"] == stats["rows_out"] == rows


@functools.lru_cache(maxsize=None)
def _jax_template():
    """JAX's TrainState structure for b1c6, its leaves shapes only (traced,
    not compiled): all that JAX's `load_checkpoint` reads of a template."""
    jtc = JaxTrainConfig(warmup_steps=2, symmetry_augment=False)
    return jax.eval_shape(lambda: jax_init_train_state(JaxNet(jax_model_spec("b1c6"), win_len=4), JCfg(5, 5, 4), jtc,
                                                       batch_size=16, rng=jax.random.PRNGKey(0)))


def _load_both(path):
    """(train_step, step, count) of a checkpoint through the port's
    `load_checkpoint` and through JAX's, which must agree."""
    state, meta = load_checkpoint(path, init_train_state(CoffeeNet(get_model_spec("b1c6"), win_len=4)))
    jstate, jmeta = jax_load_checkpoint(path, _jax_template())
    assert jmeta == meta
    assert int(jstate.step) == state.step
    return int(meta["train_step"]), state.step, state.count


def test_trainer_sigkill_resumes_from_rotating_checkpoint(tmp_path):
    base = str(tmp_path)
    spc = SelfplayConfig(batch_size=8, num_sims=8, moves_per_segment=30, max_segments=2, seed=0)
    run_selfplay_daemon(base, GameConfig(5, 5, 4), SearchParams.for_selfplay(), spc, Logger(), device="cpu")
    shuffle_data([os.path.join(base, "selfplay", "random", "tdata")], os.path.join(base, "shuffleddata"),
                 min_rows=10**9, seed=0)
    ckpt = os.path.join(base, "train", "run", "checkpoint.ckpt")

    proc = _spawn(TRAIN_CODE.format(repo=REPO, base=base, steps=10_000))
    try:
        _wait_for(proc, lambda: os.path.exists(ckpt + ".prev"), "a rotation")
        # stop the group where both generations are on disk (a kill between
        # save_checkpoint's two renames leaves only .prev, in JAX as here)
        while True:
            os.killpg(proc.pid, signal.SIGSTOP)
            if os.path.exists(ckpt) and os.path.exists(ckpt + ".prev"):
                break
            os.killpg(proc.pid, signal.SIGCONT)
            time.sleep(0.01)
    finally:
        _kill(proc)

    step_at_kill, step, count = _load_both(ckpt)
    assert step_at_kill >= 10 and step_at_kill % 5 == 0 and step == count == step_at_kill
    assert _load_both(ckpt + ".prev")[0] == step_at_kill - 5

    # a bounded run continues from the persisted step, five more
    out = subprocess.run([sys.executable, "-c", TRAIN_CODE.format(repo=REPO, base=base, steps=5)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert "TRAIN_DONE" in out.stdout, out.stdout[-2000:] + out.stderr[-2000:]
    assert f"resumed from step {step_at_kill}" in out.stdout
    assert _load_both(ckpt)[0] == step_at_kill + 5
