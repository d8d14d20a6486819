"""The trainer command: the port of `katacoffee_tpu/command/train.py`.

`python -m katacoffee_tpu_torch train -base-dir D -config configs/train.cfg`
streams the shuffled shards under `D/shuffleddata/` in the JAX package's
order for a seed (the same numpy `default_rng` stream), runs the train step
on one GPU, keeps the EMA weights, checkpoints `D/train/<run>/checkpoint.ckpt`
in the JAX package's format (a JAX checkpoint resumes with its momentum and
schedule), appends `metrics_train.json` / `metrics_val.json` lines with the
JAX keys, and exports the EMA weights to `D/modelstobetested/<run>-s<step>/`,
which selfplay's `find_latest_model` picks up. Only each batch is moved to
the device; the shard's rows are permuted on the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from katacoffee_tpu_torch.dataio.checkpoints import export_model, load_checkpoint, save_checkpoint
from katacoffee_tpu_torch.dataio.trainingwrite import _ROW_KEYS, iter_shards, read_npz_rows, rows_to_batch
from katacoffee_tpu_torch.device import resolve_device
from katacoffee_tpu_torch.game.board import GameConfig
from katacoffee_tpu_torch.nn.configs import get_model_spec
from katacoffee_tpu_torch.nn.model import CoffeeNet
from katacoffee_tpu_torch.parallel import mesh
from katacoffee_tpu_torch.train.losses import compute_losses
from katacoffee_tpu_torch.train.train import (
    TrainConfig,
    current_lr,
    init_train_state,
    make_sharded_train_step,
    make_train_step,
)
from katacoffee_tpu_torch.utils.config import ConfigParser
from katacoffee_tpu_torch.utils.logger import Logger


@dataclasses.dataclass
class TrainerConfig:
    model: str = "b6c96"
    batch_size: int = 256
    steps_per_export: int = 500
    checkpoint_every: int = 200
    max_steps: int | None = None
    max_epochs_per_data: int = 8  # the reference loop's <= 8 passes a row
    seed: int = 0
    # data-parallel over every visible GPU, one rank each, when the batch
    # divides over them (the torch-DDP/NCCL role)
    use_mesh: bool = True


def _batch_iterator(shuffled_dir: str, batch_size: int, rng: np.random.Generator, cfg: GameConfig,
                    device: torch.device, stride: int = 1, offset: int = 0):
    """Yield (epoch, TrainingBatch on `device`) of fixed-size batches from
    the shuffled shards, looping, with JAX command/train.py:52's draws:
    `rng.permutation` of the shards each epoch, then of each shard's rows.
    Yields (None, None) while there is no shard. Over several ranks
    (`stride` ranks, this one `offset`) every rank runs the same seeded
    iterator and takes every stride-th batch, disjoint rows a rank (the
    role of DistributedSampler in the reference's DDP loop)."""
    epoch = 0
    bi = 0
    while True:
        shards = list(iter_shards(shuffled_dir))
        if not shards:
            yield None, None
            continue
        for si in rng.permutation(len(shards)):
            data = read_npz_rows(shards[si])
            n = int(data["weight"].shape[0])
            perm = rng.permutation(n)
            rows = {k: data[k][perm] for k in _ROW_KEYS}
            for start in range(0, n - batch_size + 1, batch_size):
                if bi % stride == offset:
                    yield epoch, rows_to_batch({k: v[start: start + batch_size] for k, v in rows.items()}, cfg,
                                               device)
                bi += 1
        epoch += 1


def _new_state(trc: TrainerConfig, win_len: int, dev: torch.device, ckpt_path: str, logger: Logger, what: str):
    """A fresh state from `trc.seed`, or the checkpoint's; and the global
    step it starts at."""
    model = CoffeeNet(get_model_spec(trc.model), win_len=win_len).to(dev)
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(trc.seed))
    start_step = 0
    if os.path.exists(ckpt_path):
        state, meta = load_checkpoint(ckpt_path, state)
        start_step = int(meta.get("train_step", state.step))
        logger.write(f"{what}: resumed from step {start_step}")
    return state, start_step


def run_training_mixed(
    base_dir: str,
    cfgs: list,
    tc: TrainConfig,
    trc: TrainerConfig,
    logger: Logger | None = None,
    export_to: str = "modelstobetested",
    run_name: str = "run",
    device: str | torch.device | None = None,
) -> int:
    """One net trained on several board sizes (JAX command/train.py:87):
    steps alternate over the per-size shuffle dirs
    `shuffleddata/<X>x<Y>w<W>/`, each size drawn in proportion to its rows;
    the line head is sized for the largest win_len. Shares the checkpoint
    format with `run_training`. Returns the steps done."""
    dev = resolve_device(device)
    logger = logger or Logger(log_to_stdout=True)
    shuffled_base = os.path.join(base_dir, "shuffleddata")
    train_dir = os.path.join(base_dir, "train", run_name)
    os.makedirs(train_dir, exist_ok=True)
    ckpt_path = os.path.join(train_dir, "checkpoint.ckpt")

    tags = [f"{c.x_size}x{c.y_size}w{c.win_len}" for c in cfgs]
    dirs = [os.path.join(shuffled_base, t) for t in tags]
    rows = []
    for d in dirs:
        n = 0
        if os.path.isdir(d):
            for s in iter_shards(d):
                with np.load(s) as z:
                    n += int(z["weight"].shape[0])
        rows.append(n)
    if not any(rows):
        raise FileNotFoundError(f"no shuffled data under {shuffled_base}/{tags}")

    max_wl = max(c.win_len for c in cfgs)
    # the exported meta carries the head-sizing win_len
    export_cfg = GameConfig(cfgs[0].x_size, cfgs[0].y_size, max_wl)
    state, start_step = _new_state(trc, max_wl, dev, ckpt_path, logger, "train-mixed")
    step_fns = [make_train_step(c, tc, trc.batch_size) for c in cfgs]
    rng = np.random.default_rng(trc.seed + start_step)
    iters = [_batch_iterator(d, trc.batch_size, np.random.default_rng(trc.seed + 7 * i), c, dev)
             for i, (d, c) in enumerate(zip(dirs, cfgs))]
    probs = np.asarray(rows, np.float64)
    probs = probs / probs.sum()
    generator = torch.Generator(device=dev).manual_seed(trc.seed + 1)

    steps = 0
    logger.write("train-mixed: sizes " + ", ".join(f"{t}:{r} rows" for t, r in zip(tags, rows)))
    with open(os.path.join(train_dir, "metrics_train.json"), "a") as mfile:
        while trc.max_steps is None or steps < trc.max_steps:
            i = int(rng.choice(len(cfgs), p=probs))
            epoch, batch = next(iters[i])
            if batch is None:
                continue
            if epoch >= trc.max_epochs_per_data:
                break
            state, metrics = step_fns[i](state, batch, generator)
            steps += 1
            gstep = start_step + steps
            if steps % 50 == 0 or steps == 1:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=gstep, size=tags[i], time=time.time())
                mfile.write(json.dumps(m) + "\n")
                mfile.flush()
                logger.write(f"train-mixed: step {gstep} [{tags[i]}] loss {m['loss']:.4f}")
            if steps % trc.checkpoint_every == 0:
                save_checkpoint(ckpt_path, state, extra={"train_step": gstep})
            if steps % trc.steps_per_export == 0:
                _export(base_dir, export_to, run_name, gstep, state, trc, export_cfg, logger)

    save_checkpoint(ckpt_path, state, extra={"train_step": start_step + steps})
    _export(base_dir, export_to, run_name, start_step + steps, state, trc, export_cfg, logger)
    return steps


def run_training(
    base_dir: str,
    cfg: GameConfig,
    tc: TrainConfig,
    trc: TrainerConfig,
    logger: Logger | None = None,
    export_to: str = "modelstobetested",
    run_name: str = "run",
    device: str | torch.device | None = None,
) -> int:
    """Train until max_steps (or until every row was seen
    max_epochs_per_data times) on `device` (default `cuda`), resuming from
    the run's checkpoint if there is one (JAX command/train.py:193).
    Returns the steps done in this call.

    Data-parallel (JAX :224-300): started outside a launcher where the JAX
    package shards the batch (use_mesh, several visible GPUs, the batch
    divisible by their number), it runs itself on one rank a GPU through
    `launch_local`. In a process group (torchrun, or those ranks) every
    rank reads the resume, takes rank 0's state, and trains on
    batch_size/world rows of its own, every world-th batch of the seeded
    iterator, with `make_sharded_train_step`; the ranks agree each step
    whether to step, wait for data or stop (one small all-reduce); rank 0
    alone writes metrics, checkpoints, validation and exports."""
    dev = resolve_device(device)
    logger = logger or Logger(log_to_stdout=True)
    n = mesh.local_world_size(dev, trc.use_mesh, trc.batch_size)
    if n > 1:
        logger.write(f"train: data-parallel over {n} GPUs, one rank each")
        return mesh.launch_local(run_training, n, base_dir, cfg, tc, trc, logger, export_to, run_name, str(dev))[0]
    rank, world = mesh.world()
    dev = mesh.rank_device(dev)
    if trc.batch_size % world:
        raise ValueError(f"batchSize {trc.batch_size} does not divide over {world} ranks")
    is_writer = rank == 0
    shuffled_dir = os.path.join(base_dir, "shuffleddata")
    train_dir = os.path.join(base_dir, "train", run_name)
    os.makedirs(train_dir, exist_ok=True)
    metrics_val_path = os.path.join(train_dir, "metrics_val.json")
    val_dir = os.path.join(shuffled_dir, "val")
    ckpt_path = os.path.join(train_dir, "checkpoint.ckpt")

    state, start_step = _new_state(trc, cfg.win_len, dev, ckpt_path, logger, "train")
    if world > 1:
        with torch.no_grad():
            mesh.broadcast_from_zero([*state.model.parameters(), *state.trace.values(), *state.ema.values()])
        step_fn = make_sharded_train_step(cfg, tc, trc.batch_size, world)
        logger.write(f"train: rank {rank} of {world} on {dev}, {trc.batch_size // world} rows a step")
    else:
        step_fn = make_train_step(cfg, tc, trc.batch_size)
    rng = np.random.default_rng(trc.seed + start_step)
    generator = torch.Generator(device=dev).manual_seed(mesh.rank_seed(trc.seed + 1, rank, world))
    batches = _batch_iterator(shuffled_dir, trc.batch_size // world, rng, cfg, dev, stride=world, offset=rank)

    steps = 0
    t0 = time.monotonic()
    mfile = open(os.path.join(train_dir, "metrics_train.json"), "a") if is_writer else None
    try:
        while trc.max_steps is None or steps < trc.max_steps:
            epoch, batch = next(batches)
            wait = batch is None
            stop = not wait and epoch >= trc.max_epochs_per_data
            if world > 1:
                wait, stop = (mesh.all_reduce_sum(torch.tensor([wait, stop], dtype=torch.int32, device=dev))
                              > 0).tolist()
            if stop:
                break
            if wait:
                logger.write("train: no shuffled data yet, waiting")
                time.sleep(5)
                continue
            state, metrics = step_fn(state, batch, generator)
            steps += 1
            gstep = start_step + steps
            if not is_writer:
                continue
            if steps % 50 == 0 or steps == 1:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=gstep, epoch=epoch, time=time.time(), p_lr=current_lr(tc, trc.batch_size, gstep))
                mfile.write(json.dumps(m) + "\n")
                mfile.flush()
                logger.write(
                    f"train: step {gstep} loss {m['loss']:.4f} p {m['loss_policy']:.4f} v {m['loss_value']:.4f} "
                    f"({steps / max(time.monotonic() - t0, 1e-9):.2f} steps/s)")
            if steps % trc.checkpoint_every == 0:
                save_checkpoint(ckpt_path, state, extra={"train_step": gstep})
                _val_metrics(cfg, state, val_dir, metrics_val_path, gstep, logger)
            if steps % trc.steps_per_export == 0:
                _export(base_dir, export_to, run_name, gstep, state, trc, cfg, logger)
    finally:
        if mfile is not None:
            mfile.close()

    if is_writer:
        save_checkpoint(ckpt_path, state, extra={"train_step": start_step + steps})
        _val_metrics(cfg, state, val_dir, metrics_val_path, start_step + steps, logger)
        _export(base_dir, export_to, run_name, start_step + steps, state, trc, cfg, logger)
    return steps


def weighted_loss_metrics(cfg: GameConfig, model, shard_paths, device: torch.device,
                          max_rows: int) -> tuple[dict[str, float], float, int]:
    """(weight_sum-weighted sums of the loss metrics, weight sum, rows) of
    whole shards through `model`, without augmentation, until `max_rows`
    rows are in."""
    totals: dict[str, float] = {}
    wsum = 0.0
    rows = 0
    for s in shard_paths:
        batch = rows_to_batch(read_npz_rows(s), cfg, device)
        n = int(batch.weight.shape[0])
        if n == 0:
            continue
        with torch.no_grad():
            m = compute_losses(cfg, model, batch)[1]
        w = float(m["weight_sum"])
        for k, v in m.items():
            totals[k] = totals.get(k, 0.0) + float(v) * (w if k != "weight_sum" else 1.0)
        wsum += w
        rows += n
        if rows >= max_rows:
            break
    return totals, wsum, rows


def _val_metrics(cfg, state, val_dir, metrics_val_path, gstep, logger, max_rows: int = 4096):
    """The current (not EMA) parameters on the held-out shuffle split, one
    JSON line (JAX command/train.py:302)."""
    if not os.path.isdir(val_dir):
        return
    shards = list(iter_shards(val_dir))
    if not shards:
        return
    dev = next(state.model.parameters()).device
    totals, wsum, rows = weighted_loss_metrics(cfg, state.model, shards, dev, max_rows)
    if wsum <= 0:
        return
    out = {k: (v / wsum if k != "weight_sum" else v) for k, v in totals.items()}
    out.update(step=gstep, rows=rows, time=time.time())
    with open(metrics_val_path, "a") as f:
        f.write(json.dumps(out) + "\n")
    logger.write(f"train: val loss {out['loss']:.4f} on {rows} rows")


def _export(base_dir, export_to, run_name, gstep, state, trc, cfg, logger):
    """Export the EMA weights, which are what ships (JAX command/train.py:339)."""
    out = export_model(os.path.join(base_dir, export_to), f"{run_name}-s{gstep}", state.ema, trc.model, cfg,
                       extra={"train_step": gstep})
    logger.write(f"train: exported {out}")
    return out


def main(argv, *, device: str | torch.device | None = None) -> None:
    """Entry for `python -m katacoffee_tpu_torch train` (JAX
    command/train.py:353): the same flags and config keys, on `device`
    (default `cuda`). Under torchrun (`--nproc-per-node N`) each process
    joins the group as one rank of the data-parallel trainer."""
    dev = resolve_device(device)
    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch train")
    ap.add_argument("-base-dir", required=True)
    ap.add_argument("-config", default=None)
    ap.add_argument("-override-config", default=None)
    args = ap.parse_args(argv)
    c = ConfigParser(args.config, overrides=args.override_config) if args.config else ConfigParser(text="")
    if args.override_config and not args.config:
        c.apply_overrides(args.override_config)

    cfg = GameConfig(c.get_int("xSize", 5), c.get_int("ySize", 5), c.get_int("winLen", 4))
    tc = TrainConfig(
        learning_rate=c.get_float("learningRate", 0.02),
        lr_schedule=c.get_string("lrSchedule", "stepwise"),
        warmup_samples_scale=c.get_float("warmupSamplesScale", 1.0),
        output_head_lr_scale=c.get_float("outputHeadLrScale", 0.5),
    )
    trc = TrainerConfig(
        model=c.get_string("model", "b6c96"),
        batch_size=c.get_int("batchSize", 256),
        max_steps=c.get_int("maxSteps", 0) or None,
        steps_per_export=c.get_int("stepsPerExport", 500),
        seed=c.get_int("seed", 0),
    )
    logger = Logger(log_to_stdout=True)
    c.warn_unused(logger)
    mesh.init_distributed(device=dev)
    try:
        run_training(args.base_dir, cfg, tc, trc, logger, device=dev)
    finally:
        mesh.destroy_distributed()
