#!/usr/bin/env python3
"""Several GPUs on one host: the port's data parallelism over NCCL, from the
root of the repository on a machine with N >= 2 GPUs:

    python3 tools/multi_gpu_check.py

Prints, each line with the seconds since start:
  * the cards (nvidia-smi) and how many are visible;
  * `python -m katacoffee_tpu_torch selfplay` with configs/selfplay.cfg at
    B=256, 8 visits, 2 segments of 16 moves in a subprocess: the command
    spawns one rank a GPU by itself (`launch_local`); its shards read back
    (chip_smoke.read_daemon_rows), its SGFs replayed, named by every rank;
  * chip_smoke.phase_ranks over the N GPUs (NCCL) on those rows shuffled:
    10 float32 b6c96 steps at a global B=256 against one process's (within
    chip_smoke.RANKS_TOL, the ranks bit-equal), the daemon at a global B=64;
  * `python -m katacoffee_tpu_torch train` with configs/train.cfg for 10
    steps from the flagship checkpoint, spawned by the command itself and
    under `torchrun --standalone --nproc-per-node N`: the checkpoint's
    train_step and the export;
then one JSON line. It exits non-zero at the first failure.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch

import chip_smoke as c


def run(argv, timeout=600):
    t = time.monotonic()
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=timeout)
    c.log(f"{' '.join(argv[:8])} ...: exit {proc.returncode} in {time.monotonic() - t:.1f} s")
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-6000:])
        raise SystemExit(1)
    return proc.stdout


if __name__ == "__main__":
    from katacoffee_tpu_torch import cli
    from katacoffee_tpu_torch.dataio.checkpoints import read_raw
    from katacoffee_tpu_torch.game.board import GameConfig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n = torch.cuda.device_count()
    c.log(f"{c.card_line()}; {n} GPUs visible: {[torch.cuda.get_device_name(i) for i in range(n)]}")
    dev = torch.device("cuda")
    cfg = GameConfig(5, 5, 4)
    work = tempfile.mkdtemp(prefix="multi_")
    py = sys.executable
    try:
        # the selfplay command spawns one rank a GPU by itself
        sp = os.path.join(work, "sp")
        os.makedirs(os.path.join(sp, "models"))
        os.symlink(os.path.abspath(c.MODEL_DIR), os.path.join(sp, "models", "run-s5200"))
        printed = run([py, "-m", "katacoffee_tpu_torch", "selfplay", "-output-dir", sp, "-config", c.SELFPLAY_CFG,
                       "-override-config", "numParallelGames=256,maxVisits=8,movesPerSegment=16,maxSegments=2"])
        out = os.path.join(sp, "selfplay", "run-s5200")
        got, sgfs = c.read_daemon_rows(cfg, sp, "run-s5200", dev)
        rows, games = got["weight"].shape[0], c.replay_sgfs(cfg, sgfs, dev)
        ranks_named = sorted({os.path.basename(x).split("_")[1] for x in sgfs})
        c.log(f"selfplay command: {rows} rows in {len(os.listdir(os.path.join(out, 'tdata')))} shards, {games} SGFs "
              f"replayed, named by {ranks_named}; " + " | ".join(
                  line for line in printed.splitlines() if "GPUs" in line or "seg 2" in line))
        assert ranks_named == [f"rank{r}" for r in range(n)], ranks_named
        shuffled = os.path.join(work, "tr", "shuffleddata")
        cli.main(["shuffle", os.path.join(out, "tdata"), "-out-dir", shuffled, "-min-rows", "1000", "-seed", "0"])

        # phase_ranks over every GPU (NCCL) against one process
        ranks_dir = os.path.join(work, "ranks")
        os.makedirs(os.path.join(ranks_dir, "models"))
        os.symlink(os.path.abspath(c.MODEL_DIR), os.path.join(ranks_dir, "models", "run-s5200"))
        ranks = c.phase_ranks(dev, cfg, ranks_dir, shuffled, n, label=f"{n} ranks")

        # the train command spawns one rank a GPU by itself; then under torchrun
        for how in ("spawned", "torchrun"):
            base = os.path.join(work, how)
            os.makedirs(os.path.join(base, "train", "run"))
            shutil.copy(c.FLAGSHIP_CKPT, os.path.join(base, "train", "run"))
            shutil.copytree(shuffled, os.path.join(base, "shuffleddata"))
            args = ["-m", "katacoffee_tpu_torch", "train", "-base-dir", base, "-config", c.TRAIN_CFG,
                    "-override-config", "maxSteps=10,stepsPerExport=10"]
            pre = [py] if how == "spawned" else [py, "-m", "torch.distributed.run", "--standalone",
                                                  f"--nproc-per-node={n}"]
            printed = run(pre + args)
            meta = read_raw(os.path.join(base, "train", "run", "checkpoint.ckpt"))[0]
            exports = os.listdir(os.path.join(base, "modelstobetested"))
            c.log(f"train command, {how}: checkpoint train_step {meta['train_step']}, exports {exports}; " + " | ".join(
                line for line in printed.splitlines() if "GPUs" in line or "rank" in line)[:600])
            assert meta["train_step"] == 5210 and exports == ["run-s5210"], (meta, exports)
        print(json.dumps({"multi_gpu": {"gpus": n, "selfplay_rows": rows, "selfplay_sgfs": games, "ranks": ranks}}))
    finally:
        shutil.rmtree(work, ignore_errors=True)
