"""One rank of tests/test_torch_parallel.py's two-process gloo world on the
CPU. It imports torch and the port only, never JAX.

Run: WORLD_SIZE=2 RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
     python tests/torch_parallel_worker.py IN_NPZ OUT_DIR

IN_NPZ holds `tc` (the TrainConfig's fields as JSON), `rows` (the steps'
global batches, stacked) and each step's global draws; the rank runs
`make_sharded_train_step` on its block of each batch from the tiny net's
parameters and writes `train_rank<r>.npz` (the flattened state after each
step and its metrics). Then it runs the selfplay daemon over the world at a
global B=8 into OUT_DIR/selfplay and writes `selfplay_rank<r>.json` (the
total it returned). `probe` is a function for `launch_local`.
"""

import json
import os
import sys

import numpy as np
import torch

from katacoffee_tpu_torch.command.selfplay import SelfplayConfig, run_selfplay_daemon
from katacoffee_tpu_torch.dataio import checkpoints as TC
from katacoffee_tpu_torch.dataio.trainingwrite import rows_to_batch
from katacoffee_tpu_torch.game.board import GameConfig
from katacoffee_tpu_torch.parallel import mesh
from katacoffee_tpu_torch.search.params import SearchParams
from katacoffee_tpu_torch.train.train import StepDraws, TrainConfig, init_train_state, make_sharded_train_step
from katacoffee_tpu_torch.utils.logger import Logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINYNET = os.path.join(REPO, "tests", "goldens", "tinynet")
CFG = GameConfig(5, 5, 4)


def probe(x: int) -> tuple[int, int, int]:
    """(rank, world size, x summed over the ranks)."""
    rank, size = mesh.world()
    return rank, size, int(mesh.all_reduce_sum(torch.tensor([x * (rank + 1)]))[0])


def train(inputs, rank: int, size: int, out_dir: str) -> None:
    tc = TrainConfig(**json.loads(str(inputs["tc"])))
    steps, rows_total = inputs["weight"].shape[:2]
    model = TC.load_exported_model(TINYNET, "cpu", dtype=torch.float32)[0].train()
    state = init_train_state(model)
    with torch.no_grad():
        mesh.broadcast_from_zero([*model.parameters(), *state.trace.values(), *state.ema.values()])
    step = make_sharded_train_step(CFG, tc, rows_total, size)
    out = {}
    for i in range(steps):
        block = {k: mesh.rank_rows(torch.from_numpy(inputs[k][i]), rank, size).numpy() for k in inputs.files
                 if k not in ("tc", "syms", "levels")}
        block.update(schema_version=np.asarray([2], np.int32), board_shape=np.asarray([5, 5, 4], np.int32))
        draws = StepDraws(torch.from_numpy(inputs["syms"][i]), torch.from_numpy(inputs["levels"][i]))
        state, metrics = step(state, rows_to_batch(block, CFG, "cpu"), draws=draws)
        for k, v in TC.flatten(TC.state_to_tree(state)).items():
            out[f"step{i}/{k}"] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
        for k, v in metrics.items():
            out[f"step{i}/metric/{k}"] = v.numpy()
    np.savez(os.path.join(out_dir, f"train_rank{rank}.npz"), **out)


def selfplay(rank: int, out_dir: str) -> None:
    spc = SelfplayConfig(batch_size=8, num_sims=6, moves_per_segment=26, max_segments=1, seed=0)
    rows = run_selfplay_daemon(os.path.join(out_dir, "selfplay"), CFG, SearchParams.for_selfplay(), spc, Logger(),
                               device="cpu")
    with open(os.path.join(out_dir, f"selfplay_rank{rank}.json"), "w") as f:
        json.dump({"rows": rows}, f)


def main() -> None:
    torch.set_num_threads(1)
    in_npz, out_dir = sys.argv[1:3]
    rank, size = mesh.init_distributed(device="cpu")
    try:
        with np.load(in_npz) as inputs:
            train(inputs, rank, size, out_dir)
        selfplay(rank, out_dir)
    finally:
        mesh.destroy_distributed()


if __name__ == "__main__":
    main()
