"""Fused interior descent: one CUDA launch walks every game from the node
after the root level down to its leaf.

The port of the interior levels of `_simulate_once` (the while_loop `body`
at `katacoffee_tpu/search/mcts.py:1267`, with graph search's edge-visit
catch-up) together with the child-stats gather they run per level (the
Pallas kernel `_gather_kernel`, `katacoffee_tpu/ops/gather.py:39`). The plain version is
`katacoffee_tpu_torch.search.mcts._descend_interior_plain`, and
`mcts._descend_interior` chooses between the two by device: CPU tensors take
the plain version, CUDA tensors come here. `descend_interior` launches the
kernel in `descend_kernel.cu` (built at first use by `_build.py`) or raises.
The kernel copies the candidate table into shared memory (int16, flat, -1
padded to 16 bytes: `mcts._cand_table_i16`) and carries each next node's
fields from the chosen lane, so a level waits on two global round trips.
Two lanes follow the search options, each behind a flag: the policy ranks
into the scratch's `rank_c` (useNoisePruning) and the `avoid_until` mask
(`forbid_c`). Two more follow the call: the catch-up leak, whose uniform
draws `leak_u` [R, D + 1] come in as a tensor, and the rows of a round of K
playouts a game (numSearchThreads = K, `mcts._simulate_round`): R = B * K
rows, row r of game r // K, each recording its flat actions in `acts_f` and
counting no edge visit (the caller adds them, `mcts._count_path_edges`).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from katacoffee_tpu_torch.ops._build import load_library

SOURCE = Path(__file__).resolve().with_name("descend_kernel.cu")
# Two candidate lanes per thread of a warp; from 64 lanes on, torch's CUDA
# row sum, whose order the kernel follows, changes its block width.
MAX_LANES = 63
EPS = 1e-8  # search/mcts.py _EPS
# A block's shared memory on sm_90 (227 KB) less the kernel's mbarrier: the
# largest candidate table the kernel stages (15x15 needs 135,600 bytes).
MAX_TABLE_BYTES = 232_432

# torch.pow(tensor, exponent) takes its own path for these exponents
# (Pow.cpp: 0 fills ones, 1 copies; the CUDA kernel: 2, 3 and -2 multiply,
# 0.5, -0.5 and -1 call sqrt, rsqrt and reciprocal); the kernel's codes.
_POW_MODES = {0.0: 1, 1.0: 2, 2.0: 3, 3.0: 4, 0.5: 5, -0.5: 6, -1.0: 7, -2.0: 8}
_FPU_PARENT, _FPU_VISITED_POLICY, _FPU_PARENT_WEIGHT = range(3)
# The kernel's argument layout: Select's float and int constants, and the
# tensors kc_descend_interior takes.
_NUM_FLOATS = 16
_NUM_INTS = 6
_NUM_POINTERS = 27


def table_bytes(area: int, lanes: int) -> int:
    """Bytes of the int16 candidate table [area + 1, 5, lanes], padded to
    the 16-byte granule of the kernel's bulk copy."""
    return -(-(area + 1) * 5 * lanes * 2 // 16) * 16


def select_constants(sp, forbid: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """The SearchParams constants of `_selection_compact` as the kernel's
    `Select` struct: float32 values, each rounded the way torch rounds a
    Python scalar against a float32 tensor (a constant computed in Python,
    such as the prior's square, is rounded once), and a division by a Python
    scalar as torch's CUDA multiply by the float32 reciprocal. The last two
    ints switch on the rank lane (useNoisePruning) and, with `forbid`, the
    avoid mask."""
    f32 = np.float32
    if sp.fpuParentWeightByVisitedPolicy:
        fpu_mode = _FPU_VISITED_POLICY
    elif sp.fpuParentWeight > 0.0:
        fpu_mode = _FPU_PARENT_WEIGHT
    else:
        fpu_mode = _FPU_PARENT
    floats = np.array([
        sp.cpuctExploration,
        sp.cpuctExplorationLog,
        sp.cpuctExplorationBase,
        f32(1.0) / f32(sp.cpuctExplorationBase),
        sp.cpuctUtilityStdevScale,
        sp.cpuctUtilityStdevPrior,
        f32(1.0) / f32(sp.cpuctUtilityStdevPrior),
        sp.cpuctUtilityStdevPrior**2,
        sp.cpuctUtilityStdevPriorWeight,
        sp.fpuReductionMax,
        sp.fpuLossProp,
        -sp.winLossUtilityFactor,
        sp.fpuParentWeight,
        1.0 - sp.fpuParentWeight,
        sp.fpuParentWeightByVisitedPolicyPow,
        EPS,
    ], dtype=np.float32)
    ints = np.array([
        int(sp.cpuctUtilityStdevScale != 0.0),
        fpu_mode,
        _POW_MODES.get(float(sp.fpuParentWeightByVisitedPolicyPow), 0),
        int(sp.useGraphSearch),
        int(sp.useNoisePruning),
        int(forbid),
    ], dtype=np.int32)
    assert (floats.size, ints.size) == (_NUM_FLOATS, _NUM_INTS)
    return floats, ints


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build (once) and load the CUDA kernel's library; raises if its
    argument layout is not the one `descend_interior` passes."""
    lib = load_library(SOURCE)
    lib.kc_descend_layout.argtypes = []
    lib.kc_descend_layout.restype = ctypes.c_int
    want = _NUM_FLOATS * 10000 + _NUM_INTS * 100 + _NUM_POINTERS
    if lib.kc_descend_layout() != want:
        raise RuntimeError(
            f"descend_interior: the kernel's argument layout is {lib.kc_descend_layout()}, "
            f"the wrapper passes {want}"
        )
    lib.kc_descend_interior.argtypes = (
        [ctypes.c_void_p] * _NUM_POINTERS + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_void_p] * 3
    )
    lib.kc_descend_interior.restype = ctypes.c_int
    lib.kc_descend_error_string.argtypes = [ctypes.c_int]
    lib.kc_descend_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _dummy(device: torch.device) -> torch.Tensor:
    """The tensor passed for a lane whose flag is off: never read. Made
    once per device, so a launch does not launch a fill kernel before it."""
    return torch.zeros((1,), dtype=torch.int32, device=device)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"descend_interior: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"descend_interior: {name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"descend_interior: {name} must be contiguous")


def descend_interior(sp, cand: torch.Tensor, tree, node, depth, active, path, acts, scratch, avoid_until=None,
                     leak_u=None, acts_f=None):
    """One launch of the fused interior descent; returns (leaf, leaf_depth)
    [R] int64 and `caught` [R] bool (stopped by a graph-search catch-up) and
    updates `path`, `acts`, `scratch` and `tree.edge_visits` or `acts_f` in
    place, as `mcts._descend_interior_plain` does (with `avoid_until` [B, 2,
    A] int32 masking lanes, under useNoisePruning the ranks of
    `tree.policy_rank` [B, N, A] stored in `scratch.rank_c`, and with
    `leak_u` [R, D + 1] float32 the catch-up leak's draws).

    The rows R are the B games, or with `acts_f` [R, D + 1] int64 the B * K
    rows of a round of K playouts a game (row r of game r // K), which
    count no edge visit. `cand` is the candidate table [area + 1, 5, C] as
    int16, flattened and -1 padded to `table_bytes(area, C)`
    (`mcts._cand_table_i16`); `tree` a search Tree, `scratch` a LevelScratch
    [R, D, C, ...]. Every tensor must lie on one CUDA device, contiguous,
    with the Tree's dtypes; anything else, a table above MAX_TABLE_BYTES, or
    a kernel that fails to build or launch, raises. Counted in
    `descend_interior.launches`."""
    B, N, A = tree.children.shape
    R = node.shape[0]
    D, C = scratch.child_c.shape[1:]
    if acts_f is None and R != B or R % B:
        raise ValueError(f"descend_interior: {R} rows for {B} games" + ("" if acts_f is None else
                         " (a round's rows are K per game)"))
    K = R // B
    if not 1 <= C <= MAX_LANES:
        raise ValueError(f"descend_interior: {C} candidate lanes, the kernel takes 1..{MAX_LANES}")
    area = A // 4
    nbytes = table_bytes(area, C)
    if nbytes > MAX_TABLE_BYTES:
        raise ValueError(f"descend_interior: a candidate table of {nbytes} bytes does not fit the "
                         f"{MAX_TABLE_BYTES} bytes of shared memory a block has")
    leak = sp.useGraphSearch and sp.graphSearchCatchUpLeakProb > 0.0
    if leak != (leak_u is not None):
        raise ValueError("descend_interior: leak_u is needed exactly where graphSearchCatchUpLeakProb > 0 under "
                         "graph search")
    dummy = _dummy(tree.stats.device)
    rank = tree.policy_rank if sp.useNoisePruning else dummy
    avoid = avoid_until if avoid_until is not None else dummy
    args = [
        ("last_spot", tree.states.last_spot, torch.int64, (B, N)),
        ("last_dir", tree.states.last_dir, torch.int64, (B, N)),
        ("is_terminal", tree.is_terminal, torch.bool, (B, N)),
        ("cand", cand, torch.int16, (nbytes // 2,)),
        ("children", tree.children, torch.int32, (B, N, A)),
        ("edge_visits", tree.edge_visits, torch.int32, (B, N, A)),
        ("prior", tree.prior, torch.float32, (B, N, A)),
        ("stats", tree.stats, torch.float32, (B, N, 8)),
        ("self_stats", tree.self_stats, torch.float32, (B, N, 4)),
        ("to_move", tree.states.to_move, torch.int8, (B, N)),
        ("policy_rank", rank, torch.int32, (B, N, A) if sp.useNoisePruning else (1,)),
        ("avoid_until", avoid, torch.int32, (B, 2, A) if avoid_until is not None else (1,)),
        ("leak_u", leak_u, torch.float32, (R, D + 1)),
        ("node", node, torch.int64, (R,)),
        ("depth", depth, torch.int64, (R,)),
        ("active", active, torch.bool, (R,)),
        ("path", path, torch.int64, (R, D + 1)),
        ("acts", acts, torch.int64, (R, D + 1)),
        ("acts_f", acts_f, torch.int64, (R, D + 1)),
        ("cs_raw", scratch.cs_raw, torch.float32, (R, D, C, 8)),
        ("prior_c", scratch.prior_c, torch.float32, (R, D, C)),
        ("child_c", scratch.child_c, torch.int32, (R, D, C)),
        ("ev_c", scratch.ev_c, torch.float32, (R, D, C)),
        ("rank_c", scratch.rank_c, torch.float32, (R, D, C)),
    ]
    # a tensor left None (leak_u, acts_f) goes as a null pointer, which turns its flag off
    given = [(name, t, dtype, shape) for name, t, dtype, shape in args if t is not None]
    for name, t, dtype, shape in given:
        _check(name, t, dtype, shape)
    dev = tree.stats.device
    if dev.type != "cuda" or any(t.device != dev for _, t, _, _ in given):
        raise ValueError(
            "descend_interior: needs every tensor on one CUDA device, got "
            + ", ".join(f"{name} on {t.device}" for name, t, _, _ in given)
        )
    if tree.stats.data_ptr() % 16 or scratch.cs_raw.data_ptr() % 16 or cand.data_ptr() % 16:
        raise ValueError("descend_interior: stats, cs_raw and cand must be 16-byte aligned")
    if dev.index != torch.cuda.current_device():
        # the kernel launches on the current device
        with torch.cuda.device(dev):
            return descend_interior(sp, cand, tree, node, depth, active, path, acts, scratch, avoid_until, leak_u,
                                    acts_f)
    leaf = torch.empty((R,), dtype=torch.int64, device=dev)
    leaf_depth = torch.empty((R,), dtype=torch.int64, device=dev)
    caught = torch.empty((R,), dtype=torch.bool, device=dev)
    floats, ints = select_constants(sp, forbid=avoid_until is not None)
    lib = load_kernel()
    pointers = [None if t is None else t.data_ptr() for _, t, _, _ in args]
    err = lib.kc_descend_interior(
        *pointers,
        leaf.data_ptr(), leaf_depth.data_ptr(), caught.data_ptr(),
        R, N, A, C, D, area, K, float(np.float32(sp.graphSearchCatchUpLeakProb)),
        floats.ctypes.data, ints.ctypes.data,
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"descend_interior kernel launch failed: {lib.kc_descend_error_string(err).decode()}")
    descend_interior.launches += 1
    return leaf, leaf_depth, caught


descend_interior.launches = 0
