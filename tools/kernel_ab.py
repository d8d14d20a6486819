#!/usr/bin/env python3
"""A/B of the port's two CUDA kernels on one NVIDIA GPU: this checkout's
gather and descent kernels against another checkout's, in turns on the same
inputs, the descent at 1, 2 and 4 warps a block, and where a level of the
descent spends its cycles.

    git archive <rev> katacoffee_tpu_torch | tar -x -C runs/other   # runs/ is gitignored
    python3 tools/kernel_ab.py --other runs/other

Without `--other` only this checkout's kernels are timed. Prints, each line
with the seconds since start:
  * the card (nvidia-smi) and the launch floor (chip_smoke.launch_floor);
  * the gather at the search's four shapes (chip_smoke.gather_inputs): each
    version equal to gather_rows_plain, then its device time a call
    (chip_smoke.device_ms, a CUDA graph), 6 rounds in alternating order;
  * the descent on three trees grown on the card with the b6c96 net
    (run-s5200): a B=100, N=152 tree 150 playouts in under
    for_gatekeeper() (the gate's shape), and B=512 trees 300 playouts in
    under SearchParams() at N=602 and for_selfplay() at N=182 (chip_smoke
    phase 2's). Each version, and copies of this checkout's kernel built
    with 1 and 2 warps a block (`warps_source`; the kernel has 4), is held
    to `_descend_interior_plain` by chip_smoke.compare_descent; then one
    launch is timed between CUDA events after a sleep kernel, 30 rounds
    with the versions in alternating order, medians in us: "cold", with
    the edge visits restored by a copy before each launch (at B=512 the
    copy is larger than the L2 cache), and "warm", the same launch run
    twice with the rows the first wrote restored in between, so the tree's
    lines are in L2;
  * the cycles of each part of a level, from a copy of this checkout's
    descent kernel with clock64 reads added (`clocked_source`), over the
    levels of games 0-63 of one cold and one warm launch, beside the SM
    clock.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

DBG = 64 * 17 * 6  # games 0-63, 16 levels and the start, 6 numbers each


def load_wrapper(name: str, path: Path, source: Path | None = None):
    """The wrapper module at `path` under another name, building `source`
    instead of its own kernel where given."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if source is not None:
        mod.SOURCE = source
    return mod


def edited_source(src: str, edits) -> str:
    """`src` with each (old, new) of `edits` replaced; raises where `old`
    is not there exactly once."""
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"the kernel source has changed near {old[:40]!r}")
        src = src.replace(old, new)
    return src


def warps_source(src: str, warps: int) -> str:
    """The descent kernel's source with `warps` warps (games) a block."""
    return edited_source(src, [("constexpr int kWarpsPerBlock = 4;", f"constexpr int kWarpsPerBlock = {warps};")])


def clocked_source(src: str) -> str:
    """The descent kernel's source with clock64 reads at the start of each
    level, after trip (a)'s entries, after trip (b)'s rows and the lanes'
    edge stats, after the two sums and after the argmax and the chosen
    lane's shuffles; lane 0 of games 0-63 keeps the differences in
    `kc_dbg`, read by `kc_read_dbg`. Each read takes a value of the part it
    closes as an input, so it cannot run before that part."""
    return edited_source(src, [
        ("namespace {\n\nconstexpr int kWarpsPerBlock",
         f"__device__ long long kc_dbg[{DBG}];\n\nnamespace {{\n\n"
         "__device__ __forceinline__ long long clk(int dep) {\n  long long t;\n"
         '  asm volatile("{\\n\\t.reg .b32 d;\\n\\tmov.b32 d, %1;\\n\\tmov.u64 %0, %%clock64;\\n\\t}"'
         ' : "=l"(t) : "r"(dep) : "memory");\n  return t;\n}\n\nconstexpr int kWarpsPerBlock'),
        ("  if (b >= g.b) return;\n", "  if (b >= g.b) return;\n  const long long t_start = clk(0);\n  int lvl = 0;\n"),
        ("  wait_first_phase(&bar);\n",
         "  wait_first_phase(&bar);\n"
         "  if (lane == 0 && b < 64) kc_dbg[(b * 17 + 16) * 6] = clk(row + __float_as_int(self_u)) - t_start;\n"),
        ("  while (active) {\n    const long long bn = row0 + node;",
         "  while (active) {\n    const long long t0 = clk(row);\n    const long long bn = row0 + node;"),
        ("    // round trip (b): each child's stats row and node fields",
         "    const long long t1 = clk(child[0] ^ child[1] ^ evi[0] ^ evi[1] ^ __float_as_int(pr[0]) ^ "
         "__float_as_int(pr[1]));\n    // round trip (b): each child's stats row and node fields"),
        ("    if (term) break;  // the lanes are saved; nothing is recorded\n",
         "    const long long t2 = clk(__float_as_int(w[0]) ^ __float_as_int(w[1]) ^ crow[0] ^ crow[1] ^ "
         "__float_as_int(cself[0]) ^ __float_as_int(cself[1]) ^ (cterm[0] ? 1 : 0));\n"
         "    if (term) break;  // the lanes are saved; nothing is recorded\n"),
        ("    // _explore_scaling",
         "    const long long t3 = clk(__float_as_int(total_w) ^ __float_as_int(mass));\n    // _explore_scaling"),
        ("    // graph search's edge-visit catch-up (_want_catch)",
         "    const long long t4 = clk(sel_child ^ next_row ^ __float_as_int(next_w) ^ __float_as_int(next_self_u));\n"
         "    if (lane == 0 && b < 64 && lvl < 16) {\n      long long* r = kc_dbg + (b * 17 + lvl) * 6;\n"
         "      r[0] = t1 - t0; r[1] = t2 - t1; r[2] = t3 - t2; r[3] = t4 - t3; r[4] = 1; r[5] = t0 - t_start;\n"
         "    }\n    ++lvl;\n    // graph search's edge-visit catch-up (_want_catch)"),
        ('extern "C" const char* kc_descend_error_string',
         'extern "C" int kc_read_dbg(long long* host) {\n'
         "  return static_cast<int>(cudaMemcpyFromSymbol(host, kc_dbg, sizeof(kc_dbg)));\n}\n\n"
         'extern "C" int kc_clear_dbg() {\n'
         f"  static const long long zeros[{DBG}] = {{}};\n"
         "  return static_cast<int>(cudaMemcpyToSymbol(kc_dbg, zeros, sizeof(zeros)));\n}\n\n"
         'extern "C" const char* kc_descend_error_string'),
    ])


def time_gathers(dev, versions, log) -> None:
    import torch

    for shape in ((100, 152, 8, 100), (256, 182, 8, 100), (24, 182, 8, 100), (512, 602, 8, 100)):
        table, idx = cs.gather_inputs(shape, dev, seed=7)
        want = versions["this"].gather_rows_plain(table, idx)
        for name, mod in versions.items():
            if not torch.equal(mod.gather_rows(table, idx), want):
                raise AssertionError(f"gather {name} != plain at {shape}")
        times = {name: [] for name in versions}
        for rnd in range(6):
            for name in (list(versions) if rnd % 2 == 0 else list(versions)[::-1]):
                times[name].append(cs.device_ms(lambda: versions[name].gather_rows(table, idx)))
        log(f"gather {shape}, device us a call: " + "; ".join(
            f"{k} median {statistics.median(v) * 1e3:.3f} ({', '.join(f'{x * 1e3:.3f}' for x in v)})"
            for k, v in times.items()))


def time_descents(dev, versions, clocked, log) -> None:
    import numpy as np
    import torch

    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.game.board import GameConfig
    from katacoffee_tpu_torch.search import mcts
    from katacoffee_tpu_torch.search.params import SearchParams

    cfg = GameConfig(5, 5, 4)
    net = mcts.make_nn_eval_fn(cfg, load_exported_model(str(ROOT / cs.MODEL_DIR), dev)[0])
    trees = (("gatekeeper B=100 N=152", SearchParams.for_gatekeeper(), 100, 5, 150, 152),
             ("default B=512 N=602", SearchParams(), 512, 1, 300, 602),
             ("selfplay B=512 N=182", SearchParams.for_selfplay(), 512, 1, 300, 182))
    # the kernel before its redesign for the H100 takes the table as int32
    # [area + 1, 5, C]; it has no `table_bytes`
    tables = {name: mcts._cand_table_i16(cfg, dev) if hasattr(mod, "table_bytes")
              else mcts._cand_table(cfg, dev).to(torch.int32).contiguous() for name, mod in versions.items()}
    lib = clocked.load_kernel()
    lib.kc_read_dbg.argtypes = [ctypes.c_void_p]
    lib.kc_read_dbg.restype = ctypes.c_int
    lib.kc_clear_dbg.argtypes = []
    lib.kc_clear_dbg.restype = ctypes.c_int
    for label, sp, batch, seed, sims, nodes in trees:
        tree = mcts.run_search(cfg, sp, net, cs.random_positions(cfg, batch, seed=seed), sims, nodes, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(3))
        inputs = cs.descent_inputs(cfg, sp, tree)
        start_ev = tree.edge_visits.clone()
        node, depth, active, path, acts, scratch = inputs

        def launcher(mod, cand):
            return lambda p, a, sc=scratch: mod.descend_interior(sp, cand, tree, node, depth, active, p, a, sc)

        launch = {name: launcher(mod, tables[name]) for name, mod in versions.items()}
        want = cs.run_descent(mcts._descend_interior_plain, cfg, sp, tree, start_ev, inputs)
        for name, fn in launch.items():
            got = cs.run_descent(lambda *args, fn=fn: fn(args[6], args[7], args[8]), cfg, sp, tree, start_ev, inputs)
            if cs.compare_descent(f"{label} {name}", cfg, sp, tree, start_ev, inputs, got, want)[0]:
                raise AssertionError(f"{label} {name}: a near-tie flip")
        levels = torch.where(active, want[1] - depth + (want[1] < mcts._max_depth(cfg, sp)).long(), 0)
        rows = want[2][:, :-1].clamp(min=0)
        bidx = torch.arange(rows.shape[0], device=dev)[:, None].expand_as(rows)
        saved = start_ev[bidx, rows].clone()
        p, a = path.clone(), acts.clone()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def restore(warm, fn):
            tree.edge_visits.copy_(start_ev)
            p.copy_(path)
            a.copy_(acts)
            if warm:
                fn(p, a)
                tree.edge_visits[bidx, rows] = saved
                p.copy_(path)
                a.copy_(acts)

        runs = list(launch)
        for warm in (False, True):
            times = {name: [] for name in runs}
            for rnd in range(30):
                for name in (runs if rnd % 2 == 0 else runs[::-1]):
                    restore(warm, launch[name])
                    torch.cuda._sleep(1_000_000)
                    start.record()
                    launch[name](p, a)
                    end.record()
                    end.synchronize()
                    times[name].append(start.elapsed_time(end))
                    if warm and not (torch.equal(p, want[2]) and torch.equal(a, want[3])):
                        raise AssertionError(f"{label} {name}: the warm launch took other paths")
            log(f"{label}, deepest game {int(levels.max())} levels, {int(levels.sum())} in all; "
                f"{'warm' if warm else 'cold'}, device us a launch: "
                + ", ".join(f"{name} {statistics.median(t) * 1e3:.2f}" for name, t in times.items()))

        clocked_launch = launcher(clocked, tables["this"])
        buf = np.zeros(DBG, dtype=np.int64)
        for warm in (False, True):
            restore(warm, clocked_launch)
            torch.cuda.synchronize()
            if lib.kc_clear_dbg() != 0:
                raise RuntimeError("kc_clear_dbg failed")
            clocked_launch(p, a)
            torch.cuda.synchronize()
            if lib.kc_read_dbg(buf.ctypes.data) != 0:
                raise RuntimeError("kc_read_dbg failed")
            r = buf.reshape(64, 17, 6)
            lv = r[:, :16][r[:, :16, 4] == 1]
            step = r[:, 1:16, 5] - r[:, :15, 5]
            both = (r[:, 1:16, 4] == 1) & (r[:, :15, 4] == 1)
            first = r[:, 16, 0]
            log(f"{label}, {'warm' if warm else 'cold'}, clocked copy, {lv.shape[0]} levels of games 0-63, mean "
                f"cycles: trip (a) {lv[:, 0].mean():.0f}, trip (b) and the lanes' edge stats {lv[:, 1].mean():.0f}, "
                f"the two sums {lv[:, 2].mean():.0f}, scores, argmax and the chosen lane {lv[:, 3].mean():.0f}; "
                f"level to level {step[both].mean():.0f}; start to the first level {first[first > 0].mean():.0f}")
        clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                                capture_output=True, text=True, timeout=60).stdout.strip()
        log(f"  SM clock, current and max: {clocks}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="a checkout holding another katacoffee_tpu_torch/ops")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from katacoffee_tpu_torch.ops import _build, descend, gather

    cs.log(cs.card_line())
    dev = torch.device("cuda")
    ops = ROOT / "katacoffee_tpu_torch" / "ops"
    gathers = {"this": gather}
    descents = {"this": descend}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = descend.SOURCE.read_text()
    for warps in (1, 2):
        cu = _build.BUILD_DIR / f"descend_kernel_{warps}warps.cu"
        cu.write_text(warps_source(src, warps))
        name = f"this at {warps} warp{'s' if warps > 1 else ''}"
        descents[name] = load_wrapper(f"descend_{warps}warps", ops / "descend.py", cu)
    if args.other is not None:
        other = args.other.resolve() / "katacoffee_tpu_torch" / "ops"
        gathers["other"] = load_wrapper("other_gather", other / "gather.py")
        descents["other"] = load_wrapper("other_descend", other / "descend.py")
    clocked_cu = _build.BUILD_DIR / "descend_kernel_clocked.cu"
    clocked_cu.write_text(clocked_source(src))
    clocked = load_wrapper("clocked_descend", ops / "descend.py", clocked_cu)
    with ThreadPoolExecutor(8) as pool:
        for built in [pool.submit(m.load_kernel) for m in (*gathers.values(), *descents.values(), clocked)]:
            built.result()
    cs.launch_floor()
    time_gathers(dev, gathers, cs.log)
    time_descents(dev, descents, clocked, cs.log)
    cs.log("kernel_ab: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
