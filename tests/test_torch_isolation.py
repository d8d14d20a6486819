"""Guards on the PyTorch port as a package of its own: it imports neither JAX
nor the JAX package, its entry points refuse to fall back to the CPU when no
GPU is present, and it commits only small text files."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "katacoffee_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "katacoffee_tpu")


def _port_sources():
    files = sorted(p for p in PORT.rglob("*.py") if "_build" not in p.parts)
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_the_selfplay_slice_modules_are_checked():
    """The modules of the selfplay slice are among the sources checked
    above (every module of the package is)."""
    sources = _port_sources()
    for rel in ("game/symmetry.py", "search/mcts.py", "ops/descend.py"):
        assert PORT / rel in sources, rel


def test_the_distributed_and_parallel_modules_are_checked():
    """The contribution bus's and the several-GPU layer's modules are among
    the sources checked above and among the modules imported without the
    reference package."""
    sources = _port_sources()
    imported = {".".join(p.relative_to(PORT).with_suffix("").parts) for p in PORT.rglob("*.py")}
    for rel in ("distributed/__init__.py", "distributed/server.py", "distributed/client.py", "parallel/__init__.py",
                "parallel/mesh.py"):
        assert PORT / rel in sources, rel
        assert ".".join(Path(rel).with_suffix("").parts) in imported, rel


def test_the_actor_modules_are_checked():
    """The selfplay actor's modules are among the sources checked above and
    among the modules imported without the reference package below."""
    sources = _port_sources()
    for rel in ("selfplay/actor.py", "selfplay/treerecord.py", "selfplay/forking.py", "game/board.py"):
        assert PORT / rel in sources, rel
    imported = {".".join(p.relative_to(PORT).with_suffix("").parts) for p in PORT.rglob("*.py")}
    assert {"selfplay.actor", "selfplay.treerecord", "selfplay.forking"} <= imported


def test_forbidden_match_is_exact():
    assert _forbidden("katacoffee_tpu") and _forbidden("katacoffee_tpu.search")
    assert _forbidden("jax.numpy") and not _forbidden("katacoffee_tpu_torch.search")
    assert _forbidden("msgpack") and _forbidden("optax.contrib") and not _forbidden("msgpack_numpy_free")


def test_importing_the_port_loads_no_reference_package():
    modules = sorted(
        "katacoffee_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py")
        if p.name != "__init__.py" and "_build" not in p.parts
    )
    code = (
        "import sys, importlib\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'katacoffee_tpu' or m.startswith('katacoffee_tpu.')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr


def test_entry_points_refuse_the_cpu_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from katacoffee_tpu_torch.command.benchmark import benchmark_search
    from katacoffee_tpu_torch.dataio.checkpoints import load_exported_model
    from katacoffee_tpu_torch.game.board import GameConfig, init_state
    from katacoffee_tpu_torch.search.mcts import run_search, uniform_eval_fn
    from katacoffee_tpu_torch.search.params import SearchParams

    cfg = GameConfig()
    calls = []
    ev = uniform_eval_fn(cfg)

    def counting_eval(states):
        calls.append(states.board.device)
        return ev(states)

    roots = init_state(cfg, 2, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_search(cfg, SearchParams(), counting_eval, roots, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark_search(cfg, SearchParams(), counting_eval, batch_sizes=(2,), num_visits=4, log=calls.append)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(cfg, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_exported_model(str(ROOT / "tests/goldens/tinynet"))
    assert calls == []


def _committable_files():
    try:
        out = subprocess.run(
            ["git", "ls-files", "--cached", "--others", "--exclude-standard", "katacoffee_tpu_torch"],
            cwd=ROOT, capture_output=True, text=True, check=True, timeout=60,
        ).stdout.split()
        return [ROOT / f for f in out]
    except (OSError, subprocess.CalledProcessError):
        # not a git checkout: everything but the build and bytecode caches
        return [
            p for p in PORT.rglob("*")
            if p.is_file() and "_build" not in p.parts and "__pycache__" not in p.parts
        ]


def test_port_commits_only_small_text_files():
    files = _committable_files()
    assert files
    for f in files:
        if not f.exists():
            continue  # deleted in the working tree
        assert f.suffix != ".so", f
        assert f.stat().st_size <= 100 * 1024, f
        assert b"\0" not in f.read_bytes(), f


def test_selfplay_entry_points_refuse_the_cpu_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from katacoffee_tpu_torch.game.board import GameConfig, init_state
    from katacoffee_tpu_torch.search.mcts import uniform_eval_fn
    from katacoffee_tpu_torch.search.params import SearchParams
    from katacoffee_tpu_torch.selfplay.actor import SelfplaySettings, init_side_state, run_selfplay_segment
    from katacoffee_tpu_torch.selfplay.forking import init_fork_pool

    cfg = GameConfig()
    calls = []
    ev = uniform_eval_fn(cfg)

    def counting_eval(states):
        calls.append(states.board.device)
        return ev(states)

    states = init_state(cfg, 2, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_selfplay_segment(cfg, SearchParams(), SelfplaySettings(num_sims=4), counting_eval, states,
                             torch.zeros(2, dtype=torch.int64), 1, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        init_side_state(cfg, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_fork_pool(cfg, 4)
    assert calls == []


SELFPLAY_COMMAND_MODULES = ("utils/config.py", "utils/logger.py", "dataio/sgf.py", "dataio/trainingwrite.py",
                            "dataio/shuffle.py", "dataio/checkpoints.py", "selfplay/startposes.py",
                            "command/selfplay.py", "cli.py", "__main__.py")


def test_the_selfplay_command_modules_are_checked():
    """The selfplay command's modules are among the sources checked above
    and among the modules imported without the reference package."""
    sources = _port_sources()
    imported = {".".join(p.relative_to(PORT).with_suffix("").parts) for p in PORT.rglob("*.py")}
    for rel in SELFPLAY_COMMAND_MODULES:
        assert PORT / rel in sources, rel
        assert ".".join(Path(rel).with_suffix("").parts) in imported, rel


def test_selfplay_command_refuses_the_cpu_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from katacoffee_tpu_torch.command import selfplay
    from katacoffee_tpu_torch.dataio.trainingwrite import rows_to_batch
    from katacoffee_tpu_torch.game.board import GameConfig
    from katacoffee_tpu_torch.search.params import SearchParams
    from katacoffee_tpu_torch.selfplay.startposes import load_startposes

    spc = selfplay.SelfplayConfig(batch_size=2, num_sims=4, moves_per_segment=1, max_segments=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        selfplay.run_selfplay_daemon(str(tmp_path), GameConfig(), SearchParams.for_selfplay(), spc)
    with pytest.raises(RuntimeError, match="CUDA"):
        selfplay.main(["-output-dir", str(tmp_path / "out"), "-override-config", "maxSegments=1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        load_startposes(GameConfig(), str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        rows_to_batch({}, GameConfig())
    assert not (tmp_path / "out").exists() and not (tmp_path / "selfplay").exists()
    # with device="cpu" the same daemon runs
    assert selfplay.run_selfplay_daemon(str(tmp_path), GameConfig(), SearchParams.for_selfplay(), spc,
                                        device="cpu") == 0


def test_selfplay_command_refuses_several_gpus_and_hosts(monkeypatch, tmp_path):
    """Several GPUs and multi-process launches are no longer refused: under
    a launcher the command joins its process group; outside one, with
    several visible GPUs, use_mesh and a batch that divides over them, the
    daemon runs one rank a GPU through launch_local. Where the JAX package
    forms no cluster (match, gatekeeper, loop) a launch still raises and
    names torchrun."""
    from katacoffee_tpu_torch.command import gatekeeper, loop, match, selfplay
    from katacoffee_tpu_torch.game.board import GameConfig
    from katacoffee_tpu_torch.parallel import mesh
    from katacoffee_tpu_torch.search.params import SearchParams

    calls = []
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(mesh, "init_distributed", lambda backend=None, *, device=None: calls.append(("init", device)))
    monkeypatch.setattr(selfplay, "run_selfplay_daemon", lambda *a, **kw: calls.append(("daemon", kw["device"])))
    selfplay.main(["-output-dir", str(tmp_path / "sp")], device="cpu")
    assert calls == [("init", torch.device("cpu")), ("daemon", torch.device("cpu"))]
    for run in (lambda: loop.main(["-base-dir", str(tmp_path)], device="cpu"),
                lambda: gatekeeper.main(["-base-dir", str(tmp_path)], device="cpu"),
                lambda: match.main(["random", "random"], device="cpu")):
        with pytest.raises(NotImplementedError, match="torchrun"):
            run()
    assert mesh.local_world_size(torch.device("cuda"), True, 8) == 1  # under the launcher
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.undo()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    launched = []

    def launch_local(fn, n, *args, **kw):
        launched.append((fn, n, args[3].batch_size))
        return [(123, {"segment": [1.0]})] * n

    monkeypatch.setattr(mesh, "launch_local", launch_local)
    spc = selfplay.SelfplayConfig(batch_size=8)
    walls = {}
    assert selfplay.run_selfplay_daemon(str(tmp_path), GameConfig(), SearchParams.for_selfplay(), spc, device="cuda",
                                        walls=walls) == 123
    assert launched == [(selfplay._daemon_rank, 4, 8)] and walls == {"segment": [1.0]}
    cuda = torch.device("cuda")
    assert [mesh.local_world_size(cuda, True, 8), mesh.local_world_size(cuda, True, 6),
            mesh.local_world_size(cuda, False, 8), mesh.local_world_size(torch.device("cuda", 1), True, 8),
            mesh.local_world_size(torch.device("cpu"), True, 8)] == [4, 1, 1, 1, 1]


TRAINER_MODULES = ("nn/features.py", "nn/model.py", "dataio/flaxbytes.py", "dataio/checkpoints.py",
                   "train/losses.py", "train/train.py", "train/replay.py", "train/__init__.py", "command/train.py",
                   "command/validate.py", "command/checkpoint.py", "device.py")


def test_the_trainer_modules_are_checked():
    """The trainer's modules are among the sources checked above and among
    the modules imported without the reference package."""
    sources = _port_sources()
    imported = {".".join(p.relative_to(PORT).with_suffix("").parts) for p in PORT.rglob("*.py")}
    for rel in TRAINER_MODULES:
        assert PORT / rel in sources, rel
        assert ".".join(Path(rel).with_suffix("").parts) in imported, rel


def test_trainer_entry_points_refuse_the_cpu_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from katacoffee_tpu_torch.command import checkpoint, train, validate
    from katacoffee_tpu_torch.game.board import GameConfig
    from katacoffee_tpu_torch.train.train import TrainConfig

    trc = train.TrainerConfig(model="b1c6", batch_size=4, max_steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.run_training(str(tmp_path), GameConfig(), TrainConfig(), trc)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.run_training_mixed(str(tmp_path), [GameConfig()], TrainConfig(), trc)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["-base-dir", str(tmp_path), "-override-config", "maxSteps=1"])
    model = str(ROOT / "tests/goldens/tinynet")
    with pytest.raises(RuntimeError, match="CUDA"):
        validate.main([model, str(tmp_path)])
    ckpt = str(ROOT / "artifacts/flagship_b6c96/train/run/checkpoint.ckpt")
    with pytest.raises(RuntimeError, match="CUDA"):
        checkpoint.main(["export", "-checkpoint", ckpt, "-model", "b6c96", "-out-dir", str(tmp_path / "m")])
    assert os.listdir(tmp_path) == []


def test_trainer_refuses_several_gpus_and_hosts(monkeypatch, tmp_path):
    """The data-parallel trainer is no longer refused: under a launcher
    `train` joins its process group; outside one, with several visible
    GPUs, run_training runs one rank a GPU through launch_local; the
    mixed-size trainer, which shards nothing in the JAX package, runs on
    the one device it is given."""
    from katacoffee_tpu_torch.command import train
    from katacoffee_tpu_torch.game.board import GameConfig
    from katacoffee_tpu_torch.parallel import mesh
    from katacoffee_tpu_torch.train.train import TrainConfig

    calls = []
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(mesh, "init_distributed", lambda backend=None, *, device=None: calls.append(("init", device)))
    monkeypatch.setattr(train, "run_training", lambda *a, **kw: calls.append(("train", kw["device"])))
    train.main(["-base-dir", str(tmp_path)], device="cpu")
    assert calls == [("init", torch.device("cpu")), ("train", torch.device("cpu"))]
    monkeypatch.undo()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    launched = []
    monkeypatch.setattr(mesh, "launch_local", lambda fn, n, *args, **kw: launched.append((fn, n, args)) or [7] * n)
    trc = train.TrainerConfig(model="b1c6", batch_size=256)
    assert train.run_training(str(tmp_path), GameConfig(), TrainConfig(), trc, device="cuda") == 7
    assert [(fn, n, args[3]) for fn, n, args in launched] == [(train.run_training, 4, trc)]
    assert os.listdir(tmp_path) == []
    with pytest.raises(FileNotFoundError, match="no shuffled data"):
        train.run_training_mixed(str(tmp_path), [GameConfig()], TrainConfig(), trc, device="cpu")


GATING_MODULES = ("program/__init__.py", "program/setup.py", "program/match.py", "utils/elo.py",
                  "command/gatekeeper.py", "command/match.py", "command/loop.py", "command/summarize_sgfs.py",
                  "command/benchmark.py")


def test_the_gating_modules_are_checked():
    """The gatekeeper, match and loop modules are among the sources checked
    above and among the modules imported without the reference package."""
    sources = _port_sources()
    imported = {".".join(p.relative_to(PORT).with_suffix("").parts) for p in PORT.rglob("*.py")}
    for rel in GATING_MODULES:
        assert PORT / rel in sources, rel
        assert ".".join(Path(rel).with_suffix("").parts) in imported, rel


def test_gating_entry_points_refuse_the_cpu_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from katacoffee_tpu_torch.command import benchmark, gatekeeper, loop, match, summarize_sgfs
    from katacoffee_tpu_torch.game.board import GameConfig
    from katacoffee_tpu_torch.program import match as program_match
    from katacoffee_tpu_torch.program.setup import load_eval_fn
    from katacoffee_tpu_torch.search.mcts import uniform_eval_fn
    from katacoffee_tpu_torch.search.params import SearchParams

    cfg, sp, ev = GameConfig(), SearchParams.for_gatekeeper(), uniform_eval_fn(GameConfig())
    model = str(ROOT / "tests/goldens/tinynet")
    sgf = tmp_path / "sgfs"
    sgf.mkdir()
    from katacoffee_tpu_torch.dataio.sgf import write_sgf

    (sgf / "g.sgf").write_text(write_sgf(5, 5, 4, [(2, 2, 0, 1)], "a", "b", winner=0))
    for run in (
        lambda: program_match.run_match(cfg, sp, sp, ev, ev, num_games=2, num_visits=2),
        lambda: gatekeeper.run_gatekeeper(str(tmp_path / "g"), cfg, gatekeeper.GatekeeperConfig(), once=True),
        lambda: gatekeeper.main(["-base-dir", str(tmp_path / "g"), "-quit-if-no-candidates"]),
        lambda: loop.run_loop(str(tmp_path / "l"), cfg, loop.LoopConfig(num_cycles=1)),
        lambda: loop.main(["-base-dir", str(tmp_path / "l")]),
        lambda: match.run_round_robin(cfg, {"a": ev, "b": ev}, 2, 2),
        lambda: match.main(["random", "random", "-games-per-pair", "2"]),
        lambda: benchmark.main(["-visits", "2", "-batch-sizes", "1"]),
        lambda: summarize_sgfs.collect_results([str(sgf)]),
        lambda: load_eval_fn(cfg, model),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()
    assert os.listdir(tmp_path) == ["sgfs"]


def test_cli_runs_the_ported_subcommands(capsys, monkeypatch):
    """`train`, `shuffle`, `validate`, `checkpoint`, `gtp`, `analysis`,
    `evalsgf`, `genconfig`, `serve` and `contribute` dispatch to their
    commands (each here stubbed to echo its arguments), `version` and
    `printclockinfo` print; unknown subcommands exit 2 and say they are not
    ported."""
    from katacoffee_tpu_torch import cli
    from katacoffee_tpu_torch.command import analysis, checkpoint, evalsgf, genconfig, gtp, selfplay, train, validate
    from katacoffee_tpu_torch.dataio import shuffle

    assert cli.main([]) == 0
    out = capsys.readouterr().out
    for cmd in ("selfplay", "train", "shuffle", "validate", "checkpoint", "gtp", "analysis", "evalsgf", "genconfig",
                "version", "printclockinfo"):
        assert cmd in out
    seen = []
    monkeypatch.setattr(selfplay, "main", lambda argv: seen.append(("selfplay", argv)))
    monkeypatch.setattr(train, "main", lambda argv: seen.append(("train", argv)))
    monkeypatch.setattr(validate, "main", lambda argv: seen.append(("validate", argv)) or 0)
    monkeypatch.setattr(checkpoint, "main", lambda argv: seen.append(("checkpoint", argv)) or 3)
    monkeypatch.setattr(shuffle, "shuffle_data", lambda dirs, out, **kw: seen.append(("shuffle", dirs, out, kw)))
    assert cli.main(["selfplay", "-output-dir", "o"]) == 0
    assert cli.main(["train", "-base-dir", "b"]) == 0
    assert cli.main(["validate", "m", "d"]) == 0
    assert cli.main(["checkpoint", "dump", "-checkpoint", "c"]) == 3
    assert cli.main(["shuffle", "d1", "d2", "-out-dir", "o", "-min-rows", "5", "-val-prop", "0.1", "-seed", "2"]) == 0
    assert seen[:4] == [("selfplay", ["-output-dir", "o"]), ("train", ["-base-dir", "b"]), ("validate", ["m", "d"]),
                        ("checkpoint", ["dump", "-checkpoint", "c"])]
    assert seen[4][:3] == ("shuffle", ["d1", "d2"], "o")
    assert seen[4][3] == {"min_rows": 5, "expand_window_per_row": 0.4, "taper_window_exponent": 0.65,
                          "keep_target_rows": None, "val_prop": 0.1, "seed": 2}
    monkeypatch.setattr(gtp, "main", lambda argv, **kw: seen.append(("gtp", argv, kw)))
    assert cli.main(["gtp", "-config", "c.cfg"]) == 0
    assert seen[5] == ("gtp", ["-config", "c.cfg"], {})
    monkeypatch.setattr(analysis, "main", lambda argv, **kw: seen.append(("analysis", argv, kw)))
    monkeypatch.setattr(evalsgf, "main", lambda argv: seen.append(("evalsgf", argv)))
    monkeypatch.setattr(genconfig, "main", lambda argv: seen.append(("genconfig", argv)))
    assert cli.main(["analysis", "-config", "a.cfg"]) == 0
    assert cli.main(["evalsgf", "g.sgf", "-visits", "16"]) == 0
    assert cli.main(["genconfig", "-output", "o.cfg", "-noninteractive"]) == 0
    assert seen[6:] == [("analysis", ["-config", "a.cfg"], {}), ("evalsgf", ["g.sgf", "-visits", "16"]),
                        ("genconfig", ["-output", "o.cfg", "-noninteractive"])]
    capsys.readouterr()
    assert cli.main(["version"]) == 0 and capsys.readouterr().out == "0.1.0\n"
    assert cli.main(["printclockinfo"]) == 0 and "Resolution in seconds: " in capsys.readouterr().out
    from katacoffee_tpu_torch.distributed import client

    monkeypatch.setattr(client, "main_serve", lambda argv: seen.append(("serve", argv)))
    monkeypatch.setattr(client, "main", lambda argv: seen.append(("contribute", argv)))
    assert cli.main(["serve", "-base-dir", "b"]) == 0
    assert cli.main(["contribute", "-server", "http://h:1", "-max-cycles", "1"]) == 0
    assert seen[-2:] == [("serve", ["-base-dir", "b"]), ("contribute", ["-server", "http://h:1", "-max-cycles", "1"])]
    assert cli.main(["nonsense"]) == 2
    assert "nonsense is not ported" in capsys.readouterr().err


GTP_MODULES = ("game/io.py", "search/timecontrols.py", "search/ownership.py", "program/engine.py",
               "command/gtp.py")


def test_the_gtp_modules_are_checked():
    """The GTP slice's modules are among the sources checked above and
    among the modules imported without the reference package (the JAX
    package's pure-Python io and timecontrols are copied, not imported)."""
    sources = _port_sources()
    imported = {".".join(p.relative_to(PORT).with_suffix("").parts) for p in PORT.rglob("*.py")}
    for rel in GTP_MODULES:
        assert PORT / rel in sources, rel
        assert ".".join(Path(rel).with_suffix("").parts) in imported, rel


def test_gtp_entry_points_refuse_the_cpu_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from katacoffee_tpu_torch import cli
    from katacoffee_tpu_torch.command import gtp
    from katacoffee_tpu_torch.game.board import GameConfig
    from katacoffee_tpu_torch.program.engine import Engine
    from katacoffee_tpu_torch.search.params import SearchParams

    cfg, sp = GameConfig(), SearchParams.for_tests_v2()
    model = str(ROOT / "tests/goldens/tinynet")
    for run in (
        lambda: Engine(cfg, sp),
        lambda: gtp.GTPEngine(cfg, sp),
        lambda: gtp.main(["-config", str(ROOT / "configs/gtp_example.cfg")]),
        lambda: cli.main(["gtp", "-model", model]),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()


ANALYSIS_MODULES = ("command/analysis.py", "command/evalsgf.py", "command/genconfig.py")


def test_the_analysis_modules_are_checked():
    """The analysis slice's modules are among the sources checked above and
    among the modules imported without the reference package."""
    sources = _port_sources()
    imported = {".".join(p.relative_to(PORT).with_suffix("").parts) for p in PORT.rglob("*.py")}
    for rel in ANALYSIS_MODULES:
        assert PORT / rel in sources, rel
        assert ".".join(Path(rel).with_suffix("").parts) in imported, rel


def test_analysis_entry_points_refuse_the_cpu_without_cuda(tmp_path, monkeypatch):
    """The analysis engine and the analysis, evalsgf and genconfig
    subcommands raise without CUDA unless given device="cpu"; nothing is
    read from stdin or written first."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import io

    from katacoffee_tpu_torch import cli
    from katacoffee_tpu_torch.command import analysis, evalsgf, genconfig
    from katacoffee_tpu_torch.search.params import SearchParams

    monkeypatch.setattr("sys.stdin", io.StringIO('{"id":"a","maxVisits":2}\n'))
    model = str(ROOT / "tests/goldens/tinynet")
    sgf = tmp_path / "g.sgf"
    sgf.write_text("(;FF[4]GM[Coffee]SZ[5]WLL[4];B[cca])\n")
    for run in (
        lambda: analysis.AnalysisEngine(SearchParams.for_tests_v2()),
        lambda: analysis.main([]),
        lambda: cli.main(["analysis"]),
        lambda: cli.main(["analysis", "-model", model]),
        lambda: evalsgf.main([str(sgf), "-visits", "2"]),
        lambda: cli.main(["evalsgf", str(sgf), "-model", model]),
        lambda: genconfig.main(["-output", str(tmp_path / "o.cfg"), "-noninteractive", "-model", model]),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()
    assert sorted(os.listdir(tmp_path)) == ["g.sgf"]
    assert analysis.AnalysisEngine(SearchParams.for_tests_v2(), device="cpu").device.type == "cpu"
