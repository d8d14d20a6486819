"""The port's contribution bus (`katacoffee_tpu_torch/distributed/`) against
the JAX package's, on the CPU, over localhost.

- The port's server and the JAX server over one base dir give the same
  task JSON, model bytes, 404 and 400 replies, store uploads at the same
  places, and hand out the same 20 rating tasks for one `rating_seed`.
- The port's client against the JAX server, in the size of JAX's own bus
  tests (B=4, 6 visits, 26 moves), with uniform priors and with the tiny
  net: every uploaded shard reads through JAX's `read_npz_rows` and
  `rows_to_batch`, and JAX's `batch_to_arrays` writes it back with the same
  keys, dtypes, shapes and values; every SGF parses with JAX's `dataio/sgf.py`
  and names the model.
- HTTPS with a self-signed certificate (openssl), as JAX's
  `test_https_round_trip`, both clients against the port's server.
- A rating task: the SGFs uploaded tally, through the port's
  `summarize_sgfs`, to the client's own match result.
- `python -m katacoffee_tpu_torch serve` in a subprocess answers as the JAX
  server; the client and `contribute` refuse the CPU unless asked for it.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from katacoffee_tpu.dataio import sgf as JS
from katacoffee_tpu.dataio import trainingwrite as JW
from katacoffee_tpu.distributed import ContributeClient as JaxClient
from katacoffee_tpu.distributed import ContributionServer as JaxServer
from katacoffee_tpu.game.board import GameConfig
from katacoffee_tpu_torch.command.summarize_sgfs import collect_results
from katacoffee_tpu_torch.dataio import checkpoints as TC
from katacoffee_tpu_torch.distributed import ContributeClient, ContributionServer
from katacoffee_tpu_torch.distributed import client as client_module
from katacoffee_tpu_torch.game.board import GameConfig as TGameConfig
from katacoffee_tpu_torch.utils.logger import Logger
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINYNET = os.path.join(ROOT, "tests", "goldens", "tinynet")
CFG = GameConfig(5, 5, 4)
TCFG = TGameConfig(5, 5, 4)
SELFPLAY = {"maxVisits": 6, "numParallelGames": 4}


def fetch(url: str, data: bytes | None = None) -> tuple[int, bytes]:
    """(status, body) of a request, error replies included."""
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data)) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def add_second_model(models: str) -> None:
    """The tiny net with its weights scaled, exported as `tinynet-b`."""
    model = TC.load_exported_model(TINYNET, "cpu")[0]
    params = {k: v * 0.5 for k, v in model.state_dict().items()}
    TC.export_model(models, "tinynet-b", params, "b1c6", TCFG)


def servers(base: str, **kw):
    return JaxServer(base, CFG, **kw).start(), ContributionServer(base, TCFG, **kw).start()


def test_servers_agree_on_replies_layout_and_rating_tasks(tmp_path):
    base = str(tmp_path / "base")
    models = os.path.join(base, "models")
    os.makedirs(models)
    jax_srv, srv = servers(base, selfplay_config=SELFPLAY)
    try:
        for name in ("random", "tinynet"):  # without a model, then with the tiny net
            if name != "random":
                shutil.copytree(TINYNET, os.path.join(models, name))
            replies = [fetch(s.url + "/api/task") for s in (jax_srv, srv)]
            assert replies[0] == replies[1] and replies[0][0] == 200
            assert json.loads(replies[1][1])["modelName"] == name
        for path in ("/api/model/tinynet/model.npz", "/api/model/tinynet/model.json", "/api/model/nope/model.json",
                     "/api/model/tinynet/other.bin", "/api/model/..%2Fevil/model.json", "/api/nothing"):
            replies = [fetch(s.url + path) for s in (jax_srv, srv)]
            assert replies[0] == replies[1], path
        assert [fetch(srv.url + p)[0] for p in ("/api/model/tinynet/model.npz", "/api/model/nope/model.json",
                                                "/api/nothing")] == [200, 404, 404]
        for path, body in (("/api/games/tinynet", b""), ("/api/games/a..b", b"x"), ("/api/nothing", b"x")):
            replies = [fetch(s.url + path, body) for s in (jax_srv, srv)]
            assert replies[0] == replies[1] and replies[0][0] in (400, 404), path
        for path, where in (("/api/games/m1", "selfplay/m1/tdata"), ("/api/sgfs/m1", "selfplay/m1/sgfs"),
                            ("/api/ratinggames", "ratinggames")):
            names = []
            for s in (jax_srv, srv):
                body = f"{path} {s.port}".encode()
                status, reply = fetch(s.url + path, body)
                name = json.loads(reply)["stored"]
                with open(os.path.join(base, where, name), "rb") as f:
                    assert status == 200 and f.read() == body
                names.append(name.split("_")[0] + os.path.splitext(name)[1])
            assert names[0] == names[1], path
    finally:
        jax_srv.stop()
        srv.stop()

    add_second_model(models)
    kw = dict(rating_game_prob=0.5, rating_config={"maxVisits": 6, "numRatingGames": 2}, rating_seed=7)
    jax_srv, srv = servers(base, **kw)
    try:
        tasks = [[json.loads(fetch(s.url + "/api/task")[1]) for _ in range(20)] for s in (jax_srv, srv)]
    finally:
        jax_srv.stop()
        srv.stop()
    assert tasks[0] == tasks[1]
    assert 0 < sum(t["taskType"] == "rating" for t in tasks[1]) < 20


def check_uploads(base: str, model: str, rows: int, games_at_least: int = 1) -> None:
    """The shards under base/selfplay/<model> through JAX's reader and
    writer, and its SGFs through JAX's parser."""
    shards = list(JW.iter_shards(os.path.join(base, "selfplay", model, "tdata")))
    assert len(shards) == 1
    data = JW.read_npz_rows(shards[0])
    assert data["weight"].shape[0] == rows > 0 and (data["weight"] > 0).all()
    again = JW.batch_to_arrays(JW.rows_to_batch(data, CFG), CFG)
    assert again.keys() == data.keys()
    for k, v in again.items():
        assert (v.dtype, v.shape) == (data[k].dtype, data[k].shape), k
        assert np.array_equal(v, data[k]), k
    sgf_dir = os.path.join(base, "selfplay", model, "sgfs")
    sgfs = [JS.parse_sgf_file(os.path.join(sgf_dir, n)) for n in os.listdir(sgf_dir)]
    assert len(sgfs) >= games_at_least
    for g in sgfs:
        assert g.board_size() == (5, 5) and g.root.get("PB") == g.root.get("PW") == model
        assert g.result() is not None and g.moves()


def test_port_client_against_the_jax_server(tmp_path):
    base = str(tmp_path / "base")
    os.makedirs(os.path.join(base, "models"))
    srv = JaxServer(base, CFG, selfplay_config=SELFPLAY).start()
    try:
        client = ContributeClient(srv.url, str(tmp_path / "cache"), logger=Logger(), seed=0, device="cpu")
        check_uploads(base, "random", client.run_cycle(moves_per_segment=26))
        shutil.copytree(TINYNET, os.path.join(base, "models", "tinynet"))
        check_uploads(base, "tinynet", client.run_cycle(moves_per_segment=26))
    finally:
        srv.stop()
    cached = tmp_path / "cache" / "tinynet"
    for name in ("model.npz", "model.json"):
        assert (cached / name).read_bytes() == open(os.path.join(TINYNET, name), "rb").read()


def test_https_round_trip(tmp_path):
    cert, key = str(tmp_path / "server.pem"), str(tmp_path / "server.key")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", key, "-out", cert, "-days",
                    "1", "-subj", "/CN=127.0.0.1", "-addext", "subjectAltName=IP:127.0.0.1"], check=True,
                   capture_output=True, timeout=60)
    base = str(tmp_path / "base")
    os.makedirs(os.path.join(base, "models"))
    srv = ContributionServer(base, TCFG, certfile=cert, keyfile=key).start()
    try:
        assert srv.url.startswith("https://")
        mine = ContributeClient(srv.url, str(tmp_path / "c1"), logger=Logger(), cafile=cert, device="cpu")
        theirs = JaxClient(srv.url, str(tmp_path / "c2"), logger=Logger(), cafile=cert)
        assert mine.get_task() == theirs.get_task()
        assert mine.get_task()["modelName"] == "random"
    finally:
        srv.stop()


def test_rating_round_trip_tallies_to_the_client_result(tmp_path, monkeypatch):
    base = str(tmp_path / "base")
    models = os.path.join(base, "models")
    os.makedirs(models)
    shutil.copytree(TINYNET, os.path.join(models, "tinynet"))
    add_second_model(models)
    played = []

    def run_match(*args, **kwargs):
        played.append(client_module_run_match(*args, **kwargs))
        return played[-1]

    client_module_run_match = client_module.run_match
    monkeypatch.setattr(client_module, "run_match", run_match)
    srv = ContributionServer(base, TCFG, rating_game_prob=1.0, rating_config={"maxVisits": 6, "numRatingGames": 2},
                             rating_seed=0).start()
    try:
        client = ContributeClient(srv.url, str(tmp_path / "cache"), logger=Logger(), seed=0, device="cpu")
        tasks = []
        get_task = client.get_task
        client.get_task = lambda: tasks.append(get_task()) or tasks[-1]
        assert client.run_cycle() == 2
    finally:
        srv.stop()
    (task,) = tasks
    assert task["taskType"] == "rating" and {task["modelBlack"], task["modelWhite"]} == {"tinynet", "tinynet-b"}
    records = collect_results([os.path.join(base, "ratinggames")], device="cpu")
    (result,) = played
    names = {True: task["modelBlack"], False: task["modelWhite"]}  # the match's A is the task's black model
    assert result.games == sum(r[2] + r[3] + r[4] for r in records) == 2
    wins = {name: 0 for name in names.values()}
    for pb, pw, wb, ww, _ in records:
        wins[pb] += wb
        wins[pw] += ww
    assert wins == {names[True]: result.wins_a, names[False]: result.wins_b}
    assert sum(r[4] for r in records) == result.draws


def test_serve_command_answers_as_the_jax_server(tmp_path):
    """`python -m katacoffee_tpu_torch serve` in a subprocess answers a task
    as the JAX server does over the same base dir."""
    base = str(tmp_path / "base")
    os.makedirs(os.path.join(base, "models"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([sys.executable, "-m", "katacoffee_tpu_torch", "serve", "-base-dir", base, "-host",
                             "127.0.0.1", "-port", str(port), "-selfplay-visits", "6", "-parallel-games", "4"],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                reply = fetch(f"http://127.0.0.1:{port}/api/task")
                break
            except urllib.error.URLError:
                assert proc.poll() is None and time.monotonic() < deadline, proc.stdout.read()
                time.sleep(0.2)
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
    jax_srv = JaxServer(base, CFG, selfplay_config=SELFPLAY).start()
    try:
        assert reply == fetch(jax_srv.url + "/api/task")
    finally:
        jax_srv.stop()


def test_contribute_refuses_the_cpu_without_cuda(tmp_path):
    """The client and the `contribute` command run on `cuda` unless the
    caller names the CPU: without a GPU they raise before any request or
    write."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for run in (lambda: ContributeClient("http://127.0.0.1:9", str(tmp_path / "cache")),
                lambda: client_module.main(["-server", "http://127.0.0.1:9", "-cache-dir", str(tmp_path / "c2"),
                                            "-max-cycles", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()
    assert os.listdir(tmp_path) == []
