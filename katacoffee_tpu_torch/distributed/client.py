"""Contribute client: volunteer selfplay against a training server, the port
of `katacoffee_tpu/distributed/client.py` (the reference's
`Client::Connection` and `MainCmds::contribute`, cpp/distributed/client.h:71-130,
cpp/command/contribute.cpp:1051-1080).

A cycle polls the server for a task, downloads the model unless it is
cached, plays on the GPU and uploads: a selfplay task is one
`run_selfplay_segment` of B games whose rows go up as one npz shard and
whose finished games go up as one SGF each; a rating task is a batched
match between two models whose SGFs go to `/api/ratinggames`. Network
errors are retried with backoff (the core/throttle.h role).

Randomness: the client draws from one `torch.Generator` on its device,
seeded by `seed` (JAX splits `PRNGKey(seed)`, a stream torch cannot
reproduce, so the two packages play different games for one seed).
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from katacoffee_tpu_torch.command.selfplay import extract_episodes
from katacoffee_tpu_torch.dataio.checkpoints import is_complete_model_dir, load_exported_model
from katacoffee_tpu_torch.dataio.sgf import write_sgf
from katacoffee_tpu_torch.dataio.trainingwrite import batch_to_arrays
from katacoffee_tpu_torch.device import resolve_device
from katacoffee_tpu_torch.game.board import GameConfig, init_state
from katacoffee_tpu_torch.program.match import match_sgfs, run_match
from katacoffee_tpu_torch.search.mcts import make_nn_eval_fn, uniform_eval_fn
from katacoffee_tpu_torch.search.params import SearchParams
from katacoffee_tpu_torch.selfplay.actor import SelfplaySettings, finalize_targets, run_selfplay_segment
from katacoffee_tpu_torch.utils.logger import Logger


class ContributeClient:
    def __init__(self, server_url: str, cache_dir: str, logger: Logger | None = None, seed: int = 0,
                 max_retries: int = 5, cafile: str | None = None, *, device: str | torch.device | None = None):
        """A client of the server at `server_url` that caches models in
        `cache_dir` and plays on `device` (default `cuda`). `cafile` pins a
        self-hosted HTTPS server's certificate (the system's CA bundle
        otherwise)."""
        self.device = resolve_device(device)
        self.url = server_url.rstrip("/")
        self.cache_dir = cache_dir
        self.logger = logger or Logger(log_to_stdout=True)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.max_retries = max_retries
        self._ssl_ctx = None
        if self.url.startswith("https"):
            import ssl

            self._ssl_ctx = ssl.create_default_context(cafile=cafile)
        os.makedirs(cache_dir, exist_ok=True)

    def _request(self, path: str, data: bytes | None = None) -> bytes:
        """GET `path` (POST with `data`), retried with backoff (1, 2, 4, ...
        up to 30 s) `max_retries` times (contribute.cpp:1063)."""
        last = None
        for attempt in range(self.max_retries):
            try:
                req = urllib.request.Request(self.url + path, data=data)
                with urllib.request.urlopen(req, timeout=60, context=self._ssl_ctx) as r:
                    return r.read()
            except (urllib.error.URLError, OSError, TimeoutError) as e:
                last = e
                wait = min(2.0**attempt, 30.0)
                self.logger.write(f"contribute: {path} failed ({e}); retry in {wait:.0f}s")
                time.sleep(wait)
        raise RuntimeError(f"contribute: giving up on {path}: {last}")

    def get_task(self) -> dict:
        return json.loads(self._request("/api/task").decode())

    def ensure_model(self, name: str) -> str | None:
        """The cached model dir, downloaded first unless present (each file
        written tmp -> rename); None for "random"."""
        if name == "random":
            return None
        model_dir = os.path.join(self.cache_dir, name)
        if is_complete_model_dir(model_dir):
            return model_dir
        os.makedirs(model_dir, exist_ok=True)
        for fname in ("model.json", "model.npz"):
            data = self._request(f"/api/model/{name}/{fname}")
            tmp = os.path.join(model_dir, "." + fname + ".tmp")
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, os.path.join(model_dir, fname))
        self.logger.write(f"contribute: downloaded model {name}")
        return model_dir

    def _eval_fn(self, cfg: GameConfig, name: str, symmetry_randomize: bool):
        model_dir = self.ensure_model(name)
        if model_dir is None:
            return uniform_eval_fn(cfg)
        model = load_exported_model(model_dir, self.device)[0]
        return make_nn_eval_fn(cfg, model, symmetry_randomize=symmetry_randomize,
                               generator=self.generator if symmetry_randomize else None)

    def run_cycle(self, moves_per_segment: int = 64, batch_size: int | None = None) -> int:
        """Poll a task, do the work, upload (JAX client.py:87). A selfplay
        task returns the rows uploaded, a rating task the games played."""
        task = self.get_task()
        cfg = GameConfig(task["xSize"], task["ySize"], task["winLen"])
        conf = task.get("config", {})
        if task.get("taskType") == "rating":
            return self._run_rating_task(task, cfg, conf, batch_size)
        name = task["modelName"]
        B = batch_size or int(conf.get("numParallelGames", 64))
        visits = int(conf.get("maxVisits", 600))
        # the local daemon's evaluation: a random symmetry per evaluation
        eval_fn = self._eval_fn(cfg, name, symmetry_randomize=True)

        settings = SelfplaySettings(num_sims=visits)
        dev = self.device
        _, _, traj = run_selfplay_segment(cfg, SearchParams.for_selfplay(), settings, eval_fn, init_state(cfg, B, dev),
                                          torch.zeros((B,), dtype=torch.int64, device=dev), moves_per_segment,
                                          device=dev, generator=self.generator)
        arrays = batch_to_arrays(finalize_targets(cfg, settings, traj), cfg)
        rows = int(arrays["weight"].shape[0])
        if rows > 0:
            buf = io.BytesIO()
            np.savez_compressed(buf, **arrays)
            self._request(f"/api/games/{name}", data=buf.getvalue())
        for moves, winner in extract_episodes(cfg, traj):
            text = write_sgf(cfg.x_size, cfg.y_size, cfg.win_len, moves, name, name, winner=winner)
            self._request(f"/api/sgfs/{name}", data=(text + "\n").encode())
        self.logger.write(f"contribute: uploaded {rows} rows for model {name}")
        return rows

    def _run_rating_task(self, task: dict, cfg: GameConfig, conf: dict, batch_size: int | None) -> int:
        """A server-assigned rating match (JAX client.py:132): a batched
        match with colors alternated over the games, each SGF's PB/PW the
        colors actually played, uploaded for the server's Elo fit."""
        name_b, name_w = task["modelBlack"], task["modelWhite"]
        games = batch_size or int(conf.get("numRatingGames", 8))
        visits = int(conf.get("maxVisits", 150))
        evals = {name: self._eval_fn(cfg, name, symmetry_randomize=False) for name in (name_b, name_w)}
        # pure strength: no root noise, slight opening variety, as the
        # gatekeeper plays
        sp = dataclasses.replace(SearchParams.for_selfplay(), rootNoiseEnabled=False,
                                 rootDesiredPerChildVisitsCoeff=0.0, chosenMoveTemperature=0.0,
                                 chosenMoveTemperatureEarly=0.3)
        seed = int(torch.randint(0, 2**31 - 1, (), generator=self.generator, device=self.device))
        result = run_match(cfg, sp, sp, evals[name_b], evals[name_w], num_games=games, num_visits=visits, seed=seed,
                           record_moves=True, device=self.device)
        for text in match_sgfs(cfg, result, name_b, name_w):
            self._request("/api/ratinggames", data=(text + "\n").encode())
        self.logger.write(f"contribute: rating {name_b} vs {name_w}: {result.wins_a}-{result.wins_b}-{result.draws} "
                          f"({result.games} games)")
        return result.games

    def run(self, max_cycles: int | None = None) -> None:
        n = 0
        while max_cycles is None or n < max_cycles:
            self.run_cycle()
            n += 1


def main(argv, *, device: str | torch.device | None = None) -> None:
    """Entry for `python -m katacoffee_tpu_torch contribute` (JAX
    client.py:189): the same flags, playing on `device` (default `cuda`)."""
    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch contribute")
    ap.add_argument("-server", required=True, help="training server URL")
    ap.add_argument("-cache-dir", default=os.path.expanduser("~/.cache/katacoffee_tpu/models"))
    ap.add_argument("-max-cycles", type=int, default=None)
    ap.add_argument("-seed", type=int, default=0)
    ap.add_argument("-cafile", default=None, help="CA bundle pinning a self-hosted HTTPS server")
    args = ap.parse_args(argv)
    ContributeClient(args.server, args.cache_dir, seed=args.seed, cafile=args.cafile, device=device).run(
        args.max_cycles)


def main_serve(argv, *, device: str | torch.device | None = None) -> None:
    """Entry for `python -m katacoffee_tpu_torch serve` (JAX client.py:207):
    the same flags. The server plays nothing, so `device` is not used."""
    from katacoffee_tpu_torch.distributed.server import ContributionServer

    ap = argparse.ArgumentParser(prog="katacoffee_tpu_torch serve")
    ap.add_argument("-base-dir", required=True)
    ap.add_argument("-host", default="0.0.0.0")
    ap.add_argument("-port", type=int, default=8088)
    ap.add_argument("-rating-game-prob", type=float, default=0.0,
                    help="fraction of tasks that are model-vs-model rating matches")
    ap.add_argument("-rating-visits", type=int, default=150)
    ap.add_argument("-rating-games", type=int, default=8)
    ap.add_argument("-certfile", default=None, help="serve HTTPS with this certificate")
    ap.add_argument("-keyfile", default=None)
    ap.add_argument("-selfplay-visits", type=int, default=600)
    ap.add_argument("-parallel-games", type=int, default=64)
    args = ap.parse_args(argv)
    server = ContributionServer(
        args.base_dir, GameConfig(5, 5, 4), host=args.host, port=args.port,
        selfplay_config={"maxVisits": args.selfplay_visits, "numParallelGames": args.parallel_games},
        rating_game_prob=args.rating_game_prob,
        rating_config={"maxVisits": args.rating_visits, "numRatingGames": args.rating_games},
        certfile=args.certfile, keyfile=args.keyfile,
    )
    print(f"serving contribution bus for {args.base_dir} at {server.url}", flush=True)
    server.serve_forever()
