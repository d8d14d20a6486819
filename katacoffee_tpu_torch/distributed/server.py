"""Training-server side of the contribution bus: the port of
`katacoffee_tpu/distributed/server.py` over the standard library's HTTP
server, with the same endpoints, bodies, status codes and upload layout, so
the JAX package's client and the port's talk to either server.

Endpoints (the reference client's needs, client.h:95-130, as plain HTTP):
  GET  /api/task            -> selfplay task {"run", "modelName", config} or,
                            with probability rating_game_prob when >= 2
                            complete models exist, a rating task
                            {"taskType": "rating", "modelBlack",
                            "modelWhite", config} (contribute.cpp:128,188,974)
  GET  /api/model/<name>/model.npz   (and /model.json)
  POST /api/games/<model>   body = one npz training shard -> stored under
                            <base>/selfplay/<model>/tdata/
  POST /api/sgfs/<model>    body = one SGF -> <base>/selfplay/<model>/sgfs/
  POST /api/ratinggames     body = one SGF (PB/PW = model names) ->
                            <base>/ratinggames/ for the Elo summarizer

Uploads get random server-side names (several contributors at once) and are
written tmp -> rename. Rating tasks are drawn from `random.Random(rating_seed)`,
so one seed gives the JAX server's tasks. `certfile`/`keyfile` serve HTTPS.
"""

from __future__ import annotations

import json
import os
import random
import secrets
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from katacoffee_tpu_torch.dataio.checkpoints import find_latest_model

MAX_UPLOAD = 256 * 1024 * 1024


class ContributionServer:
    def __init__(self, base_dir: str, cfg, host: str = "127.0.0.1", port: int = 0,
                 selfplay_config: dict | None = None, run_name: str = "run",
                 rating_game_prob: float = 0.0, rating_config: dict | None = None,
                 rating_seed: int | None = None,
                 certfile: str | None = None, keyfile: str | None = None):
        self.base_dir = base_dir
        self.cfg = cfg
        self.run_name = run_name
        self.selfplay_config = selfplay_config or {"maxVisits": 600, "numParallelGames": 64}
        # rating games: the reference's server hands volunteers model-vs-model
        # match tasks alongside selfplay (contribute.cpp:128); latest model vs
        # a uniformly random earlier one, colors assigned by the server
        self.rating_game_prob = rating_game_prob
        self.rating_config = rating_config or {"maxVisits": 150, "numRatingGames": 8}
        self._rating_rng = random.Random(rating_seed)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _json(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parts = [p for p in self.path.split("/") if p]
                if parts == ["api", "task"]:
                    rating = outer._maybe_rating_task()
                    if rating is not None:
                        self._json(200, rating)
                        return
                    model_dir = find_latest_model(os.path.join(outer.base_dir, "models"))
                    name = os.path.basename(model_dir) if model_dir else "random"
                    self._json(200, {
                        "run": outer.run_name,
                        "taskType": "selfplay",
                        "modelName": name,
                        "xSize": outer.cfg.x_size,
                        "ySize": outer.cfg.y_size,
                        "winLen": outer.cfg.win_len,
                        "config": outer.selfplay_config,
                    })
                    return
                if len(parts) == 4 and parts[:2] == ["api", "model"]:
                    name, fname = parts[2], parts[3]
                    if fname not in ("model.npz", "model.json") or "/" in name or ".." in name:
                        self._json(404, {"error": "bad path"})
                        return
                    path = os.path.join(outer.base_dir, "models", name, fname)
                    if not os.path.isfile(path):
                        self._json(404, {"error": "no such model"})
                        return
                    with open(path, "rb") as f:
                        data = f.read()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                self._json(404, {"error": "unknown endpoint"})

            def do_POST(self):
                parts = [p for p in self.path.split("/") if p]
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0 or length > MAX_UPLOAD:
                    self._json(400, {"error": "bad length"})
                    return
                body = self.rfile.read(length)
                if parts == ["api", "ratinggames"]:
                    out_dir = os.path.join(outer.base_dir, "ratinggames")
                    os.makedirs(out_dir, exist_ok=True)
                    name = f"rating_{secrets.token_hex(8)}.sgf"
                    tmp = os.path.join(out_dir, "." + name + ".tmp")
                    with open(tmp, "wb") as f:
                        f.write(body)
                    os.replace(tmp, os.path.join(out_dir, name))
                    self._json(200, {"stored": name})
                    return
                if len(parts) == 3 and parts[0] == "api" and parts[1] in ("games", "sgfs"):
                    model = parts[2]
                    if "/" in model or ".." in model or not model:
                        self._json(400, {"error": "bad model name"})
                        return
                    sub = "tdata" if parts[1] == "games" else "sgfs"
                    ext = ".npz" if parts[1] == "games" else ".sgf"
                    out_dir = os.path.join(outer.base_dir, "selfplay", model, sub)
                    os.makedirs(out_dir, exist_ok=True)
                    name = f"contrib_{secrets.token_hex(8)}{ext}"
                    tmp = os.path.join(out_dir, "." + name + ".tmp")
                    with open(tmp, "wb") as f:
                        f.write(body)
                    os.replace(tmp, os.path.join(out_dir, name))
                    self._json(200, {"stored": name})
                    return
                self._json(404, {"error": "unknown endpoint"})

        self._server = ThreadingHTTPServer((host, port), Handler)
        # HTTPS (the reference bus is HTTPS-only, distributed/client.cpp +
        # mozilla CA bundle); pass a cert/key pair to serve TLS directly, or
        # terminate TLS at a reverse proxy in front of the plain server
        self.tls = certfile is not None
        if self.tls:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile, keyfile)
            self._server.socket = ctx.wrap_socket(self._server.socket, server_side=True)
        self.host, self.port = self._server.server_address[:2]
        self._thread: threading.Thread | None = None

    def _maybe_rating_task(self) -> dict | None:
        """With probability rating_game_prob (and >=2 complete models on
        disk), assign a model-vs-model rating match: the latest model against
        a uniformly random earlier one, colors randomized by the server —
        contribute.cpp:128's selfplay/rating task split."""
        if self.rating_game_prob <= 0:
            return None
        if self._rating_rng.random() >= self.rating_game_prob:
            return None
        models_dir = os.path.join(self.base_dir, "models")
        try:
            names = sorted(
                d for d in os.listdir(models_dir)
                if os.path.isfile(os.path.join(models_dir, d, "model.npz"))
                and os.path.isfile(os.path.join(models_dir, d, "model.json"))
            )
        except OSError:
            return None
        if len(names) < 2:
            return None
        # pick latest among COMPLETE models only (an export writes model.npz
        # before model.json; find_latest_model could name the half-written
        # dir and crash the volunteer's download)
        latest = max(
            names, key=lambda n: os.path.getmtime(os.path.join(models_dir, n, "model.npz"))
        )
        other = self._rating_rng.choice([n for n in names if n != latest])
        black, white = (latest, other) if self._rating_rng.random() < 0.5 else (other, latest)
        return {
            "run": self.run_name,
            "taskType": "rating",
            "modelBlack": black,
            "modelWhite": white,
            "xSize": self.cfg.x_size,
            "ySize": self.cfg.y_size,
            "winLen": self.cfg.win_len,
            "config": self.rating_config,
        }

    @property
    def url(self) -> str:
        return f"http{'s' if self.tls else ''}://{self.host}:{self.port}"

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        if self._thread:
            self._thread.join(timeout=5)

    def serve_forever(self):
        self._server.serve_forever()
