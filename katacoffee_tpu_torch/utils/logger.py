"""Multi-sink timestamped logger: the port's copy of
`katacoffee_tpu/utils/logger.py` `Logger` (the reference's
`cpp/core/logger.{h,cpp}`, logger.h:13). Each line is timestamped and goes
to every added file and, optionally, stdout and stderr; writes are
thread-safe."""

from __future__ import annotations

import datetime
import io
import sys
import threading


class Logger:
    def __init__(self, log_to_stdout: bool = False, log_to_stderr: bool = False):
        self._lock = threading.Lock()
        self._files: list[io.TextIOBase] = []
        self._stdout = log_to_stdout
        self._stderr = log_to_stderr

    def add_file(self, path: str):
        f = open(path, "a", buffering=1)
        with self._lock:
            self._files.append(f)
        return f

    @classmethod
    def from_config(cls, cfg, default_to_stdout: bool = False, default_to_stderr: bool = False) -> "Logger":
        """A logger from the reference's config keys (`Logger(&cfg,...)`,
        cpp/core/logger.cpp), as the JAX package's `Logger.from_config`:
        `logFile` one exact file; `logDir` one timestamped file per run in
        the dir; `logDirDated` the same under a YYYY-MM-DD subdir;
        `logToStdout` / `logToStderr` echo every line. logTimeStamp and
        logConfigContents are read and ignored (timestamps are always on)."""
        import os

        logger = cls(
            log_to_stdout=cfg.get_bool("logToStdout", default_to_stdout),
            log_to_stderr=cfg.get_bool("logToStderr", default_to_stderr),
        )
        cfg.get_bool("logTimeStamp", True)
        cfg.get_bool("logConfigContents", True)
        now = datetime.datetime.now()
        stamp = now.strftime("%Y%m%d-%H%M%S") + f"-{os.getpid()}"
        if cfg.contains("logFile"):
            logger.add_file(cfg.get_string("logFile"))
        if cfg.contains("logDir"):
            d = cfg.get_string("logDir")
            os.makedirs(d, exist_ok=True)
            logger.add_file(os.path.join(d, f"log{stamp}.log"))
        if cfg.contains("logDirDated"):
            d = os.path.join(cfg.get_string("logDirDated"), now.strftime("%Y-%m-%d"))
            os.makedirs(d, exist_ok=True)
            logger.add_file(os.path.join(d, f"log{stamp}.log"))
        return logger

    def __getstate__(self) -> dict:
        """A logger sent to another process (a spawned rank) keeps its
        sinks: the files are opened again there, for appending."""
        with self._lock:
            return {"paths": [f.name for f in self._files], "stdout": self._stdout, "stderr": self._stderr}

    def __setstate__(self, state: dict) -> None:
        self.__init__(state["stdout"], state["stderr"])
        for path in state["paths"]:
            self.add_file(path)

    def write(self, msg: str):
        stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S%z")
        line = f"{stamp}: {msg}\n"
        with self._lock:
            for f in self._files:
                f.write(line)
            if self._stdout:
                sys.stdout.write(line)
                sys.stdout.flush()
            if self._stderr:
                sys.stderr.write(line)
                sys.stderr.flush()

    def close(self):
        with self._lock:
            for f in self._files:
                f.close()
            self._files = []
