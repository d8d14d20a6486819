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
