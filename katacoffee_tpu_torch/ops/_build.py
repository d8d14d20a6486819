"""Builds the port's CUDA sources into shared libraries at first use.

Each `.cu` file has a plain C interface and includes no PyTorch header, so
`nvcc` compiles it in seconds and `ctypes` loads it. The library lands in
`katacoffee_tpu_torch/_build/` under a name that carries a hash of the source
and the flags, so an edited source is rebuilt. Nothing but the sources in the
package and the CUDA toolkit is needed.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# --fmad=false: each float multiply and add rounds on its own, as in the
# torch ops a kernel is held to bit for bit. -Xptxas=-v: the register and
# spill counts go to the build log.
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a", "--fmad=false",
    "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


def build_log(source: Path) -> str:
    """The compiler's output from building `source`'s library ("" if it
    has not been built here)."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load_library(source: Path) -> ctypes.CDLL:
    """Compile `source` unless its library exists, then load it. Raises
    RuntimeError with the compiler's output if the build fails."""
    lib = library_path(source)
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # one temporary name per thread: threads of one process may build the
        # same source at once (two checkouts whose kernel sources are equal)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) for {source.name}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))
