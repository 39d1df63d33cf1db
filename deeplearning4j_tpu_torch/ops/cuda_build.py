"""Build and load the port's CUDA C++ kernels.

Each library is compiled by ``nvcc`` into a shared object with a plain C
interface and loaded with ``ctypes`` (no PyTorch headers: a build takes
seconds, not minutes). The build runs at first use, into
``deeplearning4j_tpu_torch/_build/`` (listed in ``.gitignore``), under a
file name keyed by a hash of the sources and flags, so an edited source
never loads a stale library. A thread lock and an ``fcntl`` file lock
serialise the build: the serving gateway's worker thread may be the
first caller, and several processes may share one checkout.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "deeplearning4j_tpu_torch are built on a "
                           "machine with the CUDA toolkit")
    return path


def _key(sources: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(name: str, sources: Sequence[str]) -> Path:
    """Compile ``sources`` (file names under ``csrc/``) into
    ``_build/<name>-<hash>.so`` unless it exists; returns its path. The
    compiler's report (registers, shared memory, spills per kernel) is
    kept beside it as ``.log``."""
    srcs = [CSRC_DIR / s for s in sources]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{name}-{_key(srcs)}.so"
    with open(BUILD_DIR / f"{name}.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               *map(str, srcs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        out.with_suffix(".log").write_text(
            " ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed building {name}:\n"
                               f"{res.stderr[-4000:]}")
        os.replace(tmp, out)
    return out


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """The loaded library ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name, sources)))
        return lib
