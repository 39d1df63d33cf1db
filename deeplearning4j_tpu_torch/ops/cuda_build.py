"""Build and load the port's CUDA C++ kernels.

Each library is compiled by ``nvcc`` into a shared object with a plain C
interface and loaded with ``ctypes`` (no PyTorch headers: a build takes
seconds, not minutes). The build runs at first use, into the directory
``perf/compile_cache.py`` names (the compile store's ``kernels/`` plane,
``DL4J_TPU_COMPILE_CACHE``, or by default
``deeplearning4j_tpu_torch/_build/``, listed in ``.gitignore``), under a
file name keyed by a hash of the sources, the shared headers and the
flags, so an edited source or header never loads a stale library. Beside
each library a record of its size and CRC-32 is published after it; a
library that does not match its record (torn, damaged, or left without
one) is quarantined to ``corrupt/`` and built again, never handed to
``ctypes``. Every load counts as a request of the build cache, and finds
the library built (a hit) or runs nvcc (a miss). A thread lock and an
``fcntl`` file lock serialise the build: the serving gateway's worker
thread may be the first caller, and several processes may share one
directory.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import os
import shutil
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Dict, Sequence

from deeplearning4j_tpu_torch.perf import compile_cache

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
#: the build directory when no cache is configured
BUILD_DIR = compile_cache.DEFAULT_DIR

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
    """Hash of the flags, the sources and every header under ``csrc/``
    (a source may include any of them)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _record(path: Path) -> Path:
    return path.with_suffix(".json")


def _whole(path: Path) -> bool:
    """Whether the library at ``path`` matches the size and CRC-32
    recorded beside it when it was built."""
    try:
        rec = json.loads(_record(path).read_text())
        blob = path.read_bytes()
    except (OSError, ValueError):
        return False
    return (len(blob) == rec.get("size")
            and zlib.crc32(blob) & 0xFFFFFFFF == rec.get("crc32"))


def build(name: str, sources: Sequence[str]) -> Path:
    """Compile ``sources`` (file names under ``csrc/``) into
    ``<build dir>/<name>-<hash>.so`` unless it is there whole; returns
    its path. The compiler's report (registers, shared memory, spills
    per kernel) is kept beside it as ``.log``."""
    from deeplearning4j_tpu_torch.perf.compile_store import (CORRUPT_DIR,
                                                             quarantine)
    from deeplearning4j_tpu_torch.resilience.checkpoint import (
        atomic_write_bytes)
    srcs = [CSRC_DIR / s for s in sources]
    configured = compile_cache.cache_dir()
    build_dir = Path(configured) if configured is not None else BUILD_DIR
    build_dir.mkdir(parents=True, exist_ok=True)
    out = build_dir / f"{name}-{_key(srcs)}.so"
    with open(build_dir / f"{name}.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if out.exists():
            if _whole(out):
                compile_cache.note_load(hit=True)
                return out
            for p in (out, _record(out)):
                if p.exists():
                    quarantine(p, build_dir / CORRUPT_DIR)
            store = compile_cache.active_store()
            if store is not None:
                store.note_quarantined()
        compile_cache.note_load(hit=False)
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
        blob = out.read_bytes()
        atomic_write_bytes(_record(out), json.dumps(
            {"size": len(blob),
             "crc32": zlib.crc32(blob) & 0xFFFFFFFF}).encode())
    return out


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """The loaded library ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name, sources)))
        return lib
