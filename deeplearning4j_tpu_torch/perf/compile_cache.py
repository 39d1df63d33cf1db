"""The kernel build cache — built kernels survive the process (port of
``deeplearning4j_tpu/perf/compile_cache.py``).

The JAX package keeps XLA's executables in a persistent cache directory.
The port's counterpart of that cache is the directory its hand-written
kernels are built into: ``ops/cuda_build.py`` compiles each CUDA source
with ``nvcc`` into a library keyed by a hash of its sources, headers and
flags, and loads it from there; Triton compiles its kernels into its own
cache. This module routes both, in this order of precedence:

1. ``DL4J_TPU_COMPILE_STORE`` (``perf/compile_store.py``): the store's
   fenced ``kernels/`` plane;
2. ``DL4J_TPU_COMPILE_CACHE``, when set in the environment: that
   directory ('' / '0' / 'off' / 'none' leave the default);
3. the default, the package's own ``_build/`` directory (listed in
   ``.gitignore``).

Triton's cache is the ``triton/`` directory under the active one
(``TRITON_CACHE_DIR``, set before the first Triton launch, unless the
caller set it). Restarts and every process of a checkout (the serving
workers, the gloo ranks of the tests) reuse each other's builds.

The JAX cache's eligibility floors (``DL4J_TPU_COMPILE_CACHE_MIN_BYTES``,
``_MIN_SECS``) have no counterpart: every nvcc build is kept. The
counters: a *request* is a library load, a *hit* a library found built
(and whole), a *miss* an nvcc run. :func:`counters` reads them without
touching the disk; :func:`cache_stats` walks the directory.
"""
from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Any, Dict, Optional

_LOCK = threading.Lock()
_state: Dict[str, Any] = {
    "configured": False,     # configure() ran (lazily, at the first build)
    "dir": None,             # active cache dir (None -> the default)
    "store": None,           # CompileStore when routed through one
    "requests": 0,           # library loads
    "hits": 0,               # libraries found built
}

_DISABLED = {"", "0", "off", "none", "false", "disabled"}
#: the package's own build directory, used when no cache is configured
DEFAULT_DIR = Path(__file__).resolve().parents[1] / "_build"


def configure(cache_dir: Optional[str] = None) -> Optional[str]:
    """Route kernel builds to ``cache_dir`` (created if missing), or,
    when it is None, by the flags (the store first, then
    ``DL4J_TPU_COMPILE_CACHE``). Returns the active dir, or None when
    builds go to the default ``_build/``. Safe to call repeatedly: each
    later build and load uses the dir set last."""
    from deeplearning4j_tpu_torch import environment
    store = None
    if cache_dir is None:
        from deeplearning4j_tpu_torch.perf import compile_store
        store = compile_store.from_env()
        if store is not None:
            cache_dir = str(store.kernels_dir)
        elif "DL4J_TPU_COMPILE_CACHE" in os.environ:
            # the flag's default is the JAX package's XLA cache dir: only
            # a value set in the environment routes the builds
            cache_dir = environment.get_flag("DL4J_TPU_COMPILE_CACHE")
    if cache_dir is None or str(cache_dir).strip().lower() in _DISABLED:
        with _LOCK:
            _state.update(configured=True, dir=None, store=None)
        return None
    cache_dir = os.path.expanduser(str(cache_dir))
    os.makedirs(cache_dir, exist_ok=True)
    with _LOCK:
        _state.update(configured=True, dir=cache_dir, store=store)
    return cache_dir


def configure_from_env() -> Optional[str]:
    """Configure entirely from the flags, never raise: an unwritable
    cache dir degrades to the default build dir, not an error."""
    try:
        return configure()
    except Exception:
        with _LOCK:
            _state.update(configured=True, dir=None, store=None)
        return None


def active_store():
    """The :class:`~deeplearning4j_tpu_torch.perf.compile_store.
    CompileStore` the builds are routed through, or None."""
    return _state["store"]


def cache_dir() -> Optional[str]:
    """The configured cache dir (configured from the flags at the first
    call), or None: builds go to the default ``_build/``."""
    if not _state["configured"]:
        configure_from_env()
    return _state["dir"]


def build_dir() -> Path:
    """Where ``ops/cuda_build.py`` builds and loads libraries."""
    d = cache_dir()
    return Path(d) if d is not None else DEFAULT_DIR


def prepare_triton() -> None:
    """Point Triton's cache at ``<build dir>/triton`` before its first
    compile (a ``TRITON_CACHE_DIR`` the caller set stays)."""
    if "TRITON_CACHE_DIR" not in os.environ:
        os.environ["TRITON_CACHE_DIR"] = str(build_dir() / "triton")


def note_load(hit: bool) -> None:
    """Count one library load: found built (``hit``) or built by nvcc."""
    with _LOCK:
        _state["requests"] += 1
        _state["hits"] += bool(hit)


def counters() -> Dict[str, int]:
    """In-process request/hit counters only — no disk walk, so safe on
    a per-iteration path (``cache_stats`` walks the directory)."""
    with _LOCK:
        requests, hits = _state["requests"], _state["hits"]
    return {"compile_requests": requests, "persistent_hits": hits,
            "persistent_misses": max(0, requests - hits)}


def cache_stats() -> Dict[str, Any]:
    """On-disk and in-process view of the build cache: the directory
    builds go to, whether a cache was configured, its files and bytes,
    and this process's library loads against the libraries found built
    (misses = requests - hits: an nvcc run another process can now
    skip)."""
    from deeplearning4j_tpu_torch.perf.compile_store import walk
    d = build_dir()
    entries, size = walk(d)
    with _LOCK:
        requests, hits = _state["requests"], _state["hits"]
        store = _state["store"]
    out = {
        "dir": str(d),
        "enabled": _state["dir"] is not None,
        "entries": entries,
        "bytes": size,
        "compile_requests": requests,
        "persistent_hits": hits,
        "persistent_misses": max(0, requests - hits),
    }
    if store is not None:
        out["store_fence"] = store.fence
        out["store"] = store.counters()
    return out


def reset_counters() -> None:
    with _LOCK:
        _state["requests"] = _state["hits"] = 0
