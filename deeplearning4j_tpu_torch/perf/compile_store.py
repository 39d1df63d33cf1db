"""Content-addressed compile store — built kernels as a fleet asset (port
of ``deeplearning4j_tpu/perf/compile_store.py``).

The kernel build cache (``compile_cache.py``) keeps the nvcc-built
libraries across one checkout's processes; this store keeps them across
machines that share a root. Two planes share one fenced root:

- **kernels plane** — ``<root>/<fence>/kernels/`` is the directory
  ``ops/cuda_build.py`` builds into (through ``compile_cache`` when
  ``DL4J_TPU_COMPILE_STORE`` is set), and Triton's cache under it. The
  *fence* directory name bakes in ``(store format, torch + CUDA
  version, device capability)``, where the JAX store bakes in (jaxlib,
  topology): a new toolchain or another card lands in a disjoint
  keyspace, so a library is never loaded on a card or a runtime it was
  not built for. A library found damaged (its size or CRC-32 against the
  record written beside it) is moved to ``kernels/corrupt/`` and built
  again; it is never handed to ``ctypes``.
- **object plane** — ``<root>/<fence>/objects/<sha>.cse`` holds
  first-party content-addressed entries: ``sha = sha256(store_version,
  torch, capability, program fingerprint)``. Entries are single files
  published with the ``resilience/checkpoint.py`` atomic idiom
  (same-dir dotted tmp, fsync, ``os.replace``, dir fsync), so a process
  killed mid-``put`` leaves the old entry or no entry, never a truncated
  one. A torn or corrupt entry found at ``get`` is quarantined to
  ``<fence>/corrupt/`` and reported as a miss (the fallback: build
  again).

Entry layout: ``MAGIC + header-JSON + "\\n" + payload``, the header
carrying ``{store_version, torch, capability, fingerprint, size,
crc32}``; ``get`` re-derives the CRC before returning bytes. A header
whose fence fields differ from the store's is a *fence miss* (another
universe's entry, left alone); a payload that fails size or CRC is
*corruption* (quarantined).
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import zlib
from pathlib import Path
from typing import Any, Dict, Optional

STORE_VERSION = 1
MAGIC = b"DL4JCSE1\n"
ENTRY_SUFFIX = ".cse"
CORRUPT_DIR = "corrupt"
_OFF = ("", "0", "off", "none", "false", "disabled")


def default_torch() -> str:
    """The torch build and its CUDA version: the runtime whose kernels
    the fence isolates."""
    import torch
    return f"{torch.__version__}+cuda{torch.version.cuda or 'none'}"


def default_capability() -> str:
    """The card's compute capability (``sm_90`` on an H100), or ``cpu``
    on a machine without one."""
    import torch
    if not torch.cuda.is_available():
        return "cpu"
    major, minor = torch.cuda.get_device_capability(0)
    return f"sm_{major}{minor}"


def _sanitize(part: str) -> str:
    return "".join(c if (c.isalnum() or c in "._-") else "_"
                   for c in str(part)) or "_"


def program_fingerprint(**parts: Any) -> str:
    """Stable fingerprint of a program's identity: sorted-key JSON of
    whatever the caller considers build-relevant (model config, bucket
    grid, sources, flags...). The hash, not the JSON, is the key."""
    blob = json.dumps(parts, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


class CompileStore:
    """One fence's view of the content-addressed store rooted at
    ``root``. Counters: puts / hits / misses (fence mismatch or absent)
    / quarantined (damaged entries and libraries moved aside)."""

    def __init__(self, root, *, torch_version: Optional[str] = None,
                 capability: Optional[str] = None):
        self.root = Path(os.path.expanduser(str(root)))
        self.torch = (torch_version if torch_version is not None
                      else default_torch())
        self.capability = (capability if capability is not None
                           else default_capability())
        self.fence = (f"v{STORE_VERSION}__torch-{_sanitize(self.torch)}__"
                      f"{_sanitize(self.capability)}")
        self.fence_dir = self.root / self.fence
        self.kernels_dir = self.fence_dir / "kernels"
        self.objects_dir = self.fence_dir / "objects"
        self._lock = threading.Lock()
        self._counters = {"puts": 0, "hits": 0, "misses": 0,
                          "quarantined": 0}
        self.kernels_dir.mkdir(parents=True, exist_ok=True)
        self.objects_dir.mkdir(parents=True, exist_ok=True)

    # -- keys -------------------------------------------------------------
    def key(self, fingerprint: str) -> str:
        blob = json.dumps([STORE_VERSION, self.torch, self.capability,
                           fingerprint], sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()

    def entry_path(self, fingerprint: str) -> Path:
        return self.objects_dir / (self.key(fingerprint) + ENTRY_SUFFIX)

    # -- write ------------------------------------------------------------
    def put(self, fingerprint: str, payload: bytes) -> Path:
        """Publish ``payload`` under ``fingerprint`` atomically: a reader
        (or a crash) sees the old entry, no entry, or the complete new
        one — never a torn one."""
        from deeplearning4j_tpu_torch.resilience.checkpoint import (
            atomic_write_bytes)
        header = {
            "store_version": STORE_VERSION,
            "torch": self.torch,
            "capability": self.capability,
            "fingerprint": fingerprint,
            "size": len(payload),
            "crc32": zlib.crc32(payload) & 0xFFFFFFFF,
        }
        blob = MAGIC + json.dumps(header, sort_keys=True).encode() \
            + b"\n" + payload
        path = atomic_write_bytes(self.entry_path(fingerprint), blob)
        with self._lock:
            self._counters["puts"] += 1
        return Path(path)

    # -- read -------------------------------------------------------------
    def get(self, fingerprint: str) -> Optional[bytes]:
        """Payload bytes, or None (miss). Fence-mismatched entries are
        misses left in place; torn or corrupt entries are quarantined
        and reported as misses — the caller's fallback is always to
        build again."""
        path = self.entry_path(fingerprint)
        try:
            blob = path.read_bytes()
        except OSError:
            with self._lock:
                self._counters["misses"] += 1
            return None
        payload = self._validate(path, blob, fingerprint)
        with self._lock:
            self._counters["hits" if payload is not None
                           else "misses"] += 1
        return payload

    def _validate(self, path: Path, blob: bytes,
                  fingerprint: str) -> Optional[bytes]:
        if not blob.startswith(MAGIC):
            self._quarantine(path, "bad magic")
            return None
        rest = blob[len(MAGIC):]
        nl = rest.find(b"\n")
        if nl < 0:
            self._quarantine(path, "truncated header")
            return None
        try:
            header = json.loads(rest[:nl])
        except ValueError:
            self._quarantine(path, "unparseable header")
            return None
        if (header.get("store_version") != STORE_VERSION
                or header.get("torch") != self.torch
                or header.get("capability") != self.capability
                or header.get("fingerprint") != fingerprint):
            # the version fence: another universe's entry, not damage
            return None
        payload = rest[nl + 1:]
        if len(payload) != header.get("size") or \
                (zlib.crc32(payload) & 0xFFFFFFFF) != header.get("crc32"):
            self._quarantine(path, "size/crc mismatch")
            return None
        return payload

    def _quarantine(self, path: Path, reason: str) -> None:
        """Move a damaged file to ``<fence>/corrupt/`` — out of every
        later lookup, kept for post-mortems (the checkpoint-scan
        idiom)."""
        quarantine(path, self.fence_dir / CORRUPT_DIR)
        self.note_quarantined()

    def note_quarantined(self) -> None:
        """Count one damaged entry or library moved aside."""
        with self._lock:
            self._counters["quarantined"] += 1

    # -- reporting --------------------------------------------------------
    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def stats(self) -> Dict[str, Any]:
        """Disk + in-process view (walks the fence dir — once-per-run
        reporters only)."""
        objects = obj_bytes = 0
        for p in self.objects_dir.glob("*" + ENTRY_SUFFIX):
            objects += 1
            try:
                obj_bytes += p.stat().st_size
            except OSError:
                pass
        kernel_entries, kernel_bytes = walk(self.kernels_dir)
        fences = sorted(p.name for p in self.root.iterdir()
                        if p.is_dir()) if self.root.is_dir() else []
        out: Dict[str, Any] = {
            "root": str(self.root), "fence": self.fence,
            "fences": fences, "objects": objects,
            "object_bytes": obj_bytes, "kernel_entries": kernel_entries,
            "kernel_bytes": kernel_bytes,
        }
        out.update(self.counters())
        return out


def quarantine(path: Path, dest_dir: Path) -> None:
    """Move ``path`` into ``dest_dir`` without clobbering earlier
    evidence (a second file of the same name takes the pid as a
    suffix); when the move fails, at least take it out of the scan."""
    import shutil
    try:
        dest_dir.mkdir(parents=True, exist_ok=True)
        dest = dest_dir / path.name
        if dest.exists():
            dest = dest_dir / f"{path.name}.{os.getpid()}"
        shutil.move(str(path), str(dest))
    except OSError:
        try:
            path.unlink()
        except OSError:
            return


def walk(d) -> tuple:
    """(files, bytes) under directory ``d`` (0, 0 when it is absent);
    lock files and quarantined evidence are not entries."""
    entries = size = 0
    if d is None or not os.path.isdir(d):
        return 0, 0
    for root, dirs, files in os.walk(d):
        dirs[:] = [x for x in dirs if x != CORRUPT_DIR]
        for f in files:
            if f.endswith(".lock"):
                continue
            entries += 1
            try:
                size += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return entries, size


def from_env() -> Optional[CompileStore]:
    """Store from ``DL4J_TPU_COMPILE_STORE`` (None when unset/off)."""
    from deeplearning4j_tpu_torch import environment
    root = environment.get_flag("DL4J_TPU_COMPILE_STORE")
    if not root or str(root).strip().lower() in _OFF:
        return None
    return CompileStore(root)
