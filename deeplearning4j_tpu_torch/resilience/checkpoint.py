"""Checkpoint pipeline, write half (port of the first part of
``deeplearning4j_tpu/resilience/checkpoint.py``): atomic writes and
verification.

- **Atomic publication.** :func:`atomic_write_bytes` and the
  tmp + fsync + ``os.replace`` protocol of
  ``ModelSerializer.write_model``: the final path holds either the old
  complete checkpoint or the new complete one, never a torn file.
- **Verification.** :func:`verify_checkpoint` proves a zip checkpoint
  restorable before anyone restores it: the zip's central directory and
  per-entry CRC sweep, the required entries, a parseable ``meta.json``
  and — when the sidecar manifest exists — the whole file's CRC32, size
  and format version.
- **Manifest.** :func:`write_manifest` publishes
  ``<ckpt>.manifest.json`` (CRC32, size, format version, counters) after
  the checkpoint itself; a crash between the two leaves a valid
  checkpoint whose verification falls back to the zip-level checks.

The format is the JAX package's, so a checkpoint written by either
package verifies in the other. Quarantine, the newest-valid fallback and
the sharded (orbax) path come with ROADMAP A14.
"""
from __future__ import annotations

import json
import os
import zipfile
import zlib
from pathlib import Path
from typing import Dict, Optional, Tuple

#: bumped when the checkpoint layout changes incompatibly; recorded in
#: both the zip's meta.json and the sidecar manifest
FORMAT_VERSION = 1

#: entries a ModelSerializer zip must contain to be restorable
REQUIRED_ENTRIES = ("configuration.json", "params.npz", "meta.json")


def fsync_dir(path) -> None:
    """Flush a directory entry table — after ``os.replace`` this makes
    the rename itself durable (best-effort: not every platform/FS
    supports opening a directory)."""
    try:
        fd = os.open(os.fspath(path), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def tmp_path_for(path: Path) -> Path:
    """Same-directory tmp name for the atomic protocol. Dot-prefixed
    and ``.zip``-free so no ``checkpoint_*.zip`` glob (or mtime scan)
    can ever select an in-progress file."""
    return path.with_name(f".{path.name}.tmp-{os.getpid()}")


def atomic_write_bytes(path, data: bytes) -> Path:
    """Write ``data`` to ``path`` atomically: same-dir tmp file, fsync,
    ``os.replace``, directory fsync."""
    path = Path(path)
    tmp = tmp_path_for(path)
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    fsync_dir(path.parent)
    return path


def file_crc32(path) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def manifest_path(ckpt) -> Path:
    ckpt = Path(ckpt)
    return ckpt.with_name(ckpt.name + ".manifest.json")


def write_manifest(ckpt, extra: Optional[Dict] = None,
                   crc32: Optional[int] = None) -> Path:
    """Publish the sidecar manifest for an already-published checkpoint
    (atomic in its own right; losing it only downgrades verification
    to the zip-level checks). ``crc32``: the CRC32 of the bytes just
    written — passing it skips re-reading the whole checkpoint."""
    ckpt = Path(ckpt)
    m = {"file": ckpt.name,
         "format_version": FORMAT_VERSION,
         "size": ckpt.stat().st_size,
         "crc32": file_crc32(ckpt) if crc32 is None else int(crc32)}
    if extra:
        m.update(extra)
    return atomic_write_bytes(manifest_path(ckpt),
                              (json.dumps(m, indent=1) + "\n").encode())


def verify_checkpoint(path) -> Tuple[bool, str]:
    """Is this zip checkpoint restorable? Returns ``(ok, reason)`` —
    never raises. Checks, cheapest first: file present/non-empty,
    manifest CRC32+size+version (when the sidecar exists), zip central
    directory, per-entry CRC sweep, required entries, meta.json
    parseable."""
    path = Path(path)
    try:
        if not path.is_file():
            return False, "missing"
        if path.stat().st_size == 0:
            return False, "empty file"
        mpath = manifest_path(path)
        if mpath.is_file():
            try:
                m = json.loads(mpath.read_text())
            except (OSError, ValueError):
                m = None            # torn manifest: fall back to zip checks
            if m is not None:
                if int(m.get("format_version", FORMAT_VERSION)) > \
                        FORMAT_VERSION:
                    return False, (f"format_version "
                                   f"{m.get('format_version')} "
                                   f"> supported {FORMAT_VERSION}")
                if "size" in m and int(m["size"]) != path.stat().st_size:
                    return False, (f"size {path.stat().st_size} != "
                                   f"manifest {m['size']}")
                if "crc32" in m and int(m["crc32"]) != file_crc32(path):
                    return False, "crc32 mismatch vs manifest"
        if not zipfile.is_zipfile(path):
            return False, "not a zip (truncated or partial write)"
        with zipfile.ZipFile(path) as zf:
            bad = zf.testzip()
            if bad is not None:
                return False, f"zip entry {bad!r} fails CRC"
            names = set(zf.namelist())
            missing = [n for n in REQUIRED_ENTRIES if n not in names]
            if missing:
                return False, f"missing entries {missing}"
            try:
                json.loads(zf.read("meta.json").decode())
            except ValueError:
                return False, "meta.json unparseable"
    except (OSError, zipfile.BadZipFile) as e:
        return False, f"unreadable ({e})"
    return True, "ok"
