"""Worker heartbeats and stale-worker detection (port of
``deeplearning4j_tpu/obs/health.py``).

A collective can wedge one process of a multi-process job, and a
serving worker can stall, so liveness is an explicit, scrapeable
signal: every worker loop calls :func:`heartbeat` once a step, and
``/healthz`` (with the ``dl4j_tpu_worker_stale`` family) flags any
worker whose last beat is older than ``DL4J_TPU_STALE_WORKER_SECS``.

Timestamps are :func:`obs.trace.now` (monotonic); :func:`heartbeat`
and :func:`check` take explicit times, so a test can flag a stalled
worker without sleeping.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.obs import trace as _trace

_lock = threading.Lock()
_beats: Dict[str, float] = {}
#: per-worker staleness thresholds that win over the default (set by
#: :func:`observe_age`)
_stale_after: Dict[str, float] = {}


def heartbeat(worker: str, t: Optional[float] = None) -> None:
    """Record that ``worker`` is alive at ``t`` (default: now)."""
    with _lock:
        _beats[str(worker)] = _trace.now() if t is None else t


def observe_age(worker: str, age_s: float,
                stale_after: Optional[float] = None) -> None:
    """Record a beat whose AGE is known instead of its timestamp (a
    peer's lease read from another process's clock): the worker shows
    ``age_s`` of staleness on ``/healthz`` and
    ``dl4j_tpu_worker_stale``. ``stale_after`` pins THIS worker's
    staleness threshold."""
    heartbeat(worker, _trace.now() - max(0.0, float(age_s)))
    if stale_after is not None:
        with _lock:
            _stale_after[str(worker)] = float(stale_after)


def retire(worker: str) -> None:
    """Forget ``worker``'s heartbeat — called when a worker loop exits
    NORMALLY (``ParallelWrapper.fit`` completing its epochs). Without
    this a finished training loop reads as a permanently stale worker
    in a long-lived train-then-serve process. A crashed loop never
    retires, so the stale alarm still fires for real wedges."""
    with _lock:
        _beats.pop(str(worker), None)
        _stale_after.pop(str(worker), None)


def check(stale_after: Optional[float] = None,
          now: Optional[float] = None) -> Dict[str, Dict]:
    """``{worker: {"age_s", "stale"}}`` for every known worker. A
    per-worker threshold recorded via :func:`observe_age` wins over
    the default."""
    if stale_after is None:
        from deeplearning4j_tpu_torch import environment
        stale_after = environment.get_flag("DL4J_TPU_STALE_WORKER_SECS")
    now = _trace.now() if now is None else now
    with _lock:
        beats = dict(_beats)
        overrides = dict(_stale_after)
    return {w: {"age_s": now - t,
                "stale": (now - t) > overrides.get(w, stale_after)}
            for w, t in beats.items()}


def stale_workers(stale_after: Optional[float] = None,
                  now: Optional[float] = None) -> List[str]:
    return sorted(w for w, s in check(stale_after, now).items()
                  if s["stale"])


def reset() -> None:
    with _lock:
        _beats.clear()
        _stale_after.clear()
