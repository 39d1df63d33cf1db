"""Telemetry spine (port): the clock, step recording, device-time scopes
and the in-process metric families the serving path calls.

Port of the serving-path part of ``deeplearning4j_tpu/obs``: ``now``,
``record_step``, ``devtime.scope`` and ``metrics``. Span tracing, the
HTTP exposition and the other observatories are not ported here.
"""
from __future__ import annotations

import time
from deeplearning4j_tpu_torch.obs import devtime as devtime
from deeplearning4j_tpu_torch.obs import metrics as metrics

now = time.perf_counter


def record_step(entry: str, t0: float, t1: float, t2: float,
                t3: float) -> None:
    """One completed serve step with phase attribution: ``t0→t1``
    host→device feed, ``t1→t2`` dispatch (asynchronous on the card),
    ``t2→t3`` blocking device sync."""
    metrics.observe_step(entry, t3 - t0, t1 - t0, t3 - t2)


__all__ = ["devtime", "metrics", "now", "record_step"]
