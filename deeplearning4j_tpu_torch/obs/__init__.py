"""Telemetry spine (port of ``deeplearning4j_tpu/obs``): spans, metrics,
worker health and one merged report.

- :mod:`~deeplearning4j_tpu_torch.obs.trace` — the process-wide span
  tracer writing Chrome-trace/Perfetto JSONL (``DL4J_TPU_TRACE``); the
  off path is one branch;
- :mod:`~deeplearning4j_tpu_torch.obs.metrics` — counters, gauges and
  histograms with Prometheus text exposition on a stdlib ``/metrics`` +
  ``/healthz`` endpoint;
- :mod:`~deeplearning4j_tpu_torch.obs.health` — worker heartbeats and
  stale detection;
- :mod:`~deeplearning4j_tpu_torch.obs.devtime` — named device-time
  scopes (``torch.profiler.record_function``);
- :func:`report` — the merged JSON snapshot.

Hot-path contract: the instrumented loops call :func:`record_step` /
:func:`record_etl` / :func:`record_worker_step` with explicit
:func:`now` timestamps. Metrics are always on (a few dict lookups and
float adds a step); spans cost one branch when tracing is off.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from deeplearning4j_tpu_torch.obs import devtime as devtime
from deeplearning4j_tpu_torch.obs import health as health
from deeplearning4j_tpu_torch.obs import metrics as metrics
from deeplearning4j_tpu_torch.obs import trace as trace
from deeplearning4j_tpu_torch.obs.trace import now as now, span as span


def record_step(entry: str, t0: float, t1: float, t2: float,
                t3: float, args: Optional[Dict[str, Any]] = None,
                turn: bool = False) -> None:
    """One completed train/serve step (or a fit loop's group of steps)
    with phase attribution: ``t0→t1`` host→device feed, ``t1→t2``
    dispatch (the launches queued on the card), ``t2→t3`` blocking
    device sync. Metrics always; spans when tracing. ``turn=True`` (the
    fit loops, which call it after their listeners) runs the ``/step``
    span on to its own emission, over the loop's work after the sync:
    the listeners' calls and the step's metrics. The step's metrics
    stay ``t0→t3``."""
    metrics.observe_step(entry, t3 - t0, t1 - t0, t3 - t2)
    if trace.enabled():
        end = now() if turn else t3
        trace.add_spans(((entry + "/step", t0, end, args),
                         (entry + "/h2d", t0, t1, None),
                         (entry + "/dispatch", t1, t2, None),
                         (entry + "/sync", t2, t3, None)))


def record_etl(entry: str, t0: float, t1: float) -> None:
    """Fit-loop wait on its data iterator."""
    metrics.FIT_ETL_SECONDS.labels(entry=entry).inc(t1 - t0)
    if trace.enabled():
        trace.add_span(entry + "/etl", t0, t1)


def record_worker_step(worker: str, t0: float, t1: float, t2: float,
                       t3: float) -> None:
    """ParallelWrapper worker loop: per-worker latency histogram,
    collective-sync wall time, liveness heartbeat, spans."""
    metrics.WORKER_STEP.labels(worker=worker).observe(t3 - t0)
    metrics.WORKER_SYNC.labels(worker=worker).inc(t3 - t2)
    health.heartbeat(worker)
    if trace.enabled():
        trace.add_spans((
            ("ParallelWrapper.fit/step", t0, t3, {"worker": worker}),
            ("ParallelWrapper.fit/h2d", t0, t1, None),
            ("ParallelWrapper.fit/dispatch", t1, t2, None),
            ("ParallelWrapper.fit/collective_sync", t2, t3, None)))


def summary() -> Dict[str, Any]:
    """Compact view: tracer state, stale workers, per-entry steps."""
    return {
        "tracing": trace.enabled(),
        "trace_events": trace.events_recorded(),
        "stale_workers": health.stale_workers(),
        "step": metrics.step_summary(),
    }


def report(spans: int = 20) -> Dict[str, Any]:
    """The merged telemetry snapshot: tracer state and the last
    ``spans`` ring events, every metric family, and worker health."""
    return {
        "trace": {
            "enabled": trace.enabled(),
            "path": trace.trace_path(),
            "events_recorded": trace.events_recorded(),
        },
        "spans": trace.events(last=spans) if spans else [],
        "metrics": metrics.snapshot(),
        "health": health.check(),
    }


def overhead_report(step_seconds: Optional[float] = None,
                    iters: int = 2000) -> Dict[str, Any]:
    """Measure the tracing-OFF per-step cost of the instrumentation (the
    calls ``record_step`` + ``record_etl`` make on the off path) and
    express it as a fraction of ``step_seconds``. Restores the tracer's
    enabled state and scrubs the probe's samples from the registry."""
    was_enabled = trace.enabled()
    # flip the gate only (file and ring untouched), so the off path is
    # what gets timed even mid-trace
    trace._enabled = False
    try:
        t0 = now()
        for _ in range(iters):
            a = now()
            record_step("obs_overhead_probe", a, a, a, now())
            b = now()
            record_etl("obs_overhead_probe", b, now())
        per_step = (now() - t0) / iters
    finally:
        trace._enabled = was_enabled
        metrics.drop_entry("obs_overhead_probe")
    out: Dict[str, Any] = {
        "tracing": was_enabled,
        "off_path_cost_us": round(per_step * 1e6, 3),
    }
    if step_seconds:
        out["step_ms"] = round(step_seconds * 1e3, 3)
        out["overhead_pct_of_step"] = round(
            100.0 * per_step / step_seconds, 4)
    return out


def snapshot() -> Dict[str, Any]:
    return metrics.snapshot()


__all__ = ["trace", "metrics", "health", "devtime", "span", "now",
           "record_step", "record_etl", "record_worker_step", "summary",
           "report", "overhead_report", "snapshot"]
