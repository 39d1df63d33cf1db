"""In-process metrics: counters, gauges and histograms.

Port of the part of ``deeplearning4j_tpu/obs/metrics.py`` the serving
path calls: the registry objects, the per-entry step families that
``obs.record_step`` feeds, the ``SERVING_*`` families of
``serving/{gateway,scheduler,kv_pager}.py`` and ``OPT_STATE_BYTES`` of
``parallel/wrapper.py``. Family names are the JAX
package's, so one dashboard reads both. The Prometheus exposition and
the HTTP endpoint are not ported here.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Tuple

# latency buckets (seconds): sub-ms dispatch floors through multi-s
# first-use kernel builds
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class _Child:
    """One labelset's state; ``inc``/``set``/``observe`` are the hot
    path (a lock and a float add)."""

    __slots__ = ("_m", "value", "counts", "sum", "count")

    def __init__(self, metric: "Metric"):
        self._m = metric
        self.value = 0.0
        if metric.kind == "histogram":
            self.counts = [0] * len(metric.buckets)
            self.sum = 0.0
            self.count = 0

    def inc(self, amount: float = 1.0):
        with self._m._lock:
            self.value += amount

    def set(self, value: float):
        with self._m._lock:
            self.value = float(value)

    def observe(self, value: float):
        m = self._m
        with m._lock:
            self.sum += value
            self.count += 1
            for i, b in enumerate(m.buckets):
                if value <= b:
                    self.counts[i] += 1
                    break


class Metric:
    """One metric family (counter | gauge | histogram), optionally
    labelled. ``labels(**kv)`` returns the per-labelset child;
    un-labelled families proxy the operations directly."""

    def __init__(self, kind: str, name: str, doc: str,
                 labelnames: Tuple[str, ...] = (),
                 buckets: Tuple[float, ...] = LATENCY_BUCKETS):
        self.kind = kind
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.labelnames:
            self._children[()] = _Child(self)

    def labels(self, **kv: str) -> _Child:
        key = tuple(str(kv[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, _Child(self))
        return child

    def inc(self, amount: float = 1.0):
        self._children[()].inc(amount)

    def set(self, value: float):
        self._children[()].set(value)

    def observe(self, value: float):
        self._children[()].observe(value)

    def snapshot(self) -> Dict[str, Any]:
        """``{labelset: value}``, or ``{labelset: {count, sum}}`` for a
        histogram; the labelset key is ``""`` for an un-labelled
        family."""
        with self._lock:
            items = list(self._children.items())
        out: Dict[str, Any] = {}
        for key, child in items:
            lk = ",".join(f"{n}={v}" for n, v in zip(self.labelnames, key))
            if self.kind == "histogram":
                out[lk] = {"count": child.count, "sum": child.sum}
            else:
                out[lk] = child.value
        return out


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, kind, name, doc, labelnames,
                       buckets=LATENCY_BUCKETS) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Metric(kind, name, doc,
                                                 labelnames, buckets)
            elif m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name, doc, labelnames=()) -> Metric:
        return self._get_or_create("counter", name, doc, labelnames)

    def gauge(self, name, doc, labelnames=()) -> Metric:
        return self._get_or_create("gauge", name, doc, labelnames)

    def histogram(self, name, doc, labelnames=(),
                  buckets=LATENCY_BUCKETS) -> Metric:
        return self._get_or_create("histogram", name, doc, labelnames,
                                   buckets)



REGISTRY = MetricsRegistry()


# -- per-entry step families (fed by obs.record_step) ------------------------
STEP_SECONDS = REGISTRY.histogram(
    "dl4j_tpu_step_latency_seconds",
    "end-to-end serve step latency (h2d + dispatch + sync)", ("entry",))
STEPS = REGISTRY.counter(
    "dl4j_tpu_steps_total", "completed steps per entry point", ("entry",))
H2D_SECONDS = REGISTRY.counter(
    "dl4j_tpu_h2d_seconds_total",
    "host->device feed time (array conversion/stacking)", ("entry",))
SYNC_SECONDS = REGISTRY.counter(
    "dl4j_tpu_device_sync_seconds_total",
    "blocking device sync time (result to host)", ("entry",))

# -- continuous-batching serving gateway (serving/) --------------------------
SERVING_REQS = REGISTRY.counter(
    "dl4j_tpu_serving_requests_total",
    "gateway requests submitted (per tenant)", ("tenant",))
SERVING_SHED = REGISTRY.counter(
    "dl4j_tpu_serving_requests_shed_total",
    "gateway requests shed instead of served", ("reason",))
SERVING_TOKENS = REGISTRY.counter(
    "dl4j_tpu_serving_tokens_total",
    "tokens streamed by the continuous-batching gateway")
SERVING_TTFT = REGISTRY.histogram(
    "dl4j_tpu_serving_ttft_seconds",
    "submit -> first streamed token (queue wait + paged prefill)")
SERVING_STEP = REGISTRY.histogram(
    "dl4j_tpu_serving_step_seconds",
    "one continuous-batching decode iteration (== the per-token "
    "latency of every active slot)")
SERVING_PREFILL = REGISTRY.histogram(
    "dl4j_tpu_serving_prefill_seconds",
    "prompt prefill-into-pages wall time per admission")
SERVING_SLOTS = REGISTRY.gauge(
    "dl4j_tpu_serving_active_slots",
    "decode slots occupied by in-flight sequences")
SERVING_QUEUE = REGISTRY.gauge(
    "dl4j_tpu_serving_queue_depth",
    "requests queued awaiting admission (all tenants)")
SERVING_PAGES_FREE = REGISTRY.gauge(
    "dl4j_tpu_serving_kv_pages_free",
    "free pages in the paged KV-cache pool")
SERVING_KV_OCCUPANCY = REGISTRY.gauge(
    "dl4j_tpu_serving_kv_page_occupancy",
    "fraction of usable KV pages currently reserved by live sequences")
SERVING_KV_RESERVED = REGISTRY.gauge(
    "dl4j_tpu_serving_kv_pages_reserved",
    "KV pages reserved per tenant (whole-life reservations)",
    ("tenant",))
SERVING_PREFIX_SHARED = REGISTRY.gauge(
    "dl4j_tpu_serving_prefix_shared_pages",
    "KV pages currently referenced by more than one live sequence")

# -- parallel training (parallel/wrapper.py) -----------------------------------
# the optimizer-state footprint the ZeRO sharded update divides by N:
# layout "replicated" (every rank holds the whole moments) or "sharded"
# (1/N a rank)
OPT_STATE_BYTES = REGISTRY.gauge(
    "dl4j_tpu_opt_state_bytes_per_device",
    "optimizer-state bytes resident per device for the active "
    "ParallelWrapper training layout", ("layout",))


def observe_step(entry: str, dt: float, h2d: float = 0.0,
                 sync: float = 0.0) -> None:
    """One call per completed step — the metrics half of
    ``obs.record_step``."""
    STEP_SECONDS.labels(entry=entry).observe(dt)
    STEPS.labels(entry=entry).inc()
    if h2d:
        H2D_SECONDS.labels(entry=entry).inc(h2d)
    if sync:
        SYNC_SECONDS.labels(entry=entry).inc(sync)


def step_summary() -> Dict[str, Dict[str, float]]:
    """Per-entry ``{count, mean_ms}``."""
    out: Dict[str, Dict[str, float]] = {}
    for lk, s in STEP_SECONDS.snapshot().items():
        if s["count"]:
            out[lk[len("entry="):]] = {"count": s["count"],
                          "mean_ms": s["sum"] / s["count"] * 1e3}
    return out
