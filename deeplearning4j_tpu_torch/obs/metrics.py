"""Metrics registry — counters, gauges and histograms with Prometheus
text exposition served from a stdlib HTTP ``/metrics`` + ``/healthz``
(port of ``deeplearning4j_tpu/obs/metrics.py``).

Process-wide: the fit loops, ``ParallelWrapper``, the serving gateway
and the fault injector publish into one namespace, scraped over HTTP in
the Prometheus text format and snapshotted into ``obs.report()``.
Family names are the JAX package's (``dl4j_tpu_<subsystem>_<name>_
<unit>``), so one dashboard reads both:

- ``dl4j_tpu_step_latency_seconds{entry=...}`` — per-entry step
  histogram (``MultiLayerNetwork.fit``, ``ComputationGraph.fit``, ...);
- ``dl4j_tpu_h2d_seconds_total`` / ``dl4j_tpu_device_sync_seconds_total``
  — where the step went (host→device copy vs blocking device sync);
- ``dl4j_tpu_fit_etl_seconds_total`` — the fit loops' iterator wait;
- ``dl4j_tpu_worker_*{worker=...}`` — ``ParallelWrapper`` per-worker
  step latency, collective-sync time, heartbeat age and staleness;
- ``dl4j_tpu_faults_injected_total{site=...}`` — ``resilience/faults.py``;
- ``dl4j_tpu_serving_*`` — the serving gateway, scheduler and pager;
- ``dl4j_tpu_opt_state_bytes_per_device{layout=...}`` — ZeRO;
- ``dl4j_tpu_retrace_*``, ``dl4j_tpu_aot_hits_total``,
  ``dl4j_tpu_compile_time_seconds_total`` and
  ``dl4j_tpu_compile_cache_*`` — the compile lifecycle (``perf/``: the
  retrace sentry and the kernel build cache), read at scrape.

The JAX package's ``/fleet`` aggregation has no counterpart here.
"""
from __future__ import annotations

import json
import re
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from deeplearning4j_tpu_torch.obs import trace as _trace

# latency buckets (seconds): sub-ms dispatch floors through multi-s
# first-use kernel builds
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# size buckets (examples): the serving batches of ParallelInference
SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n") \
        .replace('"', r'\"')


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Child:
    """One labelset's state; ``inc``/``set``/``observe`` are the hot
    path (a lock, a float add, and for a histogram one scan over ~14
    bounds)."""

    __slots__ = ("_m", "value", "counts", "sum", "count", "fn")

    def __init__(self, metric: "Metric"):
        self._m = metric
        self.value = 0.0
        self.fn: Optional[Callable[[], float]] = None
        if metric.kind == "histogram":
            self.counts = [0] * len(metric.buckets)
            self.sum = 0.0
            self.count = 0

    def inc(self, amount: float = 1.0):
        with self._m._lock:
            self.value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    def set(self, value: float):
        with self._m._lock:
            self.value = float(value)

    def set_function(self, fn: Callable[[], float]):
        """Gauge evaluated at scrape time (queue depths, ages)."""
        self.fn = fn

    def observe(self, value: float):
        m = self._m
        with m._lock:
            self.sum += value
            self.count += 1
            for i, b in enumerate(m.buckets):
                if value <= b:
                    self.counts[i] += 1
                    break

    def get(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:
                return float("nan")
        return self.value


class Metric:
    """One metric family (counter | gauge | histogram), optionally
    labelled. ``labels(**kv)`` returns the cached per-labelset child;
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
        names = self.labelnames
        key = ((str(kv[names[0]]),) if len(names) == 1
               else tuple(str(kv[n]) for n in names))
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, _Child(self))
        return child

    # un-labelled convenience
    def inc(self, amount: float = 1.0):
        self._children[()].inc(amount)

    def dec(self, amount: float = 1.0):
        self._children[()].dec(amount)

    def set(self, value: float):
        self._children[()].set(value)

    def set_function(self, fn: Callable[[], float]):
        self._children[()].set_function(fn)

    def observe(self, value: float):
        self._children[()].observe(value)

    # -- exposition ------------------------------------------------------
    def _samples(self) -> Iterable[Tuple[str, Dict[str, str], float]]:
        with self._lock:
            items = list(self._children.items())
        for key, child in items:
            labels = dict(zip(self.labelnames, key))
            if self.kind == "histogram":
                cum = 0
                for b, c in zip(self.buckets, child.counts):
                    cum += c
                    yield (self.name + "_bucket",
                           {**labels, "le": repr(float(b))}, cum)
                yield (self.name + "_bucket",
                       {**labels, "le": "+Inf"}, child.count)
                yield (self.name + "_sum", labels, child.sum)
                yield (self.name + "_count", labels, child.count)
            else:
                yield (self.name, labels, child.get())

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        with self._lock:
            items = list(self._children.items())
        for key, child in items:
            lk = _label_str(dict(zip(self.labelnames, key))) or ""
            if self.kind == "histogram":
                out[lk] = {"count": child.count, "sum": child.sum}
            else:
                out[lk] = child.get()
        return out


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}
        self._collectors: List[Callable[[], Iterable]] = []

    def _get_or_create(self, kind, name, doc, labelnames, buckets
                       ) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Metric(kind, name, doc, labelnames, buckets)
                self._metrics[name] = m
            elif m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name, doc, labelnames=()) -> Metric:
        return self._get_or_create("counter", name, doc, labelnames,
                                   LATENCY_BUCKETS)

    def gauge(self, name, doc, labelnames=()) -> Metric:
        return self._get_or_create("gauge", name, doc, labelnames,
                                   LATENCY_BUCKETS)

    def histogram(self, name, doc, labelnames=(),
                  buckets=LATENCY_BUCKETS) -> Metric:
        return self._get_or_create("histogram", name, doc, labelnames,
                                   buckets)

    def register_collector(self, fn: Callable[[], Iterable]) -> None:
        """``fn()`` → iterable of ``(name, kind, doc, samples)`` with
        ``samples = [(labels_dict, value), ...]``, evaluated at scrape
        time — how an outside source (worker health) joins the
        namespace without keeping a second count."""
        with self._lock:
            self._collectors.append(fn)

    def _collected(self) -> List[Tuple[str, str, str, list]]:
        with self._lock:
            collectors = list(self._collectors)
        out = []
        for fn in collectors:
            try:
                out.extend(fn())
            except Exception:
                continue            # a broken collector never breaks /metrics
        return out

    def exposition(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in sorted(metrics, key=lambda m: m.name):
            lines.append(f"# HELP {m.name} {_escape(m.doc)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for name, labels, value in m._samples():
                lines.append(f"{name}{_label_str(labels)} {value}")
        for name, kind, doc, samples in sorted(self._collected()):
            lines.append(f"# HELP {name} {_escape(doc)}")
            lines.append(f"# TYPE {name} {kind}")
            for labels, value in samples:
                lines.append(f"{name}{_label_str(labels)} {value}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict view of every family (registry metrics and
        collector families) — the ``metrics`` section of
        ``obs.report()``."""
        with self._lock:
            metrics = dict(self._metrics)
        out: Dict[str, Any] = {
            name: {"type": m.kind, "values": m.snapshot()}
            for name, m in metrics.items()}
        for name, kind, _doc, samples in self._collected():
            out[name] = {"type": kind, "values": {
                _label_str(labels) or "": value
                for labels, value in samples}}
        return out

    def reset(self) -> None:
        """Tests only: zero every family IN PLACE (collectors kept).
        The family objects stay registered, so module-level handles like
        ``STEP_SECONDS`` keep working; only their labelsets and values
        are dropped."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            with m._lock:
                m._children.clear()
                if not m.labelnames:
                    m._children[()] = _Child(m)


REGISTRY = MetricsRegistry()


# -- per-entry step families (fed by obs.record_step) ------------------------
STEP_SECONDS = REGISTRY.histogram(
    "dl4j_tpu_step_latency_seconds",
    "end-to-end train/serve step latency (h2d + dispatch + sync)",
    ("entry",))
STEPS = REGISTRY.counter(
    "dl4j_tpu_steps_total", "completed steps per entry point", ("entry",))
H2D_SECONDS = REGISTRY.counter(
    "dl4j_tpu_h2d_seconds_total",
    "host->device feed time (array conversion/stacking)", ("entry",))
SYNC_SECONDS = REGISTRY.counter(
    "dl4j_tpu_device_sync_seconds_total",
    "blocking device sync time (loss/result to host)", ("entry",))
FIT_ETL_SECONDS = REGISTRY.counter(
    "dl4j_tpu_fit_etl_seconds_total",
    "time the fit loop waited on its data iterator", ("entry",))
PREFETCH_WAIT = REGISTRY.counter(
    "dl4j_tpu_prefetch_wait_seconds_total",
    "consumer wait on the AsyncDataSetIterator queue")
PREFETCH_DEPTH = REGISTRY.gauge(
    "dl4j_tpu_prefetch_depth",
    "AsyncDataSetIterator queue depth after the last get")
WORKER_STEP = REGISTRY.histogram(
    "dl4j_tpu_worker_step_latency_seconds",
    "ParallelWrapper per-worker step latency", ("worker",))
WORKER_SYNC = REGISTRY.counter(
    "dl4j_tpu_worker_collective_sync_seconds_total",
    "ParallelWrapper wait for step + averaging/all-reduce completion",
    ("worker",))

# -- resilience (resilience/faults.py) ---------------------------------------
FAULTS_INJECTED = REGISTRY.counter(
    "dl4j_tpu_faults_injected_total",
    "faults fired by the DL4J_TPU_FAULT_PLAN harness", ("site",))

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
# speculative decode and copy-on-write prefix sharing
# (serving/scheduler.py, serving/kv_pager.py): the accept rate is the
# share of drafted tokens one verify step confirmed; the prefix counters
# count admissions that rode an existing page chain and the prefill
# tokens that saved
SERVING_SPEC_ACCEPT = REGISTRY.histogram(
    "dl4j_tpu_serving_spec_accept_rate",
    "per-slot fraction of drafted tokens accepted by one verify step",
    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
SERVING_SPEC_DRAFTED = REGISTRY.counter(
    "dl4j_tpu_serving_spec_drafted_total",
    "tokens drafted by the host-side prompt-lookup draft")
SERVING_SPEC_ACCEPTED = REGISTRY.counter(
    "dl4j_tpu_serving_spec_accepted_total",
    "drafted tokens accepted by the batched verify step")
SERVING_PREFIX_HITS = REGISTRY.counter(
    "dl4j_tpu_serving_prefix_hits_total",
    "admissions that mapped a shared prompt prefix onto an existing "
    "page chain (prefill ran only on the novel suffix)")
SERVING_PREFIX_SAVED = REGISTRY.counter(
    "dl4j_tpu_serving_prefix_prefill_tokens_saved_total",
    "prompt tokens NOT prefilled because their pages were shared")
SERVING_PREFIX_SHARED = REGISTRY.gauge(
    "dl4j_tpu_serving_prefix_shared_pages",
    "KV pages currently referenced by more than one live sequence")
SERVING_PREFIX_COW = REGISTRY.counter(
    "dl4j_tpu_serving_prefix_cow_copies_total",
    "copy-on-write page copies (a write hit a shared page)")

# -- batched inference serving (parallel/inference.py) ------------------------
INFER_REQS = REGISTRY.counter(
    "dl4j_tpu_inference_requests_total",
    "ParallelInference requests enqueued")
INFER_LATENCY = REGISTRY.histogram(
    "dl4j_tpu_inference_request_latency_seconds",
    "enqueue->result latency per request")
INFER_QUEUE = REGISTRY.gauge(
    "dl4j_tpu_inference_queue_depth",
    "ParallelInference request queue depth")
INFER_BATCH = REGISTRY.histogram(
    "dl4j_tpu_inference_batch_size",
    "examples per dispatched serving batch", buckets=SIZE_BUCKETS)
REQS_SHED = REGISTRY.counter(
    "dl4j_tpu_inference_requests_shed_total",
    "serving requests shed instead of served", ("reason",))

# -- parallel training (parallel/wrapper.py) -----------------------------------
# the optimizer-state footprint the ZeRO sharded update divides by N:
# layout "replicated" (every rank holds the whole moments) or "sharded"
# (1/N a rank)
OPT_STATE_BYTES = REGISTRY.gauge(
    "dl4j_tpu_opt_state_bytes_per_device",
    "optimizer-state bytes resident per device for the active "
    "ParallelWrapper training layout", ("layout",))


def drop_entry(entry: str) -> None:
    """Remove one ``entry`` labelset from every per-entry family —
    used by ``obs.overhead_report`` to scrub its probe iterations so
    synthetic samples never reach /metrics or step summaries."""
    for fam in (STEP_SECONDS, STEPS, H2D_SECONDS, SYNC_SECONDS,
                FIT_ETL_SECONDS):
        with fam._lock:
            fam._children.pop((entry,), None)


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
    out = {}
    for lk, s in STEP_SECONDS.snapshot().items():
        if not s["count"]:
            continue
        entry = lk[len('{entry="'):-2] if lk.startswith('{entry="') \
            else lk
        out[entry] = {"count": s["count"],
                      "mean_ms": s["sum"] / s["count"] * 1e3}
    return out


def snapshot() -> Dict[str, Any]:
    return REGISTRY.snapshot()


def exposition() -> str:
    return REGISTRY.exposition()


# -- pull-time collectors: the compile lifecycle + worker health ------------

def _perf_collector():
    """The retrace sentry and the kernel build cache as metric families
    (read at scrape; ``perf/`` owns the counters)."""
    from deeplearning4j_tpu_torch.perf import compile_cache, sentry
    rows = list(sentry.stats().items())
    yield ("dl4j_tpu_retrace_traces_total", "counter",
           "distinct traces per sentried entry point",
           [({"function": n}, s["traces"]) for n, s in rows])
    yield ("dl4j_tpu_retrace_unplanned_shapes", "gauge",
           "distinct UNPLANNED traced shapes (the retrace budget meter)",
           [({"function": n}, s["unplanned_shapes"]) for n, s in rows])
    yield ("dl4j_tpu_retrace_compiles_total", "counter",
           "first calls not covered by a warmup, per entry point",
           [({"function": n}, s["compiles"]) for n, s in rows])
    yield ("dl4j_tpu_aot_hits_total", "counter",
           "live calls served by a warmed executable (a captured graph "
           "on the card)",
           [({"function": n}, s["aot_hits"]) for n, s in rows])
    yield ("dl4j_tpu_compile_time_seconds_total", "counter",
           "wall time spent building the sentried entry points' "
           "executables (capturing their graphs on the card)",
           [({}, sentry.total_compile_time_s())])
    c = compile_cache.counters()
    yield ("dl4j_tpu_compile_cache_requests_total", "counter",
           "kernel library loads through the build cache",
           [({}, c["compile_requests"])])
    yield ("dl4j_tpu_compile_cache_hits_total", "counter",
           "kernel libraries found built in the build cache",
           [({}, c["persistent_hits"])])



def _health_collector():
    from deeplearning4j_tpu_torch.obs import health
    chk = health.check()
    yield ("dl4j_tpu_worker_heartbeat_age_seconds", "gauge",
           "seconds since each worker's last heartbeat",
           [({"worker": w}, round(s["age_s"], 3))
            for w, s in chk.items()])
    yield ("dl4j_tpu_worker_stale", "gauge",
           "1 when a worker's heartbeat is older than "
           "DL4J_TPU_STALE_WORKER_SECS",
           [({"worker": w}, int(s["stale"])) for w, s in chk.items()])


REGISTRY.register_collector(_perf_collector)
REGISTRY.register_collector(_health_collector)


# -- scrape-side parser --------------------------------------------------------

_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+([^\s]+)$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str) -> Dict[Tuple[str, Tuple], float]:
    """Parse Prometheus text exposition into
    ``{(name, ((label, value), ...)): float}``; raises ``ValueError`` on
    a malformed sample line."""
    out: Dict[Tuple[str, Tuple], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name, labelblob, value = m.groups()
        labels = tuple(sorted(
            (k, v.replace(r'\"', '"').replace(r"\n", "\n")
             .replace(r"\\", "\\"))
            for k, v in _LABEL_RE.findall(labelblob or "")))
        out[(name, labels)] = float(value)
    return out


# -- /metrics + /healthz server ----------------------------------------------

class MetricsServer:
    """Stdlib HTTP endpoint: ``/metrics`` (Prometheus text) and
    ``/healthz`` (JSON liveness: 200 when no worker is stale, 503
    otherwise). Binds 127.0.0.1; port 0 takes an ephemeral port."""

    def __init__(self, port: int = 0, registry: MetricsRegistry = None):
        self.port = port
        self.registry = registry or REGISTRY
        self._httpd = None
        self._thread = None
        self._t_start = _trace.now()

    def healthz(self) -> Dict[str, Any]:
        from deeplearning4j_tpu_torch.obs import health
        chk = health.check()
        stale = sorted(w for w, s in chk.items() if s["stale"])
        return {
            "status": "stale_workers" if stale else "ok",
            "stale_workers": stale,
            "workers": {w: round(s["age_s"], 3)
                        for w, s in chk.items()},
            "uptime_s": round(_trace.now() - self._t_start, 3),
            "tracing": _trace.enabled(),
        }

    def start(self) -> "MetricsServer":
        import http.server

        srv = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = srv.registry.exposition().encode()
                    code, ctype = 200, \
                        "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/healthz":
                    h = srv.healthz()
                    body = json.dumps(h).encode()
                    code = 200 if h["status"] == "ok" else 503
                    ctype = "application/json"
                else:
                    body = (b"deeplearning4j_tpu_torch telemetry: "
                            b"/metrics /healthz\n")
                    code, ctype = 200, "text/plain"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


_server: Optional[MetricsServer] = None


def start_server(port: Optional[int] = None) -> MetricsServer:
    """Start (or return) the process-wide telemetry endpoint. ``port``
    defaults to ``DL4J_TPU_METRICS_PORT`` (0 → ephemeral)."""
    global _server
    if _server is not None:
        return _server
    if port is None:
        from deeplearning4j_tpu_torch import environment
        port = environment.get_flag("DL4J_TPU_METRICS_PORT")
    _server = MetricsServer(port=int(port)).start()
    return _server


def stop_server() -> None:
    global _server
    if _server is not None:
        _server.stop()
        _server = None
