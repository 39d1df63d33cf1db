"""The port's telemetry spine on the CPU (``environment.py``,
``obs/trace.py``, ``obs/health.py``, ``obs/metrics.py``, ``obs``): the
twins of ``tests/test_obs.py``, driven through the port's own fit loop,
and the flag registry held against the JAX package's.

Left without a twin: the retrace-sentry and compile-cache families (the
port has no jit cache), the listeners span, the ``tools/`` consumers,
the crash dump, ``StatsListener``, ``AsyncDataSetIterator`` and
``ParallelInference`` (not ported), and the 8-device wrapper heartbeat
(``tests/test_torch_faults.py`` holds the wrapper's heartbeat at world
size 1).
"""
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import environment as jenv
from deeplearning4j_tpu_torch import environment, obs
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.obs import health, metrics, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracer_off_after():
    yield
    trace.reset()


def _net(seed=7):
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(upd.Adam(learning_rate=0.01)).list()
            .layer(pl.DenseLayer(n_out=8, activation="relu"))
            .layer(pl.OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _batches(n=10, b=8, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((b, 4)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
        out.append(DataSet(x, y))
    return out


# --- the flag registry ------------------------------------------------------
PORT_FLAGS = {"DL4J_TPU_COORD", "DL4J_TPU_NPROC", "DL4J_TPU_PROC_ID",
              "DL4J_TPU_TRACE", "DL4J_TPU_TRACE_RING",
              "DL4J_TPU_METRICS_PORT", "DL4J_TPU_STALE_WORKER_SECS",
              "DL4J_TPU_FAULT_PLAN", "DL4J_TPU_COMPILE_CACHE",
              "DL4J_TPU_COMPILE_STORE", "DL4J_TPU_RETRACE_BUDGET",
              "DL4J_TPU_RETRACE_STRICT"}


def test_flag_registry_matches_the_jax_flags():
    """Every flag the port registers is a JAX flag with the same name,
    default and parser (the JAX package's own function, or for its
    boolean parser the port's copy, which reads every spelling alike);
    no TPU roofline figure or TPU crossover is a flag of the port, nor
    are the XLA cache's eligibility floors."""
    assert set(environment.FLAGS) == PORT_FLAGS
    for name, flag in environment.FLAGS.items():
        jflag = jenv.FLAGS[name]
        assert flag.name == jflag.name == name
        assert flag.default == jflag.default, name
        assert flag.parse is jflag.parse or all(
            flag.parse(v) == jflag.parse(v)
            for v in ("1", "true", "YES", "on", "0", "false", "off", "",
                      " yes ")), name
    for tpu_only in ("DL4J_TPU_PEAK_TFLOPS", "DL4J_TPU_PEAK_HBM_GBS",
                     "DL4J_TPU_PEAK_ICI_GBS", "DL4J_TPU_FLASH_MIN_T",
                     "DL4J_TPU_FUSED_NORM_MIN_F",
                     "DL4J_TPU_COMPILE_CACHE_MIN_BYTES",
                     "DL4J_TPU_COMPILE_CACHE_MIN_SECS"):
        assert tpu_only not in environment.FLAGS
    text = environment.describe()
    assert all(name in text for name in PORT_FLAGS)


def test_get_flag_parses_the_environment(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_STALE_WORKER_SECS", "2.5")
    monkeypatch.setenv("DL4J_TPU_NPROC", "4")
    monkeypatch.delenv("DL4J_TPU_COORD", raising=False)
    assert environment.get_flag("DL4J_TPU_STALE_WORKER_SECS") == 2.5
    assert environment.get_flag("DL4J_TPU_NPROC") == 4
    assert environment.get_flag("DL4J_TPU_COORD") is None


# --- tracer -----------------------------------------------------------------
def test_span_nesting_roundtrips_through_jsonl(tmp_path):
    """[``test_obs.py:56``]"""
    path = tmp_path / "t.jsonl"
    trace.enable(str(path))
    trace.set_thread_name("main-test")
    with obs.span("outer", {"k": 1}):
        with obs.span("inner"):
            pass
    t0 = obs.now()
    trace.add_span("explicit", t0, t0 + 0.5)
    trace.instant("marker")
    trace.disable()
    evs = trace.read_trace(str(path))
    by_name = {e["name"]: e for e in evs}
    assert by_name["thread_name"]["args"]["name"] == "main-test"
    outer, inner = by_name["outer"], by_name["inner"]
    assert outer["ph"] == inner["ph"] == "X"
    assert outer["tid"] == inner["tid"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1
    assert outer["args"] == {"k": 1}
    assert by_name["explicit"]["dur"] == pytest.approx(5e5, rel=1e-3)
    assert by_name["marker"]["ph"] == "i"
    assert path.read_text().startswith("[\n")


def test_ring_buffer_bounds_memory(tmp_path):
    """[``:85``]"""
    trace.enable(str(tmp_path / "r.jsonl"), ring=8)
    t0 = obs.now()
    for i in range(50):
        trace.add_span(f"s{i}", t0, t0 + 1e-6)
    assert len(trace.events()) <= 8
    assert trace.events_recorded() == 50
    trace.disable()
    assert sum(e.get("ph") == "X"
               for e in trace.read_trace(trace.trace_path())) == 50


def test_tracing_disabled_records_nothing_on_step_path():
    """[``:98``] a fit, grouped and not, records no event with tracing
    off."""
    trace.reset()
    net = _net()
    net.fit(ListDataSetIterator(_batches(3)))
    net.fit(ListDataSetIterator(_batches(4)), steps_per_loop=2)
    with obs.span("should-not-record"):
        pass
    t0 = obs.now()
    trace.add_span("also-not", t0, t0)
    trace.async_span("also-not", 1, t0, t0)
    trace.counter("also-not", {"a": 1.0})
    assert trace.events_recorded() == 0
    assert trace.events() == []


def test_off_path_overhead_under_one_percent_of_bench_step():
    """[``:113``] the instrumentation's tracing-off cost a step, held to
    under 1 % of a 5 ms step (min of three probes)."""
    rep = min((obs.overhead_report(step_seconds=0.005, iters=500)
               for _ in range(3)),
              key=lambda r: r["off_path_cost_us"])
    assert rep["tracing"] is False
    assert rep["off_path_cost_us"] < 50.0
    assert rep["overhead_pct_of_step"] < 1.0
    assert "obs_overhead_probe" not in metrics.step_summary()
    assert "obs_overhead_probe" not in str(metrics.STEPS.snapshot())


def _coverage(spans):
    """Union coverage of [ts, ts+dur) over traced wall time."""
    spans = sorted(spans, key=lambda e: (e["ts"], -e["dur"]))
    wall = (max(e["ts"] + e["dur"] for e in spans)
            - min(e["ts"] for e in spans))
    covered = end = 0.0
    for e in spans:
        s, d = e["ts"], e["dur"]
        if s + d <= end:
            continue
        covered += (s + d) - max(s, end)
        end = s + d
    return covered / wall


def test_ten_step_fit_trace_covers_wall_time(tmp_path):
    """[``:148``]"""
    path = tmp_path / "fit.jsonl"
    trace.enable(str(path))
    net = _net()
    net.fit(ListDataSetIterator(_batches(10)))
    trace.disable()
    evs = [e for e in trace.read_trace(str(path)) if e.get("ph") == "X"]
    names = {e["name"] for e in evs}
    assert {"MultiLayerNetwork.fit/etl", "MultiLayerNetwork.fit/step",
            "MultiLayerNetwork.fit/sync", "MultiLayerNetwork.fit/h2d",
            "MultiLayerNetwork.fit/dispatch"} <= names
    steps = [e for e in evs if e["name"] == "MultiLayerNetwork.fit/step"]
    assert len(steps) == 10
    syncs = sorted((e for e in evs
                    if e["name"] == "MultiLayerNetwork.fit/sync"),
                   key=lambda e: e["ts"])
    for s, sy in zip(sorted(steps, key=lambda e: e["ts"]), syncs):
        assert s["ts"] <= sy["ts"] + 1e-3
        assert sy["ts"] + sy["dur"] <= s["ts"] + s["dur"] + 1e-3
    top = [e for e in evs if e["name"] in (
        "MultiLayerNetwork.fit/step", "MultiLayerNetwork.fit/etl")]
    assert _coverage(top) >= 0.95


def test_env_gated_trace_end_to_end(tmp_path):
    """[``:181``] a 10-step fit in a fresh process with DL4J_TPU_TRACE
    set writes Chrome-trace JSONL covering >= 95 % of its wall time, and
    the same process's exposition carries the step histogram."""
    path = tmp_path / "env.jsonl"
    prog = """
import numpy as np
import torch
torch.set_num_threads(1)
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
conf = (NeuralNetConfiguration.builder().seed(7)
        .updater(upd.Adam(learning_rate=0.01)).list()
        .layer(pl.DenseLayer(n_out=8, activation="relu"))
        .layer(pl.OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.feed_forward(4)).build())
net = MultiLayerNetwork(conf).init(device="cpu")
rng = np.random.default_rng(0)
data = [DataSet(rng.standard_normal((8, 4)).astype(np.float32),
                np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)])
        for _ in range(10)]
net.fit(ListDataSetIterator(data))
from deeplearning4j_tpu_torch.obs import metrics, trace
trace.flush()
print(metrics.REGISTRY.exposition())
"""
    env = dict(os.environ, DL4J_TPU_TRACE=str(path))
    r = subprocess.run([sys.executable, "-c", prog], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    fams = metrics.parse_exposition(
        "\n".join(ln for ln in r.stdout.splitlines()
                  if ln.startswith(("#", "dl4j_tpu_"))))
    entry = (("entry", "MultiLayerNetwork.fit"),)
    assert fams[("dl4j_tpu_step_latency_seconds_count", entry)] == 10
    assert fams[("dl4j_tpu_fit_etl_seconds_total", entry)] > 0
    evs = [e for e in trace.read_trace(str(path)) if e.get("ph") == "X"]
    top = [e for e in evs if e["name"] in (
        "MultiLayerNetwork.fit/step", "MultiLayerNetwork.fit/etl")]
    assert sum(e["name"].endswith("/step") for e in top) == 10
    assert {e["name"] for e in evs} >= {
        "MultiLayerNetwork.fit/etl", "MultiLayerNetwork.fit/step",
        "MultiLayerNetwork.fit/h2d", "MultiLayerNetwork.fit/dispatch",
        "MultiLayerNetwork.fit/sync"}
    assert _coverage(top) >= 0.95


# --- metrics registry + exposition ------------------------------------------
def test_metrics_exposition_is_valid_prometheus_text():
    """[``:255``]"""
    net = _net()
    net.fit(ListDataSetIterator(_batches(3)))
    text = metrics.REGISTRY.exposition()
    fams = metrics.parse_exposition(text)
    entry = (("entry", "MultiLayerNetwork.fit"),)
    inf_key = ("dl4j_tpu_step_latency_seconds_bucket",
               (("entry", "MultiLayerNetwork.fit"), ("le", "+Inf")))
    assert inf_key in fams
    count = fams[("dl4j_tpu_step_latency_seconds_count", entry)]
    assert fams[inf_key] == count >= 3
    assert fams[("dl4j_tpu_step_latency_seconds_sum", entry)] > 0
    buckets = sorted(
        ((float("inf") if dict(k[1])["le"] == "+Inf"
          else float(dict(k[1])["le"])), v)
        for k, v in fams.items()
        if k[0] == "dl4j_tpu_step_latency_seconds_bucket"
        and dict(k[1]).get("entry") == "MultiLayerNetwork.fit")
    assert all(a[1] <= b[1] for a, b in zip(buckets, buckets[1:]))
    assert "# TYPE dl4j_tpu_step_latency_seconds histogram" in text
    assert "# TYPE dl4j_tpu_faults_injected_total counter" in text
    with pytest.raises(ValueError):
        metrics.parse_exposition("not a sample line at all")


def test_metrics_server_and_healthz_endpoint():
    """[``:288``]"""
    health.reset()
    srv = metrics.MetricsServer(port=0).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/metrics") as r:
            assert r.status == 200
            assert "text/plain" in r.headers["Content-Type"]
            metrics.parse_exposition(r.read().decode())
        with urllib.request.urlopen(base + "/healthz") as r:
            h = json.loads(r.read().decode())
        assert h["status"] == "ok" and h["stale_workers"] == []
        health.heartbeat("w-stalled", t=obs.now() - 1e4)
        health.heartbeat("w-live")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/healthz")
        assert ei.value.code == 503
        body = json.loads(ei.value.read().decode())
        assert body["stale_workers"] == ["w-stalled"]
    finally:
        srv.stop()
        health.reset()


def test_start_server_reads_the_port_flag(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_METRICS_PORT", "0")
    srv = metrics.start_server()
    try:
        assert metrics.start_server() is srv and srv.port > 0
    finally:
        metrics.stop_server()


def test_registry_reset_keeps_standing_family_handles():
    """[``:313``]"""
    reg = metrics.MetricsRegistry()
    fam = reg.histogram("t_steps", "probe", ("entry",))
    fam.labels(entry="a").observe(0.1)
    reg.reset()
    assert "t_steps" in reg.exposition()
    fam.labels(entry="a").observe(0.2)
    assert '{entry="a"}' in str(reg.snapshot()["t_steps"]["values"])
    assert reg.snapshot()["t_steps"]["values"]['{entry="a"}'][
        "count"] == 1


def test_heartbeat_retire_clears_finished_worker():
    """[``:325``]"""
    health.reset()
    health.heartbeat("done-worker", t=obs.now() - 1e4)
    assert health.stale_workers(stale_after=30) == ["done-worker"]
    health.retire("done-worker")
    assert health.check() == {}
    health.retire("never-registered")


def test_stale_worker_detector_explicit_clock(monkeypatch):
    """[``:384``] and the default threshold from the flag."""
    health.reset()
    now = obs.now()
    health.heartbeat("a", t=now - 5)
    health.heartbeat("b", t=now - 100)
    chk = health.check(stale_after=30, now=now)
    assert not chk["a"]["stale"] and chk["b"]["stale"]
    assert health.stale_workers(stale_after=30, now=now) == ["b"]
    assert chk["b"]["age_s"] == pytest.approx(100, abs=1)
    monkeypatch.setenv("DL4J_TPU_STALE_WORKER_SECS", "2")
    assert health.stale_workers(now=now) == ["a", "b"]
    health.observe_age("c", 10.0, stale_after=60)
    assert "c" not in health.stale_workers()
    health.reset()


def test_worker_step_recording_and_heartbeat(tmp_path):
    """[``:398``]"""
    health.reset()
    trace.enable(str(tmp_path / "w.jsonl"))
    before = metrics.WORKER_STEP.labels(worker="procX").count
    t0 = obs.now()
    obs.record_worker_step("procX", t0, t0 + 0.001, t0 + 0.002,
                           t0 + 0.010)
    trace.disable()
    assert metrics.WORKER_STEP.labels(worker="procX").count == before + 1
    assert metrics.WORKER_SYNC.labels(worker="procX").value > 0
    assert not health.check(stale_after=30)["procX"]["stale"]
    names = {e["name"] for e in trace.events()}
    assert "ParallelWrapper.fit/step" in names
    assert "ParallelWrapper.fit/collective_sync" in names
    fams = metrics.parse_exposition(metrics.exposition())
    assert fams[("dl4j_tpu_worker_stale", (("worker", "procX"),))] == 0
    health.reset()


def test_report_merges_trace_metrics_health(tmp_path):
    """[``:484``]"""
    trace.enable(str(tmp_path / "r.jsonl"))
    t0 = obs.now()
    trace.add_span("probe", t0, t0 + 0.001)
    rep = obs.report(spans=5)
    assert rep["trace"]["enabled"] is True
    assert rep["trace"]["events_recorded"] >= 1
    assert any(e.get("name") == "probe" for e in rep["spans"])
    assert "dl4j_tpu_step_latency_seconds" in rep["metrics"]
    assert isinstance(rep["health"], dict)
    json.dumps(rep)
    s = obs.summary()
    assert s["tracing"] is True and isinstance(s["step"], dict)
