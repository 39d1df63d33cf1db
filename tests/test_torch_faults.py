"""The port's fault injection (``resilience/faults.py``) on the CPU: the
plan grammar and the off path (twins of ``tests/test_resilience.py``),
the ``worker_step`` site with ``ParallelWrapper``'s heartbeat and
retire at world size 1, the ``serving`` site (twin of
``tests/test_serving.py:434``) and the gateway's request traces (twins
of ``tests/test_serving.py:596``, ``:609`` and ``:663``). The ``step``
site is held in ``tests/test_torch_train_loop.py``.

Left without a twin: the checkpoint, iterator, elastic and router
sites of ``tests/test_resilience.py`` (their modules are not ported),
``FaultTolerantTrainer`` and the preemption handler.
"""
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.obs import health, metrics
from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                               data_parallel_mesh,
                                               initialize_distributed)
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.serving.gateway import (SequenceAborted,
                                                      ServingGateway)
from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.reset()
    yield
    faults.reset()
    obs.trace.reset()


def _mlp(seed=11):
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(upd.Adam(learning_rate=5e-3)).list()
            .layer(pl.DenseLayer(n_out=16, activation="tanh"))
            .layer(pl.OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.feed_forward(8)).build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _batches(n=4, b=12, seed=5):
    rng = np.random.RandomState(seed)
    return [DataSet(rng.randn(b, 8).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.randint(0, 3, b)])
            for _ in range(n)]


# =========================================================================
# the plan grammar and the off path
# =========================================================================
def test_plan_parse_roundtrip():
    """[``test_resilience.py:90``]"""
    p = faults.FaultPlan.parse(
        "ckpt_*:error=OSError:p=0.5:seed=3:max=2;step:nth=6")
    assert len(p.rules) == 2
    assert p.rules[0].error == "OSError" and p.rules[0].max_fires == 2
    assert p.rules[1].site == "step" and p.rules[1].nth == 6
    assert p.rules[0].matches("ckpt_write")
    assert p.rules[0].matches("ckpt_commit")
    assert not p.rules[0].matches("step")
    assert faults.FaultPlan.parse(p.describe()).describe() == p.describe()


def test_named_plans_all_parse():
    """[``:101``]"""
    for name in faults.NAMED_PLANS:
        assert faults.FaultPlan.parse(name).rules


@pytest.mark.parametrize("bad", ["", "step:frequency=2", "step:error=Nope",
                                 "step:p", "ckptwrite:error=OSError"])
def test_plan_parse_rejects(bad):
    """[``:108``]"""
    with pytest.raises(ValueError):
        faults.FaultPlan.parse(bad)


def test_non_finite_error_needs_the_numerics_module():
    with pytest.raises(NotImplementedError, match="A14"):
        faults.FaultPlan.parse("step:error=NonFiniteError:nth=1")


def test_seeded_probability_is_deterministic():
    """[``:113``]"""
    fire_pattern = []
    for _ in range(2):
        r = faults.FaultRule("s", p=0.5, seed=7, max_fires=1 << 30)
        fire_pattern.append([r.should_fire() for _ in range(32)])
    assert fire_pattern[0] == fire_pattern[1]
    assert any(fire_pattern[0]) and not all(fire_pattern[0])


def test_off_path_zero_evaluations():
    """[``:122``] with no plan active, training (single and grouped)
    passes every step site and the evaluation counter never moves; with
    a plan whose nth is far away the same paths evaluate sites."""
    assert faults.plan() is None
    net = _mlp()
    net.fit(ListDataSetIterator(_batches()))
    net.fit(ListDataSetIterator(_batches()), steps_per_loop=2)
    assert faults.evaluations() == 0
    assert faults.stats() == {}
    with faults.active("step:nth=1000000000"):
        net.fit(ListDataSetIterator(_batches()), steps_per_loop=2)
        assert faults.stats() == {"step:error=InjectedFault:"
                                  "nth=1000000000": {"evals": 2,
                                                     "fires": 0}}
    # the two groups' step site, and the iterator site at each of the
    # 4 batches (data/iterators.py)
    assert faults.evaluations() == 2 + 4


def test_process_level_kinds():
    """``error=sigterm`` signals the process itself; ``error=exit``
    ends it with status 17 (no finally block runs)."""
    got = []
    prev = signal.signal(signal.SIGTERM, lambda *a: got.append(a[0]))
    try:
        with faults.active("step:error=sigterm:nth=1:max=1"):
            faults.inject("step")
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert got == [signal.SIGTERM]
    prog = ("from deeplearning4j_tpu_torch.resilience import faults\n"
            "faults.activate('step:error=exit:nth=1')\n"
            "try:\n    faults.inject('step')\n"
            "finally:\n    print('finally ran')\n")
    r = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 17 and "finally ran" not in r.stdout


def test_plan_from_the_environment(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FAULT_PLAN", "worker-crash")
    plan = faults.configure_from_env()
    assert faults.plan() is plan
    assert plan.describe() == "step:error=ConnectionError:nth=6:max=1"
    monkeypatch.setenv("DL4J_TPU_FAULT_PLAN", "")
    faults.reset()
    assert faults.configure_from_env() is None and faults.plan() is None


# =========================================================================
# worker_step: ParallelWrapper at world size 1
# =========================================================================
@pytest.fixture
def one_rank_group():
    assert not dist.is_initialized()
    initialize_distributed()
    yield
    dist.destroy_process_group()


def test_wrapper_heartbeat_retire_and_worker_step_site(one_rank_group):
    health.reset()
    net = _mlp()
    w = ParallelWrapper(net, mesh=data_parallel_mesh())
    before = metrics.WORKER_STEP.labels(worker="proc0").count
    w.fit(ListDataSetIterator(_batches()))
    assert metrics.WORKER_STEP.labels(worker="proc0").count - before == 4
    assert metrics.FIT_ETL_SECONDS.labels(
        entry="ParallelWrapper.fit").get() > 0
    # a normal end retires the beat: no permanent false alarm
    assert "proc0" not in health.check(stale_after=30)
    assert faults.evaluations() == 0
    it0 = net.iteration
    fired0 = metrics.FAULTS_INJECTED.labels(site="worker_step").get()
    with faults.active("worker_step:error=OSError:nth=2:max=1"):
        with pytest.raises(OSError, match="injected fault"):
            w.fit(ListDataSetIterator(_batches()))
    # the fire came after the first batch's step, before the second's
    assert net.iteration == it0 + 1
    assert metrics.FAULTS_INJECTED.labels(site="worker_step").get() \
        == fired0 + 1
    # a crashed loop keeps its beat, so the stale alarm can fire
    assert "proc0" in health.check(stale_after=30)
    health.reset()


# =========================================================================
# serving: the fault site and the request traces
# =========================================================================
@pytest.fixture(scope="module")
def tiny():
    model = CausalTransformerLM(hidden=32, n_layers=2, n_heads=2,
                                n_kv_heads=1, max_len=64, seed=9,
                                vocab_size=64)
    return model, model.init_params(device="cpu")


def test_injected_fault_sheds_inflight_and_recovers(tiny):
    """[``test_serving.py:434``]"""
    model, params = tiny
    gw = ServingGateway(model, params, max_slots=2, block=8,
                        max_context=64, default_max_new=30,
                        queue_limit=16)
    gw.warmup(prompt_lens=(4,))
    shed0 = metrics.SERVING_SHED.labels(reason="fault").get()
    try:
        with faults.active("serving:error=RuntimeError:nth=3:max=1"):
            victims = [gw.submit(np.full(4, i, np.int32))
                       for i in range(2)]
            errors = 0
            for st in victims:
                try:
                    st.result(timeout=60)
                except SequenceAborted as e:
                    errors += 1
                    assert e.tokens, "the error carries the streamed tokens"
                    assert e.tokens == st._tokens, \
                        "cross-request token leakage in shed error"
            assert errors == 2
            assert victims[0]._tokens != victims[1]._tokens
            fired = sum(s["fires"] for s in faults.stats().values())
        assert fired == 1
        assert metrics.SERVING_SHED.labels(reason="fault").get() \
            == shed0 + 2
        gw._sched.pager.check_invariants()
        assert gw._sched.pager.free_pages() == gw._sched.pager.n_pages - 1
        post = gw.submit(np.zeros(4, np.int32), max_new=4)
        assert post.result(timeout=60).shape == (8,)
    finally:
        gw.shutdown()


def test_request_traces_off_path_zero_events(tiny):
    """[``:596``]"""
    model, params = tiny
    gw = ServingGateway(model, params, max_slots=2, block=8,
                        max_context=32, default_max_new=4)
    gw.warmup(prompt_lens=(4,))
    e0 = obs.trace.events_recorded()
    gw.submit(np.arange(4, dtype=np.int32) % 64).result(timeout=60)
    gw.shutdown()
    assert obs.trace.events_recorded() == e0
    assert faults.evaluations() == 0


def test_request_traces_nested_phases_with_ids(tiny, tmp_path):
    """[``:609``]"""
    model, params = tiny
    gw = ServingGateway(model, params, max_slots=2, block=8,
                        max_context=32, default_max_new=4)
    gw.warmup(prompt_lens=(4,))
    path = str(tmp_path / "serving_trace.jsonl")
    obs.trace.enable(path)
    try:
        streams = [gw.submit(np.arange(4, dtype=np.int32) % 64,
                             tenant=f"t{i % 2}") for i in range(3)]
        for s in streams:
            s.result(timeout=60)
    finally:
        obs.trace.disable()
    gw.shutdown()
    evs = obs.trace.read_trace(path)
    reqs = [e for e in evs
            if str(e.get("name", "")).startswith("serving.request")]
    by_phase = {}
    for e in reqs:
        by_phase.setdefault(e["name"], []).append(e)
    for phase in ("serving.request", "serving.request/queue_wait",
                  "serving.request/prefill",
                  "serving.request/decode_steps"):
        pair = by_phase[phase]
        assert {p["ph"] for p in pair} == {"b", "e"}
        assert len(pair) == 6       # 3 requests x (b, e)
    assert len(by_phase["serving.request/submit"]) == 3
    ids = {e["id"] for e in reqs if e.get("ph") in ("b", "e")}
    assert len(ids) == 3
    lives = [e for e in by_phase["serving.request"] if e["ph"] == "b"]
    assert {e["args"]["tenant"] for e in lives} == {"t0", "t1"}
    assert all(e["args"]["outcome"] == "retired" for e in lives)
    assert all(e["args"]["tokens"] == 4 for e in lives)
    for life in lives:
        rid = life["id"]
        end = next(e for e in by_phase["serving.request"]
                   if e["ph"] == "e" and e["id"] == rid)
        for phase in ("serving.request/queue_wait",
                      "serving.request/prefill",
                      "serving.request/decode_steps"):
            inner = [e for e in by_phase[phase] if e["id"] == rid]
            assert inner, (phase, rid)
            assert all(life["ts"] <= e["ts"] <= end["ts"] + 1e-3
                       for e in inner)
    names = [e for e in evs if e.get("name") == "thread_name"
             and e["args"]["name"] == "serving-gateway"]
    assert names


def test_aborted_request_trace_carries_outcome(tiny, tmp_path):
    """[``:663``]"""
    model, params = tiny
    gw = ServingGateway(model, params, max_slots=2, block=8,
                        max_context=32, default_max_new=8)
    gw.warmup(prompt_lens=(4,))
    path = str(tmp_path / "abort_trace.jsonl")
    obs.trace.enable(path)
    try:
        with faults.active("serving:error=RuntimeError:nth=2:max=1"):
            st = gw.submit(np.arange(4, dtype=np.int32) % 64)
            with pytest.raises(SequenceAborted):
                st.result(timeout=60)
    finally:
        obs.trace.disable()
    gw.shutdown()
    evs = obs.trace.read_trace(path)
    lives = [e for e in evs if e.get("name") == "serving.request"
             and e.get("ph") == "b"]
    assert len(lives) == 1
    assert lives[0]["args"]["outcome"].startswith("aborted:")
    assert lives[0]["args"]["tokens"] >= 1
