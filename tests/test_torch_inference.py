"""``ParallelInference`` (``deeplearning4j_tpu_torch/parallel/inference.py``)
on the CPU against the JAX package's, on the same numpy inputs and the
JAX weights carried across.

Twins (the JAX test each stands for, in brackets):
- BATCHED serving of ten one-example requests from ``output_async``
  [``tests/test_parallel.py:712``]: the results equal the JAX
  ``ParallelInference``'s and the net's own ``output`` on the stacked
  batch within the reference's band (``rtol=1e-4, atol=1e-5``); so do
  INPLACE, and a request of several rows among single ones;
- a request of the wrong width raises to the caller [``:728``];
- an injected ``serving`` fault [``tests/test_resilience.py:357``]: the
  request errors fast (under 5 s) with the injected ``RuntimeError``,
  ``dl4j_tpu_faults_injected_total{site="serving"}`` moves by one, and
  the same worker serves the next request (its result the JAX one's);
- a request past its deadline in the queue is dropped with
  ``DeadlineExpiredError`` and counted as shed (reason ``deadline``), in
  both packages; a full queue sheds with ``QueueFullError`` (reason
  ``queue_full``), and ``shutdown`` errors out what is still queued
  with ``ServingShutdownError`` (reason ``shutdown``);
- the batch is zero-padded to its bucket: the network sees 4 rows for 3
  requests (buckets 1, 2, 4), the callers get their 3, the
  ``dl4j_tpu_inference_batch_size`` histogram reads 3 examples, and a
  ``ParallelInference/batch`` span is recorded;
- a ``ComputationGraph`` (two outputs) answers each request with its
  rows of both outputs, equal to ``output`` on the stacked batch;
- the refusals: ``warmup`` names ROADMAP A12; ``mesh=``,
  ``shard_params=True`` and ``shard_model_params`` name A13.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.config import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.parallel import inference as jinf
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.obs import metrics, trace
from deeplearning4j_tpu_torch.parallel import inference as pinf
from deeplearning4j_tpu_torch.resilience import faults

RTOL, ATOL = 1e-4, 1e-5     # tests/test_parallel.py:723's band


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conf(ns, seed, n_in, n_out, lr):
    """``tests/test_parallel.py`` ``_net`` (seed 42, 4 → 16 → 2) or
    ``tests/test_resilience.py`` ``_mlp`` (seed 11, 8 → 16 → 3) from the
    classes of ``ns``."""
    nc, it, dense, out, adam = ns
    return (nc.builder().seed(seed).updater(adam(learning_rate=lr)).list()
            .layer(dense(n_out=16, activation="tanh"))
            .layer(out(n_out=n_out, activation="softmax", loss="mcxent"))
            .set_input_type(it.feed_forward(n_in)).build())


_JAX = (JaxConf, JaxInputType, JaxDense, JaxOutput, jupd.Adam)
_PORT = (NeuralNetConfiguration, InputType, DenseLayer, OutputLayer,
         upd.Adam)
NETS = {"parallel": (42, 4, 2, 0.05), "resilience": (11, 8, 3, 5e-3)}


def _pair(which):
    """The JAX net and the port net (CPU) holding its weights."""
    seed, n_in, n_out, lr = NETS[which]
    jnet = JaxNet(_conf(_JAX, seed, n_in, n_out, lr)).init()
    net = MultiLayerNetwork(_conf(_PORT, seed, n_in, n_out, lr)).init(
        device="cpu")
    net.params_from_jax(jax.tree.map(np.asarray, jnet.params))
    return jnet, net


def _counter(metric, **labels):
    return (metric.labels(**labels) if labels else metric).get()


def _serve(pi, xs, **kw):
    try:
        obs = [pi.output_async(x, **kw) for x in xs]
        return [o.get(timeout=30) for o in obs]
    finally:
        pi.shutdown()


def test_parallel_inference_batched():
    jnet, net = _pair("parallel")
    xs = [np.random.default_rng(i).normal(size=(4,)).astype(np.float32)
          for i in range(10)]
    outs = _serve(pinf.ParallelInference(net, batch_limit=16), xs)
    jouts = _serve(jinf.ParallelInference(jnet, batch_limit=16), xs)
    assert all(isinstance(o, np.ndarray) and o.shape == (2,) for o in outs)
    direct = net.output(np.stack(xs)).numpy()
    np.testing.assert_allclose(np.stack(outs), direct, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.stack(outs), np.stack(jouts), rtol=RTOL,
                               atol=ATOL)


def test_inplace_and_multi_row_requests_match_jax():
    jnet, net = _pair("parallel")
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(4,)).astype(np.float32),
          rng.normal(size=(3, 4)).astype(np.float32),
          rng.normal(size=(4,)).astype(np.float32)]
    outs = _serve(pinf.ParallelInference(net, batch_limit=16), xs)
    jouts = _serve(jinf.ParallelInference(jnet, batch_limit=16), xs)
    assert [o.shape for o in outs] == [(2,), (3, 2), (2,)]
    for o, j in zip(outs, jouts):
        np.testing.assert_allclose(o, np.asarray(j), rtol=RTOL, atol=ATOL)
    pi = pinf.ParallelInference(net, mode=pinf.ParallelInference.INPLACE)
    jpi = jinf.ParallelInference(jnet, mode=jinf.ParallelInference.INPLACE)
    np.testing.assert_allclose(pi.output(xs[1]), np.asarray(jpi.output(
        xs[1])), rtol=RTOL, atol=ATOL)


def test_parallel_inference_error_propagates():
    _, net = _pair("parallel")
    pi = pinf.ParallelInference(net)
    try:
        with pytest.raises(Exception):
            pi.output(np.ones((3,), np.float32))  # wrong feature size
        out = pi.output(np.ones((4,), np.float32))  # the worker survived
        assert out.shape == (2,)
    finally:
        pi.shutdown()


def test_fault_matrix_serving_sheds_not_blocks():
    jnet, net = _pair("resilience")
    pi = pinf.ParallelInference(net, batch_limit=4, queue_limit=8,
                                buckets=(1, 2, 4))
    x = np.random.RandomState(0).randn(8, 8).astype(np.float32)
    f0 = _counter(metrics.FAULTS_INJECTED, site="serving")
    try:
        worker = pi._worker
        with faults.active("serving:error=RuntimeError:nth=1:max=1"):
            t0 = time.perf_counter()
            with pytest.raises(RuntimeError, match="injected fault"):
                pi.output(x[0], timeout=10.0)
            assert time.perf_counter() - t0 < 5.0    # fast error, no hang
        assert _counter(metrics.FAULTS_INJECTED, site="serving") == f0 + 1
        out = pi.output(x[1], timeout=10.0)          # the worker survived
        assert pi._worker is worker and worker.is_alive()
    finally:
        pi.shutdown()
    assert out.shape[-1] == 3
    jpi = jinf.ParallelInference(jnet, batch_limit=4, queue_limit=8,
                                 buckets=(1, 2, 4))
    try:
        np.testing.assert_allclose(out, np.asarray(jpi.output(x[1])),
                                   rtol=RTOL, atol=ATOL)
    finally:
        jpi.shutdown()


class _Gate:
    """A network whose ``output`` records the batch shape it is given and
    waits for ``release`` (``entered`` set first), so that a test can hold
    the worker mid-batch."""

    def __init__(self, net):
        self.net, self.seen = net, []
        self.entered, self.release = threading.Event(), threading.Event()

    def output(self, x):
        self.seen.append(tuple(x.shape))
        self.entered.set()
        assert self.release.wait(30)
        return self.net.output(x)


def _hold(pi, gate, x):
    """A first request that the worker holds inside ``gate``."""
    gate.release.clear()
    gate.entered.clear()
    ob = pi.output_async(x)
    assert gate.entered.wait(30)
    return ob


@pytest.mark.parametrize("package", ["port", "jax"])
def test_deadline_queue_full_and_shutdown_shed(package):
    """With the worker held mid-batch: a request whose deadline passes in
    the queue is dropped (``DeadlineExpiredError``), a request past the
    queue's bound is refused (``QueueFullError``), and ``shutdown`` errors
    out the rest (``ServingShutdownError``); each counted as shed by its
    reason. The JAX package's class behaves the same."""
    jnet, net = _pair("parallel")
    if package == "port":
        mod, m, gate = pinf, metrics, _Gate(net)
    else:
        from deeplearning4j_tpu.obs import metrics as m
        mod, gate = jinf, _Gate(jnet)
    shed = {r: _counter(m.REQS_SHED, reason=r)
            for r in ("deadline", "queue_full", "shutdown")}
    pi = mod.ParallelInference(gate, queue_limit=2)
    x = np.ones((4,), np.float32)
    first = _hold(pi, gate, x)
    late = pi.output_async(x, deadline_s=0.0)
    queued = pi.output_async(x)
    with pytest.raises(mod.QueueFullError):
        pi.output_async(x)
    gate.release.set()
    assert first.get(30).shape == (2,)
    with pytest.raises(mod.DeadlineExpiredError):
        late.get(30)
    assert queued.get(30).shape == (2,)
    held = _hold(pi, gate, x)
    waiting = pi.output_async(x)
    drained = []
    stopper = threading.Thread(target=lambda: drained.append(pi.shutdown()))
    stopper.start()
    while not pi._shutdown.is_set():
        time.sleep(0.01)
    gate.release.set()                 # the held batch completes
    stopper.join(30)
    assert held.get(30).shape == (2,)
    assert drained == [1]
    with pytest.raises(mod.ServingShutdownError):
        waiting.get(1)
    with pytest.raises(mod.ServingShutdownError):
        pi.output_async(x)
    for reason in shed:
        assert _counter(m.REQS_SHED, reason=reason) == shed[reason] + 1, \
            reason


def test_batch_padded_to_its_bucket_and_traced():
    _, net = _pair("parallel")
    gate = _Gate(net)
    hist = metrics.INFER_BATCH._children[()]
    n0, s0 = hist.count, hist.sum
    trace.enable(ring=64)
    pi = pinf.ParallelInference(gate, buckets=(1, 2, 4))
    try:
        xs = [np.full((4,), i, np.float32) for i in range(4)]
        first = _hold(pi, gate, xs[0])
        obs = [pi.output_async(x) for x in xs[1:]]
        gate.release.set()
        outs = [o.get(30) for o in (first, *obs)]
        spans = [e for e in trace.events()
                 if e.get("name") == "ParallelInference/batch"]
    finally:
        pi.shutdown()
        trace.reset()
    assert gate.seen == [(1, 4), (4, 4)]      # 3 requests, bucket 4
    direct = net.output(np.stack(xs)).numpy()
    np.testing.assert_allclose(np.stack(outs), direct, rtol=RTOL, atol=ATOL)
    assert (hist.count, hist.sum) == (n0 + 2, s0 + 4)
    assert [e["args"] for e in spans] == [
        {"requests": 1, "examples": 1}, {"requests": 3, "examples": 3}]


def test_graph_answers_with_every_output():
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.vertices import ElementWiseVertex
    conf = (NeuralNetConfiguration.builder().seed(1).graph_builder()
            .add_inputs("a")
            .add_layer("d", DenseLayer(n_out=8, activation="tanh"), "a")
            .add_layer("out1", OutputLayer(n_out=2, activation="softmax",
                                           loss="mcxent"), "d")
            .add_layer("out2", OutputLayer(n_out=1, activation="identity",
                                           loss="mse"), "d")
            .set_outputs("out1", "out2")
            .set_input_types(a=InputType.feed_forward(3)).build())
    assert ElementWiseVertex  # the graph module's vertices import
    net = ComputationGraph(conf).init(device="cpu")
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=(3,)).astype(np.float32),
          rng.normal(size=(2, 3)).astype(np.float32)]
    outs = _serve(pinf.ParallelInference(net), xs)
    o1, o2 = (o.numpy() for o in net.output(np.concatenate(
        [xs[0][None], xs[1]])))
    assert [a.shape for a in outs[0]] == [(2,), (1,)]
    assert [a.shape for a in outs[1]] == [(2, 2), (2, 1)]
    np.testing.assert_allclose(outs[0][0], o1[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outs[0][1], o2[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outs[1][0], o1[1:], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outs[1][1], o2[1:], rtol=RTOL, atol=ATOL)


def test_warmup_builds_every_bucket_before_the_first_request():
    """``ParallelInference.warmup`` (the JAX ``warmup``, formerly refused
    naming A12): one forward built a batch bucket, and the first request
    on a warmed bucket (3 rows, padded to 4) adds no trace; the output
    is the network's."""
    from deeplearning4j_tpu_torch.perf import sentry
    _, net = _pair("parallel")
    pi = pinf.ParallelInference(net, buckets=(2, 4))
    try:
        report = pi.warmup((4,))
        assert report["compiled"] == 2 and report["seconds"] > 0
        before = sentry.total_traces()
        x = np.random.default_rng(3).normal(size=(3, 4)).astype(np.float32)
        out = pi.output(x)
        assert out.shape == (3, 2)
        assert sentry.total_traces() == before
        np.testing.assert_allclose(out, net.output(x).numpy(), rtol=RTOL,
                                   atol=ATOL)
    finally:
        pi.shutdown()


def test_unported_options_raise_naming_their_items():
    _, net = _pair("parallel")
    for kw in ({"mesh": object()}, {"shard_params": True}):
        with pytest.raises(NotImplementedError, match="A13"):
            pinf.ParallelInference(net, **kw)
    with pytest.raises(NotImplementedError, match="A13"):
        pinf.shard_model_params(net, object())
    with pytest.raises(ValueError, match="unknown mode"):
        pinf.ParallelInference(net, mode="x")
