"""The five training listeners (``train/listeners.py``) and the
networks' listener calls, on the CPU against the JAX package: a
recording listener sees the same calls — ``on_epoch_start``,
``iteration_done(iteration, epoch)`` with that step's ``score_``,
``on_epoch_end`` — in the same order from both packages' fits, single
batch by batch and in ``steps_per_loop`` regions (where the port calls
them after the group's one device-to-host copy, step by step), for a
``MultiLayerNetwork`` and a ``ComputationGraph``; each listener then
does the JAX one's work (the logged scores, the collected scores, the
evaluations, the ETL report, the checkpoints); the ``fit/listeners``
trace span covers the calls; the orbax path (``sharded=True``) is
refused naming ROADMAP A14.

Tolerance: the scores the listeners see, port against JAX, 1e-5
relative (the same f32 math in another order); the iterations, epochs
and call order are equal.
"""
import logging

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import \
    ListDataSetIterator as JListIt
from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.train import listeners as jl
from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.data import (AsyncDataSetIterator, DataSet,
                                           ListDataSetIterator)
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.train import (CheckpointListener,
                                            CollectScoresListener,
                                            EvaluativeListener,
                                            PerformanceListener,
                                            ScoreIterationListener,
                                            TrainingListener)

TOL = 1e-5
N_BATCHES = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches():
    rng = np.random.default_rng(4)
    return [(rng.normal(size=(8, 5)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
            for _ in range(N_BATCHES)]


def _pair():
    jnet = JNet(JConf.builder().seed(3)
                .updater(jupd.Adam(learning_rate=1e-2)).list()
                .layer(JDense(n_out=7, activation="tanh"))
                .layer(JOut(n_out=3, activation="softmax", loss="mcxent"))
                .set_input_type(JInputType.feed_forward(5)).build()).init()
    pnet = MultiLayerNetwork(
        NeuralNetConfiguration.builder().seed(3)
        .updater(pupd.Adam(learning_rate=1e-2)).list()
        .layer(pl.DenseLayer(n_out=7, activation="tanh"))
        .layer(pl.OutputLayer(n_out=3, activation="softmax",
                              loss="mcxent"))
        .set_input_type(InputType.feed_forward(5)).build()).init(
            device="cpu")
    pnet.params_from_jax(jax.tree.map(np.asarray, jnet.params))
    return jnet, pnet


class _Recorder:
    """Records every call with the iteration, epoch and ``score_`` it
    sees (duck-typed, so both packages' networks call it)."""

    def __init__(self):
        self.calls = []

    def iteration_done(self, net, iteration, epoch):
        self.calls.append(("iter", iteration, epoch, float(net.score_)))

    def on_epoch_start(self, net):
        self.calls.append(("start", net.iteration, net.epoch, None))

    def on_epoch_end(self, net):
        self.calls.append(("end", net.iteration, net.epoch, None))


def _same_calls(a, b):
    assert [c[:3] for c in a] == [c[:3] for c in b]
    for x, y in zip(a, b):
        if x[3] is not None:
            assert np.isclose(x[3], y[3], rtol=TOL, atol=0), (x, y)


@pytest.mark.parametrize("steps_per_loop", [1, 4])
def test_listeners_see_the_jax_calls(steps_per_loop):
    """Two epochs of 6 batches: with K = 4 each epoch runs one 4-step
    region and one region of 2; the listener sees every step's own
    score, as in the JAX package's scanned loop."""
    jnet, pnet = _pair()
    rec_j, rec_p = _Recorder(), _Recorder()
    jnet.set_listeners(rec_j)
    pnet.set_listeners(rec_p)
    data = _batches()
    jnet.fit(JListIt([JDataSet(x, y) for x, y in data]), epochs=2,
             steps_per_loop=steps_per_loop)
    pnet.fit(ListDataSetIterator([DataSet(x, y) for x, y in data]),
             epochs=2, steps_per_loop=steps_per_loop)
    assert len(rec_p.calls) == 2 * (N_BATCHES + 2)
    _same_calls(rec_j.calls, rec_p.calls)
    assert len({c[3] for c in rec_p.calls if c[0] == "iter"}) == \
        2 * N_BATCHES                     # each step's own score


def test_regions_and_single_steps_give_listeners_the_same_calls():
    _, grouped = _pair()
    _, single = _pair()
    rec_g, rec_s = _Recorder(), _Recorder()
    grouped.add_listeners(rec_g)
    single.add_listeners(rec_s)
    it = ListDataSetIterator([DataSet(x, y) for x, y in _batches()])
    grouped.fit(it, steps_per_loop=3)
    single.fit(it)
    assert rec_g.calls == rec_s.calls     # to the bit, one package


def test_graph_listeners_see_the_calls():
    conf = (NeuralNetConfiguration.builder().seed(3)
            .updater(pupd.Sgd(learning_rate=0.1)).graph_builder()
            .add_inputs("in")
            .add_layer("d", pl.DenseLayer(n_out=4, activation="tanh"), "in")
            .add_layer("out", pl.OutputLayer(n_out=3, activation="softmax",
                                             loss="mcxent"), "d")
            .set_outputs("out")
            .set_input_types(**{"in": InputType.feed_forward(5)}).build())
    runs = {}
    for k in (1, 4):
        g = ComputationGraph(conf).init(device="cpu")
        rec = _Recorder()
        g.set_listeners(rec)
        g.fit(ListDataSetIterator([DataSet(x, y) for x, y in _batches()]),
              steps_per_loop=k)
        runs[k] = rec.calls
    assert runs[1] == runs[4]
    assert [c[0] for c in runs[1]] == ["start"] + ["iter"] * N_BATCHES + [
        "end"]
    assert g.iteration == N_BATCHES and g.epoch == 1


def test_fit_on_one_batch_calls_iteration_done_only():
    _, pnet = _pair()
    rec = _Recorder()
    pnet.set_listeners(rec)
    x, y = _batches()[0]
    pnet.fit(x, y)
    pnet.fit(DataSet(x, y))
    assert [c[:3] for c in rec.calls] == [("iter", 1, 0), ("iter", 2, 0)]
    pnet.set_listeners()
    pnet.fit(x, y)
    assert len(rec.calls) == 2


def test_score_and_collect_listeners_match_jax(caplog):
    jnet, pnet = _pair()
    jc, pc = jl.CollectScoresListener(), CollectScoresListener()
    jnet.set_listeners(jc, jl.ScoreIterationListener(2))
    pnet.set_listeners(pc, ScoreIterationListener(2))
    data = _batches()
    with caplog.at_level(logging.INFO):
        jnet.fit(JListIt([JDataSet(x, y) for x, y in data]),
                 steps_per_loop=3)
        pnet.fit(ListDataSetIterator([DataSet(x, y) for x, y in data]),
                 steps_per_loop=3)
    assert [i for i, _ in pc.scores] == [i for i, _ in jc.scores] == list(
        range(1, N_BATCHES + 1))
    np.testing.assert_allclose([s for _, s in pc.scores],
                               [s for _, s in jc.scores], rtol=TOL)
    logged = [r.getMessage() for r in caplog.records
              if r.name == "deeplearning4j_tpu_torch"
              and r.getMessage().startswith("Score at iteration")]
    assert [m.split()[3] for m in logged] == ["2", "4", "6"]


def test_evaluative_listener_matches_jax():
    jnet, pnet = _pair()
    data = _batches()
    jres, pres = [], []
    jnet.set_listeners(jl.EvaluativeListener(
        JListIt([JDataSet(x, y) for x, y in data]), frequency_iters=3,
        frequency_epochs=1, callback=jres.append))
    pnet.set_listeners(EvaluativeListener(
        ListDataSetIterator([DataSet(x, y) for x, y in data]),
        frequency_iters=3, frequency_epochs=1, callback=pres.append))
    jnet.fit(JListIt([JDataSet(x, y) for x, y in data]), epochs=2)
    pnet.fit(ListDataSetIterator([DataSet(x, y) for x, y in data]),
             epochs=2)
    assert len(pres) == len(jres) == 2 * 2 + 2
    assert [e.accuracy() for e in pres] == [e.accuracy() for e in jres]
    assert pnet.listeners[0].last_evaluation is pres[-1]


def test_performance_listener_reports_etl():
    """Twin of ``tests/test_data.py::test_performance_listener_reports_etl``,
    and in a fit fed by the prefetch iterator."""
    class _B:
        batch_size = 1

        def __iter__(self):
            return iter([])

    it = AsyncDataSetIterator(_B())
    it.etl_wait_seconds = 0.5
    msgs = []
    pl_ = PerformanceListener(frequency=1, report=msgs.append, iterator=it)

    class FakeNet:
        score_ = 1.0

        def score(self):
            raise AssertionError("a listener must not score the network")
    pl_.iteration_done(FakeNet(), 1, 0)
    pl_.iteration_done(FakeNet(), 2, 0)
    assert any("ETL wait 500.0 ms" in m for m in msgs)
    _, pnet = _pair()
    src = AsyncDataSetIterator(ListDataSetIterator(
        [DataSet(x, y) for x, y in _batches()]))
    msgs = []
    pnet.set_listeners(PerformanceListener(frequency=2, report=msgs.append,
                                           iterator=src))
    pnet.fit(src, steps_per_loop=2)
    assert len(msgs) == 2 and all("iter/sec" in m and "ETL wait" in m
                                  for m in msgs)


def test_checkpoint_listener_every_n_iterations(tmp_path):
    jnet, pnet = _pair()
    data = _batches()
    jnet.set_listeners(jl.CheckpointListener(
        tmp_path / "j", save_every_n_iterations=2, keep_last=10))
    pnet.set_listeners(CheckpointListener(
        tmp_path / "p", save_every_n_iterations=2, keep_last=10))
    jnet.fit(JListIt([JDataSet(x, y) for x, y in data]), steps_per_loop=4)
    pnet.fit(ListDataSetIterator([DataSet(x, y) for x, y in data]),
             steps_per_loop=4)
    names = sorted(p.name for p in (tmp_path / "p").glob("*.zip"))
    assert names == sorted(p.name for p in (tmp_path / "j").glob("*.zip"))
    assert names == [f"checkpoint_iter_{i}.zip" for i in (2, 4, 6)]


def test_sharded_checkpoint_listener_is_refused_naming_a14(tmp_path):
    with pytest.raises(NotImplementedError, match="A14"):
        CheckpointListener(tmp_path, save_every_n_epochs=1, sharded=True)


def test_listener_span_covers_the_calls(tmp_path):
    """The ``MultiLayerNetwork.fit/listeners`` span: one a single step,
    one a region (twin of the listeners part of ``tests/test_obs.py::
    test_ten_step_fit_trace_covers_wall_time``)."""
    path = tmp_path / "fit.jsonl"
    obs.trace.enable(str(path))
    try:
        _, pnet = _pair()
        pnet.set_listeners(TrainingListener(), ScoreIterationListener(5))
        it = ListDataSetIterator([DataSet(x, y) for x, y in _batches()])
        pnet.fit(it)
        pnet.fit(it, steps_per_loop=3)
    finally:
        obs.trace.disable()
    evs = [e for e in obs.trace.read_trace(str(path)) if e.get("ph") == "X"]
    spans = [e for e in evs if e["name"] == "MultiLayerNetwork.fit/listeners"]
    assert len(spans) == N_BATCHES + 2


def test_wrapper_calls_iteration_done_after_each_step():
    """``ParallelWrapper.fit`` calls the net's listeners after each step,
    as the JAX wrapper does (``iteration_done`` only), here at one rank
    of an in-process gloo group, its batches drawn by the prefetch
    thread."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                                   initialize_distributed)
    assert not dist.is_initialized()
    initialize_distributed()
    try:
        _, pnet = _pair()
        rec = _Recorder()
        pnet.set_listeners(rec)
        ParallelWrapper(pnet, prefetch_buffer=2).fit(ListDataSetIterator(
            [DataSet(x, y) for x, y in _batches()]), epochs=2)
    finally:
        dist.destroy_process_group()
    assert [c[:3] for c in rec.calls] == [
        ("iter", i + 1, i // N_BATCHES) for i in range(2 * N_BATCHES)]
    assert rec.calls[-1][3] == pnet.score_
