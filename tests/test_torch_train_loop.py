"""The port's ``steps_per_loop`` K-step region on the CPU, held against
its own one-``fit``-a-batch runs and against the JAX package's scanned
device loop (``tests/test_train_loop.py``), from the same numpy batches
and carried-across weights.

Bands:
- grouped against sequential in the port: equal to the bit (the same
  updates in the same order on the same tensors);
- the port against the JAX package: the JAX test's own band, 2e-5
  relative and 2e-6 absolute on every parameter, for the dense nets;
  for the BERT classifier (AdamW at lr 2e-5 under a schedule) 1e-6
  absolute, a twentieth of one step (``tests/test_torch_bert.py`` holds
  three steps of the same model within lr/3).
"""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.data import ListDataSetIterator as JListIt
from deeplearning4j_tpu.data import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.zoo.bert import BertTiny as JBertTiny
from deeplearning4j_tpu_torch import obs, tree
from deeplearning4j_tpu_torch.data import (DataSet, ListDataSetIterator,
                                           MultiDataSet)
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.zoo import BertTiny

JAX_RTOL, JAX_ATOL = 2e-5, 2e-6
BERT_TOL = 1e-6
BERT_T = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_plan():
    faults.reset()
    yield
    faults.reset()


def _arrays(n=6, b=32, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((b, 4)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
        out.append((x, y))
    return out


def _mln_pair(updater=("Adam", {"learning_rate": 0.01}), schedule=None):
    name, kw = updater
    ju, pu = getattr(jupd, name)(**kw), getattr(pupd, name)(**kw)
    if schedule is not None:
        ju.schedule, pu.schedule = schedule(jupd), schedule(pupd)
    jconf = (JConf.builder().seed(7).updater(ju).list()
             .layer(JDense(n_out=8, activation="relu"))
             .layer(JOutput(n_out=2, activation="softmax", loss="mcxent"))
             .set_input_type(JInputType.feed_forward(4)).build())
    pconf = (NeuralNetConfiguration.builder().seed(7).updater(pu).list()
             .layer(pl.DenseLayer(n_out=8, activation="relu"))
             .layer(pl.OutputLayer(n_out=2, activation="softmax",
                                   loss="mcxent"))
             .set_input_type(InputType.feed_forward(4)).build())
    jnet = JMLN(jconf).init()
    return jnet, lambda: MultiLayerNetwork(pconf).init(
        device="cpu").params_from_jax(jax.tree.map(np.asarray,
                                                   jnet.params))


def _graph_pair():
    jconf = (JConf.builder().seed(11)
             .updater(jupd.Sgd(learning_rate=0.05)).graph_builder()
             .add_inputs("in")
             .add_layer("d", JDense(n_out=8, activation="tanh"), "in")
             .add_layer("out", JOutput(n_out=2, activation="softmax",
                                       loss="mcxent"), "d")
             .set_outputs("out")
             .set_input_types(**{"in": JInputType.feed_forward(4)})
             .build())
    pconf = (NeuralNetConfiguration.builder().seed(11)
             .updater(pupd.Sgd(learning_rate=0.05)).graph_builder()
             .add_inputs("in")
             .add_layer("d", pl.DenseLayer(n_out=8, activation="tanh"),
                        "in")
             .add_layer("out", pl.OutputLayer(n_out=2,
                                              activation="softmax",
                                              loss="mcxent"), "d")
             .set_outputs("out")
             .set_input_types(**{"in": InputType.feed_forward(4)})
             .build())
    jnet = JGraph(jconf).init()
    return jnet, lambda: ComputationGraph(pconf).init(
        device="cpu").params_from_jax(jax.tree.map(np.asarray,
                                                   jnet.params))


def _same_bits(a, b):
    for p, q in zip(tree.leaves(a.params), tree.leaves(b.params)):
        assert torch.equal(p, q)
    for p, q in zip(tree.leaves(a.opt_state), tree.leaves(b.opt_state)):
        assert torch.equal(p, q)


def _near_jax(pnet, jnet, rtol=JAX_RTOL, atol=JAX_ATOL):
    """Every port parameter against the JAX one at its key path."""
    def check(path, t):
        want = jnet.params
        for k in path:
            want = want[k]
        np.testing.assert_allclose(t.numpy(), np.asarray(want),
                                   rtol=rtol, atol=atol,
                                   err_msg=".".join(path))
        return t
    tree.map_with_path(check, pnet.params)
    assert len(list(tree.leaves(pnet.params))) == \
        len(jax.tree.leaves(jnet.params))


def _counting(net):
    """Count ``_fit_batch`` calls (per-batch dispatch) on ``net``."""
    calls = []
    orig = net._fit_batch
    net._fit_batch = lambda *a, **k: (calls.append(1), orig(*a, **k))[1]
    return calls


def test_mln_steps_per_loop_matches_sequential():
    """[``test_train_loop.py:39``] groups of 4 + 2 equal six single fits
    (bit for bit), and the JAX package's grouped fit."""
    data = _arrays()
    jnet, make = _mln_pair()
    a, b = make(), make()
    a.fit(ListDataSetIterator([DataSet(x, y) for x, y in data]))
    calls = _counting(b)
    b.fit(ListDataSetIterator([DataSet(x, y) for x, y in data]),
          steps_per_loop=4)
    assert not calls
    assert a.iteration == b.iteration == len(data)
    _same_bits(a, b)
    assert a.score() == b.score()
    jnet.fit(JListIt([JDataSet(x, y) for x, y in data]), steps_per_loop=4)
    _near_jax(b, jnet)
    assert abs(b.score() - jnet.score()) < 1e-5


def test_graph_steps_per_loop_matches_sequential():
    """[``:51``]"""
    data = _arrays()
    jnet, make = _graph_pair()
    a, b = make(), make()
    a.fit(ListDataSetIterator([DataSet(x, y) for x, y in data]))
    calls = _counting(b)
    b.fit(ListDataSetIterator([DataSet(x, y) for x, y in data]),
          steps_per_loop=3)
    assert not calls
    _same_bits(a, b)
    jnet.fit(JListIt([JDataSet(x, y) for x, y in data]), steps_per_loop=3)
    _near_jax(b, jnet)


def test_steps_per_loop_shape_change_flushes():
    """[``:77``] 4 batches of 32 and 3 of 16: the change of shape
    flushes, and the result equals seven single fits."""
    data = _arrays(4, b=32) + _arrays(3, b=16, seed=2)
    _, make = _mln_pair()
    a, b = make(), make()
    for x, y in data:
        a.fit(x, y)
    groups = []
    orig = b._fit_group
    b._fit_group = lambda g: (groups.append(len(g)), orig(g))[1]
    b.fit(ListDataSetIterator([DataSet(x, y) for x, y in data]),
          steps_per_loop=4)
    assert groups == [4, 3]
    assert b.iteration == len(data)
    assert np.isfinite(b.score())
    _same_bits(a, b)


def test_mln_masked_batch_runs_alone_and_flushes():
    """The network groups mask-free batches only (JAX
    ``multilayer.py:578-579``): a masked batch flushes the open group
    and runs as a single batch."""
    data = _arrays(5, b=8)
    _, make = _mln_pair()
    net = make()
    groups = []
    orig = net._fit_group
    net._fit_group = lambda g: (groups.append(len(g)), orig(g))[1]
    batches = [DataSet(x, y) for x, y in data]
    batches[2] = DataSet(data[2][0], data[2][1],
                         labels_mask=np.ones(8, np.float32))
    single = _counting(net)
    net.fit(ListDataSetIterator(batches), steps_per_loop=2)
    assert groups == [2, 2] and len(single) == 1
    assert net.iteration == 5


def test_grouping_under_a_schedule_equals_sequential_fits():
    """A warmup-into-cosine AdamW: the schedule's counter runs on the
    device through the region exactly as through single fits."""
    data = _arrays(8, b=16)

    def sched(mod):
        return mod.WarmupSchedule(warmup_steps=3, base=mod.CosineSchedule(
            initial=0.05, max_iter=8))
    jnet, make = _mln_pair(("AdamW", {"learning_rate": 0.05,
                                      "weight_decay": 0.01}), sched)
    a, b = make(), make()
    for x, y in data:
        a.fit(x, y)
    b.fit(ListDataSetIterator([DataSet(x, y) for x, y in data]),
          steps_per_loop=4)
    _same_bits(a, b)
    for group in b.opt_state.values():
        assert int(group["schedule_count"]) == 8
    jnet.fit(JListIt([JDataSet(x, y) for x, y in data]), steps_per_loop=4)
    _near_jax(b, jnet)


def test_region_records_one_step_span_per_group(tmp_path):
    """The region's ``record_step`` carries ``steps``: one
    ``MultiLayerNetwork.fit/step`` span a group, and an ``/etl`` span a
    batch."""
    _, make = _mln_pair()
    net = make()
    obs.trace.enable(str(tmp_path / "t.jsonl"))
    try:
        net.fit(ListDataSetIterator([DataSet(x, y)
                                     for x, y in _arrays(8, b=8)]),
                steps_per_loop=4)
    finally:
        obs.trace.reset()
    evs = obs.trace.read_trace(str(tmp_path / "t.jsonl"))
    steps = [e for e in evs if e.get("name") == "MultiLayerNetwork.fit/step"]
    assert [e["args"] for e in steps] == [{"steps": 4}, {"steps": 4}]
    assert sum(e.get("name") == "MultiLayerNetwork.fit/etl"
               for e in evs) == 8


# -- masked BERT groups -----------------------------------------------------
def _bert_batches(n=6, b=4, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, 1000, (b, BERT_T)).astype(np.int32)
        lens = rng.integers(4, BERT_T + 1, b)
        split = rng.integers(1, lens)
        seg = (np.arange(BERT_T)[None, :]
               >= split[:, None]).astype(np.int32)
        mask = (np.arange(BERT_T)[None, :]
                < lens[:, None]).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)]
        out.append((tok, seg, mask, y))
    return out


def _bert_pair():
    def kw(mod):
        return dict(max_len=BERT_T, dropout=0.0, seed=4,
                    updater=mod.AdamW(
                        learning_rate=2e-5, weight_decay=0.01,
                        exclude_bias_and_norm=True,
                        schedule=mod.WarmupSchedule(
                            warmup_steps=2, base=mod.CosineSchedule(
                                initial=2e-5, max_iter=6))))
    jnet = JBertTiny(**kw(jupd)).init_classifier(2, BERT_T)
    return jnet, lambda: BertTiny(**kw(pupd)).init_classifier(
        2, BERT_T, device="cpu").params_from_jax(
            jax.tree.map(np.asarray, jnet.params))


class _ListIt:
    def __init__(self, items):
        self.items = items

    def reset(self):
        pass

    def __iter__(self):
        return iter(self.items)


def test_graph_steps_per_loop_groups_masked_batches():
    """[``:128``] on a 2-layer BERT classifier with key masks (the JAX
    test's LSTM graph is red for another reason, ``ROADMAP.md`` C):
    masked batches of one mask structure keep the region — no per-batch
    dispatch for full groups — and the grouped fit equals sequential
    fits and the JAX package's grouped fit."""
    data = _bert_batches()
    jnet, make = _bert_pair()
    a, b = make(), make()
    for tok, seg, mask, y in data:
        a.fit([tok, seg], [y], features_masks=[mask, mask])
    calls = _counting(b)
    b.fit(_ListIt([MultiDataSet([tok, seg], [y],
                                features_masks=[mask, mask])
                   for tok, seg, mask, y in data]), steps_per_loop=3)
    assert not calls, "masked batches fell out of the region"
    assert a.iteration == b.iteration == len(data)
    _same_bits(a, b)
    jcalls = []
    jorig = jnet._fit_batch
    jnet._fit_batch = lambda *x, **k: (jcalls.append(1), jorig(*x, **k))[1]
    jnet.fit(_ListIt([JMultiDataSet([tok, seg], [y],
                                    features_masks=[mask, mask])
                      for tok, seg, mask, y in data]), steps_per_loop=3)
    assert not jcalls and jnet.iteration == len(data)
    _near_jax(b, jnet, rtol=0, atol=BERT_TOL)


def test_graph_mask_structure_change_flushes():
    """A batch without masks between masked ones changes the group
    signature: it flushes the open group."""
    data = _bert_batches(5)
    _, make = _bert_pair()
    net = make()
    groups = []
    orig = net._fit_group
    net._fit_group = lambda g: (groups.append(len(g)), orig(g))[1]
    single = _counting(net)
    items = [MultiDataSet([tok, seg], [y], features_masks=[mask, mask])
             for tok, seg, mask, y in data]
    tok, seg, _, y = data[2]
    items[2] = MultiDataSet([tok, seg], [y])
    net.fit(_ListIt(items), steps_per_loop=2)
    assert groups == [2, 2] and len(single) == 1


# -- the step fault site ----------------------------------------------------
def _snapshot(net):
    return ([t.clone() for t in tree.leaves(net.params)],
            [t.clone() for t in tree.leaves(net.opt_state)],
            net.iteration)


def _same_snapshot(a, b):
    assert a[2] == b[2]
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["network", "graph"])
@pytest.mark.parametrize("steps_per_loop", [1, 2])
def test_step_site_raises_before_any_change(kind, steps_per_loop):
    """``step:error=ConnectionError:nth=2:max=1`` raises at the second
    group (or batch) before anything is staged: the params, the
    optimizer state and ``iteration`` equal those after the first."""
    data = _arrays(4, b=8)
    make = (_mln_pair() if kind == "network" else _graph_pair())[1]
    net, ref = make(), make()
    ref.fit(ListDataSetIterator([DataSet(x, y)
                                 for x, y in data[:steps_per_loop]]),
            steps_per_loop=steps_per_loop)
    fired0 = obs.metrics.FAULTS_INJECTED.labels(site="step").get()
    with faults.active("step:error=ConnectionError:nth=2:max=1"):
        with pytest.raises(ConnectionError, match="injected fault"):
            net.fit(ListDataSetIterator([DataSet(x, y) for x, y in data]),
                    steps_per_loop=steps_per_loop)
    _same_snapshot(_snapshot(net), _snapshot(ref))
    assert obs.metrics.FAULTS_INJECTED.labels(site="step").get() \
        == fired0 + 1
