"""The evaluation slice on the CPU, in one process: the port's
``eval_/`` classes, ``ListDataSetIterator``, both networks' ``evaluate``
and the Spark facades' evaluation against the JAX package's, from the
same seeded numpy inputs and carried-across weights.

Twins (the JAX test each stands for, in brackets):
- the ten tests of ``tests/test_eval_merge.py`` [``:28`` … ``:172``]:
  each scenario runs on both packages' classes; the JAX test's own
  assertions hold on the port's side, and the port's statistics equal
  the JAX package's;
- the three ``TestROCBinary`` tests
  [``tests/test_vertices_preprocessors.py:159-190``];
- the XOR net through a shuffled ``ListDataSetIterator``
  [``tests/test_multilayer.py:86``]: trained by the JAX package, its
  weights carried across by ``params_from_jax``; the iterators yield the
  same batches and the confusion matrices are equal;
- ``do_evaluation`` on the 2-input, 2-output graph
  [``tests/test_parallel.py:360``], and the port graph's ``evaluate``
  against the JAX ``do_evaluation`` there and against the JAX
  ``ComputationGraph.evaluate`` on a graph of one input. The JAX
  ``evaluate`` fails on several inputs (``ROADMAP.md`` C), which a test
  here names;
- a 2-layer BERT of width 64 (dropout 0, f32), weights carried across:
  the graph's ``evaluate`` against the JAX ``do_evaluation``;
- the masked-batch refusal, the facades' ``evaluate`` and
  ``evaluate_regression`` at one rank, ``merge_across_processes`` at
  world size 1 (no group, and a one-rank gloo group);
- torch tensors fed to every class give the statistics numpy arrays of
  the same values give.

Tolerances: counts, confusion matrices and every statistic computed
from the same inputs: exact (both packages run the same numpy code on
the same arrays). Float metrics derived from them: within 1e-12, the
JAX tests' own band. Where the networks' outputs enter, the two float
paths differ: probabilities within 1e-5 (``tests/test_torch_bert.py``'s
f32 band), regression sums within 1e-5 relative; confusion matrices
stay exact (no row of these inputs lies within 1e-5 of a tie).
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.data import ListDataSetIterator as JListIt
from deeplearning4j_tpu.data.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.eval_ import evaluation as J
from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.parallel import \
    ParameterAveragingTrainingMaster as JPATM
from deeplearning4j_tpu.parallel import master as jmaster
from deeplearning4j_tpu.zoo.bert import Bert as JBert
from deeplearning4j_tpu_torch.data import (DataSet, ListDataSetIterator,
                                           MultiDataSet)
from deeplearning4j_tpu_torch.eval_ import evaluation as P
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    ParameterAveragingTrainingMaster, SparkComputationGraph,
    SparkDl4jMultiLayer, initialize_distributed)
from deeplearning4j_tpu_torch.parallel import master as pmaster
from deeplearning4j_tpu_torch.zoo.bert import Bert

from test_parallel import _multi_io_data, _multi_io_graph
from torch_zero_worker import multi_io_conf

FLOAT_TOL = 1e-12      # float metrics from equal statistics
PROB_TOL = 1e-5        # network outputs, f32, another summation order
CLASSES = ("Evaluation", "EvaluationBinary", "ROC", "ROCMultiClass",
           "ROCBinary", "EvaluationCalibration", "RegressionEvaluation")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(obj):
    """An evaluation object's statistics as nested plain containers of
    numpy arrays and Python scalars (the class itself left out)."""
    if hasattr(obj, "__dict__"):
        return {k: _state(v) for k, v in sorted(vars(obj).items())}
    if isinstance(obj, dict):
        return {k: _state(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_state(v) for v in obj]
    return obj


def _assert_same_state(ours, theirs, path="eval"):
    """Equal statistics, dtype and bits included."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and ours.keys() == theirs.keys(), path
        for k in theirs:
            _assert_same_state(ours[k], theirs[k], f"{path}.{k}")
    elif isinstance(theirs, list):
        assert isinstance(ours, list) and len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _assert_same_state(a, b, f"{path}[{i}]")
    elif isinstance(theirs, np.ndarray):
        assert isinstance(ours, np.ndarray), path
        assert ours.dtype == theirs.dtype, (path, ours.dtype, theirs.dtype)
        np.testing.assert_array_equal(ours, theirs, err_msg=path)
    else:
        assert type(ours) is type(theirs) and ours == theirs, \
            (path, ours, theirs)


def _same(ours, theirs):
    _assert_same_state(_state(ours), _state(theirs))


@pytest.fixture
def cls_data(rng):
    """``tests/test_eval_merge.py``'s fixture."""
    n, c = 120, 4
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    p = rng.random((n, c)).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    return y, p


def _shards(y, p, k=3):
    idx = np.array_split(np.arange(len(y)), k)
    return [(y[i], p[i]) for i in idx]


def _full_and_merged(mod, cls, y, p):
    """``cls`` of package ``mod`` fed all of (y, p), and fed three
    shards merged into a fresh one."""
    full = getattr(mod, cls)()
    full.eval(y, p)
    merged = getattr(mod, cls)()
    for ys, ps in _shards(y, p):
        e = getattr(mod, cls)()
        e.eval(ys, ps)
        merged.merge(e)
    return full, merged


# -- tests/test_eval_merge.py -------------------------------------------------
def test_evaluation_merge_equals_full(cls_data):
    y, p = cls_data
    (jf, jm), (pf, pm) = (_full_and_merged(m, "Evaluation", y, p)
                          for m in (J, P))
    np.testing.assert_array_equal(pm.confusion, pf.confusion)
    assert pm.count == pf.count
    assert pm.accuracy() == pf.accuracy()
    assert pm.f1() == pf.f1()
    _same(pm, jm)
    _same(pf, jf)
    assert pm.stats() == jm.stats()


def test_evaluation_merge_into_empty(cls_data):
    y, p = cls_data
    out = {}
    for m in (J, P):
        e = m.Evaluation()
        e.eval(y, p)
        empty = m.Evaluation()
        empty.merge(e)
        e2 = m.Evaluation()
        e2.eval(y, p)
        e2.merge(m.Evaluation())
        out[m] = (e, empty, e2)
    e, empty, e2 = out[P]
    assert empty.accuracy() == e.accuracy()
    assert e2.count == e.count
    for ours, theirs in zip(out[P], out[J]):
        _same(ours, theirs)


def test_evaluation_merge_class_mismatch_raises(cls_data):
    y, p = cls_data
    msgs = []
    for m in (J, P):
        a = m.Evaluation()
        a.eval(y, p)
        b = m.Evaluation()
        b.eval(np.eye(3, dtype=np.float32)[[0, 1, 2]],
               np.eye(3, dtype=np.float32)[[0, 2, 1]])
        with pytest.raises(ValueError) as err:
            a.merge(b)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_evaluation_merge_pinned_classes_empty_shard_raises(cls_data):
    """The pinned-``n_classes`` rules hold in either direction, and an
    empty accumulator adopts a pin, on both packages alike."""
    y, p = cls_data
    states = {}
    for m in (J, P):
        other = m.Evaluation()
        other.eval(y, p)
        pinned = m.Evaluation(n_classes=other.n_classes + 2)
        with pytest.raises(ValueError):
            pinned.merge(other)
        ok = m.Evaluation(n_classes=other.n_classes)
        ok.merge(other)
        assert ok.accuracy() == other.accuracy()
        with pytest.raises(ValueError):
            other.merge(m.Evaluation(n_classes=other.n_classes + 2))
        acc = m.Evaluation()
        acc.merge(m.Evaluation(n_classes=other.n_classes + 2))
        assert acc.n_classes == other.n_classes + 2
        with pytest.raises(ValueError):
            acc.merge(other)
        states[m] = (other, pinned, ok, acc)
    for ours, theirs in zip(states[P], states[J]):
        _same(ours, theirs)


def test_evaluation_binary_merge(rng):
    y = (rng.random((80, 3)) > 0.5).astype(np.float32)
    p = rng.random((80, 3)).astype(np.float32)
    (jf, jm), (pf, pm) = (_full_and_merged(m, "EvaluationBinary", y, p)
                          for m in (J, P))
    for i in range(3):
        assert pm.f1(i) == pf.f1(i)
        assert pm.accuracy(i) == pf.accuracy(i)
        for metric in ("f1", "accuracy", "precision", "recall"):
            assert getattr(pm, metric)(i) == pytest.approx(
                getattr(jm, metric)(i), abs=FLOAT_TOL)
    _same(pm, jm)


def test_roc_merge(rng):
    y = (rng.random(200) > 0.5).astype(np.float32)
    p = rng.random(200).astype(np.float32)
    (jf, jm), (pf, pm) = (_full_and_merged(m, "ROC", y, p)
                          for m in (J, P))
    assert pm.calculate_auc() == pytest.approx(pf.calculate_auc(),
                                               abs=FLOAT_TOL)
    assert pm.calculate_auprc() == pytest.approx(pf.calculate_auprc(),
                                                 abs=FLOAT_TOL)
    assert pm.calculate_auc() == pytest.approx(jm.calculate_auc(),
                                               abs=FLOAT_TOL)
    assert pm.calculate_auprc() == pytest.approx(jm.calculate_auprc(),
                                                 abs=FLOAT_TOL)
    _same(pm, jm)


def test_roc_multiclass_and_binary_merge(cls_data):
    y, p = cls_data
    for cls in ("ROCMultiClass", "ROCBinary"):
        (jf, jm), (pf, pm) = (_full_and_merged(m, cls, y, p)
                              for m in (J, P))
        assert pm.average_auc() == pytest.approx(pf.average_auc(),
                                                 abs=FLOAT_TOL)
        assert pm.average_auc() == pytest.approx(jm.average_auc(),
                                                 abs=FLOAT_TOL)
        _same(pm, jm)


def test_calibration_merge(cls_data):
    y, p = cls_data
    (jf, jm), (pf, pm) = (_full_and_merged(m, "EvaluationCalibration", y,
                                           p) for m in (J, P))
    assert pm.expected_calibration_error() == pytest.approx(
        pf.expected_calibration_error(), abs=FLOAT_TOL)
    assert pm.expected_calibration_error() == pytest.approx(
        jm.expected_calibration_error(), abs=FLOAT_TOL)
    _same(pm, jm)


def test_regression_merge(rng):
    y = rng.standard_normal((90, 2))
    p = y + 0.1 * rng.standard_normal((90, 2))
    (jf, jm), (pf, pm) = (_full_and_merged(m, "RegressionEvaluation", y,
                                           p) for m in (J, P))
    for col in range(2):
        for metric in ("mean_squared_error", "r_squared",
                       "pearson_correlation", "mean_absolute_error",
                       "root_mean_squared_error"):
            ours = getattr(pm, metric)(col)
            assert ours == pytest.approx(getattr(pf, metric)(col),
                                         rel=1e-12)
            assert ours == pytest.approx(getattr(jm, metric)(col),
                                         rel=1e-12)
    _same(pm, jm)


@pytest.fixture
def one_rank_group():
    """A one-process gloo group in this process (``initialize_distributed``
    with no address), destroyed after the test: the facades build their
    mesh over the group."""
    assert not dist.is_initialized()
    initialize_distributed()
    yield
    dist.destroy_process_group()


def test_merge_across_processes_single_process(cls_data):
    """World size 1 — without a process group, and in a one-rank gloo
    group — gives the input back, as the JAX package's single process
    does."""
    y, p = cls_data
    je = J.Evaluation()
    je.eval(y, p)
    assert jmaster.merge_across_processes(je) is je
    e = P.Evaluation()
    e.eval(y, p)
    assert not dist.is_initialized()
    assert pmaster.merge_across_processes(e) is e
    assert pmaster.merge_across_processes([e, e]) == [e, e]
    initialize_distributed()
    try:
        assert pmaster.merge_across_processes(e) is e
        assert pmaster.merge_across_processes([e, e]) == [e, e]
    finally:
        dist.destroy_process_group()


# -- tests/test_vertices_preprocessors.py TestROCBinary -----------------------
class TestROCBinary:
    def _both(self, feed):
        out = []
        for m in (J, P):
            roc = m.ROCBinary()
            feed(roc)
            out.append(roc)
        _same(out[1], out[0])
        assert out[1].stats() == out[0].stats()
        return out[1]

    def test_perfect_and_random(self):
        labels = np.asarray([[1, 0], [1, 1], [0, 0], [0, 1]], np.float32)
        preds = np.asarray([[0.9, 0.9], [0.8, 0.1], [0.1, 0.8],
                            [0.2, 0.2]], np.float32)
        roc = self._both(lambda r: r.eval(labels, preds))
        assert roc.num_labels() == 2
        assert roc.calculate_auc(0) == 1.0
        assert roc.calculate_auc(1) == 0.0
        assert np.isclose(roc.average_auc(), 0.5)
        assert "out 0" in roc.stats()

    def test_masked_columns(self):
        labels = np.asarray([[1], [0], [1], [0]], np.float32)
        preds = np.asarray([[0.9], [0.8], [0.2], [0.1]], np.float32)
        mask = np.asarray([[1], [0], [0], [1]], np.float32)
        roc = self._both(lambda r: r.eval(labels, preds, mask=mask))
        assert roc.calculate_auc(0) == 1.0

    def test_accumulates_batches(self):
        def feed(roc):
            rng = np.random.RandomState(0)
            for _ in range(3):
                labels = (rng.rand(16, 3) > 0.5).astype(np.float32)
                roc.eval(labels, labels * 0.8 + 0.1)
        roc = self._both(feed)
        assert roc.num_labels() == 3
        assert roc.average_auc() == 1.0


# -- torch inputs -------------------------------------------------------------
@pytest.mark.parametrize("cls", CLASSES)
def test_tensor_inputs_give_the_numpy_statistics(cls, cls_data):
    """Each class fed torch tensors (f32, bf16, and one that requires
    grad) keeps the statistics it keeps when fed numpy arrays of the
    same values (the tensors' f32 values)."""
    y, p = cls_data
    if cls == "ROC":
        y, p = y[:, 1], p[:, 1]
    tensors = [(torch.tensor(y), torch.tensor(p)),
               (torch.tensor(y).bfloat16(), torch.tensor(p).bfloat16()),
               (torch.tensor(y), torch.tensor(p).requires_grad_(True))]
    fed_t, fed_np = getattr(P, cls)(), getattr(P, cls)()
    for ty, tp in tensors:
        fed_t.eval(ty, tp)
        fed_np.eval(ty.detach().float().numpy(), tp.detach().float().numpy())
    _same(fed_t, fed_np)
    assert isinstance(P.to_host(tensors[1][1]), np.ndarray)
    assert P.to_host(tensors[1][1]).dtype == np.float32


# -- tests/test_multilayer.py:86: the XOR net ---------------------------------
XOR_X = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32)
XOR_Y = np.array([[1, 0], [0, 1], [0, 1], [1, 0]], np.float32)


def _jax_xor_net():
    return JNet(JConf.builder().seed(42)
                .updater(jupd.Adam(learning_rate=0.05))
                .weight_init_fn("xavier").list()
                .layer(JDense(n_out=8, activation="tanh"))
                .layer(JOutput(n_out=2, activation="softmax",
                               loss="mcxent"))
                .set_input_type(JInputType.feed_forward(2))
                .build()).init()


def _xor_net():
    return MultiLayerNetwork(
        NeuralNetConfiguration.builder().seed(42)
        .updater(pupd.Adam(learning_rate=0.05))
        .weight_init_fn("xavier").list()
        .layer(DenseLayer(n_out=8, activation="tanh"))
        .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.feed_forward(2))
        .build()).init(device="cpu")


@pytest.fixture(scope="module")
def xor():
    """The JAX XOR net trained as ``tests/test_multilayer.py:86`` trains
    it, the port's net with its weights, and each package's shuffled
    iterator over the same data."""
    jds = JDataSet(XOR_X.repeat(8, 0), XOR_Y.repeat(8, 0))
    jit = JListIt(jds, batch_size=8, shuffle=True)
    jnet = _jax_xor_net()
    jnet.fit(jit, epochs=60)
    pnet = _xor_net().params_from_jax(jax.tree.map(np.asarray,
                                                   jnet.params))
    pit = ListDataSetIterator(DataSet(XOR_X.repeat(8, 0),
                                      XOR_Y.repeat(8, 0)),
                              batch_size=8, shuffle=True)
    pit._epoch = jit._epoch            # the JAX iterator ran 60 passes
    return jnet, jit, pnet, pit


def test_list_iterator_yields_the_jax_batches():
    """Shuffled by ``seed + epoch`` each pass, cut into ``batch_size``
    rows, ``len`` the batch count: the same batches, pass for pass; a
    list of batches goes through as it is."""
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    y = np.eye(2, dtype=np.float32)[np.arange(20) % 2]
    for shuffle in (False, True):
        jit = JListIt(JDataSet(x, y), batch_size=6, shuffle=shuffle,
                      seed=3)
        pit = ListDataSetIterator(DataSet(x, y), batch_size=6,
                                  shuffle=shuffle, seed=3)
        assert len(pit) == len(jit) == 4
        for _ in range(2):
            jb, pb = list(jit), list(pit)
            assert len(pb) == len(jb)
            for a, b in zip(pb, jb):
                np.testing.assert_array_equal(a.features, b.features)
                np.testing.assert_array_equal(a.labels, b.labels)
    batches = [DataSet(x[:4], y[:4]), DataSet(x[4:], y[4:])]
    pit = ListDataSetIterator(batches)
    assert len(pit) == 2 and list(pit) == batches


def test_fit_iterator_and_evaluate(xor):
    jnet, jit, pnet, pit = xor
    je, pe = jnet.evaluate(jit), pnet.evaluate(pit)
    assert pe.accuracy() == 1.0
    assert "Accuracy" in pe.stats()
    _same(pe, je)
    assert pe.stats() == je.stats()
    # (x, y) pairs are batches too
    pairs = pnet.evaluate([(XOR_X, XOR_Y), (XOR_X[:2], XOR_Y[:2])])
    assert pairs.count == 6 and pairs.accuracy() == 1.0


def test_evaluate_regression_matches_jax(xor):
    jnet, jit, pnet, pit = xor
    jr, pr = jnet.evaluate_regression(jit), pnet.evaluate_regression(pit)
    assert pr.n == jr.n == 32
    for k, v in jr._sums.items():
        np.testing.assert_allclose(pr._sums[k], v, rtol=PROB_TOL,
                                   atol=PROB_TOL, err_msg=k)
    for col in range(2):
        assert pr.mean_squared_error(col) == pytest.approx(
            jr.mean_squared_error(col), rel=PROB_TOL, abs=PROB_TOL)


def test_facade_evaluate_at_one_rank(xor, one_rank_group):
    """``SparkDl4jMultiLayer.evaluate`` (with and without a pinned class
    count), ``evaluate_regression`` and ``do_evaluation`` at one rank
    equal the network's own evaluation."""
    _, _, pnet, pit = xor
    spark = SparkDl4jMultiLayer(
        pnet, ParameterAveragingTrainingMaster.Builder(8).build())
    local = pnet.evaluate(pit)
    for ev in (spark.evaluate(pit), spark.evaluate(pit, num_classes=2)):
        _same(ev, local)
    _same(spark.evaluate_regression(pit), pnet.evaluate_regression(pit))
    ev, roc = spark.do_evaluation(pit, P.Evaluation(), P.ROC())
    _same(ev, local)
    assert roc.calculate_auc() == 1.0


# -- the graph: tests/test_parallel.py:360 ------------------------------------
def _port_multi_io(jnet):
    net = ComputationGraph(multi_io_conf()).init(device="cpu")
    return net.params_from_jax(jax.tree.map(np.asarray, jnet.params))


def _port_mds(jdata):
    return [MultiDataSet(m.features, m.labels) for m in jdata]


@pytest.mark.usefixtures("one_rank_group")
def test_do_evaluation_multi_io_graph():
    """doEvaluation over a 2-input/2-output graph: list features feed
    output(*x), evaluation runs on the first output/label pair — on both
    packages, to the same confusion matrix; the port graph's ``evaluate``
    follows the same rule."""
    jnet = _multi_io_graph()
    jdata = _multi_io_data(n=64, batch=32)
    jev, = jmaster.SparkComputationGraph(
        jnet, JPATM.Builder(32).build()).do_evaluation(jdata, J.Evaluation())
    pnet, pdata = _port_multi_io(jnet), _port_mds(jdata)
    ev, = SparkComputationGraph(
        pnet, ParameterAveragingTrainingMaster.Builder(32).build()
    ).do_evaluation(pdata, P.Evaluation())
    assert ev.count == 64
    assert 0.0 <= ev.accuracy() <= 1.0
    _same(ev, jev)
    _same(pnet.evaluate(pdata), jev)
    # (xs, ys) pairs are batches too
    _same(pnet.evaluate([(m.features, m.labels) for m in pdata]), jev)


def test_jax_graph_evaluate_fails_on_several_inputs():
    """The reference fault (``ROADMAP.md`` C): the JAX
    ``ComputationGraph.evaluate`` calls ``output(x)`` with the list of
    features as one argument, so the first input gets the stacked list
    and the second none, and the product fails; the port's ``evaluate``
    feeds ``output(*x)``."""
    jnet = _multi_io_graph()
    jdata = _multi_io_data(n=64, batch=32)
    with pytest.raises(TypeError, match="contracting dimensions"):
        jnet.evaluate(jdata)
    assert _port_multi_io(jnet).evaluate(_port_mds(jdata)).count == 64


def _one_input_graphs():
    jconf = (JConf.builder().seed(4).updater(jupd.Adam(learning_rate=0.05))
             .graph_builder().add_inputs("x")
             .add_layer("h", JDense(n_out=8, activation="tanh"), "x")
             .add_layer("out", JOutput(n_out=3, activation="softmax",
                                       loss="mcxent"), "h")
             .set_outputs("out")
             .set_input_types(x=JInputType.feed_forward(5)).build())
    pconf = (NeuralNetConfiguration.builder().seed(4)
             .updater(pupd.Adam(learning_rate=0.05))
             .graph_builder().add_inputs("x")
             .add_layer("h", DenseLayer(n_out=8, activation="tanh"), "x")
             .add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                           loss="mcxent"), "h")
             .set_outputs("out")
             .set_input_types(x=InputType.feed_forward(5)).build())
    jnet = JGraph(jconf).init()
    pnet = ComputationGraph(pconf).init(device="cpu").params_from_jax(
        jax.tree.map(np.asarray, jnet.params))
    return jnet, pnet


def test_graph_evaluate_one_input_matches_jax_evaluate():
    """On a graph of one input fed ``DataSet``s the port's ``evaluate``
    equals the JAX ``ComputationGraph.evaluate``."""
    jnet, pnet = _one_input_graphs()
    rng = np.random.default_rng(6)
    x = rng.normal(size=(50, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 50)]
    jev = jnet.evaluate([JDataSet(x[i:i + 16], y[i:i + 16])
                         for i in range(0, 50, 16)])
    ev = pnet.evaluate(ListDataSetIterator(DataSet(x, y), batch_size=16))
    assert ev.count == 50
    _same(ev, jev)
    np.testing.assert_allclose(pnet.output(x)[0].numpy(),
                               np.asarray(jnet.output(x)[0]), atol=PROB_TOL)


@pytest.mark.usefixtures("one_rank_group")
def test_facade_evaluate_regression_on_a_graph_raises():
    _, pnet = _one_input_graphs()
    spark = SparkComputationGraph(
        pnet, ParameterAveragingTrainingMaster.Builder(8).build())
    with pytest.raises(TypeError, match="ComputationGraph has no "
                                        "evaluate_regression"):
        spark.evaluate_regression([])
    assert not hasattr(pnet, "evaluate_regression")


# -- a narrow BERT ------------------------------------------------------------
BERT_KW = dict(vocab_size=100, hidden=64, n_layers=2, n_heads=2, max_len=16,
               dropout=0.0, seed=9)


def _bert_batches(n_batches=3, b=8, t=16, seed=12):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        tok = rng.integers(0, BERT_KW["vocab_size"], (b, t)).astype(np.int32)
        split = rng.integers(1, t, b)
        seg = (np.arange(t)[None, :] >= split[:, None]).astype(np.int32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)]
        out.append(([tok, seg], [y]))
    return out


@pytest.mark.usefixtures("one_rank_group")
def test_narrow_bert_evaluate_matches_jax_do_evaluation():
    """A 2-layer BERT of width 64 in f32: the port graph's ``evaluate``
    equals the JAX ``SparkComputationGraph.do_evaluation`` (the JAX
    ``evaluate`` fails on its two inputs); probabilities within 1e-5."""
    jnet = JBert(**BERT_KW).init_classifier(2, 16)
    pnet = Bert(**BERT_KW).init_classifier(2, 16, device="cpu")
    pnet.params_from_jax(jax.tree.map(np.asarray, jnet.params))
    data = _bert_batches()
    jev, jroc = jmaster.SparkComputationGraph(
        jnet, JPATM.Builder(8).build()).do_evaluation(
            [JMDS(x, y) for x, y in data], J.Evaluation(), J.ROC())
    pdata = [MultiDataSet(x, y) for x, y in data]
    ev = pnet.evaluate(pdata)
    assert ev.count == 24
    _same(ev, jev)
    roc = P.ROC()
    SparkComputationGraph(pnet, ParameterAveragingTrainingMaster.Builder(
        8).build()).do_evaluation(pdata, roc)
    np.testing.assert_allclose(np.concatenate(roc.scores),
                               np.concatenate(jroc.scores), atol=PROB_TOL)
    assert roc.calculate_auc() == pytest.approx(jroc.calculate_auc(),
                                                abs=FLOAT_TOL)


# -- masks --------------------------------------------------------------------
@pytest.mark.usefixtures("one_rank_group")
def test_masked_batch_raises_naming_the_gap(xor):
    """Neither JAX ``evaluate`` nor ``do_evaluation`` passes masks, so a
    padded batch would be evaluated unmasked: the port refuses it, in
    both networks' ``evaluate`` and in ``do_evaluation``."""
    _, _, pnet, _ = xor
    ds = DataSet(XOR_X, XOR_Y, labels_mask=np.ones((4, 1), np.float32))
    jnet, gnet = _one_input_graphs()
    x = np.zeros((4, 5), np.float32)
    mds = MultiDataSet([x], [np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]],
                       features_masks=[np.ones((4, 5), np.float32)])
    spark = SparkComputationGraph(
        gnet, ParameterAveragingTrainingMaster.Builder(4).build())
    for call in (lambda: pnet.evaluate([ds]),
                 lambda: pnet.evaluate_regression([ds]),
                 lambda: gnet.evaluate([mds]),
                 lambda: spark.do_evaluation([mds], P.Evaluation())):
        with pytest.raises(NotImplementedError) as err:
            call()
        assert "pass no masks" in str(err.value) \
            and "ROADMAP.md C" in str(err.value), str(err.value)
    # a MultiDataSet whose masks are all None is not masked
    clear = MultiDataSet(mds.features, mds.labels, features_masks=[None])
    assert gnet.evaluate([clear]).count == 4
