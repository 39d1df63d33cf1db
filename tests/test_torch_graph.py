"""The port's ComputationGraph, vertices and data containers against the
JAX package on the CPU: the twins of ``tests/test_graph.py``'s XOR and
cycle-detection tests, a two-branch graph's forward and training steps
with the JAX weights carried across, every ported vertex against its
JAX twin, the MultiDataSet iterator path, and the options this slice
refuses.

Tolerances (float32): 1e-5 absolute for outputs and vertices — the same
math in another summation order; losses 1e-5 relative per step;
parameters after three Adam steps 1e-6 absolute (elementwise updates in
optax's order from gradients equal to ~1e-7).
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn import vertices as jv
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch import tree
from deeplearning4j_tpu_torch.data import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.nn import vertices as pv
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph, _Node,
                                               _toposort)

TOL = 1e-5
XOR_X = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32)
XOR_Y = np.array([[1, 0], [0, 1], [0, 1], [1, 0]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _two_branch_graph(conf_cls, layers, upd, input_type):
    """The two-branch graph of ``tests/test_graph.py``, built with
    either package's classes."""
    return (conf_cls.builder()
            .seed(42)
            .updater(upd.Adam(learning_rate=0.05))
            .graph_builder()
            .add_inputs("in")
            .add_layer("d1", layers.DenseLayer(n_out=8, activation="tanh"),
                       "in")
            .add_layer("d2", layers.DenseLayer(n_out=8, activation="relu"),
                       "in")
            .add_vertex("merge", (jv if layers is jl else pv).MergeVertex(),
                        "d1", "d2")
            .add_layer("out", layers.OutputLayer(n_out=2,
                                                 activation="softmax",
                                                 loss="mcxent"), "merge")
            .set_outputs("out")
            .set_input_types(**{"in": input_type.feed_forward(2)})
            .build())


def _port_graph():
    return ComputationGraph(_two_branch_graph(
        NeuralNetConfiguration, pl, pupd, InputType))


def _jax_pair():
    jnet = JGraph(_two_branch_graph(JConf, jl, jupd, JInputType)).init()
    pnet = _port_graph().init(device="cpu")
    pnet.params_from_jax(jax.tree.map(np.asarray, jnet.params))
    return jnet, pnet


def test_graph_fit_learns_xor():
    g = _port_graph().init(device="cpu")
    for _ in range(300):
        g.fit(XOR_X, XOR_Y)
    preds = g.output(XOR_X)[0].numpy()
    assert (preds.argmax(1) == XOR_Y.argmax(1)).all()
    assert g.score() < 0.05


def test_graph_cycle_detection():
    nodes = [_Node("x", "vertex", pv.ScaleVertex(), ["y"]),
             _Node("y", "vertex", pv.ScaleVertex(), ["x"])]
    with pytest.raises(ValueError, match="cycle"):
        _toposort(nodes, ["in"])
    # a name that no node or input provides is refused the same way
    with pytest.raises(ValueError, match="nowhere"):
        _toposort([_Node("x", "vertex", pv.ScaleVertex(), ["nowhere"])],
                  ["in"])


def test_two_branch_forward_and_fit_steps_match_jax():
    jnet, pnet = _jax_pair()
    assert pnet.num_params() == jnet.num_params()
    assert [n.name for n in pnet.order] == [n.name for n in jnet.order]
    x = np.random.default_rng(0).normal(size=(6, 2)).astype(np.float32)
    np.testing.assert_allclose(pnet.output(x)[0].numpy(),
                               np.asarray(jnet.output(x)[0]), atol=TOL,
                               rtol=0)
    for _ in range(3):
        jnet.fit(XOR_X, XOR_Y)
        pnet.fit(XOR_X, XOR_Y)
        assert pnet.score() == pytest.approx(jnet.score(), rel=TOL)
    jp = jax.tree.map(np.asarray, jnet.params)
    for name in jp:
        for key in jp[name]:
            np.testing.assert_allclose(pnet.params[name][key].numpy(),
                                       jp[name][key], atol=1e-6, rtol=0,
                                       err_msg=f"{name}.{key}")
    assert pnet.iteration == 3
    assert "merge" in pnet.summary() and "Total params" in pnet.summary()


def _vertex_cases():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(4, 5, 6)).astype(np.float32)
    b = rng.normal(size=(4, 5, 6)).astype(np.float32)
    v = rng.normal(size=(4, 6)).astype(np.float32)
    img = rng.normal(size=(2, 5, 5, 3)).astype(np.float32)
    mask = np.ones((4, 5), np.float32)
    mask[1, 3:] = 0
    mask[2, 1:] = 0
    cases = [("merge", {}, [a, b], None),
             ("merge_axis1", {"axis": 1}, [a, b], None),
             ("subset", {"from_": 1, "to": 3}, [a], None),
             ("stack", {}, [a, b], None),
             ("unstack", {"index": 1, "num": 2}, [a], None),
             ("scale", {"scale": 2.5}, [a], None),
             ("shift", {"shift": -0.5}, [a], None),
             ("l2normalize", {}, [a], None),
             ("l2", {}, [a, b], None),
             ("reshape", {"shape": (30,)}, [a], None),
             ("flatten", {}, [a], None),
             ("poolhelper", {}, [img], None),
             ("lasttimestep", {}, [a], mask),
             ("lasttimestep_nomask", {}, [a], None),
             ("duplicatetotimeseries", {}, [v, a], None),
             ("reversetimeseries", {}, [a], mask)]
    for op in ("add", "sub", "mul", "avg", "max"):
        cases.append((f"elementwise_{op}", {"op": op}, [a, b, a * b], None))
    return cases


_VERTEX_CLASS = {
    "merge": "MergeVertex", "subset": "SubsetVertex",
    "stack": "StackVertex", "unstack": "UnstackVertex",
    "scale": "ScaleVertex", "shift": "ShiftVertex",
    "l2normalize": "L2NormalizeVertex", "l2": "L2Vertex",
    "reshape": "ReshapeVertex", "flatten": "FlattenVertex",
    "poolhelper": "PoolHelperVertex", "lasttimestep": "LastTimeStepVertex",
    "duplicatetotimeseries": "DuplicateToTimeSeriesVertex",
    "reversetimeseries": "ReverseTimeSeriesVertex",
    "elementwise": "ElementWiseVertex"}


@pytest.mark.parametrize("case", _vertex_cases(), ids=lambda c: c[0])
def test_vertex_matches_jax(case):
    name, kw, xs, mask = case
    cls = _VERTEX_CLASS[name.split("_")[0]]
    jvert, pvert = getattr(jv, cls)(**kw), getattr(pv, cls)(**kw)
    assert pvert.needs_mask == jvert.needs_mask
    jxs, pxs = [jnp.asarray(x) for x in xs], [torch.tensor(x) for x in xs]
    if jvert.needs_mask:
        jm = None if mask is None else jnp.asarray(mask)
        pm = None if mask is None else torch.tensor(mask)
        theirs, ours = jvert.apply(jxs, mask=jm), pvert.apply(pxs, mask=pm)
    else:
        theirs, ours = jvert.apply(jxs), pvert.apply(pxs)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=TOL,
                               rtol=0)
    shapes = [x.shape[1:] for x in xs]
    assert tuple(pvert.output_shape(shapes)) == tuple(
        jvert.output_shape(shapes))
    m = torch.ones(4, 5)
    assert (pvert.propagate_mask(m) is None) == (
        jvert.propagate_mask(jnp.ones((4, 5))) is None)


def test_merge_vertex_refuses_the_batch_axis():
    with pytest.raises(ValueError, match="batch"):
        pv.MergeVertex(axis=0).output_shape([(3,), (3,)])


def test_multidataset_iterator_fit_equals_single_fits():
    rng = np.random.default_rng(5)
    batches = [MultiDataSet([rng.normal(size=(4, 2)).astype(np.float32)],
                            [XOR_Y[rng.permutation(4)]])
               for _ in range(3)]
    a = _port_graph().init(device="cpu")
    b = _port_graph().init(device="cpu")
    for mds in batches:
        a.fit(mds.features, mds.labels)
    b.fit(iter(batches), epochs=1)
    assert b.iteration == 3 and b.epoch == 1
    for p, q in zip(tree.leaves(a.params), tree.leaves(b.params)):
        assert torch.equal(p, q)
    # (xs, ys) pairs take the same path
    c = _port_graph().init(device="cpu")
    c.fit([(m.features, m.labels) for m in batches])
    for p, q in zip(tree.leaves(a.params), tree.leaves(c.params)):
        assert torch.equal(p, q)


def test_datasets_match_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(10, 3)).astype(np.float32)
    y = rng.normal(size=(10, 2)).astype(np.float32)
    fm = (rng.random((10, 3)) > 0.5).astype(np.float32)
    ours, theirs = DataSet(x, y, fm), JDataSet(x, y, fm)
    for o, t in ((ours.shuffle(1), theirs.shuffle(1)),
                 (ours.sample(4, 2), theirs.sample(4, 2)),
                 (ours.split_test_and_train(7)[1],
                  theirs.split_test_and_train(7)[1]),
                 (DataSet.merge(ours.batch_by(3)),
                  JDataSet.merge(theirs.batch_by(3)))):
        np.testing.assert_array_equal(o.features, t.features)
        np.testing.assert_array_equal(o.labels, t.labels)
        np.testing.assert_array_equal(o.features_mask, t.features_mask)
        assert o.num_examples() == t.num_examples()
    assert repr(ours) == repr(theirs)
    mo, mt = MultiDataSet([x, x], [y]), JMultiDataSet([x, x], [y])
    assert mo.num_examples() == mt.num_examples() == 10


def _graph_with(out_layer=None, **layer_kw):
    out_layer = out_layer or pl.OutputLayer(n_out=2, activation="softmax",
                                            loss="mcxent")
    return ComputationGraph(
        NeuralNetConfiguration.builder().graph_builder()
        .add_inputs("in")
        .add_layer("d", pl.DenseLayer(n_out=3, **layer_kw), "in")
        .add_layer("out", out_layer, "d")
        .set_outputs("out")
        .set_input_types(**{"in": InputType.feed_forward(2)})
        .build())


def test_unported_options_raise_naming_the_slice():
    # l1, l2 and learning_rate on a node: the JAX graph ignores them,
    # the port refuses them (ROADMAP.md C); the other per-node options
    # are ported (tests/test_torch_layer_options.py)
    for kw in ({"l1": 1e-4}, {"l2": 1e-4}, {"learning_rate": 0.1}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md C"):
            _graph_with(**kw).init(device="cpu")
    for kw in ({"weight_decay": 0.1}, {"trainable": False},
               {"updater": pupd.Sgd()}):
        _graph_with(**kw).init(device="cpu")
    # an RnnOutputLayer output is ported (the JAX graph's fused head
    # flattens its input, graph.py:290-298; the port applies it per
    # time step): on [B, F] rows it is the OutputLayer head
    rnn_out = _graph_with(pl.RnnOutputLayer(
        n_out=2, activation="softmax", loss="mcxent")).init(device="cpu")
    dense_out = _graph_with().init(device="cpu")
    dense_out.params_from_jax(tree.map_(lambda t: t.numpy(),
                                        rnn_out.params))
    xy = (np.array([[0.5, -1.0], [2.0, 0.1], [0.0, 0.3]], np.float32),
          np.eye(2, dtype=np.float32)[[0, 1, 1]])
    for g in (rnn_out, dense_out):
        g.fit(*xy)
    assert np.isfinite(rnn_out.score()) and rnn_out.score_ == \
        dense_out.score_
    g = _graph_with().init(device="cpu")
    # steps_per_loop is ported; below 1 it is refused
    g.fit(iter([]), steps_per_loop=2)
    with pytest.raises(ValueError, match="steps_per_loop"):
        g.fit(iter([]), steps_per_loop=0)
    # listeners are ported: they now see the graph's steps
    seen = []

    class Listener:
        def iteration_done(self, net, iteration, epoch):
            seen.append(iteration)

    g.set_listeners(Listener())
    g.fit(np.zeros((3, 2), np.float32),
          np.eye(2, dtype=np.float32)[[0, 1, 0]])
    assert seen == [1]
    with pytest.raises(RuntimeError, match="init"):
        _graph_with().params_from_jax({})
    with pytest.raises(ValueError, match="no input shape"):
        ComputationGraph(
            NeuralNetConfiguration.builder().graph_builder()
            .add_inputs("in")
            .add_layer("out", pl.OutputLayer(n_out=2), "in")
            .set_outputs("out").build()).init(device="cpu")


def test_graph_entry_points_default_to_the_card():
    from deeplearning4j_tpu_torch.zoo.bert import Bert
    for fn in (ComputationGraph.init, Bert.init_classifier):
        assert inspect.signature(fn).parameters["device"].default == \
            "cuda"
