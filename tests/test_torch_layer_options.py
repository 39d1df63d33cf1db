"""Per-layer training options on the CPU, the port against the JAX
package from the same carried-across weights and numpy batches: frozen
layers (``FrozenLayer``, ``trainable=False``), a per-layer updater, a
per-layer learning rate under a global schedule (the copy drops the
schedule), l1/l2 in the score, ``weight_decay``'s place in the chain
(before the updater: Adam normalises the decayed gradient), each for
``MultiLayerNetwork`` and, where the JAX graph honours the option,
``ComputationGraph``; the graph's refusals of ``l1``, ``l2`` and
``learning_rate`` (which the JAX graph silently ignores, ROADMAP.md C);
``opt_state_from_jax`` over per-group updater types and empty frozen
states; and C7, pinned both ways: under
``FineTuneConfiguration(weight_decay=…, l2=…)`` the JAX package moves a
``FrozenLayerWithBackprop``'s weights, the port does not.

Twins of ``tests/test_multilayer.py:141`` (per-layer updater and frozen)
and ``:163`` (l2 changes the score).

Tolerances (float32): losses 1e-5 relative a step; parameters after a
few steps within 1e-5 absolute (the same f32 math in another order, on
small nets with Adam or Sgd: measured ≤ 3e-7); frozen parameters equal
to the bit to their values before ``fit``.
"""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import FineTuneConfiguration as JFTC
from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import TransferLearning as JTL
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.layers.extra import \
    FrozenLayerWithBackprop as JFLWB
from deeplearning4j_tpu.nn.layers.special import FrozenLayer as JFrozen
from deeplearning4j_tpu_torch import tree
from deeplearning4j_tpu_torch.nn import (FineTuneConfiguration,
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration,
                                         TransferLearning)
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.nn.config import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (DenseLayer, FrozenLayer,
                                                FrozenLayerWithBackprop,
                                                OutputLayer)

TOL = 1e-5
XOR_X = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32)
XOR_Y = np.array([[1, 0], [0, 1], [0, 1], [1, 0]], np.float32)

JAX = dict(conf=JConf, inputs=JInputType, dense=JDense, out=JOut,
           upd=jupd, frozen=JFrozen, flwb=JFLWB)
PORT = dict(conf=NeuralNetConfiguration, inputs=InputType,
            dense=DenseLayer, out=OutputLayer, upd=pupd,
            frozen=FrozenLayer, flwb=FrozenLayerWithBackprop)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(params):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _assert_params_close(jnet, pnet, tol=TOL):
    jp = _host(jnet.params)
    tree.map_with_path(
        lambda path, t, a: np.testing.assert_allclose(
            t.detach().numpy(), a, atol=tol, rtol=0, err_msg=str(path)),
        pnet.params, jp)


def _assert_unmoved(pnet, before, name):
    for a, b in zip(tree.leaves(pnet.params[name]),
                    tree.leaves(before[name])):
        assert torch.equal(a, b), name


# -- MultiLayerNetwork -------------------------------------------------------
def _mln(pkg, layer0=None, layer1_kw=None, updater=None, seed=42,
         global_kw=None):
    """[2] → 8 tanh → 2 softmax, with ``layer0(pkg)`` in place of the
    hidden layer when given."""
    b = pkg["conf"].builder().seed(seed).updater(
        updater(pkg["upd"]) if updater else pkg["upd"].Adam(
            learning_rate=0.05))
    for k, v in (global_kw or {}).items():
        getattr(b, k)(v)
    hidden = (layer0(pkg) if layer0
              else pkg["dense"](n_out=8, activation="tanh"))
    return (b.list().layer(hidden)
            .layer(pkg["out"](n_out=2, activation="softmax", loss="mcxent",
                              **(layer1_kw or {})))
            .set_input_type(pkg["inputs"].feed_forward(2)).build())


def _twins(**kw):
    jnet = JNet(_mln(JAX, **kw)).init()
    pnet = MultiLayerNetwork(_mln(PORT, **kw)).init(device="cpu")
    pnet.params_from_jax(_host(jnet.params))
    return jnet, pnet


def _fit_both(jnet, pnet, steps=5, x=XOR_X, y=XOR_Y):
    for _ in range(steps):
        jnet.fit(x, y)
        pnet.fit(x, y)
        assert pnet.score() == pytest.approx(jnet.score(), rel=TOL)


CASES = {
    "frozen_layer": dict(layer0=lambda p: p["frozen"](
        underlying=p["dense"](n_out=8, activation="tanh"))),
    "trainable_false": dict(layer0=lambda p: p["dense"](
        n_out=8, activation="tanh", trainable=False)),
    "per_layer_updater": dict(layer1_kw_fn=lambda p: {
        "updater": p["upd"].Sgd(learning_rate=0.5)}),
    "per_layer_lr": dict(layer1_kw_fn=lambda p: {"learning_rate": 0.2}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_per_layer_updater_and_frozen(case):
    spec = dict(CASES[case])
    fn = spec.pop("layer1_kw_fn", None)
    jnet = JNet(_mln(JAX, layer1_kw=fn(JAX) if fn else None,
                     **spec)).init()
    pnet = MultiLayerNetwork(_mln(PORT, layer1_kw=fn(PORT) if fn else None,
                                  **spec)).init(device="cpu")
    pnet.params_from_jax(_host(jnet.params))
    before = tree.map_(torch.clone, pnet.params)
    _fit_both(jnet, pnet)
    _assert_params_close(jnet, pnet)
    if case in ("frozen_layer", "trainable_false"):
        _assert_unmoved(pnet, before, "layer_0")
        assert pnet.opt_state["layer_0"] == {}
        assert not torch.allclose(pnet.params["layer_1"]["W"],
                                  torch.zeros(()))
    else:
        u = pnet._chains["layer_1"].updater
        assert u.learning_rate == (0.5 if case == "per_layer_updater"
                                   else 0.2)
        assert pnet._chains["layer_0"].updater is pnet.conf.updater


def test_per_layer_learning_rate_drops_the_global_schedule():
    def sched(upd):
        return upd.Adam(learning_rate=0.05, schedule=upd.ExponentialSchedule(
            initial=0.05, gamma=0.5))

    jnet, pnet = _twins(updater=sched,
                        layer1_kw={"learning_rate": 0.01})
    _fit_both(jnet, pnet, steps=4)
    _assert_params_close(jnet, pnet)
    # the schedule's counter lives only in the groups that keep it
    assert "schedule_count" in pnet.opt_state["layer_0"]
    assert "schedule_count" not in pnet.opt_state["layer_1"]
    assert pnet._chains["layer_1"].updater.schedule is None
    assert pnet.conf.updater.schedule is not None
    # the JAX state of both groups reads into the port's
    back = MultiLayerNetwork(_mln(PORT, updater=sched, layer1_kw={
        "learning_rate": 0.01})).init(device="cpu")
    back.opt_state_from_jax(jax.tree.map(np.asarray, jnet.opt_state))
    tree.map_(lambda a, b: torch.testing.assert_close(a, b, atol=1e-6,
                                                      rtol=0),
              back.opt_state, pnet.opt_state)


@pytest.mark.parametrize("reg", ["l1", "l2"])
def test_l2_regularization_affects_score(reg):
    plain = _twins()
    regd = _twins(global_kw={f"{reg}_": 0.1})
    for jnet, pnet in (plain, regd):
        _fit_both(jnet, pnet, steps=1)
    assert regd[1].score() > plain[1].score()        # includes the penalty
    _fit_both(*regd, steps=3)
    _assert_params_close(*regd)


def test_weight_decay_sits_before_the_updater():
    """``add_decayed_weights`` between the gradient normalisation and
    Adam: the decayed gradient is normalised, so the trajectory is the
    JAX one (and not AdamW's decoupled ``lr · wd · p``)."""
    jnet, pnet = _twins(layer1_kw={"weight_decay": 0.5})
    _fit_both(jnet, pnet, steps=4)
    _assert_params_close(jnet, pnet)
    from deeplearning4j_tpu_torch.nn.multilayer import group_chain
    assert group_chain(pnet.layers[1]) == (
        "gradient_normalization", "add_decayed_weights", "updater")
    assert group_chain(pnet.layers[0]) == ("gradient_normalization",
                                           "updater")


def test_opt_state_from_jax_with_a_frozen_group_and_a_layer_updater():
    kw = dict(layer0=CASES["frozen_layer"]["layer0"])
    jnet = JNet(_mln(JAX, layer1_kw={"updater": jupd.RmsProp(
        learning_rate=0.01)}, **kw)).init()
    pnet = MultiLayerNetwork(_mln(PORT, layer1_kw={
        "updater": pupd.RmsProp(learning_rate=0.01)}, **kw)).init(
        device="cpu")
    pnet.params_from_jax(_host(jnet.params))
    _fit_both(jnet, pnet, steps=2)
    fresh = MultiLayerNetwork(pnet.conf).init(device="cpu")
    fresh.opt_state_from_jax(jax.tree.map(np.asarray, jnet.opt_state))
    assert fresh.opt_state["layer_0"] == {}
    np.testing.assert_allclose(
        fresh.opt_state["layer_1"]["nu"]["W"].numpy(),
        pnet.opt_state["layer_1"]["nu"]["W"].numpy(), atol=1e-7)


def test_trainable_false_trains_in_training_mode_frozen_layer_does_not():
    """A ``trainable=False`` layer still runs its training forward
    (dropout on), and its l2 counts in the score though it never moves;
    a ``FrozenLayer`` runs its layer with ``train=False``."""
    def net(layer0):
        return MultiLayerNetwork(_mln(PORT, layer0=layer0)).init(
            device="cpu")

    x, y = torch.tensor(XOR_X), torch.tensor(XOR_Y)
    flagged = net(lambda p: p["dense"](n_out=8, activation="tanh",
                                       dropout=0.5, trainable=False))
    wrapped = net(lambda p: p["frozen"](underlying=p["dense"](
        n_out=8, activation="tanh", dropout=0.5)))
    wrapped.params_from_jax(tree.map_(lambda t: t.numpy(), flagged.params))

    def losses(n):
        return {float(n._loss_and_grads(x, y, rng=s)[0]) for s in (1, 2, 3)}

    assert len(losses(flagged)) > 1          # dropout draws per seed
    assert len(losses(wrapped)) == 1         # inference mode
    jnet, pnet = _twins(layer0=lambda p: p["dense"](
        n_out=8, activation="tanh", trainable=False, l2=0.5))
    before = tree.map_(torch.clone, pnet.params)
    plain = _twins(layer0=lambda p: p["dense"](
        n_out=8, activation="tanh", trainable=False))[1]
    plain.fit(XOR_X, XOR_Y)                  # the same first step
    _fit_both(jnet, pnet, steps=1)
    reg = 0.25 * sum(float((t ** 2).sum())
                     for t in tree.leaves(before["layer_0"]))
    assert pnet.score() == pytest.approx(plain.score() + reg, rel=1e-5)
    _fit_both(jnet, pnet, steps=2)
    _assert_unmoved(pnet, before, "layer_0")


def test_c7_frozen_layer_with_backprop_under_fine_tune_pinned_both_ways():
    """C7 (ROADMAP.md): the JAX package writes the fine-tune's
    ``weight_decay`` and ``l2`` onto a ``FrozenLayerWithBackprop`` and
    then moves its weights; the port skips the wrapper, never updates
    it, and refuses those options on it outright."""
    def conf(pkg):
        return (pkg["conf"].builder().seed(3)
                .updater(pkg["upd"].Sgd(learning_rate=0.1)).list()
                .layer(pkg["dense"](n_out=6, activation="tanh"))
                .layer(pkg["flwb"](underlying=pkg["dense"](
                    n_out=6, activation="tanh")))
                .layer(pkg["out"](n_out=2, activation="softmax",
                                  loss="mcxent"))
                .set_input_type(pkg["inputs"].feed_forward(2)).build())

    jnet = JNet(conf(JAX)).init()
    pnet = MultiLayerNetwork(conf(PORT)).init(device="cpu")
    pnet.params_from_jax(_host(jnet.params))
    w1 = pnet.params["layer_1"]["W"].clone()
    _fit_both(jnet, pnet, steps=2)
    # plain fits: the wrapper's W stays on both sides, the input
    # gradient still trains layer_0 through it
    np.testing.assert_array_equal(np.asarray(jnet.params["layer_1"]["W"]),
                                  w1.numpy())
    assert torch.equal(pnet.params["layer_1"]["W"], w1)
    _assert_params_close(jnet, pnet)
    jtl = (JTL.builder(jnet).fine_tune_configuration(
        JFTC(weight_decay=0.1, l2=0.1)).build())
    ptl = (TransferLearning.builder(pnet).fine_tune_configuration(
        FineTuneConfiguration(weight_decay=0.1, l2=0.1)).build())
    assert jtl.layers[1].weight_decay == 0.1          # written onto it
    assert ptl.layers[1].weight_decay is None         # skipped
    assert ptl.opt_state["layer_1"] == {}
    jtl.fit(XOR_X, XOR_Y)
    ptl.fit(XOR_X, XOR_Y)
    moved = np.abs(np.asarray(jtl.params["layer_1"]["W"])
                   - w1.numpy()).max()
    assert moved > 1e-4, moved                         # the JAX fault
    assert torch.equal(ptl.params["layer_1"]["W"], w1)  # the port's rule
    bad = conf(PORT)
    bad.layers[1].l2 = 0.1
    with pytest.raises(NotImplementedError, match="C7"):
        MultiLayerNetwork(bad).init(device="cpu")


# -- ComputationGraph --------------------------------------------------------
def _graph(pkg, graph_cls, **dense_kw):
    conf = (pkg["conf"].builder().seed(11)
            .updater(pkg["upd"].Adam(learning_rate=0.05)).graph_builder()
            .add_inputs("in")
            .add_layer("d", pkg["dense"](n_out=8, activation="tanh",
                                         **dense_kw), "in")
            .add_layer("out", pkg["out"](n_out=2, activation="softmax",
                                         loss="mcxent"), "d")
            .set_outputs("out")
            .set_input_types(**{"in": pkg["inputs"].feed_forward(2)})
            .build())
    return graph_cls(conf)


GRAPH_CASES = {
    "trainable_false": lambda p: {"trainable": False},
    "node_updater": lambda p: {"updater": p["upd"].Sgd(learning_rate=0.5)},
    "weight_decay": lambda p: {"weight_decay": 0.5},
}


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_per_node_options_match_jax(case):
    jg = _graph(JAX, JGraph, **GRAPH_CASES[case](JAX)).init()
    pg = _graph(PORT, ComputationGraph, **GRAPH_CASES[case](PORT)).init(
        device="cpu")
    pg.params_from_jax(_host(jg.params))
    before = tree.map_(torch.clone, pg.params)
    for _ in range(4):
        jg.fit(XOR_X, XOR_Y)
        pg.fit(XOR_X, XOR_Y)
        assert pg.score() == pytest.approx(jg.score(), rel=TOL)
    _assert_params_close(jg, pg)
    if case == "trainable_false":
        _assert_unmoved(pg, before, "d")
        assert pg.opt_state["d"] == {}


@pytest.mark.parametrize("opt", ["l1", "l2", "learning_rate"])
def test_graph_refuses_the_options_the_jax_graph_ignores(opt):
    # the JAX graph builds and trains with the option, ignoring it
    jg = _graph(JAX, JGraph, **{opt: 0.3}).init()
    plain = _graph(JAX, JGraph).init()
    jg.fit(XOR_X, XOR_Y)
    plain.fit(XOR_X, XOR_Y)
    assert jg.score() == plain.score()
    with pytest.raises(NotImplementedError, match="ROADMAP.md C"):
        _graph(PORT, ComputationGraph, **{opt: 0.3}).init(device="cpu")
