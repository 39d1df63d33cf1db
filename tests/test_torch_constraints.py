"""Parameter constraints and weight noise on the CPU (``nn/constraints.py``
and the networks' use of them), the port against the JAX package.

Twins of ``tests/test_constraints.py:25`` (the constraints' math, the
bias left alone), ``:56`` (constraints enforced after every update —
here also trajectory for trajectory against JAX, and for a graph node),
``:74`` (weight noise in training only), ``:91`` (DropConnect learns)
and ``:105`` (the JSON round trip, across the packages). The twin of
``:118`` (constraints and noise in the truncated-BPTT path) is in
``tests/test_torch_tbptt.py``.

Noise is drawn from the port's own seeds (``split_seed``), not
``jax.random``'s, so it is held by its statistics and by the masters
staying untouched, not against the JAX draws.

Tolerances (float32): constraint math 1e-6 relative (the same norms in
another order); trajectories 1e-5 (losses relative, parameters
absolute); noise statistics over 10^6 draws: mean within 5e-3 of its
target and the standard deviation within 1 % (over 20 standard errors
of the estimate), the keep rate within 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import constraints as jcons
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import \
    MultiLayerConfiguration as JMLConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu_torch import tree
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn import constraints as pcons
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer

JAX = dict(conf=JConf, inputs=JInputType, dense=JDense, out=JOut,
           upd=jupd, c=jcons)
PORT = dict(conf=NeuralNetConfiguration, inputs=InputType,
            dense=DenseLayer, out=OutputLayer, upd=pupd, c=pcons)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _col_norms(w):
    return np.sqrt((np.asarray(w) ** 2).sum(0))


def _host(params):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


CONSTRAINTS = {
    "max_norm": ("MaxNormConstraint", {"max_norm": 1.0}),
    "unit_norm": ("UnitNormConstraint", {}),
    "min_max_norm": ("MinMaxNormConstraint", {"min_norm": 2.0,
                                              "max_norm": 4.0,
                                              "rate": 0.7}),
    "non_negative": ("NonNegativeConstraint", {}),
}


@pytest.mark.parametrize("case", sorted(CONSTRAINTS))
def test_constraint_math(case):
    name, kw = CONSTRAINTS[case]
    w = np.random.default_rng(0).standard_normal((6, 4)).astype(
        np.float32) * 3.0
    b = -np.ones((4,), np.float32)
    want = getattr(jcons, name)(**kw).apply({"W": jnp.asarray(w),
                                             "b": jnp.asarray(b)})
    got = getattr(pcons, name)(**kw).apply({"W": torch.tensor(w),
                                            "b": torch.tensor(b)})
    np.testing.assert_allclose(got["W"].numpy(), np.asarray(want["W"]),
                               rtol=1e-6, atol=1e-7)
    # the bias is left alone unless apply_to_bias
    np.testing.assert_array_equal(got["b"].numpy(), b)
    with_b = getattr(pcons, name)(apply_to_bias=True, **kw).apply(
        {"b": torch.tensor(b)})
    np.testing.assert_allclose(with_b["b"].numpy(), np.asarray(
        getattr(jcons, name)(apply_to_bias=True, **kw).apply(
            {"b": jnp.asarray(b)})["b"]), rtol=1e-6)
    if case == "max_norm":
        assert (_col_norms(got["W"]) <= 1.0 + 1e-5).all()
    elif case == "unit_norm":
        np.testing.assert_allclose(_col_norms(got["W"]), 1.0, rtol=1e-5)


def _conf(pkg, layer_kw=None, out_kw=None, lr=0.5):
    return (pkg["conf"].builder().seed(5)
            .updater(pkg["upd"].Sgd(learning_rate=lr)).list()
            .layer(pkg["dense"](n_out=8, activation="tanh",
                                **(layer_kw or {})))
            .layer(pkg["out"](n_out=2, activation="softmax",
                              loss="mcxent", **(out_kw or {})))
            .set_input_type(pkg["inputs"].feed_forward(4)).build())


def _xy(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    return x, y


def test_constraints_enforced_during_training():
    def kw(pkg):
        return {"constraints": [pkg["c"].MaxNormConstraint(max_norm=0.7)]}

    jnet = JNet(_conf(JAX, kw(JAX))).init()
    pnet = MultiLayerNetwork(_conf(PORT, kw(PORT))).init(device="cpu")
    pnet.params_from_jax(_host(jnet.params))
    x, y = _xy(0, 64)
    for _ in range(10):            # a big rate pushes norms way past 0.7
        jnet.fit(x, y)
        pnet.fit(x, y)
        assert pnet.score() == pytest.approx(jnet.score(), rel=1e-5)
    assert (_col_norms(pnet.params["layer_0"]["W"]) <= 0.7 + 1e-4).all()
    tree.map_(lambda t, a: np.testing.assert_allclose(
        t.numpy(), a, atol=1e-5), pnet.params, _host(jnet.params))
    # constraints are per layer: the unconstrained layer moved freely
    fresh = MultiLayerNetwork(_conf(PORT)).init(device="cpu")
    assert not np.allclose(_col_norms(pnet.params["layer_1"]["W"]),
                           _col_norms(fresh.params["layer_1"]["W"]))


def test_constraints_in_a_k_step_region_and_on_a_graph_node():
    # a steps_per_loop region applies them after each of its updates
    def kw(pkg):
        return {"constraints": [pkg["c"].UnitNormConstraint()]}

    x, y = _xy(3, 16)
    a = MultiLayerNetwork(_conf(PORT, kw(PORT))).init(device="cpu")
    b = MultiLayerNetwork(_conf(PORT, kw(PORT))).init(device="cpu")
    for _ in range(3):
        a.fit(x, y)
    b.fit(iter([(x, y)] * 3), steps_per_loop=3)
    for p, q in zip(tree.leaves(a.params), tree.leaves(b.params)):
        assert torch.equal(p, q)

    def graph(pkg, cls):
        return cls(pkg["conf"].builder().seed(2)
                   .updater(pkg["upd"].Sgd(learning_rate=0.5))
                   .graph_builder().add_inputs("in")
                   .add_layer("d", pkg["dense"](
                       n_out=8, activation="tanh",
                       constraints=[pkg["c"].MaxNormConstraint(
                           max_norm=0.5)]), "in")
                   .add_layer("out", pkg["out"](
                       n_out=2, activation="softmax", loss="mcxent"), "d")
                   .set_outputs("out")
                   .set_input_types(**{"in": pkg["inputs"].feed_forward(4)})
                   .build())

    jg = graph(JAX, JGraph).init()
    pg = graph(PORT, ComputationGraph).init(device="cpu")
    pg.params_from_jax(_host(jg.params))
    for _ in range(4):
        jg.fit(x, y)
        pg.fit(x, y)
        assert pg.score() == pytest.approx(jg.score(), rel=1e-5)
    assert (_col_norms(pg.params["d"]["W"]) <= 0.5 + 1e-5).all()
    tree.map_(lambda t, a: np.testing.assert_allclose(
        t.numpy(), a, atol=1e-5), pg.params, _host(jg.params))


@pytest.mark.parametrize("additive", [True, False])
def test_weight_noise_statistics(additive):
    p = torch.full((1000, 1000), 2.0)
    noise = pcons.WeightNoise(stddev=0.5, mean=0.1, additive=additive)
    out = noise.apply({"W": p, "b": p[0]}, seed=7)
    n = (out["W"] - p) if additive else (out["W"] / p - 1.0)
    assert abs(n.mean().item() - 0.1) < 5e-3
    assert abs(n.std().item() - 0.5) < 5e-3
    assert torch.equal(out["b"], p[0])              # weights only
    again = noise.apply({"W": p, "b": p[0]}, seed=7)
    assert torch.equal(again["W"], out["W"])        # from its seed
    other = noise.apply({"W": p, "b": p[0]}, seed=8)
    assert not torch.equal(other["W"], out["W"])


def test_dropconnect_statistics():
    p = torch.full((1000, 1000), 3.0)
    out = pcons.DropConnect(weight_retain_prob=0.8).apply({"W": p},
                                                          seed=1)["W"]
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.8) < 2e-3
    assert torch.all(out[kept] == 3.0 / 0.8)


def test_weight_noise_train_only():
    def kw(pkg):
        return {"weight_noise": pkg["c"].WeightNoise(stddev=0.5)}

    x, y = _xy(1, 32)
    # a zero rate: the masters must come back untouched, bit for bit —
    # the noise is on the forward's view only
    still = MultiLayerNetwork(_conf(PORT, kw(PORT), lr=0.0)).init(
        device="cpu")
    before = tree.map_(torch.clone, still.params)
    plain = MultiLayerNetwork(_conf(PORT, lr=0.0)).init(device="cpu")
    still.fit(x, y)
    plain.fit(x, y)
    for a, b in zip(tree.leaves(still.params), tree.leaves(before)):
        assert torch.equal(a, b)
    assert still.score() != plain.score()           # the forward saw noise
    net = MultiLayerNetwork(_conf(PORT, kw(PORT))).init(device="cpu")
    w_before = net.params["layer_0"]["W"].clone()
    net.fit(x, y)
    w_after = net.params["layer_0"]["W"]
    assert torch.isfinite(w_after).all()
    assert not torch.equal(w_after, w_before)
    # inference is noise-free and deterministic
    assert torch.equal(net.output(x), net.output(x))


def test_dropconnect_learns():
    def kw(pkg):
        return {"weight_noise": pkg["c"].DropConnect(
            weight_retain_prob=0.8)}

    net = MultiLayerNetwork(_conf(PORT, kw(PORT))).init(device="cpu")
    x, y = _xy(2, 128)
    first = None
    for _ in range(40):
        net.fit(x, y)
        if first is None:
            first = net.score()
    assert net.score() < first * 0.7


def test_config_roundtrip_with_constraints_and_noise():
    def kw(pkg):
        return {"constraints": [pkg["c"].UnitNormConstraint()],
                "weight_noise": pkg["c"].DropConnect(
                    weight_retain_prob=0.9)}

    js = _conf(PORT, kw(PORT)).to_json()
    assert js == _conf(JAX, kw(JAX)).to_json()
    conf2 = MultiLayerConfiguration.from_json(js)
    l0 = conf2.layers[0]
    assert isinstance(l0.constraints[0], pcons.UnitNormConstraint)
    assert isinstance(l0.weight_noise, pcons.DropConnect)
    assert l0.weight_noise.weight_retain_prob == 0.9
    assert JMLConf.from_json(js).to_json() == js
    assert conf2.to_json() == js
