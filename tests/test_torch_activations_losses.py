"""Every activation, loss and weight init of the JAX registries in the
port, on the CPU, against the JAX package.

Twins of ``tests/test_activations_losses.py:15`` (the registry
resolves), ``:22`` (known values), ``:33`` (an unknown name raises),
``:41`` (finite-difference gradients — here for every loss, in float64
through ``torch.autograd.gradcheck``), ``:77`` (the stable logit form of
``binary_xent``), ``:84`` (masking), ``:112`` (``fmeasure``'s mask) and
``:124`` (``score_array``); ``:61``/``:69`` (the logit and sparse forms
of the cross-entropy) come with them. ``:133`` (CTC) stays with
whichever item ports ``ctc_loss``, which is not in the losses' registry.
Every activation and loss is also held against the JAX function on the
same inputs, value and gradient, every weight init by its statistics
over a large draw against the JAX init's, and the fused sigmoid heads
(``_FUSABLE``'s two xent pairs) over 3 steps against the JAX network.

Tolerances: activations and losses in float32, 1e-5 relative and 1e-6
absolute (the same elementwise formula; the transcendental functions'
last bits differ between the libraries); gradcheck at its float64
defaults; weight inits over 120 000 and 51 200 draws: the mean within
0.02 standard deviations, the standard deviation within 2 %, a uniform
init's largest magnitude within 1 % under its limit (the JAX sample's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import weights as jweights
from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu_torch.nn import weights as pweights
from deeplearning4j_tpu_torch.ops import activations as pact
from deeplearning4j_tpu_torch.ops import losses as plosses

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- activations -------------------------------------------------------------
def test_activation_registry_resolves_all():
    assert pact.names() == jact.names()
    for name in pact.names():
        out = pact.get(name)(torch.linspace(-2, 2, 8))
        assert out.shape == (8,)


def test_activation_known_values():
    x = torch.tensor([-1.0, 0.0, 2.0])
    np.testing.assert_allclose(pact.get("relu")(x), [0, 0, 2])
    np.testing.assert_allclose(pact.get("sigmoid")(x),
                               1 / (1 + np.exp([1.0, 0.0, -2.0])), rtol=1e-6)
    np.testing.assert_allclose(pact.get("softmax")(x).sum(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(pact.get("hardtanh")(x), [-1, 0, 1])
    np.testing.assert_allclose(pact.get("cube")(x), [-1, 0, 8])


def test_unknown_activation_raises():
    with pytest.raises(ValueError):
        pact.get("nope")
    with pytest.raises(ValueError, match="takes no parameter"):
        pact.get("relu:0.5")


def _act_inputs():
    # no input sits on a kink (0, ±1, the thresholds)
    return np.random.default_rng(0).normal(size=(4, 9)).astype(
        np.float32) * 2.5


@pytest.mark.parametrize("name", jact.names() + ["leakyrelu:0.3", "elu:0.5",
                                                 "celu:2.0",
                                                 "thresholdedrelu:0.5",
                                                 "clippedrelu:3.0"])
def test_activation_matches_jax_value_and_gradient(name):
    x = _act_inputs()
    w = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    jf = jact.get(name)
    want = np.asarray(jf(jnp.asarray(x)))
    jgrad = np.asarray(jax.grad(lambda v: jnp.sum(jf(v) * w))(
        jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got = pact.get(name)(xt)
    (got * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), jgrad, rtol=RTOL,
                               atol=ATOL)


# -- losses ------------------------------------------------------------------
def _loss_inputs(name, rng, n=3, k=4):
    """(labels, preds) as the reference test draws them for ``name``."""
    preds = rng.uniform(0.05, 0.95, (n, k))
    if name in ("mcxent", "negativeloglikelihood", "kl_divergence", "kld"):
        lab = rng.uniform(size=(n, k))
        return lab / lab.sum(-1, keepdims=True), preds / preds.sum(
            -1, keepdims=True)
    if name in ("xent", "binary_xent", "reconstruction_crossentropy",
                "fmeasure"):
        return rng.integers(0, 2, (n, k)).astype(float), preds
    if name in ("hinge", "squared_hinge"):
        return rng.choice([-1.0, 1.0], (n, k)), rng.normal(size=(n, k))
    if name == "sparse_mcxent":
        return rng.integers(0, k, (n,)), preds / preds.sum(-1,
                                                           keepdims=True)
    labels = rng.normal(size=(n, k))
    if name in ("poisson", "msle", "mean_squared_logarithmic_error"):
        labels = np.abs(labels)
    return labels, preds


LOSSES = jlosses.names()


def test_loss_registry_resolves_all():
    assert plosses.names() == LOSSES
    with pytest.raises(ValueError):
        plosses.get("nope")
    with pytest.raises(ValueError, match="takes no parameter"):
        plosses.get("mse:2")


@pytest.mark.parametrize("name", LOSSES + ["huber:2.0", "fmeasure:2.0"])
def test_loss_matches_jax_value_and_gradient(name):
    rng = np.random.default_rng(3)
    labels, preds = _loss_inputs(name.partition(":")[0], rng)
    lab_dtype = np.int32 if name == "sparse_mcxent" else np.float32
    labels, preds = labels.astype(lab_dtype), preds.astype(np.float32)
    jf = jlosses.get(name)
    want, jgrad = jax.value_and_grad(lambda p: jf(jnp.asarray(labels), p))(
        jnp.asarray(preds))
    pt = torch.tensor(preds, requires_grad=True)
    got = plosses.get(name)(torch.tensor(labels), pt)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jgrad),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", LOSSES)
def test_loss_gradients_finite_difference(name):
    rng = np.random.default_rng(4)
    labels, preds = _loss_inputs(name, rng)
    lab = torch.tensor(labels)
    fn = plosses.get(name)
    p = torch.tensor(preds, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda q: fn(lab, q), (p,))


@pytest.mark.parametrize("name", ["mcxent", "xent"])
def test_from_logits_matches_the_activation_path(name):
    rng = np.random.default_rng(5)
    logits = torch.tensor(rng.normal(size=(5, 7)))
    if name == "mcxent":
        lab = torch.nn.functional.one_hot(
            torch.tensor(rng.integers(0, 7, 5)), 7).double()
        probs = torch.softmax(logits, -1)
    else:
        lab = torch.tensor(rng.integers(0, 2, (5, 7))).double()
        probs = torch.sigmoid(logits)
    fn = plosses.get(name)
    np.testing.assert_allclose(fn(lab, probs).item(),
                               fn(lab, logits, from_logits=True).item(),
                               rtol=1e-5)


def test_sparse_mcxent_matches_dense():
    rng = np.random.default_rng(6)
    logits = torch.tensor(rng.normal(size=(5, 7)))
    idx = torch.tensor(rng.integers(0, 7, 5))
    dense = plosses.mcxent(torch.nn.functional.one_hot(idx, 7).double(),
                           logits, from_logits=True)
    sparse = plosses.sparse_mcxent(idx, logits, from_logits=True)
    np.testing.assert_allclose(dense.item(), sparse.item(), rtol=1e-6)


def test_binary_xent_logits_stable():
    big = torch.tensor([[100.0, -100.0]], requires_grad=True)
    lab = torch.tensor([[1.0, 0.0]])
    val = plosses.binary_xent(lab, big, from_logits=True)
    val.backward()
    assert torch.isfinite(val) and val < 1e-3
    assert torch.isfinite(big.grad).all()


def test_loss_masking():
    labels = torch.ones((2, 3, 4))
    preds = torch.zeros((2, 3, 4))
    mask = torch.tensor([[1.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    full = plosses.mse(labels, preds)
    masked = plosses.mse(labels, preds, mask=mask)
    assert full > 0 and masked > 0
    np.testing.assert_allclose(
        plosses.mse(labels, preds, mask=torch.ones((2, 3))).item(),
        full.item(), rtol=1e-6)
    np.testing.assert_allclose(masked.item(), (2 * 4 + 1 * 4) / 2,
                               rtol=1e-6)
    assert plosses.mse(labels, preds, mask=torch.zeros((2, 3))) == 0
    for name in LOSSES:
        if name == "sparse_mcxent":
            continue
        j = jlosses.get(name)(jnp.ones((2, 3, 4)) * 0.5,
                              jnp.full((2, 3, 4), 0.25),
                              mask=jnp.asarray(mask.numpy()))
        p = plosses.get(name)(torch.full((2, 3, 4), 0.5),
                              torch.full((2, 3, 4), 0.25), mask=mask)
        np.testing.assert_allclose(p.item(), float(j), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_fmeasure_mask():
    labels = torch.tensor([[1.0, 0.0], [1.0, 1.0]])
    preds = torch.tensor([[0.9, 0.1], [0.2, 0.8]])
    m = torch.tensor([[1.0, 1.0], [0.0, 0.0]])
    masked = plosses.fmeasure(labels, preds, mask=m)
    only_first = plosses.fmeasure(labels[:1], preds[:1])
    np.testing.assert_allclose(masked.item(), only_first.item(), rtol=1e-6)
    # weights take the predictions' dtype
    w = plosses.fmeasure(labels.double(), preds.double(),
                         weights=np.array([1.0, 2.0], np.float32))
    assert w.dtype == torch.float64


def test_score_array_per_example():
    rng = np.random.default_rng(7)
    labels = torch.tensor(rng.normal(size=(6, 3)))
    preds = torch.tensor(rng.normal(size=(6, 3)))
    per = plosses.score_array("mse", labels, preds)
    assert per.shape == (6,)
    np.testing.assert_allclose(per.mean().item(),
                               plosses.mse(labels, preds).item(),
                               rtol=1e-5)
    want = jlosses.score_array("mse", jnp.asarray(labels.numpy()),
                               jnp.asarray(preds.numpy()))
    np.testing.assert_allclose(per.numpy(), np.asarray(want), rtol=1e-5)


# -- weight inits ------------------------------------------------------------
@pytest.mark.parametrize("name", pweights.names())
def test_weight_init_statistics_match_jax(name):
    assert pweights.names() == sorted(jweights._REGISTRY)
    g = torch.Generator().manual_seed(0)
    shapes = ([(300, 300)] if name == "identity"
              else [(400, 300), (5, 5, 32, 64)])
    for shape in shapes:
        got = pweights.get(name)(g, shape).double().numpy()
        want = np.asarray(jweights.get(name)(jax.random.PRNGKey(0), shape),
                          np.float64)
        assert got.shape == want.shape
        if name in ("zero", "ones", "identity"):
            np.testing.assert_array_equal(got, want)
            continue
        sd = want.std()
        assert abs(got.mean() - want.mean()) <= 0.02 * sd, name
        assert abs(got.std() / sd - 1) <= 0.02, (name, got.std(), sd)
        if "uniform" in name:
            lim = np.abs(want).max()
            assert 0.99 * lim <= np.abs(got).max() <= lim * 1.0001, name


@pytest.mark.parametrize("loss", ["xent", "binary_xent"])
def test_fused_sigmoid_head_matches_jax(loss):
    """The ``("sigmoid", "xent")`` and ``("sigmoid", "binary_xent")``
    pairs of ``_FUSABLE`` now resolve: an output layer trained through
    the stable logit form, 3 steps against the JAX network."""
    from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
    from deeplearning4j_tpu.nn import updaters as jupd
    from deeplearning4j_tpu.nn.config import InputType as JInputType
    from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
    from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
    from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn import updaters as pupd
    from deeplearning4j_tpu_torch.nn.config import InputType
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer

    def conf(c, inputs, dense, out, upd):
        return (c.builder().seed(2).updater(upd.Adam(learning_rate=0.05))
                .list().layer(dense(n_out=6, activation="tanh"))
                .layer(out(n_out=3, activation="sigmoid", loss=loss))
                .set_input_type(inputs.feed_forward(4)).build())

    jnet = JNet(conf(JConf, JInputType, JDense, JOut, jupd)).init()
    pnet = MultiLayerNetwork(conf(NeuralNetConfiguration, InputType,
                                  DenseLayer, OutputLayer, pupd)).init(
        device="cpu")
    pnet.params_from_jax(jax.tree.map(np.asarray, jnet.params))
    assert pnet._last_loss()[1]                  # the fused path
    rng = np.random.default_rng(8)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    y = rng.integers(0, 2, (16, 3)).astype(np.float32)
    for _ in range(3):
        jnet.fit(x, y)
        pnet.fit(x, y)
        assert pnet.score() == pytest.approx(jnet.score(), rel=RTOL)
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-5)
