"""The port's ``ConvolutionLayer`` and ``SubsamplingLayer``
(``nn/layers/conv.py``) against the JAX package's on the CPU: the same
numpy input and the JAX layer's weights carried across, forward and
gradients (of the input and of every parameter), over VALID and SAME
padding, strides 1 and 2 (and mixed), odd and even kernels, dilation,
groups, and every pooling type. Twins of ``tests/test_layers.py``'s
``test_conv2d_gradcheck``, ``test_conv2d_same_shape``,
``test_pooling_types`` and ``test_avg_pool_matches_numpy``.

Tolerance: float32, 1e-5 relative to the largest magnitude of each
compared tensor (the same f32 sums in another order; measured ≤ 5e-7).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer,
                                                SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.layers.conv import _same_pads

TOL = 1e-5
GEN = torch.Generator().manual_seed(0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _twin(jlayer, player, params, x):
    """(output, d input, d params) of both layers for the loss
    sum(y ** 2), the port's from the JAX params carried across."""
    def loss(p, xx):
        return jnp.sum(jlayer.apply(p, {}, xx)[0] ** 2)

    jy = np.asarray(jlayer.apply(params, {}, jnp.asarray(x))[0])
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty, _ = player.apply(tp, {}, tx)
    (ty ** 2).sum().backward()
    assert tuple(ty.shape) == jy.shape
    errs = {"out": _rel(ty.detach().numpy(), jy),
            "dx": _rel(tx.grad.numpy(), jgx)}
    for k in params:
        errs[f"d{k}"] = _rel(tp[k].grad.numpy(), jgp[k])
    return errs


CONV_CASES = list(itertools.product(
    ("VALID", "SAME"), ((1, 1), (2, 2), (2, 1)), ((3, 3), (2, 2), (4, 3)),
    ((1, 1), (2, 1)), (1, 2)))


@pytest.mark.parametrize("padding,stride,kernel,dilation,groups",
                         CONV_CASES, ids=lambda v: str(v))
def test_convolution_forward_and_grads_match_jax(padding, stride, kernel,
                                                 dilation, groups):
    kw = dict(n_out=4, kernel_size=kernel, stride=stride, padding=padding,
              dilation=dilation, groups=groups, activation="tanh")
    jl, pl = JConv(**kw), ConvolutionLayer(**kw)
    params, _, out = jl.init(jax.random.PRNGKey(1), (9, 8, 4))
    tparams, _, tout = pl.init(GEN, (9, 8, 4))
    assert tout == out
    assert {k: tuple(v.shape) for k, v in tparams.items()} == \
        {k: tuple(v.shape) for k, v in params.items()}
    x = np.random.default_rng(CONV_CASES.index(
        (padding, stride, kernel, dilation, groups))).normal(
        size=(2, 9, 8, 4)).astype(np.float32)
    errs = _twin(jl, pl, params, x)
    assert max(errs.values()) <= TOL, errs


def test_conv2d_gradcheck_shape_and_valid_output():
    """Twin of ``test_layers.py::test_conv2d_gradcheck``'s layer: the
    output shape, and a float64 finite-difference check of the port's
    gradient."""
    layer = ConvolutionLayer(n_out=2, kernel_size=(2, 2), padding="VALID",
                             activation="tanh")
    params, _, out = layer.init(GEN, (4, 4, 2), torch.float64)
    assert out == (3, 3, 2)
    x = torch.randn((2, 4, 4, 2), dtype=torch.float64, generator=GEN,
                    requires_grad=True)
    w = params["W"].requires_grad_(True)
    b = params["b"].requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda xx, ww, bb: layer.apply({"W": ww, "b": bb}, {}, xx)[0],
        (x, w, b))


def test_conv2d_same_shape():
    layer = ConvolutionLayer(n_out=3, kernel_size=(3, 3), padding="SAME",
                             stride=(2, 2))
    _, _, out = layer.init(GEN, (8, 8, 1))
    assert out == (4, 4, 3)
    y, _ = layer.apply(layer.init(GEN, (8, 8, 1))[0], {},
                       torch.zeros(2, 8, 8, 1))
    assert tuple(y.shape) == (2, 4, 4, 3)


def test_same_padding_is_xlas_split():
    """XLA's SAME puts total // 2 before and the rest after: 8 rows,
    kernel 4, stride 2 → total 2 (1, 1); 7 rows, kernel 2, stride 1 →
    total 1 (0 before, 1 after); the tuple lists the last axis first."""
    assert _same_pads((8, 7), (4, 2), (2, 1), (1, 1), "SAME") == (0, 1,
                                                                  1, 1)
    assert _same_pads((8, 7), (4, 2), (2, 1), (1, 1), "VALID") == (0,) * 4
    with pytest.raises(ValueError, match="padding"):
        ConvolutionLayer(n_out=2, padding="same").init(GEN, (4, 4, 1))


POOL_CASES = list(itertools.product(
    ("VALID", "SAME"), ((1, 1), (2, 2), (3, 2)), ((2, 2), (3, 3), (2, 3)),
    ("max", "avg", "pnorm", "sum")))


@pytest.mark.parametrize("padding,stride,kernel,pooling", POOL_CASES,
                         ids=lambda v: str(v))
def test_pooling_forward_and_grads_match_jax(padding, stride, kernel,
                                             pooling):
    kw = dict(kernel_size=kernel, stride=stride, padding=padding,
              pooling_type=pooling)
    jl, pl = JPool(**kw), SubsamplingLayer(**kw)
    _, _, out = jl.init(None, (7, 8, 3))
    assert pl.init(GEN, (7, 8, 3))[2] == out
    x = np.random.default_rng(len(POOL_CASES)).normal(
        size=(2, 7, 8, 3)).astype(np.float32)
    errs = _twin(jl, pl, {}, x)
    assert max(errs.values()) <= TOL, errs


def test_pooling_types():
    """Twin of ``test_layers.py::test_pooling_types``."""
    for pt in ("max", "avg", "pnorm", "sum"):
        layer = SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                 pooling_type=pt)
        _, _, out = layer.init(GEN, (4, 4, 3))
        assert out == (2, 2, 3)
        y, _ = layer.apply({}, {}, torch.randn(2, 4, 4, 3, generator=GEN))
        assert tuple(y.shape) == (2, 2, 2, 3)
    with pytest.raises(ValueError, match="pooling type"):
        SubsamplingLayer(pooling_type="median").apply(
            {}, {}, torch.zeros(1, 4, 4, 1))


def test_avg_pool_matches_numpy():
    """Twin of ``test_layers.py::test_avg_pool_matches_numpy``, plus the
    SAME edge: a window that overhangs the input averages its unpadded
    elements only."""
    layer = SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                             pooling_type="avg")
    x = torch.arange(16.0).reshape(1, 4, 4, 1)
    y, _ = layer.apply({}, {}, x)
    expect = x.numpy().reshape(2, 2, 2, 2, 1).mean(axis=(1, 3))
    np.testing.assert_allclose(y.numpy()[0, ..., 0],
                               expect[..., 0].reshape(2, 2), rtol=1e-6)
    same = SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                            padding="SAME", pooling_type="avg")
    y, _ = same.apply({}, {}, torch.arange(9.0).reshape(1, 3, 3, 1))
    np.testing.assert_allclose(y.numpy()[0, ..., 0],
                               [[2.0, 3.5], [6.5, 8.0]], rtol=1e-6)


def test_conv_output_flattens_in_hwc_order():
    """A dense layer after the convolution reads the activations in
    H, W, C order, as the JAX package's reshape of an NHWC array does:
    the port's NCHW-strided result flattens to the same vector."""
    layer = ConvolutionLayer(n_out=3, kernel_size=(2, 2), padding="SAME")
    params, _, _ = layer.init(GEN, (4, 5, 2))
    x = np.random.default_rng(2).normal(size=(2, 4, 5, 2)).astype(
        np.float32)
    y, _ = layer.apply(params, {}, torch.tensor(x))
    jy, _ = JConv(n_out=3, kernel_size=(2, 2), padding="SAME").apply(
        {k: jnp.asarray(v.numpy()) for k, v in params.items()}, {},
        jnp.asarray(x))
    np.testing.assert_allclose(y.reshape(2, -1).numpy(),
                               np.asarray(jy).reshape(2, -1), rtol=TOL,
                               atol=TOL)


def test_other_spatial_ranks_are_refused_naming_a10():
    """The other spatial ranks are built, as the JAX package builds them:
    ``ConvolutionLayer`` with ``_spatial`` 1 or 3 (the 1-D and 3-D
    layers' base) gives the JAX layer's output, and a 2-D kernel size on
    a 1-D layer is refused as there (``tests/test_torch_cnn_layers.py``
    holds the 1-D and 3-D classes)."""
    for spatial, shape, kernel in ((1, (5, 3), (2,)),
                                   (3, (3, 4, 5, 2), (2, 2, 2))):
        kw = dict(n_out=2, kernel_size=kernel, stride=(1,) * spatial,
                  dilation=(1,) * spatial, padding="SAME",
                  _spatial=spatial)
        layer = ConvolutionLayer(**kw)
        params, _, out = layer.init(GEN, shape)
        assert out == JConv(**kw).init(jax.random.PRNGKey(0), shape)[2]
        x = np.random.default_rng(spatial).normal(
            size=(2,) + shape).astype(np.float32)
        errs = _twin(JConv(**kw), layer,
                     {k: jnp.asarray(v.numpy()) for k, v in params.items()},
                     x)
        assert max(errs.values()) <= TOL, errs
    with pytest.raises(ValueError, match="1-tuple"):
        ConvolutionLayer(n_out=2, _spatial=1).init(GEN, (5, 3))
