"""The layers ResNet-50 and the CNN zoo add to the port
(``nn/layers/core.py``: ``BatchNormalization``, ``ActivationLayer``,
``LocalResponseNormalization``; ``nn/layers/conv.py``: the 1-D and 3-D
convolutions and pooling, the transposed, depthwise and separable
convolutions, global pooling, upsampling, zero padding, cropping and
space-to-depth) against the JAX package's classes on the CPU: the same
numpy input, parameters and state on both sides (the port's init, its
shapes checked against the JAX init's), the forward, the gradient of
the input and of every parameter, batch
norm's running statistics after a training step, and each class's JSON
bean both ways. Twins of ``tests/test_layers.py:53-120`` (the
convolution, pooling and batch-norm tests), ``:233`` and ``:288`` (the
spatial utilities and the 1-D/3-D upsampling) and of
``tests/test_layer_registry_roundtrip.py`` for these classes.

Tolerances:
- float32 forward and gradients: 1e-5 of the largest magnitude of each
  compared tensor (the same f32 sums in another order).
- batch norm's running statistics after a step: 1e-6 of their largest
  magnitude (one f32 reduction over the batch, in another order).
- batch norm on a bfloat16 input (the one-pass variance): 2e-2 of the
  largest output — both sides take the statistics in f32 from the same
  bf16 input and round the output once, but XLA and PyTorch round the
  f32 affine factors to bf16 at other points.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.layers.base import \
    layer_from_dict as j_layer_from_dict
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn.layers.base import \
    layer_from_dict as p_layer_from_dict

TOL = 1e-5
STATE_TOL = 1e-6
BF16_TOL = 2e-2
GEN = torch.Generator().manual_seed(0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _t(tree_, grad=False):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a))
                        .requires_grad_(grad), tree_)


def _twin(jlayer, player, params, x, *, state=None, train=False,
          mask=None, seed=0):
    """The errors of the port's layer against the JAX one on ``x``: the
    output, the gradients of sum(y · w) (``w`` fixed, random) for the
    input and every parameter, and with ``train`` the new state. The
    JAX side runs as one jitted program (its eager ops would compile one
    by one)."""
    state = state or {}
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.tensor(mask)
    out = jax.eval_shape(lambda p, xx: jlayer.apply(
        p, state, xx, train=train, mask=jm)[0], params, x)
    w = np.random.default_rng(seed + 100).normal(
        size=out.shape).astype(np.float32)

    def loss(p, xx):
        y, s = jlayer.apply(p, state, xx, train=train, mask=jm)
        return jnp.sum(y * w), (y, s)

    (_, (jy, jstate)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    tp = _t(params, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    ty, tstate = player.apply(tp, _t(state), tx, train=train, mask=tm)
    (ty * torch.tensor(w)).sum().backward()
    assert tuple(ty.shape) == tuple(jy.shape)
    errs = {"out": _rel(ty.detach().numpy(), jy),
            "dx": _rel(tx.grad.numpy(), jgx)}
    for k in params:
        errs[f"d{k}"] = _rel(tp[k].grad.numpy(), jgp[k])
    if train:
        for k in state:
            assert not tstate[k].requires_grad
            errs[f"state.{k}"] = _rel(tstate[k].numpy(), jstate[k])
    return errs


def _init_both(jlayer, player, shape):
    """The port layer's parameters and state (as numpy), after checking
    their shapes and the output shape against the JAX layer's ``init``
    traced abstractly (a drawn JAX ``init`` compiles one ``jax.random``
    program per kernel shape, seconds on the CPU)."""
    box = {}

    def init():
        p, s, box["out"] = jlayer.init(jax.random.PRNGKey(1), shape)
        return p, s

    jp, js = jax.eval_shape(init)
    pp, ps, pout = player.init(GEN, shape)
    assert tuple(pout) == tuple(box["out"])
    as_np = (lambda t: jax.tree.map(
        lambda a: np.asarray(a.detach()), t,
        is_leaf=lambda a: isinstance(a, torch.Tensor)))
    pp, ps = as_np(pp), as_np(ps)
    assert jax.tree.map(np.shape, jp) == jax.tree.map(np.shape, pp)
    assert jax.tree.map(np.shape, js) == jax.tree.map(np.shape, ps)
    return pp, ps


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(
        np.float32)


# -- convolutions ---------------------------------------------------------
CONV_CASES = [
    # (id, class name, kwargs, input shape without the batch)
    *[(f"conv1d-{p}-s{s}-k{k}-d{d}", "Convolution1DLayer",
       dict(n_out=3, kernel_size=(k,), stride=(s,), dilation=(d,),
            padding=p, activation="tanh"), (9, 4))
      for p, (s, k, d) in itertools.product(
          ("VALID", "SAME"), ((1, 2, 1), (2, 3, 1), (1, 3, 2)))],
    ("conv1d-groups", "Convolution1DLayer",
     dict(n_out=4, kernel_size=(3,), groups=2, padding="SAME"), (7, 4)),
    *[(f"conv3d-{p}-s{s}", "Convolution3DLayer",
       dict(n_out=3, kernel_size=(2, 3, 2), stride=s, padding=p,
            activation="relu"), (5, 6, 5, 2))
      for p, s in itertools.product(("VALID", "SAME"),
                                    ((1, 1, 1), (2, 2, 1)))],
    *[(f"deconv2d-{p}-s{s}-k{k}", "Deconvolution2DLayer",
       dict(n_out=3, kernel_size=k, stride=s, padding=p,
            activation="tanh"), (4, 5, 2))
      for p, s, k in itertools.product(
          ("VALID", "SAME"), ((1, 1), (2, 2), (2, 3)), ((3, 2), (1, 1)))],
    *[(f"depthwise-{p}-s{s}-m{m}", "DepthwiseConvolution2DLayer",
       dict(kernel_size=(3, 3), stride=s, padding=p, depth_multiplier=m),
       (6, 7, 3))
      for p, s, m in (("VALID", (1, 1), 2), ("VALID", (2, 2), 1),
                      ("SAME", (1, 1), 2), ("SAME", (2, 2), 1))],
    *[(f"separable-{p}-s{s}", "SeparableConvolution2DLayer",
       dict(n_out=5, kernel_size=(2, 3), stride=s, padding=p,
            depth_multiplier=2, activation="tanh"), (6, 7, 3))
      for p, s in itertools.product(("VALID", "SAME"),
                                    ((1, 1), (2, 2)))],
]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: c[0])
def test_convolution_matches_jax(case):
    _, name, kw, shape = case
    jlayer, player = getattr(jl, name)(**kw), getattr(pl, name)(**kw)
    params, _ = _init_both(jlayer, player, shape)
    errs = _twin(jlayer, player, params,
                 _x((2,) + shape, CONV_CASES.index(case)))
    assert max(errs.values()) <= TOL, errs


# -- pooling ---------------------------------------------------------------
POOL_CASES = [
    *[(f"pool1d-{pt}-{p}-s{s}", "Subsampling1DLayer",
       dict(kernel_size=(3,), stride=(s,), padding=p, pooling_type=pt),
       (8, 3))
      for pt, (p, s) in itertools.product(("max", "avg", "pnorm", "sum"),
                                          (("VALID", 1), ("SAME", 2)))],
    *[(f"pool3d-{pt}-{p}", "Subsampling3DLayer",
       dict(kernel_size=(2, 2, 3), stride=(2, 1, 2), padding=p,
            pooling_type=pt), (5, 4, 5, 2))
      for pt, p in itertools.product(("max", "avg", "pnorm", "sum"),
                                     ("VALID", "SAME"))],
    *[(f"global-{pt}-{len(shape)}d", "GlobalPoolingLayer",
       dict(pooling_type=pt), shape)
      for pt, shape in itertools.product(
          ("max", "avg", "sum", "pnorm"), ((6, 3), (4, 5, 3),
                                           (3, 4, 2, 3)))],
]


@pytest.mark.parametrize("case", POOL_CASES, ids=lambda c: c[0])
def test_pooling_matches_jax(case):
    _, name, kw, shape = case
    jlayer, player = getattr(jl, name)(**kw), getattr(pl, name)(**kw)
    _init_both(jlayer, player, shape)
    errs = _twin(jlayer, player, {}, _x((2,) + shape,
                                        POOL_CASES.index(case) + 50))
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("pt", ("max", "avg", "sum", "pnorm"))
def test_global_pooling_masked_sequence_matches_jax(pt):
    """A [B, T, F] sequence pooled over its unmasked steps, the masked
    values left out of every pooling type."""
    mask = np.ones((3, 6), np.float32)
    mask[1, 4:] = 0.0
    mask[2, 1:] = 0.0
    kw = dict(pooling_type=pt)
    jlayer, player = jl.GlobalPoolingLayer(**kw), pl.GlobalPoolingLayer(
        **kw)
    errs = _twin(jlayer, player, {}, _x((3, 6, 4), 7), mask=mask)
    assert max(errs.values()) <= TOL, errs
    assert player.propagate_mask(torch.tensor(mask), None) is None


def test_global_pooling_masked():
    """Twin of ``test_layers.py::test_global_pooling_masked``."""
    x = torch.stack([torch.ones(4, 3), 2 * torch.ones(4, 3)])
    mask = torch.tensor([[1, 1, 0, 0], [1, 1, 1, 1]], dtype=torch.float32)
    y, _ = pl.GlobalPoolingLayer(pooling_type="avg").apply({}, {}, x,
                                                           mask=mask)
    np.testing.assert_allclose(y.numpy(), [[1] * 3, [2] * 3])


# -- the shape layers -------------------------------------------------------
SHAPE_CASES = [
    ("upsampling1d", "Upsampling1DLayer", dict(size=3), (4, 3)),
    ("upsampling2d", "Upsampling2DLayer", dict(size=(2, 3)), (3, 4, 2)),
    ("upsampling3d", "Upsampling3DLayer", dict(size=(2, 1, 3)),
     (2, 3, 2, 2)),
    ("zero_padding", "ZeroPaddingLayer", dict(padding=(1, 2, 0, 3)),
     (3, 4, 2)),
    ("cropping", "CroppingLayer", dict(cropping=(1, 0, 2, 1)), (5, 6, 2)),
    ("space_to_depth", "SpaceToDepthLayer", dict(block_size=2),
     (4, 6, 3)),
    ("depth_to_space", "DepthToSpaceLayer", dict(block_size=2),
     (2, 3, 8)),
    ("activation", "ActivationLayer", dict(activation="tanh"), (3, 4, 5)),
    ("lrn", "LocalResponseNormalization", {}, (3, 3, 8)),
    ("lrn_wide", "LocalResponseNormalization",
     dict(n=3, k=1.0, alpha=0.5, beta=0.6), (2, 7)),
]


@pytest.mark.parametrize("case", SHAPE_CASES, ids=lambda c: c[0])
def test_shape_layer_matches_jax(case):
    _, name, kw, shape = case
    jlayer, player = getattr(jl, name)(**kw), getattr(pl, name)(**kw)
    _init_both(jlayer, player, shape)
    errs = _twin(jlayer, player, {}, _x((2,) + shape,
                                        SHAPE_CASES.index(case) + 90))
    assert max(errs.values()) <= TOL, errs


def test_spatial_utils():
    """Twin of ``test_layers.py::test_spatial_utils``."""
    x = torch.randn(1, 4, 4, 4, generator=GEN)
    y, _ = pl.SpaceToDepthLayer(block_size=2).apply({}, {}, x)
    assert tuple(y.shape) == (1, 2, 2, 16)
    z, _ = pl.DepthToSpaceLayer(block_size=2).apply({}, {}, y)
    np.testing.assert_allclose(z.numpy(), x.numpy(), rtol=1e-6)
    u, _ = pl.Upsampling2DLayer(size=(2, 2)).apply({}, {}, x)
    assert tuple(u.shape) == (1, 8, 8, 4)


def test_upsampling_1d_3d():
    """Twin of ``test_layers.py::test_upsampling_1d_3d_and_cnn_loss``
    (the loss layers are not ported): shapes, the stretched mask, the
    repeated steps, the JAX mask to the bit."""
    x1 = torch.randn(2, 4, 3, generator=GEN)
    up1 = pl.Upsampling1DLayer(size=3)
    y1, _ = up1.apply({}, {}, x1)
    assert tuple(y1.shape) == (2, 12, 3)
    m = np.array([[1, 1, 0, 0], [1, 0, 0, 0]], np.float32)
    pm = up1.propagate_mask(torch.tensor(m), (4, 3))
    jm = jl.Upsampling1DLayer(size=3).propagate_mask(jnp.asarray(m),
                                                     (4, 3))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(y1[:, 0].numpy(), y1[:, 2].numpy())
    y3, _ = pl.Upsampling3DLayer(size=(2, 2, 2)).apply(
        {}, {}, torch.randn(1, 2, 2, 2, 3, generator=GEN))
    assert tuple(y3.shape) == (1, 4, 4, 4, 3)


@pytest.mark.parametrize("padding,stride", [("VALID", 1), ("VALID", 2),
                                            ("SAME", 2)])
def test_conv1d_mask_matches_jax(padding, stride):
    """A VALID 1-D convolution keeps the mask of each output's first
    step, as the JAX layer's ``propagate_mask``; SAME keeps it whole."""
    kw = dict(n_out=2, kernel_size=(3,), stride=(stride,), padding=padding)
    m = (np.arange(9)[None, :] < np.array([[9], [5]])).astype(np.float32)
    pm = pl.Convolution1DLayer(**kw).propagate_mask(torch.tensor(m), None)
    jm = jl.Convolution1DLayer(**kw).propagate_mask(jnp.asarray(m), None)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))


def test_conv1d_gradcheck():
    """Twin of ``test_layers.py::test_conv1d_gradcheck``: a float64
    finite-difference check of the port's gradients."""
    layer = pl.Convolution1DLayer(n_out=2, kernel_size=(2,),
                                  activation="tanh")
    params, _, out = layer.init(GEN, (5, 3), torch.float64)
    assert out == (4, 2)
    x = torch.randn((2, 5, 3), dtype=torch.float64, generator=GEN,
                    requires_grad=True)
    w = params["W"].requires_grad_(True)
    b = params["b"].requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda xx, ww, bb: layer.apply({"W": ww, "b": bb}, {}, xx)[0],
        (x, w, b))


def test_depthwise_separable_gradcheck():
    """Twin of ``test_layers.py::test_depthwise_separable``."""
    for layer in (pl.DepthwiseConvolution2DLayer(kernel_size=(2, 2),
                                                 depth_multiplier=2),
                  pl.SeparableConvolution2DLayer(n_out=3,
                                                 kernel_size=(2, 2))):
        params, _, _ = layer.init(GEN, (3, 3, 2), torch.float64)
        names = sorted(params)
        x = torch.randn((2, 3, 3, 2), dtype=torch.float64, generator=GEN,
                        requires_grad=True)
        leaves = [params[k].requires_grad_(True) for k in names]
        assert torch.autograd.gradcheck(
            lambda xx, *ps: layer.apply(dict(zip(names, ps)), {}, xx)[0],
            (x, *leaves))
    assert pl.DepthwiseConvolution2DLayer(depth_multiplier=2).init(
        GEN, (3, 3, 2))[2] == (1, 1, 4)


# -- batch normalisation -----------------------------------------------------
def _bn_params(c, seed):
    rng = np.random.default_rng(seed)
    params = {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "beta": rng.normal(size=c).astype(np.float32)}
    state = {"mean": rng.normal(size=c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    return params, state


BN_CASES = list(itertools.product(
    ((8, 5), (4, 3, 3, 6), (3, 7, 4)), (True, False), (False, True)))


@pytest.mark.parametrize("shape,train,locked", BN_CASES,
                         ids=lambda v: str(v))
def test_batch_norm_matches_jax(shape, train, locked):
    """Forward, gradients (through the batch statistics in training)
    and, in training, the running statistics after the step; in eval
    mode the output reads the running statistics."""
    kw = dict(decay=0.8, activation="relu", lock_gamma_beta=locked)
    jlayer, player = jl.BatchNormalization(**kw), pl.BatchNormalization(
        **kw)
    _init_both(jlayer, player, shape[1:])
    params, state = _bn_params(shape[-1], BN_CASES.index(
        (shape, train, locked)))
    if locked:
        params = {}
    x = _x(shape, 3) * 3.0 + 1.5
    errs = _twin(jlayer, player, params, x, state=state, train=train)
    state_errs = {k: v for k, v in errs.items() if k.startswith("state")}
    assert max(v for k, v in errs.items()
               if not k.startswith("state")) <= TOL, errs
    assert all(v <= STATE_TOL for v in state_errs.values()), errs
    assert len(state_errs) == (2 if train else 0)


@pytest.mark.parametrize("shape", ((64, 5), (8, 4, 4, 6)))
def test_batch_norm_bf16_one_pass_matches_jax(shape):
    """A bfloat16 input takes the one-pass variance E[x²] − E[x]² (in
    f32, clamped at 0) on both sides; the running statistics stay f32
    masters."""
    params, state = _bn_params(shape[-1], 11)
    x = (_x(shape, 12) * 2.0 + 0.5)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        torch.bfloat16)
    jlayer, player = jl.BatchNormalization(), pl.BatchNormalization()
    jy, js = jlayer.apply(jax.tree.map(lambda a: jnp.asarray(
        a, jnp.bfloat16), params), state, jx, train=True)
    ty, ts = player.apply(_t(params), _t(state), tx, train=True)
    assert ty.dtype == torch.bfloat16
    assert ts["mean"].dtype == torch.float32
    assert _rel(ty.float().numpy(), np.asarray(jy, np.float32)) <= BF16_TOL
    for k in ("mean", "var"):
        assert _rel(ts[k].numpy(), js[k]) <= STATE_TOL, k


def test_batch_norm_one_pass_variance_is_clamped():
    """A constant bf16 channel: E[x²] − E[x]² may round below 0, and is
    clamped to 0 on both sides, so the output stays finite."""
    x = np.full((16, 2), 3.3, np.float32)
    tx = torch.tensor(x).to(torch.bfloat16)
    y, s = pl.BatchNormalization(lock_gamma_beta=True).apply(
        {}, {"mean": torch.zeros(2), "var": torch.ones(2)}, tx, train=True)
    assert bool(torch.isfinite(y).all()) and bool((s["var"] >= 0.9).all())


def test_batchnorm_train_and_infer():
    """Twin of ``test_layers.py::test_batchnorm_train_and_infer``."""
    layer = pl.BatchNormalization()
    params, state, _ = layer.init(GEN, (3,))
    x = torch.randn(16, 3, generator=GEN) * 5 + 2
    y, new_state = layer.apply(params, state, x, train=True)
    np.testing.assert_allclose(y.mean(0).numpy(), 0, atol=1e-5)
    np.testing.assert_allclose(y.numpy().std(0), 1, atol=1e-2)
    assert not np.allclose(new_state["mean"].numpy(), 0)
    _, s2 = layer.apply(params, new_state, x, train=False)
    assert s2 is new_state


def test_batchnorm_gradcheck():
    """Twin of ``test_layers.py::test_batchnorm_gradcheck``: float64
    finite differences through the batch statistics."""
    layer = pl.BatchNormalization()
    params, state, _ = layer.init(GEN, (3,), torch.float64)
    x = torch.randn((4, 3), dtype=torch.float64, generator=GEN,
                    requires_grad=True)
    g = params["gamma"].requires_grad_(True)
    b = params["beta"].requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda xx, gg, bb: layer.apply({"gamma": gg, "beta": bb}, state,
                                       xx, train=True)[0], (x, g, b))


def test_layernorm_lrn():
    """Twin of ``test_layers.py::test_layernorm_lrn``'s LRN half (the
    LayerNorm half is ``tests/test_torch_layer_norm.py``'s)."""
    x = torch.randn(2, 3, 3, 8, generator=GEN)
    y, _ = pl.LocalResponseNormalization().apply({}, {}, x)
    assert y.shape == x.shape


# -- the JSON beans ---------------------------------------------------------
JSON_CASES = {
    "ActivationLayer": dict(activation="tanh"),
    "BatchNormalization": dict(decay=0.8, lock_gamma_beta=True),
    "LocalResponseNormalization": dict(n=3),
    "Convolution1DLayer": dict(n_out=2, kernel_size=(2,)),
    "Convolution3DLayer": dict(n_out=2, kernel_size=(2, 2, 2)),
    "Deconvolution2DLayer": dict(n_out=2, kernel_size=(2, 2),
                                 stride=(2, 2)),
    "DepthwiseConvolution2DLayer": dict(kernel_size=(2, 2),
                                        depth_multiplier=2),
    "SeparableConvolution2DLayer": dict(n_out=4, kernel_size=(2, 2)),
    "Subsampling1DLayer": dict(kernel_size=(2,), stride=(2,)),
    "Subsampling3DLayer": dict(kernel_size=(2, 2, 2), stride=(2, 2, 2)),
    "GlobalPoolingLayer": dict(pooling_type="avg"),
    "Upsampling1DLayer": dict(size=2),
    "Upsampling2DLayer": dict(size=(2, 2)),
    "Upsampling3DLayer": dict(size=(2, 2, 2)),
    "ZeroPaddingLayer": dict(padding=(1, 1, 1, 1)),
    "CroppingLayer": dict(cropping=(1, 1, 1, 1)),
    "SpaceToDepthLayer": dict(block_size=2),
    "DepthToSpaceLayer": dict(block_size=2),
}


@pytest.mark.parametrize("name", sorted(JSON_CASES))
def test_layer_json_crosses_both_ways(name):
    """The port's bean is the JAX package's, key for key; each package
    reads the other's into an equal layer (a fixpoint both ways)."""
    kw = JSON_CASES[name]
    pd, jd = getattr(pl, name)(**kw).to_dict(), getattr(jl, name)(
        **kw).to_dict()
    assert list(pd) == list(jd)
    assert jax.tree.map(lambda v: list(v) if isinstance(v, tuple) else v,
                        pd) == jax.tree.map(
        lambda v: list(v) if isinstance(v, tuple) else v, jd)
    assert type(p_layer_from_dict(jd)) is getattr(pl, name)
    assert p_layer_from_dict(jd).to_dict() == pd
    assert j_layer_from_dict(pd).to_dict() == jd
