"""The seven input preprocessors (``nn/preprocessors.py``), the
``PreprocessorVertex`` and the networks that apply them, on the CPU
against the JAX package: each preprocessor's output, output shape and
mask equal to its JAX counterpart's on the same numpy input (a reshape:
equal to the bit), the JSON beans both ways, a network with
preprocessors trained one step from the JAX weights, and the twin of
``tests/test_vertices_preprocessors.py::
test_feed_forward_applies_preprocessors``.

Tolerance of the trained step: the loss 1e-5 relative and the output
1e-5 absolute after it (the same f32 math in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn import preprocessors as jpre
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.vertices import \
    PreprocessorVertex as JPreprocessorVertex
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn import preprocessors as ppre
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.vertices import (PreprocessorVertex,
                                                  vertex_from_dict)

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# name → (constructor kwargs, batched input shape, mask shape or None)
CASES = {
    "CnnToFeedForwardPreProcessor": ({}, (2, 3, 4, 5), None),
    "FeedForwardToCnnPreProcessor": (
        dict(height=2, width=3, channels=4), (5, 24), None),
    "RnnToFeedForwardPreProcessor": ({}, (2, 6, 3), (2, 6)),
    "FeedForwardToRnnPreProcessor": (dict(time_steps=4), (8, 3), (8,)),
    "CnnToRnnPreProcessor": ({}, (2, 3, 4, 5), (2, 3)),
    "RnnToCnnPreProcessor": (dict(width=2, channels=3), (2, 5, 6),
                             (2, 5)),
}


def test_every_jax_preprocessor_is_ported():
    assert set(ppre._PREPROC_REGISTRY) == set(jpre._PREPROC_REGISTRY)
    assert set(CASES) | {"ComposableInputPreProcessor"} == set(
        ppre._PREPROC_REGISTRY)


@pytest.mark.parametrize("name", sorted(CASES))
def test_preprocessor_matches_jax(name):
    kw, shape, mshape = CASES[name]
    jp = getattr(jpre, name)(**kw)
    pp = getattr(ppre, name)(**kw)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(pp.pre_process(torch.tensor(x)).numpy(),
                                  np.asarray(jp.pre_process(jnp.asarray(x))))
    assert tuple(pp.output_shape(shape[1:])) == tuple(
        jp.output_shape(shape[1:]))
    if mshape is not None:
        m = (np.arange(np.prod(mshape)).reshape(mshape) % 3 > 0).astype(
            np.float32)
        jm = jp.propagate_mask(jnp.asarray(m))
        pm = pp.propagate_mask(torch.tensor(m))
        assert (jm is None) == (pm is None)
        if pm is not None:
            np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    assert pp.to_dict() == jp.to_dict()
    assert ppre.preprocessor_from_dict(jp.to_dict()) == pp


def test_composable_chains_its_processors():
    chain = dict(processors=(
        ("CnnToFeedForwardPreProcessor", {}),
        ("FeedForwardToRnnPreProcessor", dict(time_steps=2))))
    jp = jpre.ComposableInputPreProcessor(processors=tuple(
        getattr(jpre, n)(**k) for n, k in chain["processors"]))
    pp = ppre.ComposableInputPreProcessor(processors=tuple(
        getattr(ppre, n)(**k) for n, k in chain["processors"]))
    x = np.random.default_rng(1).normal(size=(4, 2, 3, 2)).astype(
        np.float32)
    np.testing.assert_array_equal(pp.pre_process(torch.tensor(x)).numpy(),
                                  np.asarray(jp.pre_process(jnp.asarray(x))))
    assert pp.output_shape((2, 3, 2)) == jp.output_shape((2, 3, 2))
    assert pp.to_dict() == jp.to_dict()
    assert ppre.preprocessor_from_dict(jp.to_dict()) == pp


def test_preprocessor_vertex_matches_jax():
    jv = JPreprocessorVertex(jpre.CnnToRnnPreProcessor())
    pv = PreprocessorVertex(ppre.CnnToRnnPreProcessor())
    x = np.random.default_rng(2).normal(size=(2, 3, 4, 5)).astype(
        np.float32)
    np.testing.assert_array_equal(pv.apply([torch.tensor(x)]).numpy(),
                                  np.asarray(jv.apply([jnp.asarray(x)])))
    assert pv.output_shape([(3, 4, 5)]) == jv.output_shape([(3, 4, 5)])
    assert pv.to_dict() == jv.to_dict()
    assert vertex_from_dict(jv.to_dict()) == pv


def _nets():
    def build(conf, inputs, layers, pre, upd):
        return (conf.builder().seed(3)
                .updater(upd.Sgd(learning_rate=1e-2)).list()
                .layer(layers.DenseLayer(n_out=16, activation="relu"))
                .layer(layers.ConvolutionLayer(n_out=2, kernel_size=(2, 2),
                                               padding="VALID",
                                               activation="relu"))
                .layer(layers.OutputLayer(n_out=2, activation="softmax",
                                          loss="mcxent"))
                .input_pre_processor(1, pre.FeedForwardToCnnPreProcessor(
                    height=4, width=4, channels=1))
                .input_pre_processor(2, pre.CnnToFeedForwardPreProcessor())
                .set_input_type(inputs.feed_forward(8)).build())
    jnet = JNet(build(JConf, JInputType, jl, jpre, jupd)).init()
    pnet = MultiLayerNetwork(build(NeuralNetConfiguration, InputType, pl,
                                   ppre, pupd)).init(device="cpu")
    pnet.params_from_jax(jax.tree.map(np.asarray, jnet.params))
    return jnet, pnet


def test_feed_forward_applies_preprocessors():
    """Twin of ``tests/test_vertices_preprocessors.py::
    test_feed_forward_applies_preprocessors``, against the JAX
    activations."""
    jnet, pnet = _nets()
    x = np.random.RandomState(0).randn(3, 8).astype(np.float32)
    acts = pnet.feed_forward(x)
    assert tuple(acts[-1].shape) == (3, 2)
    for a, b in zip(acts, jnet.feed_forward(x)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=0)
    mid = pnet.activate_selected_layers(0, 1, x)
    assert mid.ndim == 4                    # conv activation map
    np.testing.assert_allclose(
        mid.numpy(), np.asarray(jnet.activate_selected_layers(0, 1, x)),
        atol=TOL, rtol=0)
    assert pnet._layer_shapes == [tuple(s) for s in jnet._layer_shapes]


def test_network_with_preprocessors_trains_like_jax():
    jnet, pnet = _nets()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 8)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 6)]
    jnet.fit(x, y)
    pnet.fit(x, y)
    assert np.isclose(pnet.score(), jnet.score(), rtol=TOL, atol=0)
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=TOL, rtol=0)
