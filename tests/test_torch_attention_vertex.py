"""The port's ``AttentionVertex`` against the JAX package's on the CPU:
the vertex in its 3-input (queries, keys, values) and 2-input (queries,
keys-and-values) forms — output and gradients of every input — its JSON
bean, and a graph with it trained by ``fit`` against the JAX graph from
the same weights. On the card the vertex runs the flash kernels (K1
forward, K3 backward) through ``scaled_dot_attention``; here both
packages run the plain einsum and softmax.

Tolerances (float32): outputs and gradients 1e-5 absolute — the same
math in another summation order; the graph's losses 1e-5 relative per
step and its parameters 1e-6 absolute after three Adam steps, as
``tests/test_torch_graph.py`` holds its graph.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn import vertices as jv
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.nn import vertices as pv
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, ComputationGraphConfiguration)

TOL = 1e-5
#: queries over TQ steps, keys and values over TK, F features in HEADS
B, TQ, TK, F, HEADS = 3, 5, 7, 16, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(n):
    rng = np.random.default_rng(5)
    shapes = [(B, TQ, F), (B, TK, F), (B, TK, F)][:n]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("n_inputs", [3, 2])
def test_vertex_matches_jax(n_inputs):
    """The output [B, TQ, F] and the gradient of ``sum(out · co)`` for
    each input, against the JAX vertex."""
    xs = _inputs(n_inputs)
    co = np.random.default_rng(6).standard_normal((B, TQ, F)).astype(
        np.float32)
    jvert, pvert = jv.AttentionVertex(n_heads=HEADS), pv.AttentionVertex(
        n_heads=HEADS)
    theirs = jvert.apply([jnp.asarray(x) for x in xs])
    jgrads = jax.grad(lambda *a: jnp.sum(jvert.apply(list(a)) * co),
                      argnums=tuple(range(n_inputs)))(
        *[jnp.asarray(x) for x in xs])
    pxs = [torch.tensor(x, requires_grad=True) for x in xs]
    ours = pvert.apply(pxs)
    pgrads = torch.autograd.grad((ours * torch.tensor(co)).sum(), pxs)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                               atol=TOL, rtol=0)
    for i, (p, j) in enumerate(zip(pgrads, jgrads)):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=TOL,
                                   rtol=0, err_msg=f"input {i}")
    shapes = [x.shape[1:] for x in xs]
    assert tuple(pvert.output_shape(shapes)) == tuple(
        jvert.output_shape(shapes)) == (TQ, F)
    assert pvert.needs_mask is jvert.needs_mask is False


def _graph_conf(conf_cls, layers, vertices, upd, input_type):
    """Queries and keys each through a LayerNorm, the attention vertex
    over them, average pooling and a softmax output, from either
    package's classes."""
    return (conf_cls.builder().seed(9)
            .updater(upd.Adam(learning_rate=0.01))
            .graph_builder()
            .add_inputs("q", "kv")
            .add_layer("nq", layers.LayerNormalization(), "q")
            .add_layer("nkv", layers.LayerNormalization(), "kv")
            .add_vertex("att", vertices.AttentionVertex(n_heads=HEADS),
                        "nq", "nkv")
            .add_layer("pool", layers.GlobalPoolingLayer(
                pooling_type="avg"), "att")
            .add_layer("out", layers.OutputLayer(
                n_out=3, activation="softmax", loss="mcxent"), "pool")
            .set_outputs("out")
            .set_input_types(q=input_type.recurrent(F, TQ),
                             kv=input_type.recurrent(F, TK))
            .build())


def test_vertex_json_is_the_jax_bean():
    """The port's graph JSON is the JAX graph's, and reads back into an
    ``AttentionVertex`` through the vertex registry."""
    pconf = _graph_conf(NeuralNetConfiguration, pl, pv, pupd, InputType)
    jconf = _graph_conf(JConf, jl, jv, jupd, JInputType)
    assert pconf.to_json() == jconf.to_json()
    back = ComputationGraphConfiguration.from_json(jconf.to_json())
    vert = next(n.obj for n in back.nodes if n.name == "att")
    assert isinstance(vert, pv.AttentionVertex) and vert.n_heads == HEADS


def test_graph_with_the_vertex_fits_as_jax():
    """The graph's ``output`` and 3 ``fit`` steps from the JAX weights:
    the losses and the parameters after them match the JAX graph's."""
    jnet = JGraph(_graph_conf(JConf, jl, jv, jupd, JInputType)).init()
    pnet = ComputationGraph(_graph_conf(
        NeuralNetConfiguration, pl, pv, pupd, InputType)).init(
            device="cpu")
    pnet.params_from_jax(jax.tree.map(np.asarray, jnet.params))
    q, kv = _inputs(2)
    y = np.eye(3, dtype=np.float32)[[0, 2, 1]]
    np.testing.assert_allclose(pnet.output(q, kv)[0].numpy(),
                               np.asarray(jnet.output(q, kv)[0]),
                               atol=TOL, rtol=0)
    for _ in range(3):
        jnet.fit([q, kv], [y])
        pnet.fit([q, kv], [y])
        assert pnet.score() == pytest.approx(jnet.score(), rel=TOL)
    jp = jax.tree.map(np.asarray, jnet.params)
    for name in jp:
        for key in jp[name]:
            np.testing.assert_allclose(pnet.params[name][key].numpy(),
                                       jp[name][key], atol=1e-6, rtol=0,
                                       err_msg=f"{name}.{key}")
