"""ResNet-50 and the CNN zoo on the CPU against the JAX package's.

- ``zoo.ResNet50`` (twin of ``tests/test_graph.py``'s
  ``test_resnet50_builds_and_runs_tiny``): the JAX net's node names and
  parameter count at ``num_classes=10, input_shape=(32, 32, 3)`` (and
  its published 25 557 032 at 224×224×3, counted on the meta device);
  one eval-mode f32 forward at the same weights and running statistics
  (drawn from a seed and loaded by ``state_from_jax``); ``fit`` and
  ``output`` on the port's own. The JAX nets here hold the port's
  weights: the JAX ``init`` compiles one ``jax.random`` program per
  kernel shape, seconds each on the CPU.
- A reduced ResNet built from each zoo object's own ``_conv_bn`` and
  ``_bottleneck`` (the stem, then one downsampling bottleneck a stage at
  narrow filters): one f32 training step, its loss, gradients and
  running statistics, and the Nesterovs update; the zip both ways with
  the batch-norm state.
- Layer state through the networks: a K-step region, a
  ``MultiLayerNetwork`` (SimpleCNN) step and zip against the JAX
  package's, the bf16 ``output`` (the running statistics cast as the
  JAX ``output`` casts them) and ``ParallelWrapper`` at one rank.
- AlexNet, VGG16, VGG19 (twins of ``tests/test_zoo.py``'s
  ``test_sequential_zoo_forward``) and SimpleCNN: the JAX parameter
  shapes, the forward from the JAX weights, rows summing to 1.

Tolerances:
- the eval-mode forward of the full ResNet-50 in f32: 1e-4 of the
  largest probability (53 convolutions deep, sums in another order).
- the reduced net's step in f32: the loss to 1e-5 relative, each
  gradient to 1e-4 of its leaf's largest magnitude, the running
  statistics to 1e-6 of their largest, the updated parameters to 1e-4
  of their leaf's largest (a leaf that starts at zero, batch norm's
  beta, is its update alone after one step, so it keeps the gradient's
  band).
- the SimpleCNN step (``MultiLayerNetwork``): the reduced net's bands.
- the bf16 ``output``: 2e-2 of the largest probability (both packages
  round at every op in bf16, in other places).
- a K-step region, and one step under ``ParallelWrapper`` at one rank,
  against single fits: equal to the bit.
- the sequential zoo's forward: 1e-5 of the largest probability; rows
  sum to 1 within 1e-4 (the reference test's band).
- across the zip: the restored net's parameters and state equal to the
  bit, and its output equal to the source's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import GlobalPoolingLayer as JGPool
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.serialization import ModelSerializer as JSerializer
from deeplearning4j_tpu_torch import tree
from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (GlobalPoolingLayer,
                                                OutputLayer,
                                                SubsamplingLayer)
from deeplearning4j_tpu_torch.serialization import ModelSerializer

FWD_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
STATE_TOL = 1e-6
PARAM_TOL = 1e-4
ZOO_TOL = 1e-5
SHAPE = (32, 32, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(t):
    return jax.tree.map(np.asarray, t)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _worst(port_tree, jax_tree):
    """The largest error of any leaf of ``port_tree`` against the same
    leaf of ``jax_tree``, each relative to that leaf's largest
    magnitude, and its path."""
    jt = _host(jax_tree)

    def at(path):
        node = jt
        for k in path:
            node = node[k]
        return node

    return max(tree.leaves(tree.map_with_path(
        lambda path, t: (_rel(t.detach().numpy(), at(path)),
                         ".".join(path)), port_tree)), default=(0.0, ""))


def _random_state(state, seed):
    """Running statistics drawn from ``seed``: means around 0, variances
    in [0.5, 2], so an eval forward reads them."""
    rng = np.random.default_rng(seed)
    return {node: {k: (rng.normal(size=np.shape(v)) * 0.1 if k == "mean"
                       else rng.uniform(0.5, 2.0, np.shape(v))
                       ).astype(np.float32) for k, v in s.items()}
            for node, s in state.items()}


# -- the full ResNet-50 ------------------------------------------------------
def _jax_twin(jcls, conf, pnet):
    """The JAX network of ``conf`` holding ``pnet``'s parameters and
    state (its own ``init`` draws every kernel shape through a compiled
    ``jax.random`` program, seconds each on the CPU; the twins need the
    forward, not the draw)."""
    jnet = jcls(conf)
    jnet.params = jax.tree.map(jnp.asarray, tree.map_(
        lambda t: t.detach().numpy(), pnet.params))
    jnet.state = jax.tree.map(jnp.asarray, tree.map_(
        lambda t: t.detach().numpy(), pnet.state))
    return jnet


def _jax_shapes(jcls, conf):
    """The JAX network's parameter and state shapes, from its ``init``
    traced abstractly."""
    return jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda: (lambda n: (n.params, n.state))(jcls(conf).init())))


def _shapes(net):
    """(parameter shapes, state shapes) of a port network."""
    return tuple(tree.map_(lambda t: tuple(t.shape), t)
                 for t in (net.params, net.state))


def test_resnet50_parameter_count_and_nodes_match_jax():
    model = jzoo.ResNet50(num_classes=10, input_shape=SHAPE)
    net = zoo.ResNet50(num_classes=10, input_shape=SHAPE).init(
        device="cpu")
    shapes = _jax_shapes(JGraph, model.conf())
    assert shapes == _shapes(net)
    want = sum(int(np.prod(s)) for s in jax.tree.leaves(
        shapes[0], is_leaf=lambda s: isinstance(s, tuple)))
    assert net.num_params() == want == 23_528_522
    assert [n.name for n in net.order] == [
        n.name for n in JGraph(model.conf()).order]
    full = zoo.ResNet50().init(device="meta")
    assert full.num_params() == 25_557_032
    assert full.conf.to_json() == jzoo.ResNet50().conf().to_json()


def test_resnet50_eval_forward_matches_jax():
    """Eval mode: every batch norm reads the running statistics (drawn
    from a seed, carried across by ``state_from_jax``), so the
    probabilities follow the JAX net's."""
    net = zoo.ResNet50(num_classes=10, input_shape=SHAPE).init(
        device="cpu")
    state = _random_state(tree.map_(lambda t: t.numpy(), net.state), 5)
    net.state_from_jax(state)
    jnet = _jax_twin(JGraph, jzoo.ResNet50(
        num_classes=10, input_shape=SHAPE).conf(), net)
    x = np.random.default_rng(0).normal(size=(2,) + SHAPE).astype(
        np.float32)
    want = np.asarray(jnet.output(x)[0])
    got = net.output(x)[0]
    assert got.shape == (2, 10)
    assert _rel(got.numpy(), want) <= FWD_TOL
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, rtol=1e-4)


def test_resnet50_builds_and_runs_tiny():
    """Twin of ``test_graph.py::test_resnet50_builds_and_runs_tiny`` on
    the port alone: output rows sum to 1, a fit step is finite and moves
    every batch norm's running statistics."""
    g = zoo.ResNet50(num_classes=10, input_shape=SHAPE).init(device="cpu")
    x = np.random.default_rng(0).normal(size=(2,) + SHAPE).astype(
        np.float32)
    out = g.output(x)[0]
    assert out.shape == (2, 10)
    np.testing.assert_allclose(out.sum(1).numpy(), 1.0, rtol=1e-4)
    before = tree.map_(torch.clone, g.state)
    g.fit(x, np.eye(10, dtype=np.float32)[[0, 1]])
    assert np.isfinite(g.score())
    moved = [not torch.equal(a, b) for a, b in
             zip(tree.leaves(g.state), tree.leaves(before))]
    assert len(moved) == 2 * 53 and all(moved)


# -- a reduced ResNet from the zoo objects' own blocks ---------------------
#: (filters, stride) of the one bottleneck a stage: the same filters at
#: every stage, so that the JAX package's restore of the zip draws few
#: kernel shapes
REDUCED = (((4, 4, 8), (1, 1)),) + (((4, 4, 8), (2, 2)),) * 3


def _reduced(model, conf_mod, in_type, pool, gpool, out_cls):
    """Stem (8 filters), the stem's max pool, then one downsampling
    bottleneck a stage, global average pooling and a 10-way softmax,
    built by ``model``'s own ``_conv_bn`` and ``_bottleneck``."""
    b = (conf_mod.builder().seed(7).updater(model.updater)
         .weight_init_fn("relu").graph_builder().add_inputs("input"))
    x = model._conv_bn(b, "stem", "input", 8, (7, 7), (2, 2))
    b.add_layer("stem_pool", pool(kernel_size=(3, 3), stride=(2, 2),
                                  padding="SAME", pooling_type="max"), x)
    x = "stem_pool"
    for i, (filters, stride) in enumerate(REDUCED):
        x = model._bottleneck(b, f"res{i + 2}_0", x, filters,
                              stride=stride, downsample=True)
    b.add_layer("avgpool", gpool(pooling_type="avg"), x)
    b.add_layer("fc", out_cls(n_out=10, activation="softmax",
                              loss="mcxent"), "avgpool")
    return (b.set_outputs("fc")
            .set_input_types(input=in_type.convolutional(*SHAPE)).build())


def _reduced_pair(seed=3):
    pnet = ComputationGraph(_reduced(
        zoo.ResNet50(), NeuralNetConfiguration, InputType,
        SubsamplingLayer, GlobalPoolingLayer, OutputLayer)).init(
        device="cpu")
    pnet.state_from_jax(_random_state(
        tree.map_(lambda t: t.numpy(), pnet.state), seed))
    jnet = _jax_twin(JGraph, _reduced(jzoo.ResNet50(), JConf, JInputType,
                                      JPool, JGPool, JOut), pnet)
    jnet._build_optimizer()
    return jnet, pnet


def _batch(seed, b=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b,) + SHAPE).astype(np.float32)
    return x, np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)]


def test_reduced_resnet_step_matches_jax():
    """One f32 step: the loss and every gradient through the batch
    statistics, the new running statistics, then the Nesterovs update of
    ``fit`` against the JAX optimizer's update of the JAX gradients."""
    import optax
    jnet, pnet = _reduced_pair()
    x, y = _batch(1)
    (jloss, jstate), jgrads = jax.jit(jax.value_and_grad(
        jnet._loss_fn, has_aux=True))(
        jnet.params, jnet.state, {"input": jnp.asarray(x)},
        [jnp.asarray(y)], {}, {}, jax.random.PRNGKey(0))
    loss, grads, state = pnet._loss_and_grads([x], [y])
    errs = {"loss": abs(float(loss) - float(jloss)) / abs(float(jloss)),
            "grads": _worst(grads, jgrads), "state": _worst(state, jstate)}
    jparams = jax.jit(lambda g, s, p: optax.apply_updates(
        p, jnet._optimizer.update(g, s, p)[0]))(jgrads, jnet.opt_state,
                                                jnet.params)
    pnet.fit(x, y)
    errs["fit_loss"] = abs(pnet.score() - float(jloss)) / abs(float(jloss))
    errs["params"] = _worst(pnet.params, jparams)
    errs["fit_state"] = _worst(pnet.state, jstate)
    assert errs["loss"] <= LOSS_RTOL and errs["fit_loss"] <= LOSS_RTOL, errs
    assert errs["grads"][0] <= GRAD_TOL, errs
    assert errs["state"][0] <= STATE_TOL, errs
    assert errs["fit_state"][0] <= STATE_TOL, errs
    assert errs["params"][0] <= PARAM_TOL, errs


def test_reduced_resnet_zips_cross_both_ways(tmp_path):
    """The port's zip (with the batch-norm state after two steps)
    restores in the JAX package with the same parameters and state, to
    the bit; the JAX package's zip of it restores in the port equal to
    the bit, its output too."""
    jnet, pnet = _reduced_pair(4)
    for s in (2, 3):
        pnet.fit(*_batch(s))
    ModelSerializer.write_model(pnet, tmp_path / "p.zip")
    jback = JSerializer.restore_computation_graph(str(tmp_path / "p.zip"))
    for mine, theirs in ((pnet.params, jback.params),
                         (pnet.state, jback.state)):
        assert _worst(mine, theirs)[0] == 0.0
    x, _ = _batch(9)
    JSerializer.write_model(jback, tmp_path / "j.zip")
    pback = ModelSerializer.restore_computation_graph(tmp_path / "j.zip",
                                                      device="cpu")
    for a, b in zip(tree.leaves(pback.params), tree.leaves(pnet.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree.leaves(pback.state), tree.leaves(pnet.state)):
        assert torch.equal(a, b)
    assert torch.equal(pback.output(x)[0], pnet.output(x)[0])


# -- layer state through the networks ---------------------------------------
def test_bn_state_rides_a_k_step_region():
    """A ``steps_per_loop`` region carries the batch norms' state from
    update to update: two regions of 2 equal 4 single fits to the bit,
    parameters and running statistics."""
    from deeplearning4j_tpu_torch.data import DataSet
    (_, a), (_, b) = _reduced_pair(6), _reduced_pair(6)
    batches = [_batch(20 + i) for i in range(4)]
    for x, y in batches:
        a.fit(x, y)
    calls = []
    orig = b._fit_batch
    b._fit_batch = lambda *x, **k: (calls.append(1), orig(*x, **k))[1]
    b.fit([DataSet(x, y) for x, y in batches], steps_per_loop=2)
    assert not calls and a.iteration == b.iteration == 4
    for what in ("params", "state"):
        for x, z in zip(tree.leaves(getattr(a, what)),
                        tree.leaves(getattr(b, what))):
            assert torch.equal(x, z)


def test_multilayer_bn_step_and_zip_match_jax(tmp_path):
    """``MultiLayerNetwork`` carries layer state as the graph does
    (SimpleCNN: two batch norms): one f32 step's loss, gradients and
    running statistics against the JAX network's at the same weights,
    then the zip with the state both ways."""
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    shape = (16, 16, 3)
    net = zoo.SimpleCNN(input_shape=shape).init(device="cpu")
    net.state_from_jax(_random_state(tree.map_(lambda t: t.numpy(),
                                               net.state), 8))
    jnet = _jax_twin(JNet, jzoo.SimpleCNN(input_shape=shape).conf(), net)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4,) + shape).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 4)]
    (jloss, jstate), jgrads = jax.jit(jax.value_and_grad(
        jnet._loss_fn, has_aux=True))(
        jnet.params, jnet.state, jnp.asarray(x), jnp.asarray(y), None,
        None, jax.random.PRNGKey(0))
    loss, grads, state = net._loss_and_grads(net._as_input(x),
                                             net._as_input(y))
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * float(jloss)
    assert _worst(grads, jgrads)[0] <= GRAD_TOL
    assert _worst(state, jstate)[0] <= STATE_TOL
    net.fit(x, y)
    ModelSerializer.write_model(net, tmp_path / "p.zip")
    jback = JSerializer.restore_multi_layer_network(str(tmp_path / "p.zip"))
    for mine, theirs in ((net.params, jback.params),
                         (net.state, jback.state)):
        assert _worst(mine, theirs)[0] == 0.0
    JSerializer.write_model(jback, tmp_path / "j.zip")
    back = ModelSerializer.restore_multi_layer_network(tmp_path / "j.zip",
                                                       device="cpu")
    for a, b in zip(tree.leaves(back.state), tree.leaves(net.state)):
        assert torch.equal(a, b)
    assert torch.equal(back.output(x), net.output(x))


def test_bf16_eval_output_matches_jax():
    """Under ``compute_dtype="bfloat16"`` both packages cast the running
    statistics to bf16 with the parameters in ``output`` (the JAX
    ``_make_output_fn``); the probabilities agree within 2e-2 of the
    largest, the masters stay f32."""
    model = zoo.ResNet50(compute_dtype="bfloat16")
    pnet = ComputationGraph(_reduced(
        model, NeuralNetConfiguration, InputType, SubsamplingLayer,
        GlobalPoolingLayer, OutputLayer))
    pnet.conf.compute_dtype = "bfloat16"
    pnet.init(device="cpu")
    pnet.state_from_jax(_random_state(tree.map_(lambda t: t.numpy(),
                                                pnet.state), 9))
    jconf = _reduced(jzoo.ResNet50(), JConf, JInputType, JPool, JGPool,
                     JOut)
    jconf.compute_dtype = "bfloat16"
    jnet = _jax_twin(JGraph, jconf, pnet)
    x, _ = _batch(11)
    got = pnet.output(x)[0]
    assert got.dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in tree.leaves(pnet.state))
    assert _rel(got.numpy(), np.asarray(jnet.output(x)[0])) <= 2e-2


def test_wrapper_carries_bn_state_at_one_rank():
    """``ParallelWrapper`` (SYNC, a one-process gloo group) over the
    reduced ResNet keeps the step's running statistics: one wrapped
    step equals one plain ``fit`` to the bit, parameters and state."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                                   initialize_distributed)
    (_, a), (_, b) = _reduced_pair(7), _reduced_pair(7)
    x, y = _batch(30)
    a.fit(x, y)
    assert not dist.is_initialized()
    initialize_distributed()
    try:
        ParallelWrapper(b, prefetch_buffer=0).fit([DataSet(x, y)])
    finally:
        dist.destroy_process_group()
    for what in ("params", "state"):
        for p, q in zip(tree.leaves(getattr(a, what)),
                        tree.leaves(getattr(b, what))):
            assert torch.equal(p, q)


# -- the sequential CNN zoo ------------------------------------------------
@pytest.mark.parametrize("name,in_shape,classes", [
    ("AlexNet", (64, 64, 3), 10),
    ("VGG16", (32, 32, 3), 10),
    ("VGG19", (32, 32, 3), 10),
    ("SimpleCNN", (48, 48, 3), 10),
])
def test_sequential_zoo_forward(name, in_shape, classes):
    """Twin of ``test_zoo.py::test_sequential_zoo_forward`` (SimpleCNN
    added): the JAX net's parameter and state shapes, and its forward
    from the same weights (dropout off in eval), rows summing to 1."""
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    jmodel = getattr(jzoo, name)(num_classes=classes, input_shape=in_shape)
    net = getattr(zoo, name)(num_classes=classes,
                             input_shape=in_shape).init(device="cpu")
    assert _jax_shapes(JNet, jmodel.conf()) == _shapes(net)
    jnet = _jax_twin(JNet, jmodel.conf(), net)
    x = np.random.default_rng(0).normal(size=(2,) + in_shape).astype(
        np.float32)
    out = net.output(x)
    assert tuple(out.shape) == (2, classes)
    np.testing.assert_allclose(out.sum(1).numpy(), 1.0, rtol=1e-4)
    assert _rel(out.numpy(), np.asarray(jnet.output(x))) <= ZOO_TOL


def test_zoo_entry_points_default_to_the_card():
    import inspect
    for cls in (zoo.ResNet50, zoo.AlexNet, zoo.VGG16, zoo.VGG19,
                zoo.SimpleCNN):
        assert inspect.signature(cls.init).parameters[
            "device"].default == "cuda"
