"""ComputationGraph (port of ``deeplearning4j_tpu/nn/graph.py``).

A DAG of layers and vertices with named inputs and outputs, built by
``NeuralNetConfiguration.builder()...graph_builder()`` and trained by
``fit``. The DAG is walked in topological order on every forward, as
the JAX package walks it once at trace time; one training step is the
forward (through the layers' kernels on the card), the losses of every
output, autograd's backward and the optax-style update that
``MultiLayerNetwork`` runs too (``nn.multilayer.loss_and_grads`` and
``apply_updates``, one helper for both networks).

Parameters are a nested dict of f32 master tensors keyed by node name,
so a JAX graph's weights load directly (:meth:`params_from_jax`). Masks
thread through the graph as in the JAX package: a node takes the first
mask of its inputs, a vertex passes it on through ``propagate_mask``,
and a layer that removes the time axis (``ClsTokenPoolLayer``) ends it.

Not in this slice (each raises ``NotImplementedError``): JSON
serialisation, per-layer updaters, learning rates, l1/l2 and weight
decay, frozen layers, constraints, weight noise, listeners, the
numerics observatory, ``steps_per_loop > 1`` (the JAX package's scanned
device loop), an ``RnnOutputLayer`` output — the JAX graph's fused
head flattens its [B, T, F] input (``graph.py:290-298``), so the
reference's BERT MLM head is red and the port does not copy it — and
sequence-parallel layers under a ``distributed_context`` (ROADMAP item
A4).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from deeplearning4j_tpu_torch import dtypes, obs, tree
from deeplearning4j_tpu_torch.eval_.evaluation import Evaluation
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.config import _GLOBAL_DEFAULTS, InputType
from deeplearning4j_tpu_torch.nn.layers.base import (Layer, fold_in,
                                                     split_seed)
from deeplearning4j_tpu_torch.nn.layers.core import OutputLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    BaseRecurrentLayer, RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer import (
    _FUSABLE, _UNPORTED_LAYER_OPTIONS, MultiLayerNetwork, apply_updates,
    evaluate_batches, loss_and_grads)
from deeplearning4j_tpu_torch.nn.vertices import GraphVertex
from deeplearning4j_tpu_torch.ops import losses as losses_mod


@dataclass
class _Node:
    name: str
    kind: str                  # "layer" | "vertex"
    obj: Any
    inputs: List[str]


class ComputationGraphConfiguration:
    """Reference: ComputationGraphConfiguration (without JSON, which
    comes with serialisation)."""

    def __init__(self, inputs: List[str], outputs: List[str],
                 nodes: List[_Node], seed: int = 12345,
                 updater=None, dtype: str = "float32",
                 compute_dtype: Optional[str] = None,
                 input_types: Optional[Dict[str, InputType]] = None,
                 gradient_normalization: Optional[str] = None,
                 gradient_normalization_threshold: float = 1.0):
        self.inputs = inputs
        self.outputs = outputs
        self.nodes = nodes
        self.seed = seed
        self.updater = updater or upd.Sgd(learning_rate=1e-2)
        self.dtype = dtype
        self.compute_dtype = compute_dtype
        self.input_types = input_types or {}
        self.gradient_normalization = gradient_normalization
        self.gradient_normalization_threshold = \
            gradient_normalization_threshold


class GraphBuilder:
    """Reference: ComputationGraphConfiguration.GraphBuilder."""

    def __init__(self, global_conf=None):
        self._g = global_conf
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._nodes: List[_Node] = []
        self._input_types: Dict[str, InputType] = {}

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str
                  ) -> "GraphBuilder":
        if self._g is not None:
            for attr in _GLOBAL_DEFAULTS:
                if getattr(layer, attr, None) is None:
                    gv = getattr(self._g, attr, None)
                    if gv is not None:
                        setattr(layer, attr, gv)
        layer.name = name
        self._nodes.append(_Node(name, "layer", layer, list(inputs)))
        return self

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs: str
                   ) -> "GraphBuilder":
        self._nodes.append(_Node(name, "vertex", vertex, list(inputs)))
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs.extend(names)
        return self

    def set_input_types(self, **types: InputType) -> "GraphBuilder":
        self._input_types.update(types)
        return self

    def build(self) -> ComputationGraphConfiguration:
        g = self._g
        return ComputationGraphConfiguration(
            inputs=self._inputs, outputs=self._outputs, nodes=self._nodes,
            seed=g.seed_ if g else 12345,
            updater=g.updater_ if g else None,
            dtype=g.dtype_ if g else "float32",
            compute_dtype=g.compute_dtype_ if g else None,
            input_types=self._input_types,
            gradient_normalization=g.grad_norm_ if g else None,
            gradient_normalization_threshold=(
                g.grad_norm_threshold_ if g else 1.0))


def _toposort(nodes: List[_Node], inputs: List[str]) -> List[_Node]:
    """The nodes in an order where every node follows its inputs; raises
    ``ValueError`` naming the unreachable inputs of a cycle or of a node
    fed by a name that does not exist."""
    done = set(inputs)
    ordered: List[_Node] = []
    pending = list(nodes)
    while pending:
        progressed = False
        for n in list(pending):
            if all(i in done for i in n.inputs):
                ordered.append(n)
                done.add(n.name)
                pending.remove(n)
                progressed = True
        if not progressed:
            missing = {i for n in pending for i in n.inputs} - done
            raise ValueError(f"graph has cycle or missing inputs: "
                             f"{sorted(missing)}")
    return ordered


class ComputationGraph:
    """DAG network (reference ComputationGraph)."""

    def __init__(self, conf: ComputationGraphConfiguration):
        self.conf = conf
        self.order = _toposort(conf.nodes, conf.inputs)
        self.params: Dict[str, Any] = {}
        self.state: Dict[str, Any] = {}
        self.opt_state: Optional[Dict[str, Any]] = None
        self.listeners: List[Any] = []
        self.iteration = 0
        self.epoch = 0
        self.score_ = float("nan")
        self.device: Optional[torch.device] = None
        self._shapes: Dict[str, tuple] = {}

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def _check_supported(self) -> None:
        for node in self.order:
            if node.kind != "layer":
                continue
            layer = node.obj
            for attr, what in _UNPORTED_LAYER_OPTIONS:
                if getattr(layer, attr, None):
                    raise NotImplementedError(
                        f"node {node.name!r} ({type(layer).__name__}): "
                        f"{what} ({attr}) comes with the "
                        "MultiLayerNetwork-core slice")
            if not layer.trainable:
                raise NotImplementedError(
                    f"node {node.name!r}: frozen layers come with the "
                    "MultiLayerNetwork-core slice")
            if node.name in self.conf.outputs and isinstance(
                    layer, RnnOutputLayer):
                raise NotImplementedError(
                    f"output {node.name!r}: an RnnOutputLayer output is "
                    "not ported — the JAX graph's fused head flattens "
                    "its [B, T, F] input (deeplearning4j_tpu/nn/"
                    "graph.py:290-298), so the reference's BERT MLM head "
                    "fails; a later slice decides it")

    def init(self, input_shapes: Optional[Dict[str, tuple]] = None,
             device="cuda"):
        """Build the parameters (reference ComputationGraph.init()) on
        ``device``. Input shapes (no batch dim) come from
        ``input_shapes`` or the configuration's input types. Values are
        drawn on the CPU from one ``torch.Generator`` seeded with
        ``conf.seed``, node by node in topological order, so every
        device gets the same ones."""
        self._check_supported()
        shapes: Dict[str, tuple] = {}
        for name in self.conf.inputs:
            if input_shapes and name in input_shapes:
                shapes[name] = tuple(input_shapes[name])
            elif name in self.conf.input_types:
                shapes[name] = self.conf.input_types[name].shape
            else:
                raise ValueError(f"no input shape for {name!r}")
        dtype = dtypes.resolve(self.conf.dtype)
        gen = torch.Generator().manual_seed(self.conf.seed)
        self.device = torch.device(device)
        for node in self.order:
            in_shapes = [shapes[i] for i in node.inputs]
            if node.kind == "layer":
                p, s, out = node.obj.init(gen, in_shapes[0], dtype)
                self.params[node.name] = tree.map_(
                    lambda t: t.to(device), p)
                self.state[node.name] = s
            else:
                out = node.obj.output_shape(in_shapes)
            shapes[node.name] = out
        self._shapes = shapes
        self._build_optimizer()
        return self

    # the parameter and optimizer bookkeeping of MultiLayerNetwork, which
    # keys its groups by layer where this graph keys them by node
    params_from_jax = MultiLayerNetwork.params_from_jax
    opt_state_from_jax = MultiLayerNetwork.opt_state_from_jax
    _build_optimizer = MultiLayerNetwork._build_optimizer
    _as_input = MultiLayerNetwork._as_input
    num_params = MultiLayerNetwork.num_params
    set_listeners = MultiLayerNetwork.set_listeners

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _check_no_seq_context(self) -> None:
        """A graph whose layers carry a ``sequence_parallel`` mode is
        refused under a ``distributed_context``: each rank would hold
        its shard of the tokens (``parallel/mesh.py``), which the graph
        does not feed yet (ROADMAP item A4). Outside a context the mode
        is inert, as in the JAX graph."""
        from deeplearning4j_tpu_torch.parallel.mesh import active_context
        if active_context() is None:
            return
        for node in self.order:
            if (node.kind == "layer"
                    and getattr(node.obj, "sequence_parallel", None)):
                raise NotImplementedError(
                    f"node {node.name!r}: a ComputationGraph with "
                    "sequence-parallel layers under a distributed_context "
                    "comes with ROADMAP item A4")

    def _forward(self, params, state, inputs: Dict[str, torch.Tensor], *,
                 train: bool, rng, masks=None, pre_output: bool = False):
        """Returns (activations by node name, new state). ``rng``: an
        integer seed (or None), split once per layer node in topological
        order; ``masks``: [B, T] masks by input name."""
        if not params:
            raise RuntimeError(
                "Graph has no parameters — call init() before "
                "fit()/output() (reference: ComputationGraph.init()).")
        self._check_no_seq_context()
        acts: Dict[str, torch.Tensor] = dict(inputs)
        new_state = {}
        masks = dict(masks or {})
        out_set = set(self.conf.outputs)
        for node in self.order:
            xs = [acts[i] for i in node.inputs]
            m = next((masks[i] for i in node.inputs
                      if masks.get(i) is not None), None)
            with obs.devtime.scope(f"{node.name}.{type(node.obj).__name__}"):
                if node.kind == "vertex":
                    acts[node.name] = (node.obj.apply(xs, mask=m)
                                       if node.obj.needs_mask
                                       else node.obj.apply(xs))
                    masks[node.name] = node.obj.propagate_mask(m)
                    continue
                layer = node.obj
                sub = None
                if rng is not None:
                    rng, sub = split_seed(rng)
                if (pre_output and node.name in out_set
                        and isinstance(layer, OutputLayer)):
                    # pre-activation logits for the fused loss, [B, F]
                    x = xs[0]
                    if x.ndim > 2:
                        x = x.reshape(x.shape[0], -1)
                    z = x @ params[node.name]["W"]
                    if layer.has_bias:
                        z = z + params[node.name]["b"]
                    acts[node.name] = z
                    new_state[node.name] = state.get(node.name, {})
                    masks[node.name] = m
                    continue
                y, s = layer.apply(params.get(node.name, {}),
                                   state.get(node.name, {}), xs[0],
                                   train=train, rng=sub, mask=m)
            acts[node.name] = y
            new_state[node.name] = (state.get(node.name, {})
                                    if isinstance(layer, BaseRecurrentLayer)
                                    else s)
            masks[node.name] = layer.propagate_mask(m, None)
        return acts, new_state

    # ------------------------------------------------------------------
    # loss
    # ------------------------------------------------------------------
    def _out_loss(self, name):
        node = next(n for n in self.order if n.name == name)
        layer = node.obj
        loss_name = getattr(layer, "loss", None)
        if loss_name is None:
            raise ValueError(f"output {name!r} has no loss")
        act = (layer.activation or "identity").lower()
        fused = ((act, loss_name.lower()) in _FUSABLE
                 and isinstance(layer, OutputLayer))
        return loss_name, fused

    def _loss_fn(self, params, state, inputs, labels, masks, lmasks, rng):
        """The summed loss of every output, and the new state."""
        any_fused = any(self._out_loss(o)[1] for o in self.conf.outputs)
        cd = self.conf.compute_dtype
        if cd is not None:
            # bf16 forward/backward, f32 master params: the cast is in
            # the autograd graph, so gradients come back f32
            params = dtypes.cast_float_tree(params, cd)
            inputs = dtypes.cast_float_tree(inputs, cd)
        acts, new_state = self._forward(params, state, inputs, train=True,
                                        rng=rng, masks=masks,
                                        pre_output=any_fused)
        total = 0.0
        for name, y in zip(self.conf.outputs, labels):
            loss_name, fused = self._out_loss(name)
            fn = losses_mod.get(loss_name)
            logits = acts[name]
            with obs.devtime.scope(f"loss.{loss_name}"):
                if cd is not None and losses_mod.wants_f32_logits(fn,
                                                                  fused):
                    logits = logits.float()
                kw = {"from_logits": True} if fused else {}
                total = total + fn(y, logits, mask=lmasks.get(name), **kw)
        return total, new_state

    def _feed(self, xs, ys=(), fms=None, lms=None):
        """Inputs by input name, labels in output order, feature masks by
        input name and label masks by output name, on the device."""
        inputs = {n: self._as_input(x)
                  for n, x in zip(self.conf.inputs, xs)}
        labels = [self._as_input(y) for y in ys]
        masks = {n: self._as_input(m, torch.float32)
                 for n, m in zip(self.conf.inputs, fms or [])
                 if m is not None}
        lmasks = {n: self._as_input(m, torch.float32)
                  for n, m in zip(self.conf.outputs, lms or [])
                  if m is not None}
        return inputs, labels, masks, lmasks

    def _loss_and_grads(self, xs, ys, fms=None, lms=None, rng=None):
        """(loss, gradient tree, new state) at the current parameters
        for one batch given as in ``fit``; the gradients have the master
        parameters' dtype."""
        inputs, labels, masks, lmasks = self._feed(xs, ys, fms, lms)
        return loss_and_grads(
            lambda p: self._loss_fn(p, self.state, inputs, labels, masks,
                                    lmasks, rng), self.params)

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------
    def fit(self, features, labels=None, *, epochs: int = 1,
            features_masks=None, labels_masks=None,
            steps_per_loop: int = 1):
        """fit(MultiDataSet iterator, epochs=N) | fit([x...], [y...]) |
        fit(x, y).

        ``features_masks``: aligned with the inputs ([B, T] each, or
        None); ``labels_masks``: aligned with the outputs — the
        reference MultiDataSet mask semantics. Iterator items are
        MultiDataSet-like (``features``/``labels`` lists and optional
        ``features_masks``/``labels_masks``) or ``(xs, ys)`` pairs."""
        if steps_per_loop != 1:
            raise NotImplementedError(
                f"steps_per_loop={steps_per_loop}: the scanned K-step "
                "device loop comes with the MultiLayerNetwork-core slice")
        if labels is not None:
            xs = features if isinstance(features, (list, tuple)) \
                else [features]
            ys = labels if isinstance(labels, (list, tuple)) else [labels]
            self._fit_batch(xs, ys, features_masks, labels_masks)
            return self
        for _ in range(epochs):
            if hasattr(features, "reset"):
                features.reset()
            for mds in features:
                if hasattr(mds, "features"):
                    xs = (mds.features if isinstance(mds.features, list)
                          else [mds.features])
                    ys = (mds.labels if isinstance(mds.labels, list)
                          else [mds.labels])
                    self._fit_batch(xs, ys,
                                    getattr(mds, "features_masks", None),
                                    getattr(mds, "labels_masks", None))
                else:
                    xs, ys = mds
                    self._fit_batch(xs if isinstance(xs, list) else [xs],
                                    ys if isinstance(ys, list) else [ys])
            self.epoch += 1
        return self

    def _fit_batch(self, xs, ys, fms=None, lms=None):
        if self.listeners:
            raise NotImplementedError(
                "training listeners come with the MultiLayerNetwork-core "
                "slice")
        t0 = obs.now()
        rng = fold_in(self.conf.seed, self.iteration)
        t1 = obs.now()
        loss, grads, new_state = self._loss_and_grads(xs, ys, fms, lms,
                                                      rng)
        self.params, self.opt_state = apply_updates(
            self.conf.updater, self._grad_norm, self.params, grads,
            self.opt_state)
        self.state = new_state
        t2 = obs.now()
        self.score_ = float(loss)     # blocking device sync
        obs.record_step("ComputationGraph.fit", t0, t1, t2, obs.now())
        self.iteration += 1

    # ------------------------------------------------------------------
    # inference and scoring
    # ------------------------------------------------------------------
    @torch.no_grad()
    def output(self, *features, train: bool = False,
               features_masks=None) -> List[torch.Tensor]:
        """The output activations, in output order (reference
        ComputationGraph.output), on the graph's device (f32 under
        ``compute_dtype``). ``features_masks`` (aligned with the
        inputs) masks padded keys as in ``fit``; the JAX ``output``
        takes none."""
        cd = self.conf.compute_dtype
        params, state = self.params, self.state
        inputs, _, masks, _ = self._feed(features, fms=features_masks)
        if cd is not None:
            params = dtypes.cast_float_tree(params, cd)
            state = dtypes.cast_float_tree(state, cd)
            inputs = dtypes.cast_float_tree(inputs, cd)
        acts, _ = self._forward(params, state, inputs, train=train,
                                rng=None, masks=masks)
        outs = [acts[o] for o in self.conf.outputs]
        return [o.float() for o in outs] if cd is not None else outs

    def output_single(self, *features, features_masks=None):
        return self.output(*features, features_masks=features_masks)[0]

    def score(self, dataset=None) -> float:
        """The last training loss (reference ComputationGraph.score())."""
        return self.score_

    def evaluate(self, iterator) -> Evaluation:
        """Classification evaluation of the first output against the
        first label over ``iterator`` (reference
        ComputationGraph.evaluate): list features feed ``output(*x)``, the
        rule of the JAX ``SparkComputationGraph.do_evaluation``. The JAX
        ``ComputationGraph.evaluate`` (``deeplearning4j_tpu/nn/graph.py:
        783-793``) passes a list as the first input alone, so it fails on
        a graph of several inputs; on one input fed ``DataSet``s the two
        rules agree. No ``evaluate_regression``, as in the JAX graph."""
        return evaluate_batches(self, iterator, Evaluation())[0]

    def summary(self) -> str:
        lines = ["=" * 76,
                 f"{'Node':<24}{'Type':<26}{'Output':<16}{'Params':>8}",
                 "=" * 76]
        total = 0
        for node in self.order:
            n = 0
            if node.kind == "layer":
                n = sum(math.prod(t.shape)
                        for t in tree.leaves(self.params[node.name]))
            total += n
            lines.append(
                f"{node.name:<24}{type(node.obj).__name__:<26}"
                f"{str(self._shapes.get(node.name)):<16}{n:>8,}")
        lines.append("=" * 76)
        lines.append(f"Total params: {total:,}")
        return "\n".join(lines)
