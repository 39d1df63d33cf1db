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

``ComputationGraphConfiguration.to_json``/``from_json`` write and read
the JAX package's JSON (layers and vertices through their registries),
and training listeners are called as ``MultiLayerNetwork`` calls them.

Per-node options, as the JAX graph applies them: each layer node is one
parameter group with its own chain (``nn.updaters.GroupChain``: the
node's updater, its ``weight_decay``); a frozen node (``FrozenLayer``,
``FrozenLayerWithBackprop`` or ``trainable=False``) gets no update, no
optimizer state and no gradient; weight noise perturbs the training
forward's view of the masters, and constraints run after every update.
``l1``, ``l2`` and ``learning_rate`` on a node are refused: the JAX graph
silently ignores them (its optimizer never reads ``learning_rate`` and it
has no regularisation term, ``deeplearning4j_tpu/nn/graph.py:237-259``),
a gap of the reference the port does not copy (``ROADMAP.md`` C).

An ``RnnOutputLayer`` output keeps its [B, T, F] input and gives
[B, T, V] logits to the fused loss, the layer applied per time step as
its documented rule says (``deeplearning4j_tpu/nn/layers/recurrent.py:
378-392``), and a [B, T] labels mask scopes the loss: the BERT
masked-LM head trains. The JAX graph's fused head flattens that input
(``deeplearning4j_tpu/nn/graph.py:290-298``), so the reference fails
there; the port does not copy the fault (``ROADMAP.md`` C).

Layer state (batch norm's running statistics) lives on the graph's
device beside the parameters: a training step returns each layer's new
state and ``fit`` keeps it, in a K-step region too; ``output`` reads it
(cast to the compute dtype with the parameters, as the JAX ``output``
casts it); :meth:`ComputationGraph.state_from_jax` carries a JAX
graph's across.

Not in this slice (each raises ``NotImplementedError``): the numerics
observatory and sequence-parallel layers under a
``distributed_context`` (ROADMAP item A4).

``fit(iterator, steps_per_loop=K)`` runs K-step regions as
``MultiLayerNetwork`` does, and groups masked batches of one mask
structure (a padded BERT fine-tune keeps its region).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import dtypes, obs, tree
from deeplearning4j_tpu_torch.eval_.evaluation import Evaluation
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.config import _GLOBAL_DEFAULTS, InputType
from deeplearning4j_tpu_torch.nn.layers.base import (Layer, fold_in,
                                                     layer_from_dict,
                                                     split_seed)
from deeplearning4j_tpu_torch.nn.layers.core import OutputLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    RnnOutputLayer, returns_carries)
from deeplearning4j_tpu_torch.nn.multilayer import (
    _FUSABLE, REGION_SCOPE, MultiLayerNetwork, apply_updates,
    apply_weight_noise, check_frozen_options, evaluate_batches,
    has_weight_noise, loss_and_grads, notify_steps, stage)
from deeplearning4j_tpu_torch.nn.vertices import (GraphVertex,
                                                  vertex_from_dict)
from deeplearning4j_tpu_torch.ops import losses as losses_mod
from deeplearning4j_tpu_torch.resilience import faults


#: per-node options the JAX graph silently ignores, which the port refuses
_IGNORED_NODE_OPTIONS = ("l1", "l2", "learning_rate")


@dataclass
class _Node:
    name: str
    kind: str                  # "layer" | "vertex"
    obj: Any
    inputs: List[str]


class ComputationGraphConfiguration:
    """Reference: ComputationGraphConfiguration."""

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

    def to_json(self) -> str:
        """The JAX package's ``ComputationGraphConfiguration.to_json``,
        key for key and in its order."""
        return json.dumps({
            "inputs": self.inputs,
            "outputs": self.outputs,
            "nodes": [{"name": n.name, "kind": n.kind,
                       "inputs": n.inputs, "conf": n.obj.to_dict()}
                      for n in self.nodes],
            "seed": self.seed,
            "updater": self.updater.to_dict(),
            "dtype": self.dtype,
            "compute_dtype": self.compute_dtype,
            "input_types": {k: v.to_dict()
                            for k, v in self.input_types.items()},
            "gradient_normalization": self.gradient_normalization,
            "gradient_normalization_threshold":
                self.gradient_normalization_threshold,
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        d = json.loads(s)
        nodes = []
        for nd in d["nodes"]:
            obj = (layer_from_dict(nd["conf"]) if nd["kind"] == "layer"
                   else vertex_from_dict(nd["conf"]))
            nodes.append(_Node(nd["name"], nd["kind"], obj, nd["inputs"]))
        return ComputationGraphConfiguration(
            inputs=d["inputs"], outputs=d["outputs"], nodes=nodes,
            seed=d.get("seed", 12345),
            updater=upd.updater_from_dict(d["updater"]),
            dtype=d.get("dtype", "float32"),
            compute_dtype=d.get("compute_dtype"),
            input_types={k: InputType.from_dict(v)
                         for k, v in d.get("input_types", {}).items()},
            gradient_normalization=d.get("gradient_normalization"),
            gradient_normalization_threshold=d.get(
                "gradient_normalization_threshold", 1.0))


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


def _group_sig(xs, ys, fms, lms):
    """Grouping key of a ``steps_per_loop`` region (the JAX graph's
    ``_group_sig``): batches group only when every array shape and the
    mask structure match."""
    arrs = (list(xs) + list(ys)
            + [m for m in (fms or []) if m is not None]
            + [m for m in (lms or []) if m is not None])
    return (tuple(m is not None for m in (fms or [])),
            tuple(m is not None for m in (lms or [])),
            [tuple(np.shape(a)) for a in arrs])


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
            for attr in _IGNORED_NODE_OPTIONS:
                if getattr(layer, attr, None):
                    raise NotImplementedError(
                        f"node {node.name!r} ({type(layer).__name__}): "
                        f"{attr} on a ComputationGraph node — the JAX "
                        "graph silently ignores it (deeplearning4j_tpu/"
                        "nn/graph.py:237-259 never reads learning_rate, "
                        "and the graph has no l1/l2 term), a gap of the "
                        "reference the port refuses instead of copying "
                        "(ROADMAP.md C)")
            check_frozen_options(f"node {node.name!r}", layer)

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
                self.state[node.name] = tree.map_(
                    lambda t: t.to(device), s)
            else:
                out = node.obj.output_shape(in_shapes)
            shapes[node.name] = out
        self._shapes = shapes
        self._build_optimizer()
        return self

    def _group_layers(self) -> Dict[str, Layer]:
        """Parameter group → its layer: the layer nodes by name."""
        return {n.name: n.obj for n in self.order if n.kind == "layer"}

    # the parameter and optimizer bookkeeping of MultiLayerNetwork, which
    # keys its groups by layer where this graph keys them by node
    params_from_jax = MultiLayerNetwork.params_from_jax
    state_from_jax = MultiLayerNetwork.state_from_jax
    opt_state_from_jax = MultiLayerNetwork.opt_state_from_jax
    _build_optimizer = MultiLayerNetwork._build_optimizer
    _frozen = MultiLayerNetwork._frozen
    _as_input = MultiLayerNetwork._as_input
    num_params = MultiLayerNetwork.num_params
    set_listeners = MultiLayerNetwork.set_listeners
    add_listeners = MultiLayerNetwork.add_listeners

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
                    # pre-activation logits for the fused loss: [B, F],
                    # or [B, T, F] per time step for an RnnOutputLayer
                    x = xs[0]
                    if x.ndim > 2 and not isinstance(layer, RnnOutputLayer):
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
                                    if returns_carries(layer) else s)
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
        """The summed loss of every output, and the new state (weight
        noise on the forward's view of the masters, then the
        compute-dtype cast)."""
        any_fused = any(self._out_loss(o)[1] for o in self.conf.outputs)
        cd = self.conf.compute_dtype
        groups = self._group_layers()
        if has_weight_noise(groups):
            nrng, rng = split_seed(rng)
            params = apply_weight_noise(groups, params, nrng)
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
                                    lmasks, rng), self.params,
            self._frozen())

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
        ``features_masks``/``labels_masks``) or ``(xs, ys)`` pairs.
        ``steps_per_loop`` > 1 groups batches into K-step regions
        (:meth:`_fit_group`) by the JAX graph's rule
        (``deeplearning4j_tpu/nn/graph.py:667-679``): batches group while
        every array shape and the mask structure match
        (:func:`_group_sig`), masked batches included; a change flushes
        the group, and a group of one runs as a single batch."""
        if steps_per_loop < 1:
            raise ValueError(f"steps_per_loop={steps_per_loop} < 1")
        if labels is not None:
            xs = features if isinstance(features, (list, tuple)) \
                else [features]
            ys = labels if isinstance(labels, (list, tuple)) else [labels]
            self._fit_batch(xs, ys, features_masks, labels_masks)
            return self
        for _ in range(epochs):
            for listener in self.listeners:
                listener.on_epoch_start(self)
            if hasattr(features, "reset"):
                features.reset()
            group: list = []
            prev_sig = None
            src = iter(features)
            while True:
                te0 = obs.now()     # iterator wait = ETL attribution
                try:
                    mds = next(src)
                except StopIteration:
                    break
                te1 = obs.now()
                obs.record_etl("ComputationGraph.fit", te0, te1)
                if hasattr(mds, "features"):
                    xs = (mds.features if isinstance(mds.features, list)
                          else [mds.features])
                    ys = (mds.labels if isinstance(mds.labels, list)
                          else [mds.labels])
                    fms = getattr(mds, "features_masks", None)
                    lms = getattr(mds, "labels_masks", None)
                else:
                    xs, ys = mds
                    xs = xs if isinstance(xs, list) else [xs]
                    ys = ys if isinstance(ys, list) else [ys]
                    fms = lms = None
                if steps_per_loop > 1:
                    sig = _group_sig(xs, ys, fms, lms)
                    if group and sig != prev_sig:
                        self._flush_group(group)
                    group.append((xs, ys, fms, lms))
                    prev_sig = sig
                    if len(group) == steps_per_loop:
                        self._flush_group(group)
                else:
                    # the step's span starts at the batch's arrival
                    self._fit_batch(xs, ys, fms, lms, _t0=te1)
            self._flush_group(group)
            for listener in self.listeners:
                listener.on_epoch_end(self)
            self.epoch += 1
        return self

    _flush_group = MultiLayerNetwork._flush_group

    def _fit_group(self, group):
        """One K-step region over the K ``(xs, ys, fms, lms)`` batches of
        ``group`` (one shape and mask structure): the fault site first,
        then each input, label and mask stacked on the host and moved to
        the device in one copy, the K updates in turn with their losses
        written into a [K] tensor on the device, and one copy of the K
        losses to the host, then the listeners step by step (as
        ``MultiLayerNetwork._fit_group``)."""
        t0 = obs.now()
        faults.inject("step")       # site: step dispatch (resilience/)
        dev = self.device

        def field(pos, j, dtype=None):
            return stage([item[pos][j] for item in group], dev, dtype)

        xs = [field(0, j) for j in range(len(group[0][0]))]
        ys = [field(1, j) for j in range(len(group[0][1]))]
        fms = [None if m is None else field(2, j, torch.float32)
               for j, m in enumerate(group[0][2] or [])]
        lms = [None if m is None else field(3, j, torch.float32)
               for j, m in enumerate(group[0][3] or [])]
        t1 = obs.now()
        losses = torch.empty(len(group), dtype=torch.float32, device=dev)
        with obs.devtime.scope(REGION_SCOPE.format("ComputationGraph")):
            for i in range(len(group)):
                rng = fold_in(self.conf.seed, self.iteration + i)
                losses[i] = self._update(
                    [x[i] for x in xs], [y[i] for y in ys],
                    [None if m is None else m[i] for m in fms],
                    [None if m is None else m[i] for m in lms], rng)
        t2 = obs.now()
        host = losses.cpu()         # the group's one device sync
        t3 = obs.now()
        obs.record_step("ComputationGraph.fit", t0, t1, t2, t3,
                        args={"steps": len(group)})
        notify_steps(self, "ComputationGraph.fit", host.tolist())

    def _update(self, xs, ys, fms, lms, rng):
        """One gradient + optimizer update; returns the loss (on the
        device)."""
        loss, grads, new_state = self._loss_and_grads(xs, ys, fms, lms,
                                                      rng)
        self.params, self.opt_state = apply_updates(
            self._chains, self.params, grads, self.opt_state)
        self.state = new_state
        return loss

    def _fit_batch(self, xs, ys, fms=None, lms=None, _t0=None):
        t0 = obs.now() if _t0 is None else _t0
        faults.inject("step")       # site: step dispatch (resilience/)
        rng = fold_in(self.conf.seed, self.iteration)
        t1 = obs.now()
        loss = self._update(xs, ys, fms, lms, rng)
        t2 = obs.now()
        score = float(loss)           # blocking device sync
        obs.record_step("ComputationGraph.fit", t0, t1, t2, obs.now())
        notify_steps(self, "ComputationGraph.fit", [score])

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
