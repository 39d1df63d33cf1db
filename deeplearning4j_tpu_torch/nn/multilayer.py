"""MultiLayerNetwork (port of ``deeplearning4j_tpu/nn/multilayer.py``).

A sequential stack trained by ``fit``: one training step is the forward
(through the layers' kernels on the card), the loss, autograd's
backward (the kernels' backward Functions) and the optax-style update of
``nn/updaters.py``. PyTorch runs the step eagerly where the JAX package
traces it into one jitted program; the numbers it computes are the same
(``tests/test_torch_train.py`` holds the two packages step for step).

Parameters are a nested dict of f32 master tensors, ``layer_<i>`` per
layer with the JAX package's names, so a JAX network's weights load
directly (:meth:`MultiLayerNetwork.params_from_jax`). With
``compute_dtype`` the forward and backward run in that dtype: the cast
sits inside the autograd graph, so gradients come back f32 for the
update. An update rebinds ``params`` to new tensors, as the JAX package
rebinds its donated arrays. Layer state (batch norm's running
statistics) lives on the device beside the parameters: a training step
returns each layer's new state, ``fit`` keeps it (in a K-step region
too), ``output`` reads it, and :meth:`MultiLayerNetwork.state_from_jax`
carries a JAX network's across.

Input preprocessors (``conf.input_preprocessors``, ``nn/preprocessors.py``)
run before their layer in every forward, and training listeners
(``train/listeners.py``) are called where the JAX network calls them:
``on_epoch_start``/``on_epoch_end`` around each epoch of an iterator's
``fit``, and ``iteration_done`` after each step's loss reached the host
(in a K-step region, once per step after the group's one copy, each
with that step's ``score_``).

Per-layer options, as the JAX network applies them: each layer is one
parameter group with its own chain (``nn.updaters.GroupChain``: the
layer's updater or learning rate, its ``weight_decay``); a frozen layer
(``FrozenLayer``, ``FrozenLayerWithBackprop`` or ``trainable=False``)
gets no update and keeps no optimizer state, and its parameters take no
gradient, so autograd stops the backward below the lowest layer that
trains. ``l1``/``l2`` add to the loss over each layer's f32 masters
(:func:`reg_score`), weight noise perturbs the training forward's view
of the masters before the compute-dtype cast, and constraints run after
every update (:func:`apply_updates`), in a K-step region too. A
``FrozenLayerWithBackprop`` that carries ``l1``, ``l2`` or
``weight_decay`` is refused (``ROADMAP.md`` C7: the JAX network moves
its weights by them).

Truncated BPTT (``backprop_type="TruncatedBPTT"``, a [B, T, F] input):
``fit`` cuts the batch's time axis into segments of ``tbptt_fwd_length``
steps (the last one shorter when the length does not divide T) and
makes one update a segment (:meth:`MultiLayerNetwork._fit_tbptt`, the
JAX ``_fit_tbptt``): the recurrent layers' final carries of a segment,
detached, are the next segment's initial state; a [B, T, C] label and
the masks are cut alike, a 2-D label goes whole to every segment; every
segment of a batch draws from the batch's one seed, ``fold_in(seed,
iteration)``. The optimizer's count moves once a segment, ``iteration``
once a batch; ``score_`` is the last segment's loss, read back once a
batch, and the listeners are called once a batch. Such batches never
join a ``steps_per_loop`` region. ``rnn_time_step`` runs the forward
from the carries the previous call left (the reference's stored-state
inference; ``rnn_clear_previous_state`` forgets them), in the masters'
dtype, as the JAX network does.

Not in this slice (it raises ``NotImplementedError``): the numerics
observatory.

``fit(iterator, steps_per_loop=K)`` runs groups of K batches as one
K-step region (:meth:`MultiLayerNetwork._fit_group`): the counterpart of
the JAX package's scanned loop, with one host→device copy a field and
one device→host copy of the K losses, and no read-back between the
updates; a CUDA graph over the region is later work.

Under a ``parallel.distributed_context`` a network whose layers carry a
``sequence_parallel`` mode trains and infers sequence-parallel, by the
per-process rule of ``parallel/mesh.py``: every rank is given the same
global batch and keeps its own tokens of the inputs, labels and masks;
its loss over them is its share of the global loss, and the loss and
the gradients are summed over the ``seq`` group before the update;
``output`` gathers the shards back. A layer that reduces the sequence
(``Layer.pools_sequence``: pooling, the CLS token, learned queries, a
dense layer's flatten) combines the ranks' partials over the group, and
the layers after it — the replicated tail — see the same whole [B, …]
on every rank: the labels and labels mask then stay whole, ``output``
returns the tail's output as it is, and the loss counts on the first
rank only. Layers that mix positions (``Layer.mixes_positions``) other
than the sequence-parallel attention and those pooling layers are
refused before the reduction, and a sequence-parallel layer after it
(:func:`_check_seq_layer`). Past one rank each rank draws its own
shard's dropout masks in the layers before the reduction (so the masks
are not those of a one-card run, nor the JAX package's, whose generator
differs) and the same masks in the tail. A network without such a mode
ignores the context, as the JAX network does.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import dtypes, obs, tree
from deeplearning4j_tpu_torch.data.dataset import has_masks
from deeplearning4j_tpu_torch.eval_.evaluation import (Evaluation,
                                                       RegressionEvaluation,
                                                       to_host)
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.base import (Layer, fold_in,
                                                     split_seed)
from deeplearning4j_tpu_torch.nn.layers.core import OutputLayer
from deeplearning4j_tpu_torch.nn.layers.extra import FrozenLayerWithBackprop
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    BaseRecurrentLayer, RnnOutputLayer, returns_carries)
from deeplearning4j_tpu_torch.nn.layers.special import FrozenLayer
from deeplearning4j_tpu_torch.ops import losses as losses_mod
from deeplearning4j_tpu_torch.resilience import faults

# losses that support the fused from_logits path, keyed by activation
_FUSABLE = {
    ("softmax", "mcxent"), ("softmax", "negativeloglikelihood"),
    ("softmax", "sparse_mcxent"), ("sigmoid", "xent"),
    ("sigmoid", "binary_xent"),
}

#: (optax state type, field) → the port's name for that state leaf
#: (``nn/updaters.py``): every state an updater of the JAX package keeps
_OPTAX_FIELDS = {
    **{("ScaleByAdamState", f): f for f in ("count", "mu", "nu")},
    **{("ScaleByAmsgradState", f): f
       for f in ("count", "mu", "nu", "nu_max")},
    ("ScaleByScheduleState", "count"): "schedule_count",
    ("ScaleByRmsState", "nu"): "nu",
    ("ScaleByRssState", "sum_of_squares"): "sum_of_squares",
    ("ScaleByAdaDeltaState", "e_g"): "e_g",
    ("ScaleByAdaDeltaState", "e_x"): "e_x",
    ("TraceState", "trace"): "trace",
}


#: the named device-time scope around a K-step region's updates (the
#: network's class name filled in): a profiler window reads the region's
#: own host calls — no device sync may fall inside it
REGION_SCOPE = "{}.fit/region"


def _lname(i: int) -> str:
    return f"layer_{i}"


def is_frozen(layer: Layer) -> bool:
    """Does ``layer``'s group stay still: a ``FrozenLayer``, a
    ``FrozenLayerWithBackprop`` (unlike the JAX networks, ``ROADMAP.md``
    C7), or ``trainable=False``?"""
    return (isinstance(layer, (FrozenLayer, FrozenLayerWithBackprop))
            or not layer.trainable)


def check_frozen_options(where: str, layer: Layer) -> None:
    """Refuse ``l1``, ``l2`` or ``weight_decay`` on a
    ``FrozenLayerWithBackprop``: the JAX networks build its group a full
    chain and put the l2 gradient outside its ``stop_gradient``, so those
    options move the weights it freezes; the port keeps them still and
    refuses the options instead of giving them another meaning."""
    if isinstance(layer, FrozenLayerWithBackprop):
        for attr in ("l1", "l2", "weight_decay"):
            if getattr(layer, attr, None):
                raise NotImplementedError(
                    f"{where}: {attr} on a FrozenLayerWithBackprop — the "
                    "JAX network moves the frozen weights by it (a gap "
                    "of the reference, ROADMAP.md C7); the port never "
                    "updates a frozen layer")


def group_chain(layer) -> Tuple[str, ...]:
    """The stages of the optax chain the JAX networks build for one
    parameter group (``deeplearning4j_tpu/nn/multilayer.py:139-158``,
    ``nn/graph.py:237-259``): ``set_to_zero`` for a frozen group (no
    state); else the gradient normalisation, the decoupled weight decay
    where the layer has one, then the updater. The port applies the same
    stages (``nn.updaters.GroupChain``); ``serialization.py`` reads the
    updater's position from here."""
    if is_frozen(layer):
        return ("set_to_zero",)
    return (("gradient_normalization",)
            + (("add_decayed_weights",) if layer.weight_decay else ())
            + ("updater",))


def build_chains(conf, groups) -> Dict[str, upd.GroupChain]:
    """One ``GroupChain`` per parameter group of ``groups`` (name → its
    layer): frozen, or the network's gradient normalisation, the layer's
    ``weight_decay`` and its updater (``nn.updaters.layer_updater``);
    either way the layer's constraints after the update."""
    grad_norm = upd.gradient_normalization(
        conf.gradient_normalization, conf.gradient_normalization_threshold)
    return {name: (upd.GroupChain(None, grad_norm, layer=layer)
                   if is_frozen(layer)
                   else upd.GroupChain(upd.layer_updater(layer,
                                                         conf.updater),
                                       grad_norm, layer.weight_decay,
                                       layer))
            for name, layer in groups.items()}


def reg_score(groups, params):
    """The l1 and l2 terms of every group's layer over its leaves of
    ``params`` (the JAX ``_reg_score``): ``l1·Σ|w| + ½·l2·Σw²``, frozen
    layers included; 0.0 when no layer has either. The leaves of the
    layers that share one (l1, l2) pair are joined into one vector, so
    that each term is one reduction, not one a leaf."""
    by_pair = {}
    for name, layer in groups.items():
        if layer.l1 or layer.l2:
            by_pair.setdefault((layer.l1, layer.l2), []).extend(
                t.reshape(-1) for t in tree.leaves(params[name]))
    total = 0.0
    for (l1v, l2v), leaves in by_pair.items():
        w = torch.cat(leaves)
        if l1v:
            # |w| with jnp.abs's gradient, +1 at w = 0 (a zero bias steps
            # under Adam; torch.abs's gradient there is 0)
            total = total + l1v * torch.sum(torch.where(w >= 0, w, -w))
        if l2v:
            total = total + 0.5 * l2v * torch.sum(torch.square(w))
    return total


def apply_weight_noise(groups, params, seed: int):
    """The training forward's view of ``params``: each group whose layer
    has ``weight_noise`` perturbed from its own seed, split off ``seed``
    in the groups' order (the JAX ``_apply_weight_noise``)."""
    out = dict(params)
    for name, layer in groups.items():
        wn = layer.weight_noise
        if wn is not None and name in out:
            seed, sub = split_seed(seed)
            out[name] = wn.apply(out[name], sub)
    return out


def has_weight_noise(groups) -> bool:
    return any(layer.weight_noise is not None for layer in groups.values())


def apply_constraints(chains, params):
    """``params`` with each group's constraints applied by its chain of
    ``chains`` (the JAX ``_apply_constraints``): for a caller that
    updates with ``apply_updates(..., constrain=False)`` and constrains
    a tree it gathers afterwards."""
    with torch.no_grad():
        return {name: chains[name].constrain(p)
                for name, p in params.items()}


def _mesh():
    """``parallel/mesh.py`` (imported at the call: ``parallel`` imports
    this module)."""
    from deeplearning4j_tpu_torch.parallel import mesh
    return mesh


def _check_seq_layer(where: str, layer, sharded: bool) -> None:
    """Raise unless ``layer`` (or a graph vertex) can run where it sits
    in a sequence-parallel network. Fed the rank's shard of the sequence
    (``sharded``) it must have a ``sequence_parallel`` mode, reduce the
    sequence over the group (``pools_sequence``) or not mix positions
    (``mixes_positions``), else ``NotImplementedError``; in the
    replicated tail it must not carry a ``sequence_parallel`` mode, which
    would split its whole input as a shard (``ValueError``)."""
    if not sharded:
        if getattr(layer, "sequence_parallel", None) is not None:
            raise ValueError(
                f"{where} ({type(layer).__name__}) is sequence-parallel "
                "but comes after the layer that reduces the sequence: "
                "every rank holds the whole input there")
        return
    why = layer.mixes_positions
    if (why and not hasattr(layer, "sequence_parallel")
            and not layer.pools_sequence):
        if not isinstance(why, str):
            why = ""
        elif why.startswith("ROADMAP.md C"):
            why = f": it stays refused there by design ({why})"
        else:
            why = f": it comes there with {why}"
        raise NotImplementedError(
            f"{where} ({type(layer).__name__}) mixes positions, so it "
            "cannot run on a rank's shard of the sequence under a "
            "sequence-parallel context" + why)


def _sum_over(group, loss, grads):
    """The loss and every gradient summed over ``group`` (one all-reduce
    per dtype of one flat buffer): the same bits on every rank."""
    leaves = [loss.reshape(1)] + list(tree.leaves(grads))
    summed = list(leaves)
    for dtype in dict.fromkeys(t.dtype for t in leaves):
        idx = [i for i, t in enumerate(leaves) if t.dtype == dtype]
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        _mesh().all_reduce_sum(flat, group)
        at = 0
        for i in idx:
            n = leaves[i].numel()
            summed[i] = flat[at:at + n].view_as(leaves[i])
            at += n
    it = iter(summed[1:])
    return summed[0].reshape(()), tree.map_(lambda _: next(it), grads)


def loss_and_grads(loss_fn, params, frozen=()):
    """``(loss, gradients, aux)`` of ``loss_fn(params) -> (loss, aux)``
    at ``params`` (a dict of parameter groups, each a nested dict of
    tensors): the loss detached and a gradient tree of the parameters'
    structure and dtype (zeros for a parameter the loss does not reach).
    The groups named in ``frozen`` take no gradient: their leaves are
    left without ``requires_grad``, so autograd never differentiates
    through them (nor below them, when nothing below trains), and their
    gradients are zeros, as optax's ``set_to_zero`` makes them. The
    training step of both ``MultiLayerNetwork`` and
    ``ComputationGraph``."""
    work = {name: tree.map_(
        (lambda t: t.detach()) if name in frozen
        else (lambda t: t.detach().requires_grad_(True)), p)
        for name, p in params.items()}
    loss, aux = loss_fn(work)
    leaves = [t for name, p in work.items() if name not in frozen
              for t in tree.leaves(p)]
    flat = (torch.autograd.grad(loss, leaves, allow_unused=True)
            if leaves and loss.requires_grad else [None] * len(leaves))
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, flat))
    grads = {name: tree.map_(torch.zeros_like if name in frozen
                             else (lambda _: next(it)), p)
             for name, p in work.items()}
    return loss.detach(), grads, aux


def evaluate_batches(net, iterator, *evals):
    """Feed every batch of ``iterator`` through ``net.output`` and each
    evaluation of ``evals``; returns ``evals`` as a list. The JAX
    package's rule of ``SparkComputationGraph.do_evaluation``
    (``deeplearning4j_tpu/parallel/master.py:285-305``), shared by both
    networks' ``evaluate``: ``reset()`` the iterator if it has one;
    batches are ``DataSet``/``MultiDataSet``-like or ``(x, y)`` pairs;
    list features go to ``output(*x)``, and the first output is
    evaluated against the first label. The output is copied to the host
    once a batch. A batch with masks raises ``NotImplementedError``."""
    if hasattr(iterator, "reset"):
        iterator.reset()
    for ds in iterator:
        if has_masks(ds):
            raise NotImplementedError(
                "evaluate: a batch with features or labels masks — the "
                "JAX evaluate and do_evaluation pass no masks to output "
                "or eval (deeplearning4j_tpu/nn/multilayer.py:868-894, "
                "nn/graph.py:783-793, parallel/master.py:285-305), so "
                "they would evaluate the batch unmasked; the port refuses "
                "it until that gap of the reference is decided "
                "(ROADMAP.md C)")
        x, y = (ds.features, ds.labels) if hasattr(ds, "features") else ds
        out = (net.output(*x) if isinstance(x, (list, tuple))
               else net.output(x))
        if isinstance(out, (list, tuple)):
            out = out[0]
        if isinstance(y, (list, tuple)):
            y = y[0]
        out, y = to_host(out), to_host(y)
        for e in evals:
            e.eval(y, out)
    return list(evals)


def notify_steps(net, entry: str, scores) -> None:
    """After steps whose losses ``scores`` reached the host: advance
    ``net.iteration`` by one a score, set ``net.score_`` to it and call
    each listener's ``iteration_done``, step by step; with listeners and
    tracing on, one ``<entry>/listeners`` span covers the calls (the JAX
    networks' rule, ``deeplearning4j_tpu/nn/multilayer.py:512-522``)."""
    tl0 = obs.now()
    for score in scores:
        net.score_ = float(score)
        net.iteration += 1
        for listener in net.listeners:
            listener.iteration_done(net, net.iteration, net.epoch)
    if net.listeners and obs.trace.enabled():
        obs.trace.add_span(f"{entry}/listeners", tl0, obs.now())


def stage(arrays, device, dtype=None) -> torch.Tensor:
    """The K arrays of one field of a ``steps_per_loop`` group stacked
    into [K, ...] on the host (on the device when they already lie
    there) and moved to ``device`` in one copy."""
    if all(isinstance(a, torch.Tensor) for a in arrays):
        t = torch.stack(list(arrays))
    else:
        t = torch.from_numpy(np.stack([np.asarray(a) for a in arrays]))
    return t.to(device, dtype=dtype)


def apply_updates(chains, params, grads, opt_state, constrain=True):
    """One optax-style update of every top-level group of ``params`` (a
    layer, or a graph node) by its own chain of ``chains`` (name →
    ``nn.updaters.GroupChain``) and state, as the JAX networks'
    per-group ``multi_transform`` does: a frozen group keeps its tensors
    and its empty state. Then (``constrain``) each group's constraints,
    frozen groups included, as the JAX networks apply them after every
    update. Returns ``(new params, new optimizer state)``: new tensors
    for the groups that move, the old trees untouched."""
    with torch.no_grad(), obs.devtime.scope("optimizer.update"):
        new_params, new_opt = {}, {}
        for name, p in params.items():
            chain = chains[name]
            if chain.frozen:
                new_opt[name] = {}
            else:
                u, new_opt[name] = chain.update(grads[name],
                                                opt_state[name], p)
                p = tree.map_(lambda a, d: (a + d).to(a.dtype), p, u)
            new_params[name] = chain.constrain(p) if constrain else p
    return new_params, new_opt


class MultiLayerNetwork:
    """Sequential stack model (reference MultiLayerNetwork)."""

    def __init__(self, conf: MultiLayerConfiguration):
        self.conf = conf
        self.layers: List[Layer] = conf.layers
        self.params: Dict[str, Any] = {}
        self.state: Dict[str, Any] = {}
        self.opt_state: Optional[Dict[str, Any]] = None
        self.listeners: List[Any] = []
        self.iteration = 0
        self.epoch = 0
        self.score_ = float("nan")
        self.device: Optional[torch.device] = None
        #: the recurrent layers' carries that ``rnn_time_step`` resumes
        self._rnn_state: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def _check_supported(self) -> None:
        for i, layer in enumerate(self.layers):
            check_frozen_options(f"layer_{i}", layer)

    def init(self, input_shape: Optional[Tuple[int, ...]] = None,
             device="cuda"):
        """Build the parameters (reference MultiLayerNetwork.init()) on
        ``device``. Shapes come from ``conf.input_type`` unless given
        (no batch dim). Values are drawn on the CPU from a
        ``torch.Generator`` seeded with ``conf.seed``, so every device
        gets the same ones."""
        self._check_supported()
        if input_shape is None:
            if self.conf.input_type is None:
                raise ValueError("init() needs input_shape or "
                                 "conf.input_type")
            input_shape = self.conf.input_type.shape
            if self.conf.input_type.kind == "rnn" and input_shape[0] == -1:
                input_shape = (None,) + input_shape[1:]
        dtype = dtypes.resolve(self.conf.dtype)
        gen = torch.Generator().manual_seed(self.conf.seed)
        self.device = torch.device(device)
        shape = tuple(input_shape)
        self._input_shape = shape
        self._layer_shapes = []
        for i, layer in enumerate(self.layers):
            proc = self.conf.input_preprocessors.get(i)
            if proc is not None:
                shape = proc.output_shape(shape)
            p, s, shape = layer.init(gen, shape, dtype)
            self.params[_lname(i)] = tree.map_(lambda t: t.to(device), p)
            self.state[_lname(i)] = tree.map_(lambda t: t.to(device), s)
            self._layer_shapes.append(shape)
        self._output_shape = shape
        # tied params are NOT master parameters: drop them after init
        # (shape-checked against their source); _forward rebuilds them
        for di, dn, si, sn, tr in self.conf.tied_weights:
            src = self.params[_lname(si)][sn]
            dst = self.params[_lname(di)].pop(dn)
            want = tuple(src.shape[::-1] if tr else src.shape)
            if tuple(dst.shape) != want:
                raise ValueError(
                    f"tie_weights: layer_{di}.{dn} {tuple(dst.shape)} != "
                    f"layer_{si}.{sn}{'(transposed)' if tr else ''} "
                    f"{want}")
        self._build_optimizer()
        return self

    def params_from_jax(self, params_tree):
        """Load a JAX network's weights: ``params_tree`` is the nested
        dict ``jax.tree.map(np.asarray, net.params)`` gives, checked key
        for key and shape for shape against this network's parameters.
        The optimizer state restarts at zero. Returns self."""
        if not self.params:
            raise RuntimeError("call init() before params_from_jax()")
        want = tree.map_(lambda t: tuple(t.shape), self.params)
        self.params = tree.from_numpy(want, params_tree, self.device)
        self._build_optimizer()
        return self

    def state_from_jax(self, state_tree):
        """Load a JAX network's layer state (batch norm's running
        statistics): ``state_tree`` is ``jax.tree.map(np.asarray,
        net.state)``, checked key for key and shape for shape against
        this network's state. Returns self."""
        if not self.params:
            raise RuntimeError("call init() before state_from_jax()")
        want = tree.map_(lambda t: tuple(t.shape), self.state)
        self.state = tree.from_numpy(want, state_tree, self.device)
        return self

    def opt_state_from_jax(self, state_tree):
        """Load a JAX network's optimizer state: ``state_tree`` is what
        ``jax.tree.map(np.asarray, net.opt_state)`` gives — optax's
        per-group ``multi_transform`` state of namedtuples, tuples and
        dicts. Each leaf is mapped by its group, the optax state type
        and field that hold it (:data:`_OPTAX_FIELDS`: a schedule's
        ``ScaleByScheduleState.count`` becomes ``schedule_count``, apart
        from Adam's ``count``) and its parameter keys; the state type
        must be the group's updater's (``Updater.optax_state``; a frozen
        group has no state, as optax's ``set_to_zero``), and each leaf
        is checked for shape against this network's optimizer state.
        Returns self."""
        if self.opt_state is None:
            raise RuntimeError("call init() before opt_state_from_jax()")
        by_key = {}

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            elif isinstance(node, tuple) and hasattr(node, "_fields"):
                for f in node._fields:
                    walk(getattr(node, f),
                         path + ((type(node).__name__, f),))
            elif isinstance(node, (tuple, list)):
                for i, v in enumerate(node):
                    walk(v, path + (i,))
            else:
                add(path, node)

        def add(path, leaf):
            # (..., (multi_transform's state, "inner_states"), group,
            #  ..., (state type, field)[, group], *keys)
            at = next(i for i, p in enumerate(path)
                      if isinstance(p, tuple) and p[1] == "inner_states")
            group = path[at + 1]
            i = max(i for i, p in enumerate(path)
                    if isinstance(p, tuple) and p in _OPTAX_FIELDS)
            rest = path[i + 1:]
            if rest and rest[0] == group:
                rest = rest[1:]
            by_key[(group, path[i][0], _OPTAX_FIELDS[path[i]])
                   + rest] = leaf

        walk(state_tree, ())

        def load(path, t):
            kind = ("ScaleByScheduleState" if path[1] == "schedule_count"
                    else self._chains[path[0]].updater.optax_state)
            key = (path[0], kind) + path[1:]
            if key not in by_key:
                raise ValueError(f"opt_state{list(path)}: not in the JAX "
                                 f"optimizer state (as {kind})")
            a = tree.to_torch(by_key[key])
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"opt_state{list(path)}: shape "
                                 f"{tuple(a.shape)} != {tuple(t.shape)}")
            return a.to(t.device, dtype=t.dtype)

        self.opt_state = tree.map_with_path(load, self.opt_state)
        return self

    def _materialize_ties(self, params):
        """Rebuild tied params from their source inside the forward —
        gradients accumulate onto the source from both uses."""
        if not self.conf.tied_weights:
            return params
        out = dict(params)
        for di, dn, si, sn, tr in self.conf.tied_weights:
            src = out[_lname(si)][sn]
            blk = dict(out.get(_lname(di), {}))
            blk[dn] = src.T if tr else src
            out[_lname(di)] = blk
        return out

    def _group_layers(self) -> Dict[str, Layer]:
        """Parameter group → its layer (``layer_<i>``)."""
        return {_lname(i): layer for i, layer in enumerate(self.layers)}

    def _build_optimizer(self):
        """Each group's chain (:func:`build_chains`) and its fresh
        state."""
        self._chains = build_chains(self.conf, self._group_layers())
        self.opt_state = {name: self._chains[name].init_state(p)
                          for name, p in self.params.items()}

    def _frozen(self):
        """The names of the frozen groups, which take no gradient."""
        return frozenset(n for n, c in self._chains.items() if c.frozen)

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _forward(self, params, state, x, *, train, rng, mask=None,
                 rnn_init=None, pre_output_last: bool = False):
        """Returns (activation, new_state, rnn_states). ``rng``: an integer
        seed (or None), split once per layer. ``rnn_init`` (layer name →
        carries) is each recurrent layer's initial state; ``rnn_states``
        holds their final carries, and the layer state of a recurrent
        layer or of its wrapper stays as it was. Inside a
        sequence-parallel forward (the context's ``layout`` set, see
        :meth:`_layout`) a layer fed the rank's shard takes a seed with
        the rank's index folded in past one rank, and the first layer
        that reduces the sequence clears the layout: the layers after it
        run on the whole [B, …]."""
        if not params:
            raise RuntimeError(
                "Network has no parameters — call init() before "
                "fit()/output() (reference: MultiLayerNetwork.init()).")
        params = self._materialize_ties(params)
        new_state, rnn_states = {}, {}
        n = len(self.layers)
        preprocs = self.conf.input_preprocessors
        shard = _mesh().active_context()
        if shard is not None and shard.layout is None:
            shard = None
        for i, layer in enumerate(self.layers):
            name = _lname(i)
            proc = preprocs.get(i)
            if proc is not None:
                x = proc.pre_process(x)
                mask = proc.propagate_mask(mask)
            sub = None
            if rng is not None:
                rng, sub = split_seed(rng)
                if shard is not None and shard.size > 1:
                    sub = fold_in(sub, shard.index)
            recurrent = isinstance(layer, BaseRecurrentLayer)
            kwargs = ({"initial_state": rnn_init.get(name)}
                      if recurrent and rnn_init else {})
            with obs.devtime.scope(f"{name}.{type(layer).__name__}"):
                if (pre_output_last and i == n - 1
                        and isinstance(layer, OutputLayer)):
                    # pre-activation logits for the fused loss
                    z = (x if isinstance(layer, RnnOutputLayer)
                         else layer.flat_input(x))
                    z = z @ params[name]["W"]
                    if layer.has_bias:
                        z = z + params[name]["b"]
                    x = z
                    new_state[name] = state.get(name, {})
                    continue
                x, s = layer.apply(params.get(name, {}),
                                   state.get(name, {}), x, train=train,
                                   rng=sub, mask=mask, **kwargs)
            if recurrent:
                rnn_states[name] = s
            new_state[name] = (state.get(name, {}) if returns_carries(layer)
                               else s)
            mask = layer.propagate_mask(mask, None)
            if shard is not None and layer.pools_sequence:
                shard.layout = None          # the replicated tail
                shard = None
        return x, new_state, rnn_states

    # ------------------------------------------------------------------
    # loss
    # ------------------------------------------------------------------
    def _last_loss(self):
        last = self.layers[-1]
        loss_name = getattr(last, "loss", None)
        if loss_name is None:
            raise ValueError("last layer has no loss; use an OutputLayer "
                             "variant for fit()")
        act = (last.activation or "identity").lower()
        fused = ((act, loss_name.lower()) in _FUSABLE
                 and isinstance(last, OutputLayer))
        return loss_name, fused

    def _loss_fn(self, params, state, x, y, mask, lmask, rng, *,
                 with_reg=True, count_loss=True, rnn_init=None,
                 rnn_out=None):
        """The training loss at ``params`` (the f32 masters) and the new
        state: weight noise on the forward's view of the masters (from a
        seed split off ``rng``), the compute-dtype cast, the forward, the
        data loss, and the l1/l2 terms over the masters in f32.
        ``with_reg=False`` leaves the l1/l2 terms out and
        ``count_loss=False`` weighs the data loss 0, its backward kept
        (see :meth:`_loss_and_grads`). The recurrent layers start from
        ``rnn_init``, and their final carries go into the dict
        ``rnn_out`` when one is given (truncated BPTT)."""
        loss_name, fused = self._last_loss()
        cd = self.conf.compute_dtype
        groups = self._group_layers()
        master = params
        if has_weight_noise(groups):
            noise_rng, rng = split_seed(rng)
            params = apply_weight_noise(groups, params, noise_rng)
        if cd is not None:
            # bf16 forward/backward, f32 master params: the cast is in
            # the autograd graph, so gradients come back f32
            params = dtypes.cast_float_tree(params, cd)
            x = dtypes.cast_float_tree(x, cd)
        out, new_state, rnn_states = self._forward(
            params, state, x, train=True, rng=rng, mask=mask,
            rnn_init=rnn_init, pre_output_last=fused)
        if rnn_out is not None:
            rnn_out.update(rnn_states)
        loss_fn = losses_mod.get(loss_name)
        with obs.devtime.scope(f"loss.{loss_name}"):
            if cd is not None and losses_mod.wants_f32_logits(loss_fn,
                                                              fused):
                out = out.float()
            kw = {"from_logits": True} if fused else {}
            loss = loss_fn(y, out, mask=lmask, **kw)
            if not count_loss:
                loss = loss * 0.0
            reg = reg_score(groups, master) if with_reg else 0.0
            if torch.is_tensor(reg):
                loss = loss + reg
        return loss, new_state

    def _loss_and_grads(self, x, y, mask=None, lmask=None, rng=None,
                        **rnn):
        """(loss, gradient tree, new state) at the current parameters;
        the gradients have the master parameters' dtype. Under a
        sequence-parallel context ``x``, ``y`` and the masks are the
        global batch: the rank's tokens are taken here (of the labels
        only when the output keeps its time axis), and the loss and
        gradients come back summed over the group. Past one rank, the
        rank's index is folded into the dropout seeds of the layers
        before the reduction (:meth:`_forward`), so that no two shards
        draw the same dropout masks; the weight noise's seed is split
        off the unfolded seed, so that every shard of the sequence runs
        through the same perturbed weights; and the l1/l2 terms, and the
        data loss of a replicated tail, count on the first rank only, so
        that the sum holds them once, as the global loss does. ``rnn``
        (``rnn_init``, ``rnn_out``) goes to :meth:`_loss_fn`."""
        sp = self._seq_parallel()
        tail = sp is not None and self._pooled_at() is not None
        x, mask = self._shard(sp, x, mask)
        if not tail:
            y, lmask = self._shard(sp, y, lmask)
        kw = dict(rnn)
        if sp is not None and sp[0].size > 1:
            kw["with_reg"] = sp[0].index == 0
            kw["count_loss"] = not tail or sp[0].index == 0
        with self._layout(sp):
            loss, grads, state = loss_and_grads(
                lambda p: self._loss_fn(p, self.state, x, y, mask, lmask,
                                        rng, **kw), self.params,
                self._frozen())
        if sp is not None and sp[0].size > 1:
            loss, grads = _sum_over(sp[0].group, loss, grads)
        return loss, grads, state

    # ------------------------------------------------------------------
    # sequence parallelism
    # ------------------------------------------------------------------
    def _seq_parallel(self):
        """``(context, mode)`` when this network runs sequence-parallel:
        a ``distributed_context`` is active and its layers carry a
        ``sequence_parallel`` mode. None otherwise (the context does not
        touch a network without one). Raises when the layers disagree on
        the mode, or hold a layer that cannot run where it sits
        (:func:`_check_seq_layer`: before the first layer that reduces
        the sequence, on the rank's shard; after it, in the replicated
        tail), or an input preprocessor on the rank's shard, which would
        reshape it as if it were the whole sequence."""
        ctx = _mesh().active_context()
        if ctx is None:
            return None
        modes = {layer.sequence_parallel for layer in self.layers
                 if hasattr(layer, "sequence_parallel")}
        if modes <= {None}:
            return None
        if len(modes) > 1:
            raise ValueError(
                f"the network's attention layers disagree on "
                f"sequence_parallel ({sorted(map(str, modes))}): under a "
                "sequence-parallel context every one takes the same mode")
        mode = modes.pop()
        if mode not in _mesh().SP_MODES:
            raise ValueError(f"unknown sequence_parallel mode {mode!r} "
                             "(ring|ulysses|zigzag_ring)")
        pooled = self._pooled_at()
        for i, layer in enumerate(self.layers):
            sharded = pooled is None or i <= pooled
            proc = self.conf.input_preprocessors.get(i)
            if sharded and proc is not None:
                from deeplearning4j_tpu_torch.nn.vertices import SEQ_ITEM
                raise NotImplementedError(
                    f"layer_{i}'s input preprocessor "
                    f"({type(proc).__name__}) would reshape the rank's "
                    "shard of the sequence under a sequence-parallel "
                    f"context: it comes there with {SEQ_ITEM}")
            _check_seq_layer(f"layer_{i}", layer, sharded)
        return ctx, mode

    def _pooled_at(self) -> Optional[int]:
        """The index of the first layer that reduces the sequence
        (``Layer.pools_sequence``), after which a sequence-parallel
        network's activations are the replicated tail; None when the
        output keeps its time axis."""
        return next((i for i, layer in enumerate(self.layers)
                     if layer.pools_sequence), None)

    @staticmethod
    def _shard(sp, *arrays):
        """This rank's tokens (axis 1) of each global array (None stays
        None) under ``sp = (context, mode)``; the arrays as they are
        when ``sp`` is None."""
        if sp is None:
            return arrays
        ctx, mode = sp
        return tuple(None if a is None else _mesh().shard_sequence(
            a, mode, ctx.size, ctx.index) for a in arrays)

    @staticmethod
    @contextlib.contextmanager
    def _layout(sp):
        """Under ``sp = (context, mode)``, the context's ``layout`` set
        to ``mode`` around a forward (``PositionalEmbeddingLayer`` and
        the layers that reduce the sequence read it; the forward clears
        it for the replicated tail), and restored after; nothing when
        ``sp`` is None."""
        if sp is None:
            yield
            return
        ctx, mode = sp
        prev, ctx.layout = ctx.layout, mode
        try:
            yield
        finally:
            ctx.layout = prev

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------
    def _update(self, x, y, mask, lmask, rng, **rnn):
        """One gradient + optimizer update; returns the loss (on the
        device). ``rnn`` as :meth:`_loss_and_grads` takes it."""
        loss, grads, new_state = self._loss_and_grads(x, y, mask, lmask,
                                                      rng, **rnn)
        self.params, self.opt_state = apply_updates(
            self._chains, self.params, grads, self.opt_state)
        self.state = new_state
        return loss

    def _as_input(self, a, dtype=None):
        if a is None:
            return None
        t = (a if isinstance(a, torch.Tensor)
             else torch.as_tensor(np.asarray(a)))
        return t.to(self.device, dtype=dtype)

    def fit(self, features, labels=None, *, epochs: int = 1,
            features_mask=None, labels_mask=None, steps_per_loop: int = 1):
        """fit(x, y) for one batch, or fit(iterator, epochs=N).

        Iterator elements: DataSet-like (``.features``/``.labels``/
        ``.features_mask``/``.labels_mask``) or (x, y) tuples.
        ``steps_per_loop`` > 1 groups mask-free batches of one shape into
        K-step regions (:meth:`_fit_group`), the JAX package's rule
        (``deeplearning4j_tpu/nn/multilayer.py:575-593``): a batch with
        masks, or a truncated-BPTT batch, runs alone and flushes the
        group, a change of shape flushes it, and a group of one runs as
        a single batch. The numbers equal those of one ``fit`` a
        batch."""
        if steps_per_loop < 1:
            raise ValueError(f"steps_per_loop={steps_per_loop} < 1")
        if labels is not None:
            self._fit_batch(features, labels, features_mask, labels_mask)
            return self
        if hasattr(features, "features") and not hasattr(features,
                                                         "__iter__"):
            ds = features
            self._fit_batch(ds.features, ds.labels,
                            getattr(ds, "features_mask", None),
                            getattr(ds, "labels_mask", None))
            return self
        for _ in range(epochs):
            for listener in self.listeners:
                listener.on_epoch_start(self)
            if hasattr(features, "reset"):
                features.reset()
            group: list = []
            src = iter(features)
            while True:
                te0 = obs.now()     # iterator wait = ETL attribution
                try:
                    ds = next(src)
                except StopIteration:
                    break
                te1 = obs.now()
                obs.record_etl("MultiLayerNetwork.fit", te0, te1)
                if hasattr(ds, "features"):
                    x, y = ds.features, ds.labels
                    fm = getattr(ds, "features_mask", None)
                    lm = getattr(ds, "labels_mask", None)
                else:
                    x, y = ds
                    fm = lm = None
                tbptt = (self.conf.backprop_type == "TruncatedBPTT"
                         and np.ndim(x) == 3)
                if (steps_per_loop > 1 and fm is None and lm is None
                        and not tbptt):
                    if group and (np.shape(group[-1][0]) != np.shape(x)
                                  or np.shape(group[-1][1]) != np.shape(y)):
                        self._flush_group(group)
                    group.append((x, y))
                    if len(group) == steps_per_loop:
                        self._flush_group(group)
                else:
                    self._flush_group(group)
                    # the step's span starts at the batch's arrival
                    self._fit_batch(x, y, fm, lm, _t0=te1)
            self._flush_group(group)
            for listener in self.listeners:
                listener.on_epoch_end(self)
            self.epoch += 1
        return self

    def _flush_group(self, group):
        if not group:
            return
        if len(group) == 1:
            self._fit_batch(*group[0])
        else:
            self._fit_group(list(group))
        group.clear()

    def _fit_group(self, group):
        """One K-step region over the K (x, y) batches of ``group``: the
        port's counterpart of the JAX package's scanned device loop.
        The fault site fires first (a fire changes nothing); each array
        of the group is stacked on the host and moved to the device in
        one copy; the K updates then run in turn, update ``i`` with the
        dropout seed of iteration ``iteration + i`` and its loss written
        into a [K] tensor on the device, with no read-back between them;
        the K losses come to the host in one copy at the end, and the
        listeners then see the K steps one by one (:func:`notify_steps`)."""
        t0 = obs.now()
        faults.inject("step")       # site: step dispatch (resilience/)
        xs = stage([x for x, _ in group], self.device)
        ys = stage([y for _, y in group], self.device)
        t1 = obs.now()
        losses = torch.empty(len(group), dtype=torch.float32,
                             device=self.device)
        with obs.devtime.scope(REGION_SCOPE.format("MultiLayerNetwork")):
            for i in range(len(group)):
                rng = fold_in(self.conf.seed, self.iteration + i)
                losses[i] = self._update(xs[i], ys[i], None, None, rng)
        t2 = obs.now()
        host = losses.cpu()         # the group's one device sync
        t3 = obs.now()
        notify_steps(self, "MultiLayerNetwork.fit", host.tolist())
        obs.record_step("MultiLayerNetwork.fit", t0, t1, t2, t3,
                        args={"steps": len(group)}, turn=True)

    def _fit_batch(self, x, y, fmask=None, lmask=None, _t0=None):
        t0 = obs.now() if _t0 is None else _t0
        faults.inject("step")       # site: step dispatch (resilience/)
        x, y = self._as_input(x), self._as_input(y)
        fmask = self._as_input(fmask, torch.float32)
        lmask = self._as_input(lmask, torch.float32)
        rng = fold_in(self.conf.seed, self.iteration)
        t1 = obs.now()
        if self.conf.backprop_type == "TruncatedBPTT" and x.ndim == 3:
            loss = self._fit_tbptt(x, y, fmask, lmask, rng)
            entry = "MultiLayerNetwork.fit_tbptt"
        else:
            loss = self._update(x, y, fmask, lmask, rng)
            entry = "MultiLayerNetwork.fit"
        t2 = obs.now()
        score = float(loss)         # blocking device sync
        t3 = obs.now()
        notify_steps(self, "MultiLayerNetwork.fit", [score])
        obs.record_step(entry, t0, t1, t2, t3, turn=True)

    def _fit_tbptt(self, x, y, fmask, lmask, rng):
        """One truncated-BPTT batch (the JAX ``_fit_tbptt``): an update a
        segment of ``tbptt_fwd_length`` steps, each segment's recurrent
        layers starting from the previous one's final carries, detached,
        and every segment with the batch's seed ``rng``. Returns the last
        segment's loss, on the device: no segment reads back."""
        k = self.conf.tbptt_fwd_length
        rnn, loss = None, None
        for s0 in range(0, x.shape[1], k):
            cut = lambda a: None if a is None else a[:, s0:s0 + k]
            out = {}
            loss = self._update(cut(x), cut(y) if y.ndim == 3 else y,
                                cut(fmask), cut(lmask), rng, rnn_init=rnn,
                                rnn_out=out)
            rnn = {name: tree.map_(torch.Tensor.detach, carries)
                   for name, carries in out.items()}
        return loss

    # ------------------------------------------------------------------
    # inference and scoring
    # ------------------------------------------------------------------
    @torch.no_grad()
    def output(self, x, train: bool = False, mask=None):
        """Reference: MultiLayerNetwork.output. Returns a tensor on the
        network's device (f32 under ``compute_dtype``)."""
        cd = self.conf.compute_dtype
        params, state = self.params, self.state
        x = self._as_input(x)
        mask = self._as_input(mask, torch.float32)
        sp = self._seq_parallel()
        x, mask = self._shard(sp, x, mask)
        if cd is not None:
            params = dtypes.cast_float_tree(params, cd)
            state = dtypes.cast_float_tree(state, cd)
            x = dtypes.cast_float_tree(x, cd)
        with self._layout(sp):
            out, _, _ = self._forward(params, state, x, train=train,
                                      rng=None, mask=mask)
        if (sp is not None and sp[0].size > 1
                and self._pooled_at() is None):
            ctx, mode = sp
            out = _mesh().unshard_sequence(
                _mesh().all_gather(out, ctx.group), mode)
        return out.float() if cd is not None else out

    @torch.no_grad()
    def score(self, dataset=None) -> float:
        """The last training loss, or the loss on ``dataset`` (an object
        with ``features``/``labels`` and optional masks)."""
        if dataset is None:
            return self.score_
        loss_name, fused = self._last_loss()
        x = self._as_input(dataset.features)
        y = self._as_input(dataset.labels)
        fmask = self._as_input(getattr(dataset, "features_mask", None),
                               torch.float32)
        lmask = self._as_input(getattr(dataset, "labels_mask", None),
                               torch.float32)
        sp = self._seq_parallel()
        tail = sp is not None and self._pooled_at() is not None
        x, fmask = self._shard(sp, x, fmask)
        if not tail:
            y, lmask = self._shard(sp, y, lmask)
        with self._layout(sp):
            out, _, _ = self._forward(self.params, self.state, x,
                                      train=False, rng=None, mask=fmask,
                                      pre_output_last=fused)
        kw = {"from_logits": True} if fused else {}
        loss = losses_mod.get(loss_name)(y, out, mask=lmask, **kw)
        # a replicated tail's loss is already the global one on every rank
        if sp is not None and sp[0].size > 1 and not tail:
            loss = _mesh().all_reduce_sum(loss.reshape(1).contiguous(),
                                           sp[0].group)
        return float(loss)

    def rnn_clear_previous_state(self):
        """Forget the carries of :meth:`rnn_time_step` (reference
        rnnClearPreviousState)."""
        self._rnn_state = None

    @torch.no_grad()
    def rnn_time_step(self, x, mask=None):
        """Stateful inference (reference rnnTimeStep): the forward over
        ``x`` ([B, F] for one step, or [B, T, F]) from the recurrent
        layers' carries the previous call left, which it then replaces.
        A [B, F] input gives the last step's [B, C] output. Runs on the
        masters' dtype (no ``compute_dtype`` cast), as the JAX network
        does."""
        x = self._as_input(x)
        squeeze = x.ndim == 2
        if squeeze:
            x = x[:, None, :]
        out, _, self._rnn_state = self._forward(
            self.params, self.state, x, train=False, rng=None,
            mask=self._as_input(mask, torch.float32),
            rnn_init=self._rnn_state)
        if squeeze and out.ndim == 3:
            out = out[:, -1]
        return out

    def evaluate(self, iterator) -> Evaluation:
        """Classification evaluation over ``iterator`` (reference
        MultiLayerNetwork.evaluate(DataSetIterator) → Evaluation)."""
        return evaluate_batches(self, iterator, Evaluation())[0]

    def evaluate_regression(self, iterator) -> RegressionEvaluation:
        """Regression evaluation over ``iterator`` (reference
        MultiLayerNetwork.evaluateRegression)."""
        return evaluate_batches(self, iterator, RegressionEvaluation())[0]

    def num_params(self) -> int:
        return sum(math.prod(t.shape) for t in tree.leaves(self.params))

    def set_listeners(self, *listeners):
        """Replace the training listeners (reference setListeners)."""
        self.listeners = list(listeners)
        return self

    def add_listeners(self, *listeners):
        self.listeners.extend(listeners)
        return self

    def _activations(self, x, start: int, stop: int, train: bool):
        """The activations of layers ``start`` .. ``stop - 1`` fed ``x``
        at ``start``, each preprocessor applied before its layer."""
        params = self._materialize_ties(self.params)
        for i in range(start, stop):
            proc = self.conf.input_preprocessors.get(i)
            if proc is not None:
                x = proc.pre_process(x)
            x, _ = self.layers[i].apply(params.get(_lname(i), {}),
                                        self.state.get(_lname(i), {}), x,
                                        train=train, rng=None)
            yield x

    @torch.no_grad()
    def feed_forward(self, x, train: bool = False):
        """Every layer's activation (reference feedForward): a list, the
        input first."""
        x = self._as_input(x)
        return [x, *self._activations(x, 0, len(self.layers), train)]

    @torch.no_grad()
    def activate_selected_layers(self, from_: int, to: int, x):
        """The activation of layer ``to`` fed ``x`` at layer ``from_``
        (reference activateSelectedLayers)."""
        *_, out = self._activations(self._as_input(x), from_, to + 1,
                                    False)
        return out
