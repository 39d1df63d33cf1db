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
rebinds its donated arrays.

Not in this slice (each raises ``NotImplementedError`` naming the later
slice): truncated BPTT, input preprocessors, listeners, l1/l2 and
per-layer weight decay, per-layer updaters or learning rates, frozen
layers, constraints, weight noise, the numerics observatory. A
``steps_per_loop`` group runs its steps one after another (the JAX
package scans them in one program; the results are the same); a CUDA
graph over the group is later work.

Under a ``parallel.distributed_context`` a network whose layers carry a
``sequence_parallel`` mode trains and infers sequence-parallel, by the
per-process rule of ``parallel/mesh.py``: every rank is given the same
global batch and keeps its own tokens of the inputs, labels and masks;
its loss over them is its share of the global loss, and the loss and
the gradients are summed over the ``seq`` group before the update;
``output`` gathers the shards back. Layers that mix positions
(``Layer.mixes_positions``) other than the sequence-parallel attention
are refused under the context (:func:`_check_seq_layer`). Past one rank
each rank draws its own shard's dropout masks, so the masks are not
those of a one-card run (nor the JAX package's, whose generator
differs). A network without such a mode ignores the context, as the
JAX network does.
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
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    BaseRecurrentLayer, RnnOutputLayer)
from deeplearning4j_tpu_torch.ops import losses as losses_mod

# losses that support the fused from_logits path, keyed by activation
_FUSABLE = {
    ("softmax", "mcxent"), ("softmax", "negativeloglikelihood"),
    ("softmax", "sparse_mcxent"), ("sigmoid", "xent"),
    ("sigmoid", "binary_xent"),
}

#: per-layer options of the JAX network this slice does not carry
_UNPORTED_LAYER_OPTIONS = (
    ("l1", "l1 regularisation"), ("l2", "l2 regularisation"),
    ("weight_decay", "per-layer weight decay"),
    ("updater", "a per-layer updater"),
    ("learning_rate", "a per-layer learning rate"),
    ("constraints", "parameter constraints"),
    ("weight_noise", "weight noise"))


def _lname(i: int) -> str:
    return f"layer_{i}"


def _mesh():
    """``parallel/mesh.py`` (imported at the call: ``parallel`` imports
    this module)."""
    from deeplearning4j_tpu_torch.parallel import mesh
    return mesh


def _check_seq_layer(i: int, layer: Layer) -> None:
    """Raise ``NotImplementedError`` unless ``layer`` runs on the rank's
    shard of the sequence: it has a ``sequence_parallel`` mode, or it
    does not mix positions (``Layer.mixes_positions``)."""
    why = layer.mixes_positions
    if why and not hasattr(layer, "sequence_parallel"):
        raise NotImplementedError(
            f"layer_{i} ({type(layer).__name__}) mixes positions, so it "
            "cannot run on a rank's shard of the sequence under a "
            "sequence-parallel context"
            + (f": it comes there with {why}" if isinstance(why, str)
               else ""))


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


def loss_and_grads(loss_fn, params):
    """``(loss, gradients, aux)`` of ``loss_fn(params) -> (loss, aux)``
    at ``params`` (a nested dict of tensors): the loss detached and a
    gradient tree of the parameters' structure and dtype (zeros for a
    parameter the loss does not reach). The training step of both
    ``MultiLayerNetwork`` and ``ComputationGraph``."""
    work = tree.map_(lambda t: t.detach().requires_grad_(True), params)
    loss, aux = loss_fn(work)
    leaves = list(tree.leaves(work))
    flat = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, flat))
    grads = tree.map_(lambda _: next(it), work)
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


def apply_updates(updater, grad_norm, params, grads, opt_state):
    """One optax-style update of every top-level group of ``params`` (a
    layer, or a graph node) with its own gradient normalisation and
    updater state, as the JAX networks' per-layer ``multi_transform``
    does. Returns ``(new params, new optimizer state)``: new tensors,
    the old trees untouched."""
    with torch.no_grad(), obs.devtime.scope("optimizer.update"):
        new_params, new_opt = {}, {}
        for name, p in params.items():
            u, new_opt[name] = updater.update(grad_norm(grads[name]),
                                              opt_state[name], p)
            new_params[name] = tree.map_(lambda a, d: (a + d).to(a.dtype),
                                         p, u)
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

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def _check_supported(self) -> None:
        conf = self.conf
        if conf.backprop_type != "Standard":
            raise NotImplementedError(
                f"backprop_type={conf.backprop_type!r}: truncated BPTT "
                "comes with the recurrent slice")
        if conf.input_preprocessors:
            raise NotImplementedError(
                "input preprocessors come with the MultiLayerNetwork-"
                "core slice")
        for i, layer in enumerate(self.layers):
            for attr, what in _UNPORTED_LAYER_OPTIONS:
                if getattr(layer, attr, None):
                    raise NotImplementedError(
                        f"layer_{i} ({type(layer).__name__}): {what} "
                        f"({attr}) comes with the MultiLayerNetwork-core "
                        "slice")
            if not layer.trainable:
                raise NotImplementedError(
                    f"layer_{i}: frozen layers come with the "
                    "MultiLayerNetwork-core slice")

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
            p, s, shape = layer.init(gen, shape, dtype)
            self.params[_lname(i)] = tree.map_(lambda t: t.to(device), p)
            self.state[_lname(i)] = s
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

    def opt_state_from_jax(self, state_tree):
        """Load a JAX network's optimizer state: ``state_tree`` is what
        ``jax.tree.map(np.asarray, net.opt_state)`` gives — optax's
        per-group ``multi_transform`` state of namedtuples, tuples and
        dicts, whose Adam-family leaves are each group's ``count``,
        ``mu`` and ``nu``. Each leaf of this network's optimizer state is
        found there by its group, its field and its parameter keys, and
        checked for shape. Returns self."""
        if self.opt_state is None:
            raise RuntimeError("call init() before opt_state_from_jax()")
        found = {}

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            elif isinstance(node, tuple) and hasattr(node, "_fields"):
                for f in node._fields:
                    walk(getattr(node, f), path + (f,))
            elif isinstance(node, (tuple, list)):
                for i, v in enumerate(node):
                    walk(v, path + (i,))
            else:
                found[path] = node

        walk(state_tree, ())
        by_key = {}
        for path, leaf in found.items():
            # (..., "inner_states", group, ..., field[, group, *keys])
            group = path[path.index("inner_states") + 1]
            at = next(i for i, p in enumerate(path)
                      if isinstance(p, str) and p in ("count", "mu", "nu"))
            rest = path[at + 1:]
            if rest and rest[0] == group:
                rest = rest[1:]
            by_key[(group, path[at]) + rest] = leaf

        def load(path, t):
            if path not in by_key:
                raise ValueError(f"opt_state{list(path)}: not in the JAX "
                                 "optimizer state")
            a = tree.to_torch(by_key[path])
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

    def _build_optimizer(self):
        self._grad_norm = upd.gradient_normalization(
            self.conf.gradient_normalization,
            self.conf.gradient_normalization_threshold)
        self.opt_state = {name: self.conf.updater.init_state(p)
                          for name, p in self.params.items()}

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _forward(self, params, state, x, *, train, rng, mask=None,
                 pre_output_last: bool = False):
        """Returns (activation, new_state). ``rng``: an integer seed (or
        None), split once per layer."""
        if not params:
            raise RuntimeError(
                "Network has no parameters — call init() before "
                "fit()/output() (reference: MultiLayerNetwork.init()).")
        params = self._materialize_ties(params)
        new_state = {}
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            name = _lname(i)
            sub = None
            if rng is not None:
                rng, sub = split_seed(rng)
            with obs.devtime.scope(f"{name}.{type(layer).__name__}"):
                if (pre_output_last and i == n - 1
                        and isinstance(layer, OutputLayer)):
                    # pre-activation logits for the fused loss
                    z = (x.reshape(x.shape[0], -1)
                         if not isinstance(layer, RnnOutputLayer)
                         and x.ndim > 2 else x)
                    z = z @ params[name]["W"]
                    if layer.has_bias:
                        z = z + params[name]["b"]
                    x = z
                    new_state[name] = state.get(name, {})
                    continue
                x, s = layer.apply(params.get(name, {}),
                                   state.get(name, {}), x, train=train,
                                   rng=sub, mask=mask)
            new_state[name] = (state.get(name, {})
                               if isinstance(layer, BaseRecurrentLayer)
                               else s)
            mask = layer.propagate_mask(mask, None)
        return x, new_state

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

    def _loss_fn(self, params, state, x, y, mask, lmask, rng):
        loss_name, fused = self._last_loss()
        cd = self.conf.compute_dtype
        if cd is not None:
            # bf16 forward/backward, f32 master params: the cast is in
            # the autograd graph, so gradients come back f32
            params = dtypes.cast_float_tree(params, cd)
            x = dtypes.cast_float_tree(x, cd)
        out, new_state = self._forward(params, state, x, train=True,
                                       rng=rng, mask=mask,
                                       pre_output_last=fused)
        loss_fn = losses_mod.get(loss_name)
        with obs.devtime.scope(f"loss.{loss_name}"):
            if cd is not None and losses_mod.wants_f32_logits(loss_fn,
                                                              fused):
                out = out.float()
            kw = {"from_logits": True} if fused else {}
            loss = loss_fn(y, out, mask=lmask, **kw)
        return loss, new_state

    def _loss_and_grads(self, x, y, mask=None, lmask=None, rng=None):
        """(loss, gradient tree, new state) at the current parameters;
        the gradients have the master parameters' dtype. Under a
        sequence-parallel context ``x``, ``y`` and the masks are the
        global batch: the rank's tokens are taken here (and, past one rank,
        its index folded into ``rng``, so that no two shards draw the
        same dropout masks), and the loss and gradients come back summed
        over the group."""
        sp = self._seq_parallel()
        x, y, mask, lmask = self._shard(sp, x, y, mask, lmask)
        if sp is not None and sp[0].size > 1 and rng is not None:
            # each rank draws the dropout masks of its own shard
            rng = fold_in(rng, sp[0].index)
        with self._layout(sp):
            loss, grads, state = loss_and_grads(
                lambda p: self._loss_fn(p, self.state, x, y, mask, lmask,
                                        rng), self.params)
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
        the mode, or hold a layer that cannot run on a shard."""
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
        for i, layer in enumerate(self.layers):
            _check_seq_layer(i, layer)
        return ctx, mode

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
        to ``mode`` around a forward (``PositionalEmbeddingLayer`` reads
        it); nothing when ``sp`` is None."""
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
    def _update(self, x, y, mask, lmask, rng):
        """One gradient + optimizer update; returns the loss (on the
        device)."""
        loss, grads, new_state = self._loss_and_grads(x, y, mask, lmask,
                                                      rng)
        self.params, self.opt_state = apply_updates(
            self.conf.updater, self._grad_norm, self.params, grads,
            self.opt_state)
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
        ``steps_per_loop`` groups batches for the JAX package's scanned
        device loop; here the group's steps run one after another, with
        the same results."""
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
            if hasattr(features, "reset"):
                features.reset()
            for ds in features:
                if hasattr(ds, "features"):
                    self._fit_batch(ds.features, ds.labels,
                                    getattr(ds, "features_mask", None),
                                    getattr(ds, "labels_mask", None))
                else:
                    x, y = ds
                    self._fit_batch(x, y)
            self.epoch += 1
        return self

    def _fit_batch(self, x, y, fmask=None, lmask=None):
        if self.listeners:
            raise NotImplementedError(
                "training listeners come with the MultiLayerNetwork-core "
                "slice")
        t0 = obs.now()
        x, y = self._as_input(x), self._as_input(y)
        fmask = self._as_input(fmask, torch.float32)
        lmask = self._as_input(lmask, torch.float32)
        rng = fold_in(self.conf.seed, self.iteration)
        t1 = obs.now()
        loss = self._update(x, y, fmask, lmask, rng)
        t2 = obs.now()
        self.score_ = float(loss)   # blocking device sync
        obs.record_step("MultiLayerNetwork.fit", t0, t1, t2, obs.now())
        self.iteration += 1

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
            out, _ = self._forward(params, state, x, train=train, rng=None,
                                   mask=mask)
        if sp is not None and sp[0].size > 1:
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
        x, y, fmask, lmask = self._shard(sp, x, y, fmask, lmask)
        with self._layout(sp):
            out, _ = self._forward(self.params, self.state, x, train=False,
                                   rng=None, mask=fmask,
                                   pre_output_last=fused)
        kw = {"from_logits": True} if fused else {}
        loss = losses_mod.get(loss_name)(y, out, mask=lmask, **kw)
        if sp is not None and sp[0].size > 1:
            loss = _mesh().all_reduce_sum(loss.reshape(1).contiguous(),
                                           sp[0].group)
        return float(loss)

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
        if listeners:
            raise NotImplementedError(
                "training listeners come with the MultiLayerNetwork-core "
                "slice")
        self.listeners = []
        return self
