"""ParallelWrapper — data-parallel training over a process group (port
of ``deeplearning4j_tpu/parallel/wrapper.py``).

Reference: ``org.deeplearning4j.parallelism.ParallelWrapper`` (+Builder,
SURVEY §3.5): per-GPU replicas exchanging averaged params or
threshold-encoded gradients.

The JAX package runs one SPMD step over a device mesh in one process;
the port runs one process per replica (``torch.distributed``), each
holding its replica in ``net.params``, and composes every mode's step
from the networks' shared ``loss_and_grads`` and ``apply_updates``
(``nn/multilayer.py``), as the JAX step variants compose
``_local_grads``/``_apply_update``:

 - SYNC (default): this rank's batch, then the gradient mean over the
   ``data`` group;
 - SYNC with ``sharded_update=True`` (ZeRO, arXiv 2004.13336,
   ``parallel/zero.py``): the gradient mean becomes one flat
   ``reduce_scatter`` per leaf, the rank updates its 1/N slice of the
   flat parameters against optimizer state that lives as 1/N shards
   (born from the net's own ``opt_state``, whose whole copy then moves
   to host memory), and one ``all_gather`` per leaf rebuilds
   ``net.params``. With ``gather_overlap=True`` the rank carries its
   parameter shards between steps and gathers them at the top of the
   next step, where the JAX program lets XLA overlap the gather with the
   forward; eager PyTorch issues the same gathers at the same place, and
   ``net.params`` is refreshed when ``fit`` returns (or raises);
 - ENCODED: per-rank gradients through
   ``EncodedGradientsAccumulator.exchange`` (residuals and τ stay on the
   rank), the decoded mean applied;
 - AVERAGING: independent replicas, float params (and, with
   ``average_updaters``, the optimizer moments) averaged every
   ``averaging_frequency`` iterations;
 - ASYNC: each replica applies its own encoded update at once and its
   peers' one step late (``exchange_async``).

The JAX steps donate their carried state (``donate_argnums``) so that
XLA reuses the buffers in place; PyTorch has no counterpart, and each
step's update allocates new tensors, the old ones freed as their last
reference goes.

A ``MultiLayerNetwork`` takes ``(x, y)``; a ``ComputationGraph`` takes
its features as one array, a list or tuple in input order, or a dict by
input name, and its labels as a list in output order (the JAX package's
loss adapter). That adapter passes no masks, so a batch that carries
features or labels masks would train unmasked there: the port raises
``NotImplementedError`` for one instead, for both network types.

``fit`` takes THIS rank's batches, the JAX package's multi-process rule
(``wrapper.py`` ``_fit_epochs``): a global source is dealt out by
``ShardedDataSetIterator``. Over more than one rank, ``fit`` first
agrees the per-epoch step count and the batch size as minima over the
group, so that every rank runs the same collectives. The reported loss
is the mean over ranks. Past one rank, each rank folds its ``data``
index into the step's seed, so that the ranks draw their own dropout
masks for their own rows, as the JAX SYNC step's one global program
draws one mask over the global batch (the JAX ``shard_map`` modes pass
every device the same key; the port does not copy that). At one rank
SYNC's gradient mean is the rank's own gradient: no collective runs for
it. The first step
broadcasts rank 0's params and optimizer state, the counterpart of JAX's
replicated placement. After AVERAGING and ASYNC, ``fit`` folds the
replicas back (``_sync_back``).

**Layer state** (batch norm's running statistics) follows the JAX
steps mode by mode. Under SYNC the JAX step is one ``jit`` over the
global batch, so a training layer's batch statistics cover every row of
it: here each rank's ``_local_grads`` runs under
``mesh.batch_statistics`` over the ``data`` group, the statistics are
summed over the ranks by the differentiable ``mesh.reduce_sum`` (the
identity at one rank), and every rank computes the same new state. The
other modes — ENCODED, AVERAGING, ASYNC and SYNC with
``sharded_update`` — are ``shard_map`` programs in the JAX package: each
device computes its new state from its own shard, and the step returns
it under ``out_specs=P()`` unchecked (``check_vma=False``), so each
device carries its own chain of states and ``net.state`` reads device
0's (measured on 2 CPU devices: the two chains differ, ``np.asarray``
gives the first device's). Training reads only the batch's statistics,
so device 0's chain depends on its own shards alone: here each rank
computes its state from its own rows, then takes rank 0's by a
broadcast, so every rank ends each step with the state the JAX
``net.state`` shows. No statistics are reduced in those modes. The
replicas of AVERAGING and ASYNC carry (params, optimizer state, layer
state), and ``_sync_back`` folds the state back with them.

Every mode updates each parameter group by the network's own chain
(``net._chains``: a frozen group not at all, and its gradient is never
computed), and runs the layers' constraints after the update; under
``sharded_update`` the constraints run on the gathered params, and
``gather_overlap``, which has no gathered tree after the update, is
refused for a network with constraints, as in the JAX wrapper
(``deeplearning4j_tpu/parallel/wrapper.py:256-309``). Weight noise
draws from the step's seed, into which each rank past one has folded
its index, as dropout does.

**Entry point** (``perf/sentry.py``): a rank's step runs through one
entry point named as the JAX wrapper's step of its mode
(``ParallelWrapper.sync_step``, ``.sync_sharded_step``,
``.sync_sharded_overlap_step``, ``.encoded_step``, ``.async_step``,
``.averaging_step``), whose traces are counted as the JAX jitted step's
and whose batch shapes :meth:`ParallelWrapper.warmup` declares ahead.
The steps run collectives over the process group, which this slice does
not capture: they stay eager on the card (``ROADMAP.md`` A17).

Not in this slice (each raises ``NotImplementedError`` naming its
slice): the numerics diagnostic steps, ``elastic`` and checkpoints.
"""
from __future__ import annotations

import logging
import weakref
from typing import Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch import obs, tree
from deeplearning4j_tpu_torch.data.dataset import has_masks
from deeplearning4j_tpu_torch.data.iterators import AsyncDataSetIterator
from deeplearning4j_tpu_torch.nn.layers.base import fold_in
from deeplearning4j_tpu_torch.nn.multilayer import (apply_constraints,
                                                    apply_updates,
                                                    loss_and_grads,
                                                    notify_steps)
from deeplearning4j_tpu_torch.parallel.compression import \
    EncodedGradientsAccumulator
from deeplearning4j_tpu_torch.parallel.mesh import (Mesh, all_gather_,
                                                    all_reduce_sum,
                                                    batch_statistics,
                                                    broadcast_,
                                                    data_parallel_mesh,
                                                    mean_over)
from deeplearning4j_tpu_torch.parallel.zero import (FlatShardLayout,
                                                    per_device_bytes)
from deeplearning4j_tpu_torch.perf import sentry
from deeplearning4j_tpu_torch.perf.sentry import ShapeDtype
from deeplearning4j_tpu_torch.resilience import faults

_LOG = logging.getLogger("deeplearning4j_tpu_torch")

#: gradient-normalisation modes that reduce ACROSS a layer or a tree:
#: on 1/N parameter shards the shard-local norm is not the layer's, so
#: ``sharded_update`` refuses them
_CROSS_LEAF_GRAD_NORMS = frozenset({
    "clipl2perlayer", "clipl2perparamtype",
    "renormalizel2perlayer", "renormalizel2perparamtype"})


def _later(what: str, slice_: str):
    raise NotImplementedError(f"ParallelWrapper: {what} comes with the "
                              f"{slice_} slice")


def _first_leaf(x):
    """The first array of a batch's features or labels: the array
    itself, the first of a list or tuple, or the first value of a
    dict."""
    if isinstance(x, dict):
        return next(iter(x.values()))
    if isinstance(x, (list, tuple)):
        return x[0]
    return x


def _map_batch(fn, x):
    """``fn`` over every array of a batch's features or labels, keeping
    the container (list, tuple, dict or one array)."""
    if isinstance(x, dict):
        return {k: fn(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(fn(a) for a in x)
    return fn(x)


class ParallelWrapper:
    SYNC = "sync"
    ENCODED = "encoded"
    AVERAGING = "averaging"
    ASYNC = "async"

    def __init__(self, net, workers: Optional[int] = None,
                 mode: str = SYNC,
                 averaging_frequency: int = 5,
                 average_updaters: bool = True,
                 accumulator: Optional[EncodedGradientsAccumulator] = None,
                 mesh: Optional[Mesh] = None,
                 prefetch_buffer: int = 4,
                 sharded_update: bool = False,
                 gather_overlap: bool = False):
        if mode not in (self.SYNC, self.ENCODED, self.AVERAGING,
                        self.ASYNC):
            raise ValueError(f"unknown mode {mode!r}")
        if sharded_update and mode != self.SYNC:
            raise ValueError(
                "sharded_update is a SYNC-mode optimization (the ZeRO "
                f"weight-update sharding); mode {mode!r} carries "
                "per-replica state that is already not replicated")
        if gather_overlap and not sharded_update:
            raise ValueError("gather_overlap rides the ZeRO sharded "
                             "update — set sharded_update=True")
        self.net = net
        self.mesh = mesh or data_parallel_mesh(workers)
        if self.mesh.axis_names != ("data",):
            raise ValueError(f"ParallelWrapper runs over one 'data' axis, "
                             f"got {self.mesh}")
        self.group = self.mesh.group("data")
        self.n = self.mesh.size("data")
        self.index = self.mesh.index("data")
        self.mode = mode
        self.averaging_frequency = averaging_frequency
        # reference ParallelWrapper.Builder#averageUpdaters (default
        # true): AVERAGING mode averages the optimizer moments along
        # with the params at every averaging round
        self.average_updaters = average_updaters
        self.accumulator = accumulator or (
            EncodedGradientsAccumulator()
            if mode in (self.ENCODED, self.ASYNC) else None)
        #: batches drawn ahead of the step by an AsyncDataSetIterator
        #: around the fit's iterator (0: each batch read when its step
        #: runs), as the JAX wrapper does
        self.prefetch_buffer = prefetch_buffer
        self.sharded_update = bool(sharded_update)
        self.gather_overlap = bool(gather_overlap)
        # plain SYNC is one JAX program over the global batch: its layers'
        # batch statistics cover every rank's rows; every other mode is a
        # shard_map step, whose layer state is rank 0's own
        self._global_stats = mode == self.SYNC and not self.sharded_update
        self._acc_state = None      # this rank's accumulator state
        self._rep = None            # AVERAGING/ASYNC: (params, opt
        #                             state, layer state)
        self._placed = False        # rank 0's replica broadcast yet?
        # ZeRO: the layout, this rank's 1/N optimizer state, and (overlap)
        # its carried 1/N param shards with the leaves they came from
        self._shard_layout = None
        self._dp_state = None
        self._evicted_opt = None    # the whole opt state, in host memory
        self._pshard = None
        self._pshard_src = None
        self._params_stale = False
        # MultiLayerNetwork takes (x, y); ComputationGraph takes
        # ({name: x}, [y]): adapt here so every mode's step stays
        # network-agnostic (the JAX wrapper's loss adapter, which passes
        # no masks)
        if hasattr(net.conf, "inputs"):
            ins = net.conf.inputs

            def _graph_loss(p, s, x, y, rng):
                xd = x if isinstance(x, dict) else (
                    dict(zip(ins, x)) if isinstance(x, (list, tuple))
                    else {ins[0]: x})
                yl = list(y) if isinstance(y, (list, tuple)) else [y]
                return net._loss_fn(p, s, xd, yl, {}, {}, rng)

            self._loss = _graph_loss
        else:
            self._loss = lambda p, s, x, y, rng: net._loss_fn(
                p, s, x, y, None, None, rng)
        #: ``resilience.elastic.ElasticContext`` in the JAX package; set,
        #: ``fit`` raises (the resilience slice)
        self.elastic = None

    # -- builder parity (reference ParallelWrapper.Builder) -------------
    class Builder:
        def __init__(self, net):
            self._kw = {"net": net}

        def workers(self, n):
            self._kw["workers"] = n
            return self

        def training_mode(self, mode):
            self._kw["mode"] = mode
            return self

        def averaging_frequency(self, k):
            self._kw["averaging_frequency"] = k
            return self

        def average_updaters(self, flag: bool):
            self._kw["average_updaters"] = flag
            return self

        def sharded_update(self, flag: bool = True):
            self._kw["sharded_update"] = flag
            return self

        def gather_overlap(self, flag: bool = True):
            self._kw["gather_overlap"] = flag
            return self

        def gradients_accumulator(self, acc):
            self._kw["accumulator"] = acc
            # an accumulator implies an encoded-family mode; a prior
            # explicit ASYNC choice is kept, anything else becomes
            # ENCODED — reference Builder behavior
            if self._kw.get("mode") not in (ParallelWrapper.ENCODED,
                                            ParallelWrapper.ASYNC):
                self._kw["mode"] = ParallelWrapper.ENCODED
            return self

        def prefetch_buffer(self, k):
            self._kw["prefetch_buffer"] = k
            return self

        def build(self):
            return ParallelWrapper(**self._kw)

    @staticmethod
    def builder(net) -> "ParallelWrapper.Builder":
        return ParallelWrapper.Builder(net)

    # -- the step's entry point (perf/sentry.py) -------------------------
    def _step_name(self) -> str:
        """The JAX wrapper's name for this mode's step."""
        if self.mode == self.SYNC:
            if not self.sharded_update:
                return "ParallelWrapper.sync_step"
            return ("ParallelWrapper.sync_sharded_overlap_step"
                    if self.gather_overlap
                    else "ParallelWrapper.sync_sharded_step")
        return f"ParallelWrapper.{self.mode}_step"

    _step_fn = None

    def _step_program(self) -> sentry.SentryJit:
        if self._step_fn is None:
            self._step_fn = sentry.jit(
                lambda x, y, rng: self._step(x, y, rng),
                name=self._step_name())
        return self._step_fn

    def warmup(self, specs):
        """Declare this mode's step for every batch shape of ``specs``
        (``perf.warmup.WarmupSpec``) before the first batch: each is a
        planned signature, and the first live step on it adds no trace.
        Spec features and labels carry the GLOBAL batch dim, as the JAX
        wrapper's do; a rank's step takes its 1/n of the rows (``fit``'s
        per-rank batches). The step's collectives stay eager in this
        slice, so there is no graph to capture, and warmup runs nothing:
        it changes no state. Returns ``{"compiled": n, "seconds": t}``."""
        from deeplearning4j_tpu_torch.perf.warmup import (_feature_sds,
                                                          _label_sds)
        net = self.net
        graph = hasattr(net.conf, "inputs")
        rng = fold_in(net.conf.seed, 0)
        if self.n > 1:
            rng = fold_in(rng, self.index)
        rows = lambda s: ShapeDtype((s.shape[0] // self.n,)
                                    + tuple(s.shape[1:]), s.dtype, s.device)
        local = lambda t: (rows(t) if isinstance(t, ShapeDtype)
                           else [rows(a) for a in t])
        step = self._step_program()
        compiled, seconds = 0, 0.0
        for spec in specs:
            if not spec.train:
                continue
            x = _feature_sds(spec, net.conf, net.device)
            y = _label_sds(spec, net.conf, net.device)
            if graph:
                x = list(x.values())
            dt = step.warmup(local(x), local(y), rng)
            compiled += dt > 0
            seconds += dt
        return {"compiled": compiled, "seconds": seconds}

    # -- not in this slice ---------------------------------------------

    def checkpoint_tree(self):
        _later("checkpoint_tree (sharded checkpoints)", "resilience")

    def checkpoint_target(self):
        _later("checkpoint_target (sharded checkpoints)", "resilience")

    def load_checkpoint_tree(self, tree_):
        _later("load_checkpoint_tree (sharded checkpoints)", "resilience")

    def load_gathered_tree(self, tree_, src_layout: str = "zero-flat"):
        _later("load_gathered_tree (sharded checkpoints)", "resilience")

    # -- shared step pieces (every mode composes these) ----------------
    def _local_grads(self, params, state, x, y, rng):
        """(loss, gradients, new layer state) of this rank's rows from
        ``params`` and layer ``state``; a frozen group's gradients are
        zeros, never computed. Under plain SYNC the training layers'
        batch statistics cover the rows of the whole ``data`` group (the
        JAX SYNC step's one program over the global batch); under every
        other mode, a ``shard_map`` step in the JAX package, this rank's
        rows alone."""
        with batch_statistics(self.group if self._global_stats else None):
            return loss_and_grads(
                lambda p: self._loss(p, state, x, y, rng), params,
                self.net._frozen())

    def _shared_state(self, state):
        """The layer state every rank ends a step with: ``state`` itself
        under plain SYNC (its statistics already cover the group) and at
        one rank; else rank 0's, broadcast over the group — the state the
        JAX ``shard_map`` step's unchecked ``P()`` output shows. The
        leaves go as one flat buffer a dtype (ResNet-50: 106 running
        statistics in one broadcast)."""
        if self.n == 1 or self._global_stats:
            return state
        leaves = list(tree.leaves(state))
        out = [None] * len(leaves)
        by_dtype = {}
        for i, t in enumerate(leaves):
            by_dtype.setdefault(t.dtype, []).append(i)
        with torch.no_grad():
            for idx in by_dtype.values():
                flat = broadcast_(torch.cat(
                    [leaves[i].reshape(-1) for i in idx]), 0, self.group)
                pieces = flat.split([leaves[i].numel() for i in idx])
                for i, piece in zip(idx, pieces):
                    out[i] = piece.view_as(leaves[i])
        it = iter(out)
        return tree.map_(lambda _: next(it), state)

    def _apply_update(self, params, opt_state, grads, constrain=True):
        """One optimizer application by the network's per-group chains,
        then (``constrain``) the layers' constraints: (new params, new
        optimizer state). On flat shards the per-layer groups and every
        leaf's key are the tree's own, so the updater's per-key rules
        hold; constraints reduce over a whole leaf, so the sharded step
        passes ``constrain=False`` and runs them on the gathered
        params."""
        return apply_updates(self.net._chains, params, grads, opt_state,
                             constrain)

    def _replica(self):
        """(params, optimizer state, layer state) this rank trains: the
        net's own under SYNC and ENCODED, where every rank holds the same;
        under AVERAGING and ASYNC the replica carried from fit to fit
        (JAX's per-device ``_dp_state``, with the carried layer state),
        which ``_sync_back`` folds into the net."""
        if self._rep is not None:
            return self._rep
        return self.net.params, self.net.opt_state, self.net.state

    def _exchanged_grads(self, x, y, rng):
        """(loss, the gradient this mode applies, new layer state): the
        local gradients, then SYNC's mean over the group, ENCODED's
        ``exchange`` or ASYNC's ``exchange_async`` (the accumulator state
        advances); AVERAGING's stay local."""
        params, _, state = self._replica()
        loss, grads, new_state = self._local_grads(params, state, x, y, rng)
        if self.mode == self.AVERAGING or (self.mode == self.SYNC
                                           and self.n == 1):
            # AVERAGING's gradients stay local; SYNC's mean over a group
            # of one is the rank's own
            return loss, grads, new_state
        # a convolution's kernel gradient comes back in the permuted
        # (channels-last) layout: the collectives, and the exchanges'
        # codes and residuals, take dense tensors
        grads = tree.map_(torch.Tensor.contiguous, grads)
        if self.mode == self.SYNC:
            # the autograd gradients are fresh tensors, summed in place
            grads = tree.map_(
                lambda g: all_reduce_sum(g, self.group) / self.n, grads)
        elif self.mode == self.ENCODED:
            grads, self._acc_state = self.accumulator.exchange(
                grads, self._acc_state, self.group)
        elif self.mode == self.ASYNC:
            grads, self._acc_state = self.accumulator.exchange_async(
                grads, self._acc_state, self.group)
        return loss, grads, new_state

    def _mean_floats(self, t):
        # optimizer state holds non-float leaves too (step counts);
        # those are replica-identical — average only the float ones
        return mean_over(t, self.group) if t.is_floating_point() else t

    def _step(self, x, y, rng):
        """One training step of this rank; returns the loss's mean over
        the group (on the device)."""
        if self.sharded_update:
            return self._sharded_step(x, y, rng)
        net = self.net
        loss, grads, new_state = self._exchanged_grads(x, y, rng)
        net.state = self._shared_state(new_state)
        params, opt_state = self._apply_update(*self._replica()[:2], grads)
        k = self.averaging_frequency
        if self.mode == self.AVERAGING and net.iteration % k == k - 1:
            # every k-th iteration: replica averaging (reference
            # ParameterAveraging; averageUpdaters also averages the
            # optimizer moments)
            params = tree.map_(self._mean_floats, params)
            if self.average_updaters:
                opt_state = tree.map_(self._mean_floats, opt_state)
        if self._rep is not None:
            self._rep = (params, opt_state, net.state)
        else:
            net.params, net.opt_state = params, opt_state
        return mean_over(loss, self.group)

    # -- the ZeRO sharded update ---------------------------------------
    def _layout(self) -> FlatShardLayout:
        if self._shard_layout is None:
            self._shard_layout = FlatShardLayout(self.net.params, self.n)
        return self._shard_layout

    def _sharded_step(self, x, y, rng):
        """The ZeRO SYNC step (arXiv 2004.13336): local gradients, their
        mean reduce-scattered a flat leaf at a time, this rank's 1/N
        slice of the flat params updated against its 1/N optimizer
        state, and the params all-gathered into ``net.params`` (end
        gather). With ``gather_overlap`` the step starts from the carried
        shards, gathers them first and ends with the updated shards:
        the same math, the gather moved across the step boundary."""
        net = self.net
        layout = self._layout()
        if self.gather_overlap:
            pshard = self._pshard
            params = layout.gather(pshard, self.group)
        else:
            params = net.params
            pshard = layout.shard(layout.flatten(params), self.index)
        loss, grads, new_state = self._local_grads(params, net.state, x, y,
                                                   rng)
        net.state = self._shared_state(new_state)
        # the whole gathered params and gradients go before the update
        # allocates its new shards and moments
        del params
        gshard = layout.scatter_mean(grads, self.group)
        del grads
        pshard, self._dp_state = self._apply_update(
            pshard, self._dp_state, gshard, constrain=False)
        if self.gather_overlap:
            self._pshard = pshard
            self._params_stale = True
        else:
            net.params = apply_constraints(net._chains,
                                           layout.gather(pshard, self.group))
        return mean_over(loss, self.group)

    def _check_sharded_update_supported(self):
        gn = getattr(self.net.conf, "gradient_normalization", None)
        if gn and str(gn).lower() in _CROSS_LEAF_GRAD_NORMS:
            raise ValueError(
                f"sharded_update applies the optimizer to 1/{self.n} "
                f"parameter shards; gradient normalization {gn!r} "
                "reduces across a whole layer/tree and would see only "
                "the local shard — use sharded_update=False, or "
                "elementwise clipping (ClipElementWiseAbsoluteValue)")
        if self.gather_overlap and any(
                layer.constraints
                for layer in self.net._group_layers().values()):
            raise ValueError(
                "gather_overlap defers the post-update param gather "
                "to the NEXT step's forward, so per-layer constraints "
                "(full-tree reductions after the update) have no "
                "gathered tree to run on — use gather_overlap=False "
                "with constrained layers")

    def _init_sharded_opt(self):
        """This rank's optimizer state as 1/N shards of the flat layout,
        taken from the net's current ``opt_state`` (fresh, or carried
        across from a resumed run, so a resume keeps its moments): each
        moment leaf flattened, zero-padded and sliced to the rank's
        block, each scalar (the step count) kept. The structure is that
        of the updater's own state over the shards."""
        net = self.net
        layout = self._layout()
        pshard = layout.shard(layout.flatten(net.params), self.index)
        ref = {name: net._chains[name].init_state(p)
               for name, p in pshard.items()}
        src = list(tree.leaves(net.opt_state))
        want = list(tree.leaves(ref))
        if len(src) != len(want):
            raise ValueError(
                "net.opt_state does not match the optimizer layout "
                f"({len(src)} leaves vs {len(want)}) — was the updater "
                "reconfigured after restore?")
        out = []
        for cur, w in zip(src, want):
            cur = cur.to(w.device)
            if w.ndim == 0:
                out.append(cur.to(w.dtype).clone())
                continue
            flat = cur.reshape(-1)
            pad = w.numel() * self.n - flat.numel()
            if pad:
                flat = torch.nn.functional.pad(flat, (0, pad))
            # a copy of the rank's block: the whole moments can go
            out.append(flat.narrow(0, self.index * w.numel(), w.numel())
                       .to(w.dtype).clone())
        it = iter(out)
        return tree.map_(lambda _: next(it), ref)

    def _ensure_sharded_state(self):
        """Build the rank's 1/N optimizer shards when missing, from the
        net's current ``opt_state``, whose whole copy then moves to host
        memory so the device holds only the shards (past one rank, 1/N of
        the moments); under ``gather_overlap`` also the carried param
        shards."""
        if self._dp_state is None:
            net = self.net
            self._dp_state = self._init_sharded_opt()
            net.opt_state = tree.map_(lambda t: t.cpu(), net.opt_state)
            self._evicted_opt = net.opt_state
            # ModelSerializer folds the live shards into a zip while this
            # wrapper owns the optimizer state (the identity check)
            net._zero_wrapper = weakref.ref(self)
        if self.gather_overlap and self._pshard is None:
            self._pshard = self._init_param_shards()
            self._params_stale = False

    def _init_param_shards(self):
        """The net's CURRENT params as this rank's flat 1/N shards, the
        carried state of the overlap step; the leaves they came from are
        recorded (:meth:`_params_current_in_shards`)."""
        layout = self._layout()
        self._pshard_src = [weakref.ref(t)
                            for t in tree.leaves(self.net.params)]
        return layout.shard(layout.flatten(self.net.params), self.index)

    def _params_current_in_shards(self) -> bool:
        """Do the carried shards derive from the net's CURRENT param
        leaves? Assigning ``net.params`` (loaded weights, transfer
        learning) replaces the leaf tensors and breaks the identity, so
        the next fit re-derives the shards; an untouched tree keeps
        them."""
        src = self._pshard_src
        if src is None:
            return False
        leaves = list(tree.leaves(self.net.params))
        return (len(src) == len(leaves)
                and all(w() is t for w, t in zip(src, leaves)))

    def _materialize_params(self):
        """Gather the carried param shards back into ``net.params``
        (overlap mode; a no-op while the params are current). A
        collective: every rank of the group calls it."""
        if not self._params_stale:
            return
        self.net.params = self._layout().gather(self._pshard, self.group)
        self._pshard_src = [weakref.ref(t)
                            for t in tree.leaves(self.net.params)]
        self._params_stale = False

    def gather_opt_state(self):
        """The sharded optimizer state gathered into the whole layout of
        ``net.opt_state``, on the device (a collective: every rank calls
        it). For export and inspection only: it rebuilds the N copies the
        sharded update exists to avoid. Without the sharded update (or
        before its first step) the net's own ``opt_state``."""
        if not self.sharded_update or self._dp_state is None:
            return self.net.opt_state
        ref = list(tree.leaves(self._evicted_opt))
        out = []
        for cur, want in zip(tree.leaves(self._dp_state), ref):
            if want.ndim == 0:
                out.append(cur)
                continue
            full = torch.empty(cur.numel() * self.n, dtype=cur.dtype,
                               device=cur.device)
            all_gather_(full, cur, self.group)
            out.append(full[:want.numel()].reshape(want.shape))
        it = iter(out)
        return tree.map_(lambda _: next(it), self._evicted_opt)

    def _export_opt_state_bytes(self):
        """Publish this rank's optimizer-state bytes for the active
        layout (``OPT_STATE_BYTES``, the number the sharded update
        divides by N)."""
        if self.sharded_update:
            layout, nbytes = "sharded", per_device_bytes(self._dp_state)
        else:
            layout, nbytes = "replicated", per_device_bytes(
                self._replica()[1])
        obs.metrics.OPT_STATE_BYTES.labels(layout=layout).set(nbytes)

    # ------------------------------------------------------------------
    def _place(self):
        """First step: every rank takes rank 0's params, optimizer state
        and layer state (JAX's replicated placement, in place); the
        replicas of AVERAGING and ASYNC start from them, and so do the
        accumulator state and, under the sharded update, the rank's
        shards."""
        net = self.net
        if self.sharded_update:
            self._check_sharded_update_supported()
        with torch.no_grad():
            for t in (*tree.leaves(net.params), *tree.leaves(net.opt_state),
                      *tree.leaves(net.state)):
                broadcast_(t, 0, self.group)
        if self.mode in (self.AVERAGING, self.ASYNC):
            self._rep = (net.params, net.opt_state, net.state)
        if self.mode == self.ENCODED:
            self._acc_state = self.accumulator.init_state(net.params)
        elif self.mode == self.ASYNC:
            self._acc_state = self.accumulator.init_async_state(net.params)
        if self.sharded_update:
            self._ensure_sharded_state()
        self._export_opt_state_bytes()
        self._placed = True

    def _check_fit(self):
        if self.elastic is not None:
            _later("an elastic context", "resilience")
        if getattr(self.net, "_numerics", None) is not None:
            _later("the numerics observatory's diagnostic steps",
                   "observatories")

    def _agree(self, iterator):
        """(steps per epoch, batch size) agreed over the group: the
        minimum of every rank's ``len(iterator)`` and of the size of its
        first batch (its first feature array's rows; the JAX
        ``_fit_epochs``'s multi-process rule, one ``all_reduce(MIN)`` on
        the CPU side of the group)."""
        try:
            n_local = len(iterator)
        except TypeError:
            raise ValueError(
                "multi-rank ParallelWrapper.fit needs a sized iterator "
                "(len()) so all ranks can agree on the step count") \
                from None
        first = next(iter(iterator), None)
        b_local = (0 if first is None else
                   _first_leaf(first.features if hasattr(first, "features")
                               else first[0]).shape[0])
        mins = torch.tensor([n_local, b_local], dtype=torch.int64)
        dist.all_reduce(mins, op=dist.ReduceOp.MIN, group=self.group)
        n_steps, b = (int(v) for v in mins)
        if b == 0 and n_steps > 0:
            raise ValueError("a rank's first batch is empty: the ranks "
                             "cannot agree on a batch size")
        return n_steps, b

    def fit(self, iterator, epochs: int = 1):
        """Reference: ParallelWrapper.fit(DataSetIterator). The iterator
        yields this rank's batches (DataSet- or MultiDataSet-like
        elements, or ``(x, y)`` tuples; ``ShardedDataSetIterator`` deals
        a global source out over the ranks); a batch with masks raises
        ``NotImplementedError``. At world size 1 every batch trains
        whole. Over more ranks, before the first step the ranks agree the
        per-epoch step count (the iterator must be sized; else
        ``ValueError``) and the batch size, each as the minimum over the
        group (of ``len(iterator)`` and of the first batch's size); every
        array of a batch is cut to the agreed size, a smaller batch
        raises ``ValueError``, and every rank stops an epoch at the
        agreed count, so their collectives stay in step. With a
        ``prefetch_buffer`` the batches are drawn ahead by an
        ``AsyncDataSetIterator``; after each step the net's listeners get
        ``iteration_done``, as in the JAX wrapper. Under
        ``gather_overlap`` ``net.params`` is gathered from the shards on
        the way out, also when a step raises. Returns the net."""
        try:
            return self._fit_epochs(iterator, epochs)
        finally:
            if self._params_stale:
                try:
                    self._materialize_params()
                except Exception:
                    _LOG.warning(
                        "gather_overlap: could not materialize net.params "
                        "after an interrupted fit — the live weights "
                        "remain in the carried shards")

    def _fit_epochs(self, iterator, epochs: int):
        net = self.net
        self._check_fit()
        if not self._placed:
            self._place()
        elif (self.gather_overlap and not self._params_stale
              and not self._params_current_in_shards()):
            # net.params was assigned between fits: the overlap step
            # trains from them
            self._pshard = self._init_param_shards()
        n_steps, b = (None, None) if self.n == 1 else self._agree(iterator)
        it = (AsyncDataSetIterator(iterator, self.prefetch_buffer)
              if self.prefetch_buffer else iterator)
        # the liveness key: a heartbeat a step (obs.health), retired
        # when fit ends normally
        worker = f"proc{dist.get_rank() if dist.is_initialized() else 0}"
        for _ in range(epochs):
            if hasattr(it, "reset"):
                it.reset()
            i = 0
            src = iter(it)
            while True:
                te0 = obs.now()     # iterator wait = ETL attribution
                try:
                    ds = next(src)
                except StopIteration:
                    break
                obs.record_etl("ParallelWrapper.fit", te0, obs.now())
                faults.inject("worker_step")  # site: worker loop body
                if n_steps is not None and i >= n_steps:
                    break                # stay in lockstep with the group
                i += 1
                t0 = obs.now()
                if has_masks(ds):
                    raise NotImplementedError(
                        "ParallelWrapper.fit: a batch with features or "
                        "labels masks — the JAX wrapper's loss adapter "
                        "passes no masks (deeplearning4j_tpu/parallel/"
                        "wrapper.py:163-164), so it would train the batch "
                        "unmasked; the port refuses it until that gap of "
                        "the reference is decided (ROADMAP.md C)")
                x, y = ((ds.features, ds.labels) if hasattr(ds, "features")
                        else ds)
                rows = _first_leaf(x).shape[0]
                if b is None and rows == 0:
                    _LOG.warning("ParallelWrapper: dropping an empty batch")
                    continue
                if b is not None:
                    if rows < b:
                        raise ValueError(
                            f"batch of {rows} smaller than the agreed "
                            f"per-rank size {b}: multi-rank training "
                            "needs uniform batches (drop or pad the "
                            "ragged remainder)")
                    x, y = (_map_batch(lambda a: a[:b], t) for t in (x, y))
                x, y = (_map_batch(net._as_input, t) for t in (x, y))
                rng = fold_in(net.conf.seed, net.iteration)
                if self.n > 1:
                    # each rank draws the dropout masks of its own rows
                    rng = fold_in(rng, self.index)
                t1 = obs.now()
                loss = self._step_program()(x, y, rng)
                t2 = obs.now()
                score = float(loss)          # blocking device sync
                obs.record_worker_step(worker, t0, t1, t2, obs.now())
                notify_steps(net, "ParallelWrapper.fit", [score])
            net.epoch += 1
        # normal completion: retire the liveness beat, so a finished fit
        # does not read as a stale worker (a crashed loop keeps it)
        obs.health.retire(worker)
        if self._rep is not None:
            self._sync_back()
        return net

    def _sync_back(self):
        """After averaging/async-mode training, fold the replicas into
        every rank's net (reference: ParallelWrapper final params copy):
        the params' mean; the optimizer moments' mean under AVERAGING
        with ``average_updaters``, else rank 0's optimizer state; the
        layer state the replicas carry, every rank's rank 0's already
        (:meth:`_shared_state`). The replicas themselves train on at the
        next ``fit``."""
        net = self.net
        params, opt_state, net.state = self._rep
        net.params = tree.map_(lambda t: mean_over(t, self.group), params)
        if self.mode == self.AVERAGING and self.average_updaters:
            net.opt_state = tree.map_(self._mean_floats, opt_state)
        else:
            net.opt_state = tree.map_(
                lambda t: broadcast_(t.clone(), 0, self.group), opt_state)
