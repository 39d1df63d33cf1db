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

 - SYNC (default): this rank's rows of the batch, then the gradient mean
   over the ``data`` group;
 - ENCODED: per-rank gradients through
   ``EncodedGradientsAccumulator.exchange`` (residuals and τ stay on the
   rank), the decoded mean applied;
 - AVERAGING: independent replicas, float params (and, with
   ``average_updaters``, the optimizer moments) averaged every
   ``averaging_frequency`` iterations;
 - ASYNC: each replica applies its own encoded update at once and its
   peers' one step late (``exchange_async``).

``fit`` takes the GLOBAL batch on every rank, as the JAX wrapper does in
one process: rank r keeps rows ``[r·B/n, (r+1)·B/n)`` (the rows
``P("data")`` gives device r) and the reported loss is the mean over
ranks. The first step broadcasts rank 0's params and optimizer state, the
counterpart of JAX's replicated placement. After AVERAGING and ASYNC,
``fit`` folds the replicas back (``_sync_back``).

Not in this slice (each raises ``NotImplementedError`` naming its
slice): ``sharded_update``/``gather_overlap`` (ZeRO), the numerics
diagnostic steps, ``elastic``, checkpoints, ``warmup`` and a
``ComputationGraph`` under the wrapper.
"""
from __future__ import annotations

import logging
from typing import Optional

import torch

from deeplearning4j_tpu_torch import obs, tree
from deeplearning4j_tpu_torch.nn.layers.base import fold_in
from deeplearning4j_tpu_torch.nn.multilayer import (apply_updates,
                                                    loss_and_grads)
from deeplearning4j_tpu_torch.parallel.compression import \
    EncodedGradientsAccumulator
from deeplearning4j_tpu_torch.parallel.mesh import (Mesh, all_reduce_sum,
                                                    broadcast_,
                                                    data_parallel_mesh,
                                                    mean_over)

_LOG = logging.getLogger("deeplearning4j_tpu_torch")


def _later(what: str, slice_: str):
    raise NotImplementedError(f"ParallelWrapper: {what} comes with the "
                              f"{slice_} slice")


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
        if sharded_update or gather_overlap:
            _later("the ZeRO sharded update (sharded_update, "
                   "gather_overlap)", "ZeRO")
        if hasattr(net.conf, "inputs"):
            _later("a ComputationGraph", "ComputationGraph-under-the-"
                   "wrapper")
        if mode not in (self.SYNC, self.ENCODED, self.AVERAGING,
                        self.ASYNC):
            raise ValueError(f"unknown mode {mode!r}")
        self.net = net
        self.mesh = mesh or data_parallel_mesh(workers)
        if self.mesh.axis_names != ("data",):
            raise ValueError(f"ParallelWrapper runs over one 'data' axis, "
                             f"got {self.mesh}")
        self.group = self.mesh.group("data")
        self.n = self.mesh.size("data")
        self.rank = self.mesh.index("data")
        self.mode = mode
        self.averaging_frequency = averaging_frequency
        # reference ParallelWrapper.Builder#averageUpdaters (default
        # true): AVERAGING mode averages the optimizer moments along
        # with the params at every averaging round
        self.average_updaters = average_updaters
        self.accumulator = accumulator or (
            EncodedGradientsAccumulator()
            if mode in (self.ENCODED, self.ASYNC) else None)
        #: kept for the API: the port reads each batch when its step
        #: runs (the data iterators' prefetch comes with the data slice)
        self.prefetch_buffer = prefetch_buffer
        self._acc_state = None      # this rank's accumulator state
        self._rep = None            # AVERAGING/ASYNC: (params, opt state)
        self._placed = False        # rank 0's replica broadcast yet?
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

    # -- not in this slice ---------------------------------------------
    def warmup(self, specs):
        _later("warmup (ahead-of-time compiled steps)", "compile-lifecycle")

    def gather_opt_state(self):
        _later("gather_opt_state (ZeRO optimizer shards)", "ZeRO")

    def checkpoint_tree(self):
        _later("checkpoint_tree (sharded checkpoints)", "resilience")

    def checkpoint_target(self):
        _later("checkpoint_target (sharded checkpoints)", "resilience")

    def load_checkpoint_tree(self, tree_):
        _later("load_checkpoint_tree (sharded checkpoints)", "resilience")

    def load_gathered_tree(self, tree_, src_layout: str = "zero-flat"):
        _later("load_gathered_tree (sharded checkpoints)", "resilience")

    # -- shared step pieces (every mode composes these) ----------------
    def _local_grads(self, params, x, y, rng):
        """(loss, gradients, new layer state) of this rank's rows."""
        net = self.net
        return loss_and_grads(
            lambda p: net._loss_fn(p, net.state, x, y, None, None, rng),
            params)

    def _apply_update(self, params, opt_state, grads):
        """One optimizer application: (new params, new optimizer
        state)."""
        net = self.net
        return apply_updates(net.conf.updater, net._grad_norm, params,
                             grads, opt_state)

    def _replica(self):
        """(params, optimizer state) this rank trains: the net's own under
        SYNC and ENCODED, where every rank holds the same; under
        AVERAGING and ASYNC the replica carried from fit to fit (JAX's
        per-device ``_dp_state``), which ``_sync_back`` folds into the
        net."""
        if self._rep is not None:
            return self._rep
        return self.net.params, self.net.opt_state

    def _exchanged_grads(self, x, y, rng):
        """(loss, the gradient this mode applies, new layer state): the
        local gradients, then SYNC's mean over the group, ENCODED's
        ``exchange`` or ASYNC's ``exchange_async`` (the accumulator state
        advances); AVERAGING's stay local."""
        loss, grads, new_state = self._local_grads(self._replica()[0], x,
                                                   y, rng)
        if self.mode == self.SYNC:
            # the autograd gradients are fresh tensors: summed in place
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
        net = self.net
        loss, grads, net.state = self._exchanged_grads(x, y, rng)
        params, opt_state = self._apply_update(*self._replica(), grads)
        k = self.averaging_frequency
        if self.mode == self.AVERAGING and net.iteration % k == k - 1:
            # every k-th iteration: replica averaging (reference
            # ParameterAveraging; averageUpdaters also averages the
            # optimizer moments)
            params = tree.map_(self._mean_floats, params)
            if self.average_updaters:
                opt_state = tree.map_(self._mean_floats, opt_state)
        if self._rep is not None:
            self._rep = (params, opt_state)
        else:
            net.params, net.opt_state = params, opt_state
        return mean_over(loss, self.group)

    # ------------------------------------------------------------------
    def _place(self):
        """First step: every rank takes rank 0's params and optimizer
        state (JAX's replicated placement, in place), the replicas of
        AVERAGING and ASYNC start from them, and so does the accumulator
        state."""
        net = self.net
        with torch.no_grad():
            for t in (*tree.leaves(net.params), *tree.leaves(net.opt_state)):
                broadcast_(t, 0, self.group)
        if self.mode in (self.AVERAGING, self.ASYNC):
            self._rep = (net.params, net.opt_state)
        if self.mode == self.ENCODED:
            self._acc_state = self.accumulator.init_state(net.params)
        elif self.mode == self.ASYNC:
            self._acc_state = self.accumulator.init_async_state(net.params)
        self._placed = True

    def _check_fit(self):
        if self.elastic is not None:
            _later("an elastic context", "resilience")
        if getattr(self.net, "_numerics", None) is not None:
            _later("the numerics observatory's diagnostic steps",
                   "observatories")

    def fit(self, iterator, epochs: int = 1):
        """Reference: ParallelWrapper.fit(DataSetIterator). Every rank
        iterates the same global batches (DataSet-like elements or
        ``(x, y)`` tuples); a batch is trimmed to a multiple of the rank
        count and each rank trains on its rows. Returns the net."""
        net = self.net
        self._check_fit()
        if not self._placed:
            self._place()
        for _ in range(epochs):
            if hasattr(iterator, "reset"):
                iterator.reset()
            for ds in iterator:
                t0 = obs.now()
                x, y = ((ds.features, ds.labels) if hasattr(ds, "features")
                        else ds)
                bsz = x.shape[0]
                b = bsz - bsz % self.n
                if b == 0:
                    _LOG.warning(
                        "ParallelWrapper: dropping batch of %d examples "
                        "(< %d workers); use batch sizes divisible by "
                        "the worker count", bsz, self.n)
                    continue
                # this rank's rows: block r of the b rows, as P("data")
                lo, hi = (self.rank * b // self.n,
                          (self.rank + 1) * b // self.n)
                x, y = net._as_input(x[lo:hi]), net._as_input(y[lo:hi])
                rng = fold_in(net.conf.seed, net.iteration)
                t1 = obs.now()
                loss = self._step(x, y, rng)
                t2 = obs.now()
                net.score_ = float(loss)     # blocking device sync
                obs.record_step("ParallelWrapper.fit", t0, t1, t2,
                                obs.now())
                net.iteration += 1
            net.epoch += 1
        if self._rep is not None:
            self._sync_back()
        return net

    def _sync_back(self):
        """After averaging/async-mode training, fold the replicas into
        every rank's net (reference: ParallelWrapper final params copy):
        the params' mean; the optimizer moments' mean under AVERAGING
        with ``average_updaters``, else rank 0's optimizer state. The
        replicas themselves train on at the next ``fit``."""
        net = self.net
        params, opt_state = self._rep
        net.params = tree.map_(lambda t: mean_over(t, self.group), params)
        if self.mode == self.AVERAGING and self.average_updaters:
            net.opt_state = tree.map_(self._mean_floats, opt_state)
        else:
            net.opt_state = tree.map_(
                lambda t: broadcast_(t.clone(), 0, self.group), opt_state)
