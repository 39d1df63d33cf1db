"""ZeRO-style sharded weight update — flat shard layout and accounting
(port of ``deeplearning4j_tpu/parallel/zero.py``).

Reference: "Automatic Cross-Replica Sharding of Weight Update in
Data-Parallel Training" (arXiv 2004.13336). The replicated data-parallel
step all-reduces the gradients and has every replica redo the same
optimizer math over the whole parameter set, holding N copies of the
moments. The sharded update reduce-scatters the gradients (each rank
receives the mean of its 1/N slice), applies the optimizer to that slice
against moments that live as 1/N shards, and all-gathers the updated
parameters for the next forward. The wire volume is that of the
all-reduce it replaces; the optimizer state and the update's work drop
by N.

The per-process form (one process per card, ``parallel/mesh.py``):
:class:`FlatShardLayout` views every parameter leaf as a flat vector,
zero-padded to a multiple of the rank count so that
``reduce_scatter``/``all_gather`` tile it evenly; ``scatter_mean`` and
``gather`` are one collective per leaf over the ``data`` group. Every
method keeps the parameter tree's nested-dict keys, so the optimizer's
per-key rules (AdamW's decay mask by key name, ``nn/updaters.py``) and
the per-group chains of ``apply_updates`` hold on shards unchanged: a
group's own updater, its decay, and a frozen group's shards passed
through with no state.
Elementwise optimizers are exact on shards; gradient normalisation that
reduces across a layer or a tree is refused by ``ParallelWrapper``.

:func:`zero_dp_report` is the measurement half: the replicated, sharded
and overlapped rows (step time, optimizer-state bytes per rank, the
estimated peak) over the current process group. The JAX package's
``subprocess_report`` forces JAX host devices and has no counterpart
here; a port bench takes its place (``ROADMAP.md`` item A10).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import obs, tree
from deeplearning4j_tpu_torch.parallel.mesh import (all_gather_,
                                                    reduce_scatter_sum)


class FlatShardLayout:
    """Per-leaf flat shard layout over ``n_shards`` ranks, fixed at
    construction from a donor parameter tree (nested dicts of tensors):
    each leaf's shape, dtype, size and size padded to a multiple of
    ``n_shards``. Every method maps a tree of the donor's keys to a tree
    of the same keys."""

    def __init__(self, params, n_shards: int):
        self.n = int(n_shards)
        self._template = tree.map_(lambda _: None, params)
        leaves = list(tree.leaves(params))
        self.shapes = [tuple(t.shape) for t in leaves]
        self.dtypes = [t.dtype for t in leaves]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.padded = [-(-s // self.n) * self.n for s in self.sizes]

    def _build(self, leaves):
        it = iter(leaves)
        return tree.map_(lambda _: next(it), self._template)

    def flatten(self, tree_):
        """Params-like tree → the same keys over flat zero-padded
        ``(padded,)`` leaves (a view of the leaf where no pad is
        needed)."""
        flat = []
        for t, s, p in zip(tree.leaves(tree_), self.sizes, self.padded):
            f = t.reshape(-1)
            flat.append(f if p == s else torch.nn.functional.pad(
                f, (0, p - s)))
        return self._build(flat)

    def unflatten(self, flat_tree):
        """Inverse of :meth:`flatten` (drops the zero pad)."""
        return self._build(
            f[:s].reshape(shape) for f, s, shape in
            zip(tree.leaves(flat_tree), self.sizes, self.shapes))

    def shard(self, flat_tree, index: int):
        """Rank ``index``'s ``(padded/n,)`` slice of every flat leaf (a
        view)."""
        return self._build(
            f.narrow(0, index * (p // self.n), p // self.n)
            for f, p in zip(tree.leaves(flat_tree), self.padded))

    def scatter_mean(self, tree_, group=None):
        """Reduce-scatter a grads-like tree over ``group``: this rank
        receives the group's MEAN of its flat slice of each leaf, one
        ``reduce_scatter`` per leaf — the sharded counterpart of the
        replicated step's gradient mean (the same sum of the same terms
        a slice at a time, then the same ``/ n``)."""
        with obs.devtime.scope("zero.reduce_scatter"):
            return self._build(
                reduce_scatter_sum(f.contiguous(), group).div_(self.n)
                for f in tree.leaves(self.flatten(tree_)))

    def gather(self, shard_tree, group=None):
        """All-gather every rank's shards back into the original shapes,
        one ``all_gather`` per leaf: every rank receives the same full
        leaves."""
        with obs.devtime.scope("zero.all_gather"):
            full = []
            for s, p in zip(tree.leaves(shard_tree), self.padded):
                out = torch.empty(p, dtype=s.dtype, device=s.device)
                full.append(all_gather_(out, s.contiguous(), group))
            return self.unflatten(self._build(full))


class LayoutMismatch(ValueError):
    """A checkpoint's flat leaves do not belong to the target parameter
    layout (non-zero data where the zero pad must be, or a shape that
    cannot be re-padded). Raised by :func:`repad_flat_leaves`; a restore
    treats it as a configuration error that fails fast, never as
    corruption."""


def repad_flat_leaves(src_leaves, ref_leaves, *, strict: bool = True):
    """Re-pad flat-layout leaves written under one shard count onto the
    padded sizes of another (the re-scatter half of a resharded
    restore). A flat leaf padded for N ranks and the same leaf padded for
    M differ only in the zero tail, and the zero pad is an invariant of
    training (padded gradient lanes are 0, so every elementwise optimizer
    keeps moments and parameters 0 there): truncating or extending with
    zeros is exact on the real content. ``strict`` checks that a
    truncated tail is all zero, so a mismatched layout fails loudly
    (:class:`LayoutMismatch`). Scalar leaves (step counts) pass through.
    Host-side numpy."""
    out = []
    for i, (cur, want) in enumerate(zip(src_leaves, ref_leaves)):
        cur = np.asarray(cur)
        wshape = tuple(want.shape)
        if tuple(cur.shape) == wshape:
            out.append(cur)
            continue
        if cur.ndim != 1 or len(wshape) != 1:
            raise LayoutMismatch(
                f"resharded restore: leaf {i} has shape {cur.shape} "
                f"but the target layout wants {wshape} — only flat "
                "(1-D padded) leaves can be re-padded")
        n = int(wshape[0])
        if cur.size > n:
            tail = cur[n:]
            if strict and np.any(tail != 0):
                raise LayoutMismatch(
                    f"resharded restore: leaf {i} carries non-zero "
                    f"data beyond the target padded size {n} "
                    f"({cur.size} > {n}) — the checkpoint does not "
                    "match this parameter layout")
            cur = cur[:n]
        elif cur.size < n:
            cur = np.pad(cur, (0, n - cur.size))
        out.append(cur.astype(want.dtype))
    return out


def sharded_leaf(leaf, n_shards: int) -> bool:
    """Is this optimizer-state leaf carried as 1/N shards under the flat
    layout? Moment leaves are flat vectors padded to a multiple of the
    shard count; scalars (step counts) stay whole on every rank."""
    return leaf.ndim >= 1 and leaf.shape[0] % n_shards == 0


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(np.asarray(leaf).nbytes)


def per_device_bytes(tree_, n_shards: int = 1) -> int:
    """Bytes of a tree of tensors (or arrays) held on one device. With
    ``n_shards`` 1 (the per-process use) that is every leaf: the bytes of
    the tensors this rank holds. With ``n_shards > 1`` on a global tree
    the sharded leaves count at 1/N and the scalars whole, as the JAX
    package counts a ``P('data')`` layout."""
    total = 0
    for leaf in tree.leaves(tree_):
        nb = _nbytes(leaf)
        if n_shards > 1 and sharded_leaf(leaf, n_shards):
            nb //= n_shards
        total += nb
    return int(total)


# ---------------------------------------------------------------------------
# the before/after measurement row
# ---------------------------------------------------------------------------

def zero_dp_report(steps: int = 10, hidden: int = 256, features: int = 64,
                   classes: int = 8, device: Optional[str] = None
                   ) -> Dict[str, Any]:
    """Replicated against sharded-update SYNC over the current process
    group (``initialize_distributed`` first; every rank calls this): the
    JAX package's MLP (``features``-``hidden``-``hidden``-``classes``,
    Adam 1e-3), each rank on its 8 rows of a global batch of 8 · n. Per
    row (``replicated``, ``sharded``, ``sharded_overlap``): the mean step
    ms over ``steps`` steps after 2 warm ones, this rank's
    optimizer-state bytes, and an estimated peak (params + one gradient
    tree + the optimizer state); then the largest relative difference of
    the sharded rows' parameters from the replicated ones. ``device``:
    the card unless the caller asks for the CPU."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import updaters as upd
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper

    device = device or "cuda"
    mesh = data_parallel_mesh()
    n, rank = mesh.size("data"), mesh.index("data")

    def mk_net():
        conf = (NeuralNetConfiguration.builder().seed(7)
                .updater(upd.Adam(learning_rate=1e-3)).list()
                .layer(DenseLayer(n_out=hidden, activation="relu"))
                .layer(DenseLayer(n_out=hidden, activation="relu"))
                .layer(OutputLayer(n_out=classes, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.feed_forward(features))
                .build())
        return MultiLayerNetwork(conf).init(device=device)

    rng = np.random.default_rng(0)
    x = rng.normal(size=(8 * n, features)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, 8 * n)]
    batch = [DataSet(x[8 * rank:8 * (rank + 1)], y[8 * rank:8 * (rank + 1)])]

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def drive(sharded: bool, overlap: bool = False) -> Dict[str, Any]:
        net = mk_net()
        w = ParallelWrapper(net, mesh=mesh, sharded_update=sharded,
                            gather_overlap=overlap)
        w.fit(batch, epochs=2)                # warm
        sync()
        t0 = obs.now()
        w.fit(batch, epochs=steps)
        sync()
        dt = (obs.now() - t0) / steps
        opt = w._dp_state if sharded else net.opt_state
        opt_bytes = per_device_bytes(opt)
        return {"step_ms": dt * 1e3,
                "opt_state_bytes_per_rank": opt_bytes,
                "est_peak_bytes_per_rank":
                    2 * per_device_bytes(net.params) + opt_bytes,
                "params": net.params}

    def max_rel(a_tree, b_tree) -> float:
        return max(float(((a - b).abs() / (a.abs() + 1e-6)).max())
                   for a, b in zip(tree.leaves(a_tree),
                                   tree.leaves(b_tree)))

    rep, sh, ov = drive(False), drive(True), drive(True, overlap=True)
    ref = rep.pop("params")
    rel = max_rel(ref, sh.pop("params"))
    rel_ov = max_rel(ref, ov.pop("params"))
    return {
        "n_ranks": n,
        "backend": dist.get_backend(mesh.group("data")),
        "device": device,
        "model": f"mlp {features}-{hidden}-{hidden}-{classes} adam",
        "replicated": rep, "sharded": sh, "sharded_overlap": ov,
        "opt_state_ratio": sh["opt_state_bytes_per_rank"]
        / max(1, rep["opt_state_bytes_per_rank"]),
        "step_time_ratio": sh["step_ms"] / rep["step_ms"],
        "overlap_step_ratio": ov["step_ms"] / sh["step_ms"],
        "max_param_rel_diff": rel,
        "max_param_rel_diff_overlap": rel_ov,
    }
