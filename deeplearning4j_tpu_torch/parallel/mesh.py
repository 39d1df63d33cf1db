"""Process groups with named axes, and the multi-process bring-up (port
of ``deeplearning4j_tpu/parallel/mesh.py``).

The JAX package runs one process per host and one SPMD program over a
``jax.sharding.Mesh`` of devices. The port runs one process per card
(``torch.distributed``): a rank takes the place of a device, and a mesh
axis the place of ``axis_name`` — :class:`Mesh` maps each named axis to
the process group of the ranks that differ only along it, and the
collectives of ``parallel/`` take that group. Rank ``r`` runs on
``cuda:r``.

The default group is ``"cpu:gloo,cuda:nccl"`` where a card is present,
so one process sends a CUDA tensor over NCCL and a CPU tensor over gloo;
``"gloo"`` on a machine without a card. Every axis group inherits that.
A CUDA tensor given to a group without a CUDA backend raises
(:func:`check_backend`): it is never copied to the host to get through.

JAX's ``replicated``/``batch_sharded`` ``NamedSharding``s have no
counterpart: each process holds the whole parameter tree (the wrapper
broadcasts rank 0's at its first step, as JAX places one replicated
copy) and takes its own rows of a batch. ``enable_cpu_collectives`` has
none either: gloo is the CPU transport. The elastic bring-up comes with
the resilience slice.

**Sequence parallelism, the per-process rule.** The JAX package runs one
SPMD program over global arrays: a layer maps the global [B, T, F] to
the global [B, T, F], and ``shard_map`` exists only around the
attention. The port runs one process per card, so under
:class:`distributed_context` a rank holds only its own tokens, in every
layer:

- *Layout.* The rank of index ``m`` in a ``seq`` group of ``n`` holds a
  shard of each sequence: under ``"ring"`` and ``"ulysses"`` the
  contiguous chunk ``m`` of ``n``; under ``"zigzag_ring"`` chunks
  ``(m, 2n−1−m)`` of ``2n`` (``ring_attention.zigzag_order``), in that
  order. Its global positions follow from ``(mode, n, m, T_loc)`` alone
  (:func:`sequence_segments`); a T not divisible by ``n`` (by ``2n``
  under zigzag) raises ``ValueError`` (:func:`shard_sequence`).
- *Positions.* RoPE and ``PositionalEmbeddingLayer`` take the rank's
  global positions: each contiguous run of its tokens at its own offset
  (two runs under zigzag).
- *Data into ``fit``.* ``fit(x, y)`` is called on every rank of the
  group with the same global [B, T] batch, as the JAX call is; the
  network keeps the rank's tokens of the inputs, labels and masks, all
  in the mode's layout. ``output()`` all-gathers the shards over the
  group and undoes the layout, returning the global activations.
- *Loss and gradients.* The loss is a batch mean of per-example sums
  (``ops/losses.py``), so a rank's loss over its own tokens is already
  its share of the global loss (the divisor, B, is the same on every
  rank; the labels mask weighs each token). The gradients and the loss
  are summed over the group before the update, so gradient-norm
  clipping sees the global norm, ``score()`` is the global loss, and
  every rank's parameters stay the same to the bit.
- *The replicated tail.* A layer that reduces the sequence axis
  (``Layer.pools_sequence``: global pooling, the CLS pool, the learned
  queries' attention, a dense layer that flattens [B, T, F]; the
  ``LastTimeStepVertex``) combines the ranks' partials over the group
  by the differentiable collectives below — an all-reduce of the
  partial pools, the sum of the one rank's CLS row, an lse merge of the
  partial attentions, the shards gathered in global order — so every
  rank then holds the same [B, …] activations, and computes the same
  labels' loss. That loss counts on the first rank of the group only
  (the others weigh it 0, so their backward still runs the
  collectives): the sum over the group is then the global loss and
  gradient, not n times it, and it adds only zeros to the first rank's,
  with no rounding (a 1/n share each would round at n not a power of
  two). The collectives' backward is the adjoint of their forward: the
  sum of every rank's cotangent, routed back to the rank's own
  contribution. Dropout in the tail draws the same mask on every rank
  (the rank's index is folded into the seeds of the layers before the
  reduction only), so the ranks' parameters stay the same.
- *Refused.* ``batch_axis``/``head_axis`` and a mesh with any axis but
  the sequence axis (composed DP × SP × TP, ROADMAP item A3) raise
  ``NotImplementedError``; so do layers that mix positions other than
  the sequence-parallel attention and the pooling layers above
  (``nn/multilayer.py``), a sequence-parallel layer after the
  reduction, and the graph vertices that reorder or flatten a time
  axis (``nn/vertices.py``) and the input preprocessors that reshape
  it, on the rank's shard (item A16).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.environment import get_flag


def _required_flag(name: str) -> int:
    """The flag ``name``, which a coordinated start needs: ``KeyError``
    when it is not set."""
    value = get_flag(name)
    if value is None:
        raise KeyError(name)
    return value


def _backend() -> str:
    return "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-process bring-up (reference: SharedTrainingMaster's
    Spark + Aeron bootstrap; JAX: ``jax.distributed.initialize``): the
    default process group of ``num_processes`` ranks, this one
    ``process_id``. ``coordinator_address`` is ``host:port`` (TCP) or an
    ``init_method`` URL (``tcp://…``, ``file://…``); unset, the three
    come from ``DL4J_TPU_COORD``, ``DL4J_TPU_NPROC`` and
    ``DL4J_TPU_PROC_ID``, and with no coordinator at all the group is
    this process alone (an in-memory store: no port, no file). A second
    call returns at once. On a machine with cards rank ``r`` takes
    ``cuda:r`` (mod the host's cards)."""
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or get_flag(
        "DL4J_TPU_COORD")
    if torch.cuda.is_available():
        rank = process_id if process_id is not None else (
            get_flag("DL4J_TPU_PROC_ID") or 0)
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if coordinator_address is None:
        dist.init_process_group(_backend(), store=dist.HashStore(),
                                rank=0, world_size=1)
        return
    if num_processes is None:
        num_processes = _required_flag("DL4J_TPU_NPROC")
    if process_id is None:          # NOT `or`: rank 0 is falsy
        process_id = _required_flag("DL4J_TPU_PROC_ID")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(_backend(), init_method=url,
                            world_size=num_processes, rank=process_id)


def initialize_distributed_elastic(*args, **kwargs) -> bool:
    """The preemptible fleet's bring-up comes with the resilience slice
    (``resilience/elastic.py``)."""
    raise NotImplementedError(
        "initialize_distributed_elastic: the elastic bring-up comes with "
        "the resilience slice")


def check_backend(tensor: torch.Tensor, group=None) -> None:
    """Raise unless ``group`` (None: the default group) has a backend for
    ``tensor``'s device: a CUDA tensor needs NCCL."""
    backend = dist.get_backend(group)
    if tensor.is_cuda and "nccl" not in backend:
        raise ValueError(
            f"a CUDA tensor in a process group without a CUDA backend "
            f"({backend!r}); initialize_distributed on a machine with a "
            "card gives 'cpu:gloo,cuda:nccl'")


def all_reduce_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``tensor`` over ``group`` IN PLACE and return it (gloo has no
    ``ReduceOp.AVG``: callers divide by the group size)."""
    check_backend(tensor, group)
    if not tensor.is_contiguous():
        raise ValueError("collectives take contiguous tensors")
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


def mean_over(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``tensor`` over ``group``, a new tensor (the JAX
    ``pmean``: the sum, then / n)."""
    return all_reduce_sum(tensor.contiguous().clone(), group) \
        / dist.get_world_size(group)


def all_gather(tensor: torch.Tensor, group=None):
    """``tensor`` of every rank of ``group``, in rank order."""
    check_backend(tensor, group)
    tensor = tensor.contiguous()
    out = [torch.empty_like(tensor)
           for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, tensor, group=group)
    return out


def _all_reduce(tensor: torch.Tensor, op, group) -> torch.Tensor:
    """``op`` over ``group`` of a contiguous copy of ``tensor``."""
    out = tensor.contiguous().clone()
    check_backend(out, group)
    dist.all_reduce(out, op=op, group=group)
    return out


# -- differentiable collectives of the replicated tail (the rule above) ------
class _ReduceSum(torch.autograd.Function):
    """The sum over the group; its adjoint is the sum of the cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, dist.ReduceOp.SUM, ctx.group), None


class _ReduceMax(torch.autograd.Function):
    """The elementwise max over the group. The gradient of an element
    goes whole to its owning rank: the first in the group that holds the
    max (a tie between ranks is not split)."""

    @staticmethod
    def forward(ctx, x, group):
        y = _all_reduce(x, dist.ReduceOp.MAX, group)
        me = dist.get_rank(group)
        held = torch.where(x == y, me, dist.get_world_size(group))
        owner = _all_reduce(held, dist.ReduceOp.MIN, group)
        ctx.group = group
        ctx.save_for_backward(owner == me)
        return y

    @staticmethod
    def backward(ctx, g):
        mine, = ctx.saved_tensors
        g = _all_reduce(g, dist.ReduceOp.SUM, ctx.group)
        return torch.where(mine, g, torch.zeros_like(g)), None


class _GatherSequence(torch.autograd.Function):
    """Every rank's shard of the sequence, put back in global order; the
    backward keeps the rank's own positions of the summed cotangent."""

    @staticmethod
    def forward(ctx, x, group, mode):
        ctx.args = (group, mode, dist.get_world_size(group),
                    dist.get_rank(group), x.shape[1])
        return unshard_sequence(all_gather(x, group), mode)

    @staticmethod
    def backward(ctx, g):
        group, mode, n, m, _ = ctx.args
        g = _all_reduce(g, dist.ReduceOp.SUM, group)
        return shard_sequence(g, mode, n, m).contiguous(), None, None


def _alone(group) -> bool:
    return group is None or dist.get_world_size(group) == 1


def reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group``, differentiable (the JAX ``psum``):
    every rank's cotangents are summed back to each rank. ``x`` itself
    when ``group`` is None (an input that is not a shard,
    :func:`shard_group`) or has one rank."""
    return x if _alone(group) else _ReduceSum.apply(x, group)


def reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group``, differentiable: the
    summed cotangent goes to the first rank holding each max. ``x``
    itself when ``group`` is None or has one rank."""
    return x if _alone(group) else _ReduceMax.apply(x, group)


def gather_sequence(x: torch.Tensor, mode: str,
                    group=None) -> torch.Tensor:
    """The global [B, T, ...] from every rank's shard ``x`` [B, T_loc,
    ...] in the layout of ``mode``, differentiable: the inverse of
    :func:`shard_sequence`, whose backward keeps the rank's positions of
    the summed cotangent. ``x`` itself when ``group`` is None or has one
    rank."""
    return x if _alone(group) else _GatherSequence.apply(x, group, mode)


def max_over(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group``, outside autograd
    (:func:`reduce_max` also finds each element's owner); ``x`` itself
    when ``group`` is None or has one rank."""
    return x if _alone(group) else _all_reduce(x, dist.ReduceOp.MAX, group)


# the flat collectives' current names (torch 2.13); older releases have
# only the ``_tensor`` ones, with the same arguments
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_ALL_GATHER = getattr(dist, "all_gather_single",
                      dist.all_gather_into_tensor)


def reduce_scatter_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's block of the sum of ``tensor`` over ``group``, a new
    tensor: ``tensor`` (1-D, its length a multiple of the group size) is
    cut into one block per rank in rank order, and rank ``r`` receives
    the sum of every rank's block ``r`` (the JAX ``psum_scatter`` with
    ``tiled=True``)."""
    check_backend(tensor, group)
    n = dist.get_world_size(group)
    if tensor.ndim != 1 or tensor.numel() % n:
        raise ValueError(f"reduce_scatter_sum takes a 1-D tensor whose "
                         f"length is a multiple of {n}, got "
                         f"{tuple(tensor.shape)}")
    if not tensor.is_contiguous():
        raise ValueError("collectives take contiguous tensors")
    out = torch.empty(tensor.numel() // n, dtype=tensor.dtype,
                      device=tensor.device)
    _REDUCE_SCATTER(out, tensor, op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather_(out: torch.Tensor, tensor: torch.Tensor,
                group=None) -> torch.Tensor:
    """Write every rank's ``tensor`` (1-D) into ``out``, in rank order,
    in place, and return ``out`` (the JAX ``all_gather`` with
    ``tiled=True``)."""
    check_backend(tensor, group)
    if out.numel() != tensor.numel() * dist.get_world_size(group):
        raise ValueError(f"all_gather_: out holds {out.numel()} elements, "
                         f"{dist.get_world_size(group)} ranks send "
                         f"{tensor.numel()} each")
    if not (tensor.is_contiguous() and out.is_contiguous()):
        raise ValueError("collectives take contiguous tensors")
    _ALL_GATHER(out, tensor, group=group)
    return out


def broadcast_(tensor: torch.Tensor, src_group_rank: int = 0,
               group=None) -> torch.Tensor:
    """Overwrite ``tensor`` with rank ``src_group_rank``'s (its rank in
    ``group``), in place."""
    check_backend(tensor, group)
    if not tensor.is_contiguous():
        raise ValueError("collectives take contiguous tensors")
    src = dist.get_global_rank(group or dist.group.WORLD, src_group_rank)
    dist.broadcast(tensor, src=src, group=group)
    return tensor


class Mesh:
    """Named axes over the ranks of the default group (the counterpart
    of ``jax.sharding.Mesh``): ``ranks`` is the world's ranks laid out
    row-major in the axes' sizes, as ``make_mesh`` lays out devices;
    :meth:`group` is the process group of this rank's line along an
    axis."""

    def __init__(self, axes: Dict[str, int], ranks: np.ndarray,
                 groups: Dict[str, object]):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)
        self.ranks = ranks
        self._groups = groups
        coord = np.argwhere(ranks == dist.get_rank())[0]
        self._index = dict(zip(self.axis_names, map(int, coord)))

    def group(self, axis: str):
        """The process group of ``axis`` (JAX's ``axis_name``)."""
        return self._groups[axis]

    def size(self, axis: Optional[str] = None) -> int:
        """Ranks along ``axis``, or in the whole mesh."""
        return (self.shape[axis] if axis is not None
                else int(self.ranks.size))

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self._index[axis]

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(axes: Dict[str, int]) -> Mesh:
    """A mesh with named axes over every rank, e.g. ``{"slice": 2,
    "data": 4}``; an axis size of -1 absorbs the remaining ranks (like a
    reshape). Collective: every rank calls it with the same axes (each
    axis line becomes a ``dist.new_group``; a line of every rank is the
    default group)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed() first")
    n = dist.get_world_size()
    names, sizes = list(axes), list(axes.values())
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError(f"{n} ranks not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs "
                         f"{math.prod(sizes)} ranks, the group has {n}")
    ranks = np.arange(n).reshape(sizes)
    me = dist.get_rank()
    groups = {}
    for k, name in enumerate(names):
        lines = np.moveaxis(ranks, k, -1).reshape(-1, sizes[k])
        if len(lines) == 1:
            groups[name] = dist.group.WORLD
            continue
        for line in lines:                  # every rank makes every group
            g = dist.new_group([int(r) for r in line])
            if me in line:
                groups[name] = g
    return Mesh(dict(zip(names, sizes)), ranks, groups)


def data_parallel_mesh(n: Optional[int] = None) -> Mesh:
    """Every rank on one ``data`` axis — the ParallelWrapper topology.
    ``n``, when given, must be the world size (a process outside the
    mesh would have no step to run)."""
    return make_mesh({"data": n if n else -1})


# ---------------------------------------------------------------------------
# the ambient sequence-parallel context (JAX ``parallel/mesh.py:207-262``)
# ---------------------------------------------------------------------------
#: the sequence-parallel modes of ``MultiHeadAttention``
SP_MODES = ("ring", "ulysses", "zigzag_ring")

_TLS = threading.local()
_CTX_EPOCH = [0]


def _stack() -> list:
    if not hasattr(_TLS, "stack"):
        _TLS.stack = []
    return _TLS.stack


class distributed_context:
    """Context manager installing a mesh as the ambient distributed
    context: layers with a ``sequence_parallel`` setting
    (``MultiHeadAttention`` and the blocks holding one) route their
    attention over ``axis_name`` of this mesh while it is active, and a
    network holding them keeps each rank's tokens (the per-process rule
    of this module's docstring).

        with distributed_context(make_mesh({"seq": 4})):
            net.fit(x, y)     # every rank: the same global batch

    Per-thread, as in JAX. ``layout`` is the mode whose layout the
    running network holds its tokens in, set by the network for each
    layer or vertex it feeds the rank's shard (None outside a forward and
    in the replicated tail): ``PositionalEmbeddingLayer`` and the layers
    that reduce the sequence read it (:func:`sharded_input`).
    ``batch_axis``/``head_axis`` and a mesh with other axes (composed
    DP × SP × TP) raise ``NotImplementedError``: ROADMAP item A3."""

    def __init__(self, mesh: Mesh, axis_name: str = "seq",
                 batch_axis: Optional[str] = None,
                 head_axis: Optional[str] = None):
        if batch_axis is not None or head_axis is not None:
            raise NotImplementedError(
                f"distributed_context(batch_axis={batch_axis!r}, "
                f"head_axis={head_axis!r}): composed DP x SP x TP "
                "(parallel/composed.py) comes with ROADMAP item A3")
        if tuple(mesh.axis_names) != (axis_name,):
            raise NotImplementedError(
                f"distributed_context over a mesh with axes "
                f"{mesh.axis_names} (sequence axis {axis_name!r}): a "
                "mesh with axes besides the sequence axis (composed "
                "parallelism) comes with ROADMAP item A3")
        self.mesh = mesh
        self.axis_name = axis_name
        self.batch_axis = batch_axis
        self.head_axis = head_axis
        self.layout: Optional[str] = None

    @property
    def group(self):
        """The process group of the sequence axis."""
        return self.mesh.group(self.axis_name)

    @property
    def size(self) -> int:
        return self.mesh.size(self.axis_name)

    @property
    def index(self) -> int:
        """This rank's index along the sequence axis."""
        return self.mesh.index(self.axis_name)

    def __enter__(self):
        _stack().append(self)
        _CTX_EPOCH[0] += 1
        return self

    def __exit__(self, *exc):
        stack = _stack()
        if self in stack:          # tolerate out-of-order exits
            stack.remove(self)
        _CTX_EPOCH[0] += 1
        return False


def active_context() -> Optional[distributed_context]:
    """The innermost active context of this thread, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def context_epoch() -> int:
    """Monotone counter bumped on every context enter/exit (the JAX
    package keys its jit caches on it; the port has no traces and keeps
    it for the API)."""
    return _CTX_EPOCH[0]


def sequence_segments(mode: str, n: int, m: int,
                      t_loc: int) -> Tuple[Tuple[int, int], ...]:
    """``(global offset, length)`` of each contiguous run of the tokens
    rank ``m`` of ``n`` holds, in the order it holds them, for a local
    length ``t_loc``: one run under ``"ring"``/``"ulysses"``, two
    half-chunks under ``"zigzag_ring"``."""
    if mode == "zigzag_ring":
        if t_loc % 2:
            raise ValueError(f"zigzag_ring: the local length {t_loc} is "
                             "not two equal half-chunks")
        c = t_loc // 2
        return ((m * c, c), ((2 * n - 1 - m) * c, c))
    if mode not in SP_MODES:
        raise ValueError(f"unknown sequence_parallel mode {mode!r} "
                         "(ring|ulysses|zigzag_ring)")
    return ((m * t_loc, t_loc),)


def local_segments(mode: Optional[str], t_loc: int):
    """:func:`sequence_segments` of this rank under the active context
    for ``mode``; None with no context or no mode (the tokens are the
    whole sequence from position 0)."""
    ctx = active_context()
    if ctx is None or mode is None:
        return None
    return sequence_segments(mode, ctx.size, ctx.index, t_loc)


def shard_sequence(x: torch.Tensor, mode: str, n: int, m: int,
                   axis: int = 1) -> torch.Tensor:
    """Rank ``m``'s tokens of the global array ``x`` along ``axis``, in
    the layout of ``mode``. ``ValueError`` unless T divides into ``n``
    chunks (``2n`` under zigzag), as ``zigzag_permute`` refuses."""
    t = x.shape[axis]
    parts = 2 * n if mode == "zigzag_ring" else n
    if t % parts:
        raise ValueError(f"T={t} not divisible by {parts} ({mode!r} over "
                         f"{n} ranks)")
    segs = sequence_segments(mode, n, m, t // n)
    if len(segs) == 1:
        return x.narrow(axis, *segs[0])
    return torch.cat([x.narrow(axis, off, ln) for off, ln in segs],
                     dim=axis)


def unshard_sequence(shards: Sequence[torch.Tensor], mode: str,
                     axis: int = 1) -> torch.Tensor:
    """The global array from every rank's shard (in rank order): the
    inverse of :func:`shard_sequence`."""
    n = len(shards)
    runs = []
    for m, x in enumerate(shards):
        at = 0
        for off, ln in sequence_segments(mode, n, m, x.shape[axis]):
            runs.append((off, x.narrow(axis, at, ln)))
            at += ln
    runs.sort(key=lambda r: r[0])
    return torch.cat([r[1] for r in runs], dim=axis)


def sharded_input():
    """``(context, mode)`` while a sequence-parallel network's forward
    feeds a layer (or vertex) the rank's shard of the sequence (the
    context's ``layout`` set); None otherwise — outside a context, in a
    network that does not run sequence-parallel, and in the replicated
    tail after the reduction, where a layer sees the whole [B, …]."""
    ctx = active_context()
    if ctx is None or ctx.layout is None:
        return None
    return ctx, ctx.layout


@contextlib.contextmanager
def unsharded():
    """The active context's ``layout`` cleared around a call that feeds a
    layer single positions as rows, not the rank's shard of a sequence
    (``TimeDistributed``): :func:`sharded_input` is None inside it."""
    ctx = active_context()
    if ctx is None:
        yield
        return
    prev, ctx.layout = ctx.layout, None
    try:
        yield
    finally:
        ctx.layout = prev


def shard_group():
    """The ``seq`` group over which the calling layer's input is sharded
    (:func:`sharded_input`), or None when it is fed the whole sequence:
    the collectives above are then the identity."""
    sp = sharded_input()
    return None if sp is None else sp[0].group


def global_positions(t_loc: int, device=None) -> torch.Tensor:
    """The global position of each of the ``t_loc`` tokens the calling
    layer is fed, in the order it holds them (int64 [t_loc]): the rank's
    under :func:`sharded_input`, else ``0 … t_loc − 1``."""
    sp = sharded_input()
    if sp is None:
        return torch.arange(t_loc, device=device)
    ctx, mode = sp
    return torch.cat([
        torch.arange(off, off + ln, device=device)
        for off, ln in sequence_segments(mode, ctx.size, ctx.index, t_loc)])


def local_index(t_loc: int, position: int) -> Optional[int]:
    """Where among the ``t_loc`` tokens the calling layer is fed the
    global ``position`` lies, or None when another rank holds it."""
    sp = sharded_input()
    if sp is None:
        return position if 0 <= position < t_loc else None
    ctx, mode = sp
    at = 0
    for off, ln in sequence_segments(mode, ctx.size, ctx.index, t_loc):
        if off <= position < off + ln:
            return at + position - off
        at += ln
    return None
