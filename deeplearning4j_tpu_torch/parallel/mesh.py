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
none either: gloo is the CPU transport. ``distributed_context`` comes
with the sequence-parallel slice, and the elastic bring-up with the
resilience slice.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


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
    coordinator_address = coordinator_address or os.environ.get(
        "DL4J_TPU_COORD")
    if torch.cuda.is_available():
        rank = process_id if process_id is not None else int(
            os.environ.get("DL4J_TPU_PROC_ID", 0))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if coordinator_address is None:
        dist.init_process_group(_backend(), store=dist.HashStore(),
                                rank=0, world_size=1)
        return
    if num_processes is None:
        num_processes = int(os.environ["DL4J_TPU_NPROC"])
    if process_id is None:          # NOT `or`: rank 0 is falsy
        process_id = int(os.environ["DL4J_TPU_PROC_ID"])
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
