"""Ulysses sequence parallelism: an all-to-all trades the sequence shard
for a head shard around the attention (port of
``deeplearning4j_tpu/parallel/ulysses.py``).

Each rank holds its contiguous chunk of the sequence (the per-process
rule of ``parallel/mesh.py``). Two tiled all-to-alls over the ``seq``
group, each ``dist.all_to_all_single`` inside an autograd Function whose
backward is the inverse exchange:

    [B, T/n, H, D]  --all_to_all-->  [B, T, H/n, D]
        (attention over the whole sequence, 1/n of the heads)
    [B, T, H/n, D]  --all_to_all-->  [B, T/n, H, D]

The key mask is all-gathered. The attention is the port's
``scaled_dot_attention``: on the card the flash kernels K1 and K3, as on
the local path. At group size 1 nothing is exchanged.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel.mesh import (Mesh, all_gather,
                                                    check_backend)


def _exchange(x, group):
    """``dist.all_to_all_single`` of ``x`` [n, ...]: chunk j goes to rank
    j, and chunk j of the result came from rank j."""
    x = x.contiguous()
    check_backend(x, group)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _seq_to_head(x, group, n: int):
    """[B, T/n, H, D] (this rank's tokens, every head) → [B, T, H/n, D]
    (every token, this rank's head group)."""
    b, tl, h, d = x.shape
    y = _exchange(x.reshape(b, tl, n, h // n, d).permute(2, 0, 1, 3, 4),
                  group)                       # [src rank, B, T/n, H/n, D]
    return y.permute(1, 0, 2, 3, 4).reshape(b, n * tl, h // n, d)


def _head_to_seq(x, group, n: int):
    """The inverse of :func:`_seq_to_head`."""
    b, t, hn, d = x.shape
    tl = t // n
    y = _exchange(x.reshape(b, n, tl, hn, d).permute(1, 0, 2, 3, 4),
                  group)                       # [head group, B, T/n, H/n, D]
    return y.permute(1, 2, 0, 3, 4).reshape(b, tl, n * hn, d)


class _SeqToHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _seq_to_head(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _head_to_seq(g, ctx.group, ctx.n), None, None


class _HeadToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _head_to_seq(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_head(g, ctx.group, ctx.n), None, None


def ulysses_self_attention(q, k, v, mesh: Mesh, axis_name: str = "seq",
                           mask: Optional[torch.Tensor] = None,
                           causal: bool = False):
    """Distributed attention over the ``axis_name`` ranks of ``mesh``:
    q, k, v [B, T_loc, H, D] are THIS rank's contiguous chunk of the
    sequence; returns this rank's [B, T_loc, H, D]. ``mask``: this rank's
    [B, T_loc] key mask. Requires ``H % n == 0`` (the heads spread over
    the axis) and as many kv heads as query heads (the layer repeats
    them first). Every rank of the axis calls it, with the same
    shapes."""
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        scaled_dot_attention
    n = mesh.size(axis_name)
    h = q.shape[2]
    if h % n:
        raise ValueError(
            f"ulysses needs heads ({h}) divisible by the "
            f"{axis_name!r} axis size ({n}); use ring_attention for "
            "head counts below the mesh size")
    if n == 1:
        return scaled_dot_attention(q, k, v, mask=mask, causal=causal)
    group = mesh.group(axis_name)
    qf, kf, vf = (_SeqToHead.apply(x, group, n) for x in (q, k, v))
    mf = (None if mask is None
          else torch.cat(all_gather(mask, group), dim=1))
    out = scaled_dot_attention(qf, kf, vf, mask=mf, causal=causal)
    return _HeadToSeq.apply(out, group, n)
