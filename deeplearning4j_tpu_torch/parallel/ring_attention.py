"""Ring attention: sequence parallelism over the ranks of a ``seq`` axis
(port of ``deeplearning4j_tpu/parallel/ring_attention.py``).

Each rank holds its own shard of the sequence (the per-process rule of
``parallel/mesh.py``): q, k, v [B, T_loc, H, D]. Over ``n`` ring steps a
rank attends its query block to the key block it holds — one
``ops.cuda_kernels.flash_block_fwd`` call a step, K1 on the card at the
two blocks' global offsets — merges the block's normalised (out, lse)
into its running pair exactly (:func:`_merge_blocks`, in f32), and
passes the key block (and its key mask) to rank ``m + 1`` while taking
rank ``m − 1``'s, by ``dist.batch_isend_irecv`` over the axis's group
(one batch of a send and a receive, so no rank waits on another's
order). At ring step ``i`` rank ``m`` holds the block that started on
rank ``src = (m − i) mod n``: query offset ``m · T_loc``, key offset
``src · T_loc``. A causal block wholly above the diagonal does no work
in the kernel and returns out 0, lse −inf.

The backward is a second ring (FlashAttention-2 style): q, out, lse and
dO stay home, k and v rotate again, and one ``flash_block_bwd`` call a
step (K3, or K4 + K5 past the fused budget) gives the pair's (dq
contribution, dk, dv). dq accumulates locally in f32; the f32 dk/dv
accumulators travel with their key block and arrive home, summed over
every query block, after ``n`` rotations. At group size 1 nothing is
sent. NCCL carries CUDA tensors and gloo CPU ones; a CUDA tensor on a
group without NCCL raises (``mesh.check_backend``).

:func:`zigzag_ring_self_attention` is the load-balanced causal ring: a
rank holds global chunks ``(m, 2n−1−m)`` of ``2n`` and each ring step
runs the four half-chunk pairs, so every rank does the same work.
Composed DP × SP × TP (``batch_axis``/``head_axis``) comes with ROADMAP
item A3.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.ops.cuda_kernels import (flash_block_bwd,
                                                       flash_block_fwd)
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, check_backend


def _merge_blocks(out, lse, o_b, lse_b):
    """Merge a new block's normalised (``o_b``, ``lse_b``) into the
    running (``out``, ``lse``): out [B, T, H, D] f32, lse [B, H, T] f32,
    ``o_b`` in the compute dtype. Exact: o_b·exp(lse_b) is the block's
    unnormalised numerator and exp(lse_b) its denominator, so the pair
    reweights by exp(lse − lse_new), lse_new = logaddexp(lse, lse_b);
    a −inf side weighs 0, and two −inf sides stay −inf and 0."""
    lse_new = torch.logaddexp(lse, lse_b)
    safe = torch.where(torch.isinf(lse_new), 0.0, lse_new)
    w_old = torch.where(torch.isinf(lse), 0.0, torch.exp(lse - safe))
    w_new = torch.where(torch.isinf(lse_b), 0.0, torch.exp(lse_b - safe))
    rows = lambda w: w.transpose(1, 2)[..., None]     # [B, T, H, 1]
    return out * rows(w_old) + o_b.float() * rows(w_new), lse_new


def _rotate(tensors, group, n: int, m: int):
    """Each tensor of ``tensors`` (None passes through) sent to rank
    ``m + 1`` of ``group`` and replaced by rank ``m − 1``'s, in one
    ``batch_isend_irecv``; unchanged at group size 1."""
    if n == 1:
        return list(tensors)
    nxt = dist.get_global_rank(group, (m + 1) % n)
    prv = dist.get_global_rank(group, (m - 1) % n)
    ops, outs = [], []
    for t in tensors:
        if t is None:
            outs.append(None)
            continue
        t = t.contiguous()
        check_backend(t, group)
        buf = torch.empty_like(t)
        ops += [dist.P2POp(dist.isend, t, nxt, group),
                dist.P2POp(dist.irecv, buf, prv, group)]
        outs.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def _halves(x, dim: int = 1):
    c = x.shape[dim] // 2
    return x.narrow(dim, 0, c), x.narrow(dim, c, c)


def _ring_fwd(q, k, v, km, group, n, m, causal):
    """The forward ring: (out in q's dtype, lse [B, H, T_loc] f32)."""
    b, t, h, _ = q.shape
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, t), -math.inf, device=q.device)
    k_cur, v_cur, km_cur = k, v, km
    for i in range(n):
        src = (m - i) % n
        o_b, lse_b = flash_block_fwd(q, k_cur, v_cur, km_cur,
                                     (m * t, src * t), causal)
        out, lse = _merge_blocks(out, lse, o_b, lse_b)
        if i < n - 1:
            k_cur, v_cur, km_cur = _rotate((k_cur, v_cur, km_cur), group,
                                           n, m)
    return out.to(q.dtype), lse


def _ring_bwd(q, k, v, km, out, lse, dout, group, n, m, causal):
    t = q.shape[1]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    k_cur, v_cur, km_cur = k, v, km
    for i in range(n):
        src = (m - i) % n
        dq_b, dk_b, dv_b = flash_block_bwd(q, k_cur, v_cur, out, lse, dout,
                                           km_cur, (m * t, src * t),
                                           causal)
        dq += dq_b.float()
        dk += dk_b.float()
        dv += dv_b.float()
        # the accumulators travel with their key block: home after n
        if i < n - 1:
            k_cur, v_cur, km_cur, dk, dv = _rotate(
                (k_cur, v_cur, km_cur, dk, dv), group, n, m)
        else:
            dk, dv = _rotate((dk, dv), group, n, m)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _zz_fwd(q, k, v, km, group, n, m):
    """The zigzag forward ring: four half-chunk pairs a step, causal."""
    b, t, h, _ = q.shape
    c = t // 2
    q_ids = (m, 2 * n - 1 - m)
    qh = _halves(q)
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, t), -math.inf, device=q.device)
    k_cur, v_cur, km_cur = k, v, km
    for i in range(n):
        src = (m - i) % n
        k_ids = (src, 2 * n - 1 - src)
        kh, vh = _halves(k_cur), _halves(v_cur)
        kmh = (None, None) if km_cur is None else _halves(km_cur)
        for qi in (0, 1):
            qs = slice(qi * c, (qi + 1) * c)
            for ki in (0, 1):
                o_b, lse_b = flash_block_fwd(
                    qh[qi], kh[ki], vh[ki], kmh[ki],
                    (q_ids[qi] * c, k_ids[ki] * c), True)
                out[:, qs], lse[:, :, qs] = _merge_blocks(
                    out[:, qs], lse[:, :, qs], o_b, lse_b)
        if i < n - 1:
            k_cur, v_cur, km_cur = _rotate((k_cur, v_cur, km_cur), group,
                                           n, m)
    return out.to(q.dtype), lse


def _zz_bwd(q, k, v, km, out, lse, dout, group, n, m):
    t = q.shape[1]
    c = t // 2
    q_ids = (m, 2 * n - 1 - m)
    qh, outh, douth = _halves(q), _halves(out), _halves(dout)
    # the kernels read lse as a dense [B, H, c] block
    lseh = tuple(x.contiguous() for x in _halves(lse, 2))
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    k_cur, v_cur, km_cur = k, v, km
    for i in range(n):
        src = (m - i) % n
        k_ids = (src, 2 * n - 1 - src)
        kh, vh = _halves(k_cur), _halves(v_cur)
        kmh = (None, None) if km_cur is None else _halves(km_cur)
        for qi in (0, 1):
            qs = slice(qi * c, (qi + 1) * c)
            for ki in (0, 1):
                ks = slice(ki * c, (ki + 1) * c)
                dq_b, dk_b, dv_b = flash_block_bwd(
                    qh[qi], kh[ki], vh[ki], outh[qi], lseh[qi], douth[qi],
                    kmh[ki], (q_ids[qi] * c, k_ids[ki] * c), True)
                dq[:, qs] += dq_b.float()
                dk[:, ks] += dk_b.float()
                dv[:, ks] += dv_b.float()
        if i < n - 1:
            k_cur, v_cur, km_cur, dk, dv = _rotate(
                (k_cur, v_cur, km_cur, dk, dv), group, n, m)
        else:
            dk, dv = _rotate((dk, dv), group, n, m)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttnFn(torch.autograd.Function):
    """The ring (or zigzag ring) as one differentiable call (the JAX
    ``_ring_attn``/``_zz_ring_attn`` custom vjps): the forward ring saves
    ``q, k, v, mask, out, lse`` — never a probability — and the backward
    runs the second ring on them. No gradient for the mask."""

    @staticmethod
    def forward(ctx, q, k, v, km, group, n, m, causal, zigzag):
        if zigzag:
            out, lse = _zz_fwd(q, k, v, km, group, n, m)
        else:
            out, lse = _ring_fwd(q, k, v, km, group, n, m, causal)
        ctx.save_for_backward(q, k, v, km, out, lse)
        ctx.ring = (group, n, m, causal, zigzag)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, km, out, lse = ctx.saved_tensors
        group, n, m, causal, zigzag = ctx.ring
        # autograd's cotangent may come out of a reshape: the kernels
        # read dO through strides but need the head dim dense
        dout = dout.contiguous()
        if zigzag:
            grads = _zz_bwd(q, k, v, km, out, lse, dout, group, n, m)
        else:
            grads = _ring_bwd(q, k, v, km, out, lse, dout, group, n, m,
                              causal)
        return (*grads, None, None, None, None, None, None)


def _seq_axis(mesh: Mesh, axis_name: str, batch_axis, head_axis):
    """(group, size, this rank's index) of ``axis_name``."""
    if batch_axis is not None or head_axis is not None:
        raise NotImplementedError(
            f"batch_axis={batch_axis!r}, head_axis={head_axis!r}: "
            "composed DP x SP x TP comes with ROADMAP item A3")
    return (mesh.group(axis_name), mesh.size(axis_name),
            mesh.index(axis_name))


def _check_heads(q, k, v):
    h, h_kv = q.shape[2], k.shape[2]
    if h % h_kv or v.shape[2] != h_kv:
        raise ValueError(f"q heads ({h}) not divisible by kv heads "
                         f"({h_kv})")


def ring_self_attention(q, k, v, mesh: Mesh, axis_name: str = "seq",
                        mask: Optional[torch.Tensor] = None,
                        causal: bool = False, batch_axis=None,
                        head_axis=None):
    """Distributed attention over the ``axis_name`` ranks of ``mesh``:
    q [B, T_loc, H, D], k, v [B, T_loc, Hkv, D] are THIS rank's
    contiguous chunk of the sequence (chunk ``m`` of ``n``); returns
    this rank's [B, T_loc, H, D]. ``mask``: this rank's [B, T_loc] key
    mask. ``causal`` masks above the global diagonal through each ring
    step's block offsets. GQA: k/v may carry fewer heads (H divisible by
    Hkv); only the small kv travels the ring. Every rank of the axis
    calls it, with the same shapes."""
    _check_heads(q, k, v)
    group, n, m = _seq_axis(mesh, axis_name, batch_axis, head_axis)
    return _RingAttnFn.apply(q, k, v, mask, group, n, m, causal, False)


# Ulysses all-to-all sequence parallelism lives in parallel/ulysses.py;
# this alias keeps the JAX package's import location.
from deeplearning4j_tpu_torch.parallel.ulysses import \
    ulysses_self_attention as ulysses_attention  # noqa: E402


def zigzag_order(n: int):
    """Global chunk order of the zigzag layout: rank m holds chunks
    (m, 2n−1−m) of 2n equal chunks."""
    order = []
    for m in range(n):
        order += [m, 2 * n - 1 - m]
    return order


def _zigzag_index(t: int, n: int, device) -> torch.Tensor:
    c = t // (2 * n)
    if t % (2 * n):
        raise ValueError(f"T={t} not divisible by 2·n_devices={2 * n}")
    return torch.cat([torch.arange(j * c, (j + 1) * c, device=device)
                      for j in zigzag_order(n)])


def zigzag_permute(x, n: int, axis: int = 1):
    """Reorder a global [..., T, ...] tensor into the zigzag layout
    (rank m's shard is then the m-th of n equal chunks)."""
    return torch.index_select(x, axis,
                              _zigzag_index(x.shape[axis], n, x.device))


def zigzag_unpermute(x, n: int, axis: int = 1):
    """Inverse of :func:`zigzag_permute`."""
    idx = _zigzag_index(x.shape[axis], n, x.device)
    return torch.index_select(x, axis, torch.argsort(idx))


def zigzag_ring_self_attention(q, k, v, mesh: Mesh,
                               axis_name: str = "seq",
                               mask: Optional[torch.Tensor] = None,
                               batch_axis=None, head_axis=None):
    """Load-balanced CAUSAL ring attention. q [B, T_loc, H, D], k, v
    [B, T_loc, Hkv, D] are THIS rank's shard in the zigzag layout:
    global chunks (m, 2n−1−m) of 2n, in that order (rank m's chunk of
    :func:`zigzag_permute` of the global tensor); returns the same
    layout. Each ring step runs the four half-chunk pairs, so every rank
    computes the same number of live pairs. ``mask``: the rank's
    [B, T_loc] key mask in the same layout; masked keys contribute
    nothing, and rows whose query is masked are unspecified (mask them
    downstream, as the dense path does)."""
    _check_heads(q, k, v)
    if q.shape[1] % 2:
        raise ValueError(f"zigzag_ring: the local length {q.shape[1]} is "
                         "not two equal half-chunks")
    group, n, m = _seq_axis(mesh, axis_name, batch_axis, head_axis)
    return _RingAttnFn.apply(q, k, v, mask, group, n, m, True, True)
