"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Counterpart of ``deeplearning4j_tpu/ops/pallas_kernels.py``. Kernels:

- :func:`flash_attention` — blockwise online-softmax attention forward
  (``csrc/flash_attention.cu``, replacing the TPU kernel
  ``_flash_kernel``). For a CUDA tensor it launches the kernel; for a
  CPU tensor it runs the plain version, :func:`flash_attention_reference`
  (the port of the JAX ``_reference_scan``). There is no other route: a
  CUDA input the kernel does not take raises.
- :func:`flash_attention_bwd` — the single-pass FlashAttention-2
  backward (``csrc/flash_attention_bwd.cu``, replacing
  ``_flash_bwd_fused_kernel``): dq, dk, dv from q, k, v, the output, its
  gradient and the saved row logsumexp. Its plain version is
  :func:`flash_attention_bwd_reference` (the port of the JAX
  ``_reference_bwd_block``).

:func:`flash_attention` is differentiable: when autograd needs its
gradient it runs through :class:`_FlashAttentionFn`, whose forward calls
the forward kernel with the logsumexp and whose backward calls the
backward kernel (their plain versions for CPU tensors).

The split backward kernels for very long sequences, the ring-composition
entries (``flash_block_fwd``/``flash_block_bwd``) and the threshold
codec come with later slices (``ops/kernel_registry.py`` lists them).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.obs import devtime

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
#: the kernels' fixed tile: 64 query rows by 64 keys
KERNEL_BLOCK = 64

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: library name -> (sources, C entry point, its argtypes)
_LIBS = {
    "flash_attention": (
        ("flash_attention.cu",), "dl4j_flash_attention_fwd",
        [_I, _I] + [_P] * 6 + [_I] * 5 + [_LL] * 9
        + [_I, _I, ctypes.c_float, _P]),
    "flash_attention_bwd": (
        ("flash_attention_bwd.cu",), "dl4j_flash_attention_bwd",
        [_I, _I] + [_P] * 12 + [_I] * 5 + [_LL] * 15
        + [_I, _I, ctypes.c_float, _P]),
}


def _lib(name: str = "flash_attention") -> ctypes.CDLL:
    from deeplearning4j_tpu_torch.ops import cuda_build
    sources, entry, argtypes = _LIBS[name]
    lib = cuda_build.load(name, sources)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        # argtypes last: a thread that sees them set sees the rest set
        lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        msg = ("unsupported dtype or head dim" if err < 0 else
               lib.dl4j_cuda_error_string(err).decode())
        raise RuntimeError(f"{what} kernel launch failed ({err}): {msg}")


def _reference_scan(q, k, v, km=None, offs=None, causal: bool = False,
                    block: int = 512, return_lse: bool = False):
    """Plain blockwise attention (port of ``pallas_kernels.py``
    ``_reference_scan``): a loop over ``block``-key tiles with the same
    online softmax, mask and offset semantics as the kernel. q: [BH, T,
    D]; k, v: [BH, Tk, D] (already expanded to the query heads); km:
    [BH, Tk] key mask (> 0 = attend); offs: ``(q_offset, k_offset)``
    global positions for causal masking. Scores and accumulators are
    f32 (inputs upcast); the output is cast back to q's dtype. Returns
    out [BH, T, D] and, with ``return_lse``, the f32 row logsumexp [BH,
    T, 1] (-inf for a row with no live key)."""
    bh, t, d = q.shape
    tk_real = k.shape[1]
    q_off, k_off = (0, 0) if offs is None else offs
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    qf = q.float()
    q_idx = q_off + torch.arange(t, device=dev)[:, None]
    m = torch.full((bh, t, 1), -math.inf, device=dev)
    l = torch.zeros((bh, t, 1), device=dev)
    acc = torch.zeros((bh, t, d), device=dev)
    for j0 in range(0, tk_real, block):
        kb = k[:, j0:j0 + block].float()
        vb = v[:, j0:j0 + block].float()
        s = torch.einsum("bqd,bkd->bqk", qf, kb) * scale
        kv_idx = j0 + torch.arange(kb.shape[1], device=dev)[None, :]
        mask = torch.ones((bh, 1, kb.shape[1]), dtype=torch.bool,
                          device=dev)
        if km is not None:
            mask = km[:, None, j0:j0 + block] > 0
        if causal:
            mask = mask & (k_off + kv_idx <= q_idx)
        s = s.masked_fill(~mask, -math.inf)
        m_blk = s.amax(dim=-1, keepdim=True)
        m_new = torch.maximum(m, m_blk)
        safe = torch.where(torch.isinf(m_new), torch.zeros_like(m_new),
                           m_new)
        p = torch.where(mask, torch.exp(s - safe), torch.zeros_like(s))
        alpha = torch.where(torch.isinf(m), torch.zeros_like(m),
                            torch.exp(m - safe))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bqk,bkd->bqd", p, vb)
        m = m_new
    den = torch.clamp(l, min=1e-30)
    out = (acc / den).to(q.dtype)
    if return_lse:
        return out, m + torch.log(den)
    return out


def _check_cuda_inputs(q, k, v, mask, block_q, block_k) -> None:
    """Raise on anything the CUDA kernel does not take."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"flash_attention: {name} is on {x.device} "
                             "while q is on the card")
        if x.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} dtype {x.dtype} "
                             f"!= q dtype {q.dtype}")
        if x.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} head dim must be "
                             "contiguous (stride 1)")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention kernel takes float32 or "
                         f"bfloat16, not {q.dtype}")
    d = q.shape[-1]
    if d not in _HEAD_DIMS or k.shape[-1] != d or v.shape[-1] != d:
        raise ValueError(f"flash_attention kernel takes head dim in "
                         f"{_HEAD_DIMS} (q, k, v all alike), got "
                         f"{q.shape[-1]}, {k.shape[-1]}, {v.shape[-1]}")
    if k.shape != v.shape or k.shape[0] != q.shape[0]:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if blk not in (None, KERNEL_BLOCK):
            raise ValueError(f"flash_attention kernel tiles are fixed at "
                             f"{KERNEL_BLOCK}; got {name}={blk}")
    if mask is not None and (not mask.is_cuda
                             or tuple(mask.shape) != (q.shape[0],
                                                      k.shape[1])):
        raise ValueError(f"flash_attention: mask must be a [B, Tk] CUDA "
                         f"tensor, got {tuple(mask.shape)} on "
                         f"{mask.device}")


def _flash_cuda(q, k, v, mask, causal: bool, q_off: int,
                return_lse: bool):
    b, t, h, d = q.shape
    tk, h_kv = k.shape[1], k.shape[2]
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if t == 0:
        return out, lse
    km = None if mask is None else mask.to(torch.float32).contiguous()
    lib = _lib()
    # the stream of the CALLING thread (the gateway steps the scheduler
    # on its own worker thread)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.dl4j_flash_attention_fwd(
        _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), None if km is None else km.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(),
        b, t, tk, h, h_kv,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(causal), int(q_off), 1.0 / math.sqrt(d), stream)
    _raise_on(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, causal: bool = False,
                    mask: Optional[torch.Tensor] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    return_lse: bool = False):
    """Blockwise attention, [B, T, H, D] layout (head axis 2) like
    ``scaled_dot_attention``; ``mask``: optional [B, Tk] key mask.
    ``k``/``v`` may carry FEWER heads than ``q`` (grouped-query
    attention, H divisible by Hkv): query head h reads kv head
    h // (H / Hkv). Tq and Tk may differ; causal then masks against the
    END-ALIGNED diagonal (query row i attends keys ≤ i + Tk − Tq). A
    row with no live key returns zeros.

    A CUDA tensor launches the CUDA kernel (tiles fixed at 64: pass
    ``block_q``/``block_k`` only as None or 64). A CPU tensor runs the
    plain :func:`flash_attention_reference` (``block_k`` its key tile,
    default 512). ``return_lse`` also returns the f32 row logsumexp
    [B, H, Tq] (no gradient). Differentiable in q, k and v: when autograd
    needs the gradient the call runs through :class:`_FlashAttentionFn`
    (forward kernel with lse, backward kernel)."""
    t, h, h_kv = q.shape[1], q.shape[2], k.shape[2]
    if h % h_kv:
        raise ValueError(f"q heads ({h}) not divisible by kv heads "
                         f"({h_kv})")
    with devtime.scope("ops.flash_attention"):
        if q.is_cuda:
            _check_cuda_inputs(q, k, v, mask, block_q, block_k)
        if (not return_lse and torch.is_grad_enabled()
                and (q.requires_grad or k.requires_grad
                     or v.requires_grad)):
            return _FlashAttentionFn.apply(q, k, v, mask, causal,
                                           block_k or 512)
        if not q.is_cuda:
            return flash_attention_reference(q, k, v, causal, mask,
                                             block_k or 512, return_lse)
        out, lse = _flash_cuda(q, k, v, mask, causal,
                               k.shape[1] - t if causal else 0,
                               return_lse)
        return (out, lse) if return_lse else out


def flash_attention_reference(q, k, v, causal: bool = False, mask=None,
                              block_k: int = 512,
                              return_lse: bool = False):
    """The plain version of :func:`flash_attention` on any device:
    the same [B, T, H, D] arguments, folded to [B·H, T, D] rows (kv rows
    repeated per head group, the key mask per head) and run through
    :func:`_reference_scan`."""
    b, t, h, d = q.shape
    groups = h // k.shape[2]
    q_off = k.shape[1] - t if causal else 0
    fold = lambda x: x.permute(0, 2, 1, 3).reshape(
        b * x.shape[2], x.shape[1], d)
    expand = lambda x: x.repeat_interleave(groups, dim=0)
    km = (None if mask is None
          else mask.to(torch.float32).repeat_interleave(h, dim=0))
    res = _reference_scan(fold(q), expand(fold(k)), expand(fold(v)), km,
                          (q_off, 0), causal, block=block_k,
                          return_lse=return_lse)
    out, lse = res if return_lse else (res, None)
    out = out.reshape(b, h, t, d).permute(0, 2, 1, 3)
    return (out, lse.reshape(b, h, t)) if return_lse else out


class _FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention (the port of the JAX ``_flash``
    custom vjp). The forward runs the forward kernel with the row
    logsumexp and saves ``q, k, v, out, lse`` — never the probabilities;
    the backward runs :func:`flash_attention_bwd` on them. CPU tensors
    take the plain versions of both."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, block_k):
        if q.is_cuda:
            out, lse = _flash_cuda(q, k, v, mask, causal,
                                   k.shape[1] - q.shape[1] if causal
                                   else 0, True)
        else:
            out, lse = flash_attention_reference(q, k, v, causal, mask,
                                                 block_k, True)
        ctx.save_for_backward(q, k, v, out, lse, mask)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, mask = ctx.saved_tensors
        # autograd's cotangent may come out of a reshape or permute: the
        # kernel reads dO through strides but needs the head dim dense
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(),
                                         causal=ctx.causal, mask=mask)
        return dq, dk, dv, None, None, None


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = False,
                        mask: Optional[torch.Tensor] = None):
    """Gradients (dq, dk, dv) of :func:`flash_attention` given its output
    ``out`` [B, Tq, H, D], the f32 row logsumexp ``lse`` [B, H, Tq] it
    returned and the output's gradient ``dout``; ``k``/``v``
    [B, Tk, Hkv, D] (GQA: dk/dv are summed over each kv head's query
    heads). A CUDA tensor launches the CUDA kernel; a CPU tensor runs
    :func:`flash_attention_bwd_reference`."""
    with devtime.scope("ops.flash_attention_bwd"):
        if not q.is_cuda:
            return flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                                 causal, mask)
        _check_cuda_inputs(q, k, v, mask, None, None)
        b, t, h, d = q.shape
        for name, x in (("out", out), ("dout", dout)):
            if (not x.is_cuda or x.dtype != q.dtype
                    or x.shape != q.shape or x.stride(-1) != 1):
                raise ValueError(
                    f"flash_attention_bwd: {name} must be a CUDA "
                    f"{q.dtype} tensor shaped like q {tuple(q.shape)} "
                    f"with a dense head dim, got {tuple(x.shape)} "
                    f"{x.dtype} on {x.device}")
        if (not lse.is_cuda or lse.dtype != torch.float32
                or tuple(lse.shape) != (b, h, t)
                or not lse.is_contiguous()):
            raise ValueError(f"flash_attention_bwd: lse must be a "
                             f"contiguous CUDA float32 [{b}, {h}, {t}] "
                             f"tensor, got {tuple(lse.shape)} "
                             f"{lse.dtype} on {lse.device}")
        return _flash_bwd_cuda(q, k, v, out, lse, dout, mask, causal)


def _flash_bwd_cuda(q, k, v, out, lse, dout, mask, causal: bool):
    b, t, h, d = q.shape
    tk, h_kv = k.shape[1], k.shape[2]
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, h_kv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, tk, h_kv, d), dtype=v.dtype, device=q.device)
    if t == 0 or tk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # scratch: dq accumulates in f32 across key tiles, Delta per row
    dq_acc = torch.empty((b, t, h, d), dtype=torch.float32,
                         device=q.device)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    km = None if mask is None else mask.to(torch.float32).contiguous()
    lib = _lib("flash_attention_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.dl4j_flash_attention_bwd(
        _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        None if km is None else km.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dq_acc.data_ptr(),
        delta.data_ptr(), b, t, tk, h, h_kv,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        dout.stride(0), dout.stride(1), dout.stride(2),
        int(causal), tk - t if causal else 0, 1.0 / math.sqrt(d), stream)
    _raise_on(lib, err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                  causal: bool = False, mask=None):
    """The plain version of :func:`flash_attention_bwd` on any device —
    the port of the JAX ``_reference_bwd_block`` on [B, T, H, D]: the
    kv heads repeated per head group, the whole [Tq, Tk] probability
    matrix recomputed in f32 from the logsumexp (lse taken as 0 where it
    is not finite), dk/dv summed back onto the kv heads. O(Tq·Tk)
    memory: for tests and the card's comparison only."""
    b, t, h, d = q.shape
    tk, h_kv = k.shape[1], k.shape[2]
    groups = h // h_kv
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    fold = lambda x: x.permute(0, 2, 1, 3).reshape(
        b * x.shape[2], x.shape[1], d).float()
    expand = lambda x: x.repeat_interleave(groups, dim=0)
    qf, of, gf = fold(q), fold(out), fold(dout)
    kf, vf = expand(fold(k)), expand(fold(v))
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    live = torch.ones((1, t, tk), dtype=torch.bool, device=dev)
    if mask is not None:
        live = mask.to(torch.float32).repeat_interleave(
            h, dim=0)[:, None, :] > 0
    if causal:
        q_idx = (tk - t) + torch.arange(t, device=dev)[:, None]
        live = live & (torch.arange(tk, device=dev)[None, :] <= q_idx)
    lse3 = lse.reshape(b * h, t, 1)
    lse_safe = torch.where(torch.isfinite(lse3), lse3,
                           torch.zeros_like(lse3))
    p = torch.where(live, torch.exp(s - lse_safe), torch.zeros_like(s))
    delta = (gf * of).sum(-1, keepdim=True)
    dp = torch.einsum("bqd,bkd->bqk", gf, vf)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bqk,bkd->bqd", ds, kf)
    dk = torch.einsum("bqk,bqd->bkd", ds, qf)
    dv = torch.einsum("bqk,bqd->bkd", p, gf)
    reduce = lambda x: x.reshape(b * h_kv, groups, tk, d).sum(1)
    unfold = lambda x, heads, n: x.reshape(b, heads, n, d).permute(
        0, 2, 1, 3).contiguous()
    return (unfold(dq, h, t).to(q.dtype),
            unfold(reduce(dk), h_kv, tk).to(k.dtype),
            unfold(reduce(dv), h_kv, tk).to(v.dtype))


#: launches of the CUDA kernels (the counts the smoke run reads)
flash_attention.launches = 0
flash_attention_bwd.launches = 0
