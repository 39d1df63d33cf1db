"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Counterpart of ``deeplearning4j_tpu/ops/pallas_kernels.py``. Kernels:

- :func:`flash_attention` — blockwise online-softmax attention forward
  (``csrc/flash_attention.cu``, replacing the TPU kernel
  ``_flash_kernel``). For a CUDA tensor it launches the kernel; for a
  CPU tensor it runs the plain version, :func:`flash_attention_reference`
  (the port of the JAX ``_reference_scan``). There is no other route: a
  CUDA input the kernel does not take raises. The C entry picks the
  kernel by dtype: bf16 runs the tensor-core loop of
  ``csrc/flash_mma.cuh`` (``mma.sync`` on bf16 tiles loaded by
  ``cp.async``, P rounded to bf16 before P·V as the TPU kernel rounds
  it), f32 the CUDA-core kernel, f32 throughout.
- :func:`flash_attention_bwd` — the backward: dq, dk, dv from q, k, v,
  the output, its gradient and the saved row logsumexp. It makes the
  JAX ``_flash_bwd``'s choice on the same padded shapes
  (``_FUSED_BWD_DQ_VMEM``): the single-pass FlashAttention-2 backward
  (``csrc/flash_attention_bwd.cu``, replacing
  ``_flash_bwd_fused_kernel``; plain version
  :func:`flash_attention_bwd_reference`, the port of the JAX
  ``_reference_bwd_block``) up to ~24k query rows, past that the split
  pair of ``csrc/flash_attention_bwd_split.cu``:
  :func:`flash_attention_bwd_dq` (replacing ``_flash_bwd_dq_kernel``;
  bf16 on the same query-stationary tensor-core loop as the forward, dS
  rounded to bf16 before dS·K) and :func:`flash_attention_bwd_dkv`
  (replacing ``_flash_bwd_dkv_kernel``), with the blockwise plain
  versions :func:`flash_attention_bwd_dq_reference` and
  :func:`flash_attention_bwd_dkv_reference`. The fused kernel and the
  dk/dv pass share the key-stationary tensor-core loop of
  ``csrc/flash_mma.cuh`` in bf16 (P and dS rounded to bf16 before Pᵀ·dO,
  dSᵀ·Q and dS·K); every backward kernel runs f32 inputs on the CUDA
  cores, f32 throughout.

- :func:`threshold_encode` and :func:`threshold_decode` — the codec of
  the packed gradient exchange (``csrc/threshold_codec.cu``, replacing
  ``_encode_kernel`` and ``_decode_kernel``): 16 two-bit codes per int32
  word, the JAX entries' word count and bit layout, with the plain
  versions :func:`threshold_encode_reference` and
  :func:`threshold_decode_reference` (the ports of
  ``_jnp_threshold_encode``/``_jnp_threshold_decode``, on the flat
  layout).

:func:`flash_attention` is differentiable: when autograd needs its
gradient it runs through :class:`_FlashAttentionFn`, whose forward calls
the forward kernel with the logsumexp and whose backward calls
:func:`flash_attention_bwd` (the plain versions for CPU tensors).

The ring-composition entries (``flash_block_fwd``/``flash_block_bwd``)
come with the sequence-parallel slice (``ops/kernel_registry.py`` lists
the kernels they reach).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from deeplearning4j_tpu_torch.obs import devtime

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
#: the kernels' fixed tile: 64 query rows by 64 keys
KERNEL_BLOCK = 64

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
#: library name -> (sources, {C entry point: its argtypes})
_LIBS = {
    "flash_attention": (("flash_attention.cu",), {
        "dl4j_flash_attention_fwd":
            [_I, _I] + [_P] * 6 + [_I] * 5 + [_LL] * 9 + [_I, _I, _F, _P]}),
    "flash_attention_bwd": (("flash_attention_bwd.cu",), {
        "dl4j_flash_attention_bwd":
            [_I, _I] + [_P] * 12 + [_I] * 5 + [_LL] * 15
            + [_I, _I, _F, _P]}),
    "flash_attention_bwd_split": (("flash_attention_bwd_split.cu",), {
        "dl4j_flash_attention_bwd_delta":
            [_I, _I] + [_P] * 3 + [_I] * 3 + [_LL] * 6 + [_P],
        "dl4j_flash_attention_bwd_dq":
            [_I, _I] + [_P] * 8 + [_I] * 5 + [_LL] * 12
            + [_I] * 3 + [_F, _P],
        "dl4j_flash_attention_bwd_dkv":
            [_I, _I] + [_P] * 9 + [_I] * 5 + [_LL] * 12
            + [_I] * 3 + [_F, _P]}),
    "threshold_codec": (("threshold_codec.cu",), {
        "dl4j_threshold_encode": [_P] * 4 + [_LL, _LL, _P],
        "dl4j_threshold_decode": [_P] * 3 + [_LL, _P]}),
    # K6 and K9, bound in ops/fused_norms.py
    "norm_bwd": (("norm_bwd.cu",), {
        "dl4j_norm_bwd_grid": [_I] * 4 + [_P],
        "dl4j_norm_bwd": [_I] * 4 + [_P] * 7 + [_LL, _I, _F, _I, _I, _P]}),
}


def _lib(name: str = "flash_attention") -> ctypes.CDLL:
    from deeplearning4j_tpu_torch.ops import cuda_build
    sources, entries = _LIBS[name]
    lib = cuda_build.load(name, sources)
    if getattr(lib, list(entries)[-1]).argtypes is None:
        lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
        # the last entry's argtypes last: a thread that sees them set
        # sees the rest set
        for entry, argtypes in entries.items():
            fn = getattr(lib, entry)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
    return lib


def _raise_on(lib, err: int, what: str,
              refused: str = "unsupported dtype or head dim") -> None:
    if err:
        msg = (refused if err < 0 else
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


#: the fused backward's full-length dq scratch budget in f32 bytes, the
#: JAX package's ``_FUSED_BWD_DQ_VMEM`` (``pallas_kernels.py:557``): past
#: it :func:`flash_attention_bwd` takes the split pair K4 + K5, as the JAX
#: ``_flash_bwd`` does (at head dim <= 128, past 24 576 query rows)
_FUSED_BWD_DQ_VMEM = 12 * 1024 * 1024
#: the JAX ``flash_attention``'s default query block
_JAX_BLOCK_Q = 1024


def _flash_blocks(tq_real: int, d: int):
    """The query side of the JAX ``_flash_blocks`` padding at the JAX
    ``flash_attention``'s default query block (its Mosaic clamp of the
    key block left out): the query block, the padded query length and
    the 128-lane head dim."""
    block_q = min(_JAX_BLOCK_Q, -(-tq_real // 128) * 128)
    tq = -(-tq_real // block_q) * block_q
    dp = max(-(-d // 128) * 128, 128)
    return block_q, tq, dp


def _split_bwd(tq: int, d: int) -> bool:
    """Whether the backward over ``tq`` query rows at head dim ``d``
    takes the split pair (K4, K5) rather than the fused K3: the JAX
    ``_flash_bwd``'s test ``tq · dp · 4 <= _FUSED_BWD_DQ_VMEM``
    (``pallas_kernels.py:621``) on the same padded shapes, negated."""
    if tq == 0:
        return False
    _, tq_pad, dp = _flash_blocks(tq, d)
    return tq_pad * dp * 4 > _FUSED_BWD_DQ_VMEM


def _check_bwd_inputs(q, k, v, out, lse, dout, mask, delta=None) -> None:
    """Raise on anything the backward kernels do not take."""
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
    for name, x in (("lse", lse), ("delta", delta)):
        if x is not None and (not x.is_cuda or x.dtype != torch.float32
                              or tuple(x.shape) != (b, h, t)
                              or not x.is_contiguous()):
            raise ValueError(f"flash_attention_bwd: {name} must be a "
                             f"contiguous CUDA float32 [{b}, {h}, {t}] "
                             f"tensor, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = False,
                        mask: Optional[torch.Tensor] = None):
    """Gradients (dq, dk, dv) of :func:`flash_attention` given its output
    ``out`` [B, Tq, H, D], the f32 row logsumexp ``lse`` [B, H, Tq] it
    returned and the output's gradient ``dout``; ``k``/``v``
    [B, Tk, Hkv, D] (GQA: dk/dv are summed over each kv head's query
    heads).

    The JAX ``_flash_bwd``'s choice of kernels, made first: the fused
    K3 while its full-length dq scratch fits in ``_FUSED_BWD_DQ_VMEM``
    (:func:`_split_bwd`), else the split pair — one Delta pre-pass, then
    :func:`flash_attention_bwd_dq` (K4) and
    :func:`flash_attention_bwd_dkv` (K5). A CUDA tensor launches the
    picked kernels; a CPU tensor runs their plain versions
    (:func:`flash_attention_bwd_reference`, or the split pair's)."""
    with devtime.scope("ops.flash_attention_bwd"):
        if q.is_cuda:
            _check_bwd_inputs(q, k, v, out, lse, dout, mask)
        if _split_bwd(q.shape[1], q.shape[-1]):
            delta = (_flash_delta_cuda(out, dout) if q.is_cuda
                     else _delta_reference(out, dout))
            dq = flash_attention_bwd_dq(q, k, v, out, lse, dout, causal,
                                        mask, delta=delta)
            dk, dv = flash_attention_bwd_dkv(q, k, v, out, lse, dout,
                                             causal, mask, delta=delta)
            return dq, dk, dv
        if not q.is_cuda:
            return flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                                 causal, mask)
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


def _offsets(tq: int, tk: int, causal: bool, offsets):
    """The causal offsets ``(q_off, k_off)``: given, or the end-aligned
    ``(Tk − Tq, 0)``."""
    if offsets is not None:
        return int(offsets[0]), int(offsets[1])
    return (tk - tq, 0) if causal else (0, 0)


def _flash_delta_cuda(out, dout):
    """Delta = rowsum(dO ∘ O) in f32, [B, H, Tq], by the split library's
    pre-pass kernel (read by K4 and K5)."""
    b, t, h, d = out.shape
    delta = torch.empty((b, h, t), dtype=torch.float32, device=out.device)
    if delta.numel():
        lib = _lib("flash_attention_bwd_split")
        err = lib.dl4j_flash_attention_bwd_delta(
            _DTYPE_CODES[out.dtype], d, out.data_ptr(), dout.data_ptr(),
            delta.data_ptr(), b, t, h, out.stride(0), out.stride(1),
            out.stride(2), dout.stride(0), dout.stride(1), dout.stride(2),
            torch.cuda.current_stream(out.device).cuda_stream)
        _raise_on(lib, err, "flash_attention_bwd delta")
    return delta


def _delta_reference(out, dout):
    """The plain Delta = rowsum(dO ∘ O) in f32, [B, H, Tq]."""
    return (dout.float() * out.float()).sum(-1).permute(0, 2, 1) \
        .contiguous()


def _split_launch(entry: str, q, k, v, out, lse, dout, causal, mask,
                  offsets, delta, outputs) -> None:
    """Launch K4 (``outputs`` = (dq,)) or K5 (``outputs`` = (dk, dv))."""
    b, t, h, d = q.shape
    tk, h_kv = k.shape[1], k.shape[2]
    if delta is None:
        delta = _flash_delta_cuda(out, dout)
    km = None if mask is None else mask.to(torch.float32).contiguous()
    q_off, k_off = _offsets(t, tk, causal, offsets)
    lib = _lib("flash_attention_bwd_split")
    err = getattr(lib, entry)(
        _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        None if km is None else km.data_ptr(),
        *(x.data_ptr() for x in outputs), b, t, tk, h, h_kv,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        dout.stride(0), dout.stride(1), dout.stride(2),
        int(causal), q_off, k_off, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, entry)


def flash_attention_bwd_dq(q, k, v, out, lse, dout, causal: bool = False,
                           mask: Optional[torch.Tensor] = None,
                           offsets=None, delta=None):
    """dq of :func:`flash_attention` by the split dq pass (K4,
    ``csrc/flash_attention_bwd_split.cu``, replacing
    ``_flash_bwd_dq_kernel``): the arguments of
    :func:`flash_attention_bwd`, plus the causal ``offsets`` ``(q_off,
    k_off)`` (row i sees key j when k_off + j ≤ q_off + i; default the
    end-aligned ``(Tk − Tq, 0)``) and ``delta``, rowsum(dO ∘ O) as f32
    [B, H, Tq] (computed here when None). No atomics: dq is the same to
    the bit from run to run. A CPU tensor runs
    :func:`flash_attention_bwd_dq_reference`."""
    with devtime.scope("ops.flash_attention_bwd_dq"):
        if not q.is_cuda:
            return flash_attention_bwd_dq_reference(
                q, k, v, out, lse, dout, causal, mask, offsets, delta)
        _check_bwd_inputs(q, k, v, out, lse, dout, mask, delta)
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        if q.shape[1] == 0 or k.shape[1] == 0:
            return dq.zero_()
        _split_launch("dl4j_flash_attention_bwd_dq", q, k, v, out, lse,
                      dout, causal, mask, offsets, delta, (dq,))
        flash_attention_bwd_dq.launches += 1
        return dq


def flash_attention_bwd_dkv(q, k, v, out, lse, dout, causal: bool = False,
                            mask: Optional[torch.Tensor] = None,
                            offsets=None, delta=None):
    """(dk, dv) of :func:`flash_attention` by the split dk/dv pass (K5,
    ``csrc/flash_attention_bwd_split.cu``, replacing
    ``_flash_bwd_dkv_kernel``): the arguments of
    :func:`flash_attention_bwd_dq`. dk/dv [B, Tk, Hkv, D] come out summed
    over each kv head's query heads, in a fixed order. A CPU tensor runs
    :func:`flash_attention_bwd_dkv_reference`."""
    with devtime.scope("ops.flash_attention_bwd_dkv"):
        if not q.is_cuda:
            return flash_attention_bwd_dkv_reference(
                q, k, v, out, lse, dout, causal, mask, offsets, delta)
        _check_bwd_inputs(q, k, v, out, lse, dout, mask, delta)
        dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
        dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        if q.shape[1] == 0 or k.shape[1] == 0:
            return dk.zero_(), dv.zero_()
        _split_launch("dl4j_flash_attention_bwd_dkv", q, k, v, out, lse,
                      dout, causal, mask, offsets, delta, (dk, dv))
        flash_attention_bwd_dkv.launches += 1
        return dk, dv


class _Rows(NamedTuple):
    """The split plain versions' operands as f32 [B·H, T, ·] rows: q, dO,
    k and v (kv rows repeated per head group), the key mask per row or
    None, lse (0 where not finite) and Delta as [B·H, Tq, 1]."""
    q: torch.Tensor
    g: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    km: Optional[torch.Tensor]
    lse: torch.Tensor
    delta: torch.Tensor


def _rows(q, k, v, out, lse, dout, mask, delta) -> _Rows:
    b, t, h, d = q.shape
    groups = h // k.shape[2]
    fold = lambda x: x.permute(0, 2, 1, 3).reshape(
        b * x.shape[2], x.shape[1], d).float()
    expand = lambda x: fold(x).repeat_interleave(groups, dim=0)
    lse3 = lse.reshape(b * h, t, 1)
    if delta is None:
        delta = _delta_reference(out, dout)
    km = (None if mask is None
          else mask.to(torch.float32).repeat_interleave(h, dim=0))
    return _Rows(fold(q), fold(dout), expand(k), expand(v), km,
                 torch.where(torch.isfinite(lse3), lse3,
                             torch.zeros_like(lse3)),
                 delta.reshape(b * h, t, 1).float())


def _tile_p_ds(r: _Rows, i0: int, i1: int, j0: int, j1: int,
               causal: bool, q_off: int, k_off: int, scale: float):
    """p and ds = p ∘ (dp − Δ) for query rows i0:i1 and keys j0:j1 (the
    JAX ``_flash_bwd_p_ds``, in f32)."""
    dev = r.q.device
    s = torch.einsum("bqd,bkd->bqk", r.q[:, i0:i1], r.k[:, j0:j1]) * scale
    live = torch.ones((1, i1 - i0, j1 - j0), dtype=torch.bool, device=dev)
    if r.km is not None:
        live = r.km[:, None, j0:j1] > 0
    if causal:
        q_idx = q_off + torch.arange(i0, i1, device=dev)[:, None]
        k_idx = k_off + torch.arange(j0, j1, device=dev)[None, :]
        live = live & (k_idx <= q_idx)
    p = torch.where(live, torch.exp(s - r.lse[:, i0:i1]),
                    torch.zeros_like(s))
    dp = torch.einsum("bqd,bkd->bqk", r.g[:, i0:i1], r.v[:, j0:j1])
    return p, p * (dp - r.delta[:, i0:i1])


def _unfold(x, b: int, heads: int, dtype):
    """[B·heads, T, D] rows back to [B, T, heads, D] in ``dtype``."""
    n, d = x.shape[1], x.shape[2]
    return x.reshape(b, heads, n, d).permute(0, 2, 1, 3).contiguous() \
        .to(dtype)


def _reduce_kv(x, b: int, h: int, h_kv: int):
    """Per-query-head kv gradients [B·H, Tk, D] summed onto their kv
    heads [B·Hkv, Tk, D] (the JAX ``_reduce_kv_rows``)."""
    return x.reshape(b * h_kv, h // h_kv, *x.shape[1:]).sum(1)


def flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                  causal: bool = False, mask=None):
    """The plain version of :func:`flash_attention_bwd`'s fused kernel
    on any device — the port of the JAX ``_reference_bwd_block`` on
    [B, T, H, D]: the kv heads repeated per head group, the whole
    [Tq, Tk] probability matrix recomputed in f32 from the logsumexp
    (lse taken as 0 where it is not finite), dk/dv summed back onto the
    kv heads. O(Tq·Tk) memory: for tests and the card's comparison only
    (the split pair's plain versions are blockwise)."""
    b, t, h, d = q.shape
    tk, h_kv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    r = _rows(q, k, v, out, lse, dout, mask, None)
    p, ds = _tile_p_ds(r, 0, t, 0, tk, causal,
                       *_offsets(t, tk, causal, None), scale)
    dq = torch.einsum("bqk,bkd->bqd", ds, r.k) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, r.q) * scale
    dv = torch.einsum("bqk,bqd->bkd", p, r.g)
    return (_unfold(dq, b, h, q.dtype),
            _unfold(_reduce_kv(dk, b, h, h_kv), b, h_kv, k.dtype),
            _unfold(_reduce_kv(dv, b, h, h_kv), b, h_kv, v.dtype))


def flash_attention_bwd_dq_reference(q, k, v, out, lse, dout,
                                     causal: bool = False, mask=None,
                                     offsets=None, delta=None,
                                     block: int = 512):
    """The plain version of :func:`flash_attention_bwd_dq` on any device,
    the port of the JAX dq pass: for each ``block``-row query tile, a
    loop over ``block``-key tiles up to the causal diagonal, p
    recomputed in f32 from the logsumexp, dq accumulated in f32 and
    scaled once. O(B·H·T·block) memory."""
    b, t, h, d = q.shape
    tk = k.shape[1]
    q_off, k_off = _offsets(t, tk, causal, offsets)
    scale = 1.0 / math.sqrt(d)
    r = _rows(q, k, v, out, lse, dout, mask, delta)
    dq = torch.zeros_like(r.q)
    for i0 in range(0, t, block):
        i1 = min(i0 + block, t)
        for j0 in range(0, tk, block):
            if causal and k_off + j0 > q_off + i1 - 1:
                break                    # past the diagonal
            j1 = min(j0 + block, tk)
            _, ds = _tile_p_ds(r, i0, i1, j0, j1, causal, q_off, k_off,
                               scale)
            dq[:, i0:i1] += torch.einsum("bqk,bkd->bqd", ds, r.k[:, j0:j1])
    return _unfold(dq * scale, b, h, q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, out, lse, dout,
                                      causal: bool = False, mask=None,
                                      offsets=None, delta=None,
                                      block: int = 512):
    """The plain version of :func:`flash_attention_bwd_dkv` on any
    device, the port of the JAX dk/dv pass: for each ``block``-key tile,
    a loop over ``block``-row query tiles from the causal diagonal on,
    dv += pᵀ·dO and dk += dsᵀ·q in f32 per query head, dk scaled once,
    then both summed onto the kv heads (``_reduce_kv_rows``).
    O(B·H·T·block) memory."""
    b, t, h, d = q.shape
    tk, h_kv = k.shape[1], k.shape[2]
    q_off, k_off = _offsets(t, tk, causal, offsets)
    scale = 1.0 / math.sqrt(d)
    r = _rows(q, k, v, out, lse, dout, mask, delta)
    dk, dv = torch.zeros_like(r.k), torch.zeros_like(r.v)
    for j0 in range(0, tk, block):
        j1 = min(j0 + block, tk)
        first = max(0, j0 + k_off - q_off) if causal else 0
        for i0 in range(first // block * block, t, block):
            i1 = min(i0 + block, t)
            p, ds = _tile_p_ds(r, i0, i1, j0, j1, causal, q_off, k_off,
                               scale)
            dv[:, j0:j1] += torch.einsum("bqk,bqd->bkd", p, r.g[:, i0:i1])
            dk[:, j0:j1] += torch.einsum("bqk,bqd->bkd", ds, r.q[:, i0:i1])
    return (_unfold(_reduce_kv(dk * scale, b, h, h_kv), b, h_kv, k.dtype),
            _unfold(_reduce_kv(dv, b, h, h_kv), b, h_kv, v.dtype))


# ---------------------------------------------------------------------------
# threshold compression codec
# ---------------------------------------------------------------------------
_GROUP = 16          # 16 two-bit codes per int32 word
#: the JAX entries' grid block width, which rounds the word count up
_BLOCK_COLS = 32768
_CODEC_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def threshold_words(size: int) -> int:
    """The packed word count C for ``size`` elements, the JAX
    ``threshold_encode``'s: ceil(size / 16) rounded up to 128 lanes, then
    to a multiple of ``min(C, 32768)``. It fixes the bytes on the wire,
    so the two packages send the same number of words."""
    c = -(-size // _GROUP)
    c = -(-c // 128) * 128
    if c == 0:
        return 0
    bc = min(c, _BLOCK_COLS)
    return -(-c // bc) * bc


def _tau(tau, device) -> torch.Tensor:
    """τ as a one-element f32 tensor on ``device``: a tensor stays where
    it lives when that is ``device`` (the kernels read it there; no host
    read), a Python number is copied over."""
    t = torch.as_tensor(tau, dtype=torch.float32, device=device)
    if t.numel() != 1:
        raise ValueError(f"tau must hold one value, got shape "
                         f"{tuple(t.shape)}")
    return t.reshape(1)


def threshold_encode_reference(grad, tau):
    """The plain version of :func:`threshold_encode` on any device, the
    port of the JAX ``_jnp_threshold_encode`` on the flat layout: the
    grad cast to f32 and zero-padded to ``16 · C`` elements, row c of the
    [C, 16] view packed into word c."""
    shape, size = tuple(grad.shape), grad.numel()
    n_words = threshold_words(size)
    g = grad.reshape(-1).to(torch.float32)
    t = _tau(tau, g.device)[0]
    flat = torch.zeros(n_words * _GROUP, dtype=torch.float32,
                       device=g.device)
    flat[:size] = g
    g2 = flat.reshape(n_words, _GROUP)
    pos, neg = g2 > t, g2 < -t
    code = torch.where(pos, 1, torch.where(neg, 2, 0)).to(torch.int64)
    q = torch.where(pos, t, torch.where(neg, -t, 0.0))
    shifts = 2 * torch.arange(_GROUP, device=g.device)
    word = (code << shifts).sum(-1)               # < 2^32, as uint32
    packed = torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(
        torch.int32)
    resid = (g2 - q).reshape(-1)[:size].reshape(shape)
    return packed, resid


def threshold_decode_reference(packed, tau, size: int, shape=None):
    """The plain version of :func:`threshold_decode` on any device, the
    port of the JAX ``_jnp_threshold_decode`` on the flat layout."""
    words = packed.reshape(-1)[:-(-size // _GROUP)].to(torch.int64) \
        & 0xFFFFFFFF
    t = _tau(tau, packed.device)[0]
    shifts = 2 * torch.arange(_GROUP, device=packed.device)
    code = (words[:, None] >> shifts) & 3
    out = torch.where(code == 1, t, torch.where(code == 2, -t, 0.0))
    dense = out.reshape(-1)[:size]
    return dense.reshape(shape) if shape is not None else dense


def threshold_encode(grad, tau):
    """Fused threshold encode (K10, ``csrc/threshold_codec.cu``,
    replacing ``_encode_kernel``): grad → (packed int32 codes [C],
    residual f32 in grad's shape). q = τ·sign(g)·1[|g| > τ]; 2 bits an
    element (code 0, +τ = 1, −τ = 2), residual = g − q; C is
    :func:`threshold_words`, the padding words 0. ``tau``: a one-element
    tensor (read on the card, no host sync) or a number. A CUDA grad
    launches the kernel; a CPU grad runs
    :func:`threshold_encode_reference`."""
    with devtime.scope("ops.threshold_encode"):
        if not grad.is_cuda:
            return threshold_encode_reference(grad, tau)
        if grad.dtype not in _CODEC_FLOATS:
            raise ValueError(f"threshold_encode takes a float grad, not "
                             f"{grad.dtype}")
        shape, size = tuple(grad.shape), grad.numel()
        n_words = threshold_words(size)
        g = grad.reshape(-1).to(torch.float32).contiguous()
        t = _tau(tau, g.device)
        packed = torch.empty(n_words, dtype=torch.int32, device=g.device)
        resid = torch.empty(size, dtype=torch.float32, device=g.device)
        if n_words:
            lib = _lib("threshold_codec")
            err = lib.dl4j_threshold_encode(
                g.data_ptr(), t.data_ptr(), packed.data_ptr(),
                resid.data_ptr(), size, n_words,
                torch.cuda.current_stream(g.device).cuda_stream)
            _raise_on(lib, err, "threshold_encode", "grid too large")
            threshold_encode.launches += 1
        return packed, resid.reshape(shape)


def threshold_decode(packed, tau, size: int, shape=None):
    """Threshold decode (K11, ``csrc/threshold_codec.cu``, replacing
    ``_decode_kernel``): the first ``size`` codes of ``packed`` (int32,
    at least ceil(size / 16) words) → dense f32 ±τ/0, shaped ``shape``
    when given. A CUDA ``packed`` launches the kernel; a CPU one runs
    :func:`threshold_decode_reference`."""
    with devtime.scope("ops.threshold_decode"):
        if not packed.is_cuda:
            return threshold_decode_reference(packed, tau, size, shape)
        if (packed.dtype != torch.int32 or packed.dim() != 1
                or packed.numel() * _GROUP < size
                or not packed.is_contiguous()):
            raise ValueError(
                f"threshold_decode takes a contiguous int32 [C] tensor "
                f"with C >= ceil({size} / 16), got {packed.dtype} "
                f"{tuple(packed.shape)}")
        t = _tau(tau, packed.device)
        out = torch.empty(size, dtype=torch.float32, device=packed.device)
        if size:
            lib = _lib("threshold_codec")
            err = lib.dl4j_threshold_decode(
                packed.data_ptr(), t.data_ptr(), out.data_ptr(), size,
                torch.cuda.current_stream(packed.device).cuda_stream)
            _raise_on(lib, err, "threshold_decode", "grid too large")
            threshold_decode.launches += 1
        return out.reshape(shape) if shape is not None else out


#: launches of the CUDA kernels (the counts the smoke run reads)
flash_attention.launches = 0
flash_attention_bwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
threshold_encode.launches = 0
threshold_decode.launches = 0
