"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Counterpart of ``deeplearning4j_tpu/ops/pallas_kernels.py``. Kernels:

- :func:`flash_attention` — blockwise online-softmax attention forward
  (``csrc/flash_attention.cu``, replacing the TPU kernel
  ``_flash_kernel``). For a CUDA tensor it launches the kernel; for a
  CPU tensor it runs the plain version, :func:`flash_attention_reference`
  (the port of the JAX ``_reference_scan``). There is no other route: a
  CUDA input the kernel does not take raises.

The backward kernels, the ring-composition entries
(``flash_block_fwd``/``flash_block_bwd``) and the threshold codec come
with later slices (``ops/kernel_registry.py`` lists them).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.obs import devtime

_LIB_NAME = "flash_attention"
_SOURCES = ("flash_attention.cu",)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
#: the kernel's fixed tile: 64 query rows per block, 64-key tiles
KERNEL_BLOCK = 64


def _lib() -> ctypes.CDLL:
    from deeplearning4j_tpu_torch.ops import cuda_build
    lib = cuda_build.load(_LIB_NAME, _SOURCES)
    fn = lib.dl4j_flash_attention_fwd
    if fn.argtypes is None:
        # argtypes last: a thread that sees them set sees the rest set
        lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
        fn.restype = ctypes.c_int
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([i, i, p, p, p, p, p, p, i, i, i, i, i]
                       + [ll] * 9 + [i, i, ctypes.c_float, p])
    return lib


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
    if err:
        msg = ("unsupported dtype or head dim" if err < 0 else
               lib.dl4j_cuda_error_string(err).decode())
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"({err}): {msg}")
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
    [B, H, Tq]. Forward only: the backward kernels come with the
    training slice."""
    t, h, h_kv = q.shape[1], q.shape[2], k.shape[2]
    if h % h_kv:
        raise ValueError(f"q heads ({h}) not divisible by kv heads "
                         f"({h_kv})")
    with devtime.scope("ops.flash_attention"):
        if not q.is_cuda:
            return flash_attention_reference(q, k, v, causal, mask,
                                             block_k or 512, return_lse)
        _check_cuda_inputs(q, k, v, mask, block_q, block_k)
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


#: launches of the CUDA kernel (the count the smoke run reads)
flash_attention.launches = 0
