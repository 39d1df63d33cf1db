"""Attention helpers: rotary embedding, GQA head broadcast and the
flash-dispatched ``scaled_dot_attention``.

Port of the functions of ``deeplearning4j_tpu/nn/layers/attention.py``
that the serving path calls; the layer classes (MultiHeadAttention, the
encoder and decoder blocks) come with the training slice. Shapes are the
JAX package's: [B, T, H, D], head axis 2; key mask [B, Tk].
"""
from __future__ import annotations

import torch


def rotary_embedding(x, theta: float = 10000.0, offset=0):
    """Rotary position embedding (RoPE) on [B, T, H, D] (D even):
    HALF-SPLIT pairing (GPT-NeoX convention — feature i rotates with
    feature i + D/2). ``offset`` shifts the position index (KV-cache
    decoding). Angles are f32; cos/sin are cast to x's dtype."""
    b, t, h, d = x.shape
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    pos = offset + torch.arange(t, dtype=torch.float32, device=x.device)
    ang = pos[:, None] * freqs[None, :]            # [T, D/2]
    cos = torch.cos(ang)[None, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def repeat_kv_heads(k, n_heads: int):
    """Grouped-query attention: broadcast ``n_kv`` key/value heads to
    ``n_heads`` query heads ([B, T, n_kv, D] → [B, T, n_heads, D])."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k
    if n_heads % n_kv:
        raise ValueError(f"n_heads={n_heads} not divisible by "
                         f"n_kv_heads={n_kv}")
    return k.repeat_interleave(n_heads // n_kv, dim=2)


def _use_flash(q, k, causal: bool = False) -> bool:
    """The dispatch gate. The SEMANTIC refusals of the JAX gate hold:
    causal with Tq > Tk (its leading rows have no live key, and the two
    paths define that row differently — kernel: zeros; einsum: uniform
    average) and float64 stay on the einsum. Past those, a CUDA tensor
    always goes to the flash kernel and a CPU tensor to the einsum, the
    plain version. No size threshold: the JAX package's v5e crossovers
    do not carry over to this card."""
    semantic_ok = (not (causal and q.shape[1] > k.shape[1])
                   and q.dtype != torch.float64)
    return semantic_ok and q.is_cuda


def scaled_dot_attention(q, k, v, mask=None, causal=False):
    """q,k,v: [B, T, H, D] (head axis 2); ``k``/``v`` may carry fewer
    heads (GQA); Tq and Tk may differ (causal is then END-ALIGNED:
    query i attends keys ≤ i + Tk − Tq). mask: [B, Tk] key mask.

    On the card this is the hand-written flash kernel
    (``ops.cuda_kernels.flash_attention``); otherwise the explicit
    einsum + softmax with -1e9 masking, as the JAX package computes it
    off the TPU."""
    d = q.shape[-1]
    if _use_flash(q, k, causal):
        from deeplearning4j_tpu_torch.ops.cuda_kernels import \
            flash_attention
        return flash_attention(q, k, v, causal=causal, mask=mask)
    k = repeat_kv_heads(k, q.shape[2])
    v = repeat_kv_heads(v, q.shape[2])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
        torch.tensor(d, dtype=q.dtype))
    neg = torch.tensor(-1e30 if q.dtype == torch.float64 else -1e9,
                       dtype=q.dtype, device=q.device)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :] > 0, logits, neg)
    if causal:
        tq, tk = logits.shape[-2:]
        cm = torch.ones((tq, tk), dtype=torch.bool,
                        device=q.device).tril(tk - tq)
        logits = torch.where(cm, logits, neg)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)

