"""Attention: rotary embedding, GQA head broadcast, the flash-dispatched
``scaled_dot_attention``, and the layers of the causal LM's stack.

Port of ``deeplearning4j_tpu/nn/layers/attention.py``: the functions the
serving path calls, :class:`MultiHeadAttention` (local attention, or
under a ``parallel.distributed_context`` its ``sequence_parallel`` mode
on the rank's shard of the sequence, at the rank's global positions),
the pre-RMSNorm :class:`TransformerDecoderBlock`, and BERT's layers — the
learned :class:`PositionalEmbeddingLayer`, the pre-LayerNorm
:class:`TransformerEncoderBlock` and the :class:`ClsTokenPoolLayer`.
Learned and recurrent attention come with a later slice. Shapes are the
JAX package's: [B, T, H, D], head axis 2; key mask [B, Tk].
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from deeplearning4j_tpu_torch.nn import weights as winit
from deeplearning4j_tpu_torch.nn.layers.base import (Layer, register_layer,
                                                     split_seed)


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
    (``ops.cuda_kernels.flash_attention``, differentiable through its
    backward kernel); otherwise the explicit einsum + softmax with -1e9
    masking, as the JAX package computes it off the TPU."""
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


def _at_positions(fn, x, segments):
    """``fn(run, offset)`` over each contiguous run of the rank's tokens
    (``segments``: ``(global offset, length)`` pairs along axis 1, or
    None for the whole sequence from position 0), concatenated."""
    if segments is None:
        return fn(x, 0)
    runs, at = [], 0
    for off, ln in segments:
        runs.append(fn(x[:, at:at + ln], off))
        at += ln
    return runs[0] if len(runs) == 1 else torch.cat(runs, dim=1)


def _local_segments(mode, t_loc: int):
    from deeplearning4j_tpu_torch.parallel.mesh import local_segments
    return local_segments(mode, t_loc)


def _split_heads(x, n_heads):
    b, t, f = x.shape
    return x.reshape(b, t, n_heads, f // n_heads)


def _merge_heads(x):
    b, t, h, d = x.shape
    return x.reshape(b, t, h * d)


@register_layer
@dataclass
class MultiHeadAttention(Layer):
    """Self multi-head attention projection block (reference
    multi_head_dot_product_attention op). Grouped-query attention via
    ``n_kv_heads``, rotary embeddings via ``rope``.

    ``sequence_parallel``: ``"ring"`` | ``"zigzag_ring"`` |
    ``"ulysses"`` | ``None``. Under an active
    ``parallel.distributed_context`` the layer takes THIS rank's shard
    of the sequence (the per-process rule of ``parallel/mesh.py``: the
    contiguous chunk, or the zigzag half-chunks) and runs the mode's
    distributed attention over the context's axis; RoPE rotates each
    token at its global position. Outside a context the attention is
    local, so one configuration runs on one card and on many. An
    unknown mode raises ``ValueError`` even with no context."""
    n_in: Optional[int] = None
    n_out: int = 0
    n_heads: int = 1
    causal: bool = False
    project_out: bool = True
    sequence_parallel: Optional[str] = None
    n_kv_heads: Optional[int] = None   # grouped-query attention
    rope: bool = False                 # rotary position embeddings
    rope_theta: float = 10000.0

    _SP_MODES = (None, "ring", "ulysses", "zigzag_ring")

    def _context(self):
        """The active distributed context when this layer runs
        sequence-parallel, else None; an unknown mode raises."""
        if self.sequence_parallel not in self._SP_MODES:
            # reject typos even on one card, where no context is active
            raise ValueError(
                f"unknown sequence_parallel mode "
                f"{self.sequence_parallel!r} (ring|ulysses|zigzag_ring)")
        if self.sequence_parallel is None:
            return None
        from deeplearning4j_tpu_torch.parallel.mesh import active_context
        return active_context()

    def _attend(self, q, k, v, mask, ctx):
        """``k``/``v`` may carry fewer heads than ``q`` (GQA): the ring
        paths keep the small kv on the wire and the flash kernels read
        one kv block per head group; only Ulysses (the head-axis
        all-to-all) needs the broadcast."""
        if ctx is None:
            return scaled_dot_attention(q, k, v, mask, self.causal)
        kw = dict(axis_name=ctx.axis_name, mask=mask)
        if self.sequence_parallel == "ring":
            from deeplearning4j_tpu_torch.parallel.ring_attention import \
                ring_self_attention
            return ring_self_attention(q, k, v, ctx.mesh,
                                       causal=self.causal, **kw)
        if self.sequence_parallel == "ulysses":
            from deeplearning4j_tpu_torch.parallel.ulysses import \
                ulysses_self_attention
            n_heads = q.shape[2]
            return ulysses_self_attention(
                q, repeat_kv_heads(k, n_heads), repeat_kv_heads(v, n_heads),
                ctx.mesh, causal=self.causal, **kw)
        if not self.causal:
            raise ValueError("zigzag_ring is causal-only")
        # the rank's shard is already in the zigzag layout: no permute
        from deeplearning4j_tpu_torch.parallel.ring_attention import \
            zigzag_ring_self_attention
        return zigzag_ring_self_attention(q, k, v, ctx.mesh, **kw)

    def init(self, gen, input_shape, dtype=torch.float32):
        n_in = self.n_in or input_shape[-1]
        n_out = self.n_out or n_in
        if n_out % self.n_heads:
            raise ValueError(f"n_out={n_out} not divisible by "
                             f"n_heads={self.n_heads}")
        n_kv = self.n_kv_heads or self.n_heads
        if self.n_heads % n_kv:
            raise ValueError(f"n_heads={self.n_heads} not divisible "
                             f"by n_kv_heads={n_kv}")
        kv_out = (n_out // self.n_heads) * n_kv
        wi = winit.get(self.weight_init or "xavier")
        params = {"Wq": wi(gen, (n_in, n_out), dtype),
                  "Wk": wi(gen, (n_in, kv_out), dtype),
                  "Wv": wi(gen, (n_in, kv_out), dtype)}
        if self.project_out:
            params["Wo"] = wi(gen, (n_out, n_out), dtype)
            params["bo"] = torch.zeros((n_out,), dtype=dtype)
        return params, {}, (input_shape[0], n_out)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        ctx = self._context()
        n_kv = self.n_kv_heads or self.n_heads
        q = _split_heads(x @ params["Wq"], self.n_heads)
        k = _split_heads(x @ params["Wk"], n_kv)
        v = _split_heads(x @ params["Wv"], n_kv)
        if self.rope:
            segs = (None if ctx is None else
                    _local_segments(self.sequence_parallel, x.shape[1]))
            rope = lambda t, off: rotary_embedding(t, self.rope_theta, off)
            q = _at_positions(rope, q, segs)
            k = _at_positions(rope, k, segs)
        o = _merge_heads(self._attend(q, k, v, mask, ctx))
        if self.project_out:
            o = o @ params["Wo"] + params["bo"]
        if mask is not None:
            o = o * mask[..., None].to(o.dtype)
        return self._maybe_dropout(self._act()(o), train, rng), state


@register_layer
@dataclass
class TransformerDecoderBlock(Layer):
    """Pre-RMSNorm causal decoder block: grouped-query attention with
    rotary embeddings and a SwiGLU MLP, residuals around both. The
    residual add before the second norm is one fused kernel (K7,
    ``ops.fused_norms.add_rms_norm``) on the card.

    ``remat=True`` recomputes the block's activations during the
    backward (``torch.utils.checkpoint``, non-reentrant) instead of
    storing them; the dropout seed is an argument of the block, so the
    recomputation draws the same mask."""
    n_in: Optional[int] = None
    n_heads: int = 8
    n_kv_heads: Optional[int] = None
    ffn_mult: float = 4
    rope_theta: float = 10000.0
    sequence_parallel: Optional[str] = None
    remat: bool = False

    def _subs(self):
        if not hasattr(self, "_mha"):
            from deeplearning4j_tpu_torch.nn.layers.core import RMSNorm
            f = self.n_in
            self._mha = MultiHeadAttention(
                n_in=f, n_out=f, n_heads=self.n_heads,
                n_kv_heads=self.n_kv_heads, causal=True, rope=True,
                rope_theta=self.rope_theta,
                sequence_parallel=self.sequence_parallel)
            self._ln1 = RMSNorm()
            self._ln2 = RMSNorm()

    def init(self, gen, input_shape, dtype=torch.float32):
        f = self.n_in = self.n_in or input_shape[-1]
        self._subs()
        wi = winit.get(self.weight_init or "xavier")
        pa, _, _ = self._mha.init(gen, input_shape, dtype)
        p1, _, _ = self._ln1.init(gen, input_shape, dtype)
        p2, _, _ = self._ln2.init(gen, input_shape, dtype)
        hid = int(round(f * self.ffn_mult))
        params = {"mha": pa, "ln1": p1, "ln2": p2,
                  # SwiGLU: (silu(x W_gate) * x W_up) W_down
                  "Wg": wi(gen, (f, hid), dtype),
                  "Wu": wi(gen, (f, hid), dtype),
                  "Wd": wi(gen, (hid, f), dtype)}
        return params, {}, tuple(input_shape)

    def _body(self, params, x, mask, train, rng):
        from deeplearning4j_tpu_torch.ops import fused_norms
        r1, r2 = split_seed(rng) if rng is not None else (None, None)
        h, _ = self._ln1.apply(params["ln1"], {}, x)
        a, _ = self._mha.apply(params["mha"], {}, h, train=train,
                               rng=r1, mask=mask)
        h, x = fused_norms.add_rms_norm(x, a, params["ln2"]["gamma"],
                                        eps=self._ln2.eps)
        h = F.silu(h @ params["Wg"]) * (h @ params["Wu"])
        return x + self._maybe_dropout(h @ params["Wd"], train, r2)

    def apply(self, params, state, x, *, train=False, rng=None,
              mask=None):
        self._subs()
        if self.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(
                lambda p, x: self._body(p, x, mask, train, rng), params,
                x, use_reentrant=False), state
        return self._body(params, x, mask, train, rng), state


@register_layer
@dataclass
class PositionalEmbeddingLayer(Layer):
    """Learned positional embeddings added to [B, T, F] (BERT-style),
    drawn N(0, 0.02²). Inside a sequence-parallel network's forward
    (the context's ``layout`` set) the rows are those of the rank's
    global positions."""
    max_len: int = 512
    #: its rows are the rank's global positions under the context
    mixes_positions = False

    def init(self, gen, input_shape, dtype=torch.float32):
        t, f = input_shape
        params = {"pos": torch.randn((self.max_len, f), generator=gen,
                                     dtype=dtype) * 0.02}
        return params, {}, tuple(input_shape)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        from deeplearning4j_tpu_torch.parallel.mesh import active_context
        ctx = active_context()
        segs = (None if ctx is None
                else _local_segments(ctx.layout, x.shape[1]))
        pos = params["pos"]
        rows = (pos[:x.shape[1]] if segs is None else
                torch.cat([pos[off:off + ln] for off, ln in segs]))
        return x + rows[None], state


@register_layer
@dataclass
class TransformerEncoderBlock(Layer):
    """Pre-LayerNorm transformer encoder block: multi-head attention (not
    causal; the key mask passes through) and a GELU MLP with biases,
    residuals around both. Both norms are ``LayerNormalization`` (K8 and
    K9 on the card). The JAX block calls ``jax.nn.gelu``, whose default
    is the tanh approximation, so this block does too. Dropout applies
    to the MLP's output."""
    n_in: Optional[int] = None
    n_heads: int = 8
    ffn_mult: float = 4
    causal: bool = False
    sequence_parallel: Optional[str] = None

    def _subs(self):
        if not hasattr(self, "_mha"):
            from deeplearning4j_tpu_torch.nn.layers.core import \
                LayerNormalization
            f = self.n_in
            self._mha = MultiHeadAttention(
                n_in=f, n_out=f, n_heads=self.n_heads, causal=self.causal,
                sequence_parallel=self.sequence_parallel)
            self._ln1 = LayerNormalization()
            self._ln2 = LayerNormalization()

    def init(self, gen, input_shape, dtype=torch.float32):
        f = self.n_in = self.n_in or input_shape[-1]
        self._subs()
        wi = winit.get(self.weight_init or "xavier")
        pa, _, _ = self._mha.init(gen, input_shape, dtype)
        p1, _, _ = self._ln1.init(gen, input_shape, dtype)
        p2, _, _ = self._ln2.init(gen, input_shape, dtype)
        hid = int(round(f * self.ffn_mult))
        params = {"mha": pa, "ln1": p1, "ln2": p2,
                  "W1": wi(gen, (f, hid), dtype),
                  "b1": torch.zeros((hid,), dtype=dtype),
                  "W2": wi(gen, (hid, f), dtype),
                  "b2": torch.zeros((f,), dtype=dtype)}
        return params, {}, tuple(input_shape)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        self._subs()
        r1, r2 = split_seed(rng) if rng is not None else (None, None)
        h, _ = self._ln1.apply(params["ln1"], {}, x)
        a, _ = self._mha.apply(params["mha"], {}, h, train=train, rng=r1,
                               mask=mask)
        x = x + a
        h, _ = self._ln2.apply(params["ln2"], {}, x)
        h = F.gelu(h @ params["W1"] + params["b1"], approximate="tanh")
        h = h @ params["W2"] + params["b2"]
        return x + self._maybe_dropout(h, train, r2), state


@register_layer
@dataclass
class ClsTokenPoolLayer(Layer):
    """[B, T, F] -> [B, F]: the first (CLS) token, optionally through a
    tanh pooler dense (BERT's pooler). Ends the sequence mask."""
    n_out: int = 0                 # 0: no pooler dense, raw CLS vector
    pooler: bool = False
    #: pools the sequence: under a sequence-parallel context with
    #: GlobalPoolingLayer and conv.py
    mixes_positions = "ROADMAP item A10"

    def init(self, gen, input_shape, dtype=torch.float32):
        t, f = input_shape
        if self.n_out and not self.pooler:
            raise ValueError("ClsTokenPoolLayer: n_out requires "
                             "pooler=True (no projection otherwise)")
        if self.pooler:
            n = self.n_out or f
            wi = winit.get(self.weight_init or "xavier")
            return ({"W": wi(gen, (f, n), dtype),
                     "b": torch.zeros((n,), dtype=dtype)}, {}, (n,))
        return {}, {}, (f,)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        cls = x[:, 0, :]
        if self.pooler:
            cls = torch.tanh(cls @ params["W"] + params["b"])
        return cls, state

    def propagate_mask(self, mask, input_shape):
        return None                # the sequence axis is gone
