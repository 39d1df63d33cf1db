"""Decoder-only causal transformer LM.

Port of ``deeplearning4j_tpu/zoo/gpt.py``: RMSNorm pre-norm blocks,
rotary position embeddings, grouped-query attention and SwiGLU MLPs.
Train it through the JAX package's entry points, :meth:`conf` /
:meth:`init` → ``MultiLayerNetwork.fit(tokens[B,T], next_ids[B,T])``
(sparse softmax cross-entropy from the logits, the model's AdamW by
default); decode it with a KV cache — one batched prefill forward over
the prompt (every cache row written at once, attention through the flash
kernel on the card) followed by one decode step per generated position.

The model holds the configuration; parameters are a nested dict of
tensors with the JAX package's names and shapes (``layer_0`` the
embedding ``W`` [V, F]; ``layer_1..L`` the blocks with
``mha.{Wq,Wk,Wv,Wo,bo}``, ``ln1/ln2.gamma``, ``Wg/Wu/Wd``;
``layer_{L+1}.gamma`` the final norm; ``layer_{L+2}`` the head ``b``
and, untied, ``W`` [F, V]). :meth:`CausalTransformerLM.init_params`
builds them from a seed; :meth:`CausalTransformerLM.params_from_jax`
carries a JAX network's weights across. A trained ``MultiLayerNetwork``
holds the same tree in ``net.params``, so :meth:`generate` and the
serving gateway take it as it is.

``sequence_parallel`` (``"ring"``, ``"zigzag_ring"``, ``"ulysses"``)
reaches every block's attention: under ``parallel.distributed_context``
``fit`` trains sequence-parallel, each rank on its shard of the tokens
(``parallel/mesh.py``); outside a context the same model trains locally.
Decoding (``generate``, :meth:`CausalTransformerLM.generate_beam`, the
gateway) is local. ``serve_quant="int8"`` serves weight-only int8
weights (:class:`QuantizedWeight`, dequantised inside each consuming
matmul) and ``cache_quant="int8"`` keeps the KV cache as int8 codes
with per-(row, head, half, position) f32 scales (:func:`_quant_kv`);
both change decoding only, never the training parameters.
"""
from __future__ import annotations

import functools
import math
import weakref
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import dtypes, obs, tree
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import (EmbeddingSequenceLayer,
                                                RMSNorm, RnnOutputLayer,
                                                TransformerDecoderBlock)
from deeplearning4j_tpu_torch.nn.layers.attention import (
    rotary_embedding, scaled_dot_attention)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import fused_norms
from deeplearning4j_tpu_torch.perf import sentry


def _row(x, i):
    """``x[:, i]`` for an int ``i`` or a 0-d index tensor on ``x``'s
    device (a gather a CUDA graph can capture; an index below 0 reads
    row 0)."""
    if isinstance(i, int):
        return x[:, i]
    return x.index_select(1, i.clamp(min=0).reshape(1))[:, 0]


def _rms(x, gamma):
    """RMSNorm shared by the prefill forward and the per-token decode
    step: the Triton kernel on the card, the plain expression on the
    CPU (``ops/fused_norms.py``)."""
    return fused_norms.rms_norm(x, gamma, eps=fused_norms.RMSNORM_EPS)


def _div127(x):
    """``x / 127`` as a true f32 division on every device: PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal, which
    rounds differently for ~5 % of values, so the divisor is a 0-dim
    tensor on ``x``'s device, filled there (no host copy, so no wait for
    the stream)."""
    return x / x.new_full((), 127.0)


def _quant_kv(kvr, channel_axis: int):
    """int8 KV quantisation shared by prefill, the decode step and the
    paged steps: per-slice abs-max scales over ``channel_axis`` (the D
    channels of each k/v half), round-half-even int8 codes. Returns
    (codes int8, scales f32 with the channel axis dropped) — the same
    bits as the JAX package's ``_quant_kv`` (a true f32 division, round
    half to even), on the card as on the CPU."""
    kvr = kvr.to(torch.float32)
    s = torch.clamp_min(_div127(kvr.abs().amax(dim=channel_axis)), 1e-8)
    w8 = torch.round(kvr / s.unsqueeze(channel_axis)).to(torch.int8)
    return w8, s


class QuantizedWeight:
    """Weight-only int8 tensor for serving: ``w8`` (int8) and a
    per-channel f32 ``scale``, dequantised inside the consuming op —
    ``x @ qw`` computes ``x @ (w8.to(x.dtype) * scale.to(x.dtype))``.
    ``axis`` is the channel axis the scale runs along (0 = one scale a
    row, 1 = one a column); ``act_dtype`` is the dtype a row gather (the
    embedding) returns, where no operand gives one. A leaf of the
    parameter tree (``tree.leaves`` and the dtype casts pass it through
    whole). ``x @ qw`` works because ``Tensor.__matmul__`` returns
    ``NotImplemented`` for an operand that is not a tensor, so Python
    calls :meth:`__rmatmul__`.

    On the card the dequantised copy is a separate tensor that the
    matmul reads again (PyTorch does not fuse the convert into the
    matmul as XLA does); ``PERF.md`` records what that costs."""

    def __init__(self, w8, scale, axis: int, act_dtype="float32"):
        self.w8 = w8
        self.scale = scale
        self.axis = axis
        self.act_dtype = dtypes.resolve(act_dtype)

    @staticmethod
    def quantize(w, axis: int, act_dtype="float32") -> "QuantizedWeight":
        """Per-channel abs-max int8 codes of ``w`` along ``axis`` (the
        JAX package's bits: f32 scale, round half to even)."""
        scale = _div127(w.abs().amax(dim=1 - axis, keepdim=True))
        scale = torch.clamp_min(scale, 1e-8).to(torch.float32)
        w8 = torch.round(w / scale).to(torch.int8)
        return QuantizedWeight(w8, scale, axis, act_dtype)

    def _dequant(self, dtype):
        return self.w8.to(dtype) * self.scale.to(dtype)

    @property
    def T(self) -> "QuantizedWeight":
        return QuantizedWeight(self.w8.T, self.scale.T, 1 - self.axis,
                               self.act_dtype)

    @property
    def device(self):
        return self.w8.device

    def __rmatmul__(self, x):
        return x @ self._dequant(x.dtype)

    def __getitem__(self, idx):
        # embedding-style row gather: dequantise only the taken rows
        return (self.w8[idx].to(self.act_dtype)
                * self.scale[idx if self.axis == 0 else slice(None)]
                .to(self.act_dtype))


def _top_k(x, k: int):
    """The ``k`` largest entries of the last axis, largest first, ties
    broken toward the LOWER index — ``jax.lax.top_k``'s order (a stable
    descending sort; ``torch.topk`` promises no order among ties).
    Returns (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def prompt_bucket(t0: int, max_len: Optional[int] = None) -> int:
    """THE prompt-length bucket table: power-of-two (min 16), clamped
    to ``max_len`` when given. ``generate()`` and the serving gateway's
    prefill (``serving/scheduler.py``) share this one derivation."""
    tb = max(16, 1 << (max(int(t0), 1) - 1).bit_length())
    return tb if max_len is None else min(tb, max_len)


class CausalTransformerLM:
    """Configurable decoder-only LM. ``GPTNano()`` / ``GPTMini()`` give
    preset sizes. Train with ``init(seq_len)`` then
    ``fit(tokens[B,T], next_ids[B,T])``; decode with :meth:`generate`
    or serve through ``serving.gateway.ServingGateway``."""

    def __init__(self, vocab_size: int = 50257, hidden: int = 768,
                 n_layers: int = 12, n_heads: int = 12,
                 n_kv_heads: Optional[int] = None, max_len: int = 1024,
                 ffn_mult: float = 4, rope_theta: float = 10000.0,
                 dropout: float = 0.0,
                 sequence_parallel: Optional[str] = None,
                 remat: bool = False, tie_embeddings: bool = False,
                 serve_quant: Optional[str] = None,
                 cache_quant: Optional[str] = None,
                 seed: int = 123, updater=None,
                 compute_dtype: Optional[str] = None):
        # "int8": weight-only per-channel quantisation applied to the
        # decode copy of the parameters (training params untouched)
        if serve_quant not in (None, "int8"):
            raise ValueError(f"serve_quant={serve_quant!r} "
                             "(None | 'int8')")
        # "int8": KV cache stored as int8 codes + per-(row, kv-head,
        # k/v-half, position) f32 scales
        if cache_quant not in (None, "int8"):
            raise ValueError(f"cache_quant={cache_quant!r} "
                             "(None | 'int8')")
        n_kv_heads = n_kv_heads or n_heads
        if hidden % n_heads or n_heads % n_kv_heads:
            raise ValueError(f"hidden={hidden}, n_heads={n_heads}, "
                             f"n_kv_heads={n_kv_heads}: heads must divide "
                             "hidden and kv heads must divide heads")
        self.tie_embeddings = tie_embeddings
        self.serve_quant = serve_quant
        self.cache_quant = cache_quant
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        self.max_len = max_len
        self.ffn_mult = ffn_mult
        self.rope_theta = rope_theta
        self.seed = seed
        self.dropout = dropout
        self.sequence_parallel = sequence_parallel
        self.remat = remat
        self.updater = updater or upd.AdamW(learning_rate=3e-4,
                                            weight_decay=0.1,
                                            exclude_bias_and_norm=True)
        self.compute_dtype = compute_dtype
        self._gen_calls = 0
        self._decode_params_cache = None

    # -- parameters -----------------------------------------------------
    def param_shapes(self) -> Dict[str, dict]:
        """The parameter tree's shapes, the JAX network's layout."""
        f, v = self.hidden, self.vocab_size
        kv = (f // self.n_heads) * self.n_kv_heads
        hid = int(round(f * self.ffn_mult))
        shapes: Dict[str, dict] = {"layer_0": {"W": (v, f)}}
        for i in range(self.n_layers):
            shapes[f"layer_{i + 1}"] = {
                "mha": {"Wq": (f, f), "Wk": (f, kv), "Wv": (f, kv),
                        "Wo": (f, f), "bo": (f,)},
                "ln1": {"gamma": (f,)}, "ln2": {"gamma": (f,)},
                "Wg": (f, hid), "Wu": (f, hid), "Wd": (hid, f)}
        shapes[f"layer_{self.n_layers + 1}"] = {"gamma": (f,)}
        head = {} if self.tie_embeddings else {"W": (f, v)}
        head["b"] = (v,)
        shapes[f"layer_{self.n_layers + 2}"] = head
        return shapes

    def init_params(self, seed: Optional[int] = None,
                    device="cuda") -> Dict[str, dict]:
        """Random f32 parameters with the JAX package's init rules: the
        embedding ``normal`` (N(0,1)/sqrt(F), ``nn/weights.py:65``),
        every other matrix ``xavier`` (N(0, 2/(fan_in+fan_out)),
        ``:26``), gammas ones, biases zeros; a tied head has no ``W``.
        Drawn on the CPU from ``torch.Generator(seed)`` (default: the
        model's seed), then moved to ``device`` — the same values on
        every device. The values differ from the JAX package's (another
        generator); carry those across with :meth:`params_from_jax`."""
        g = torch.Generator().manual_seed(
            self.seed if seed is None else int(seed))

        def init(path, shape):
            name = path[-1]
            if name == "gamma":
                return torch.ones(shape)
            if len(shape) == 1:
                return torch.zeros(shape)
            w = torch.randn(shape, generator=g)
            if path == ("layer_0", "W"):
                return w / math.sqrt(shape[-1])
            return w * math.sqrt(2.0 / (shape[0] + shape[1]))

        def build(tree, path=()):
            return {k: (build(v, path + (k,)) if isinstance(v, dict)
                        else init(path + (k,), v).to(device))
                    for k, v in tree.items()}

        return build(self.param_shapes())

    def params_from_jax(self, params_tree,
                        device="cuda") -> Dict[str, dict]:
        """Carry a JAX network's weights across: ``params_tree`` is the
        nested dict of numpy arrays ``jax.tree.map(np.asarray,
        net.params)`` gives. Returns the port's parameters on
        ``device``, checked against :meth:`param_shapes` (same dtypes as
        given)."""
        return tree.from_numpy(self.param_shapes(), params_tree, device)

    # -- training -------------------------------------------------------
    def conf(self, seq_len: int):
        """The network configuration the JAX package builds: embedding,
        ``n_layers`` decoder blocks, the final RMSNorm and a softmax
        head trained by sparse cross-entropy from the logits; the head
        tied to the embedding (transposed) with ``tie_embeddings``."""
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater)
             .compute_data_type(self.compute_dtype)
             .list()
             .layer(EmbeddingSequenceLayer(n_in=self.vocab_size,
                                           n_out=self.hidden,
                                           weight_init="normal")))
        for _ in range(self.n_layers):
            b.layer(TransformerDecoderBlock(
                n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
                ffn_mult=self.ffn_mult, rope_theta=self.rope_theta,
                dropout=self.dropout or None, remat=self.remat,
                sequence_parallel=self.sequence_parallel))
        b.layer(RMSNorm())
        b.layer(RnnOutputLayer(n_out=self.vocab_size,
                               activation="softmax",
                               loss="sparse_mcxent"))
        if self.tie_embeddings:
            b.tie_weights(self.n_layers + 2, "W", 0, "W",
                          transpose=True)
        return b.set_input_type(
            InputType.recurrent(1, seq_len)).build()

    def init(self, seq_len: Optional[int] = None,
             device="cuda") -> MultiLayerNetwork:
        """A new network with random weights (from the model's seed) on
        ``device``, ready for ``fit``."""
        return MultiLayerNetwork(
            self.conf(seq_len or self.max_len)).init(device=device)

    # -- KV-cached autoregressive decoding ------------------------------
    @torch.no_grad()
    def generate(self, net, prompt, n_new: int,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        """Greedy (or sampled) decoding: ONE batched prefill forward
        over the whole prompt, right-padded to its power-of-two bucket,
        then one decode step per generated position against a dense KV
        cache. Sampling (``temperature > 0``) supports ``top_k`` and
        nucleus ``top_p``; both filters compose. ``prompt``: [B, T0]
        ints. Returns [B, T0 + n_new] int32 (numpy). ``net`` is a
        ``MultiLayerNetwork`` of this model (as the JAX ``generate``
        takes) or its parameter tree; it runs on the device they live
        on.

        ``generator``: a ``torch.Generator`` on that device for
        reproducible samples; the default seeds one from a per-call
        counter, so repeated sampled calls differ."""
        if top_k is not None and not 1 <= top_k <= self.vocab_size:
            raise ValueError(f"top_k={top_k} outside [1, vocab_size="
                             f"{self.vocab_size}]")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p={top_p} outside (0, 1]")
        ts0 = obs.now()
        prep = self._prep_decode(net, prompt, n_new)
        if prep is None:
            return np.asarray(prompt, np.int32)
        prompt_np, toks, p, b, t0, tb = prep
        dev = toks.device
        sample = temperature > 0
        if sample and generator is None:
            self._gen_calls += 1
            generator = torch.Generator(device=dev).manual_seed(
                self._gen_calls)
        ts1 = obs.now()
        gen = self._decode_program(b, tb, n_new, sample, top_k,
                                   top_p is not None)(
            p, toks, t0, temperature or 1.0,
            1.0 if top_p is None else top_p, generator)
        ts2 = obs.now()
        gen_np = gen.cpu().numpy().astype(np.int32)   # device sync
        obs.record_step("CausalTransformerLM.generate", ts0, ts1, ts2,
                        obs.now())
        return np.concatenate([prompt_np, gen_np], axis=1)

    def _decode_program(self, b: int, tb: int, n_new: int, sample: bool,
                        top_k, nucleus: bool) -> sentry.SentryJit:
        """``CausalTransformerLM.decode``: one entry point a key of the
        JAX ``_jit_cached`` (batch, prompt bucket, ``n_new``, the
        sampling flags, ``cache_quant``), its arguments the decode
        parameters, the padded prompt, the true prompt length, the
        temperature, ``top_p`` and the generator. It stays eager on the
        card in this slice: its cache writes and rotary offsets index by
        the Python position of each step (``ROADMAP.md`` A17)."""
        key = (b, tb, n_new, sample, top_k, nucleus, self.cache_quant)
        cache = self.__dict__.setdefault("_gen_cache", {})
        if key not in cache:
            cache[key] = sentry.jit(
                functools.partial(self._decode_gen, b=b, tb=tb,
                                  n_new=n_new, sample=sample, top_k=top_k,
                                  nucleus=nucleus),
                name="CausalTransformerLM.decode")
        return cache[key]

    @torch.no_grad()
    def warmup_decode(self, net, *, n_new: int, batch_sizes=(1,),
                      prompt_lens=None, temperature: float = 0.0,
                      top_k: Optional[int] = None,
                      top_p: Optional[float] = None):
        """Build the decode program of every (batch, prompt bucket) pair
        BEFORE the first request (``perf.warmup``): prompts snap to the
        power-of-two buckets of :func:`prompt_bucket`, so the set is
        O(batch_sizes × log max_len), and a first ``generate`` on a
        warmed bucket adds no trace. ``prompt_lens`` (true lengths,
        bucketed here) defaults to every reachable one given ``n_new``;
        the sampling flags must match the serving call's (they key the
        program). Returns ``{"compiled": n, "seconds": t}``."""
        if prompt_lens is None:
            prompt_lens = range(1, self.max_len - n_new + 1)
        buckets = sorted({prompt_bucket(t0, self.max_len)
                          for t0 in prompt_lens})
        params = net.params if isinstance(net, MultiLayerNetwork) else net
        p = self._decode_params(params)
        dev = p["layer_0"]["W"].device
        sample = temperature > 0
        gen = torch.Generator(device=dev) if sample else None
        compiled, seconds = 0, 0.0
        for b in batch_sizes:
            for tb in buckets:
                dt = self._decode_program(b, tb, n_new, sample, top_k,
                                          top_p is not None).warmup(
                    p, torch.zeros((b, tb), dtype=torch.int64, device=dev),
                    tb, temperature or 1.0,
                    1.0 if top_p is None else top_p, gen)
                compiled += dt > 0
                seconds += dt
        return {"compiled": compiled, "seconds": seconds}

    def _prep_decode(self, net, prompt, n_new: int):
        """Shared ``generate``/``generate_beam`` prologue: coerce, guard,
        bucket-pad, prepare the parameters. Returns None when there is
        nothing to generate, else (prompt [B, T0] int32, padded prompt
        [B, Tb] on the parameters' device, decode parameters, B, T0,
        Tb)."""
        prompt_np = np.asarray(prompt, np.int32)
        b, t0 = prompt_np.shape
        if n_new <= 0:
            return None
        if t0 + n_new > self.max_len:
            raise ValueError(f"prompt+new ({t0 + n_new}) exceeds "
                             f"max_len={self.max_len}")
        tb = prompt_bucket(t0, self.max_len)
        params = net.params if isinstance(net, MultiLayerNetwork) else net
        p = self._decode_params(params)
        pad = np.zeros((b, tb), np.int64)
        pad[:, :t0] = prompt_np
        toks = torch.as_tensor(pad, device=p["layer_0"]["W"].device)
        return prompt_np, toks, p, b, t0, tb

    @staticmethod
    def _filter_logits(logits, top_k, top_p, nucleus):
        """Top-k then nucleus filtering on [B, V] f32 logits (filtered
        entries → -inf); one descending sort serves both filters."""
        if not (top_k is not None or nucleus):
            return logits
        if top_k is not None and not nucleus:
            kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
            return logits.masked_fill(logits < kth, -math.inf)
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        if top_k is not None:
            logits = logits.masked_fill(
                logits < sorted_l[:, top_k - 1:top_k], -math.inf)
            cols = torch.arange(sorted_l.shape[-1],
                                device=logits.device)[None, :]
            sorted_l = sorted_l.masked_fill(cols >= top_k, -math.inf)
        if nucleus:
            # keep the smallest prefix of the sorted distribution whose
            # cumulative mass reaches top_p (always keep the argmax)
            cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
            keep = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool),
                              cum[:, :-1] < top_p], dim=-1)
            thresh = torch.where(keep, sorted_l,
                                 torch.full_like(sorted_l, math.inf)
                                 ).amin(dim=-1, keepdim=True)
            logits = logits.masked_fill(logits < thresh, -math.inf)
        return logits

    def _token_logits(self, params, tok, caches, pos: int, rows: int):
        """One decode position through the whole stack: token ids
        [rows] → (logits [rows, V], caches). Each layer's dense cache
        is ONE [rows, Hkv, 2D, T] tensor (k rows 0:D, v rows D:2D), the
        JAX layout — under ``cache_quant="int8"`` a pair (int8 codes of
        that shape, f32 scales [rows, Hkv, 2, T]); this position's k/v
        are written into it IN PLACE (the JAX code returns an updated
        copy)."""
        hd = self.hidden // self.n_heads
        n_kv = self.n_kv_heads
        groups = self.n_heads // n_kv
        with obs.devtime.scope("decode.embed"):
            x = params["layer_0"]["W"][tok]         # [rows, F]
        for i, ckv in enumerate(caches):
            pblk = params[f"layer_{i + 1}"]
            with obs.devtime.scope(f"decode.block_{i}"):
                h = _rms(x, pblk["ln1"]["gamma"])
                mha = pblk["mha"]
                q = (h @ mha["Wq"]).reshape(rows, 1, self.n_heads, hd)
                k = (h @ mha["Wk"]).reshape(rows, 1, n_kv, hd)
                v = (h @ mha["Wv"]).reshape(rows, 1, n_kv, hd)
                q = rotary_embedding(q, self.rope_theta, offset=pos)[:, 0]
                k = rotary_embedding(k, self.rope_theta, offset=pos)[:, 0]
                kv = torch.cat([k, v[:, 0]], dim=2)     # [rows, Kv, 2D]
                if self.cache_quant:
                    # quantise this position against fresh per-(row,
                    # head, half) scales; the scales factor OUT of both
                    # einsums (constant over the channel axis): k-scales
                    # multiply the scores, v-scales pre-scale the
                    # softmax weights, both in f32, and only their
                    # products cast back — bf16 rounds each value once
                    w8, sc = ckv
                    q8, s_new = _quant_kv(kv.reshape(rows, n_kv, 2, hd), 3)
                    w8[:, :, :, pos] = q8.reshape(rows, n_kv, 2 * hd)
                    sc[:, :, :, pos] = s_new
                    ck = w8[:, :, :hd, :].to(x.dtype)
                    cv = w8[:, :, hd:, :].to(x.dtype)
                    k_scale = sc[:, :, 0, None, :]
                    v_scale = sc[:, :, 1, None, :]
                else:
                    ckv[:, :, :, pos] = kv
                    ck, cv = ckv[:, :, :hd, :], ckv[:, :, hd:, :]
                    k_scale = v_scale = None
                qg = q.reshape(rows, n_kv, groups, hd)
                s = torch.einsum("bkgd,bkdt->bkgt", qg, ck) / torch.sqrt(
                    torch.tensor(hd, dtype=x.dtype))
                if k_scale is not None:
                    s = (s * k_scale).to(x.dtype)
                live = torch.arange(ck.shape[3], device=x.device) <= pos
                s = s.masked_fill(~live, -1e9)
                w = torch.softmax(s, dim=-1)
                if v_scale is not None:
                    w = (w * v_scale).to(x.dtype)
                a = torch.einsum("bkgt,bkdt->bkgd", w, cv).reshape(rows,
                                                                   -1)
                x = x + a @ mha["Wo"] + mha["bo"]
                h = _rms(x, pblk["ln2"]["gamma"])
                h = F.silu(h @ pblk["Wg"]) * (h @ pblk["Wu"])
                x = x + h @ pblk["Wd"]
        with obs.devtime.scope("decode.lm_head"):
            x = _rms(x, params[f"layer_{self.n_layers + 1}"]["gamma"])
            logits = self._head_logits(params, x)
        return logits, caches

    def _head_logits(self, params, x):
        """LM-head matmul, honoring ``tie_embeddings`` (the tied W is
        the embedding matrix transposed)."""
        head = params[f"layer_{self.n_layers + 2}"]
        hw = (params["layer_0"]["W"].T if self.tie_embeddings
              else head["W"])
        return x @ hw + head["b"]

    def _prefill_forward(self, params, toks, cache_len: int, t0: int):
        """Batched prompt prefill: ONE causal forward over the padded
        prompt [B, Tb] builds every layer's dense cache [B, Hkv, 2D,
        cache_len] (int8 codes and f32 scales under ``cache_quant``)
        and yields the logits at the last real prompt position
        ``t0 - 1`` (``t0`` an int, or a 0-d tensor on the device in a
        captured program). Attention goes through
        ``scaled_dot_attention`` (the flash kernel on the card). Rows
        past ``t0 - 1`` hold right-padding junk, but causality keeps
        them out of every real row's context, and decode overwrites row
        ``p`` before attending at ``p``. The head runs on the ONE
        selected row."""
        bsz, tb = toks.shape
        hd = self.hidden // self.n_heads
        n_kv = self.n_kv_heads
        with obs.devtime.scope("prefill.embed"):
            x = params["layer_0"]["W"][toks]        # [B, Tb, F]
        caches = []
        for i in range(self.n_layers):
            pblk = params[f"layer_{i + 1}"]
            with obs.devtime.scope(f"prefill.block_{i}"):
                h = _rms(x, pblk["ln1"]["gamma"])
                mha = pblk["mha"]
                q = (h @ mha["Wq"]).reshape(bsz, tb, self.n_heads, hd)
                k = (h @ mha["Wk"]).reshape(bsz, tb, n_kv, hd)
                v = (h @ mha["Wv"]).reshape(bsz, tb, n_kv, hd)
                q = rotary_embedding(q, self.rope_theta)
                k = rotary_embedding(k, self.rope_theta)
                a = scaled_dot_attention(q, k, v, causal=True)
                x = x + a.reshape(bsz, tb, -1) @ mha["Wo"] + mha["bo"]
                h = _rms(x, pblk["ln2"]["gamma"])
                h = F.silu(h @ pblk["Wg"]) * (h @ pblk["Wu"])
                x = x + h @ pblk["Wd"]
                # cache layout [B, Hkv, 2D, T]: k rows 0:D, v rows D:2D
                kv_full = torch.cat([k.permute(0, 2, 3, 1),
                                     v.permute(0, 2, 3, 1)], dim=2)
                if self.cache_quant:
                    w8, sc = _quant_kv(
                        kv_full.reshape(bsz, n_kv, 2, hd, tb), 3)
                    codes = torch.zeros((bsz, n_kv, 2 * hd, cache_len),
                                        dtype=torch.int8, device=x.device)
                    codes[..., :tb] = w8.reshape(bsz, n_kv, 2 * hd, tb)
                    scales = x.new_zeros((bsz, n_kv, 2, cache_len),
                                         dtype=torch.float32)
                    scales[..., :tb] = sc
                    caches.append((codes, scales))
                else:
                    kv = x.new_zeros((bsz, n_kv, 2 * hd, cache_len))
                    kv[..., :tb] = kv_full
                    caches.append(kv)
        with obs.devtime.scope("prefill.lm_head"):
            x = _rms(x, params[f"layer_{self.n_layers + 1}"]["gamma"])
            logits = self._head_logits(params, _row(x, t0 - 1))
        return logits, caches

    def _pick(self, logits, temperature, top_p, generator, *, sample,
              top_k, nucleus):
        """Next-token choice from [rows, V] logits — argmax or filtered
        categorical sample (int64 ids)."""
        if sample:
            lf = self._filter_logits(logits.float() / temperature, top_k,
                                     top_p, nucleus)
            probs = torch.softmax(lf, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0]
        return torch.argmax(logits, dim=-1)

    def _cast_decode(self, params):
        """Serving honors ``compute_dtype``: parameters cast once, so
        the KV caches and every per-token matmul run in it.
        ``serve_quant="int8"`` first quantises every 2-D weight
        per-channel FROM the f32 masters (quantising a bf16-rounded
        tree would compound the rounding), then the remaining float
        leaves are cast. The embedding gets one scale a ROW: the rows
        it gathers and the tied head (its ``.T``) share them."""
        if self.serve_quant == "int8":
            act = self.compute_dtype or "float32"
            params = {
                lname: tree.map_(
                    lambda w, a=(0 if lname == "layer_0" else 1):
                    QuantizedWeight.quantize(w.to(torch.float32), a, act)
                    if w.ndim == 2 else w, blk)
                for lname, blk in params.items()}
        if self.compute_dtype is not None:
            params = dtypes.cast_float_tree(params, self.compute_dtype)
        return params

    def _decode_params(self, params):
        """Cast (and quantise) ONCE per params version: repeated calls
        against unchanged params reuse the prepared copy. Staleness-safe
        by LEAF identity through weakrefs: replacing any tensor in the
        tree invalidates the cache, and the cache never pins the old
        tensors."""
        if self.compute_dtype is None and self.serve_quant is None:
            return params
        leaves = list(tree.leaves(params))
        cached = self._decode_params_cache
        if (cached is not None and len(cached[0]) == len(leaves)
                and all(w() is t for w, t in zip(cached[0], leaves))):
            return cached[1]
        prepared = self._cast_decode(params)
        self._decode_params_cache = ([weakref.ref(t) for t in leaves],
                                     prepared)
        return prepared

    def _decode_gen(self, params, toks, t0: int, temperature, top_p,
                    generator, *, b, tb, n_new, sample, top_k, nucleus):
        """Batched prefill + one decode step per generated position.
        Returns the generated tokens [B, n_new] (the caller re-attaches
        the prompt)."""
        logits0, caches = self._prefill_forward(params, toks, tb + n_new,
                                                t0)
        pick = lambda lg: self._pick(lg, temperature, top_p, generator,
                                     sample=sample, top_k=top_k,
                                     nucleus=nucleus)
        prev = pick(logits0)
        out = [prev]
        for i in range(n_new - 1):
            logits, caches = self._token_logits(params, prev, caches,
                                                t0 + i, b)
            prev = pick(logits)
            out.append(prev)
        return torch.stack(out, dim=1)

    # -- beam search ------------------------------------------------------
    @torch.no_grad()
    def generate_beam(self, net, prompt, n_new: int, beams: int = 4):
        """Beam-search decoding (deterministic): keeps the ``beams``
        highest-logprob hypotheses per example, KV caches reordered to
        follow their parent beam at every step. The prompt runs as ONE
        batched prefill with B rows; its caches repeat to B·beams rows
        only for the expansion. Ties go to the lower index, as
        ``jax.lax.top_k`` breaks them (:func:`_top_k`), so ``beams=1``
        is greedy :meth:`generate`. Composes with ``serve_quant`` and
        ``cache_quant``. Returns the best hypothesis per example,
        [B, T0 + n_new] int32 (numpy)."""
        if beams < 1 or beams > self.vocab_size:
            raise ValueError(f"beams={beams} outside [1, vocab_size]")
        prep = self._prep_decode(net, prompt, n_new)
        if prep is None:
            return np.asarray(prompt, np.int32)
        prompt_np, toks, p, b, t0, tb = prep
        gen = self._beam_scan(p, toks, t0, b=b, beams=beams, tb=tb,
                              n_new=n_new)
        gen_np = gen.cpu().numpy().astype(np.int32)   # device sync
        return np.concatenate([prompt_np, gen_np], axis=1)

    def _beam_scan(self, params, toks, t0: int, *, b, beams, tb, n_new):
        """Prefill with B rows; its last-position log-probs drive the
        first expansion (top ``beams`` of one root hypothesis); then one
        decode step over B·beams rows per position, the top ``beams``
        over beams·V continuations of each example, hypotheses and caches
        following their parent beam. Returns [B, n_new] token ids."""
        R = b * beams
        V = self.vocab_size
        logits0, caches_b = self._prefill_forward(params, toks, tb + n_new,
                                                  t0)
        logp0 = torch.log_softmax(logits0.float(), dim=-1)
        scores, nxt0 = _top_k(logp0, beams)            # [B, beams]
        prev = nxt0.reshape(-1)                        # [B·beams]
        rep = lambda c: c.repeat_interleave(beams, dim=0)
        caches = [tuple(map(rep, c)) if isinstance(c, tuple) else rep(c)
                  for c in caches_b]
        gen = torch.zeros((R, n_new), dtype=torch.int64, device=toks.device)
        gen[:, 0] = prev
        base = torch.arange(b, device=toks.device)[:, None] * beams
        for i in range(n_new - 1):
            # prev sits at position t0+i; _token_logits writes its KV
            # row before attending
            logits, caches = self._token_logits(params, prev, caches,
                                                t0 + i, R)
            logp = torch.log_softmax(logits.float(), dim=-1)
            tot = scores[:, :, None] + logp.reshape(b, beams, V)
            scores, flat = _top_k(tot.reshape(b, beams * V), beams)
            rowsel = (base + flat // V).reshape(-1)
            nxt = (flat % V).reshape(-1)
            # hypotheses and their KV caches follow the parent beam
            take = lambda c: c.index_select(0, rowsel)
            gen = take(gen)
            caches = [tuple(map(take, c)) if isinstance(c, tuple)
                      else take(c) for c in caches]
            gen[:, i + 1] = nxt
            prev = nxt
        best = torch.argmax(scores, dim=1)             # [B]
        return gen[torch.arange(b, device=toks.device) * beams + best]


def GPTNano(**kw) -> CausalTransformerLM:
    """4-layer/128-hidden toy LM for tests and smoke runs."""
    kw.setdefault("vocab_size", 256)
    return CausalTransformerLM(hidden=128, n_layers=4, n_heads=4,
                               n_kv_heads=kw.pop("n_kv_heads", 2),
                               max_len=kw.pop("max_len", 256), **kw)


def GPTMini(**kw) -> CausalTransformerLM:
    """6-layer/384-hidden small LM (GPT-2-small-quarter scale)."""
    return CausalTransformerLM(hidden=384, n_layers=6, n_heads=6,
                               max_len=kw.pop("max_len", 1024), **kw)

