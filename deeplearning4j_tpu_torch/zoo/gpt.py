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
Decoding (``generate``, the gateway) is local. int8 weight and KV-cache
quantisation and beam search come with later slices.
"""
from __future__ import annotations

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


def _rms(x, gamma):
    """RMSNorm shared by the prefill forward and the per-token decode
    step: the Triton kernel on the card, the plain expression on the
    CPU (``ops/fused_norms.py``)."""
    return fused_norms.rms_norm(x, gamma, eps=fused_norms.RMSNORM_EPS)


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
        if serve_quant is not None:
            raise ValueError(f"serve_quant={serve_quant!r}: int8 "
                             "weight-only serving is not ported yet "
                             "(None only)")
        if cache_quant is not None:
            raise ValueError(f"cache_quant={cache_quant!r}: the int8 KV "
                             "cache is not ported yet (None only)")
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
        prompt_np = np.asarray(prompt, np.int32)
        b, t0 = prompt_np.shape
        if n_new <= 0:
            return prompt_np
        if t0 + n_new > self.max_len:
            raise ValueError(f"prompt+new ({t0 + n_new}) exceeds "
                             f"max_len={self.max_len}")
        tb = prompt_bucket(t0, self.max_len)
        params = net.params if isinstance(net, MultiLayerNetwork) else net
        p = self._decode_params(params)
        dev = p["layer_0"]["W"].device
        pad = np.zeros((b, tb), np.int64)
        pad[:, :t0] = prompt_np
        toks = torch.as_tensor(pad, device=dev)
        sample = temperature > 0
        if sample and generator is None:
            self._gen_calls += 1
            generator = torch.Generator(device=dev).manual_seed(
                self._gen_calls)
        ts1 = obs.now()
        gen = self._decode_gen(
            p, toks, t0, temperature or 1.0,
            1.0 if top_p is None else top_p, generator, b=b, tb=tb,
            n_new=n_new, sample=sample, top_k=top_k,
            nucleus=top_p is not None)
        ts2 = obs.now()
        gen_np = gen.cpu().numpy().astype(np.int32)   # device sync
        obs.record_step("CausalTransformerLM.generate", ts0, ts1, ts2,
                        obs.now())
        return np.concatenate([prompt_np, gen_np], axis=1)

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
        JAX layout; this position's k/v are written into it IN PLACE
        (the JAX code returns an updated copy)."""
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
                ckv[:, :, :, pos] = torch.cat([k, v[:, 0]], dim=2)
                ck, cv = ckv[:, :, :hd, :], ckv[:, :, hd:, :]
                qg = q.reshape(rows, n_kv, groups, hd)
                s = torch.einsum("bkgd,bkdt->bkgt", qg, ck) / torch.sqrt(
                    torch.tensor(hd, dtype=x.dtype))
                live = torch.arange(ck.shape[3], device=x.device) <= pos
                s = s.masked_fill(~live, -1e9)
                w = torch.softmax(s, dim=-1)
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
        cache_len] and yields the logits at the last real prompt
        position ``t0 - 1``. Attention goes through
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
                kv = x.new_zeros((bsz, n_kv, 2 * hd, cache_len))
                kv[..., :tb] = torch.cat([k.permute(0, 2, 3, 1),
                                          v.permute(0, 2, 3, 1)], dim=2)
                caches.append(kv)
        with obs.devtime.scope("prefill.lm_head"):
            x = _rms(x, params[f"layer_{self.n_layers + 1}"]["gamma"])
            logits = self._head_logits(params, x[:, t0 - 1])
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
        the KV caches and every per-token matmul run in it."""
        if self.compute_dtype is None:
            return params
        return dtypes.cast_float_tree(params, self.compute_dtype)

    def _decode_params(self, params):
        """Cast ONCE per params version: repeated calls against
        unchanged params reuse the prepared copy. Staleness-safe by
        LEAF identity through weakrefs: replacing any tensor in the
        tree invalidates the cache, and the cache never pins the old
        tensors."""
        if self.compute_dtype is None:
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

