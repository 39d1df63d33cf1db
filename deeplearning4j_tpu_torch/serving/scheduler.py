"""Continuous-batching decode scheduler — one fixed-shape decode step.

Port of ``deeplearning4j_tpu/serving/scheduler.py``. Every iteration
runs ONE decode step over ``(max_slots,)`` rows against the paged KV
pool (``kv_pager.py``): each active slot advances one token, new
sequences are admitted *into the running loop* by prefilling into free
pages (at the power-of-two buckets ``generate()`` uses —
``zoo.gpt.prompt_bucket`` is shared), and finished sequences release
their pages without anything changing shape.

Attention math mirrors ``zoo/gpt.py::_token_logits`` value for value
(same ``_quant_kv`` codes and scales under ``cache_quant="int8"``, same
scale factoring out of the einsums, same -1e9 mask), so padded and
trash positions contribute exact zeros after softmax and paged greedy
decode is TOKEN-IDENTICAL to dense ``generate()``
(``tests/test_torch_serving.py`` and ``tests/test_torch_serving_opts.py``
hold it to that, for the float and the int8 pool). The dense prefill
runs ``_prefill_forward``, so on the card each such admission launches
the flash kernel once per layer; the RMSNorm kernel runs twice per
block plus once for the head, in every prefill and every step.

Two opt-in multipliers ride the same machinery. With ``spec_k > 1``
(one of :data:`SPEC_KS`) each iteration drafts k-1 tokens on the host
(prompt lookup over the slot's own history — no second model),
verifies all k in ONE forward over ``[S, k]`` rows
(:meth:`DecodeScheduler._paged_rows_step`) and emits the agreeing
prefix: an accepted row's cache context is exactly the sequential
path's, so greedy speculative output is the dense ``generate()``
output. With ``prefix_sharing=True`` admission consults the pager's
page-chain index: a prompt whose prefix already sits in live pages
ADOPTS them (refcount++), prefill runs only on the novel suffix (the
same multirow step, no flash kernel), and any write to a page with
refcount > 1 first copies it (copy-on-write) so siblings never observe
the writer.

The pool is updated IN PLACE (``index_put_`` through indexed
assignment) where the JAX code donates it and rebinds the result.

The scheduler is single-threaded host logic (the gateway's worker
drives it); requests are duck-typed: ``.prompt`` (1-D int32),
``.max_new``, ``.temperature``, ``.eos_id``, and ``push(tok)`` /
``finish()`` / ``fail(exc)`` callbacks (``gateway.TokenStream``).

**Entry points** (``perf/sentry.py``), the JAX package's five programs
under its names: ``serving.decode_step``, ``serving.spec_step_k{k}``,
``serving.prefill`` (one a prompt bucket), ``serving.suffix_prefill``
(one a suffix bucket) and ``serving.cow_copy``. :meth:`DecodeScheduler.
warmup` declares all of them before traffic. On the card the first four
replay a CUDA graph per signature (captured at warmup, or at first use):
the prepared decode parameters are read in place, the prompt's length,
a suffix's start and the request's temperature come in as 0-d tensors
on the device (one graph a bucket), the pool is written in place as the
eager step writes it, and the sampling generator is registered with the
graphs, so a replay draws what the eager step draws and advances the
generator as it does. ``cow_copy`` stays an eager PyTorch copy of one
page (``ROADMAP.md`` A17).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.perf import sentry
from deeplearning4j_tpu_torch.serving.kv_pager import KVPager
from deeplearning4j_tpu_torch.zoo.gpt import (_quant_kv, _rms, _row,
                                              prompt_bucket)

#: the speculative-decode k grid: ``spec_k`` must come from this tuple,
#: as in the JAX package (whose warmup pre-compiles exactly this grid)
SPEC_KS = (2, 4, 8)


def _rotary_rows(x, theta: float, pos):
    """RoPE at one position PER ROW: ``x`` [S, H, D], ``pos`` [S] int.
    Per row the same values as ``rotary_embedding(x[:, None],
    offset=pos_scalar)[:, 0]`` (same f32 angle math, same half-split
    pairing)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.to(torch.float32)[:, None] * freqs[None, :]  # [S, D/2]
    cos = torch.cos(ang)[:, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class _Slot:
    """Host state of one occupied decode slot."""

    __slots__ = ("req", "length", "remaining", "history")

    def __init__(self, req, length: int, remaining: int,
                 history: Optional[list] = None):
        self.req = req
        self.length = length        # cache positions written so far
        self.remaining = remaining  # tokens still to generate
        # prompt + emitted tokens, host-side: the prompt-lookup draft
        # source for speculative decode
        self.history = history if history is not None else []


class DecodeScheduler:
    """In-flight batched decode over a shared paged KV pool.

    ``max_context`` bounds prompt+generation per sequence (a multiple of
    ``block``, at most ``model.max_len``); ``n_pages`` sizes the pool
    (default: enough for every slot at full context). Sampling config
    is gateway-level (``sample``/``top_k``/``top_p``); per-request
    ``temperature`` rides in a per-slot vector. The pool lives on the
    device ``params`` live on; sampling draws from one
    ``torch.Generator`` there, seeded with ``seed``. ``spec_k`` (1 or
    one of :data:`SPEC_KS`, greedy only) and ``prefix_sharing`` turn on
    speculative decode and copy-on-write prefix sharing.
    """

    def __init__(self, model, params, *, max_slots: int = 8,
                 block: int = 16, n_pages: Optional[int] = None,
                 max_context: Optional[int] = None,
                 sample: bool = False, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0,
                 spec_k: int = 1, prefix_sharing: bool = False):
        self.model = model
        self.params = params
        self.max_slots = int(max_slots)
        self.block = int(block)
        mc = int(max_context or model.max_len)
        if mc > model.max_len:
            raise ValueError(f"max_context={mc} exceeds model "
                             f"max_len={model.max_len}")
        if mc % self.block:
            raise ValueError(f"max_context={mc} must be a multiple of "
                             f"block={self.block} so pages tile every "
                             "prompt bucket exactly")
        if min(16, mc) % self.block:
            raise ValueError(f"block={self.block} must divide the "
                             "smallest prompt bucket (16)")
        self.max_context = mc
        self.max_pages_per_seq = mc // self.block
        self.sample = bool(sample)
        self.top_k = top_k
        self.top_p = top_p
        self.seed = int(seed)
        self.spec_k = int(spec_k)
        if self.spec_k != 1:
            if self.spec_k not in SPEC_KS:
                raise ValueError(f"spec_k={spec_k} not in SPEC_KS="
                                 f"{SPEC_KS}")
            if self.sample:
                raise ValueError(
                    "speculative decode is greedy-only: the accept rule "
                    "compares per-row argmax against the draft; under "
                    "sampling it would skew the distribution")
        self.prefix_sharing = bool(prefix_sharing)
        self.device = params["layer_0"]["W"].device
        hd = model.hidden // model.n_heads
        self.pager = KVPager(
            n_layers=model.n_layers, n_kv_heads=model.n_kv_heads,
            head_dim=hd, block=self.block,
            n_pages=(int(n_pages) if n_pages
                     else 1 + self.max_slots * self.max_pages_per_seq),
            cache_quant=model.cache_quant,
            dtype=model.compute_dtype or "float32", device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.seed)
        # per-slot host state, mirrored into the small int tensors the
        # fixed-shape step consumes each iteration
        self._slots: List[Optional[_Slot]] = [None] * self.max_slots
        self._page_table = np.zeros(
            (self.max_slots, self.max_pages_per_seq), np.int64)
        self._lengths = np.zeros(self.max_slots, np.int64)
        self._prev = np.zeros(self.max_slots, np.int64)
        self._temps = np.ones(self.max_slots, np.float32)
        # device-side feed: in steady state the step feeds back its own
        # outputs (prev=nxt, lengths advanced) and the static tensors
        # stay resident — no host->device copy per token but the spec
        # drafts; any admit, retire, shed or copy-on-write marks the
        # feed dirty for a one-shot rebuild
        self._dev_feed: Optional[dict] = None
        self._feed_dirty = True
        self.steps = 0
        self.tokens_out = 0
        # the entry points (perf/sentry.py)
        self._step_fn = self._program("_decode_step", "serving.decode_step")
        self._spec_fn = self._program("_spec_step",
                                      f"serving.spec_step_k{self.spec_k}")
        self._admit_fns: Dict[int, sentry.SentryJit] = {}
        self._suffix_fns: Dict[int, sentry.SentryJit] = {}
        self._cow_fn = sentry.jit(lambda src, dst: self._cow_copy(src, dst),
                                  name="serving.cow_copy")

    def _program(self, method: str, name: str) -> sentry.SentryJit:
        """A capturable entry point that calls the instance's ``method``
        at each call (a method patched on the instance included)."""
        return sentry.jit(lambda *a: getattr(self, method)(*a), name=name,
                          capture=True, const=(0,),
                          generators=lambda: [self._gen])

    def _admit_fn(self, tb: int) -> sentry.SentryJit:
        """``serving.prefill`` at prompt bucket ``tb`` (one a bucket, as
        in the JAX scheduler)."""
        if tb not in self._admit_fns:
            self._admit_fns[tb] = self._program("_prefill_into_pages",
                                                "serving.prefill")
        return self._admit_fns[tb]

    def _suffix_fn(self, sb: int) -> sentry.SentryJit:
        """``serving.suffix_prefill`` at suffix bucket ``sb``."""
        if sb not in self._suffix_fns:
            self._suffix_fns[sb] = self._program("_suffix_first",
                                                 "serving.suffix_prefill")
        return self._suffix_fns[sb]

    # -- device programs --------------------------------------------------
    def _pick(self, logits, temp):
        """The gateway's pick rule on [rows, V] logits (``temp`` a 0-d
        or a [rows, 1] tensor)."""
        return self.model._pick(logits, temp,
                                1.0 if self.top_p is None else self.top_p,
                                self._gen, sample=self.sample,
                                top_k=self.top_k,
                                nucleus=self.top_p is not None)

    def _decode_logits(self, params, pt, lengths, active, prev):
        """One decode position for every slot: token ids [S] -> logits
        [S, V]; the pool is written in place (each active slot writes
        its position's KV into its own page, inactive slots into the
        trash page)."""
        model = self.model
        L = model.n_layers
        with obs.devtime.scope("paged_decode.embed"):
            x = params["layer_0"]["W"][prev]        # [S, F]
        for i in range(L):
            with obs.devtime.scope(f"paged_decode.block_{i}"):
                x = self._paged_block_step(params[f"layer_{i + 1}"], i, x,
                                           pt, lengths, active)
        with obs.devtime.scope("paged_decode.lm_head"):
            x = _rms(x, params[f"layer_{L + 1}"]["gamma"])
            return model._head_logits(params, x)

    def _decode_step(self, params, pt, lengths, active, prev, temps):
        """One decode iteration for every slot: token ids [S] -> next
        token ids [S] and the advanced lengths."""
        logits = self._decode_logits(params, pt, lengths, active, prev)
        nxt = self._pick(logits, temps[:, None])
        nxt = torch.where(active, nxt, torch.zeros_like(nxt))
        return nxt, lengths + active.to(lengths.dtype)

    def _write_kv(self, li, pids, offs, kv):
        """Scatter k/v rows ``kv`` [..., Kv, 2D] (compute dtype) into
        layer ``li`` of the pool at pages ``pids`` and in-page offsets
        ``offs`` (both of shape ``[...]``), in place: quantised by
        ``_quant_kv`` (scales per row, head and half) into the int8
        pool. Several inactive rows may hit the trash page at one
        offset; which one lands there is never read."""
        hd = self.pager.head_dim
        if self.model.cache_quant:
            codes, scales = self.pager.pool
            q8, s_new = _quant_kv(
                kv.reshape(*kv.shape[:-1], 2, hd), kv.dim())
            codes[li, pids, :, :, offs] = q8.reshape(kv.shape)
            scales[li, pids, :, :, offs] = s_new
        else:
            (kvpool,) = self.pager.pool
            kvpool[li, pids, :, :, offs] = kv.to(kvpool.dtype)

    def _context(self, li, pt, dtype):
        """Layer ``li``'s cache of every slot in position order: the
        page-table gather of the WHOLE table row (all
        ``max_pages_per_seq`` pages, as the JAX step reads it), as k and
        v [S, Kv, D, T] in ``dtype``, and under int8 the k and v scales
        [S, Kv, T] f32 (else None) — they stay out of the einsums."""
        S = pt.shape[0]
        n_kv, hd = self.pager.n_kv_heads, self.pager.head_dim
        order = lambda a, c: a[li, pt].permute(0, 2, 3, 1, 4).reshape(
            S, n_kv, c, -1)
        if self.model.cache_quant:
            codes, scales = self.pager.pool
            ctx = order(codes, 2 * hd)
            sc = order(scales, 2)
            return (ctx[:, :, :hd, :].to(dtype), ctx[:, :, hd:, :].to(dtype),
                    sc[:, :, 0, :], sc[:, :, 1, :])
        (kvpool,) = self.pager.pool
        ctx = order(kvpool, 2 * hd)
        return ctx[:, :, :hd, :], ctx[:, :, hd:, :], None, None

    def _paged_block_step(self, pblk, li, x, pt, pos, active):
        """One transformer block at one position per slot, reading and
        writing the paged pool. Mirrors ``_token_logits``'s block value
        for value; only the cache addressing differs: the write goes to
        page ``pt[s, pos//block]`` offset ``pos%block``, the context is
        the slot's page-table gather reshaped back to position order."""
        model = self.model
        S = self.max_slots
        hd = model.hidden // model.n_heads
        n_kv = model.n_kv_heads
        h = _rms(x, pblk["ln1"]["gamma"])
        mha = pblk["mha"]
        q = (h @ mha["Wq"]).reshape(S, model.n_heads, hd)
        k = (h @ mha["Wk"]).reshape(S, n_kv, hd)
        v = (h @ mha["Wv"]).reshape(S, n_kv, hd)
        q = _rotary_rows(q, model.rope_theta, pos)
        k = _rotary_rows(k, model.rope_theta, pos)
        rows = torch.arange(S, device=x.device)
        # inactive slots scatter into the reserved trash page — the
        # step's shape never depends on how many slots are live
        page_idx = (pos // self.block).clamp(max=pt.shape[1] - 1)
        pids = torch.where(active, pt[rows, page_idx], 0)
        self._write_kv(li, pids, pos % self.block,
                       torch.cat([k, v], dim=2))        # [S, Kv, 2D]
        ck, cv, k_scale, v_scale = self._context(li, pt, x.dtype)
        groups = model.n_heads // n_kv
        qg = q.reshape(S, n_kv, groups, hd)
        s = torch.einsum("bkgd,bkdt->bkgt", qg, ck) / torch.sqrt(
            torch.tensor(hd, dtype=x.dtype))
        if k_scale is not None:
            s = (s * k_scale[:, :, None, :]).to(x.dtype)
        # per-slot causal mask; positions past a slot's pages resolve to
        # trash-page junk but always sit beyond its length, so the mask
        # keeps them at exact-zero softmax weight
        live = (torch.arange(ck.shape[3], device=x.device)[None, :]
                <= pos[:, None])
        s = s.masked_fill(~live[:, None, None, :], -1e9)
        w = torch.softmax(s, dim=-1)
        if v_scale is not None:
            w = (w * v_scale[:, :, None, :]).to(x.dtype)
        a = torch.einsum("bkgt,bkdt->bkgd", w, cv).reshape(S, -1)
        x = x + a @ mha["Wo"] + mha["bo"]
        h = _rms(x, pblk["ln2"]["gamma"])
        h = F.silu(h @ pblk["Wg"]) * (h @ pblk["Wu"])
        return x + h @ pblk["Wd"]

    def _paged_rows_step(self, pblk, li, x, pt, pos, act):
        """One transformer block at R positions per slot — the multirow
        form of :meth:`_paged_block_step` that the speculative verify
        step and the shared-prefix suffix prefill both run. ``x`` is
        [S, R, F], ``pos`` [S, R] int, ``act`` bool broadcastable to
        [S, R] (False rows scatter into the trash page). Every matmul
        runs on the flattened [S*R, F] view and the attention einsums
        grow an ``r`` axis, so each row's arithmetic is the single-row
        step's. A position past the slot's page table is clamped
        EXPLICITLY and its write sent to the trash page: a junk row
        never lands in a live page."""
        model = self.model
        S, R = x.shape[0], x.shape[1]
        hd = model.hidden // model.n_heads
        n_kv = model.n_kv_heads
        block = self.block
        h = _rms(x.reshape(S * R, -1), pblk["ln1"]["gamma"])
        mha = pblk["mha"]
        q = (h @ mha["Wq"]).reshape(S * R, model.n_heads, hd)
        k = (h @ mha["Wk"]).reshape(S * R, n_kv, hd)
        v = (h @ mha["Wv"]).reshape(S * R, n_kv, hd)
        pflat = pos.reshape(S * R)
        q = _rotary_rows(q, model.rope_theta, pflat).reshape(
            S, R, model.n_heads, hd)
        k = _rotary_rows(k, model.rope_theta, pflat)
        kv = torch.cat([k.reshape(S, R, n_kv, hd),
                        v.reshape(S, R, n_kv, hd)], dim=3)  # [S,R,Kv,2D]
        cap = pt.shape[1] * block
        inb = act & (pos < cap)
        pidx = (pos // block).clamp(max=pt.shape[1] - 1)
        pids = torch.where(inb, torch.gather(pt, 1, pidx), 0)
        self._write_kv(li, pids, pos % block, kv)
        ck, cv, k_scale, v_scale = self._context(li, pt, x.dtype)
        groups = model.n_heads // n_kv
        qg = q.permute(0, 2, 1, 3).reshape(S, n_kv, groups, R, hd)
        s = torch.einsum("bkgrd,bkdt->bkgrt", qg, ck) / torch.sqrt(
            torch.tensor(hd, dtype=x.dtype))
        if k_scale is not None:
            s = (s * k_scale[:, :, None, None, :]).to(x.dtype)
        # per-ROW causal mask: row r sees keys <= pos[s, r]. The scatter
        # above runs before the gather, so a row attends its own key and
        # every earlier row's — later rows' keys (and stale speculative
        # rows past the accepted length) sit beyond pos, at exact-zero
        # softmax weight
        live = (torch.arange(ck.shape[3], device=x.device)[None, None, :]
                <= pos[:, :, None])                      # [S, R, T]
        s = s.masked_fill(~live[:, None, None, :, :], -1e9)
        w = torch.softmax(s, dim=-1)
        if v_scale is not None:
            w = (w * v_scale[:, :, None, None, :]).to(x.dtype)
        a = torch.einsum("bkgrt,bkdt->bkgrd", w, cv).permute(
            0, 3, 1, 2, 4).reshape(S * R, -1)
        x = x + (a @ mha["Wo"] + mha["bo"]).reshape(S, R, -1)
        h = _rms(x.reshape(S * R, -1), pblk["ln2"]["gamma"])
        h = F.silu(h @ pblk["Wg"]) * (h @ pblk["Wu"])
        return x + (h @ pblk["Wd"]).reshape(S, R, -1)

    def _rows_forward(self, params, toks, pt, pos, act, scope: str):
        """Token ids [S, R] at positions ``pos`` through every block by
        :meth:`_paged_rows_step`: the last block's output [S, R, F]."""
        S, R = toks.shape
        with obs.devtime.scope(f"{scope}.embed"):
            x = params["layer_0"]["W"][toks.reshape(-1)].reshape(S, R, -1)
        for i in range(self.model.n_layers):
            with obs.devtime.scope(f"{scope}.block_{i}"):
                x = self._paged_rows_step(params[f"layer_{i + 1}"], i, x,
                                          pt, pos, act)
        return x

    def _spec_logits(self, params, pt, lengths, active, prev, drafts):
        """The verify forward: ``prev`` and the k-1 ``drafts`` [S, k-1]
        of every slot as ONE [S, k] batch of rows at positions
        ``lengths .. lengths+k-1``; logits [S, k, V]."""
        model = self.model
        S, k = drafts.shape[0], drafts.shape[1] + 1
        toks = torch.cat([prev[:, None], drafts], dim=1)
        pos = (lengths[:, None]
               + torch.arange(k, dtype=lengths.dtype,
                              device=lengths.device)[None, :])
        x = self._rows_forward(params, toks, pt, pos, active[:, None],
                               "spec_decode")
        with obs.devtime.scope("spec_decode.lm_head"):
            h = _rms(x.reshape(S * k, -1),
                     params[f"layer_{model.n_layers + 1}"]["gamma"])
            return model._head_logits(params, h).reshape(S, k, -1)

    def _spec_step(self, params, pt, lengths, active, prev, drafts):
        """Speculative verify step: per-row greedy argmax ``m`` [S, k]
        (the argmax ``_pick(sample=False)`` runs) and the accepted count
        ``e`` [S] — 1 plus the agreeing prefix of the drafts, 0 for an
        inactive slot. Because row r's cache context is exactly the
        sequential path's whenever drafts 1..r matched, every accepted
        token is the token single-step decode would have produced.
        Rejected rows leave stale KV at positions length+e..length+k-1;
        the next step's k writes start at length+e and e >= 1, so the
        stale rows are overwritten before any mask admits them. Returns
        (m, e, lengths + e, the last accepted token [S])."""
        logits = self._spec_logits(params, pt, lengths, active, prev,
                                   drafts)
        m = torch.argmax(logits, dim=-1)
        agree = (m[:, :-1] == drafts).to(lengths.dtype)
        e = 1 + torch.cumprod(agree, dim=1).sum(dim=1)
        e = torch.where(active, e, torch.zeros_like(e))
        m = torch.where(active[:, None], m, torch.zeros_like(m))
        prev_next = torch.gather(m, 1, (e - 1).clamp(min=0)[:, None])[:, 0]
        return m, e, lengths + e, prev_next

    def _prefill_logits_into_pages(self, params, page_ids, prompt_pad,
                                   t0):
        """ONE batched causal forward over the padded prompt (the same
        ``_prefill_forward`` the dense path runs), its per-layer caches
        written into this sequence's pages in place; returns the logits
        [1, V] at position ``t0 - 1`` (``t0`` an int or a 0-d tensor)."""
        model = self.model
        tb = prompt_pad.shape[1]
        n_chunks = tb // self.block
        logits0, caches = model._prefill_forward(params, prompt_pad, tb,
                                                 t0)
        # [L, Kv, C, tb] -> [L, n_chunks, Kv, C, block]: page p covers
        # positions p*block..(p+1)*block-1
        paged = lambda a: a.reshape(
            a.shape[0], a.shape[1], a.shape[2], n_chunks, self.block
        ).permute(0, 3, 1, 2, 4)
        if model.cache_quant:
            codes, scales = self.pager.pool
            codes[:, page_ids] = paged(torch.stack([c[0][0]
                                                    for c in caches]))
            scales[:, page_ids] = paged(torch.stack([c[1][0]
                                                     for c in caches]))
        else:
            (kvpool,) = self.pager.pool
            kv = torch.stack([c[0] for c in caches])   # [L, Kv, 2D, tb]
            kvpool[:, page_ids] = paged(kv).to(kvpool.dtype)
        return logits0

    def _prefill_into_pages(self, params, page_ids, prompt_pad, t0, temp):
        """Prefill-into-pages and the pick of the first generated
        token (the same ``_pick`` the dense path runs)."""
        return self._pick(self._prefill_logits_into_pages(
            params, page_ids, prompt_pad, t0), temp)

    def _suffix_logits(self, params, page_row, suffix_pad, start, t0):
        """Prefill ONLY the novel suffix of a shared-prefix admission:
        positions ``0 .. start-1`` already sit in adopted pages, so the
        ``sb``-bucketed suffix rows (``suffix_pad`` [1, sb]) run through
        :meth:`_paged_rows_step` with S = 1 — they attend the shared
        pages through the slot's page-table row ``page_row`` [MP] and
        write their own KV into its novel (or copied) pages; rows past
        ``t0 - 1`` write the trash page. No flash kernel runs, as in the
        JAX package. Returns the logits [1, V] of prompt row
        ``t0 - 1``. ``start`` and ``t0`` are ints or 0-d tensors on the
        device."""
        model = self.model
        sb = suffix_pad.shape[1]
        ar = torch.arange(sb, device=suffix_pad.device)
        x = self._rows_forward(params, suffix_pad, page_row[None],
                               (start + ar)[None], (ar < t0 - start)[None],
                               "suffix_prefill")
        with obs.devtime.scope("suffix_prefill.lm_head"):
            row = _row(x, t0 - 1 - start)
            h = _rms(row, params[f"layer_{model.n_layers + 1}"]["gamma"])
            return model._head_logits(params, h)

    def _suffix_first(self, params, page_row, suffix_pad, start, t0,
                      temp):
        """The suffix prefill and the pick of the first generated token
        (the dense admission's pick rule)."""
        return self._pick(self._suffix_logits(params, page_row, suffix_pad,
                                              start, t0), temp)

    def _cow_copy(self, src: int, dst: int) -> None:
        """Copy one physical page of every pool tensor (all layers; codes
        AND scales), in place — the copy-on-write primitive: a writer
        holding a page whose refcount exceeds one clones it before its
        next KV write, so sibling readers keep the original bytes."""
        for a in self.pager.pool:
            a[:, dst] = a[:, src]

    # -- host-side scheduling -------------------------------------------
    def pages_needed(self, t0: int, max_new: int) -> int:
        """Pages a (prompt, budget) pair needs for its WHOLE life: the
        prefilled bucket plus every decode write (positions
        ``t0 .. t0+max_new-2``) — reserved up front so an admitted
        sequence can never stall mid-flight on an empty free list."""
        tb = prompt_bucket(t0, self.max_context)
        return self.pager.pages_for(max(tb, t0 + max_new - 1))

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def can_admit(self, t0: int, max_new: int) -> bool:
        return (self.free_slot() is not None
                and self.pages_needed(t0, max_new)
                <= self.pager.free_pages())

    def active_count(self) -> int:
        return sum(s is not None for s in self._slots)

    @torch.no_grad()
    def admit(self, req) -> bool:
        """Prefill ``req`` into free pages and occupy a slot; emits the
        first generated token (the TTFT token). Under ``prefix_sharing``
        a prompt whose prefix is indexed adopts those pages instead
        (:meth:`_admit_shared`). Returns False when capacity is lacking
        — the caller keeps it queued."""
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        t0, max_new = prompt.shape[0], int(req.max_new)
        slot = self.free_slot()
        if slot is None:
            return False
        if self.prefix_sharing:
            match = self.pager.match_prefix(prompt)
            if match is not None:
                return self._admit_shared(req, slot, prompt, t0, max_new,
                                          match)
        tb = prompt_bucket(t0, self.max_context)
        pages = self.pager.alloc(self.pages_needed(t0, max_new), req)
        if pages is None:
            return False
        ts0 = obs.now()
        row = self._page_table[slot]
        row[:] = 0
        row[:len(pages)] = pages
        pad = np.zeros((1, tb), np.int64)
        pad[0, :t0] = prompt
        # `is not None`, never truthiness: the gateway rejects
        # temperature <= 0 at submit
        temp = getattr(req, "temperature", None)
        try:
            dev = self.device
            page_ids = torch.as_tensor(
                np.asarray(pages[:tb // self.block], np.int64),
                device=dev)
            prompt_pad = torch.as_tensor(pad, device=dev)
            ts1 = obs.now()
            g0 = self._admit_fn(tb)(
                self.model._decode_params(self.params), page_ids,
                prompt_pad, self._scalar(t0), self._temp(temp))
            ts2 = obs.now()
            first = int(g0[0])                  # blocking device sync
        except BaseException:
            # a failed prefill must not leak the reservation (the slot
            # was never occupied; its table row resets)
            self._page_table[slot] = 0
            self._feed_dirty = True
            self.pager.release(req)
            raise
        ts3 = obs.now()
        obs.record_step("serving.prefill", ts0, ts1, ts2, ts3)
        obs.metrics.SERVING_PREFILL.observe(ts3 - ts0)
        if self.prefix_sharing:
            # publish this prompt's page chain so later admissions with
            # the same prefix adopt the pages instead of re-prefilling
            self.pager.register_chain(prompt, pages)
        self._occupy(slot, req, t0, max_new, first, temp, prompt)
        return True

    def _admit_shared(self, req, slot, prompt, t0: int, max_new: int,
                      match) -> bool:
        """Admit ``req`` by ADOPTING a matched prefix chain: incref the
        shared pages, allocate only the novel remainder of the
        whole-life reservation, and prefill just the suffix. A
        whole-prompt (tail) match copies the final shared page first —
        position ``t0-1`` is recomputed there to recover the first-token
        logits, and that write may not touch a page siblings still
        read."""
        shared_len, spages, tail = match
        total = self.pages_needed(t0, max_new)
        novel = total - len(spages) + (1 if tail else 0)
        suffix = t0 - shared_len
        sb = prompt_bucket(suffix, self.max_context)
        new_pages = self.pager.alloc(novel, req)
        if new_pages is None:
            return False
        ts0 = obs.now()
        try:
            self.pager.adopt(spages, req)
        except BaseException:
            self.pager.release(req)
            raise
        try:
            if tail:
                old_tail = spages[-1]
                target = new_pages[0]
                self._cow_fn(old_tail, target)
                self.pager.drop_ref(req, old_tail)
                obs.metrics.SERVING_PREFIX_COW.inc()
                row_pages = (list(spages[:-1]) + [target]
                             + list(new_pages[1:]))
            else:
                row_pages = list(spages) + list(new_pages)
            row = self._page_table[slot]
            row[:] = 0
            row[:len(row_pages)] = row_pages
            pad = np.zeros((1, sb), np.int64)
            pad[0, :suffix] = prompt[shared_len:]
            temp = getattr(req, "temperature", None)
            dev = self.device
            page_row = torch.as_tensor(row, device=dev)
            suffix_pad = torch.as_tensor(pad, device=dev)
            ts1 = obs.now()
            # the first token by the dense admission's pick rule
            g0 = self._suffix_fn(sb)(
                self.model._decode_params(self.params), page_row,
                suffix_pad, self._scalar(shared_len), self._scalar(t0),
                self._temp(temp))
            ts2 = obs.now()
            first = int(g0[0])                  # blocking device sync
        except BaseException:
            # one release drops BOTH the adopted refs and the novel
            # pages — shared pages survive for their siblings
            self._page_table[slot] = 0
            self._feed_dirty = True
            self.pager.release(req)
            raise
        ts3 = obs.now()
        obs.record_step("serving.prefill", ts0, ts1, ts2, ts3)
        obs.metrics.SERVING_PREFILL.observe(ts3 - ts0)
        obs.metrics.SERVING_PREFIX_HITS.inc()
        obs.metrics.SERVING_PREFIX_SAVED.inc(shared_len)
        self.pager.register_chain(prompt, row_pages)
        self._occupy(slot, req, t0, max_new, first, temp, prompt)
        return True

    def _occupy(self, slot: int, req, t0: int, max_new: int,
                first: int, temp, prompt) -> None:
        """Post-prefill slot bookkeeping shared by the dense and the
        shared-prefix admissions: mirror state, emit the TTFT token,
        retire immediately if the budget was one token."""
        self._slots[slot] = _Slot(req, length=t0, remaining=max_new - 1,
                                  history=list(map(int, prompt))
                                  + [first])
        self._lengths[slot] = t0
        self._prev[slot] = first
        self._temps[slot] = 1.0 if temp is None else temp
        self._feed_dirty = True
        obs.metrics.SERVING_SLOTS.set(self.active_count())
        req.push(first)
        obs.metrics.SERVING_TOKENS.inc()
        self.tokens_out += 1
        if self._slots[slot].remaining <= 0 or first == getattr(
                req, "eos_id", None):
            self._retire(slot)

    def _scalar(self, n: int) -> torch.Tensor:
        """``n`` as a 0-d int64 tensor on the device (filled there: no
        host copy)."""
        return torch.full((), int(n), dtype=torch.int64,
                          device=self.device)

    def _temp(self, temp) -> torch.Tensor:
        """A request's temperature (1.0 when it has none) as a 0-d f32
        tensor on the device, as the JAX scheduler passes it: one
        prefill graph a bucket serves every temperature."""
        return torch.full((), 1.0 if temp is None else float(temp),
                          dtype=torch.float32, device=self.device)

    def _ensure_feed(self, act) -> dict:
        """Rebuild the device-side feed if an admit/retire/shed dirtied
        it; otherwise hand back the resident tensors."""
        if self._feed_dirty or self._dev_feed is None:
            active = np.zeros(self.max_slots, bool)
            active[act] = True
            dev = self.device
            self._dev_feed = {
                "pt": torch.as_tensor(self._page_table, device=dev),
                "lengths": torch.as_tensor(self._lengths, device=dev),
                "active": torch.as_tensor(active, device=dev),
                "prev": torch.as_tensor(self._prev, device=dev),
                "temps": torch.as_tensor(self._temps, device=dev),
            }
            self._feed_dirty = False
        return self._dev_feed

    @torch.no_grad()
    def step(self) -> int:
        """One continuous-batching iteration: step every active slot one
        token, deliver, retire finished sequences (their pages go back
        to the free list). Returns tokens produced (0 = idle). With
        ``spec_k > 1`` the iteration runs the speculative
        draft/verify/accept step instead and can emit up to k tokens
        per slot."""
        act = [i for i, s in enumerate(self._slots) if s is not None]
        if not act:
            return 0
        if self.spec_k > 1:
            return self._step_spec(act)
        if self.prefix_sharing:
            # admission copies a shared tail eagerly, so a live slot
            # should never write a shared page — but if one slipped
            # through, clone it before the step can write it
            self._cow_writable(act, 1)
        ts0 = obs.now()
        f = self._ensure_feed(act)
        ts1 = obs.now()
        nxt, len_next = self._step_fn(
            self.model._decode_params(self.params), f["pt"],
            f["lengths"], f["active"], f["prev"], f["temps"])
        # feed the step's own outputs back: no h2d on the clean path
        f["prev"], f["lengths"] = nxt, len_next
        ts2 = obs.now()
        toks = nxt.cpu().numpy()                # blocking device sync
        ts3 = obs.now()
        self.steps += 1
        for i in act:
            s = self._slots[i]
            tok = int(toks[i])
            self._lengths[i] += 1
            self._prev[i] = tok
            s.length += 1
            s.remaining -= 1
            s.req.push(tok)
            if s.remaining <= 0 or tok == getattr(s.req, "eos_id",
                                                  None):
                self._retire(i)
        obs.record_step("serving.decode_step", ts0, ts1, ts2, ts3)
        obs.metrics.SERVING_STEP.observe(ts3 - ts0)
        obs.metrics.SERVING_TOKENS.inc(len(act))
        self.tokens_out += len(act)
        return len(act)

    def _step_spec(self, act) -> int:
        """One speculative iteration: host-draft k-1 tokens per slot
        (prompt lookup over its history — the one small host->device
        copy this mode pays per step), verify all k in one step, deliver
        the accepted prefix. The tokens and accepted counts come to the
        host in ONE copy. Device lengths advance by the accepted count;
        a slot that retires mid-acceptance (eos or budget) dirties the
        feed, so the rebuilt mirror re-synchronises the truncation."""
        k = self.spec_k
        if self.prefix_sharing:
            self._cow_writable(act, k)
        ts0 = obs.now()
        f = self._ensure_feed(act)
        drafts_np = np.zeros((self.max_slots, k - 1), np.int64)
        for i in act:
            drafts_np[i] = self._draft(self._slots[i].history, k - 1)
        drafts = torch.as_tensor(drafts_np, device=self.device)
        ts1 = obs.now()
        m, e, len_next, prev_next = self._spec_fn(
            self.model._decode_params(self.params), f["pt"],
            f["lengths"], f["active"], f["prev"], drafts)
        f["prev"], f["lengths"] = prev_next, len_next
        ts2 = obs.now()
        host = torch.cat([m, e[:, None]], dim=1).cpu().numpy()  # sync
        toks, counts = host[:, :k], host[:, k]
        ts3 = obs.now()
        self.steps += 1
        produced = 0
        for i in act:
            s = self._slots[i]
            n_acc = int(counts[i])
            pushed = 0
            retire = False
            for j in range(n_acc):
                tok = int(toks[i, j])
                s.req.push(tok)
                s.history.append(tok)
                pushed += 1
                s.remaining -= 1
                if s.remaining <= 0 or tok == getattr(s.req, "eos_id",
                                                      None):
                    retire = True
                    break
            s.length += pushed
            self._lengths[i] += pushed
            self._prev[i] = int(toks[i, pushed - 1])
            produced += pushed
            obs.metrics.SERVING_SPEC_DRAFTED.inc(k - 1)
            obs.metrics.SERVING_SPEC_ACCEPTED.inc(n_acc - 1)
            obs.metrics.SERVING_SPEC_ACCEPT.observe((n_acc - 1) / (k - 1))
            if retire:
                self._retire(i)
        obs.record_step("serving.spec_step", ts0, ts1, ts2, ts3)
        obs.metrics.SERVING_STEP.observe(ts3 - ts0)
        obs.metrics.SERVING_TOKENS.inc(produced)
        self.tokens_out += produced
        return produced

    def _cow_writable(self, act, k: int) -> None:
        """Copy-on-write every page the next step's k writes could touch
        if its refcount exceeds one: copy the bytes, swap the copy into
        this slot's table row, drop the reference on the original —
        sibling readers keep the shared page untouched."""
        for i in act:
            s = self._slots[i]
            length = int(self._lengths[i])
            lo = length // self.block
            hi = min((length + k - 1) // self.block,
                     self.max_pages_per_seq - 1)
            for pi in range(lo, hi + 1):
                pid = int(self._page_table[i, pi])
                if pid and self.pager.refcount(pid) > 1:
                    new = self.pager.cow(s.req, pid)
                    self._cow_fn(pid, new)
                    self._page_table[i, pi] = new
                    self._feed_dirty = True
                    obs.metrics.SERVING_PREFIX_COW.inc()

    @staticmethod
    def _draft(hist, n: int):
        """Prompt-lookup drafting: find the LATEST earlier occurrence of
        the trailing bigram (unigram fallback) in this slot's own
        history and propose its continuation; pad by repeating the last
        candidate. A wrong draft only costs the verify row it rode
        in."""
        L = len(hist)
        idx = None
        if L >= 2:
            a, b = hist[-2], hist[-1]
            for j in range(L - 3, -1, -1):
                if hist[j] == a and hist[j + 1] == b:
                    idx = j + 2
                    break
        if idx is None and L >= 1:
            a = hist[-1]
            for j in range(L - 2, -1, -1):
                if hist[j] == a:
                    idx = j + 1
                    break
        cand = list(hist[idx:idx + n]) if idx is not None else []
        last = cand[-1] if cand else (hist[-1] if hist else 0)
        while len(cand) < n:
            cand.append(last)
        return cand

    def _retire(self, slot: int) -> None:
        s = self._slots[slot]
        self._slots[slot] = None
        self._page_table[slot] = 0
        self._feed_dirty = True
        self.pager.release(s.req)
        obs.metrics.SERVING_SLOTS.set(self.active_count())
        s.req.finish()

    def shed_all(self, make_error) -> int:
        """Error out every in-flight sequence and release its pages — a
        failed step never leaves a wedged slot or a leaked page.
        ``make_error`` is a ZERO-ARG factory called once per stream."""
        n = 0
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            self._slots[i] = None
            self._page_table[i] = 0
            self.pager.release(s.req)
            s.req.fail(make_error())
            n += 1
        self._feed_dirty = True
        obs.metrics.SERVING_SLOTS.set(0)
        return n

    def evict(self, req) -> bool:
        """Cancel one in-flight sequence (client went away): free its
        slot and pages without erroring the stream."""
        for i, s in enumerate(self._slots):
            if s is not None and s.req is req:
                self._slots[i] = None
                self._page_table[i] = 0
                self._feed_dirty = True
                self.pager.release(req)
                obs.metrics.SERVING_SLOTS.set(self.active_count())
                req.finish()
                return True
        return False

    # -- warmup ------------------------------------------------------------
    @torch.no_grad()
    def warmup(self, prompt_lens=None) -> Dict[str, object]:
        """Declare and build every program of the configured mode BEFORE
        traffic (the JAX ``warmup``): the decode step, the prefill of
        every reachable prompt bucket, with ``spec_k > 1`` the verify
        step, and with ``prefix_sharing`` the page copy and the suffix
        prefill of every suffix bucket a shared prefix can leave (the
        downward closure of the prompt buckets). On the card each
        capturable program captures its graph now (its warm run with
        every slot inactive, the prefills into the trash page); on the
        CPU each runs once so. After it no admission order adds a trace.
        Nothing writes a live page, and the sampling generator's state
        is as it was. Returns ``{"compiled", "seconds", "buckets",
        "suffix_buckets", "spec_k"}``."""
        ts0 = obs.now()
        if prompt_lens is None:
            prompt_lens = range(1, self.max_context)
        buckets = sorted({prompt_bucket(t, self.max_context)
                          for t in prompt_lens})
        params = self.model._decode_params(self.params)
        dev = self.device
        S, MP = self.max_slots, self.max_pages_per_seq
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.int64,
                                           device=dev)
        inactive = torch.zeros(S, dtype=torch.bool, device=dev)
        state = self._gen.get_state()
        compiled = self._step_fn.warmup(
            params, zeros(S, MP), zeros(S), inactive, zeros(S),
            torch.ones(S, device=dev)) > 0
        for tb in buckets:
            compiled += self._admit_fn(tb).warmup(
                params, zeros(tb // self.block), zeros(1, tb),
                self._scalar(tb), self._temp(None)) > 0
        if self.spec_k > 1:
            compiled += self._spec_fn.warmup(
                params, zeros(S, MP), zeros(S), inactive, zeros(S),
                zeros(S, self.spec_k - 1)) > 0
        sbuckets = []
        if self.prefix_sharing:
            compiled += self._cow_fn.warmup(0, 0) > 0
            top = max(buckets) if buckets else 16
            sbuckets = sorted({prompt_bucket(t, self.max_context)
                               for t in range(1, top + 1)})
            for sb in sbuckets:
                compiled += self._suffix_fn(sb).warmup(
                    params, zeros(MP), zeros(1, sb), self._scalar(0),
                    self._scalar(sb), self._temp(None)) > 0
        self._gen.set_state(state)        # the warm runs drew nothing
        return {"compiled": int(compiled), "seconds": obs.now() - ts0,
                "buckets": list(buckets), "suffix_buckets": sbuckets,
                "spec_k": self.spec_k}
