"""Continuous-batching decode scheduler — one fixed-shape decode step.

Port of ``deeplearning4j_tpu/serving/scheduler.py``. Every iteration
runs ONE decode step over ``(max_slots,)`` rows against the paged KV
pool (``kv_pager.py``): each active slot advances one token, new
sequences are admitted *into the running loop* by prefilling into free
pages (at the power-of-two buckets ``generate()`` uses —
``zoo.gpt.prompt_bucket`` is shared), and finished sequences release
their pages without anything changing shape.

Attention math mirrors ``zoo/gpt.py::_token_logits`` value for value
(same -1e9 mask), so padded and trash positions contribute exact zeros
after softmax and paged greedy decode is TOKEN-IDENTICAL to dense
``generate()`` (``tests/test_torch_serving.py`` holds it to that). The
prefill runs ``_prefill_forward``, so on the card each admission
launches the flash kernel once per layer; the RMSNorm kernel runs twice
per block plus once for the head, in prefill and in every step.

The pool is updated IN PLACE (``index_put_`` through indexed
assignment) where the JAX code donates it and rebinds the result.

Not ported yet: speculative decode (``spec_k > 1``) and prefix sharing
with copy-on-write pages (``prefix_sharing=True``) — both are rejected
at construction.

The scheduler is single-threaded host logic (the gateway's worker
drives it); requests are duck-typed: ``.prompt`` (1-D int32),
``.max_new``, ``.temperature``, ``.eos_id``, and ``push(tok)`` /
``finish()`` / ``fail(exc)`` callbacks (``gateway.TokenStream``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.serving.kv_pager import KVPager
from deeplearning4j_tpu_torch.zoo.gpt import _rms, prompt_bucket


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

    __slots__ = ("req", "length", "remaining")

    def __init__(self, req, length: int, remaining: int):
        self.req = req
        self.length = length        # cache positions written so far
        self.remaining = remaining  # tokens still to generate


class DecodeScheduler:
    """In-flight batched decode over a shared paged KV pool.

    ``max_context`` bounds prompt+generation per sequence (a multiple of
    ``block``, at most ``model.max_len``); ``n_pages`` sizes the pool
    (default: enough for every slot at full context). Sampling config
    is gateway-level (``sample``/``top_k``/``top_p``); per-request
    ``temperature`` rides in a per-slot vector. The pool lives on the
    device ``params`` live on; sampling draws from one
    ``torch.Generator`` there, seeded with ``seed``.
    """

    def __init__(self, model, params, *, max_slots: int = 8,
                 block: int = 16, n_pages: Optional[int] = None,
                 max_context: Optional[int] = None,
                 sample: bool = False, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0,
                 spec_k: int = 1, prefix_sharing: bool = False):
        if spec_k != 1:
            raise ValueError(f"spec_k={spec_k}: speculative decode is "
                             "not ported yet (1 only)")
        if prefix_sharing:
            raise ValueError("prefix_sharing=True: shared prefix pages "
                             "are not ported yet")
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
        # outputs (prev=nxt, lengths+active) and the static tensors stay
        # resident — no host->device copy per token; any admit, retire
        # or shed marks the feed dirty for a one-shot rebuild
        self._dev_feed: Optional[dict] = None
        self._feed_dirty = True
        self.steps = 0
        self.tokens_out = 0

    # -- device programs --------------------------------------------------
    def _decode_step(self, params, pt, lengths, active, prev, temps):
        """One decode iteration for every slot: token ids [S] -> next
        token ids [S] and the advanced lengths; the pool is written in
        place (each active slot writes its position's KV into its own
        page, inactive slots into the trash page)."""
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
            logits = model._head_logits(params, x)
        nxt = model._pick(logits, temps[:, None],
                          1.0 if self.top_p is None else self.top_p,
                          self._gen, sample=self.sample, top_k=self.top_k,
                          nucleus=self.top_p is not None)
        nxt = torch.where(active, nxt, torch.zeros_like(nxt))
        return nxt, lengths + active.to(lengths.dtype)

    def _paged_block_step(self, pblk, li, x, pt, pos, active):
        """One transformer block at one position per slot, reading and
        writing the paged pool. Mirrors ``_token_logits``'s block value
        for value; only the cache addressing differs: the write goes to
        page ``pt[s, pos//block]`` offset ``pos%block``, the context is
        the slot's page-table gather reshaped back to position order.
        The gather reads the WHOLE page table row of every slot (all
        ``max_pages_per_seq`` pages), as the JAX step does."""
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
        kv = torch.cat([k, v], dim=2)                   # [S, Kv, 2D]
        (kvpool,) = self.pager.pool
        rows = torch.arange(S, device=x.device)
        # inactive slots scatter into the reserved trash page — the
        # step's shape never depends on how many slots are live
        page_idx = (pos // self.block).clamp(max=pt.shape[1] - 1)
        pids = torch.where(active, pt[rows, page_idx], 0)
        kvpool[li, pids, :, :, pos % self.block] = kv.to(kvpool.dtype)
        ctx = kvpool[li, pt].permute(0, 2, 3, 1, 4).reshape(
            S, n_kv, 2 * hd, -1)
        ck, cv = ctx[:, :, :hd, :], ctx[:, :, hd:, :]
        groups = model.n_heads // n_kv
        qg = q.reshape(S, n_kv, groups, hd)
        s = torch.einsum("bkgd,bkdt->bkgt", qg, ck) / torch.sqrt(
            torch.tensor(hd, dtype=x.dtype))
        # per-slot causal mask; positions past a slot's pages resolve to
        # trash-page junk but always sit beyond its length, so the mask
        # keeps them at exact-zero softmax weight
        live = (torch.arange(ck.shape[3], device=x.device)[None, :]
                <= pos[:, None])
        s = s.masked_fill(~live[:, None, None, :], -1e9)
        w = torch.softmax(s, dim=-1)
        a = torch.einsum("bkgt,bkdt->bkgd", w, cv).reshape(S, -1)
        x = x + a @ mha["Wo"] + mha["bo"]
        h = _rms(x, pblk["ln2"]["gamma"])
        h = F.silu(h @ pblk["Wg"]) * (h @ pblk["Wu"])
        return x + h @ pblk["Wd"]

    def _prefill_into_pages(self, params, page_ids, prompt_pad, t0: int,
                            temp):
        """Prefill-into-pages: ONE batched causal forward over the
        padded prompt (the same ``_prefill_forward`` + ``_pick`` the
        dense path runs), its per-layer caches written into this
        sequence's pages in place, the first generated token
        returned."""
        model = self.model
        tb = prompt_pad.shape[1]
        n_chunks = tb // self.block
        logits0, caches = model._prefill_forward(params, prompt_pad, tb,
                                                 t0)
        (kvpool,) = self.pager.pool
        kv = torch.stack([c[0] for c in caches])       # [L, Kv, 2D, tb]
        # page p covers positions p*block..(p+1)*block-1
        kvpool[:, page_ids] = kv.reshape(
            kv.shape[0], kv.shape[1], kv.shape[2], n_chunks, self.block
        ).permute(0, 3, 1, 2, 4).to(kvpool.dtype)
        return model._pick(logits0, temp,
                           1.0 if self.top_p is None else self.top_p,
                           self._gen, sample=self.sample, top_k=self.top_k,
                           nucleus=self.top_p is not None)

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
        first generated token (the TTFT token). Returns False when
        capacity is lacking — the caller keeps it queued."""
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        t0, max_new = prompt.shape[0], int(req.max_new)
        slot = self.free_slot()
        if slot is None:
            return False
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
            g0 = self._prefill_into_pages(
                self.model._decode_params(self.params), page_ids,
                prompt_pad, t0, 1.0 if temp is None else float(temp))
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
        self._occupy(slot, req, t0, max_new, first, temp)
        return True

    def _occupy(self, slot: int, req, t0: int, max_new: int,
                first: int, temp) -> None:
        """Post-prefill slot bookkeeping: mirror state, emit the TTFT
        token, retire immediately if the budget was one token."""
        self._slots[slot] = _Slot(req, length=t0, remaining=max_new - 1)
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
        to the free list). Returns tokens produced (0 = idle)."""
        act = [i for i, s in enumerate(self._slots) if s is not None]
        if not act:
            return 0
        ts0 = obs.now()
        f = self._ensure_feed(act)
        ts1 = obs.now()
        nxt, len_next = self._decode_step(
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
        """Run the decode step once and the prefill of every reachable
        prompt bucket once BEFORE traffic, so the kernels are built and
        every shape has been through the device before the first
        request. The prefills write no page; the step runs with every
        slot inactive, so it writes only the trash page. Returns
        ``{"buckets": [...], "seconds": t}``."""
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
        nxt, _ = self._decode_step(
            params, zeros(S, MP), zeros(S),
            torch.zeros(S, dtype=torch.bool, device=dev), zeros(S),
            torch.ones(S, device=dev))
        nxt.cpu()
        for tb in buckets:
            logits, _ = self.model._prefill_forward(params, zeros(1, tb),
                                                    tb, tb)
            logits.cpu()
        return {"buckets": list(buckets), "seconds": obs.now() - ts0}
