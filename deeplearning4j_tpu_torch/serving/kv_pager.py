"""Paged/block KV cache — the serving gateway's memory plane.

Port of ``deeplearning4j_tpu/serving/kv_pager.py``: a FIXED pool of
``block``-token pages, per-sequence page lists, free-list allocation,
refcounts and the content-addressed page-chain index, with the same
invariants (:meth:`KVPager.check_invariants`). Cache memory is
O(active tokens), sequences of any length share one pool, and the pool's
shape never changes.

Layout, on the device:

- ``codes`` ``[L, P, Hkv, 2D, block]`` — page ``p`` of layer ``l``
  holds ``block`` consecutive positions of the k (rows ``0:D``) and v
  (rows ``D:2D``) halves, the dense cache's layout. ``int8`` under
  ``cache_quant="int8"`` (codes from ``zoo.gpt._quant_kv``, the
  quantiser the dense path uses), else the model's compute dtype;
- ``scales`` ``[L, P, Hkv, 2, block]`` f32 — per-(page, head, k/v half,
  position) dequant scales; present only under int8.

Page 0 is the reserved **trash page**: inactive slots' writes and
unallocated page-table entries route there, so the fixed-shape step can
always scatter and gather without touching live sequences (reads of
trash positions are masked by each slot's length).

Pages are REFCOUNTED: several live sequences may reference one physical
page (copy-on-write prefix sharing — a KV page is a pure function of the
tokens it covers). The content-addressed page-chain index maps the
token bytes each full-page prefix covers to its pages; admission looks
the prompt up (:meth:`KVPager.match_prefix`), adopts the shared pages
(:meth:`KVPager.adopt`), and the scheduler copies a page before writing
it whenever its refcount exceeds one (:meth:`KVPager.cow` does the
bookkeeping, the scheduler the device copy). A page returns to the free
list only when its LAST reference releases.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.obs import metrics as _metrics


class PageTableError(RuntimeError):
    """A pager invariant broke (page referenced without a matching
    refcount, free-list leak, double free) — raised by
    :meth:`KVPager.check_invariants`."""


class KVPager:
    """Fixed pool of refcounted KV pages with free-list allocation.

    ``n_pages`` counts the trash page: usable capacity is
    ``n_pages - 1`` pages of ``block`` tokens each. ``device`` holds the
    pool (the card unless the caller asks for the CPU).
    """

    def __init__(self, *, n_layers: int, n_kv_heads: int, head_dim: int,
                 n_pages: int, block: int, cache_quant: Optional[str],
                 dtype: str = "float32", device="cuda"):
        if block < 1 or block & (block - 1):
            raise ValueError(f"block={block} must be a power of two "
                             "(pages must tile the power-of-two "
                             "prompt buckets exactly)")
        if n_pages < 2:
            raise ValueError(f"n_pages={n_pages}: need at least one "
                             "usable page beyond the trash page")
        if cache_quant not in (None, "int8"):
            raise ValueError(f"cache_quant={cache_quant!r} "
                             "(None | 'int8')")
        self.n_layers = n_layers
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.n_pages = n_pages
        self.block = block
        self.cache_quant = cache_quant
        shape = (n_layers, n_pages, n_kv_heads, 2 * head_dim, block)
        if cache_quant == "int8":
            self._pool: Tuple[torch.Tensor, ...] = (
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros((n_layers, n_pages, n_kv_heads, 2, block),
                            dtype=torch.float32, device=device))
        else:
            self._pool = (torch.zeros(shape, dtype=dtypes.resolve(dtype),
                                      device=device),)
        # host bookkeeping: LIFO free list (hot pages stay hot), the
        # page -> refcount map, and the per-owner page lists the
        # invariant checks cross-foot against the refcounts
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        self._pages_of: Dict[int, List[int]] = {}
        # content-addressed page-chain index: (kind, n_tokens,
        # token_bytes) -> page list; entries die with any member page
        self._chains: Dict[tuple, List[int]] = {}
        self._page_keys: Dict[int, set] = {}
        # per-tenant reserved-page accounting (owners carry .tenant);
        # label cardinality capped like the gateway's request counter
        self._tenant_of: Dict[int, str] = {}
        self._tenant_pages: Dict[str, int] = {}
        self._tenant_labels: set = set()
        self.max_tenant_labels = 64
        self._gauge()

    # -- device pool -----------------------------------------------------
    @property
    def pool(self) -> Tuple[torch.Tensor, ...]:
        """The layer-stacked device tensors the steps read and write
        in place: ``(codes,)`` or ``(codes, scales)``."""
        return self._pool

    def pool_bytes(self) -> int:
        """Device bytes of the pool: codes and, under int8, scales."""
        return sum(a.numel() * a.element_size() for a in self._pool)

    # -- allocation ------------------------------------------------------
    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` cache positions."""
        return -(-int(n_tokens) // self.block)

    def alloc(self, n: int, owner) -> Optional[List[int]]:
        """Take ``n`` exclusive pages (refcount 1) for ``owner`` (keyed
        by identity — the gateway uses the request stream). Returns the
        page ids in position order, or None when the pool can't satisfy
        the request — admission control's signal to keep it queued."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self._pages_of.setdefault(id(owner), []).extend(pages)
        self._bill_tenant(owner, n)
        self._gauge()
        return pages

    def adopt(self, pages: List[int], owner) -> None:
        """Reference already-live pages for ``owner`` (refcount bump per
        page); they come back through the same :meth:`release`."""
        mine = self._pages_of.setdefault(id(owner), [])
        for p in pages:
            if p == 0:
                raise PageTableError("cannot adopt trash page 0")
            rc = self._refs.get(p)
            if rc is None:
                raise PageTableError(f"cannot adopt page {p}: not live")
            if p in mine:
                raise PageTableError(
                    f"owner already references page {p}")
            self._refs[p] = rc + 1
            mine.append(p)
        self._bill_tenant(owner, len(pages))
        self._gauge()

    def drop_ref(self, owner, page: int) -> bool:
        """Drop ``owner``'s reference on one page. Returns True when
        this was the last reference and the page went back to the free
        list."""
        mine = self._pages_of.get(id(owner), [])
        if page not in mine:
            raise PageTableError(f"owner does not reference page {page}")
        mine.remove(page)
        self._bill_tenant(owner, -1)
        freed = self._decref(page)
        self._gauge()
        return freed

    def cow(self, owner, old_page: int) -> int:
        """Copy-on-write bookkeeping: take a fresh exclusive page for
        ``owner`` and drop its reference on ``old_page`` (which stays
        live for its other holders). The caller copies the page on the
        device BEFORE redirecting writes."""
        if not self._free:
            raise PageTableError(
                "copy-on-write needs a free page but the pool is empty")
        new = self.alloc(1, owner)[0]
        self.drop_ref(owner, old_page)
        return new

    def release(self, owner) -> int:
        """Drop every reference ``owner`` holds; pages whose LAST
        reference this was go back to the free list. Returns the
        number of pages actually freed."""
        pages = self._pages_of.pop(id(owner), [])
        freed = 0
        for p in pages:
            freed += self._decref(p)
        tenant = self._tenant_of.pop(id(owner), None)
        if tenant is not None and pages:
            self._tenant_pages[tenant] = max(
                0, self._tenant_pages.get(tenant, 0) - len(pages))
        self._gauge()
        return freed

    def owned(self, owner) -> List[int]:
        return list(self._pages_of.get(id(owner), []))

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def shared_pages(self) -> int:
        """Pages currently referenced by more than one live sequence."""
        return sum(1 for rc in self._refs.values() if rc > 1)

    def _decref(self, p: int) -> bool:
        rc = self._refs.get(p)
        if rc is None:
            raise PageTableError(f"double free of page {p}")
        if rc > 1:
            self._refs[p] = rc - 1
            return False
        del self._refs[p]
        self._free.append(p)
        # a freed page invalidates every chain entry it belonged to
        for key in self._page_keys.pop(p, set()):
            entry = self._chains.pop(key, None)
            if entry:
                for q in entry:
                    ks = self._page_keys.get(q)
                    if ks is not None:
                        ks.discard(key)
        return True

    # -- content-addressed page-chain index ------------------------------
    def register_chain(self, tokens: np.ndarray,
                       pages: List[int]) -> None:
        """Index ``tokens``'s page chain: one entry per full-page prefix
        (key: the token bytes the pages cover) plus one "tail" entry for
        the whole prompt. First registrant wins on key collisions."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        t0 = int(tokens.shape[0])
        for i in range(1, t0 // self.block + 1):
            key = ("pages", i * self.block,
                   tokens[:i * self.block].tobytes())
            self._index(key, pages[:i])
        npg = self.pages_for(t0)
        if len(pages) >= npg:
            self._index(("tail", t0, tokens.tobytes()), pages[:npg])

    def _index(self, key: tuple, pages: List[int]) -> None:
        if key in self._chains or not pages:
            return
        if any(self._refs.get(p) is None or p == 0 for p in pages):
            return      # never index dead or trash pages
        self._chains[key] = list(pages)
        for p in pages:
            self._page_keys.setdefault(p, set()).add(key)

    def match_prefix(self, tokens: np.ndarray
                     ) -> Optional[Tuple[int, List[int], bool]]:
        """Longest indexed prefix of ``tokens``: ``(shared_len, pages,
        tail)`` or None. ``tail=True``: the whole prompt matched (shared
        coverage capped at ``t0-1``); ``tail=False``: full pages only."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        t0 = int(tokens.shape[0])
        entry = self._chains.get(("tail", t0, tokens.tobytes()))
        if entry is not None:
            return t0 - 1, list(entry), True
        for i in range((t0 - 1) // self.block, 0, -1):
            entry = self._chains.get(
                ("pages", i * self.block,
                 tokens[:i * self.block].tobytes()))
            if entry is not None:
                return i * self.block, list(entry), False
        return None

    def reserved_by_tenant(self) -> Dict[str, int]:
        """Live reserved-page counts per tenant label."""
        return {t: n for t, n in self._tenant_pages.items() if n}

    def _bill_tenant(self, owner, n: int) -> None:
        tenant = self._tenant_of.get(id(owner))
        if tenant is None:
            tenant = self._tenant_label(owner)
            self._tenant_of[id(owner)] = tenant
        self._tenant_pages[tenant] = max(
            0, self._tenant_pages.get(tenant, 0) + n)

    def _tenant_label(self, owner) -> str:
        tenant = str(getattr(owner, "tenant", "") or "unknown")
        if tenant in self._tenant_labels or \
                len(self._tenant_labels) < self.max_tenant_labels:
            self._tenant_labels.add(tenant)
            return tenant
        return "other"

    def _gauge(self) -> None:
        _metrics.SERVING_PAGES_FREE.set(len(self._free))
        usable = self.n_pages - 1
        _metrics.SERVING_KV_OCCUPANCY.set(
            (usable - len(self._free)) / usable)
        _metrics.SERVING_PREFIX_SHARED.set(self.shared_pages())
        for tenant, n in self._tenant_pages.items():
            _metrics.SERVING_KV_RESERVED.labels(tenant=tenant).set(n)

    # -- invariants -------------------------------------------------------
    def check_invariants(self) -> None:
        """Refcount conservation (per page, live table references ==
        refcount; trash page exempt), no page both free and referenced,
        trash page out of circulation, no double free, and allocation
        conservation: free + referenced == n_pages - 1. Raises
        :class:`PageTableError` on any breach."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise PageTableError("duplicate pages on the free list")
        counts: Dict[int, int] = {}
        for pages in self._pages_of.values():
            for p in pages:
                counts[p] = counts.get(p, 0) + 1
        if 0 in counts or 0 in free or 0 in self._refs:
            raise PageTableError("trash page 0 entered circulation")
        for p in set(counts) | set(self._refs):
            occ, rc = counts.get(p, 0), self._refs.get(p, 0)
            if occ > rc:
                raise PageTableError(
                    f"page {p}: {occ} table references != refcount "
                    f"{rc} (two live sequences sharing a page must "
                    "both hold a ref)")
            if occ < rc:
                raise PageTableError(
                    f"page {p}: refcount {rc} leaks past its {occ} "
                    "live table references")
        if free & set(self._refs):
            raise PageTableError(
                f"pages both free and referenced: "
                f"{sorted(free & set(self._refs))}")
        if len(free) + len(self._refs) != self.n_pages - 1:
            raise PageTableError(
                f"page leak: {len(free)} free + {len(self._refs)} "
                f"referenced != {self.n_pages - 1} usable")
        for key, pages in self._chains.items():
            for p in pages:
                if p not in self._refs:
                    raise PageTableError(
                        f"chain entry {key[:2]} references freed "
                        f"page {p}")
