"""The port's serving options on the CPU: the int8 KV pool, speculative
decode (``spec_k``), copy-on-write prefix sharing, and both together.

Twins of ``tests/test_serving.py``'s fences (the int8 paged decode, the
int8 page round trip, the spec-decode and prefix-sharing identity
fences, the spec metrics, the chain index and copy-on-write isolation),
on GPTNano with JAX weights carried across. The JAX references — dense
``generate()`` and the JAX gateway with ``spec_k=4`` and
``prefix_sharing=True`` — are built once per cache mode (a module
fixture: the JAX scheduler compiles a program per bucket).

Tolerances: tokens exact (against the port's dense ``generate()``, the
JAX package's dense ``generate()`` and the JAX gateway's streams);
f32 logits of the multirow step against the single-row step, and of the
suffix prefill against the single-row step and (float cache) the dense
prefill, 1e-5 absolute (the same math on other matmul shapes, 4 layers
deep, logits O(1)); page bytes and pool bytes exact.
"""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import ServingGateway as JaxGateway
from deeplearning4j_tpu.serving.scheduler import (
    DecodeScheduler as JaxScheduler)
from deeplearning4j_tpu.zoo.gpt import GPTNano as JaxGPTNano
from deeplearning4j_tpu_torch.obs import metrics
from deeplearning4j_tpu_torch.serving.gateway import ServingGateway
from deeplearning4j_tpu_torch.serving.kv_pager import KVPager
from deeplearning4j_tpu_torch.serving.scheduler import (SPEC_KS,
                                                        DecodeScheduler)
from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM, GPTNano

LOGIT_TOL = 1e-5
CACHE_MODES = [None, "int8"]
#: the identity fence's prompts and budgets (``test_serving.py``): 3
#: slots for 6 requests, so admissions stagger mid-decode
LENS, BUDGETS = (5, 17, 9, 30, 3, 22), (10, 4, 16, 8, 12, 6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _identity_prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 64, t).astype(np.int32) for t in LENS]


def _sharing_prompts():
    """``test_prefix_sharing_token_identical_to_dense``'s three: a donor,
    a whole-prompt sibling (tail copy-on-write) and a sharer of the
    first two full pages with a novel suffix."""
    rng = np.random.default_rng(1)
    base = rng.integers(0, 64, 30).astype(np.int32)
    return [base.copy(), base.copy(),
            np.concatenate([base[:16],
                            rng.integers(0, 64, 8).astype(np.int32)])]


def _serve(gw, prompts, budgets):
    streams = [gw.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
    return [np.asarray(st.result(timeout=120)) for st in streams]


@pytest.fixture(scope="module")
def refs():
    """Per cache mode: the JAX net, the port model and parameters, and
    the JAX references of both prompt sets — dense ``generate()`` and
    the JAX gateway's streams with ``spec_k=4, prefix_sharing=True``."""
    out = {}
    for cq in CACHE_MODES:
        jm = JaxGPTNano(vocab_size=64, max_len=64, seed=7, cache_quant=cq)
        net = jm.init()
        pm = GPTNano(vocab_size=64, max_len=64, seed=7, cache_quant=cq)
        params = pm.params_from_jax(jax.tree.map(np.asarray, net.params),
                                    device="cpu")
        ident, share = _identity_prompts(), _sharing_prompts()
        dense = [np.asarray(jm.generate(net, p[None], n_new=n))[0]
                 for p, n in zip(ident, BUDGETS)]
        dense_share = [np.asarray(jm.generate(net, p[None], n_new=12))[0]
                       for p in share[1:]]
        gw = JaxGateway(jm, net, max_slots=3, block=8, max_context=64,
                        spec_k=4, prefix_sharing=True)
        gw.warmup(prompt_lens=LENS)
        gw_ident = _serve(gw, ident, BUDGETS)
        gw_share = _serve(gw, share, (12, 12, 12))
        gw.shutdown()
        out[cq] = dict(model=pm, params=params, ident=ident, share=share,
                       dense=dense, dense_share=[dense_share[0]]
                       + dense_share, gw_ident=gw_ident, gw_share=gw_share)
    return out


def _check_drained(gw):
    gw._sched.pager.check_invariants()
    assert gw._sched.pager.free_pages() == gw._sched.pager.n_pages - 1


# -- the identity fences ------------------------------------------------------
def test_paged_int8_decode_token_identical_to_dense(refs):
    """Twin of ``test_paged_decode_token_identical_to_dense[int8]``: the
    int8 pool through the plain gateway gives the dense int8-cache
    tokens, the port's and the JAX package's."""
    r = refs["int8"]
    mine = [r["model"].generate(r["params"], p[None], n_new=n)[0]
            for p, n in zip(r["ident"], BUDGETS)]
    for a, b in zip(mine, r["dense"]):
        np.testing.assert_array_equal(a, b)
    gw = ServingGateway(r["model"], r["params"], max_slots=3, block=8,
                        max_context=64)
    gw.warmup(prompt_lens=LENS)
    for got, want in zip(_serve(gw, r["ident"], BUDGETS), r["dense"]):
        np.testing.assert_array_equal(got, want)
    _check_drained(gw)
    gw.shutdown()


def test_int8_pages_roundtrip_token_for_token():
    """Twin of ``test_int8_pages_roundtrip_token_for_token``: the
    scheduler driven directly over int8 pages reproduces the dense
    int8-cache decode (the port's and the JAX package's)."""
    kw = dict(vocab_size=64, hidden=32, n_layers=2, n_heads=2, n_kv_heads=1,
              max_len=64, seed=11, cache_quant="int8")
    from deeplearning4j_tpu.zoo.gpt import CausalTransformerLM as JaxLM
    jm = JaxLM(**kw)
    net = jm.init()
    model = CausalTransformerLM(**kw)
    params = model.params_from_jax(jax.tree.map(np.asarray, net.params),
                                   device="cpu")
    prompt = np.random.default_rng(5).integers(0, 64, 13).astype(np.int32)
    dense = model.generate(params, prompt[None], n_new=14)[0]
    np.testing.assert_array_equal(
        dense, np.asarray(jm.generate(net, prompt[None], n_new=14))[0])
    sched = DecodeScheduler(model, params, max_slots=2, block=8,
                            max_context=64)
    sched.warmup(prompt_lens=(13,))
    r = _Req(prompt, 14)
    assert sched.admit(r)
    while not r.done:
        sched.step()
    np.testing.assert_array_equal(np.r_[prompt, r.tokens], dense)


@pytest.mark.parametrize("cache_quant", CACHE_MODES, ids=["float", "int8"])
def test_spec_decode_token_identical_to_dense(refs, cache_quant):
    """Twin of ``test_spec_decode_token_identical_to_dense``: greedy
    speculative decode (k = 4, prompt-lookup drafts) through the gateway
    emits exactly the dense tokens and the JAX gateway's."""
    r = refs[cache_quant]
    gw = ServingGateway(r["model"], r["params"], max_slots=3, block=8,
                        max_context=64, spec_k=4)
    gw.warmup(prompt_lens=LENS)
    got = _serve(gw, r["ident"], BUDGETS)
    for g, d, j in zip(got, r["dense"], r["gw_ident"]):
        np.testing.assert_array_equal(g, d)
        np.testing.assert_array_equal(g, j)
    _check_drained(gw)
    gw.shutdown()


@pytest.mark.parametrize("spec_k", [1, 4], ids=["single", "spec4"])
@pytest.mark.parametrize("cache_quant", CACHE_MODES, ids=["float", "int8"])
def test_prefix_sharing_token_identical_to_dense(refs, cache_quant, spec_k):
    """Twin of ``test_prefix_sharing_token_identical_to_dense``: a
    whole-prompt sibling (tail copy-on-write) and a novel-suffix sharer
    ride the donor's pages yet give the dense tokens and the JAX
    gateway's (which runs sharing with k = 4); both hit the chain, skip
    their shared prefill, and every page returns to the free list."""
    r = refs[cache_quant]
    gw = ServingGateway(r["model"], r["params"], max_slots=4, block=8,
                        max_context=64, prefix_sharing=True, spec_k=spec_k)
    gw.warmup(prompt_lens=(30,))
    h0 = metrics.SERVING_PREFIX_HITS.snapshot()[""]
    s0 = metrics.SERVING_PREFIX_SAVED.snapshot()[""]
    c0 = metrics.SERVING_PREFIX_COW.snapshot()[""]
    got = _serve(gw, r["share"], (12, 12, 12))
    for g, d, j in zip(got, r["dense_share"], r["gw_share"]):
        np.testing.assert_array_equal(g, d)
        np.testing.assert_array_equal(g, j)
    assert metrics.SERVING_PREFIX_HITS.snapshot()[""] - h0 == 2
    assert metrics.SERVING_PREFIX_SAVED.snapshot()[""] - s0 >= 16 + 29
    assert metrics.SERVING_PREFIX_COW.snapshot()[""] - c0 >= 1
    _check_drained(gw)
    gw.shutdown()


@pytest.mark.parametrize("cache_quant", CACHE_MODES, ids=["float", "int8"])
def test_spec_and_sharing_match_the_jax_gateway(refs, cache_quant):
    """The JAX gateway's configuration (``spec_k=4,
    prefix_sharing=True``, 3 slots) on both prompt sets, one after the
    other: the port's streams equal the JAX gateway's token for
    token."""
    r = refs[cache_quant]
    gw = ServingGateway(r["model"], r["params"], max_slots=3, block=8,
                        max_context=64, spec_k=4, prefix_sharing=True)
    gw.warmup(prompt_lens=LENS)
    for got, want in zip(_serve(gw, r["ident"], BUDGETS), r["gw_ident"]):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(_serve(gw, r["share"], (12, 12, 12)),
                         r["gw_share"]):
        np.testing.assert_array_equal(got, want)
    _check_drained(gw)
    gw.shutdown()


# -- the steps, one against another -------------------------------------------
class _Req:
    """Minimal duck-typed request for driving DecodeScheduler
    directly."""

    def __init__(self, prompt, max_new, eos_id=None):
        self.prompt = np.asarray(prompt, np.int32)
        self.max_new = max_new
        self.temperature = None
        self.eos_id = eos_id
        self.tokens = []
        self.done = False

    def push(self, tok):
        self.tokens.append(int(tok))

    def finish(self):
        self.done = True

    def fail(self, e):
        self.done = True


def _feed(sched):
    act = [i for i, s in enumerate(sched._slots) if s is not None]
    return act, sched._ensure_feed(act)


@pytest.mark.parametrize("cache_quant", CACHE_MODES, ids=["float", "int8"])
def test_verify_rows_equal_single_steps(refs, cache_quant):
    """The verify forward over [S, 4] rows against 4 single-token steps
    from the same pool (two slots live): each row's logits within
    ``LOGIT_TOL`` of the step at its position, and the pool the verify
    step leaves equal to the one the single steps leave (codes and
    scales to the bit under int8)."""
    r = refs[cache_quant]
    model, params = r["model"], r["params"]
    scheds = []
    for _ in range(2):
        s = DecodeScheduler(model, params, max_slots=3, block=8,
                            max_context=64)
        s.admit(_Req(r["ident"][0], 20))
        s.admit(_Req(r["ident"][3], 20))
        scheds.append(s)
    forced = np.random.default_rng(7).integers(0, 64, (3, 4))
    p = model._decode_params(params)
    a, b = scheds
    act, f = _feed(a)
    drafts = torch.as_tensor(forced[:, 1:])
    prev = f["prev"].clone()
    prev[act] = torch.as_tensor(forced[act, 0])
    rows = a._spec_logits(p, f["pt"], f["lengths"], f["active"], prev,
                          drafts)
    act, f = _feed(b)
    lengths = f["lengths"]
    for j in range(4):
        tok = torch.as_tensor(forced[:, j])
        single = b._decode_logits(p, f["pt"], lengths, f["active"], tok)
        err = (rows[act, j] - single[act]).abs().max().item()
        assert err <= LOGIT_TOL, (j, err)
        lengths = lengths + f["active"].to(lengths.dtype)
    for pa, pb in zip(a.pager.pool, b.pager.pool):
        live = sorted({int(x) for x in a._page_table[act].ravel()} - {0})
        if pa.dtype == torch.int8:
            assert torch.equal(pa[:, live], pb[:, live])
        else:
            torch.testing.assert_close(pa[:, live], pb[:, live],
                                       rtol=0, atol=LOGIT_TOL)


def _sequential_suffix_logits(model, params, donor, prompt, shared_len):
    """The reference of a suffix prefill: a scheduler without sharing
    admits ``donor``; a second slot's table row takes the donor's first
    ``shared_len // 8`` pages (and, for a tail match, a copy of its next
    page) and fresh pages, and the suffix tokens run one at a time
    through the single-row decode step. Returns the logits [V] at the
    prompt's last position."""
    sched = DecodeScheduler(model, params, max_slots=2, block=8,
                            max_context=64)
    sched.admit(_Req(donor, 12))
    dpages = [int(x) for x in sched._page_table[0][:4]]
    n_full = shared_len // 8
    fresh = sched.pager.alloc(4 - n_full, object())
    if shared_len % 8:                          # tail: copy-on-write
        sched._cow_copy(dpages[n_full], fresh[0])
    row = dpages[:n_full] + fresh
    pt = torch.as_tensor(sched._page_table)
    pt[1, :4] = torch.as_tensor(row)
    p = model._decode_params(params)
    active = torch.tensor([False, True])
    for pos in range(shared_len, len(prompt)):
        logits = sched._decode_logits(
            p, pt, torch.tensor([0, pos]), active,
            torch.tensor([0, int(prompt[pos])]))
    return logits[1]


@pytest.mark.parametrize("tail", [False, True], ids=["suffix", "tail"])
@pytest.mark.parametrize("cache_quant", CACHE_MODES, ids=["float", "int8"])
def test_suffix_prefill_equals_sequential_and_dense(refs, cache_quant,
                                                     tail):
    """The suffix prefill of a sharer (``tail``: of a whole-prompt
    sibling, after the tail page's copy): its first-token logits within
    ``LOGIT_TOL`` of the suffix run one token at a time through the
    single-row step over the same shared pages, and — with the float
    cache — of the dense prefill of the whole prompt. (The int8 cache's
    dense prefill attends its own keys unquantised, as the JAX
    package's does, so there the two differ by the quantisation.) The
    donor's pages keep their bytes through the sharer's admission."""
    r = refs[cache_quant]
    model, params = r["model"], r["params"]
    p = model._decode_params(params)
    donor, sibling, sharer = r["share"]
    prompt = sibling if tail else sharer
    sched = DecodeScheduler(model, params, max_slots=3, block=8,
                            max_context=64, prefix_sharing=True)
    sched.admit(_Req(donor, 12))
    donor_pages = list(sched._page_table[0][:4])
    before = [a[:, donor_pages].clone() for a in sched.pager.pool]
    seen = {}
    real = sched._suffix_logits

    def spy(*args):
        seen["args"] = args
        seen["logits"] = real(*args)
        return seen["logits"]
    sched._suffix_logits = spy
    sched.admit(_Req(prompt, 12))
    shared_len = seen["args"][3]
    assert shared_len == (29 if tail else 16)
    for a, b in zip(before, sched.pager.pool):
        assert torch.equal(a, b[:, donor_pages])
    want = _sequential_suffix_logits(model, params, donor, prompt,
                                     shared_len)
    err = (seen["logits"][0] - want).abs().max().item()
    assert err <= LOGIT_TOL, err
    if cache_quant is None:
        dense = DecodeScheduler(model, params, max_slots=1, block=8,
                                max_context=64)
        pad = torch.zeros((1, 32), dtype=torch.int64)
        pad[0, :len(prompt)] = torch.as_tensor(prompt)
        pages = torch.as_tensor(dense.pager.alloc(4, object()))
        want = dense._prefill_logits_into_pages(p, pages, pad, len(prompt))
        err = (seen["logits"] - want).abs().max().item()
        assert err <= LOGIT_TOL, err


def test_rows_step_sends_out_of_table_rows_to_trash(refs):
    """A verify row past the slot's page table is clamped and written to
    the trash page: every live page holds the same bytes as after an
    all-inactive step."""
    r = refs[None]
    sched = DecodeScheduler(r["model"], r["params"], max_slots=1, block=8,
                            max_context=16)
    sched.admit(_Req(np.arange(10, dtype=np.int32), 6))
    act, f = _feed(sched)
    (pool,) = sched.pager.pool
    live = sorted(set(sched._page_table[0].tolist()) - {0})
    before = pool[:, live].clone()
    p = r["model"]._decode_params(r["params"])
    far = torch.full_like(f["lengths"], 16)          # past the table
    sched._spec_logits(p, f["pt"], far, f["active"], f["prev"],
                       torch.zeros((1, 7), dtype=torch.int64))
    assert torch.equal(pool[:, live], before)


# -- metrics, drafts, warmup --------------------------------------------------
def test_spec_accept_metrics_exported(refs):
    """Twin of ``test_spec_accept_metrics_exported``: drafted tokens come
    k-1 a verify step, the accept histogram counts, accepted <=
    drafted."""
    r = refs[None]
    gw = ServingGateway(r["model"], r["params"], max_slots=2, block=8,
                        max_context=32, spec_k=4)
    gw.warmup(prompt_lens=(4, 8))
    d0 = metrics.SERVING_SPEC_DRAFTED.snapshot()[""]
    a0 = metrics.SERVING_SPEC_ACCEPT.snapshot()[""]["count"]
    gw.submit(np.arange(6, dtype=np.int32) % 64,
              max_new=12).result(timeout=120)
    drafted = metrics.SERVING_SPEC_DRAFTED.snapshot()[""] - d0
    assert drafted > 0 and drafted % 3 == 0
    assert metrics.SERVING_SPEC_ACCEPT.snapshot()[""]["count"] > a0
    accepted = metrics.SERVING_SPEC_ACCEPTED.snapshot()[""]
    assert 0 <= accepted <= metrics.SERVING_SPEC_DRAFTED.snapshot()[""]
    assert metrics.step_summary()["serving.spec_step"]["count"] > 0
    gw.shutdown()


def test_prompt_lookup_draft_matches_jax():
    """The host draft is the JAX package's, on random histories with
    repeats (bigram hits, unigram fallbacks, no hit, empty)."""
    rng = np.random.default_rng(9)
    for _ in range(200):
        hist = list(map(int, rng.integers(0, 6, int(rng.integers(0, 30)))))
        for n in (1, 3, 7):
            assert DecodeScheduler._draft(hist, n) == \
                JaxScheduler._draft(None, hist, n)


def test_warmup_runs_verify_and_every_suffix_bucket(refs):
    """In place of the JAX package's zero-retrace fence (compile
    lifecycle is a later item of the port): ``warmup`` runs the verify
    step at the configured k once and the suffix prefill at every bucket
    a shared prefix can leave, and writes no live page."""
    r = refs[None]
    sched = DecodeScheduler(r["model"], r["params"], max_slots=3, block=8,
                            max_context=64, spec_k=2, prefix_sharing=True)
    calls = {"spec": [], "suffix": []}
    real_spec, real_suffix = sched._spec_logits, sched._suffix_logits
    sched._spec_logits = lambda *a: (calls["spec"].append(a[-1].shape)
                                     or real_spec(*a))
    sched._suffix_logits = lambda *a: (calls["suffix"].append(a[2].shape[1])
                                       or real_suffix(*a))
    warm = sched.warmup(prompt_lens=range(1, 25))
    assert warm["buckets"] == [16, 32] and warm["spec_k"] == 2
    assert warm["suffix_buckets"] == [16, 32]
    assert calls["spec"] == [(3, 1)]
    assert calls["suffix"] == [16, 32]
    for a in sched.pager.pool:
        assert not a[:, 1:].any()
    assert sched.pager.free_pages() == sched.pager.n_pages - 1
    assert SPEC_KS == (2, 4, 8)


# -- the pager ----------------------------------------------------------------
def test_pager_int8_pool_layout_and_bytes():
    """The int8 pool: codes int8 [L, P, Kv, 2D, block] and scales f32
    [L, P, Kv, 2, block]; ``pool_bytes`` counts both."""
    pager = KVPager(n_layers=2, n_kv_heads=3, head_dim=16, n_pages=9,
                    block=8, cache_quant="int8", device="cpu")
    codes, scales = pager.pool
    assert codes.shape == (2, 9, 3, 32, 8) and codes.dtype == torch.int8
    assert scales.shape == (2, 9, 3, 2, 8) and scales.dtype == torch.float32
    assert pager.pool_bytes() == 2 * 9 * 3 * 32 * 8 + 4 * 2 * 9 * 3 * 2 * 8
    flt = KVPager(n_layers=2, n_kv_heads=3, head_dim=16, n_pages=9, block=8,
                  cache_quant=None, dtype="bfloat16", device="cpu")
    assert flt.pool_bytes() == 2 * 2 * 9 * 3 * 32 * 8


def test_pager_chain_index_dies_with_pages():
    """Twin of ``test_pager_chain_index_dies_with_pages``."""
    pager = KVPager(n_layers=1, n_kv_heads=1, head_dim=4, n_pages=9,
                    block=8, cache_quant=None, device="cpu")
    toks = np.arange(20, dtype=np.int32)
    a = object()
    pages = pager.alloc(3, a)
    pager.register_chain(toks, pages)
    m = pager.match_prefix(toks)
    assert m is not None and m[0] == 19 and m[2] is True
    assert pager.match_prefix(toks[:17])[0] == 16
    b = object()
    pager.adopt(pages[:2], b)
    pager.release(a)
    pager.check_invariants()
    m = pager.match_prefix(toks)
    assert m is not None and m[0] == 16 and m[2] is False
    m = pager.match_prefix(toks[:17])
    assert m is not None and m[0] == 16
    pager.release(b)
    pager.check_invariants()
    assert pager.match_prefix(toks[:17]) is None
    assert pager.free_pages() == pager.n_pages - 1


@pytest.mark.parametrize("cache_quant", CACHE_MODES, ids=["float", "int8"])
def test_cow_isolation_against_sibling(refs, cache_quant):
    """Twin of ``test_cow_isolation_against_sibling``, and on the device
    pool: after a writer copies a shared page, the sibling keeps the
    original page id and its bytes (codes AND scales) stay as they were
    while the writer decodes into its copy."""
    pager = KVPager(n_layers=1, n_kv_heads=1, head_dim=4, n_pages=9,
                    block=8, cache_quant=None, device="cpu")
    a, b = object(), object()
    pa = pager.alloc(2, a)
    pager.adopt(pa, b)
    new = pager.cow(b, pa[1])
    assert new not in pa
    assert pager.owned(a) == pa
    assert set(pager.owned(b)) == {pa[0], new}
    assert pager.refcount(pa[1]) == 1
    pager.check_invariants()
    pager.release(a)
    pager.release(b)
    assert pager.free_pages() == pager.n_pages - 1
    # the scheduler, admission: a whole-prompt sibling copies the
    # donor's tail page, then writes position 30 into its copy with
    # another token than the donor's — the donor's page keeps its bytes
    r = refs[cache_quant]
    model = r["model"]
    p = model._decode_params(r["params"])
    sched = DecodeScheduler(model, r["params"], max_slots=2, block=8,
                            max_context=64, prefix_sharing=True)
    donor, sibling = r["share"][0], r["share"][1]
    d = _Req(donor, 12)
    sched.admit(d)
    dpages = [int(x) for x in sched._page_table[0][:4]]
    sched.admit(_Req(sibling, 6))
    spages = [int(x) for x in sched._page_table[1][:4]]
    assert spages[:3] == dpages[:3] and spages[3] != dpages[3]
    assert sched.pager.refcount(dpages[3]) == 1
    snap = [t[:, dpages].clone() for t in sched.pager.pool]
    pt = torch.as_tensor(sched._page_table)
    other = (int(d.tokens[0]) + 1) % 64
    sched._decode_logits(p, pt, torch.tensor([0, 30]),
                         torch.tensor([False, True]),
                         torch.tensor([0, other]))
    for t, before in zip(sched.pager.pool, snap):
        assert torch.equal(t[:, dpages], before)
        assert not torch.equal(t[:, spages[3], ..., 6],
                               t[:, dpages[3], ..., 6])
    # the step: a page the next write hits is shared (a second holder
    # adopts it) — the step copies it first, and the holder's page
    # keeps its bytes while the donor decodes into the copy
    holder = object()
    sched.pager.adopt([dpages[3]], holder)
    c0 = metrics.SERVING_PREFIX_COW.snapshot()[""]
    held = [t[:, dpages[3]].clone() for t in sched.pager.pool]
    sched.step()
    assert metrics.SERVING_PREFIX_COW.snapshot()[""] - c0 == 1
    assert int(sched._page_table[0][3]) != dpages[3]
    for t, before in zip(sched.pager.pool, held):
        assert torch.equal(t[:, dpages[3]], before)
    while sched.active_count():
        sched.step()
    sched.pager.release(holder)
    sched.pager.check_invariants()
    assert sched.pager.free_pages() == sched.pager.n_pages - 1
