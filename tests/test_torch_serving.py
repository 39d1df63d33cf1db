"""The port's continuous-batching gateway on the CPU.

The fences of ``tests/test_serving.py``, held by the port:

- **pager correctness**: paged greedy decode through the gateway is
  TOKEN-IDENTICAL to the port's dense ``generate()`` and to the JAX
  package's ``generate()`` (JAX weights carried across);
- **pager invariants**: conservation, double ownership, admit/evict
  churn;
- **serving semantics**: queue-full and deadline sheds, graceful drain,
  tenant round-robin, streaming with EOS, cancel, admission control,
  anti-starvation aging, fault shedding.
"""
import threading
import time

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.zoo.gpt import GPTNano as JaxGPTNano
from deeplearning4j_tpu_torch.obs import metrics
from deeplearning4j_tpu_torch.parallel.inference import (
    DeadlineExpiredError, QueueFullError, ServingShutdownError)
from deeplearning4j_tpu_torch.serving.gateway import (SequenceAborted,
                                                      ServingGateway)
from deeplearning4j_tpu_torch.serving.kv_pager import (KVPager,
                                                       PageTableError)
from deeplearning4j_tpu_torch.serving.scheduler import DecodeScheduler
from deeplearning4j_tpu_torch.zoo.gpt import (CausalTransformerLM,
                                              GPTNano, prompt_bucket)


def _tiny_model(**kw):
    """2-layer/32-hidden LM for the scheduling tests (the identity fence
    uses GPTNano to cover GQA + 4 layers)."""
    kw.setdefault("vocab_size", 64)
    return CausalTransformerLM(hidden=32, n_layers=2, n_heads=2,
                               n_kv_heads=1, max_len=kw.pop("max_len", 64),
                               seed=kw.pop("seed", 9), **kw)


@pytest.fixture(scope="module")
def tiny():
    model = _tiny_model()
    return model, model.init_params(device="cpu")


class _Req:
    """Minimal duck-typed request for driving DecodeScheduler directly
    (no gateway thread — deterministic churn tests)."""

    def __init__(self, prompt, max_new, temperature=None, eos_id=None):
        self.prompt = np.asarray(prompt, np.int32)
        self.max_new = max_new
        self.temperature = temperature
        self.eos_id = eos_id
        self.tokens = []
        self.done = False
        self.error = None

    def push(self, tok):
        self.tokens.append(int(tok))

    def finish(self):
        self.done = True

    def fail(self, e):
        self.error = e
        self.done = True


# -- pager correctness -----------------------------------------------------
def test_paged_decode_token_identical_to_dense_and_jax():
    jm = JaxGPTNano(vocab_size=64, max_len=64, seed=7)
    net = jm.init()
    model = GPTNano(vocab_size=64, max_len=64, seed=7)
    params = model.params_from_jax(jax.tree.map(np.asarray, net.params),
                                   device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, t).astype(np.int32)
               for t in (5, 17, 9, 30, 3, 22)]
    budgets = [10, 4, 16, 8, 12, 6]
    dense = [model.generate(params, p[None], n_new=n)[0]
             for p, n in zip(prompts, budgets)]
    # dense == JAX on three (bucket, budget) pairs (each JAX pair is a
    # fresh compile); the gateway is then held to dense on all six
    for p, n, d in zip(prompts[:3], budgets[:3], dense[:3]):
        np.testing.assert_array_equal(
            np.asarray(jm.generate(net, p[None], n_new=n))[0], d)
    # 3 slots for 6 requests: admissions stagger mid-decode, every slot
    # serves sequences at different positions and buckets
    gw = ServingGateway(model, params, max_slots=3, block=8,
                        max_context=64)
    gw.warmup(prompt_lens=(3, 5, 9, 17, 22, 30))
    streams = [gw.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
    for st, d in zip(streams, dense):
        np.testing.assert_array_equal(st.result(timeout=120), d)
    gw._sched.pager.check_invariants()
    assert gw._sched.pager.free_pages() == gw._sched.pager.n_pages - 1
    gw.shutdown()


# -- pager invariants -------------------------------------------------------
def test_pager_alloc_release_conservation():
    pager = KVPager(n_layers=2, n_kv_heads=1, head_dim=16, n_pages=9,
                    block=8, cache_quant=None, device="cpu")
    assert pager.pool[0].shape == (2, 9, 1, 32, 8)
    a, b = object(), object()
    pa = pager.alloc(3, a)
    pb = pager.alloc(4, b)
    assert len(pa) == 3 and len(pb) == 4
    assert 0 not in pa + pb                  # trash page reserved
    assert not set(pa) & set(pb)             # disjoint owners
    assert pager.free_pages() == 1
    assert pager.alloc(2, object()) is None  # exhausted -> refused
    assert pager.free_pages() == 1           # refusal takes nothing
    pager.check_invariants()
    assert pager.release(a) == 3
    assert pager.release(b) == 4
    assert pager.free_pages() == 8           # full conservation
    pager.check_invariants()


def test_pager_detects_double_ownership_and_double_free():
    pager = KVPager(n_layers=1, n_kv_heads=1, head_dim=8, n_pages=5,
                    block=8, cache_quant=None, device="cpu")
    a, b = object(), object()
    pa = pager.alloc(2, a)
    pager.alloc(1, b)
    pager._pages_of[id(b)].append(pa[0])     # a scheduler bug
    with pytest.raises(PageTableError, match="two live sequences"):
        pager.check_invariants()
    with pytest.raises(PageTableError, match="double free"):
        pager._decref(4)
    # the JAX pager's validation: None or "int8" (the int8 pool's
    # round trip lives in tests/test_torch_serving_opts.py)
    with pytest.raises(ValueError, match="cache_quant"):
        KVPager(n_layers=1, n_kv_heads=1, head_dim=8, n_pages=5,
                block=8, cache_quant="int4", device="cpu")


def test_pager_refcounts_and_chain_index():
    pager = KVPager(n_layers=1, n_kv_heads=1, head_dim=8, n_pages=8,
                    block=4, cache_quant=None, device="cpu")
    a, b = object(), object()
    toks = np.arange(10, dtype=np.int32)
    pa = pager.alloc(3, a)
    pager.register_chain(toks, pa)
    shared_len, pages, tail = pager.match_prefix(toks)
    assert (shared_len, pages, tail) == (9, pa, True)
    assert pager.match_prefix(np.r_[toks[:8], 99])[:2] == (8, pa[:2])
    pager.adopt(pa[:2], b)
    assert pager.refcount(pa[0]) == 2 and pager.shared_pages() == 2
    new = pager.cow(b, pa[1])
    assert pager.refcount(pa[1]) == 1 and new not in pa
    pager.check_invariants()
    assert pager.release(a) == 2             # pa[0] still held by b
    # chains through the freed pages died; the first page's survives
    assert pager.match_prefix(toks) == (4, [pa[0]], False)
    assert pager.release(b) == 2
    assert pager.free_pages() == 7
    pager.check_invariants()


def test_pager_invariants_under_admit_evict_churn(tiny):
    model, params = tiny
    sched = DecodeScheduler(model, params, max_slots=3, block=8,
                            max_context=32, n_pages=10)
    sched.warmup(prompt_lens=range(1, 17))
    rng = np.random.default_rng(4)
    live = []
    for _ in range(80):
        op = rng.integers(0, 3)
        if op == 0:
            r = _Req(rng.integers(0, 64, int(rng.integers(1, 17))),
                     int(rng.integers(1, 9)))
            if sched.can_admit(r.prompt.size, r.max_new):
                assert sched.admit(r)
                if not r.done:
                    live.append(r)
        elif op == 1:
            sched.step()
        elif live:
            sched.evict(live.pop(int(rng.integers(0, len(live)))))
        live = [r for r in live if not r.done]
        sched.pager.check_invariants()
    while any(s is not None for s in sched._slots):
        sched.step()
        sched.pager.check_invariants()
    assert sched.pager.free_pages() == sched.pager.n_pages - 1


# -- scheduler contract -----------------------------------------------------
def test_warmup_buckets_and_unported_options(tiny):
    model, params = tiny
    sched = DecodeScheduler(model, params, max_slots=2, block=16,
                            max_context=64)
    warm = sched.warmup(prompt_lens=range(1, 33))
    assert warm["buckets"] == sorted({prompt_bucket(t, 64)
                                      for t in range(1, 33)})
    assert sched.pager.free_pages() == sched.pager.n_pages - 1
    # rejected exactly where the JAX scheduler rejects: a k off the
    # SPEC_KS grid, and speculative decode under sampling
    with pytest.raises(ValueError, match="spec_k"):
        DecodeScheduler(model, params, spec_k=3)
    with pytest.raises(ValueError, match="greedy-only"):
        DecodeScheduler(model, params, spec_k=2, sample=True)
    with pytest.raises(ValueError, match="max_context"):
        DecodeScheduler(model, params, max_context=128)


def test_streaming_tokens_and_eos(tiny):
    model, params = tiny
    sched = DecodeScheduler(model, params, max_slots=2, block=8,
                            max_context=32)
    probe = _Req(np.arange(5), 6)
    sched.admit(probe)
    while not probe.done:
        sched.step()
    assert len(probe.tokens) == 6
    # eos = the first token not produced earlier: the stream stops there
    cut = next(i for i, t in enumerate(probe.tokens)
               if t not in probe.tokens[:i] and i > 0)
    r = _Req(np.arange(5), 6, eos_id=probe.tokens[cut])
    sched.admit(r)
    while not r.done:
        sched.step()
    assert r.tokens == probe.tokens[:cut + 1]
    sched.pager.check_invariants()
    assert sched.pager.free_pages() == sched.pager.n_pages - 1
    # gateway streaming surface: tokens() yields what result() returns
    gw = ServingGateway(model, params, max_slots=2, block=8,
                        max_context=32, default_max_new=6)
    st = gw.submit(np.arange(5, dtype=np.int32))
    toks = list(st.tokens(timeout=60))
    np.testing.assert_array_equal(st.result(timeout=5),
                                  np.concatenate([np.arange(5), toks]))
    assert toks == probe.tokens
    assert st.ttft_s is not None and st.ttft_s >= 0
    gw.shutdown()


# -- gateway serving semantics ----------------------------------------------
def test_queue_full_sheds_fast(tiny):
    model, params = tiny
    gw = ServingGateway(model, params, max_slots=2, block=8,
                        max_context=32, queue_limit=3, default_max_new=4,
                        start=False)
    shed0 = metrics.SERVING_SHED.labels(reason="queue_full").value
    for _ in range(3):
        gw.submit(np.zeros(4, np.int32))
    t0 = time.perf_counter()
    with pytest.raises(QueueFullError):
        gw.submit(np.zeros(4, np.int32))
    assert time.perf_counter() - t0 < 0.5       # shed, not blocked
    assert metrics.SERVING_SHED.labels(reason="queue_full").value \
        == shed0 + 1


def test_deadline_sheds_unadmitted_requests(tiny):
    model, params = tiny
    gw = ServingGateway(model, params, max_slots=1, block=8,
                        max_context=64, default_max_new=4)
    blocker = gw.submit(np.zeros(4, np.int32), max_new=40)
    doomed = gw.submit(np.zeros(4, np.int32), deadline_s=0.0)
    with pytest.raises(DeadlineExpiredError):
        doomed.result(timeout=30)
    assert blocker.result(timeout=120).shape == (44,)
    gw.shutdown()


def test_shutdown_drains_inflight_and_flushes_queue(tiny):
    model, params = tiny
    gw = ServingGateway(model, params, max_slots=1, block=8,
                        max_context=64, default_max_new=24)
    running = gw.submit(np.zeros(4, np.int32))
    for _ in range(500):                       # wait until admitted
        if running.n_generated():
            break
        time.sleep(0.01)
    queued = [gw.submit(np.zeros(4, np.int32)) for _ in range(2)]
    assert gw.shutdown(drain=True) == 2
    assert running.result(timeout=30).shape == (28,)   # drained to end
    for st in queued:
        with pytest.raises(ServingShutdownError):
            st.result(timeout=5)
    with pytest.raises(ServingShutdownError):
        gw.submit(np.zeros(4, np.int32))
    assert not gw.ready()
    assert gw._sched.pager.free_pages() == gw._sched.pager.n_pages - 1


def test_tenant_round_robin_fairness(tiny):
    """One chatty tenant must not starve another: with one slot, a flood
    from tenant A and a late pair from tenant B interleave, so both B
    requests serve before A's tail."""
    model, params = tiny
    gw = ServingGateway(model, params, max_slots=1, block=8,
                        max_context=32, default_max_new=8, queue_limit=32,
                        start=False)
    a = [gw.submit(np.zeros(3, np.int32), tenant="A") for _ in range(6)]
    b = [gw.submit(np.zeros(3, np.int32), tenant="B") for _ in range(2)]
    gw.warmup(prompt_lens=(3,))
    assert gw.ready()
    gw._worker = threading.Thread(target=gw._loop, daemon=True)
    gw._worker.start()
    for st in a + b:
        st.result(timeout=120)
    t_first = {st: st.t_first for st in a + b}
    assert max(t_first[st] for st in b) < max(t_first[st] for st in a[3:])
    gw.shutdown()


def test_admission_control_and_oversized_requests(tiny):
    """Pool smaller than the offered load: admission defers until pages
    free up, every request still completes, nothing leaks; a request
    that can never fit fails loudly at submit."""
    model, params = tiny
    gw = ServingGateway(model, params, max_slots=4, block=8,
                        max_context=32, n_pages=8, default_max_new=12,
                        queue_limit=32)
    streams = [gw.submit(np.zeros(3, np.int32)) for _ in range(10)]
    for st in streams:
        assert st.result(timeout=120).shape == (15,)
    gw._sched.pager.check_invariants()
    assert gw._sched.pager.free_pages() == 7
    gw.shutdown()
    small = ServingGateway(model, params, max_slots=2, block=8,
                           max_context=32, n_pages=3, start=False)
    with pytest.raises(ValueError, match="pages"):
        small.submit(np.zeros(20, np.int32), max_new=12)
    with pytest.raises(ValueError, match="max_context"):
        small.submit(np.zeros(30, np.int32), max_new=8)
    with pytest.raises(ValueError, match="empty"):
        small.submit(np.zeros(0, np.int32))
    with pytest.raises(ValueError, match="temperature"):
        small.submit(np.zeros(4, np.int32), temperature=0.0)


def test_cancel_queued_and_live_sequences(tiny):
    model, params = tiny
    gw = ServingGateway(model, params, max_slots=1, block=8,
                        max_context=32, default_max_new=16)
    live = gw.submit(np.zeros(4, np.int32))
    for _ in range(500):                      # wait until admitted
        if live.n_generated():
            break
        time.sleep(0.005)
    queued = gw.submit(np.zeros(4, np.int32))
    survivor = gw.submit(np.zeros(4, np.int32), max_new=4)
    assert gw.cancel(queued)                  # unqueued immediately
    assert gw.cancel(live)                    # evicted by the worker
    assert queued.result(timeout=10).shape == (4,)
    partial = live.result(timeout=30)
    assert live.error() is None and partial.shape[0] < 20
    assert survivor.result(timeout=60).shape == (8,)
    gw._sched.pager.check_invariants()
    assert gw._sched.pager.free_pages() == gw._sched.pager.n_pages - 1
    gw.shutdown()


def test_starved_large_request_ages_into_admission(tiny):
    model, params = tiny
    gw = ServingGateway(model, params, max_slots=2, block=8,
                        max_context=32, n_pages=5, queue_limit=32,
                        default_max_new=12, starvation_patience=0.2)
    small = lambda: gw.submit(np.zeros(3, np.int32), tenant="small",
                              max_new=12)          # 2 pages
    others = [small() for _ in range(2)]           # pool now full
    big = gw.submit(np.zeros(4, np.int32), tenant="big",
                    max_new=18)                    # needs 3 pages
    others += [small() for _ in range(8)]
    assert big.result(timeout=120).shape == (22,)
    for st in others:
        st.result(timeout=120)
    assert big.t_first < max(st.t_first for st in others[-4:])
    gw._sched.pager.check_invariants()
    gw.shutdown()


def test_step_fault_sheds_inflight_and_recovers(tiny):
    """A failing decode step sheds every in-flight sequence with a
    structured error carrying ITS OWN tokens; no page leaks and the same
    worker serves the next request. A failing prefill sheds only that
    request."""
    model, params = tiny
    gw = ServingGateway(model, params, max_slots=2, block=8,
                        max_context=64, default_max_new=30)
    sched = gw._sched
    real_step = sched._decode_step
    calls = [0]

    def poisoned(*a):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("synthetic device error")
        return real_step(*a)

    sched._decode_step = poisoned
    gw.pause()
    victims = [gw.submit(np.full(4, i, np.int32)) for i in range(2)]
    gw.resume()
    for st in victims:
        with pytest.raises(SequenceAborted) as ei:
            st.result(timeout=60)
        assert ei.value.tokens and ei.value.tokens == st._tokens
    assert victims[0]._tokens != victims[1]._tokens
    sched.pager.check_invariants()
    assert sched.pager.free_pages() == sched.pager.n_pages - 1
    real_prefill = sched._prefill_into_pages
    sched._prefill_into_pages = lambda *a: (_ for _ in ()).throw(
        RuntimeError("synthetic prefill error"))
    with pytest.raises(SequenceAborted, match="admission fault"):
        gw.submit(np.zeros(4, np.int32)).result(timeout=30)
    sched._prefill_into_pages = real_prefill
    assert gw.submit(np.zeros(4, np.int32),
                     max_new=4).result(timeout=60).shape == (8,)
    sched.pager.check_invariants()
    assert sched.pager.free_pages() == sched.pager.n_pages - 1
    gw.shutdown()


def test_sampled_serving_in_vocab_and_seeded(tiny):
    model, params = tiny

    def run():
        gw = ServingGateway(model, params, max_slots=2, block=8,
                            max_context=32, default_max_new=6,
                            sample=True, top_k=8, top_p=0.9, seed=3)
        out = gw.submit(np.zeros(4, np.int32),
                        temperature=0.8).result(timeout=60)
        gw.shutdown()
        return out

    a, b = run(), run()
    np.testing.assert_array_equal(a, b)       # one seed, one stream
    gen = a[4:]
    assert gen.shape == (6,) and ((gen >= 0) & (gen < 64)).all()


def test_serving_metrics_and_stats(tiny):
    model, params = tiny
    tok0 = metrics.SERVING_TOKENS.snapshot()[""]
    gw = ServingGateway(model, params, max_slots=2, block=8,
                        max_context=32, default_max_new=5)
    gw.submit(np.zeros(4, np.int32), tenant="t1").result(timeout=60)
    assert metrics.SERVING_TOKENS.snapshot()[""] == tok0 + 5
    assert metrics.SERVING_REQS.labels(tenant="t1").value >= 1
    s = gw.stats()
    assert s["active"] == 0 and s["queued"] == 0 and s["steps"] >= 4
    assert metrics.SERVING_KV_OCCUPANCY.snapshot()[""] == 0.0
    summary = metrics.step_summary()
    assert summary["serving.decode_step"]["count"] >= 4
    gw.shutdown()
