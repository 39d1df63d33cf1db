"""Serving gateway — the continuous-batching front end.

Port of ``deeplearning4j_tpu/serving/gateway.py``: ``submit()`` returns
a :class:`TokenStream` whose tokens arrive as the in-flight batch
produces them; admission is controlled by the paged pool's free list (a
request is admitted only when its WHOLE life fits — no mid-flight
stall); a round-robin cursor over per-tenant queues keeps one chatty
tenant from starving the rest, and a head that has waited past
``starvation_patience`` pauses younger admissions until it fits.

The worker thread is the only mutator of scheduler/pager state: each
iteration evicts cancelled sequences, admits queued prompts into free
pages, and runs one decode step. A failed step sheds every in-flight
sequence with a structured :class:`SequenceAborted` — pages released,
worker alive — and later requests serve normally. The worker launches
the kernels on its own thread's current CUDA stream.

Shed taxonomy (``dl4j_tpu_serving_requests_shed_total{reason=}``):
``queue_full`` at submit, ``deadline`` when the admission wait outlives
the request's budget, ``shutdown`` at drain, ``fault`` when a step or
an admission fails. (The JAX package's injected-fault site comes with
the resilience slice.)
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Dict, Optional

import numpy as np

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.parallel.inference import (
    DeadlineExpiredError, QueueFullError, ServingShutdownError)
from deeplearning4j_tpu_torch.serving.scheduler import DecodeScheduler


class SequenceAborted(RuntimeError):
    """An in-flight sequence was shed mid-generation (step fault or
    forced drain). Structured: carries the tokens already streamed and
    the cause, so a client can resubmit with the shortened prompt."""

    def __init__(self, msg: str, tokens=None, cause=None):
        super().__init__(msg)
        self.tokens = list(tokens or [])
        self.cause = cause


#: request ids — process-unique, monotonic
_RID = itertools.count(1)


class TokenStream:
    """One request's streaming observable: tokens arrive as the
    continuous batch produces them; ``result()`` waits for the full
    sequence; ``tokens()`` iterates live (the streaming API)."""

    def __init__(self, prompt, max_new: int, tenant: str,
                 temperature: Optional[float],
                 eos_id: Optional[int], deadline: Optional[float]):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new = int(max_new)
        self.tenant = tenant
        self.temperature = temperature
        self.eos_id = eos_id
        self.deadline = deadline        # absolute obs.now() time
        self.rid = next(_RID)
        self.t_submit = obs.now()
        self.t_admit: Optional[float] = None
        self.t_first: Optional[float] = None
        self._tokens: list = []
        self._done = False
        self._error: Optional[Exception] = None
        self._cond = threading.Condition()

    # -- scheduler-facing callbacks (duck-typed request protocol) --------
    def push(self, tok: int) -> None:
        with self._cond:
            self._tokens.append(int(tok))
            if self.t_first is None:
                self.t_first = obs.now()
                obs.metrics.SERVING_TTFT.observe(
                    self.t_first - self.t_submit)
            self._cond.notify_all()

    def finish(self) -> None:
        with self._cond:
            self._done = True
            self._cond.notify_all()

    def fail(self, e: Exception) -> None:
        with self._cond:
            if self._done:
                return
            if isinstance(e, SequenceAborted) and not e.tokens:
                e.tokens = list(self._tokens)
            self._error = e
            self._done = True
            self._cond.notify_all()

    # -- client API ------------------------------------------------------
    @property
    def ttft_s(self) -> Optional[float]:
        return (None if self.t_first is None
                else self.t_first - self.t_submit)

    def n_generated(self) -> int:
        with self._cond:
            return len(self._tokens)

    def done(self) -> bool:
        with self._cond:
            return self._done

    def error(self) -> Optional[Exception]:
        with self._cond:
            return self._error

    def tokens(self, timeout: Optional[float] = 30.0):
        """Yield tokens as they stream in; raises the terminal error
        (if any) after the last delivered token."""
        i = 0
        while True:
            with self._cond:
                while i >= len(self._tokens) and not self._done:
                    if not self._cond.wait(timeout):
                        raise TimeoutError(
                            "token stream stalled past timeout")
                if i < len(self._tokens):
                    tok = self._tokens[i]
                else:           # done and drained
                    if self._error is not None:
                        raise self._error
                    return
            yield tok
            i += 1

    def result(self, timeout: Optional[float] = 30.0) -> np.ndarray:
        """Block until the sequence completes; returns
        ``[T0 + n_generated]`` int32 (prompt + generation), mirroring
        ``generate()``'s prompt-reattached contract."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._done, timeout):
                raise TimeoutError("sequence not finished in time")
            if self._error is not None:
                raise self._error
            gen = np.asarray(self._tokens, np.int32)
        return np.concatenate([self.prompt, gen])


class ServingGateway:
    """Continuous-batching serving front end for ``CausalTransformerLM``
    parameters. Constructor knobs flow to :class:`DecodeScheduler`
    (slots/pages/block/sampling, ``spec_k``, ``prefix_sharing``) and
    the queue policy (``queue_limit``, ``default_max_new``); the pool
    lives on ``params``' device.

    Concurrency contract: ``_lock`` protects the tenant queues (and the
    deferred-cancel list) ONLY. Scheduler/pager state is mutated
    exclusively by the worker thread — device launches and blocking
    syncs run OUTSIDE the lock, so ``submit()`` latency is never coupled
    to a decode iteration — plus by ``shutdown()`` after the worker has
    been joined."""

    def __init__(self, model, params, *, max_slots: int = 8,
                 block: int = 16, n_pages: Optional[int] = None,
                 max_context: Optional[int] = None,
                 queue_limit: int = 64, default_max_new: int = 64,
                 sample: bool = False, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0,
                 eos_id: Optional[int] = None,
                 starvation_patience: float = 5.0,
                 start: bool = True, spec_k: int = 1,
                 prefix_sharing: bool = False):
        self._sched = DecodeScheduler(
            model, params, max_slots=max_slots, block=block,
            n_pages=n_pages, max_context=max_context, sample=sample,
            top_k=top_k, top_p=top_p, seed=seed, spec_k=spec_k,
            prefix_sharing=prefix_sharing)
        self.queue_limit = int(queue_limit)
        self.default_max_new = int(default_max_new)
        self.eos_id = eos_id
        # anti-starvation aging: once a skipped head has waited this
        # long, younger admissions pause so freed pages can ACCUMULATE
        # until it fits
        self.starvation_patience = float(starvation_patience)
        self._tenants: Dict[str, deque] = {}
        self._rr: list = []             # tenant round-robin order
        self._rr_next = 0
        # metric-label cardinality cap: tenant names are caller-
        # controlled; past this many distinct names the rest share one
        # "other" label (queues stay per-tenant)
        self._tenant_labels: set = set()
        self.max_tenant_labels = 64
        self._cancels: list = []        # live-sequence cancels, evicted
        self._lock = threading.RLock()  # by the worker next iteration
        self._work = threading.Condition(self._lock)
        self._shutdown = threading.Event()
        self._pause = threading.Event()     # worker hold request
        self._parked = threading.Event()    # worker's "I'm held" ack
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._warm_report = None        # set by warmup(); ready() gate
        if start:
            self._worker = threading.Thread(target=self._loop,
                                            name="serving-gateway",
                                            daemon=True)
            self._worker.start()

    # -- public API ------------------------------------------------------
    def warmup(self, prompt_lens=None):
        """Run every program of the scheduler's mode once (kernels
        built, every shape through the device; see
        ``DecodeScheduler.warmup``). Call BEFORE taking traffic: the
        worker is idle then."""
        self._warm_report = self._sched.warmup(prompt_lens)
        return self._warm_report

    def ready(self) -> bool:
        """True once :meth:`warmup` has run (and the gateway is not shut
        down): a live-but-cold gateway would build kernels on the
        request path."""
        return (self._warm_report is not None
                and not self._shutdown.is_set())

    def warm_report(self):
        """The last :meth:`warmup` report (None before first warmup)."""
        return self._warm_report

    def pause(self, timeout: float = 30.0) -> bool:
        """Park the worker at its next loop top (any in-flight step
        finishes first), so a whole burst can be queued before a single
        admission happens. Returns True once the worker acknowledges
        the park (False on timeout or when no worker is running)."""
        self._pause.set()
        with self._lock:
            self._work.notify_all()
        if self._worker is None or not self._worker.is_alive():
            return False
        return self._parked.wait(timeout)

    def resume(self) -> None:
        """Release a :meth:`pause` hold."""
        self._parked.clear()
        self._pause.clear()
        with self._lock:
            self._work.notify_all()

    def submit(self, prompt, max_new: Optional[int] = None,
               tenant: str = "default",
               temperature: Optional[float] = None,
               deadline_s: Optional[float] = None) -> TokenStream:
        """Enqueue one sequence; returns its streaming observable.
        ``deadline_s`` bounds the ADMISSION wait (`is not None`
        semantics — an explicit 0 sheds immediately); a full gateway
        queue sheds with :class:`QueueFullError` rather than blocking
        the caller."""
        if self._shutdown.is_set():
            raise ServingShutdownError(
                "serving gateway is shut down; request refused")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        max_new = int(max_new if max_new is not None
                      else self.default_max_new)
        if max_new < 1:
            raise ValueError(f"max_new={max_new} must be >= 1")
        if temperature is not None and temperature <= 0:
            raise ValueError(f"temperature={temperature} must be > 0 "
                             "(omit it for the gateway default; use a "
                             "sample=False gateway for greedy)")
        mc = self._sched.max_context
        if prompt.size + max_new > mc:
            raise ValueError(f"prompt+max_new ({prompt.size + max_new})"
                             f" exceeds max_context={mc}")
        need = self._sched.pages_needed(prompt.size, max_new)
        if need > self._sched.pager.n_pages - 1:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self._sched.pager.n_pages - 1} — lower max_new or "
                "size the pool for the workload")
        with self._lock:    # check-then-add must not race submits
            if tenant in self._tenant_labels or \
                    len(self._tenant_labels) < self.max_tenant_labels:
                self._tenant_labels.add(tenant)
                label = tenant
            else:
                label = "other"
        obs.metrics.SERVING_REQS.labels(tenant=label).inc()
        stream = TokenStream(
            prompt, max_new, tenant, temperature, self.eos_id,
            deadline=(obs.now() + deadline_s
                      if deadline_s is not None else None))
        with self._lock:
            # re-check under the lock: shutdown() drains the queues
            # under this same lock
            if self._shutdown.is_set():
                raise ServingShutdownError(
                    "serving gateway is shut down; request refused")
            if self._queued() >= self.queue_limit:
                obs.metrics.SERVING_SHED.labels(
                    reason="queue_full").inc()
                raise QueueFullError(
                    f"gateway queue full ({self.queue_limit} waiting);"
                    " shedding — retry with backoff or scale out")
            q = self._tenants.get(tenant)
            if q is None:
                q = self._tenants[tenant] = deque()
                self._rr.append(tenant)
            q.append(stream)
            obs.metrics.SERVING_QUEUE.set(self._queued())
            self._work.notify_all()
        return stream

    def stats(self) -> Dict[str, float]:
        """Occupancy snapshot (scheduler counters read without pausing
        the worker — approximate under live traffic)."""
        s = self._sched
        with self._lock:
            queued = self._queued()
        return {"active": s.active_count(), "queued": queued,
                "free_pages": s.pager.free_pages(),
                "steps": s.steps, "tokens_out": s.tokens_out}

    def cancel(self, stream: TokenStream) -> bool:
        """Unqueue a waiting request immediately, or schedule a live
        sequence's eviction (the worker performs it at its next
        iteration)."""
        with self._lock:
            q = self._tenants.get(stream.tenant)
            if q is not None and stream in q:
                q.remove(stream)
                obs.metrics.SERVING_QUEUE.set(self._queued())
                stream.finish()
                return True
            self._cancels.append(stream)
            self._work.notify_all()
        return True

    def shutdown(self, drain: bool = True, timeout: float = 30.0
                 ) -> int:
        """Graceful drain: refuse new submits, error every QUEUED stream
        out immediately, let in-flight sequences finish (``drain=True``)
        or shed them too (``drain=False``), stop the worker. Any
        in-flight sequence still live when the worker stops is shed
        with a structured ``ServingShutdownError`` AFTER the worker is
        joined. Returns the number of streams errored out."""
        self._shutdown.set()
        dropped = 0
        with self._lock:
            for q in self._tenants.values():
                while q:
                    st = q.popleft()
                    obs.metrics.SERVING_SHED.labels(
                        reason="shutdown").inc()
                    st.fail(ServingShutdownError(
                        "gateway shut down before this request was "
                        "admitted"))
                    dropped += 1
            obs.metrics.SERVING_QUEUE.set(0)
            self._work.notify_all()
        if drain:
            deadline = obs.now() + timeout
            while obs.now() < deadline:
                if self._sched.active_count() == 0:
                    break
                self._stop.wait(0.01)
        self._stop.set()
        with self._lock:
            self._work.notify_all()
        if self._worker is not None:
            self._worker.join(timeout)
            if self._worker.is_alive():
                # worker wedged mid-launch: mutating scheduler state
                # under it would corrupt the pool bookkeeping
                return dropped
        # worker joined (or never started): this thread is now the sole
        # mutator — shed whatever is still in flight
        n = self._sched.shed_all(lambda: ServingShutdownError(
            "gateway shut down mid-generation"))
        for _ in range(n):
            obs.metrics.SERVING_SHED.labels(reason="shutdown").inc()
        return dropped + n

    # -- worker ----------------------------------------------------------
    def _queued(self) -> int:
        return sum(len(q) for q in self._tenants.values())

    def _next_admission(self) -> Optional[TokenStream]:
        """Pop the next admissible request under the lock (round-robin
        across tenants, expired deadlines shed on the spot) — the
        prefill runs OUTSIDE the lock, in the worker. Returns None when
        nothing fits current capacity, or when a head past
        ``starvation_patience`` is waiting for pages to accumulate."""
        with self._lock:
            starved_cutoff = obs.now() - self.starvation_patience
            # reclaim drained tenants (caller-controlled names)
            for t in [t for t in self._rr if not self._tenants.get(t)]:
                self._rr.remove(t)
                self._tenants.pop(t, None)
            order = list(self._rr)
            if not order:
                return None
            # anti-starvation pre-pass: once the OLDEST waiting head has
            # aged past patience, it is the only admissible request
            oldest, oldest_q = None, None
            for t in order:
                q = self._tenants[t]
                self._shed_expired_heads(q)
                if q and (oldest is None
                          or q[0].t_submit < oldest.t_submit):
                    oldest, oldest_q = q[0], q
            if oldest is not None and oldest.t_submit < starved_cutoff:
                if self._sched.can_admit(oldest.prompt.size,
                                         oldest.max_new):
                    oldest_q.popleft()
                    obs.metrics.SERVING_QUEUE.set(self._queued())
                    return oldest
                return None
            start = self._rr_next % len(order)
            for k in range(len(order)):
                tenant = order[(start + k) % len(order)]
                q = self._tenants[tenant]
                if not q:
                    continue
                head = q[0]
                if not self._sched.can_admit(head.prompt.size,
                                             head.max_new):
                    continue
                q.popleft()
                self._rr_next = (start + k + 1) % len(order)
                obs.metrics.SERVING_QUEUE.set(self._queued())
                return head
            return None

    def _shed_expired_heads(self, q: deque) -> None:
        """Shed every expired head-of-line request of one tenant queue
        (called under the lock, once per admission pass)."""
        while q:
            head = q[0]
            if head.deadline is None or obs.now() <= head.deadline:
                return
            q.popleft()
            obs.metrics.SERVING_SHED.labels(reason="deadline").inc()
            obs.metrics.SERVING_QUEUE.set(self._queued())
            head.fail(DeadlineExpiredError(
                f"deadline expired after "
                f"{obs.now() - head.t_submit:.3f}s waiting for "
                "admission"))

    def _admit_queued(self) -> int:
        """Admit until capacity or the queues run dry. An admission
        failure sheds THAT request with a structured error (the
        scheduler released its pages) and the worker keeps serving."""
        admitted = 0
        while True:
            head = self._next_admission()
            if head is None:
                return admitted
            head.t_admit = obs.now()
            try:
                if not self._sched.admit(head):
                    # capacity race (cannot happen single-mutator, but
                    # never drop a request on a false admit)
                    with self._lock:
                        self._tenants[head.tenant].appendleft(head)
                        obs.metrics.SERVING_QUEUE.set(self._queued())
                    return admitted
            except Exception as e:
                obs.metrics.SERVING_SHED.labels(reason="fault").inc()
                head.fail(SequenceAborted(
                    f"request shed by admission fault: "
                    f"{type(e).__name__}: {e}", cause=e))
            else:
                admitted += 1

    def _drain_cancels(self) -> None:
        with self._lock:
            cancels, self._cancels = self._cancels, []
        for st in cancels:
            self._sched.evict(st)

    def _loop(self) -> None:
        while not self._stop.is_set():
            if self._pause.is_set():
                self._parked.set()
                with self._lock:
                    self._work.wait(0.05)
                continue
            self._drain_cancels()
            if not self._shutdown.is_set():
                self._admit_queued()
            if self._sched.active_count() == 0:
                with self._lock:
                    if not (self._queued() or self._cancels):
                        # park until a submit arrives (or shutdown)
                        self._work.wait(0.05)
                continue
            try:
                # no gateway lock here: submit() never waits out a
                # decode iteration
                self._sched.step()
            except Exception as e:
                n = self._sched.shed_all(lambda: SequenceAborted(
                    f"in-flight sequences shed by serving fault: "
                    f"{type(e).__name__}: {e}", cause=e))
                for _ in range(n):
                    obs.metrics.SERVING_SHED.labels(
                        reason="fault").inc()
