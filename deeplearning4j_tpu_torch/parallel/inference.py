"""ParallelInference — batched inference serving (port of
``deeplearning4j_tpu/parallel/inference.py``), and the serving errors the
gateway shares.

Reference: ``org.deeplearning4j.parallelism.ParallelInference`` (+
``BatchedInferenceObservable``): callers enqueue inputs, a worker
concatenates up to ``batch_limit`` examples into one batch, runs
``output()`` and delivers each caller its rows.

As in the JAX package: one forward a batch, the batch zero-padded to the
least of ``buckets`` that holds it (the JAX package pads to keep its jit
from retracing; the port keeps the padding so that the batch sizes the
network sees are the same few), a bounded queue that SHEDS when full, a
deadline a request that expires in the queue is dropped at, the
``serving`` fault site in the worker, the ``ParallelInference/batch``
span and the ``dl4j_tpu_inference_*`` metrics. The forward runs on the
network's device (the card unless the network was built on the CPU), and
every result comes back to the caller as a host numpy array, as the JAX
``np.asarray`` gives it: the copy is where the worker waits for the
device, so the latency it records is the request's whole.

Mode INPLACE runs the caller's input at once on the caller's thread;
BATCHED (the default) queues it for the worker thread. A request of
``ndim > 1`` is a batch of examples along axis 0, a 1-D request one
example (the JAX rule: send an image as [1, H, W, C]). A
``ComputationGraph``, whose ``output`` returns a list, answers each
request with the list of its rows of every output; the JAX worker
handles a ``MultiLayerNetwork``'s one output only.

:meth:`ParallelInference.warmup` builds the network's forward for every
batch bucket before the first request (on the card it captures the
``output`` graph of each; ``perf/warmup.py``), so a first request on a
warmed bucket adds no trace.

Not in this slice: model-parallel serving (``mesh``, ``shard_params``,
:func:`shard_model_params`; ROADMAP item A13) raises
``NotImplementedError``.
"""
from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.resilience import faults


class QueueFullError(RuntimeError):
    """The bounded serving queue is full: the request is SHED (counted
    in ``dl4j_tpu_inference_requests_shed_total{reason="queue_full"}``,
    or the gateway's ``dl4j_tpu_serving_requests_shed_total``) instead of
    blocking the caller indefinitely."""


class ServingShutdownError(RuntimeError):
    """The serving queue was shut down before this request dispatched;
    ``shutdown()`` delivers it to every queued request so pending
    waits return immediately instead of burning their full timeout."""


class DeadlineExpiredError(TimeoutError):
    """The request's deadline passed while it sat in the queue; it is
    shed instead of computed."""


def _model_parallel(what: str):
    raise NotImplementedError(
        f"ParallelInference: {what} (model-parallel serving over a mesh "
        "'model' axis) comes with ROADMAP item A13")


def shard_model_params(net, mesh, axis: str = "model"):
    """Model-parallel serving's weight placement: ROADMAP item A13."""
    _model_parallel("shard_model_params")


def _host(out):
    """A forward's output (a tensor, or a graph's list of them) as host
    numpy arrays."""
    if isinstance(out, (list, tuple)):
        return [_host(o) for o in out]
    return out.detach().cpu().numpy()


def _rows(out, start: int, stop: int):
    """Rows ``start:stop`` of an output, or of each output of a list."""
    if isinstance(out, list):
        return [o[start:stop] for o in out]
    return out[start:stop]


class _Observable:
    """Reference: InferenceObservable — a future for one request.
    ``deadline`` (absolute ``obs.now()`` time, None = none) rides along
    to the dispatch worker, which skips the request once expired."""

    def __init__(self, x, deadline: Optional[float] = None):
        self.x = x
        self.t_enqueue = obs.now()   # request-latency anchor
        self.deadline = deadline
        self._event = threading.Event()
        self._result = None
        self._error = None

    def set(self, result):
        self._result = result
        self._event.set()

    def set_error(self, e):
        self._error = e
        self._event.set()

    def get(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("inference result not ready")
        if self._error is not None:
            raise self._error
        return self._result


def _request(x) -> torch.Tensor:
    """A request's input as a tensor: a tensor stays where it lives, an
    array-like becomes a host tensor (``np.asarray``'s dtype)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


class ParallelInference:
    INPLACE = "inplace"
    BATCHED = "batched"

    def __init__(self, net, mode: str = BATCHED, batch_limit: int = 32,
                 queue_limit: int = 64, buckets=(1, 2, 4, 8, 16, 32),
                 mesh=None, shard_params: bool = False,
                 model_axis: str = "model"):
        if mesh is not None or shard_params:
            _model_parallel("mesh= and shard_params=True")
        if mode not in (self.INPLACE, self.BATCHED):
            raise ValueError(f"unknown mode {mode!r}")
        self.net = net
        self.mode = mode
        self.batch_limit = batch_limit
        self.buckets = tuple(sorted(buckets))
        self._q: queue.Queue = queue.Queue(maxsize=queue_limit)
        self._stop = threading.Event()
        self._shutdown = threading.Event()
        self._worker = None
        if mode == self.BATCHED:
            self._worker = threading.Thread(target=self._loop, daemon=True)
            self._worker.start()

    # -- public API (reference ParallelInference.output) ----------------
    def warmup(self, feature_shape, dtype: str = "float32"):
        """Build the network's forward for every declared batch bucket
        (``perf.warmup.warmup_inference``; the JAX ``warmup``):
        ``feature_shape`` is ONE example's shape. Returns
        ``{"compiled": n, "seconds": t}``."""
        from deeplearning4j_tpu_torch.perf.warmup import warmup_inference
        return warmup_inference(self, feature_shape, dtype)

    def output(self, x, timeout: Optional[float] = 30.0):
        """The network's output for ``x`` as host numpy arrays.
        ``timeout`` doubles as the request DEADLINE: once it passes, the
        dispatch worker drops the request unserved."""
        if self.mode == self.INPLACE:
            t0 = obs.now()
            with torch.no_grad():
                out = _host(self.net.output(_request(x)))
            obs.metrics.INFER_REQS.inc()
            obs.metrics.INFER_LATENCY.observe(obs.now() - t0)
            return out
        # `is not None`, not truthiness: an explicit timeout of 0 means
        # "already expired" (shed at once), not "no deadline"
        ob = _Observable(
            _request(x), deadline=obs.now() + timeout
            if timeout is not None else None)
        self._submit(ob)
        return ob.get(timeout)

    def output_async(self, x,
                     deadline_s: Optional[float] = None) -> _Observable:
        """Enqueue without waiting. ``deadline_s`` (seconds from now,
        None = no deadline) bounds how long the request may wait in the
        queue before the worker drops it."""
        ob = _Observable(
            _request(x), deadline=obs.now() + deadline_s
            if deadline_s is not None else None)
        self._submit(ob)
        return ob

    def _submit(self, ob: _Observable) -> None:
        """Bounded enqueue: a full queue SHEDS (raises QueueFullError)
        instead of blocking the caller into an unbounded latency tail."""
        if self._shutdown.is_set():
            raise ServingShutdownError(
                "ParallelInference is shut down; request refused")
        obs.metrics.INFER_REQS.inc()   # every arrival: the shed count is
        try:                           # a subset of requests_total
            self._q.put_nowait(ob)
        except queue.Full:
            obs.metrics.REQS_SHED.labels(reason="queue_full").inc()
            raise QueueFullError(
                f"serving queue full ({self._q.maxsize} pending "
                f"requests); shedding — retry with backoff or scale "
                f"out replicas") from None
        if self._shutdown.is_set():
            # raced with shutdown(): its drain may already be past the
            # queue, leaving this request unserved — error it out here so
            # no get() waits out its full timeout
            obs.metrics.REQS_SHED.labels(reason="shutdown").inc()
            ob.set_error(ServingShutdownError(
                "ParallelInference shut down; request refused"))
            raise ServingShutdownError(
                "ParallelInference shut down; request refused")
        obs.metrics.INFER_QUEUE.set(self._q.qsize())

    def shutdown(self, timeout: float = 5.0):
        """Graceful drain: refuse new requests, stop the worker (its
        in-flight batch completes and delivers), then error out every
        still-queued request so pending ``get()`` calls return at once.
        Returns how many were drained."""
        self._shutdown.set()
        self._stop.set()
        if self._worker:
            try:
                self._q.put_nowait(None)   # wake a blocked get()
            except queue.Full:
                pass                       # the worker is mid-drain: it
            self._worker.join(timeout)     # sees _stop on its own
        drained = 0
        while True:
            try:
                ob = self._q.get_nowait()
            except queue.Empty:
                break
            if ob is None or ob._event.is_set():
                continue            # already delivered or errored
            obs.metrics.REQS_SHED.labels(reason="shutdown").inc()
            ob.set_error(ServingShutdownError(
                "ParallelInference shut down before this request was "
                "dispatched"))
            drained += 1
        obs.metrics.INFER_QUEUE.set(0)
        return drained

    # -- batching worker (reference BatchedInferenceObservable) ---------
    def _bucket(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _infer(self, batch: torch.Tensor):
        """The network's output for ``batch``'s rows, the batch zero-padded
        to its bucket on the way in and the pad's rows cut on the way out,
        as host arrays."""
        n = batch.shape[0]
        pad = self._bucket(n) - n
        if pad > 0:
            batch = torch.cat([batch, batch.new_zeros(
                (pad,) + tuple(batch.shape[1:]))])
        with torch.no_grad():
            out = self.net.output(batch)
        if isinstance(out, tuple):
            out = list(out)
        return _host(_rows(out, 0, n))

    def _loop(self):
        obs.trace.set_thread_name("pi-serving")
        while not self._stop.is_set():
            first = self._q.get()
            if first is None:
                continue
            group = [first]
            count = first.x.shape[0] if first.x.ndim > 1 else 1
            # drain up to batch_limit without blocking
            while count < self.batch_limit:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    break
                group.append(nxt)
                count += nxt.x.shape[0] if nxt.x.ndim > 1 else 1
            obs.metrics.INFER_QUEUE.set(self._q.qsize())
            # deadline propagation: skip requests that expired in the
            # queue — their callers' get() already timed out
            now = obs.now()
            live = []
            for o in group:
                if o.deadline is not None and now > o.deadline:
                    obs.metrics.REQS_SHED.labels(reason="deadline").inc()
                    o.set_error(DeadlineExpiredError(
                        f"request deadline expired after "
                        f"{now - o.t_enqueue:.3f}s in the serving "
                        f"queue; dropped undispatched"))
                else:
                    live.append(o)
            group = live
            if not group:
                continue
            try:
                faults.inject("serving")  # site: serving worker batch
                arrays = [o.x if o.x.ndim > 1 else o.x[None]
                          for o in group]
                sizes = [a.shape[0] for a in arrays]
                batch = torch.cat(arrays)
                tb0 = obs.now()
                out = self._infer(batch)
                if obs.trace.enabled():
                    obs.trace.add_span(
                        "ParallelInference/batch", tb0, obs.now(),
                        args={"requests": len(group),
                              "examples": int(batch.shape[0])})
                obs.metrics.INFER_BATCH.observe(batch.shape[0])
                done = obs.now()
                ofs = 0
                for o, s in zip(group, sizes):
                    res = _rows(out, ofs, ofs + s)
                    if o.x.ndim <= 1:          # one example: its row
                        res = ([r[0] for r in res]
                               if isinstance(res, list) else res[0])
                    obs.metrics.INFER_LATENCY.observe(done - o.t_enqueue)
                    o.set(res)
                    ofs += s
            except Exception as e:  # deliver errors to all waiters
                for o in group:
                    o.set_error(e)
