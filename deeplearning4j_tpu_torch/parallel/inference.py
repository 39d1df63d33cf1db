"""Serving errors shared by the gateway (port of the exception classes
of ``deeplearning4j_tpu/parallel/inference.py``; ``ParallelInference``
itself comes with a later serving slice)."""
from __future__ import annotations


class QueueFullError(RuntimeError):
    """The bounded serving queue is full: the request is SHED (counted
    in ``dl4j_tpu_serving_requests_shed_total{reason="queue_full"}``)
    instead of blocking the caller indefinitely."""


class ServingShutdownError(RuntimeError):
    """The serving queue was shut down before this request dispatched;
    ``shutdown()`` delivers it to every queued stream so pending
    waits return immediately instead of burning their full timeout."""


class DeadlineExpiredError(TimeoutError):
    """The request's deadline passed while it sat in the queue; it is
    shed instead of computed."""
