"""Named device-time scopes (port of ``devtime.scope`` from
``deeplearning4j_tpu/obs/devtime.py``).

A scope is a ``torch.profiler.record_function`` range: under
``torch.profiler.profile`` every op and kernel launched inside it is
attributed to the scope's name; with no profiler running it costs a few
microseconds of host time. The capture and gap-report half of the JAX
module is not ported here.
"""
from __future__ import annotations

import torch


def scope(name: str):
    """Context manager naming the ops launched inside it."""
    return torch.profiler.record_function(name)
