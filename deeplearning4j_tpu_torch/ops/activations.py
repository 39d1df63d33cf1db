"""Activation functions (port of ``deeplearning4j_tpu/ops/activations.py``).

This slice carries the activations the causal LM's stack names:
identity (the default of every layer), softmax (the LM head, fused into
the loss) and silu (the SwiGLU gate). Each is a plain elementwise torch
function; gradients come from autograd. Other reference names raise
``NotImplementedError`` until the slice that needs them.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F


def identity(x):
    return x


def softmax(x, axis: int = -1):
    return torch.softmax(x, dim=axis)


def swish(x):
    return F.silu(x)


_REGISTRY: Dict[str, Callable] = {
    "identity": identity,
    "linear": identity,
    "softmax": softmax,
    "swish": swish,
    "silu": swish,
}


def get(name_or_fn) -> Callable:
    """Resolve an activation by reference enum name (case-insensitive);
    a callable is returned as it is."""
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in _REGISTRY:
        raise NotImplementedError(
            f"activation {name_or_fn!r} is not ported yet (this slice "
            f"has {sorted(_REGISTRY)}; the rest come with the "
            "MultiLayerNetwork-core slice)")
    return _REGISTRY[key]
