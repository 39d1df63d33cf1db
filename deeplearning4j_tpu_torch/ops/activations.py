"""Activation functions (port of ``deeplearning4j_tpu/ops/activations.py``).

The ported slices carry the activations their stacks name: identity
(the default of every layer), softmax (the heads, fused into the loss),
silu (the causal LM's SwiGLU gate), gelu in its erf and tanh forms and
tanh (BERT's encoder MLP and pooler), and relu. Each is a plain
elementwise torch function; gradients come from autograd. Other
reference names raise ``NotImplementedError`` until the slice that needs
them.
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


def relu(x):
    return F.relu(x)


def gelu(x):
    """The exact (erf) GELU, as the JAX package's ``gelu``."""
    return F.gelu(x)


def gelu_tanh(x):
    """The tanh-approximated GELU (``jax.nn.gelu``'s default form)."""
    return F.gelu(x, approximate="tanh")


def tanh(x):
    return torch.tanh(x)


_REGISTRY: Dict[str, Callable] = {
    "identity": identity,
    "linear": identity,
    "softmax": softmax,
    "swish": swish,
    "silu": swish,
    "relu": relu,
    "gelu": gelu,
    "gelu_tanh": gelu_tanh,
    "tanh": tanh,
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
