"""Weight initialisation (port of ``deeplearning4j_tpu/nn/weights.py``).

Each initialiser draws from an explicit CPU ``torch.Generator``, so the
same seed gives the same values on every device (the caller moves them).
The values differ from ``jax.random``'s: the rules (distribution and
scale) are the JAX package's, the streams are not; tests carry JAX
weights across instead. This slice carries the rules the causal LM
uses, ``xavier`` (glorot normal) and ``normal`` (N(0, 1/F) over the last
axis); other names raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def xavier(gen: torch.Generator, shape, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return torch.randn(shape, generator=gen, dtype=dtype) * std


def normal(gen: torch.Generator, shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, dtype=dtype) / math.sqrt(
        shape[-1])


_REGISTRY: Dict[str, Callable] = {
    "xavier": xavier,
    "glorot_normal": xavier,
    "normal": normal,
}


def get(name_or_fn) -> Callable:
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in _REGISTRY:
        raise NotImplementedError(
            f"weight init {name_or_fn!r} is not ported yet (this slice "
            f"has {sorted(_REGISTRY)}; the rest come with the "
            "MultiLayerNetwork-core slice)")
    return _REGISTRY[key]
