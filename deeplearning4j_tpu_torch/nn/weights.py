"""Weight initialisation (port of ``deeplearning4j_tpu/nn/weights.py``).

Each initialiser draws from an explicit CPU ``torch.Generator``, so the
same seed gives the same values on every device (the caller moves them).
The values differ from ``jax.random``'s: the rules (distribution, fans
and scale) are the JAX package's, the streams are not; tests carry JAX
weights across instead. Every name of the JAX registry is here: xavier
(glorot normal), xavier_uniform (glorot_uniform), xavier_fan_in, relu
(he_normal), relu_uniform (he_uniform), lecun_normal, lecun_uniform,
normal (N(0, 1/F) over the last axis), uniform (±1/sqrt(fan in)), zero,
ones and identity; an unknown name raises ``ValueError``.
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
    # conv kernels [*spatial, in, out] (channels-last layout)
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def _normal(gen, shape, dtype, std: float):
    return torch.randn(shape, generator=gen, dtype=dtype) * std


def _uniform(gen, shape, dtype, limit: float):
    """U(−limit, limit), as ``jax.random.uniform(key, shape, dtype,
    -limit, limit)``."""
    u = torch.rand(shape, generator=gen, dtype=dtype)
    return u * (2 * limit) - limit


def xavier(gen: torch.Generator, shape, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    return _normal(gen, shape, dtype, math.sqrt(2.0 / (fan_in + fan_out)))


def xavier_uniform(gen: torch.Generator, shape, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    return _uniform(gen, shape, dtype, math.sqrt(6.0 / (fan_in + fan_out)))


def xavier_fan_in(gen: torch.Generator, shape, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    return torch.randn(shape, generator=gen, dtype=dtype) / math.sqrt(
        fan_in)


def relu_init(gen: torch.Generator, shape, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    return _normal(gen, shape, dtype, math.sqrt(2.0 / fan_in))


def relu_uniform(gen: torch.Generator, shape, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    return _uniform(gen, shape, dtype, math.sqrt(6.0 / fan_in))


def lecun_normal(gen: torch.Generator, shape, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    return torch.randn(shape, generator=gen, dtype=dtype) / math.sqrt(
        fan_in)


def lecun_uniform(gen: torch.Generator, shape, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    return _uniform(gen, shape, dtype, math.sqrt(3.0 / fan_in))


def normal(gen: torch.Generator, shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, dtype=dtype) / math.sqrt(
        shape[-1])


def uniform(gen: torch.Generator, shape, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    return _uniform(gen, shape, dtype, 1.0 / math.sqrt(fan_in))


def zero(gen: torch.Generator, shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def ones_(gen: torch.Generator, shape, dtype=torch.float32):
    return torch.ones(shape, dtype=dtype)


def identity(gen: torch.Generator, shape, dtype=torch.float32):
    if len(shape) != 2 or shape[0] != shape[1]:
        raise ValueError("IDENTITY init needs square 2-D shape")
    return torch.eye(shape[0], dtype=dtype)


_REGISTRY: Dict[str, Callable] = {
    "xavier": xavier,
    "xavier_uniform": xavier_uniform,
    "xavier_fan_in": xavier_fan_in,
    "glorot_normal": xavier,
    "glorot_uniform": xavier_uniform,
    "relu": relu_init,
    "he_normal": relu_init,
    "relu_uniform": relu_uniform,
    "he_uniform": relu_uniform,
    "lecun_normal": lecun_normal,
    "lecun_uniform": lecun_uniform,
    "normal": normal,
    "uniform": uniform,
    "zero": zero,
    "ones": ones_,
    "identity": identity,
}


def get(name_or_fn) -> Callable:
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown weight init {name_or_fn!r}; known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]


def names():
    return sorted(_REGISTRY)
