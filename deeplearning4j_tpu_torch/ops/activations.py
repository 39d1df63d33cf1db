"""Activation functions (port of ``deeplearning4j_tpu/ops/activations.py``).

Every activation of the JAX registry, under its names and with its
formula and constants (``jax.nn``'s where it calls one: ``selu``'s α
and λ, ``hardsigmoid``'s 0.2 slope against ``hardsigmoid_keras``'s
relu6(x + 3)/6, ``rationaltanh`` as 1.7159·tanh(2x/3)). Each is a plain
torch function; gradients come from autograd. A ``name:param`` suffix
sets the α of ``leakyrelu``, ``elu`` and ``celu``, the θ of
``thresholdedrelu`` and the cap of ``clippedrelu``, as in the JAX
package; an unknown name raises ``ValueError``.
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


def relu6(x):
    return F.relu6(x)


def leakyrelu(x, alpha: float = 0.01):
    return F.leaky_relu(x, alpha)


def elu(x, alpha: float = 1.0):
    return F.elu(x, alpha)


#: ``jax.nn.selu``'s constants
_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def selu(x):
    return _SELU_SCALE * torch.where(
        x > 0, x, _SELU_ALPHA * torch.expm1(torch.clamp(x, max=0.0)))


def celu(x, alpha: float = 1.0):
    return F.celu(x, alpha)


def sigmoid(x):
    return torch.sigmoid(x)


def hardsigmoid(x):
    """The reference's hard sigmoid: clip(0.2·x + 0.5, 0, 1)."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def hardsigmoid_keras(x):
    """Keras 3's hard sigmoid: relu6(x + 3) / 6 (slope 1/6)."""
    return F.relu6(x + 3.0) / 6.0


def hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


def rationaltanh(x):
    """The JAX package's RationalTanh: 1.7159 · tanh(2x / 3)."""
    return 1.7159 * torch.tanh(2.0 * x / 3.0)


def rectifiedtanh(x):
    return torch.clamp(torch.tanh(x), min=0.0)


def logsoftmax(x, axis: int = -1):
    return torch.log_softmax(x, dim=axis)


def softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)), with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def softsign(x):
    return x / (torch.abs(x) + 1)


def cube(x):
    return x ** 3


def mish(x):
    return x * torch.tanh(softplus(x))


def thresholdedrelu(x, theta: float = 1.0):
    return torch.where(x > theta, x, torch.zeros_like(x))


def clippedrelu(x, max_value: float = 6.0):
    """ReLU capped at ``max_value`` (``relu6`` is the cap 6)."""
    return torch.clamp(x, 0.0, max_value)


_REGISTRY: Dict[str, Callable] = {
    "identity": identity,
    "linear": identity,
    "relu": relu,
    "relu6": relu6,
    "leakyrelu": leakyrelu,
    "elu": elu,
    "selu": selu,
    "celu": celu,
    "gelu": gelu,
    "gelu_tanh": gelu_tanh,
    "sigmoid": sigmoid,
    "hardsigmoid": hardsigmoid,
    "hardsigmoid_keras": hardsigmoid_keras,
    "tanh": tanh,
    "hardtanh": hardtanh,
    "rationaltanh": rationaltanh,
    "rectifiedtanh": rectifiedtanh,
    "softmax": softmax,
    "logsoftmax": logsoftmax,
    "softplus": softplus,
    "softsign": softsign,
    "cube": cube,
    "swish": swish,
    "silu": swish,
    "mish": mish,
    "thresholdedrelu": thresholdedrelu,
    "clippedrelu": clippedrelu,
}

#: the activations a ``name:param`` suffix parametrises
_PARAMETRIC = ("leakyrelu", "elu", "celu", "thresholdedrelu", "clippedrelu")


def get(name_or_fn) -> Callable:
    """Resolve an activation by reference enum name (case-insensitive);
    a callable is returned as it is. ``"leakyrelu:0.3"`` and the like
    set the parameter of an activation of :data:`_PARAMETRIC`."""
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if ":" in key:
        base, _, arg = key.partition(":")
        if base not in _PARAMETRIC:
            raise ValueError(f"activation {base!r} takes no parameter")
        fn, alpha = _REGISTRY[base], float(arg)
        return lambda x: fn(x, alpha)
    if key not in _REGISTRY:
        raise ValueError(f"Unknown activation {name_or_fn!r}; known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]


def names():
    return sorted(_REGISTRY)
