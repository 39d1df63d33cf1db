"""Parameter constraints and weight noise (port of
``deeplearning4j_tpu/nn/constraints.py``) — reference:
``org.deeplearning4j.nn.api.layers.LayerConstraint`` (MaxNormConstraint,
MinMaxNormConstraint, NonNegativeConstraint, UnitNormConstraint, applied
to a layer's parameters after each update) and
``org.deeplearning4j.nn.conf.weightnoise`` (WeightNoise, DropConnect:
the parameters the training forward sees are perturbed; the master
parameters are not).

Both are functions of one layer's parameter dict. The networks run the
constraints right after the update in every path that updates, and the
noise on the forward's view of the f32 masters before the compute-dtype
cast. By default both touch the weights only: a key named like a bias
or a norm's scale and shift (:data:`_NON_WEIGHT_KEYS`) is left alone
unless ``apply_to_bias``.

Noise is drawn from integer seeds (``rng.split_seed``), as
dropout is: the network splits a seed off the step's seed, one per layer
with noise, and the layer splits one per leaf it perturbs, in the
parameter dict's order. The draws differ from ``jax.random``'s, and a
card's generator from the CPU's; their distribution is the JAX
package's.

Each bean's JSON is the JAX package's (``"@class"`` and its fields), and
:func:`constraint_from_dict` / :func:`noise_from_dict` read it back.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from deeplearning4j_tpu_torch.rng import generator, split_seed

#: parameter keys that are not weights (a bias, a norm's scale and
#: shift, a recurrent bias, a peephole)
_NON_WEIGHT_KEYS = {"b", "bo", "beta", "gamma", "g", "rb", "P"}


def _is_weight(key: str) -> bool:
    return key not in _NON_WEIGHT_KEYS


def _map_weights(fn, params, apply_to_bias: bool = False):
    """``fn`` over every weight leaf of a nested parameter dict (every
    leaf with ``apply_to_bias``); the other leaves as they are."""
    if not isinstance(params, dict):
        return params
    return {k: (_map_weights(fn, v, apply_to_bias) if isinstance(v, dict)
                else (fn(v) if apply_to_bias or _is_weight(k) else v))
            for k, v in params.items()}


_CONSTRAINTS: Dict[str, type] = {}
_NOISES: Dict[str, type] = {}


def _register(cls):
    _CONSTRAINTS[cls.__name__] = cls
    return cls


def _register_noise(cls):
    _NOISES[cls.__name__] = cls
    return cls


def _bean(obj) -> Dict[str, Any]:
    return {"@class": type(obj).__name__, **obj.__dict__}


def constraint_from_dict(d: Dict[str, Any]) -> "BaseConstraint":
    d = dict(d)
    return _CONSTRAINTS[d.pop("@class")](**d)


def noise_from_dict(d: Dict[str, Any]) -> "BaseWeightNoise":
    d = dict(d)
    return _NOISES[d.pop("@class")](**d)


@dataclass
class BaseConstraint:
    apply_to_bias: bool = False

    def constrain(self, p: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, params):
        """The layer's parameter dict with every weight constrained."""
        return _map_weights(self.constrain, params, self.apply_to_bias)

    def to_dict(self):
        return _bean(self)

    from_dict = staticmethod(constraint_from_dict)


def _axis_norms(p: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """The norm of each output unit: over every axis but the last (over
    the one axis of a vector), plus ``eps``."""
    dims = tuple(range(p.ndim - 1)) if p.ndim > 1 else (0,)
    return torch.sqrt(torch.sum(torch.square(p), dim=dims,
                                keepdim=True)) + eps


@_register
@dataclass
class MaxNormConstraint(BaseConstraint):
    """Rescale the units whose norm exceeds ``max_norm`` (reference
    MaxNormConstraint)."""
    max_norm: float = 2.0

    def constrain(self, p):
        return p * torch.clamp(self.max_norm / _axis_norms(p), max=1.0)


@_register
@dataclass
class MinMaxNormConstraint(BaseConstraint):
    """Move each unit's norm into [``min_norm``, ``max_norm``] by
    ``rate`` (reference MinMaxNormConstraint)."""
    min_norm: float = 0.5
    max_norm: float = 2.0
    rate: float = 1.0

    def constrain(self, p):
        n = _axis_norms(p)
        clipped = torch.clamp(n, self.min_norm, self.max_norm)
        target = self.rate * clipped + (1.0 - self.rate) * n
        return p * (target / n)


@_register
@dataclass
class NonNegativeConstraint(BaseConstraint):
    """Clip the parameters at zero (reference NonNegativeConstraint)."""

    def constrain(self, p):
        return torch.clamp(p, min=0.0)


@_register
@dataclass
class UnitNormConstraint(BaseConstraint):
    """Rescale every unit to norm 1 (reference UnitNormConstraint)."""

    def constrain(self, p):
        return p / _axis_norms(p)


@dataclass
class BaseWeightNoise:
    apply_to_bias: bool = False

    def perturb(self, p: torch.Tensor, gen: torch.Generator):
        raise NotImplementedError

    def apply(self, params, seed: int):
        """The layer's parameter dict as the training forward sees it:
        each weight perturbed from its own seed, split off ``seed`` in
        the dict's order; differentiable in the parameters."""
        box = [seed]

        def one(p):
            box[0], sub = split_seed(box[0])
            gen = generator(p.device, sub)
            return self.perturb(p, gen)

        return _map_weights(one, params, self.apply_to_bias)

    def to_dict(self):
        return _bean(self)

    from_dict = staticmethod(noise_from_dict)


@_register_noise
@dataclass
class WeightNoise(BaseWeightNoise):
    """Gaussian noise on the weights in the training forward (reference
    WeightNoise): ``w + n`` (additive) or ``w · (1 + n)``, n ~
    N(``mean``, ``stddev``²)."""
    stddev: float = 0.01
    mean: float = 0.0
    additive: bool = True

    def perturb(self, p, gen):
        n = self.mean + self.stddev * torch.randn(
            p.shape, generator=gen, dtype=p.dtype, device=p.device)
        return p + n if self.additive else p * (1.0 + n)


@_register_noise
@dataclass
class DropConnect(BaseWeightNoise):
    """A Bernoulli mask on the weights in the training forward, kept
    ones scaled by 1 / ``weight_retain_prob`` (reference DropConnect)."""
    weight_retain_prob: float = 0.5

    def perturb(self, p, gen):
        keep = self.weight_retain_prob
        m = torch.rand(p.shape, generator=gen, device=p.device) < keep
        return torch.where(m, p / keep, torch.zeros_like(p)).to(p.dtype)
