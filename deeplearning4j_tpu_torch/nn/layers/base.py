"""Layer base class and registry (port of
``deeplearning4j_tpu/nn/layers/base.py``).

One dataclass per layer holds its configuration, infers shapes
(``init``) and applies itself to a parameter dict (``apply``), as in the
JAX package. Randomness is explicit: ``init`` draws from a CPU
``torch.Generator``, and a training forward hands each layer an integer
seed (the counterpart of a ``jax.random`` key; :func:`split_seed` splits
it) from which dropout builds its own generator — so recomputing a
block (``remat``) draws the same mask. The seed arithmetic and the
draws' generators live in ``deeplearning4j_tpu_torch/rng.py``.

``Layer.to_dict`` and :func:`layer_from_dict` are the JAX package's
JSON beans: a layer's dict names its class under ``"@class"`` and holds
every dataclass field, so a configuration written by either package
parses in the other.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from deeplearning4j_tpu_torch.ops import activations
from deeplearning4j_tpu_torch.rng import (  # noqa: F401 (re-exported)
    fold_in, generator, split_seed)

_LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(cls):
    """Class decorator adding the layer to the registry."""
    _LAYER_REGISTRY[cls.__name__] = cls
    return cls


def layer_from_dict(d: Dict[str, Any]) -> "Layer":
    """The layer a ``Layer.to_dict`` dict describes, nested beans rebuilt
    as the JAX ``layer_from_dict`` rebuilds them: a wrapped layer, a
    per-layer updater, parameter constraints and weight noise
    (``nn/constraints.py``). Raises ``ValueError`` for a class the port
    does not register."""
    from deeplearning4j_tpu_torch.nn import constraints as cmod
    d = dict(d)
    kind = d.pop("@class")
    if kind not in _LAYER_REGISTRY:
        raise ValueError(f"Unknown layer class {kind!r}")
    cls = _LAYER_REGISTRY[kind]
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in names:
            continue
        if k == "updater" and isinstance(v, dict):
            from deeplearning4j_tpu_torch.nn.updaters import \
                updater_from_dict
            v = updater_from_dict(v)
        elif k == "constraints" and isinstance(v, list):
            v = [cmod.constraint_from_dict(c) if isinstance(c, dict)
                 else c for c in v]
        elif isinstance(v, dict) and "@class" in v:
            v = (cmod.constraint_from_dict(v)
                 if v["@class"] in cmod._CONSTRAINTS
                 else cmod.noise_from_dict(v) if v["@class"] in cmod._NOISES
                 else layer_from_dict(v))
        kwargs[k] = v
    return cls(**kwargs)


def sharded_input():
    """``(context, mode)`` while a sequence-parallel network feeds the
    calling layer the rank's shard of the sequence, else None
    (``parallel.mesh.sharded_input``, imported at the call: ``parallel``
    imports the networks)."""
    from deeplearning4j_tpu_torch.parallel.mesh import sharded_input as s
    return s()


@dataclass
class Layer:
    """Base config bean + runtime for all layers.

    Subclasses implement:
      init(gen, input_shape, dtype) -> (params, state, output_shape)
      apply(params, state, x, *, train, rng, mask) -> (y, new_state)

    ``input_shape``/``output_shape`` exclude the batch dimension;
    ``params`` are trainable tensors, ``state`` non-trainable ones;
    ``rng`` is an integer seed or None; ``mask`` is [B, T] for sequence
    data.
    """
    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    bias_init: float = 0.0
    l1: Optional[float] = None
    l2: Optional[float] = None
    weight_decay: Optional[float] = None
    dropout: Optional[float] = None          # drop rate
    updater: Optional[Any] = None            # per-layer updater override
    learning_rate: Optional[float] = None    # per-layer LR override
    trainable: bool = True
    constraints: Optional[list] = None       # post-update constraints
    weight_noise: Optional[Any] = None       # train-time weight noise

    #: whether an output position depends on other positions (attention,
    #: pooling, a scan). Under a sequence-parallel context a rank holds
    #: only its shard of the sequence (``parallel/mesh.py``), so a
    #: network refuses such a layer unless it has a ``sequence_parallel``
    #: mode; a string names the ROADMAP item that brings it there.
    #: False on the layers that act on each position alone.
    mixes_positions = True
    #: whether the layer reduces the sequence axis (pooling, the CLS
    #: token, learned queries, a dense layer's flatten). Under a
    #: sequence-parallel context such a layer runs on the rank's shard
    #: and combines the ranks' partials over the group, and the layers
    #: after it see the same whole [B, …] on every rank: the replicated
    #: tail of ``parallel/mesh.py``'s rule.
    pools_sequence = False

    def to_dict(self) -> Dict[str, Any]:
        """The JSON bean: ``"@class"`` and every dataclass field, nested
        beans (a layer, an updater, a schedule) as their own dicts."""
        out = {"@class": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, list):
                v = [e.to_dict() if hasattr(e, "to_dict") else e
                     for e in v]
            elif hasattr(v, "to_dict") and not isinstance(v, type):
                v = v.to_dict()
            out[f.name] = v
        return out

    def init(self, gen, input_shape, dtype=torch.float32):
        raise NotImplementedError

    def apply(self, params, state, x, *, train: bool = False, rng=None,
              mask=None):
        raise NotImplementedError

    def propagate_mask(self, mask, input_shape):
        """Transform an incoming [B, T] mask for downstream layers
        (default: unchanged)."""
        return mask

    def _act(self, default="identity"):
        return activations.get(self.activation or default)

    def _maybe_dropout(self, x, train, rng):
        if not train or not self.dropout or self.dropout <= 0.0:
            return x
        if rng is None:
            raise ValueError(
                f"Layer {self.name or type(self).__name__} has dropout "
                "but no rng was supplied to apply()")
        keep = 1.0 - self.dropout
        gen = generator(x.device, rng)
        m = torch.rand(x.shape, generator=gen, device=x.device) < keep
        return torch.where(m, x / keep, torch.zeros_like(x)).to(x.dtype)
