"""Updaters (port of ``deeplearning4j_tpu/nn/updaters.py``).

The JAX package maps each updater bean to an optax transformation; the
port carries optax's update math, not ``torch.optim``'s (they differ in
where eps sits and how decay is applied):

- Adam: ``m = (1-b1)·g + b1·m``, ``v = (1-b2)·g² + b2·v``, bias
  correction ``1 - b^t`` in f32, ``u = m̂ / (sqrt(v̂) + eps)`` — eps
  outside the square root;
- AdamW: ``u + wd·p`` before the learning rate, so the decay applied is
  ``lr·wd·p``; ``exclude_bias_and_norm`` masks it by key name (keys
  starting with ``b``, and ``gamma``/``beta``, are not decayed);
- every update is then scaled by ``-lr`` and added to the parameter.

Parameters and optimizer state are nested dicts of tensors on the
parameters' device; an update returns new tensors (the JAX package's
functional update), so a reader holding the old tree never sees it
change. Learning-rate schedules and the other updaters come with later
slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from deeplearning4j_tpu_torch import tree


@dataclass
class Updater:
    learning_rate: float = 1e-3
    schedule: Optional[Any] = None

    def _check(self) -> None:
        if self.schedule is not None:
            raise NotImplementedError(
                "learning-rate schedules are not ported yet (they come "
                "with the MultiLayerNetwork-core slice)")

    def init_state(self, params) -> dict:
        self._check()
        return {}

    def update(self, grads, state: dict, params):
        """(updates, new state) for one step; ``params + updates`` is
        the new parameter tree."""
        raise NotImplementedError


@dataclass
class Sgd(Updater):
    def update(self, grads, state, params):
        lr = self.learning_rate
        return tree.map_(lambda g: g * -lr, grads), state


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """``1 - decay**count`` in f32 on the count's device, as optax
    computes it (no host round trip)."""
    return 1 - torch.pow(decay, count.float())


@dataclass
class Adam(Updater):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, params) -> dict:
        self._check()
        first = next(tree.leaves(params), None)
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=getattr(first, "device", None)),
                "mu": tree.map_(torch.zeros_like, params),
                "nu": tree.map_(torch.zeros_like, params)}

    def _decay(self, u, params):
        return u

    def update(self, grads, state, params):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        mu = tree.map_(lambda g, m: (1 - b1) * g + b1 * m, grads,
                       state["mu"])
        nu = tree.map_(lambda g, v: (1 - b2) * g ** 2 + b2 * v, grads,
                       state["nu"])
        count = state["count"] + 1
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        u = tree.map_(lambda m, v: (m / c1) / (torch.sqrt(v / c2) + eps),
                      mu, nu)
        u = self._decay(u, params)
        lr = self.learning_rate
        u = tree.map_(lambda x: x * -lr, u)
        return u, {"count": count, "mu": mu, "nu": nu}


@dataclass
class AdamW(Adam):
    weight_decay: float = 0.01
    # BERT-recipe decay masking: keys named like biases (b, bo, b1...)
    # or norm scales (gamma/beta) are excluded from decay
    exclude_bias_and_norm: bool = False

    def _decays(self, path) -> bool:
        key = path[-1]
        return not (self.exclude_bias_and_norm
                    and (key.startswith("b") or key in ("gamma", "beta")))

    def _decay(self, u, params):
        wd = self.weight_decay
        return tree.map_with_path(
            lambda path, x, p: x + wd * p if self._decays(path) else x,
            u, params)


def gradient_normalization(mode: Optional[str],
                           threshold: float = 1.0) -> Callable:
    """The reference's GradientNormalization modes as a function of one
    layer's gradient tree (the JAX package applies them per layer)."""
    if mode is None or mode == "None":
        return lambda g: g
    mode_l = str(mode).lower()

    def norm(x):
        return torch.sqrt(torch.sum(torch.square(x)) + 1e-12)

    def global_norm(g):
        return torch.sqrt(sum(torch.sum(torch.square(x))
                              for x in tree.leaves(g)))

    if mode_l == "clipelementwiseabsolutevalue":
        return lambda g: tree.map_(
            lambda x: torch.clamp(x, -threshold, threshold), g)
    if mode_l == "clipl2perlayer":
        return lambda g: tree.map_(
            lambda x: x * torch.clamp(threshold / norm(x), max=1.0), g)
    if mode_l == "clipl2perparamtype":
        def clip(g):
            n = global_norm(g)
            return tree.map_(lambda x: torch.where(
                n < threshold, x, (x / n.to(x.dtype)) * threshold), g)
        return clip
    if mode_l == "renormalizel2perlayer":
        return lambda g: tree.map_(lambda x: x / norm(x), g)
    if mode_l == "renormalizel2perparamtype":
        def renorm(g):
            n = global_norm(g)
            return tree.map_(lambda x: x / (n + 1e-12), g)
        return renorm
    raise ValueError(f"unknown gradient normalization {mode!r}")
