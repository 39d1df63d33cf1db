"""Updaters and learning-rate schedules (port of
``deeplearning4j_tpu/nn/updaters.py``).

The JAX package maps each updater bean to an optax transformation; the
port carries optax 0.2.6's update math, not ``torch.optim``'s (they
differ in where eps sits and how decay is applied). An update is the
optax chain ``direction → [decay] → scale by -learning rate``:

- Sgd: the gradient;
- Momentum / Nesterovs: ``trace = g + m·trace``; the direction is
  ``trace``, or ``g + m·trace`` for Nesterov;
- Adam: ``m = (1-b1)·g + b1·m``, ``v = (1-b2)·g² + b2·v``, bias
  correction ``1 - b^t`` in f32, ``u = m̂ / (sqrt(v̂) + eps)`` — eps
  outside the square root; Nadam takes
  ``m̂ = b1·m/(1-b1^(t+1)) + (1-b1)·g/(1-b1^t)``; AMSGrad divides by
  ``sqrt(max over steps of v̂)``; AdaMax keeps ``v = max(|g| + eps,
  b2·v)`` and takes ``m̂ / v``;
- AdamW: ``u + wd·p`` before the learning rate, so the decay applied is
  ``lr·wd·p``; ``exclude_bias_and_norm`` masks it by key name (keys
  starting with ``b``, and ``gamma``/``beta``, are not decayed);
- RmsProp: ``v = decay·v + (1-decay)·g²`` from 0, ``g / sqrt(v + eps)``
  — eps inside the root;
- AdaGrad: ``s = s + g²`` from 0.1, ``g·rsqrt(s + eps)`` where ``s > 0``;
- AdaDelta: the JAX bean passes ``learning_rate=1.0``, so it ignores
  its learning rate and any schedule;
- NoOp: zeros.

A schedule is evaluated on the device from its own int32 counter
(``schedule_count`` in the state, optax's ``ScaleByScheduleState``), in
f32 as jnp computes it: update ``t`` (from 0) scales by ``schedule(t)``
and then counts. No step of an update reads a value back to the host,
so a run of updates queues on the card without a wait.

Parameters and optimizer state are nested dicts of tensors on the
parameters' device; an update returns new tensors (the JAX package's
functional update), so a reader holding the old tree never sees it
change.

The networks build one :class:`GroupChain` per parameter group (a layer,
or a graph node), the JAX networks' per-group optax chain under
``multi_transform``: nothing for a frozen group (optax's
``set_to_zero``, which keeps no state), else the gradient normalisation,
``add_decayed_weights`` where the layer has a ``weight_decay``, and the
group's own updater (:func:`layer_updater`: the layer's, or a copy of
the global one at the layer's learning rate, or the global one).
"""
from __future__ import annotations

import copy
import dataclasses as dc
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from deeplearning4j_tpu_torch import tree

_UPDATER_REGISTRY: Dict[str, type] = {}
_SCHEDULE_REGISTRY: Dict[str, type] = {}


def register_updater(cls):
    _UPDATER_REGISTRY[cls.__name__] = cls
    return cls


def register_schedule(cls):
    _SCHEDULE_REGISTRY[cls.__name__] = cls
    return cls


def updater_from_dict(d):
    if isinstance(d, Updater):
        return d
    d = dict(d)
    cls = _UPDATER_REGISTRY[d.pop("@class")]
    if "schedule" in d and isinstance(d["schedule"], dict):
        d["schedule"] = schedule_from_dict(d["schedule"])
    return cls(**d)


def schedule_from_dict(d):
    d = dict(d)
    cls = _SCHEDULE_REGISTRY[d.pop("@class")]
    if isinstance(d.get("base"), dict) and "@class" in d["base"]:
        d["base"] = schedule_from_dict(d["base"])   # nested warmup base
    return cls(**d)


# ---------------------------------------------------------------------------
# Schedules — reference org.nd4j.linalg.schedule.*
# ---------------------------------------------------------------------------

def _count(step) -> torch.Tensor:
    """``step`` as an int32 tensor (a Python int goes to the CPU)."""
    if isinstance(step, torch.Tensor):
        return step
    return torch.tensor(int(step), dtype=torch.int32)


def _f32(step: torch.Tensor) -> torch.Tensor:
    return step.to(torch.float32)


def _c(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as an f32 scalar on ``like``'s device, for a division:
    a CUDA tensor divided by a Python number is multiplied by its
    reciprocal, where jnp divides."""
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def _div(step: torch.Tensor, n) -> torch.Tensor:
    """jnp's ``int32 / int``: both converted to f32, then divided."""
    return _f32(step) / _c(n, step)


@dataclass
class Schedule:
    """A learning rate as a function of the update count: called with an
    int32 count tensor (or a Python int), returns an f32 scalar tensor
    on the count's device."""

    def __call__(self, step) -> torch.Tensor:
        raise NotImplementedError

    def to_dict(self):
        out = {"@class": type(self).__name__}
        out.update(dc.asdict(self))
        return out


@register_schedule
@dataclass
class FixedSchedule(Schedule):
    value: float = 1e-3

    def __call__(self, step):
        return _c(self.value, _count(step))


@register_schedule
@dataclass
class StepSchedule(Schedule):
    """lr * decay^floor(step / interval) (reference StepSchedule)."""
    initial: float = 1e-3
    decay_rate: float = 0.5
    step: int = 1000

    def __call__(self, step):
        t = _count(step)
        return self.initial * torch.pow(
            _c(self.decay_rate, t), torch.floor(_div(t, self.step)))


@register_schedule
@dataclass
class ExponentialSchedule(Schedule):
    initial: float = 1e-3
    gamma: float = 0.99

    def __call__(self, step):
        t = _count(step)
        return self.initial * torch.pow(_c(self.gamma, t), _f32(t))


@register_schedule
@dataclass
class InverseSchedule(Schedule):
    initial: float = 1e-3
    gamma: float = 0.99
    power: float = 1.0

    def __call__(self, step):
        t = _count(step)
        return _c(self.initial, t) / torch.pow(
            1 + self.gamma * _f32(t), _c(self.power, t))


@register_schedule
@dataclass
class PolySchedule(Schedule):
    initial: float = 1e-3
    power: float = 2.0
    max_iter: int = 10000

    def __call__(self, step):
        t = _count(step)
        frac = torch.clamp(_div(t, self.max_iter), 0.0, 1.0)
        return self.initial * torch.pow(1 - frac, _c(self.power, t))


@register_schedule
@dataclass
class SigmoidSchedule(Schedule):
    initial: float = 1e-3
    gamma: float = 0.01
    step_center: int = 1000

    def __call__(self, step):
        t = _count(step)
        return _c(self.initial, t) / (1 + torch.exp(
            self.gamma * _f32(t - self.step_center)))


@register_schedule
@dataclass
class CosineSchedule(Schedule):
    """Cosine decay (modern addition; reference has CycleSchedule)."""
    initial: float = 1e-3
    max_iter: int = 10000
    final_fraction: float = 0.0

    def __call__(self, step):
        t = _count(step)
        frac = torch.clamp(_div(t, self.max_iter), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return self.initial * (self.final_fraction
                               + (1 - self.final_fraction) * cos)


@register_schedule
@dataclass
class WarmupSchedule(Schedule):
    """Linear warmup into another schedule (transformer-era addition):
    ``base(t) · min(1, (t + 1) / warmup_steps)``. ``base``: a constant
    rate or any Schedule; defaults to 1e-3."""
    warmup_steps: int = 1000
    base: Any = 1e-3

    def __call__(self, step):
        t = _count(step)
        base = self.base(t) if callable(self.base) else float(self.base)
        return base * torch.clamp(_div(t + 1, self.warmup_steps), max=1.0)

    def to_dict(self):
        d = super().to_dict()
        if isinstance(self.base, Schedule):
            d["base"] = self.base.to_dict()
        return d


# ---------------------------------------------------------------------------
# Updater beans
# ---------------------------------------------------------------------------

def _zero_count(params) -> torch.Tensor:
    first = next(tree.leaves(params), None)
    return torch.zeros((), dtype=torch.int32,
                       device=getattr(first, "device", None))


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """``1 - decay**count`` in f32 on the count's device, as optax
    computes it (no host round trip)."""
    return 1 - torch.pow(decay, count.float())


@dataclass
class Updater:
    learning_rate: float = 1e-3
    schedule: Optional[Schedule] = None

    #: the learning rate the update is scaled by, when the bean fixes it
    #: (AdaDelta); None: ``learning_rate``, or the schedule
    _fixed_lr = None
    #: the optax state type that holds the direction's moments (read by
    #: ``MultiLayerNetwork.opt_state_from_jax``)
    optax_state = None
    #: the stages of the optax chain the JAX bean's ``to_optax`` builds,
    #: in order: ``"moments"`` holds the state of ``optax_state``,
    #: ``"lr"`` is ``scale_by_learning_rate`` (a ``ScaleByScheduleState``
    #: count under a schedule), any other name a stage without state.
    #: ``serialization.py`` places the state's leaves in a zip's
    #: ``updater.npz`` by their stage's position here.
    optax_chain = ("moments", "lr")

    def init_state(self, params) -> dict:
        """The optimizer state of one parameter group: the direction's
        moments, and ``schedule_count`` under a schedule."""
        state = self._init(params)
        if self.schedule is not None and self._fixed_lr is None:
            state["schedule_count"] = _zero_count(params)
        return state

    def _init(self, params) -> dict:
        return {}

    def _direction(self, grads, state, params):
        """(direction, new moment state): the optax chain before the
        learning rate."""
        return grads, {}

    def update(self, grads, state: dict, params):
        """(updates, new state) for one step; ``params + updates`` is
        the new parameter tree."""
        u, new = self._direction(grads, state, params)
        if self.schedule is not None and self._fixed_lr is None:
            count = state["schedule_count"]
            step = -self.schedule(count)
            u = tree.map_(lambda x: step.to(x.dtype) * x, u)
            new["schedule_count"] = count + 1
        else:
            lr = (self.learning_rate if self._fixed_lr is None
                  else self._fixed_lr)
            u = tree.map_(lambda x: x * -lr, u)
        return u, new

    def to_dict(self):
        out = {"@class": type(self).__name__}
        for f in dc.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Schedule):
                v = v.to_dict()
            out[f.name] = v
        return out


@register_updater
@dataclass
class Sgd(Updater):
    # optax.sgd without momentum: identity, then the learning rate
    optax_chain = ("identity", "lr")


@register_updater
@dataclass
class Adam(Updater):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    optax_state = "ScaleByAdamState"

    def _init(self, params) -> dict:
        return {"count": _zero_count(params),
                "mu": tree.map_(torch.zeros_like, params),
                "nu": tree.map_(torch.zeros_like, params)}

    def _moments(self, grads, state):
        b1, b2 = self.beta1, self.beta2
        mu = tree.map_(lambda g, m: (1 - b1) * g + b1 * m, grads,
                       state["mu"])
        nu = tree.map_(lambda g, v: (1 - b2) * g ** 2 + b2 * v, grads,
                       state["nu"])
        return mu, nu, state["count"] + 1

    def _mu_hat(self, mu, grads, count):
        c1 = _bias_correction(self.beta1, count)
        return tree.map_(lambda m: m / c1, mu)

    def _decay(self, u, params):
        return u

    def _direction(self, grads, state, params):
        eps = self.epsilon
        mu, nu, count = self._moments(grads, state)
        c2 = _bias_correction(self.beta2, count)
        u = tree.map_(lambda m, v: m / (torch.sqrt(v / c2) + eps),
                      self._mu_hat(mu, grads, count), nu)
        return self._decay(u, params), {"count": count, "mu": mu,
                                        "nu": nu}


@register_updater
@dataclass
class AdamW(Adam):
    weight_decay: float = 0.01
    # BERT-recipe decay masking: keys named like biases (b, bo, b1...)
    # or norm scales (gamma/beta) are excluded from decay
    exclude_bias_and_norm: bool = False
    optax_chain = ("moments", "add_decayed_weights", "lr")

    def _decays(self, path) -> bool:
        key = path[-1]
        return not (self.exclude_bias_and_norm
                    and (key.startswith("b") or key in ("gamma", "beta")))

    def _decay(self, u, params):
        wd = self.weight_decay
        return tree.map_with_path(
            lambda path, x, p: x + wd * p if self._decays(path) else x,
            u, params)


@register_updater
@dataclass
class Nadam(Adam):
    def _mu_hat(self, mu, grads, count):
        b1 = self.beta1
        c_next = _bias_correction(b1, count + 1)
        c1 = _bias_correction(b1, count)
        return tree.map_(lambda m, g: b1 * (m / c_next)
                         + (1 - b1) * (g / c1), mu, grads)


@register_updater
@dataclass
class AMSGrad(Adam):
    optax_state = "ScaleByAmsgradState"

    def _init(self, params) -> dict:
        state = super()._init(params)
        state["nu_max"] = tree.map_(torch.zeros_like, params)
        return state

    def _direction(self, grads, state, params):
        eps = self.epsilon
        mu, nu, count = self._moments(grads, state)
        c2 = _bias_correction(self.beta2, count)
        nu_max = tree.map_(lambda v, vm: torch.maximum(vm, v / c2), nu,
                           state["nu_max"])
        u = tree.map_(lambda m, vm: m / (torch.sqrt(vm) + eps),
                      self._mu_hat(mu, grads, count), nu_max)
        return u, {"count": count, "mu": mu, "nu": nu, "nu_max": nu_max}


@register_updater
@dataclass
class AdaMax(Adam):
    def _direction(self, grads, state, params):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        count = state["count"] + 1
        mu = tree.map_(lambda g, m: (1 - b1) * g + b1 * m, grads,
                       state["mu"])
        nu = tree.map_(lambda g, v: torch.maximum(torch.abs(g) + eps,
                                                  b2 * v),
                       grads, state["nu"])
        u = tree.map_(lambda m, v: m / v, self._mu_hat(mu, grads, count),
                      nu)
        return u, {"count": count, "mu": mu, "nu": nu}


@register_updater
@dataclass
class Nesterovs(Updater):
    momentum: float = 0.9
    _nesterov = True
    optax_state = "TraceState"

    def _init(self, params) -> dict:
        return {"trace": tree.map_(torch.zeros_like, params)}

    def _direction(self, grads, state, params):
        m = self.momentum
        new = tree.map_(lambda g, t: g + m * t, grads, state["trace"])
        u = (tree.map_(lambda g, t: g + m * t, grads, new)
             if self._nesterov else new)
        return u, {"trace": new}


@register_updater
@dataclass
class Momentum(Nesterovs):
    _nesterov = False


@register_updater
@dataclass
class RmsProp(Updater):
    decay: float = 0.95
    epsilon: float = 1e-8
    optax_state = "ScaleByRmsState"

    def _init(self, params) -> dict:
        return {"nu": tree.map_(torch.zeros_like, params)}

    def _direction(self, grads, state, params):
        d, eps = self.decay, self.epsilon
        nu = tree.map_(lambda g, v: (1 - d) * g ** 2 + d * v, grads,
                       state["nu"])
        u = tree.map_(lambda v, g: torch.rsqrt(v + eps) * g, nu, grads)
        return u, {"nu": nu}


@register_updater
@dataclass
class AdaGrad(Updater):
    epsilon: float = 1e-6
    #: optax.adagrad's initial accumulator
    _initial_accumulator = 0.1
    optax_state = "ScaleByRssState"

    def _init(self, params) -> dict:
        a = self._initial_accumulator
        return {"sum_of_squares": tree.map_(
            lambda p: torch.full_like(p, a), params)}

    def _direction(self, grads, state, params):
        eps = self.epsilon
        s = tree.map_(lambda g, t: g * g + t, grads,
                      state["sum_of_squares"])
        u = tree.map_(lambda t, g: torch.where(
            t > 0, torch.rsqrt(t + eps), 0.0) * g, s, grads)
        return u, {"sum_of_squares": s}


@register_updater
@dataclass
class AdaDelta(Updater):
    rho: float = 0.95
    epsilon: float = 1e-6
    _fixed_lr = 1.0
    optax_state = "ScaleByAdaDeltaState"
    optax_chain = ("add_decayed_weights", "moments", "lr")

    def _init(self, params) -> dict:
        return {"e_g": tree.map_(torch.zeros_like, params),
                "e_x": tree.map_(torch.zeros_like, params)}

    def _direction(self, grads, state, params):
        rho, eps = self.rho, self.epsilon
        # optax.adadelta's add_decayed_weights(0.0) ahead of the rule
        grads = tree.map_(lambda g, p: g + 0.0 * p, grads, params)
        e_g = tree.map_(lambda g, t: (1 - rho) * g ** 2 + rho * t, grads,
                        state["e_g"])
        u = tree.map_(lambda g, eg, ex: torch.sqrt(ex + eps)
                      / torch.sqrt(eg + eps) * g,
                      grads, e_g, state["e_x"])
        e_x = tree.map_(lambda x, t: (1 - rho) * x ** 2 + rho * t, u,
                        state["e_x"])
        return u, {"e_g": e_g, "e_x": e_x}


@register_updater
@dataclass
class NoOp(Updater):
    optax_chain = ("set_to_zero",)

    def init_state(self, params) -> dict:
        return {}

    def update(self, grads, state, params):
        return tree.map_(torch.zeros_like, grads), {}


def layer_updater(layer, updater: Updater) -> Updater:
    """The updater of ``layer``'s group (the JAX ``_layer_updater``,
    ``deeplearning4j_tpu/nn/multilayer.py:130-137``): the layer's own;
    else, with a per-layer ``learning_rate``, a deep copy of ``updater``
    at that rate with its schedule dropped (the rate replaces a global
    schedule for that layer); else ``updater``."""
    u = layer.updater
    if u is None and layer.learning_rate is not None:
        u = copy.deepcopy(updater)
        u.learning_rate = layer.learning_rate
        u.schedule = None
    return u or updater


@dataclass
class GroupChain:
    """The optax chain of one parameter group: ``updater`` None for a
    frozen group (no update, no state), else ``grad_norm`` (one group's
    gradient normalisation), then ``add_decayed_weights(weight_decay)``
    when it is set, then ``updater``; after the update, the constraints
    of the group's ``layer``, read when they run, as the JAX
    ``_apply_constraints`` reads them."""
    updater: Optional[Updater]
    grad_norm: Callable
    weight_decay: Optional[float] = None
    layer: Any = dc.field(default=None, repr=False, compare=False)

    @property
    def frozen(self) -> bool:
        return self.updater is None

    def init_state(self, params) -> dict:
        """The group's optimizer state: empty for a frozen group."""
        return {} if self.frozen else self.updater.init_state(params)

    def constrain(self, params):
        """``params`` with the layer's constraints applied in turn."""
        for c in getattr(self.layer, "constraints", None) or ():
            params = c.apply(params)
        return params

    def update(self, grads, state: dict, params):
        """(updates, new state) of a group that is not frozen."""
        g = self.grad_norm(grads)
        wd = self.weight_decay
        if wd:
            # optax.add_decayed_weights: g + wd · p
            g = tree.map_(lambda x, p: x + wd * p, g, params)
        return self.updater.update(g, state, params)


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
