"""Loss functions (port of ``deeplearning4j_tpu/ops/losses.py``).

Every loss is ``fn(labels, preds, mask=None, weights=None) -> scalar``:
the mean over the batch of per-example sums (masked steps contribute 0),
the reference's ``BaseOutputLayer.computeScore`` semantics. Every loss
of the JAX registry is here under its names, with its mask, weight and
clipping rules: the regression losses (``mse``/``l2``, ``mae``/``l1``,
``msle``, ``poisson``, ``cosine_proximity``, ``huber``, ``logcosh``),
the cross-entropies (``mcxent``/``negativeloglikelihood``,
``sparse_mcxent``, ``xent``/``binary_xent``/
``reconstruction_crossentropy`` with its stable logit form), ``hinge``,
``squared_hinge``, ``kl_divergence``/``kld``, ``wasserstein`` and the
F-beta surrogate ``fmeasure``. A ``name:param`` suffix sets ``huber``'s
δ and ``fmeasure``'s β; an unknown name raises ``ValueError``. The CTC
loss is not ported.

``sparse_mcxent(..., from_logits=True)`` takes the logits in their own
dtype: the logsumexp runs in f32, but on row chunks, so a bfloat16
[B, T, V] logit cube never has an f32 twin in device memory — in the
forward or in the backward (:class:`_SparseXentFromLogits`), which the
JAX package gets from XLA's fusion.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch

_EPS = 1e-7
#: f32 bytes of one row chunk of the from-logits cross-entropy
_CHUNK_BYTES = 1 << 28


def _per_example(raw, mask):
    """Reduce feature axes to per-example scores, applying a mask."""
    if mask is not None:
        m = mask.reshape(tuple(mask.shape) + (1,) * (raw.ndim - mask.ndim))
        raw = raw * m
    axes = tuple(range(1, raw.ndim))
    return raw.sum(dim=axes) if axes else raw


def _mean(raw, mask):
    """Mean over the batch of per-example (mask-weighted) summed scores:
    an all-ones mask equals no mask, and longer active sequences weigh
    more."""
    return _per_example(raw, mask).mean()


def _apply_weights(raw, weights):
    if weights is not None:
        raw = raw * torch.as_tensor(weights, dtype=raw.dtype,
                                    device=raw.device)
    return raw


def _chunks(rows: int, v: int):
    step = max(1, _CHUNK_BYTES // (4 * max(v, 1)))
    return [(i, min(i + step, rows)) for i in range(0, rows, step)]


class _SparseXentFromLogits(torch.autograd.Function):
    """Per-row ``logsumexp(logits) - logits[label]`` in f32 from logits
    [N, V] of any float dtype. The forward keeps the logits (in their
    own dtype) and the f32 row logsumexp; the backward writes
    ``(softmax - onehot) · g`` chunk by chunk, in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, labels):
        n, v = logits.shape
        lse = torch.empty((n,), dtype=torch.float32, device=logits.device)
        for a, b in _chunks(n, v):
            lse[a:b] = torch.logsumexp(logits[a:b].float(), dim=-1)
        picked = logits.gather(1, labels[:, None])[:, 0].float()
        ctx.save_for_backward(logits, labels, lse)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        n, v = logits.shape
        grad = torch.empty_like(logits)
        for a, b in _chunks(n, v):
            p = torch.exp(logits[a:b].float() - lse[a:b, None])
            p[torch.arange(b - a, device=p.device), labels[a:b]] -= 1.0
            grad[a:b] = (p * g[a:b, None].float()).to(logits.dtype)
        return grad, None


def sparse_mcxent(labels, preds, mask=None, weights=None,
                  from_logits=False):
    """Integer-label cross-entropy (reference LossSparseMCXENT). With
    ``from_logits`` the logsumexp is taken in f32 over the logits in
    their own dtype (bf16 logits stay bf16 in memory) and only the
    picked label logits are gathered."""
    lab = labels.long()
    if from_logits:
        v = preds.shape[-1]
        raw = _SparseXentFromLogits.apply(preds.reshape(-1, v),
                                          lab.reshape(-1))
        raw = raw.reshape(tuple(lab.shape) + (1,))
    else:
        logp = torch.log(torch.clamp(preds, _EPS, 1.0))
        raw = -torch.gather(logp, -1, lab[..., None])
    if weights is not None:
        w = torch.as_tensor(weights, dtype=raw.dtype, device=raw.device)
        raw = raw * w[lab][..., None]
    return _mean(raw, mask)


sparse_mcxent.handles_low_precision_logits = True


def mcxent(labels, preds, mask=None, weights=None, from_logits=False):
    """Multi-class cross-entropy over one-hot (or soft) labels (reference
    LossMCXENT): ``log_softmax`` of the logits with ``from_logits``, else
    the log of the probabilities clipped at 1e-7."""
    if from_logits:
        logp = torch.log_softmax(preds, dim=-1)
    else:
        logp = torch.log(torch.clamp(preds, _EPS, 1.0))
    return _mean(_apply_weights(-labels * logp, weights), mask)


negativeloglikelihood = mcxent


# -- regression ------------------------------------------------------------

def mse(labels, preds, mask=None, weights=None):
    """Squared error, summed per example (reference LossMSE)."""
    return _mean(_apply_weights(torch.square(preds - labels), weights),
                 mask)


def mae(labels, preds, mask=None, weights=None):
    return _mean(_apply_weights(torch.abs(preds - labels), weights), mask)


l2 = mse
l1 = mae


def msle(labels, preds, mask=None, weights=None):
    raw = torch.square(torch.log1p(torch.clamp(preds, min=-1 + _EPS))
                       - torch.log1p(torch.clamp(labels, min=-1 + _EPS)))
    return _mean(_apply_weights(raw, weights), mask)


def poisson(labels, preds, mask=None, weights=None):
    raw = preds - labels * torch.log(torch.clamp(preds, min=_EPS))
    return _mean(_apply_weights(raw, weights), mask)


def cosine_proximity(labels, preds, mask=None, weights=None):
    ln = labels / torch.clamp(torch.linalg.vector_norm(
        labels, dim=-1, keepdim=True), min=_EPS)
    pn = preds / torch.clamp(torch.linalg.vector_norm(
        preds, dim=-1, keepdim=True), min=_EPS)
    raw = -torch.sum(_apply_weights(ln * pn, weights), dim=-1,
                     keepdim=True)
    return _mean(raw, mask)


def huber(labels, preds, mask=None, weights=None, delta: float = 1.0):
    d = torch.abs(preds - labels)
    raw = torch.where(d <= delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return _mean(_apply_weights(raw, weights), mask)


def logcosh(labels, preds, mask=None, weights=None):
    d = preds - labels
    # log(cosh(d)) = d + softplus(-2d) - log 2, stable for large |d|
    sp = torch.logaddexp(-2.0 * d, torch.zeros_like(d))
    raw = d + sp - math.log(2.0)
    return _mean(_apply_weights(raw, weights), mask)


# -- classification --------------------------------------------------------

def binary_xent(labels, preds, mask=None, weights=None,
                from_logits=False):
    """Binary cross-entropy (reference LossBinaryXENT / XENT). From
    logits: max(x, 0) − x·z + log1p(exp(−|x|)), finite at any logit;
    else the probabilities clipped into [1e-7, 1 − 1e-7]."""
    if from_logits:
        x = preds
        raw = (torch.clamp(x, min=0) - x * labels
               + torch.log1p(torch.exp(-torch.abs(x))))
    else:
        p = torch.clamp(preds, _EPS, 1.0 - _EPS)
        raw = -(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p))
    return _mean(_apply_weights(raw, weights), mask)


def _signs(labels):
    """Labels in {−1, +1}, or {0, 1} taken as {−1, +1}."""
    return torch.where(labels > 0, 1.0, -1.0)


def hinge(labels, preds, mask=None, weights=None):
    raw = torch.clamp(1.0 - _signs(labels) * preds, min=0.0)
    return _mean(_apply_weights(raw, weights), mask)


def squared_hinge(labels, preds, mask=None, weights=None):
    raw = torch.square(torch.clamp(1.0 - _signs(labels) * preds, min=0.0))
    return _mean(_apply_weights(raw, weights), mask)


def kl_divergence(labels, preds, mask=None, weights=None):
    p = torch.clamp(labels, _EPS, 1.0)
    q = torch.clamp(preds, _EPS, 1.0)
    raw = p * (torch.log(p) - torch.log(q))
    return _mean(_apply_weights(raw, weights), mask)


def wasserstein(labels, preds, mask=None, weights=None):
    return _mean(_apply_weights(labels * preds, weights), mask)


def fmeasure(labels, preds, mask=None, weights=None, beta: float = 1.0):
    """1 − the differentiable F-beta of binary predictions (reference
    LossFMeasure): true and false positives and false negatives summed
    over the whole batch, each element weighted by ``weights`` and by
    its [B, T] ``mask`` row (the weights in the predictions' dtype)."""
    w = torch.ones_like(preds)
    if weights is not None:
        w = w * torch.as_tensor(weights, dtype=preds.dtype,
                                device=preds.device)
    if mask is not None:
        w = w * mask.reshape(tuple(mask.shape)
                             + (1,) * (preds.ndim - mask.ndim))
    tp = torch.sum(w * labels * preds)
    fp = torch.sum(w * (1 - labels) * preds)
    fn = torch.sum(w * labels * (1 - preds))
    b2 = beta * beta
    f = ((1 + b2) * tp) / torch.clamp((1 + b2) * tp + b2 * fn + fp,
                                      min=_EPS)
    return 1.0 - f


def wants_f32_logits(fn, fused: bool) -> bool:
    """The single gate for the half-precision-training loss cast:
    losses that fold the upcast into their own reductions (marked
    ``handles_low_precision_logits``) take fused logits in the compute
    dtype directly; everything else (and every non-fused path) gets f32
    preds."""
    return not (fused and getattr(fn, "handles_low_precision_logits",
                                  False))


_REGISTRY: Dict[str, Callable] = {
    "mse": mse,
    "l2": l2,
    "mae": mae,
    "l1": l1,
    "msle": msle,
    "mean_squared_logarithmic_error": msle,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "mcxent": mcxent,
    "negativeloglikelihood": negativeloglikelihood,
    "sparse_mcxent": sparse_mcxent,
    "xent": binary_xent,
    "binary_xent": binary_xent,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "kl_divergence": kl_divergence,
    "kld": kl_divergence,
    "huber": huber,
    "logcosh": logcosh,
    "reconstruction_crossentropy": binary_xent,
    "wasserstein": wasserstein,
    "fmeasure": fmeasure,
}


def get(name_or_fn) -> Callable:
    """Resolve a loss by name; a callable is returned as it is.
    ``"huber:2.0"`` sets δ, ``"fmeasure:2.0"`` β."""
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if ":" in key:
        base, _, arg = key.partition(":")
        val = float(arg)
        if base == "huber":
            return lambda l, p, mask=None, weights=None: \
                huber(l, p, mask, weights, delta=val)
        if base == "fmeasure":
            return lambda l, p, mask=None, weights=None: \
                fmeasure(l, p, mask, weights, beta=val)
        raise ValueError(f"loss {base!r} takes no parameter")
    if key not in _REGISTRY:
        raise ValueError(f"Unknown loss {name_or_fn!r}; known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]


def score_array(name_or_fn, labels, preds, mask=None, weights=None,
                **kw):
    """Per-example scores [B] (reference ILossFunction.computeScoreArray):
    the loss of each example alone, as the JAX package's vmap over the
    batch axis takes it."""
    fn = get(name_or_fn)
    return torch.stack([
        fn(labels[i:i + 1], preds[i:i + 1],
           None if mask is None else mask[i:i + 1], weights, **kw)
        for i in range(preds.shape[0])])


def names():
    return sorted(_REGISTRY)
