"""Loss functions (port of ``deeplearning4j_tpu/ops/losses.py``).

Every loss is ``fn(labels, preds, mask=None, weights=None) -> scalar``:
the mean over the batch of per-example sums (masked steps contribute 0),
the reference's ``BaseOutputLayer.computeScore`` semantics. The ported
slices carry ``sparse_mcxent`` (the causal LM's loss), ``mcxent`` with
its alias ``negativeloglikelihood`` (one-hot labels: BERT's classifier)
and ``mse`` with its alias ``l2`` (a regression output of a multi-output
graph under ``ParallelWrapper``); other names raise
``NotImplementedError`` until the slice that needs them.

``sparse_mcxent(..., from_logits=True)`` takes the logits in their own
dtype: the logsumexp runs in f32, but on row chunks, so a bfloat16
[B, T, V] logit cube never has an f32 twin in device memory — in the
forward or in the backward (:class:`_SparseXentFromLogits`), which the
JAX package gets from XLA's fusion.
"""
from __future__ import annotations

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
    raw = -labels * logp
    if weights is not None:
        raw = raw * torch.as_tensor(weights, dtype=raw.dtype,
                                    device=raw.device)
    return _mean(raw, mask)


negativeloglikelihood = mcxent


def mse(labels, preds, mask=None, weights=None):
    """Squared error, summed per example (reference LossMSE)."""
    raw = torch.square(preds - labels)
    if weights is not None:
        raw = raw * torch.as_tensor(weights, dtype=raw.dtype,
                                    device=raw.device)
    return _mean(raw, mask)


l2 = mse


def wants_f32_logits(fn, fused: bool) -> bool:
    """The single gate for the half-precision-training loss cast:
    losses that fold the upcast into their own reductions (marked
    ``handles_low_precision_logits``) take fused logits in the compute
    dtype directly; everything else (and every non-fused path) gets f32
    preds."""
    return not (fused and getattr(fn, "handles_low_precision_logits",
                                  False))


_REGISTRY: Dict[str, Callable] = {
    "sparse_mcxent": sparse_mcxent,
    "mcxent": mcxent,
    "negativeloglikelihood": negativeloglikelihood,
    "mse": mse,
    "l2": l2,
}


def get(name_or_fn) -> Callable:
    """Resolve a loss by name; a callable is returned as it is."""
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in _REGISTRY:
        raise NotImplementedError(
            f"loss {name_or_fn!r} is not ported yet (this slice has "
            f"{sorted(_REGISTRY)}; the rest come with the "
            "MultiLayerNetwork-core slice)")
    return _REGISTRY[key]
