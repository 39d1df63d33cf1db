"""Gradient compression (port of
``deeplearning4j_tpu/parallel/compression.py``) — reference:
``org.deeplearning4j.optimize.solvers.accumulation
.EncodedGradientsAccumulator`` + libnd4j ops ``encode_threshold`` /
``decode_threshold`` / bitmap encode, ``ThresholdAlgorithm``
(AdaptiveThresholdAlgorithm), ``ResidualPostProcessor``.

Semantics (1-bit-style threshold compression):
  quantized  q = τ·sign(g)·1[|g|>τ]
  residual   r ← g − q   (kept locally, added to next step's gradient)

Where JAX takes ``axis_name`` inside ``shard_map``, each exchange here
takes the process group of that mesh axis (``mesh.group("data")``;
None: the default group) and runs in every rank of it. τ and the
residuals are device tensors: nothing in an exchange reads a value back
to the host. ``exchange_packed`` gathers the packed words of the CUDA
codec (``ops/cuda_kernels.py`` K10/K11: 16 two-bit codes per int32 word,
16× less wire than f32) and decodes every peer's words locally.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch import tree
from deeplearning4j_tpu_torch.obs import devtime
from deeplearning4j_tpu_torch.ops.cuda_kernels import (threshold_decode,
                                                       threshold_encode)
from deeplearning4j_tpu_torch.parallel.mesh import (all_gather,
                                                    all_reduce_sum)


def encode_threshold(grad, tau):
    """g → (ternary sign int8, residual). Reference op
    ``encode_threshold`` (sparse int-encoded update + residual)."""
    sign = torch.sign(grad) * (grad.abs() > tau)
    q = sign * tau
    return sign.to(torch.int8), grad - q


def decode_threshold(sign, tau, dtype=torch.float32):
    """Reference op ``decode_threshold``."""
    return sign.to(dtype) * tau


def encode_bitmap(sign):
    """Pack a ternary sign tensor into two uint8 bitmaps (pos, neg).

    Reference: libnd4j bitmap encoding path of the
    EncodedGradientsAccumulator. 8 elements per byte per bitmap → 16×
    compression over f32. Input is flattened; pad to a multiple of 8.
    """
    flat = sign.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % 8))
    bits = flat.reshape(-1, 8)
    weights = 2 ** torch.arange(8, dtype=torch.int32, device=sign.device)
    pos = ((bits > 0).to(torch.int32) * weights).sum(-1).to(torch.uint8)
    neg = ((bits < 0).to(torch.int32) * weights).sum(-1).to(torch.uint8)
    return pos, neg


def decode_bitmap(pos, neg, size: int, shape=None):
    """Unpack bitmaps back to a ternary sign tensor."""
    weights = (2 ** torch.arange(8, dtype=torch.int32,
                                 device=pos.device)).to(torch.uint8)
    p = ((pos[:, None] & weights) > 0).to(torch.int8).reshape(-1)
    n = ((neg[:, None] & weights) > 0).to(torch.int8).reshape(-1)
    sign = (p - n)[:size]
    return sign.reshape(shape) if shape is not None else sign


class AdaptiveThresholdAlgorithm:
    """Adapts τ toward a target update sparsity (reference
    AdaptiveThresholdAlgorithm: keeps encoded fraction near a target,
    decaying/boosting τ). τ is a 0-dim f32 device tensor, updated on the
    device."""

    def __init__(self, initial_threshold: float = 1e-3,
                 target_sparsity: float = 1e-2, decay: float = 1.05):
        self.initial = initial_threshold
        self.target = target_sparsity
        self.decay = decay

    def init_state(self, device=None):
        return torch.tensor(self.initial, dtype=torch.float32,
                            device=device)

    def update(self, tau, encoded_fraction):
        # too dense → raise τ; too sparse → lower τ
        return torch.where(encoded_fraction > self.target,
                           tau * self.decay, tau / self.decay)


def _like(reference, leaves):
    """A tree of ``reference``'s structure holding ``leaves`` in leaf
    order."""
    it = iter(leaves)
    return tree.map_(lambda _: next(it), reference)


def _device(params):
    return next(tree.leaves(params)).device


class EncodedGradientsAccumulator:
    """The reference accumulator for a data-parallel step: encode this
    rank's gradients, exchange the ternary updates over the group (where
    interconnect bandwidth is saved), keep the residuals on this rank.

    Reference flow (SURVEY §3.5): encode_threshold → IndexedTail fan-out
    to all replicas → decode+apply, residual += (grad − decoded). The
    fan-out queueing disappears: a sum of the decoded ternary values over
    the group has identical semantics, synchronously.
    """

    def __init__(self, threshold_algorithm=None, residual_clip: float = 5.0):
        self.algo = threshold_algorithm or AdaptiveThresholdAlgorithm()
        self.residual_clip = residual_clip

    def init_state(self, params):
        return {
            "residual": tree.map_(torch.zeros_like, params),
            "tau": self.algo.init_state(_device(params)),
        }

    def _clip(self, res, tau):
        """ResidualClippingPostProcessor: ±k·τ."""
        return torch.clamp(res, -self.residual_clip * tau,
                           self.residual_clip * tau)

    def _encode_leaves(self, grads, state):
        """Shared per-leaf encode loop: threshold-encode each gradient
        leaf against its residual, clip the residual, and account the
        encoded fraction for τ adaptation. Returns
        ``(signs, residuals, nnz, total)``, lists in leaf order."""
        tau = state["tau"]
        signs, residuals = [], []
        total = 0.0
        nnz = 0.0
        for g, r in zip(tree.leaves(grads), tree.leaves(state["residual"])):
            sign, res = encode_threshold(g + r, tau)
            signs.append(sign)
            residuals.append(self._clip(res, tau))
            total += float(math.prod(g.shape))
            nnz = nnz + torch.sum(sign.abs().to(torch.float32))
        return signs, residuals, nnz, total

    def exchange(self, grads, state, group=None):
        """In every rank of ``group``: returns (the group's mean of the
        decoded updates, new state)."""
        tau = state["tau"]
        signs, residuals, nnz, total = self._encode_leaves(grads, state)
        with devtime.scope("encoded.exchange"):
            n_dev = dist.get_world_size(group)
            decoded = [all_reduce_sum(decode_threshold(s, tau), group)
                       / n_dev for s in signs]
        new_state = {
            "residual": _like(grads, residuals),
            "tau": self.algo.update(tau, nnz / total),
        }
        return _like(grads, decoded), new_state

    def init_async_state(self, params):
        """State for ``exchange_async``: residuals + the in-flight
        decoded update each replica has broadcast but peers have not
        yet applied (one-step staleness)."""
        return {
            "residual": tree.map_(torch.zeros_like, params),
            "inflight": tree.map_(torch.zeros_like, params),
            "tau": self.algo.init_state(_device(params)),
        }

    def exchange_async(self, grads, state, group=None):
        """Async-flavor exchange (reference ``SharedTrainingMaster``'s
        asynchronous gradient passing): each replica applies its OWN
        decoded update at once, and its peers' with a staleness of one
        step — this step's sum delivers the messages encoded during the
        *previous* step (the ``inflight`` state), as the reference's
        IndexedTail queues do."""
        tau = state["tau"]
        signs, residuals, nnz, total = self._encode_leaves(grads, state)
        own = [decode_threshold(s, tau) for s in signs]
        with devtime.scope("encoded.exchange_async"):
            n_dev = dist.get_world_size(group)
            combined = [
                (o + all_reduce_sum(f.clone(), group) - f) / n_dev
                for o, f in zip(own, tree.leaves(state["inflight"]))]
        new_state = {
            "residual": _like(grads, residuals),
            "inflight": _like(grads, own),
            "tau": self.algo.update(tau, nnz / total),
        }
        return _like(grads, combined), new_state

    def exchange_packed(self, grads, state, group=None):
        """Compressed-wire variant: encode each leaf with K10
        (``threshold_encode``), ``all_gather`` the PACKED words (16× less
        traffic than gathering f32 gradients), then decode every peer's
        words with K11 (``threshold_decode``) and average. This is the
        reference's fan-out semantics made synchronous; meant for
        interconnect-constrained groups where a dense f32 sum is the
        bottleneck. Each rank decodes its peers' words with its OWN τ,
        as the JAX method does."""
        tau = state["tau"]
        with devtime.scope("encoded.exchange_packed"):
            n_dev = dist.get_world_size(group)
        decoded, residuals = [], []
        total = 0.0
        nnz = 0.0
        for g, r in zip(tree.leaves(grads), tree.leaves(state["residual"])):
            gi = g + r
            packed, res = threshold_encode(gi, tau)
            residuals.append(self._clip(res, tau))
            # adapt τ on the LOCAL encoded fraction (reference
            # ThresholdAlgorithm semantics)
            nnz = nnz + torch.sum((gi.abs() > tau).to(torch.float32))
            # the packed-word gather is the wire
            with devtime.scope("encoded.exchange_packed"):
                words = all_gather(packed, group)
            # decode peers one at a time into one sum (in place): extra
            # memory stays O(g.size), not O(N·g.size)
            dec_sum = threshold_decode(words[0], tau, g.numel(), g.shape)
            for w in words[1:]:
                dec_sum += threshold_decode(w, tau, g.numel(), g.shape)
            decoded.append(dec_sum / n_dev)
            total += float(math.prod(g.shape))
        new_state = {
            "residual": _like(grads, residuals),
            "tau": self.algo.update(tau, nnz / total),
        }
        return _like(grads, decoded), new_state

    def exchange_hierarchical(self, grads, state, intra_group=None,
                              cross_group=None):
        """Two-tier gradient sync: DENSE mean over ``intra_group`` (the
        well-connected ranks, where an f32 sum is cheap), then the
        THRESHOLD-ENCODED packed exchange over ``cross_group`` (2-bit
        codes, 16× less wire than f32).

        State is per cross-group member: after the intra mean every rank
        of an intra group holds the same gradients, so residuals and τ
        agree within it and differ across (as the reference's per-node
        accumulators do)."""
        with devtime.scope("encoded.exchange_hierarchical"):
            n = dist.get_world_size(intra_group)
            grads = tree.map_(
                lambda g: all_reduce_sum(g.contiguous().clone(),
                                         intra_group) / n, grads)
        return self.exchange_packed(grads, state, cross_group)
