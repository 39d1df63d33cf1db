"""Core layers (port of ``deeplearning4j_tpu/nn/layers/core.py``): the
dense, output and loss layers, the activation layer, standalone dropout, the
embeddings, batch normalisation, LayerNorm, RMSNorm and local response
normalisation.

``BatchNormalization`` is the first layer whose ``state`` changes in
training: ``apply(train=True)`` returns the new running statistics
(detached: they take no gradient), and the networks carry them from
step to step as the JAX networks carry theirs. Its arithmetic is the
JAX layer's, written in torch ops: the batch statistics in the promoted
dtype (f32 for a half-precision input), the one-pass variance
``E[x²] − E[x]²`` clamped at 0 for bf16 and f16 inputs and the shifted
two-pass variance otherwise, the *biased* variance in the running
update ``decay·old + (1 − decay)·batch``, and the output folded into
``x·a + b``. PyTorch's ``F.batch_norm`` keeps the unbiased variance in
its running statistics and picks its own variance formula, so it is not
used.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import weights as winit
from deeplearning4j_tpu_torch.nn.layers.base import (Layer, register_layer,
                                                     sharded_input)
from deeplearning4j_tpu_torch.ops import fused_norms

#: default RMSNorm epsilon — ``zoo/gpt.py``'s decode path uses the same
RMSNORM_EPS = fused_norms.RMSNORM_EPS


@register_layer
@dataclass
class DenseLayer(Layer):
    """Fully connected layer (reference DenseLayer)."""
    n_in: Optional[int] = None
    n_out: int = 0
    has_layer_norm: bool = False
    has_bias: bool = True
    #: acts on each row; its flatten of a [B, T, F] input reduces the
    #: sequence (under a sequence-parallel context the ranks' shards are
    #: gathered in global order first)
    mixes_positions = False
    pools_sequence = True

    def init(self, gen, input_shape, dtype=torch.float32):
        if self.has_layer_norm:
            raise NotImplementedError(
                "DenseLayer(has_layer_norm=True) comes with the "
                "encoder slice")
        n_in = self.n_in or int(math.prod(input_shape))
        params = {"W": winit.get(self.weight_init or "xavier")(
            gen, (n_in, self.n_out), dtype)}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init,
                                     dtype=dtype)
        return params, {}, (self.n_out,)

    @staticmethod
    def flat_input(x):
        """The [B, F] the weights take: a [B, T, …] input flattened, as
        the JAX ``reshape(B, -1)``. The rank's shard of a sequence
        (``parallel.mesh.sharded_input``) is gathered in global order
        first, so the flatten follows global positions in every mode."""
        sp = sharded_input() if x.ndim > 2 else None
        if sp is not None:
            ctx, mode = sp
            from deeplearning4j_tpu_torch.parallel.mesh import \
                gather_sequence
            x = gather_sequence(x, mode, ctx.group)
        return x.reshape(x.shape[0], -1) if x.ndim > 2 else x

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        z = self.flat_input(x) @ params["W"]
        if self.has_bias:
            z = z + params["b"]
        y = self._act()(z)
        return self._maybe_dropout(y, train, rng), state


@register_layer
@dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head (reference OutputLayer). ``loss`` names a
    function in ``ops.losses``; the network applies it in its train
    step, fused with the activation where it can (softmax + cross
    entropy from the logits)."""
    loss: str = "mcxent"


@register_layer
@dataclass
class LossLayer(Layer):
    """Loss-only layer, no parameters (reference LossLayer): applies its
    activation; the network applies ``loss`` to its output, unfused."""
    loss: str = "mse"
    mixes_positions = False

    def init(self, gen, input_shape, dtype=torch.float32):
        return {}, {}, tuple(input_shape)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return self._act()(x), state


@register_layer
@dataclass
class ActivationLayer(Layer):
    """Stateless activation (reference ActivationLayer)."""
    mixes_positions = False

    def init(self, gen, input_shape, dtype=torch.float32):
        return {}, {}, tuple(input_shape)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return self._act()(x), state


@register_layer
@dataclass
class DropoutLayer(Layer):
    """Standalone dropout (reference DropoutLayer). ``dropout`` is the
    drop probability (0.5 when unset); inverted dropout, scaled at train
    time."""
    mixes_positions = False

    def __post_init__(self):
        if self.dropout is None:
            self.dropout = 0.5

    def init(self, gen, input_shape, dtype=torch.float32):
        return {}, {}, tuple(input_shape)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return self._maybe_dropout(x, train, rng), state


@register_layer
@dataclass
class EmbeddingLayer(Layer):
    """Int index -> dense vector (reference EmbeddingLayer)."""
    n_in: Optional[int] = None     # vocab size
    n_out: int = 0
    has_bias: bool = False
    mixes_positions = False

    def init(self, gen, input_shape, dtype=torch.float32):
        params = {"W": winit.get(self.weight_init or "xavier")(
            gen, (self.n_in, self.n_out), dtype)}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init,
                                     dtype=dtype)
        return params, {}, (self.n_out,)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        idx = x.long()
        if idx.ndim == 2 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        y = params["W"][idx]
        if self.has_bias:
            y = y + params["b"]
        return self._act()(y), state


@register_layer
@dataclass
class EmbeddingSequenceLayer(EmbeddingLayer):
    """Sequence of indices [B, T] -> [B, T, F] (reference
    EmbeddingSequenceLayer)."""
    input_length: Optional[int] = None

    def init(self, gen, input_shape, dtype=torch.float32):
        params, state, _ = super().init(gen, input_shape, dtype)
        t = self.input_length or (input_shape[0] if input_shape else None)
        return params, state, (t, self.n_out)


@register_layer
@dataclass
class BatchNormalization(Layer):
    """Batch norm over the trailing feature/channel axis (reference
    BatchNormalization): parameters ``gamma``, ``beta`` (none with
    ``lock_gamma_beta``), running ``mean`` and ``var`` in ``state``.
    The statistics reduce over every axis but the last, so a [B, T, F]
    input under a sequence-parallel context would need every rank's
    share: the layer mixes positions.

    In training the statistics are means over the rows of the batch
    (``parallel.mesh.group_mean``): this rank's rows, or, under
    ``ParallelWrapper``'s SYNC step (``mesh.batch_statistics``), the rows
    of every rank of its data group, as the JAX SYNC step's one program
    over the global batch takes them. The JAX rules hold in both: bf16
    and f16 inputs in one pass (E[x²] − E[x]², the squares summed in f32,
    one reduction for both sums), full precision in the shifted two
    passes (the mean first, then the mean of the squared deviations from
    it), the variance biased (over the count of rows)."""
    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False

    def init(self, gen, input_shape, dtype=torch.float32):
        c = input_shape[-1]
        params = {} if self.lock_gamma_beta else {
            "gamma": torch.ones((c,), dtype=dtype),
            "beta": torch.zeros((c,), dtype=dtype)}
        state = {"mean": torch.zeros((c,), dtype=dtype),
                 "var": torch.ones((c,), dtype=dtype)}
        return params, state, tuple(input_shape)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        axes = tuple(range(x.ndim - 1))
        sdt = torch.promote_types(x.dtype, torch.float32)  # f64 stays f64
        if train:
            from deeplearning4j_tpu_torch.parallel.mesh import group_mean
            xf = x.to(sdt)
            rows = math.prod(x.shape[:-1])
            if x.dtype in (torch.bfloat16, torch.float16):
                # one pass: E[x²] − E[x]², the squares summed in f32
                mu, ex2 = group_mean(torch.stack(
                    [xf.sum(dim=axes), torch.square(xf).sum(dim=axes)]),
                    rows)
                var = torch.clamp_min(ex2 - torch.square(mu), 0.0)
            else:
                # full precision: the shifted two-pass variance
                mu = group_mean(xf.sum(dim=axes), rows)
                var = group_mean(torch.square(xf - mu).sum(dim=axes), rows)
            new_state = {
                "mean": (self.decay * state["mean"]
                         + (1 - self.decay) * mu.detach()),
                "var": (self.decay * state["var"]
                        + (1 - self.decay) * var.detach()),
            }
        else:
            mu = state["mean"].to(sdt)
            var = state["var"].to(sdt)
            new_state = state
        # y = a·x + b with per-channel a, b
        inv = torch.rsqrt(var + self.eps)
        if not self.lock_gamma_beta:
            inv = inv * params["gamma"].to(sdt)
            b = params["beta"].to(sdt) - mu * inv
        else:
            b = -mu * inv
        y = x * inv.to(x.dtype) + b.to(x.dtype)
        return self._act()(y), new_state


@register_layer
@dataclass
class LayerNormalization(Layer):
    """Layer norm over the trailing axis, through
    ``ops.fused_norms.layer_norm``: the kernels (forward K8 in Triton,
    backward K9 in CUDA) on the card, the plain versions on the CPU."""
    eps: float = fused_norms.LAYERNORM_EPS
    mixes_positions = False

    def init(self, gen, input_shape, dtype=torch.float32):
        c = input_shape[-1]
        return ({"gamma": torch.ones((c,), dtype=dtype),
                 "beta": torch.zeros((c,), dtype=dtype)}, {},
                tuple(input_shape))

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return fused_norms.layer_norm(x, params["gamma"], params["beta"],
                                      eps=self.eps), state


@register_layer
@dataclass
class RMSNorm(Layer):
    """Root-mean-square norm over the trailing axis (no mean
    subtraction, no bias), through ``ops.fused_norms.rms_norm``: the
    kernels (forward K2 in Triton, backward K6 in CUDA) on the card, the
    plain versions on the CPU."""
    eps: float = RMSNORM_EPS
    mixes_positions = False

    def init(self, gen, input_shape, dtype=torch.float32):
        c = input_shape[-1]
        return ({"gamma": torch.ones((c,), dtype=dtype)}, {},
                tuple(input_shape))

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return fused_norms.rms_norm(x, params["gamma"],
                                    eps=self.eps), state


@register_layer
@dataclass
class LocalResponseNormalization(Layer):
    """LRN across channels (reference LocalResponseNormalization, the
    AlexNet-era layer), channels-last: ``x / (k + α·Σ x²)^β`` over a
    window of ``n`` channels, the window sums taken as differences of a
    cumulative sum, as the JAX layer takes them."""
    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75
    mixes_positions = False

    def init(self, gen, input_shape, dtype=torch.float32):
        return {}, {}, tuple(input_shape)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        half = self.n // 2
        cs = torch.cumsum(F.pad(torch.square(x), (half, half)), dim=-1)
        cs = torch.cat([torch.zeros_like(cs[..., :1]), cs], dim=-1)
        win = cs[..., self.n:] - cs[..., :-self.n]
        return x / torch.pow(self.k + self.alpha * win, self.beta), state
