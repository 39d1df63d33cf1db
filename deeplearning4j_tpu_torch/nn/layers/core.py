"""Core layers (port of ``deeplearning4j_tpu/nn/layers/core.py``): the
dense and output layers, standalone dropout, the embeddings, LayerNorm
and RMSNorm. BatchNorm and the other feed-forward layers come with the
MultiLayerNetwork-core slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn import weights as winit
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
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
    #: flattens a [B, T, F] input: under a sequence-parallel context the
    #: pooling layer ahead of it comes with GlobalPoolingLayer and conv.py
    mixes_positions = "ROADMAP item A10"

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

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        if x.ndim > 2:
            x = x.reshape(x.shape[0], -1)
        z = x @ params["W"]
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
