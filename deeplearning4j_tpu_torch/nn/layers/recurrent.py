"""Recurrent layers (port of ``deeplearning4j_tpu/nn/layers/recurrent.py``).

This slice carries the per-timestep output head the causal LM ends in,
:class:`RnnOutputLayer`, and the :class:`BaseRecurrentLayer` marker that
``MultiLayerNetwork`` tests for. The recurrent cells (LSTM, GravesLSTM,
SimpleRnn, bidirectional wrappers) come with the recurrent slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, OutputLayer


class BaseRecurrentLayer(Layer):
    """Common recurrent machinery: a recurrent layer returns (y[B,T,H],
    its final carries) so truncated BPTT can resume from them."""


@register_layer
@dataclass
class RnnOutputLayer(OutputLayer):
    """Per-timestep dense + loss head over [B, T, F] (reference
    RnnOutputLayer)."""

    def init(self, gen, input_shape, dtype=torch.float32):
        n_in = self.n_in or input_shape[-1]
        params, state, _ = DenseLayer.init(self, gen, (n_in,), dtype)
        t = input_shape[0] if len(input_shape) == 2 else None
        return params, state, (t, self.n_out)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        z = x @ params["W"]
        if self.has_bias:
            z = z + params["b"]
        return self._act()(z), state
