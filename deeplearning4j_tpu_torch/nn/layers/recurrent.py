"""Recurrent layers (port of ``deeplearning4j_tpu/nn/layers/recurrent.py``).

The port carries the per-timestep output head, :class:`RnnOutputLayer`
— the causal LM's head in a ``MultiLayerNetwork`` and BERT's masked-LM
head in a ``ComputationGraph``, both applying it per time step over
[B, T, F] — and the :class:`BaseRecurrentLayer` marker that the
networks test for. The recurrent cells (LSTM, GravesLSTM, SimpleRnn,
bidirectional wrappers) come with ROADMAP item A11.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, OutputLayer


class BaseRecurrentLayer(Layer):
    """Common recurrent machinery: a recurrent layer returns (y[B,T,H],
    its final carries) so truncated BPTT can resume from them."""
    #: scans the sequence
    mixes_positions = "ROADMAP item A11"


@register_layer
@dataclass
class RnnOutputLayer(OutputLayer):
    """Per-timestep dense + loss head over [B, T, F] (reference
    RnnOutputLayer)."""
    mixes_positions = False

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
