"""FrozenLayer (port of ``FrozenLayer`` in
``deeplearning4j_tpu/nn/layers/special.py``; reference
``org.deeplearning4j.nn.layers.FrozenLayer``): a wrapper whose
underlying layer runs in inference mode (dropout off, a batch norm's
running statistics) and whose parameters the networks never update —
they take no gradient and keep no optimizer state. Transfer learning's
``set_feature_extractor`` wraps the frozen prefix in it.

The wrapper answers for its layer where the networks ask a layer:
``propagate_mask``, ``mixes_positions``, ``pools_sequence`` and
``sequence_parallel`` (absent when the underlying layer has none), so a
frozen block keeps its place in a sequence-parallel network. Its JSON
nests the underlying layer, as the JAX ``to_dict`` does. The other
classes of the JAX file are not ported (``ROADMAP.md``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


class _Wrapper(Layer):
    """What both frozen wrappers delegate to their ``underlying``."""

    underlying: Optional[Layer]

    def init(self, gen, input_shape, dtype=torch.float32):
        return self.underlying.init(gen, input_shape, dtype)

    def propagate_mask(self, mask, input_shape):
        return self.underlying.propagate_mask(mask, input_shape)

    @property
    def mixes_positions(self):
        return self.underlying.mixes_positions

    @property
    def pools_sequence(self):
        return self.underlying.pools_sequence

    @property
    def sequence_parallel(self):
        # AttributeError when the layer has no mode: hasattr is False
        return self.underlying.sequence_parallel


@register_layer
@dataclass
class FrozenLayer(_Wrapper):
    """The underlying layer with its parameters frozen, run with
    ``train=False``."""
    underlying: Optional[Layer] = None

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return self.underlying.apply(params, state, x, train=False,
                                     rng=rng, mask=mask)
