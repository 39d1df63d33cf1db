"""FrozenLayerWithBackprop (port of ``FrozenLayerWithBackprop`` in
``deeplearning4j_tpu/nn/layers/extra.py``; reference
``org.deeplearning4j.nn.layers.misc.FrozenLayerWithBackprop``): the
underlying layer runs in the caller's mode (dropout on in training) on
its parameters detached, so no gradient reaches them while the input
gradient still flows to the layers below.

The networks give its group no update and no optimizer state, as for
``FrozenLayer``. The JAX networks do not: they build its group a full
chain, so a decay or an l2 term moves its weights (``ROADMAP.md`` C7);
the port keeps them still and refuses ``l1``, ``l2`` and
``weight_decay`` on the wrapper. The other classes of the JAX file are
not ported (``ROADMAP.md``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from deeplearning4j_tpu_torch import tree
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.layers.special import _Wrapper


@register_layer
@dataclass
class FrozenLayerWithBackprop(_Wrapper):
    """The underlying layer on detached parameters, in the caller's
    mode."""
    underlying: Optional[Layer] = None

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        frozen = tree.map_(lambda t: t.detach(), params)
        return self.underlying.apply(frozen, state, x, train=train,
                                     rng=rng, mask=mask)
