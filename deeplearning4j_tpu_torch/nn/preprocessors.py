"""Input preprocessors (port of ``deeplearning4j_tpu/nn/preprocessors.py``)
— shape adapters between layer families.

Reference: ``org.deeplearning4j.nn.conf.preprocessor.*``
(CnnToFeedForwardPreProcessor, FeedForwardToCnnPreProcessor,
RnnToFeedForwardPreProcessor, FeedForwardToRnnPreProcessor,
CnnToRnnPreProcessor, RnnToCnnPreProcessor) attached per layer via
``ListBuilder.input_pre_processor(idx, proc)``.

Each preprocessor is a reshape of a contiguous tensor (a view, no copy)
kept as a named config bean for the JSON round trip. Layouts are the
JAX package's: CNN tensors NHWC, sequences [B, T, F] — so the same
preprocessor merges the same axes as the reference, in another memory
order.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Sequence

_PREPROC_REGISTRY: Dict[str, type] = {}


def register_preprocessor(cls):
    _PREPROC_REGISTRY[cls.__name__] = cls
    return cls


def preprocessor_from_dict(d: Dict[str, Any]):
    """The preprocessor a ``to_dict`` dict describes (a composable one's
    chain rebuilt too)."""
    d = dict(d)
    cls = _PREPROC_REGISTRY[d.pop("@class")]
    if cls is ComposableInputPreProcessor:
        return cls(processors=tuple(preprocessor_from_dict(p)
                                    for p in d.get("processors", ())))
    return cls(**{k: v for k, v in d.items()
                  if k in {f.name for f in dataclasses.fields(cls)}})


@dataclass
class InputPreProcessor:
    """pre_process transforms activations; output_shape mirrors it on
    (batch-less) shapes; propagate_mask adapts the [B,T] mask."""

    def pre_process(self, x):
        raise NotImplementedError

    def output_shape(self, input_shape: Sequence[int]) -> tuple:
        raise NotImplementedError

    def propagate_mask(self, mask):
        return mask

    def to_dict(self):
        out = {"@class": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = list(v) if isinstance(v, tuple) else v
        return out


@register_preprocessor
@dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """[B, H, W, C] → [B, H*W*C] in H, W, C order (reference
    CnnToFeedForwardPreProcessor)."""

    def pre_process(self, x):
        return x.reshape(x.shape[0], -1)

    def output_shape(self, s):
        return (int(s[0]) * int(s[1]) * int(s[2]),)

    def propagate_mask(self, mask):
        return None


@register_preprocessor
@dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """[B, H*W*C] → [B, H, W, C] (reference FeedForwardToCnnPreProcessor;
    NHWC here, the reference NCHW)."""
    height: int = 0
    width: int = 0
    channels: int = 0

    def pre_process(self, x):
        return x.reshape(x.shape[0], self.height, self.width,
                         self.channels)

    def output_shape(self, s):
        return (self.height, self.width, self.channels)


@register_preprocessor
@dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[B, T, F] → [B*T, F]: timestep-wise dense over sequences
    (reference RnnToFeedForwardPreProcessor)."""

    def pre_process(self, x):
        return x.reshape(-1, x.shape[-1])

    def output_shape(self, s):
        return (int(s[-1]),)

    def propagate_mask(self, mask):
        return None if mask is None else mask.reshape(-1)


@register_preprocessor
@dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """[B*T, F] → [B, T, F] (reference FeedForwardToRnnPreProcessor)."""
    time_steps: int = 0

    def pre_process(self, x):
        return x.reshape(-1, self.time_steps, x.shape[-1])

    def output_shape(self, s):
        return (self.time_steps, int(s[-1]))

    def propagate_mask(self, mask):
        return None if mask is None else mask.reshape(
            -1, self.time_steps)


@register_preprocessor
@dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    """[B, H, W, C] → [B, H, W*C]: rows become timesteps (reference
    CnnToRnnPreProcessor merges spatial dims into a time axis)."""

    def pre_process(self, x):
        return x.reshape(x.shape[0], x.shape[1], -1)

    def output_shape(self, s):
        return (int(s[0]), int(s[1]) * int(s[2]))


@register_preprocessor
@dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    """[B, T, F] → [B, T, W, C] with F = W*C (reference
    RnnToCnnPreProcessor)."""
    width: int = 0
    channels: int = 0

    def pre_process(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.width,
                         self.channels)

    def output_shape(self, s):
        return (int(s[0]), self.width, self.channels)

    def propagate_mask(self, mask):
        return None


@register_preprocessor
@dataclass
class ComposableInputPreProcessor(InputPreProcessor):
    """Chain of preprocessors (reference ComposableInputPreProcessor)."""
    processors: Sequence[Any] = ()

    def pre_process(self, x):
        for p in self.processors:
            x = p.pre_process(x)
        return x

    def output_shape(self, s):
        for p in self.processors:
            s = p.output_shape(s)
        return s

    def propagate_mask(self, mask):
        for p in self.processors:
            mask = p.propagate_mask(mask)
        return mask

    def to_dict(self):
        return {"@class": type(self).__name__,
                "processors": [p.to_dict() for p in self.processors]}

