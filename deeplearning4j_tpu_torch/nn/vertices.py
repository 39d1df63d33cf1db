"""Graph vertices (port of ``deeplearning4j_tpu/nn/vertices.py``).

A vertex is a parameter-free multi-input op in a ``ComputationGraph``:
one dataclass per vertex with ``apply(inputs)`` on batched tensors and
``output_shape(shapes)`` on batchless shapes. A vertex that reads the
sequence mask sets ``needs_mask`` (the graph then calls
``apply(inputs, mask=m)``); ``propagate_mask`` says what mask its
consumers see. ``PreprocessorVertex`` (with the preprocessors) and
``AttentionVertex`` come with later slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import torch

_VERTEX_REGISTRY: Dict[str, type] = {}


def register_vertex(cls):
    """Class decorator adding the vertex to the registry."""
    _VERTEX_REGISTRY[cls.__name__] = cls
    return cls


@dataclass
class GraphVertex:
    #: subclasses that consume the sequence mask set this True; the
    #: graph then calls ``apply(inputs, mask=m)``
    needs_mask = False

    def apply(self, inputs: List[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def output_shape(self, input_shapes: List[tuple]) -> tuple:
        raise NotImplementedError

    def propagate_mask(self, mask):
        """Transform the incoming [B, T] mask for downstream nodes
        (mirrors ``Layer.propagate_mask``). Default: unchanged."""
        return mask


@register_vertex
@dataclass
class MergeVertex(GraphVertex):
    """Concatenate along the feature axis (reference MergeVertex)."""
    axis: int = -1

    def apply(self, inputs):
        return torch.cat(inputs, dim=self.axis)

    def output_shape(self, shapes):
        # shapes are batchless, ``apply`` sees batched tensors: normalise
        # the axis against the batched rank, then shift it down by one
        out = list(shapes[0])
        batched_rank = len(out) + 1
        ax = self.axis if self.axis >= 0 else self.axis + batched_rank
        if ax == 0:
            raise ValueError("MergeVertex cannot concatenate along "
                             "the batch axis")
        ax -= 1
        out[ax] = sum(s[ax] for s in shapes)
        return tuple(out)


@register_vertex
@dataclass
class ElementWiseVertex(GraphVertex):
    """Elementwise add/sub/mul/avg/max (reference ElementWiseVertex.Op)."""
    op: str = "add"

    def apply(self, inputs):
        op = self.op.lower()
        out = inputs[0]
        if op == "add":
            for x in inputs[1:]:
                out = out + x
        elif op in ("sub", "subtract"):
            for x in inputs[1:]:
                out = out - x
        elif op in ("mul", "product"):
            for x in inputs[1:]:
                out = out * x
        elif op in ("avg", "average"):
            out = sum(inputs) / len(inputs)
        elif op == "max":
            for x in inputs[1:]:
                out = torch.maximum(out, x)
        else:
            raise ValueError(f"unknown elementwise op {self.op!r}")
        return out

    def output_shape(self, shapes):
        return tuple(shapes[0])


@register_vertex
@dataclass
class SubsetVertex(GraphVertex):
    """Feature range [from, to], inclusive (reference SubsetVertex)."""
    from_: int = 0
    to: int = 0

    def apply(self, inputs):
        return inputs[0][..., self.from_:self.to + 1]

    def output_shape(self, shapes):
        s = list(shapes[0])
        s[-1] = self.to - self.from_ + 1
        return tuple(s)


@register_vertex
@dataclass
class StackVertex(GraphVertex):
    """Stack along the batch axis (reference StackVertex)."""

    def apply(self, inputs):
        return torch.cat(inputs, dim=0)

    def output_shape(self, shapes):
        return tuple(shapes[0])


@register_vertex
@dataclass
class UnstackVertex(GraphVertex):
    """Slice ``index`` of ``num`` along the batch axis (reference
    UnstackVertex)."""
    index: int = 0
    num: int = 2

    def apply(self, inputs):
        x = inputs[0]
        n = x.shape[0] // self.num
        return x[self.index * n:(self.index + 1) * n]

    def output_shape(self, shapes):
        return tuple(shapes[0])


@register_vertex
@dataclass
class ScaleVertex(GraphVertex):
    scale: float = 1.0

    def apply(self, inputs):
        return inputs[0] * self.scale

    def output_shape(self, shapes):
        return tuple(shapes[0])


@register_vertex
@dataclass
class ShiftVertex(GraphVertex):
    shift: float = 0.0

    def apply(self, inputs):
        return inputs[0] + self.shift

    def output_shape(self, shapes):
        return tuple(shapes[0])


@register_vertex
@dataclass
class L2NormalizeVertex(GraphVertex):
    eps: float = 1e-8

    def apply(self, inputs):
        x = inputs[0]
        n = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
        return x / torch.clamp(n, min=self.eps)

    def output_shape(self, shapes):
        return tuple(shapes[0])


@register_vertex
@dataclass
class ReshapeVertex(GraphVertex):
    """Reshape the trailing dims, batch kept (reference ReshapeVertex)."""
    shape: Sequence[int] = ()

    def apply(self, inputs):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(self.shape))

    def output_shape(self, shapes):
        return tuple(self.shape)


@register_vertex
@dataclass
class FlattenVertex(GraphVertex):
    """Collapse all trailing dims to one feature axis."""

    def apply(self, inputs):
        x = inputs[0]
        return x.reshape(x.shape[0], -1)

    def output_shape(self, shapes):
        n = 1
        for d in shapes[0]:
            if d is None or int(d) < 0:
                raise ValueError(
                    "FlattenVertex needs fully-known input dims; got "
                    f"{shapes[0]} (dynamic time axes cannot be flattened)")
            n *= int(d)
        return (n,)

    def propagate_mask(self, mask):
        return None          # the time axis is gone


@register_vertex
@dataclass
class PoolHelperVertex(GraphVertex):
    """Strips the first row and column (reference PoolHelperVertex)."""

    def apply(self, inputs):
        return inputs[0][:, 1:, 1:, :]

    def output_shape(self, shapes):
        s = shapes[0]
        return (s[0] - 1, s[1] - 1, s[2])


@register_vertex
@dataclass
class L2Vertex(GraphVertex):
    """Pairwise L2 distance between two activation tensors → [B, 1]
    (reference L2Vertex)."""
    eps: float = 1e-8

    def apply(self, inputs):
        a = inputs[0].reshape(inputs[0].shape[0], -1)
        b = inputs[1].reshape(inputs[1].shape[0], -1)
        d2 = torch.sum(torch.square(a - b), dim=-1, keepdim=True)
        # guarded sqrt: a finite gradient when the two branches coincide
        safe = torch.where(d2 > 0, d2, torch.ones_like(d2))
        return torch.where(d2 > 0, torch.sqrt(safe),
                           torch.full_like(d2, self.eps))

    def output_shape(self, shapes):
        return (1,)

    def propagate_mask(self, mask):
        return None


@register_vertex
@dataclass
class LastTimeStepVertex(GraphVertex):
    """The last unmasked timestep of [B, T, F] → [B, F] (reference
    LastTimeStepVertex)."""
    needs_mask = True

    def apply(self, inputs, mask=None):
        x = inputs[0]
        if mask is None:
            return x[:, -1, :]
        lengths = torch.sum(mask.to(torch.int64), dim=1)
        idx = torch.clamp(lengths - 1, min=0)
        return x[torch.arange(x.shape[0], device=x.device), idx]

    def output_shape(self, shapes):
        return (shapes[0][-1],)

    def propagate_mask(self, mask):
        return None          # the time axis is gone


@register_vertex
@dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """Broadcast a [B, F] vector across the time axis of a reference
    sequence → [B, T, F]; inputs = [vector, time-series reference]."""

    def apply(self, inputs):
        vec, ts = inputs[0], inputs[1]
        return vec[:, None, :].expand(vec.shape[0], ts.shape[1],
                                      vec.shape[-1])

    def output_shape(self, shapes):
        return (shapes[1][0], shapes[0][-1])


@register_vertex
@dataclass
class ReverseTimeSeriesVertex(GraphVertex):
    """Mask-aware time reversal of [B, T, F]: only the valid prefix is
    reversed, padding stays in place."""
    needs_mask = True

    def apply(self, inputs, mask=None):
        x = inputs[0]
        if mask is None:
            return torch.flip(x, dims=(1,))
        lengths = torch.sum(mask.to(torch.int64), dim=1)
        t = torch.arange(x.shape[1], device=x.device)
        idx = torch.where(t[None, :] < lengths[:, None],
                          lengths[:, None] - 1 - t[None, :], t[None, :])
        return torch.gather(x, 1, idx[:, :, None].expand(-1, -1,
                                                         x.shape[2]))

    def output_shape(self, shapes):
        return tuple(shapes[0])
