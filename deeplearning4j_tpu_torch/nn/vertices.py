"""Graph vertices (port of ``deeplearning4j_tpu/nn/vertices.py``).

A vertex is a parameter-free multi-input op in a ``ComputationGraph``:
one dataclass per vertex with ``apply(inputs)`` on batched tensors and
``output_shape(shapes)`` on batchless shapes. A vertex that reads the
sequence mask sets ``needs_mask`` (the graph then calls
``apply(inputs, mask=m)``); ``propagate_mask`` says what mask its
consumers see. ``to_dict``/:func:`vertex_from_dict` are the JAX
package's JSON beans.

Under a sequence-parallel context a vertex fed the rank's shard of a
sequence answers as a layer does (``Layer.mixes_positions``,
``Layer.pools_sequence``): the vertices that act on each position (or on
the feature or batch axis) run on the shard; ``LastTimeStepVertex``
takes each row's last step from the rank that holds it and sums it over
the group (the replicated tail of ``parallel/mesh.py``);
``DuplicateToTimeSeriesVertex`` spreads its vector over the rank's
steps; and the vertices that reorder, flatten or attend along the time
axis — ``ReverseTimeSeriesVertex``, ``FlattenVertex``,
``ReshapeVertex``, ``AttentionVertex``, a ``MergeVertex`` on the time
axis and the others that read the whole input — are refused there,
naming :data:`SEQ_ITEM`. Outside the sharded part of a graph they run as
anywhere.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch

_VERTEX_REGISTRY: Dict[str, type] = {}

#: the ROADMAP item of the vertices that cannot run on the rank's shard
#: of a sequence (they reorder, flatten or attend along the time axis)
SEQ_ITEM = "ROADMAP item A16"


def register_vertex(cls):
    """Class decorator adding the vertex to the registry."""
    _VERTEX_REGISTRY[cls.__name__] = cls
    return cls


def vertex_from_dict(d: Dict[str, Any]):
    """The vertex a ``GraphVertex.to_dict`` dict describes (a
    ``PreprocessorVertex``'s preprocessor rebuilt too)."""
    d = dict(d)
    kind = d.pop("@class")
    if kind not in _VERTEX_REGISTRY:
        raise ValueError(f"Unknown vertex class {kind!r}")
    cls = _VERTEX_REGISTRY[kind]
    if isinstance(d.get("preprocessor"), dict):
        from deeplearning4j_tpu_torch.nn.preprocessors import \
            preprocessor_from_dict
        d["preprocessor"] = preprocessor_from_dict(d["preprocessor"])
    return cls(**{k: v for k, v in d.items()
                  if k in {f.name for f in dataclasses.fields(cls)}})


@dataclass
class GraphVertex:
    #: subclasses that consume the sequence mask set this True; the
    #: graph then calls ``apply(inputs, mask=m)``
    needs_mask = False
    #: as ``Layer.mixes_positions``: False where the vertex acts on each
    #: position alone (so it runs on the rank's shard of a sequence), a
    #: string naming the ROADMAP item that would bring it there
    mixes_positions = SEQ_ITEM
    #: as ``Layer.pools_sequence``: the vertex reduces the time axis
    pools_sequence = False

    def apply(self, inputs: List[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def output_shape(self, input_shapes: List[tuple]) -> tuple:
        raise NotImplementedError

    def to_dict(self):
        out = {"@class": type(self).__name__}
        for f in dataclasses.fields(self):
            out[f.name] = getattr(self, f.name)
        return out

    def propagate_mask(self, mask):
        """Transform the incoming [B, T] mask for downstream nodes
        (mirrors ``Layer.propagate_mask``). Default: unchanged."""
        return mask


@register_vertex
@dataclass
class MergeVertex(GraphVertex):
    """Concatenate along the feature axis (reference MergeVertex)."""
    axis: int = -1

    @property
    def mixes_positions(self):
        # axis 1 of a [B, T, F] input is the time axis
        return self.axis in (1, -2) and SEQ_ITEM

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
    mixes_positions = False
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
    mixes_positions = False
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
    mixes_positions = False

    def apply(self, inputs):
        return torch.cat(inputs, dim=0)

    def output_shape(self, shapes):
        return tuple(shapes[0])


@register_vertex
@dataclass
class UnstackVertex(GraphVertex):
    """Slice ``index`` of ``num`` along the batch axis (reference
    UnstackVertex)."""
    mixes_positions = False
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
    mixes_positions = False
    scale: float = 1.0

    def apply(self, inputs):
        return inputs[0] * self.scale

    def output_shape(self, shapes):
        return tuple(shapes[0])


@register_vertex
@dataclass
class ShiftVertex(GraphVertex):
    mixes_positions = False
    shift: float = 0.0

    def apply(self, inputs):
        return inputs[0] + self.shift

    def output_shape(self, shapes):
        return tuple(shapes[0])


@register_vertex
@dataclass
class L2NormalizeVertex(GraphVertex):
    mixes_positions = False
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
    LastTimeStepVertex): each row's live steps are counted over the
    ranks, and the rank that holds the last one gives it, summed over the
    ranks. On the rank's shard of a sequence (under a sequence-parallel
    context) the sums are all-reduces and every other rank gives zeros;
    on the whole sequence they are the identity."""
    needs_mask = True
    mixes_positions = False
    pools_sequence = True

    def apply(self, inputs, mask=None):
        from deeplearning4j_tpu_torch.parallel.mesh import (
            global_positions, reduce_sum, shard_group)
        x = inputs[0]
        g = shard_group()
        live = (torch.ones(x.shape[:2], dtype=torch.int64, device=x.device)
                if mask is None else mask.to(torch.int64))
        idx = torch.clamp(reduce_sum(live.sum(dim=1), g) - 1, min=0)
        hit = global_positions(x.shape[1], x.device)[None, :] == idx[:, None]
        # one row's step or nothing: a sum of it and zeros, exact
        return reduce_sum(torch.where(hit[..., None], x, 0).sum(dim=1), g)

    def output_shape(self, shapes):
        return (shapes[0][-1],)

    def propagate_mask(self, mask):
        return None          # the time axis is gone


@register_vertex
@dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """Broadcast a [B, F] vector across the time axis of a reference
    sequence → [B, T, F]; inputs = [vector, time-series reference]. On
    the rank's shard of the reference it spans the rank's steps."""
    mixes_positions = False

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


@register_vertex
@dataclass
class PreprocessorVertex(GraphVertex):
    """Wraps an input preprocessor (``nn/preprocessors.py``) as a vertex
    (reference PreprocessorVertex)."""
    preprocessor: Optional[Any] = None

    def apply(self, inputs):
        return self.preprocessor.pre_process(inputs[0])

    def output_shape(self, shapes):
        return self.preprocessor.output_shape(shapes[0])

    def propagate_mask(self, mask):
        return self.preprocessor.propagate_mask(mask)

    def to_dict(self):
        return {"@class": type(self).__name__,
                "preprocessor": self.preprocessor.to_dict()}


@register_vertex
@dataclass
class AttentionVertex(GraphVertex):
    """Cross-attention vertex (reference AttentionVertex over
    multi_head_dot_product_attention): inputs [queries, keys, values]
    (or [q, kv]), each [B, T, F] split into ``n_heads`` heads.
    Parameter-free scaled dot-product attention through the port's
    ``scaled_dot_attention``: on the card the flash kernels (K1 forward,
    K3 backward; head dims 16, 32, 64 and 128). For projected attention
    use ``nn.layers.attention.MultiHeadAttention``."""
    n_heads: int = 1

    def apply(self, inputs):
        from deeplearning4j_tpu_torch.nn.layers.attention import \
            scaled_dot_attention
        q = inputs[0]
        k = inputs[1]
        v = inputs[2] if len(inputs) > 2 else inputs[1]

        def split(x):
            b, t, f = x.shape
            return x.reshape(b, t, self.n_heads, f // self.n_heads)

        out = scaled_dot_attention(split(q), split(k), split(v))
        b, t, h, d = out.shape
        return out.reshape(b, t, h * d)

    def output_shape(self, shapes):
        return tuple(shapes[0])
