"""Nested-dict parameter trees: the few ``jax.tree`` operations the port
needs (the JAX package keeps its parameters as pytrees; the port keeps
them as nested dicts of tensors with the same keys)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch


def leaves(tree) -> Iterator[Any]:
    """The leaves of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def map_(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: map_(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def map_with_path(fn: Callable, tree, *rest, path: Tuple[str, ...] = ()):
    """Like :func:`map_`, with the key path of each leaf as the first
    argument of ``fn``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest),
                                 path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *rest)


def to_torch(a) -> torch.Tensor:
    """A numpy (or JAX-exported) array as a CPU tensor of the same dtype;
    bfloat16 goes through float32, which holds it exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16: no torch view
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def from_numpy(shapes, tree, device, path: str = ""):
    """Tensors on ``device`` from ``tree``, a nested dict of arrays
    (``jax.tree.map(np.asarray, params)``), checked key for key and
    shape for shape against ``shapes`` (the same nesting, shape tuples at
    the leaves). Raises ``ValueError`` naming the first mismatch."""
    if set(tree) != set(shapes):
        raise ValueError(f"params{path}: keys {sorted(tree)} != "
                         f"expected {sorted(shapes)}")
    out = {}
    for k, shape in shapes.items():
        if isinstance(shape, dict):
            out[k] = from_numpy(shape, tree[k], device, f"{path}.{k}")
            continue
        t = to_torch(tree[k])
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"params{path}.{k}: shape {tuple(t.shape)} "
                             f"!= {tuple(shape)}")
        out[k] = t.to(device)
    return out
