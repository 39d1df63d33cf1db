"""Data-type registry and the compute-dtype policy.

Port of ``deeplearning4j_tpu/dtypes.py``: the same canonical names and
reference-style aliases, mapped onto ``torch`` dtypes.
``cast_float_tree`` is the mixed-precision helper the serving path uses
to cast a parameter tree to ``compute_dtype`` once.
"""
from __future__ import annotations

import torch

# Canonical name -> torch dtype
_REGISTRY = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "bool": torch.bool,
}

# Reference-style aliases (DataType enum names in nd4j).
_ALIASES = {
    "half": "float16",
    "float": "float32",
    "double": "float64",
    "long": "int64",
    "int": "int32",
    "short": "int16",
    "byte": "int8",
    "ubyte": "uint8",
}


def resolve(name_or_dtype) -> torch.dtype:
    """Resolve a dtype name or ``torch.dtype`` to a ``torch.dtype``
    (``None`` → float32)."""
    if name_or_dtype is None:
        return torch.float32
    if isinstance(name_or_dtype, torch.dtype):
        return name_or_dtype
    key = str(name_or_dtype).lower()
    key = _ALIASES.get(key, key)
    if key not in _REGISTRY:
        raise ValueError(f"Unknown dtype {name_or_dtype!r}")
    return _REGISTRY[key]


def cast_float_tree(tree, dtype):
    """Cast every floating-point tensor of a nested dict/list/tuple to
    ``dtype``; integer tensors and non-tensor leaves are untouched."""
    dt = resolve(dtype)
    if isinstance(tree, dict):
        return {k: cast_float_tree(v, dt) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_float_tree(v, dt) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dt)
    return tree
