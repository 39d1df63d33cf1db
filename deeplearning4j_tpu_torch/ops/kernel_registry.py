"""The port's kernel table: one row per TPU kernel of the JAX package
(each function that reaches ``pl.pallas_call``).

For each row: the JAX kernel body and its entry point, the port function
and its plain PyTorch version, the launch counter, the route (``cuda`` or
``triton``), the source file, and the status — ``ported`` or ``todo``.
``chip_smoke.py`` reads this table: it builds and checks every
``ported`` row on the card and reads its launch counter around the
serving run. ``tests/test_torch_imports.py`` holds the ``ported`` rows
to importable functions that carry a ``launches`` counter.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

_PK = "deeplearning4j_tpu/ops/pallas_kernels.py"
_FN = "deeplearning4j_tpu/ops/fused_norms.py"


@dataclass(frozen=True)
class KernelEntry:
    key: str                  # K1..K11
    name: str                 # short name in the smoke line
    replaces: str             # file:line of the TPU kernel body
    jax_entry: str            # file:function that reaches pallas_call
    status: str               # "ported" | "todo"
    slice: str                # the port slice that carries it
    route: Optional[str] = None          # "cuda" | "triton"
    source: Optional[str] = None         # kernel source in the repo
    port: Optional[str] = None           # "module:function"
    plain: Optional[str] = None          # "module:function"

    def _resolve(self, ref: str) -> Callable:
        mod, fn = ref.split(":")
        return getattr(importlib.import_module(mod), fn)

    def port_fn(self) -> Callable:
        return self._resolve(self.port)

    def plain_fn(self) -> Callable:
        return self._resolve(self.plain)

    def launches(self) -> int:
        return self.port_fn().launches

    def reset(self) -> None:
        self.port_fn().launches = 0


_CK = "deeplearning4j_tpu_torch.ops.cuda_kernels"
_NORM = "deeplearning4j_tpu_torch.ops.fused_norms"

KERNELS: Tuple[KernelEntry, ...] = (
    KernelEntry(
        "K1", "flash_attention_fwd", f"{_PK}:109",
        f"{_PK}:flash_attention", "ported", "serving",
        route="cuda",
        source="deeplearning4j_tpu_torch/csrc/flash_attention.cu",
        port=f"{_CK}:flash_attention",
        plain=f"{_CK}:flash_attention_reference"),
    KernelEntry(
        "K2", "rms_norm_fwd", f"{_FN}:111", f"{_FN}:rms_norm", "ported",
        "serving", route="triton",
        source="deeplearning4j_tpu_torch/ops/fused_norms.py",
        port=f"{_NORM}:rms_norm", plain=f"{_NORM}:rms_norm_reference"),
    KernelEntry("K3", "flash_attention_bwd_fused", f"{_PK}:488",
                f"{_PK}:_flash_bwd", "todo", "training"),
    KernelEntry("K4", "flash_attention_bwd_dq", f"{_PK}:418",
                f"{_PK}:_flash_bwd", "todo", "training"),
    KernelEntry("K5", "flash_attention_bwd_dkv", f"{_PK}:451",
                f"{_PK}:_flash_bwd", "todo", "training"),
    KernelEntry("K6", "rms_norm_bwd", f"{_FN}:119",
                f"{_FN}:_rms_bwd_call", "todo", "training"),
    KernelEntry("K7", "add_rms_norm_fwd", f"{_FN}:218",
                f"{_FN}:add_rms_norm", "todo", "training"),
    KernelEntry("K8", "layer_norm_fwd", f"{_FN}:298",
                f"{_FN}:layer_norm", "todo", "encoder"),
    KernelEntry("K9", "layer_norm_bwd", f"{_FN}:312",
                f"{_FN}:_ln_bwd_call", "todo", "encoder"),
    KernelEntry("K10", "threshold_encode", f"{_PK}:843",
                f"{_PK}:threshold_encode", "todo", "parallel"),
    KernelEntry("K11", "threshold_decode", f"{_PK}:854",
                f"{_PK}:threshold_decode", "todo", "parallel"),
)


def ported() -> Tuple[KernelEntry, ...]:
    return tuple(e for e in KERNELS if e.status == "ported")
