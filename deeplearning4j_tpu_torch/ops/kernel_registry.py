"""The port's kernel table: one row per TPU kernel of the JAX package
(each function that reaches ``pl.pallas_call``).

For each row: the JAX kernel body and its entry point, the port function
and its plain PyTorch version, the launch counter, the route (``cuda`` or
``triton``), the source file, the status — ``ported`` or ``todo`` — the
main paths that launch it (``serve``, ``train``, ``finetune``,
``longctx``, ``dp``, ``dp_packed``, ``sp``, ``zero``, ``dp_graph``,
``eval``) and, for each path that runs in steps or batches (``train``,
``finetune``, ``longctx``: the LM trained at a 32 768-token context,
where the backward takes the
split pair K4 + K5 instead of K3; ``dp``: the train LM through
``ParallelWrapper``'s ENCODED mode; ``dp_packed``: the same step with
``EncodedGradientsAccumulator.exchange_packed``; ``sp``: the long-context
LM trained with ``sequence_parallel="zigzag_ring"`` under a one-rank
``{"seq": 1}`` context, whose attention runs four half-chunk block pairs
a layer through ``flash_block_fwd``/``flash_block_bwd``; ``zero``: the
train LM through ``ParallelWrapper(sharded_update=True)``, the ZeRO
sharded update; ``dp_graph``: BERT-base's classifier, a
``ComputationGraph``, through the same wrapper on full-length rows, so
its attention runs unmasked; ``eval``: the same classifier's
``evaluate`` on full-length rows, a forward alone, counted per evaluated
batch), its launches per step.
``chip_smoke.py`` reads this table: it builds and checks every
``ported`` row on the card, zeroes the launch counters just before each
path it drives and reads them just after, and expects every row to
launch on each of its paths (on a stepped path, exactly
``per_step[path]`` times a step, and no launch of a row the path does
not list). ``tests/test_torch_imports.py`` holds the ``ported`` rows to
importable functions that carry a ``launches`` counter.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

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
    paths: Tuple[str, ...] = ()          # main paths that launch it
    #: launches per step on each stepped path that launches it: ``train``
    #: and ``longctx`` (the 12-layer GPT-2-small-class LM at 1 024 and
    #: 32 768 tokens, remat off), ``finetune`` and ``dp_graph``
    #: (BERT-base's classifier), ``dp``, ``dp_packed`` and ``zero`` (the
    #: train LM data-parallel over one rank), ``sp`` (the long-context
    #: LM's zigzag ring at one rank), ``eval`` (BERT-base's classifier
    #: forward, per evaluated batch); ``serve`` runs no steps
    per_step: Dict[str, int] = field(default_factory=dict)

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
#: the data-parallel paths, which run the train LM's step (``zero``
#: through the sharded update)
_DP = ("dp", "dp_packed", "zero")
#: the fine-tune step's paths: alone, and under the wrapper
_FT = ("finetune", "dp_graph")
#: parameter leaves of the train LM (tied: the embedding; 10 a block of
#: 12; the final norm's gamma; the head's bias), ``len(list(tree.leaves(
#: net.params)))``, held by ``tests/test_torch_threshold_codec.py`` and
#: counted again by ``chip_smoke.py``
LM_LEAVES = 1 + 12 * 10 + 1 + 1


def _dp(n: int) -> Dict[str, int]:
    """The train step's count ``n`` on every data-parallel path."""
    return {path: n for path in _DP}


def _ft(n: int) -> Dict[str, int]:
    """The fine-tune step's count ``n`` on both of its paths."""
    return {path: n for path in _FT}


#: flash block pairs a layer of the ``sp`` step: the zigzag ring at one
#: rank runs one ring step of four half-chunk pairs (q half × k half),
#: one of them wholly above the diagonal; each pair is one K1 launch
#: forward and, its 16 384 query rows inside the fused budget, one K3
#: launch backward
SP_PAIRS = 4

KERNELS: Tuple[KernelEntry, ...] = (
    KernelEntry(
        "K1", "flash_attention_fwd", f"{_PK}:109",
        f"{_PK}:flash_attention", "ported", "serving",
        route="cuda",
        source="deeplearning4j_tpu_torch/csrc/flash_attention.cu",
        port=f"{_CK}:flash_attention",
        plain=f"{_CK}:flash_attention_reference",
        # once a block (the sp path: once a block pair)
        paths=("serve", "train", *_FT, "longctx", *_DP, "sp", "eval"),
        per_step={"train": 12, **_ft(12), "longctx": 12,
                  **_dp(12), "sp": SP_PAIRS * 12, "eval": 12}),
    KernelEntry(
        "K2", "rms_norm_fwd", f"{_FN}:111", f"{_FN}:rms_norm", "ported",
        "serving", route="triton",
        source="deeplearning4j_tpu_torch/ops/fused_norms.py",
        port=f"{_NORM}:rms_norm", plain=f"{_NORM}:rms_norm_reference",
        # ln1 of 12 blocks, the final norm
        paths=("serve", "train", "longctx", *_DP, "sp"),
        per_step={"train": 13, "longctx": 13, **_dp(13), "sp": 13}),
    KernelEntry(
        "K3", "flash_attention_bwd_fused", f"{_PK}:488",
        f"{_PK}:_flash_bwd", "ported", "training", route="cuda",
        source="deeplearning4j_tpu_torch/csrc/flash_attention_bwd.cu",
        port=f"{_CK}:flash_attention_bwd",
        plain=f"{_CK}:flash_attention_bwd_reference",
        paths=("train", *_FT, *_DP, "sp"),
        # once a block (the sp path: once a block pair)
        per_step={"train": 12, **_ft(12), **_dp(12),
                  "sp": SP_PAIRS * 12}),
    KernelEntry(
        "K4", "flash_attention_bwd_dq", f"{_PK}:418", f"{_PK}:_flash_bwd",
        "ported", "long-context", route="cuda",
        source="deeplearning4j_tpu_torch/csrc/flash_attention_bwd_split.cu",
        port=f"{_CK}:flash_attention_bwd_dq",
        plain=f"{_CK}:flash_attention_bwd_dq_reference",
        paths=("longctx",), per_step={"longctx": 12}),    # once a block
    KernelEntry(
        "K5", "flash_attention_bwd_dkv", f"{_PK}:451", f"{_PK}:_flash_bwd",
        "ported", "long-context", route="cuda",
        source="deeplearning4j_tpu_torch/csrc/flash_attention_bwd_split.cu",
        port=f"{_CK}:flash_attention_bwd_dkv",
        plain=f"{_CK}:flash_attention_bwd_dkv_reference",
        paths=("longctx",), per_step={"longctx": 12}),    # once a block
    KernelEntry(
        "K6", "rms_norm_bwd", f"{_FN}:119", f"{_FN}:_rms_bwd_call",
        "ported", "training", route="cuda",
        source="deeplearning4j_tpu_torch/csrc/norm_bwd.cu",
        port=f"{_NORM}:rms_norm_bwd",
        plain=f"{_NORM}:rms_norm_bwd_reference",
        paths=("train", "longctx", *_DP, "sp"),
        per_step={"train": 25, "longctx": 25, **_dp(25),
                  "sp": 25}),                             # all 25 norms
    KernelEntry(
        "K7", "add_rms_norm_fwd", f"{_FN}:218", f"{_FN}:add_rms_norm",
        "ported", "training", route="triton",
        source="deeplearning4j_tpu_torch/ops/fused_norms.py",
        port=f"{_NORM}:add_rms_norm",
        plain=f"{_NORM}:add_rms_norm_reference",
        paths=("train", "longctx", *_DP, "sp"),
        per_step={"train": 12, "longctx": 12, **_dp(12),
                  "sp": 12}),                             # once a block
    KernelEntry(
        "K8", "layer_norm_fwd", f"{_FN}:298", f"{_FN}:layer_norm",
        "ported", "encoder", route="triton",
        source="deeplearning4j_tpu_torch/ops/fused_norms.py",
        port=f"{_NORM}:layer_norm", plain=f"{_NORM}:layer_norm_reference",
        # emb_ln, ln1 and ln2 of 12 blocks, final_ln
        paths=(*_FT, "eval"), per_step={**_ft(26), "eval": 26}),
    KernelEntry(
        "K9", "layer_norm_bwd", f"{_FN}:312", f"{_FN}:_ln_bwd_call",
        "ported", "encoder", route="cuda",
        source="deeplearning4j_tpu_torch/csrc/norm_bwd.cu",
        port=f"{_NORM}:layer_norm_bwd",
        plain=f"{_NORM}:layer_norm_bwd_reference", paths=_FT,
        per_step=_ft(26)),                                # all 26 norms
    KernelEntry(
        "K10", "threshold_encode", f"{_PK}:843", f"{_PK}:threshold_encode",
        "ported", "data-parallel", route="cuda",
        source="deeplearning4j_tpu_torch/csrc/threshold_codec.cu",
        port=f"{_CK}:threshold_encode",
        plain=f"{_CK}:threshold_encode_reference",
        # once a gradient leaf
        paths=("dp_packed",), per_step={"dp_packed": LM_LEAVES}),
    KernelEntry(
        "K11", "threshold_decode", f"{_PK}:854", f"{_PK}:threshold_decode",
        "ported", "data-parallel", route="cuda",
        source="deeplearning4j_tpu_torch/csrc/threshold_codec.cu",
        port=f"{_CK}:threshold_decode",
        plain=f"{_CK}:threshold_decode_reference",
        # once a gradient leaf and rank (one rank on the card)
        paths=("dp_packed",), per_step={"dp_packed": LM_LEAVES}),
)


def ported() -> Tuple[KernelEntry, ...]:
    return tuple(e for e in KERNELS if e.status == "ported")


def on_path(path: str) -> Tuple[KernelEntry, ...]:
    """The ported rows a main path (``serve``, ``train``, ``finetune``,
    ``longctx``, ``dp``, ``dp_packed``, ``sp``, ``zero``, ``dp_graph``,
    ``eval``) launches."""
    return tuple(e for e in ported() if path in e.paths)
