"""Distributed training (port of ``deeplearning4j_tpu/parallel``) on
``torch.distributed``: one process per card, NCCL for CUDA tensors and
gloo for CPU tensors. This slice carries the data-parallel trainer —
``ParallelWrapper`` (SYNC, ENCODED, AVERAGING, ASYNC, the ZeRO sharded
update of ``zero.py`` with its gather overlap, a ``MultiLayerNetwork`` or
a ``ComputationGraph``), the training masters and the Spark facades — the
gradient compression of
``compression.py`` with its packed exchange over the CUDA codec (K10,
K11), the named-axis ``Mesh``, and the serving errors of
``inference.py``, and sequence parallelism: ``distributed_context``,
the ring and zigzag ring of ``ring_attention.py`` over the flash block
entries (K1, K3, K4, K5) and the Ulysses all-to-all of ``ulysses.py``.
Distributed evaluation: the facades' ``evaluate``, ``evaluate_regression``
and ``do_evaluation``, and ``master.merge_across_processes``, which folds
every rank's statistics together over the group.
``composed.py``, ``pipeline.py``, ``moe.py`` and
``ParallelInference`` come with later slices.
"""
from deeplearning4j_tpu_torch.parallel.mesh import (
    Mesh, active_context, context_epoch, data_parallel_mesh,
    distributed_context, initialize_distributed, make_mesh)
from deeplearning4j_tpu_torch.parallel.ring_attention import (
    ring_self_attention, zigzag_permute, zigzag_ring_self_attention,
    zigzag_unpermute)
from deeplearning4j_tpu_torch.parallel.ulysses import ulysses_self_attention
from deeplearning4j_tpu_torch.parallel.compression import (
    AdaptiveThresholdAlgorithm, EncodedGradientsAccumulator, decode_bitmap,
    decode_threshold, encode_bitmap, encode_threshold)
from deeplearning4j_tpu_torch.parallel.zero import (
    FlatShardLayout, LayoutMismatch, per_device_bytes, repad_flat_leaves,
    zero_dp_report)
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
from deeplearning4j_tpu_torch.parallel.master import (
    ParameterAveragingTrainingMaster, ShardedDataSetIterator,
    SharedTrainingMaster, SparkComputationGraph, SparkDl4jMultiLayer,
    TrainingMaster)

__all__ = [
    "ring_self_attention", "ulysses_self_attention",
    "zigzag_ring_self_attention", "zigzag_permute", "zigzag_unpermute",
    "distributed_context", "active_context", "context_epoch",
    "Mesh", "make_mesh", "data_parallel_mesh", "initialize_distributed",
    "ParallelWrapper",
    "FlatShardLayout", "LayoutMismatch", "repad_flat_leaves",
    "per_device_bytes", "zero_dp_report",
    "EncodedGradientsAccumulator", "encode_threshold", "decode_threshold",
    "encode_bitmap", "decode_bitmap", "AdaptiveThresholdAlgorithm",
    "TrainingMaster", "ParameterAveragingTrainingMaster",
    "SharedTrainingMaster", "SparkDl4jMultiLayer", "SparkComputationGraph",
    "ShardedDataSetIterator",
]
