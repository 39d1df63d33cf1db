"""Distributed training (port of ``deeplearning4j_tpu/parallel``) on
``torch.distributed``: one process per card, NCCL for CUDA tensors and
gloo for CPU tensors. This slice carries the data-parallel trainer —
``ParallelWrapper`` (SYNC, ENCODED, AVERAGING, ASYNC), the training
masters and the Spark facades — the gradient compression of
``compression.py`` with its packed exchange over the CUDA codec (K10,
K11), the named-axis ``Mesh``, and the serving errors of
``inference.py``. Sequence parallelism (ring, zigzag, Ulysses,
``distributed_context``) comes with the sequence-parallel slice; ZeRO,
``composed.py``, ``pipeline.py``, ``moe.py`` and ``ParallelInference``
with later ones.
"""
from deeplearning4j_tpu_torch.parallel.mesh import (
    Mesh, data_parallel_mesh, initialize_distributed, make_mesh)
from deeplearning4j_tpu_torch.parallel.compression import (
    AdaptiveThresholdAlgorithm, EncodedGradientsAccumulator, decode_bitmap,
    decode_threshold, encode_bitmap, encode_threshold)
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
from deeplearning4j_tpu_torch.parallel.master import (
    ParameterAveragingTrainingMaster, ShardedDataSetIterator,
    SharedTrainingMaster, SparkComputationGraph, SparkDl4jMultiLayer,
    TrainingMaster)

__all__ = [
    "Mesh", "make_mesh", "data_parallel_mesh", "initialize_distributed",
    "ParallelWrapper",
    "EncodedGradientsAccumulator", "encode_threshold", "decode_threshold",
    "encode_bitmap", "decode_bitmap", "AdaptiveThresholdAlgorithm",
    "TrainingMaster", "ParameterAveragingTrainingMaster",
    "SharedTrainingMaster", "SparkDl4jMultiLayer", "SparkComputationGraph",
    "ShardedDataSetIterator",
]
