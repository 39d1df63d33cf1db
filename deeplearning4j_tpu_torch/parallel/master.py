"""Multi-node training masters (port of
``deeplearning4j_tpu/parallel/master.py``) — reference:
``org.deeplearning4j.spark.impl.multilayer.SparkDl4jMultiLayer``,
``graph.SparkComputationGraph``,
``paramavg.ParameterAveragingTrainingMaster`` and
``org.deeplearning4j.spark.parameterserver.training.SharedTrainingMaster``.

The reference splits multi-node training across Spark (orchestration and
data partitioning), the Aeron parameter-server mesh (gradient transport)
and ParallelWrapper (local replicas). Here cluster formation is
``initialize_distributed`` (``torch.distributed``), the transport the
collectives of ``parallel/`` over the ``data`` group, and the replicas
one process each. The two TrainingMaster strategies keep their
semantics:

 - ``ParameterAveragingTrainingMaster``: replicas train independently
   and average their parameters every ``averaging_frequency`` iterations
   (the wrapper's AVERAGING mode);
 - ``SharedTrainingMaster``: every step, threshold-encoded gradients are
   exchanged and every replica applies every replica's update, residuals
   kept locally (the wrapper's ENCODED mode).

``make_global_batch`` has no counterpart: in the per-process model each
rank feeds its own batch (``ParallelWrapper.fit``, the JAX package's
multi-process rule), so nothing assembles a global device array. Evaluation
(``evaluate``, ``do_evaluation``, ``merge_across_processes``) needs the
``eval_/`` classes, which come with the MultiLayerNetwork-core slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel.compression import (
    AdaptiveThresholdAlgorithm, EncodedGradientsAccumulator)
from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper

_EVAL_SLICE = ("evaluation needs the eval_/ classes, which come with the "
               "MultiLayerNetwork-core slice")


class TrainingMaster:
    """Strategy bean consumed by the Spark-facade trainers (reference
    ``org.deeplearning4j.spark.api.TrainingMaster`` SPI)."""

    def make_wrapper(self, net, mesh=None) -> ParallelWrapper:
        raise NotImplementedError

    def to_json(self) -> dict:
        raise NotImplementedError


@dataclass
class ParameterAveragingTrainingMaster(TrainingMaster):
    """Reference ``ParameterAveragingTrainingMaster`` (+Builder):
    parameter averaging every ``averaging_frequency`` iterations."""
    batch_size_per_worker: int = 16
    averaging_frequency: int = 5
    prefetch_num_batches: int = 2
    collect_training_stats: bool = False

    class Builder:
        def __init__(self, batch_size_per_worker: int = 16):
            self._kw = {"batch_size_per_worker": batch_size_per_worker}

        def averaging_frequency(self, k):
            self._kw["averaging_frequency"] = k
            return self

        def batch_size_per_worker(self, b):
            self._kw["batch_size_per_worker"] = b
            return self

        def worker_prefetch_num_batches(self, n):
            self._kw["prefetch_num_batches"] = n
            return self

        def collect_training_stats(self, flag=True):
            self._kw["collect_training_stats"] = flag
            return self

        def build(self):
            return ParameterAveragingTrainingMaster(**self._kw)

    def make_wrapper(self, net, mesh=None) -> ParallelWrapper:
        return ParallelWrapper(
            net, mode=ParallelWrapper.AVERAGING,
            averaging_frequency=self.averaging_frequency,
            mesh=mesh, prefetch_buffer=self.prefetch_num_batches)

    def to_json(self) -> dict:
        return {"@class": "ParameterAveragingTrainingMaster",
                **self.__dict__}


@dataclass
class SharedTrainingMaster(TrainingMaster):
    """Reference ``SharedTrainingMaster`` (gradient sharing over the
    Aeron parameter-server mesh): threshold-encoded gradient exchange
    with local residuals, every step, every worker."""
    batch_size_per_worker: int = 16
    threshold: float = 1e-3
    threshold_algorithm: Optional[AdaptiveThresholdAlgorithm] = None
    residual_clip: float = 5.0
    prefetch_num_batches: int = 2

    class Builder:
        def __init__(self, batch_size_per_worker: int = 16):
            self._kw = {"batch_size_per_worker": batch_size_per_worker}

        def threshold(self, tau):
            self._kw["threshold"] = tau
            return self

        def threshold_algorithm(self, algo):
            self._kw["threshold_algorithm"] = algo
            return self

        def residual_post_processor_clip(self, k):
            self._kw["residual_clip"] = k
            return self

        def batch_size_per_worker(self, b):
            self._kw["batch_size_per_worker"] = b
            return self

        def build(self):
            return SharedTrainingMaster(**self._kw)

    def make_wrapper(self, net, mesh=None) -> ParallelWrapper:
        algo = self.threshold_algorithm or AdaptiveThresholdAlgorithm(
            initial_threshold=self.threshold)
        acc = EncodedGradientsAccumulator(
            threshold_algorithm=algo, residual_clip=self.residual_clip)
        return ParallelWrapper(
            net, mode=ParallelWrapper.ENCODED, accumulator=acc,
            mesh=mesh, prefetch_buffer=self.prefetch_num_batches)

    def to_json(self) -> dict:
        d = dict(self.__dict__)
        d.pop("threshold_algorithm", None)
        return {"@class": "SharedTrainingMaster", **d}


class ShardedDataSetIterator:
    """Round-robin shard of a base iterator for one worker process (the
    analog of Spark's RDD partitioning: each executor sees only its
    partitions). Batches whose index % num_shards != shard_index are
    skipped. The index and count default to this process's rank and the
    world size (0 and 1 with no process group)."""

    def __init__(self, base, shard_index: Optional[int] = None,
                 num_shards: Optional[int] = None):
        up = dist.is_initialized()
        self.base = base
        self.shard_index = (shard_index if shard_index is not None
                            else dist.get_rank() if up else 0)
        self.num_shards = (num_shards if num_shards is not None
                           else dist.get_world_size() if up else 1)

    def reset(self):
        if hasattr(self.base, "reset"):
            self.base.reset()

    def __iter__(self):
        for i, ds in enumerate(self.base):
            if i % self.num_shards == self.shard_index:
                yield ds

    def __len__(self):
        n = len(self.base)        # sized bases only (list, ...)
        full, rem = divmod(n, self.num_shards)
        return full + (1 if self.shard_index < rem else 0)

    def __getattr__(self, name):
        # delegate iterator metadata (batch_size, labels, …) to the base
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.base, name)


def merge_across_processes(evals):
    """Cross-process reduction of evaluation objects (reference
    ``SparkDl4jMultiLayer#doEvaluation``); comes with the eval_/ classes."""
    raise NotImplementedError(f"merge_across_processes: {_EVAL_SLICE}")


class SparkDl4jMultiLayer:
    """Reference ``SparkDl4jMultiLayer`` facade: distributed fit of a
    MultiLayerNetwork under a TrainingMaster strategy. Every process
    calls ``initialize_distributed()`` first (the spark-submit
    replacement) and then ``fit`` with its own batches: wrap a global
    source in ``ShardedDataSetIterator``."""

    def __init__(self, net, training_master: TrainingMaster,
                 mesh=None):
        self.net = net
        self.master = training_master
        self.mesh = mesh or data_parallel_mesh()
        self.wrapper = training_master.make_wrapper(net, mesh=self.mesh)
        self.stats: list = []

    def fit(self, iterator, epochs: int = 1):
        """Distributed fit: every rank iterates its own batches, the
        ranks agreeing the step count and the batch size
        (``ParallelWrapper.fit``)."""
        net = self.wrapper.fit(iterator, epochs=epochs)
        if getattr(self.master, "collect_training_stats", False):
            self.stats.append({"iterations": net.iteration,
                               "score": net.score_})
        return net

    def fit_datasets(self, datasets, epochs: int = 1):
        """Fit from an explicit list of this rank's DataSets (reference
        ``fit(RDD<DataSet>)``)."""
        return self.fit(list(datasets), epochs=epochs)

    def evaluate(self, iterator, num_classes: Optional[int] = None):
        raise NotImplementedError(f"evaluate: {_EVAL_SLICE}")

    def evaluate_regression(self, iterator):
        raise NotImplementedError(f"evaluate_regression: {_EVAL_SLICE}")

    def do_evaluation(self, iterator, *evals):
        raise NotImplementedError(f"do_evaluation: {_EVAL_SLICE}")

    def score(self) -> float:
        return self.net.score()

    def get_network(self):
        return self.net


class SparkComputationGraph(SparkDl4jMultiLayer):
    """Reference ``SparkComputationGraph`` — the same flow over a
    ComputationGraph, which the wrapper refuses until its slice."""
