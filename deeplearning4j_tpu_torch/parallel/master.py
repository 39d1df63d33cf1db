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

``SparkComputationGraph`` runs the same flow over a ``ComputationGraph``
(the wrapper's graph adapter). ``make_global_batch`` has no counterpart:
in the per-process model each rank feeds its own batch
(``ParallelWrapper.fit``, the JAX package's multi-process rule), so
nothing assembles a global device array. Evaluation follows the same
rule: each rank evaluates its own batches (``evaluate``,
``evaluate_regression``, ``do_evaluation``) and
``merge_across_processes`` folds the ranks' statistics together, so
every rank returns the full-data evaluation.
"""
from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.eval_.evaluation import Evaluation
from deeplearning4j_tpu_torch.nn.multilayer import evaluate_batches
from deeplearning4j_tpu_torch.parallel.compression import (
    AdaptiveThresholdAlgorithm, EncodedGradientsAccumulator)
from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper


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


def _gather_bytes(payload: bytes):
    """Every rank's ``payload``, in rank order, over the default group's
    CPU (gloo) side: the lengths are all-gathered, then the bytes padded
    to the longest as uint8 CPU tensors."""
    n = dist.get_world_size()
    size = torch.tensor([len(payload)], dtype=torch.int64)
    sizes = [torch.zeros_like(size) for _ in range(n)]
    dist.all_gather(sizes, size)
    lens = [int(t) for t in sizes]
    padded = torch.zeros(max(lens), dtype=torch.uint8)
    padded[:len(payload)] = torch.frombuffer(bytearray(payload),
                                             dtype=torch.uint8)
    parts = [torch.zeros_like(padded) for _ in range(n)]
    dist.all_gather(parts, padded)
    return [p[:k].numpy().tobytes() for p, k in zip(parts, lens)]


def merge_across_processes(evals):
    """Cross-process reduction of evaluation objects (reference
    ``SparkDl4jMultiLayer#doEvaluation``: per-partition local eval
    followed by a reduce of ``IEvaluation#merge``).

    Every rank calls this with its own shard's evaluation (or list of
    them). Past one rank the pickled lists are all-gathered over the
    default group as CPU tensors (gloo, never NCCL) and merged in rank
    order, so every rank returns the same full-data evaluations, equal
    to the byte when pickled. The ranks' list lengths are compared after
    the gather, on every rank, so a mismatch raises ``ValueError`` on
    all of them and leaves none waiting in a collective; so does a
    ``merge`` that refuses (a class-count mismatch). At world size 1 (or
    without a process group) the input comes back as it is. Works for
    any evaluation class with a ``merge`` method."""
    return _evaluate_and_merge(lambda: evals)


def _evaluate_and_merge(run):
    """``merge_across_processes(run())``, where ``run`` evaluates this
    rank's batches. Past one rank, a refusal of this rank's batches (the
    ``NotImplementedError`` of a masked batch, a ``ValueError`` of
    ``eval``) goes through the same gather in place of the evaluations,
    so every rank raises it and none is left waiting in the collective:
    the refusing rank its own error, the others the first refusal's
    type, naming its rank."""
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return run()
    try:
        evs, refusal = run(), None
    except (NotImplementedError, ValueError) as err:
        evs, refusal = None, err
    single = not isinstance(evs, (list, tuple))
    payload = pickle.dumps((refusal, [evs] if single else list(evs)))
    shards = [pickle.loads(p) for p in _gather_bytes(payload)]
    if refusal is not None:
        raise refusal
    for rank, (err, _) in enumerate(shards):
        if err is not None:
            raise type(err)(f"rank {rank} refused its batches: {err}")
    merged = shards[0][1]
    for rank, (_, shard) in enumerate(shards[1:], start=1):
        if len(shard) != len(merged):
            raise ValueError(
                f"rank {rank} contributed {len(shard)} evaluation "
                f"objects, expected {len(merged)} — every rank must "
                "pass the same evaluations")
        for a, b in zip(merged, shard):
            a.merge(b)
    return merged[0] if single else merged


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
        """Evaluate this rank's batches, then merge the statistics across
        the ranks: every rank returns the full-data Evaluation.
        ``num_classes`` pins the class count for shards that do not see
        every class (or no sample at all)."""
        if num_classes is None:
            return _evaluate_and_merge(lambda: self.net.evaluate(iterator))
        return self.do_evaluation(iterator,
                                  Evaluation(n_classes=num_classes))[0]

    def evaluate_regression(self, iterator):
        """``RegressionEvaluation`` of this rank's batches, merged across
        the ranks. A ``ComputationGraph`` has no ``evaluate_regression``
        (nor has the JAX one): use ``do_evaluation(iterator,
        RegressionEvaluation())``."""
        if not hasattr(self.net, "evaluate_regression"):
            raise TypeError(
                f"evaluate_regression: a {type(self.net).__name__} has no "
                "evaluate_regression, as in the JAX package; use "
                "do_evaluation(iterator, RegressionEvaluation())")
        return _evaluate_and_merge(
            lambda: self.net.evaluate_regression(iterator))

    def do_evaluation(self, iterator, *evals):
        """Reference ``doEvaluation``: run any evaluation objects over
        this rank's batches and merge them across the ranks. List
        features feed ``output(*x)``; a graph of several outputs is
        evaluated on its first output and label (reference
        ``SparkComputationGraph#doEvaluation``). A batch with masks
        raises ``NotImplementedError``, as the networks' ``evaluate``,
        and on every rank when one rank's batches hold it."""
        return _evaluate_and_merge(
            lambda: evaluate_batches(self.net, iterator, *evals))

    def score(self) -> float:
        return self.net.score()

    def get_network(self):
        return self.net


class SparkComputationGraph(SparkDl4jMultiLayer):
    """Reference ``SparkComputationGraph`` — the same flow over a
    ComputationGraph: ``fit`` takes this rank's ``MultiDataSet``-like
    batches (features and labels as lists) through the wrapper's graph
    adapter; ``evaluate`` and ``do_evaluation`` evaluate the first output
    against the first label."""
