"""Training utilities (port of ``deeplearning4j_tpu/train``): the five
training listeners. Early stopping, the fault-tolerant trainer, the
solver and the stats listener come with later slices."""
from deeplearning4j_tpu_torch.train.listeners import (
    CheckpointListener, CollectScoresListener, EvaluativeListener,
    PerformanceListener, ScoreIterationListener, TrainingListener)

__all__ = ["TrainingListener", "ScoreIterationListener",
           "PerformanceListener", "CheckpointListener",
           "EvaluativeListener", "CollectScoresListener"]
