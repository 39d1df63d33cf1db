"""Evaluation (port of ``deeplearning4j_tpu/eval_``) — reference:
``org.nd4j.evaluation`` package."""
from deeplearning4j_tpu_torch.eval_.evaluation import (
    ROC, Evaluation, EvaluationBinary, EvaluationCalibration,
    RegressionEvaluation, ROCBinary, ROCMultiClass)

__all__ = ["Evaluation", "RegressionEvaluation", "ROC", "ROCMultiClass",
           "ROCBinary", "EvaluationBinary", "EvaluationCalibration"]
