"""Evaluation classes (port of ``deeplearning4j_tpu/eval_/evaluation.py``).

Reference: ``org.nd4j.evaluation.classification.Evaluation`` (confusion
matrix, accuracy/precision/recall/F1, top-N), ``ROC``/``ROCMultiClass``
(AUC via exact thresholding), ``EvaluationBinary``,
``EvaluationCalibration``, ``regression.RegressionEvaluation``
(MSE/MAE/RMSE/R²/correlation per column).

Host-side numpy accumulation, as in the JAX package: the statistics are
an int64 confusion matrix, the ROC scores kept for exact thresholds and
float64 sums, so a ``merge`` is exact and a pickled evaluation holds no
device tensor (``parallel.master.merge_across_processes`` gathers the
pickles). ``eval`` takes numpy arrays or torch tensors on any device; a
tensor is copied to the host once, as float32 (:func:`to_host`). Method
names, ``stats()`` text, merge rules and errors are the JAX package's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def to_host(a) -> np.ndarray:
    """``a`` as a host numpy array: a torch tensor (any device, any
    float or integer dtype) by one ``.detach().float().cpu()`` copy,
    anything else by ``np.asarray``."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def _to_class_indices(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.ndim >= 2 and arr.shape[-1] > 1:
        return np.argmax(arr, axis=-1).ravel()
    return arr.astype(np.int64).ravel()


class Evaluation:
    """Classification evaluation (reference Evaluation)."""

    def __init__(self, n_classes: Optional[int] = None, top_n: int = 1):
        self.n_classes = n_classes
        self.top_n = top_n
        self.confusion: Optional[np.ndarray] = None
        self.top_n_correct = 0
        self.count = 0

    def _ensure(self, n):
        if self.confusion is None:
            self.n_classes = self.n_classes or n
            self.confusion = np.zeros((self.n_classes, self.n_classes),
                                      np.int64)

    def eval(self, labels, predictions, mask=None):
        labels = to_host(labels)
        predictions = to_host(predictions)
        # sequence output [B,T,C] -> flatten valid steps
        if predictions.ndim == 3:
            if mask is not None:
                m = to_host(mask).astype(bool).ravel()
                labels = labels.reshape(-1, labels.shape[-1])[m]
                predictions = predictions.reshape(
                    -1, predictions.shape[-1])[m]
            else:
                labels = labels.reshape(-1, labels.shape[-1])
                predictions = predictions.reshape(-1,
                                                  predictions.shape[-1])
        n = predictions.shape[-1] if predictions.ndim > 1 else (
            int(max(labels.max(), predictions.max())) + 1)
        self._ensure(n)
        li = _to_class_indices(labels)
        pi = _to_class_indices(predictions)
        np.add.at(self.confusion, (li, pi), 1)
        self.count += li.size
        if self.top_n > 1 and predictions.ndim > 1:
            topk = np.argsort(-predictions, axis=-1)[:, :self.top_n]
            self.top_n_correct += int(np.sum(topk == li[:, None]))
        else:
            self.top_n_correct += int(np.sum(li == pi))

    def merge(self, other: "Evaluation") -> "Evaluation":
        """Fold another Evaluation's sufficient statistics into this one
        (reference ``org.nd4j.evaluation.IEvaluation#merge`` — the
        cross-shard reduction used by distributed evaluation)."""
        # an explicitly pinned n_classes must agree even when either
        # side saw no data yet (confusion None but n_classes set) —
        # the check must not depend on merge direction
        if (self.n_classes is not None and other.n_classes is not None
                and self.n_classes != other.n_classes):
            raise ValueError(
                f"merge: class-count mismatch {self.n_classes} vs "
                f"{other.n_classes}")
        if other.confusion is None:
            # adopt an explicit pin from an empty shard so it still
            # gates later merges into this accumulator
            if self.n_classes is None:
                self.n_classes = other.n_classes
            return self
        if self.confusion is None:
            self.n_classes = other.n_classes
            self.confusion = other.confusion.copy()
        else:
            self.confusion += other.confusion
        self.top_n_correct += other.top_n_correct
        self.count += other.count
        return self

    # -- metrics (reference method names) ------------------------------
    def accuracy(self) -> float:
        c = self.confusion
        return float(np.trace(c) / max(c.sum(), 1))

    def top_n_accuracy(self) -> float:
        return self.top_n_correct / max(self.count, 1)

    def true_positives(self, cls):
        return int(self.confusion[cls, cls])

    def false_positives(self, cls):
        return int(self.confusion[:, cls].sum() - self.confusion[cls, cls])

    def false_negatives(self, cls):
        return int(self.confusion[cls, :].sum() - self.confusion[cls, cls])

    def precision(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            tp, fp = self.true_positives(cls), self.false_positives(cls)
            return tp / max(tp + fp, 1)
        vals = [self.precision(i) for i in range(self.n_classes)
                if self.confusion[:, i].sum() + self.confusion[i, :].sum()]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            tp, fn = self.true_positives(cls), self.false_negatives(cls)
            return tp / max(tp + fn, 1)
        vals = [self.recall(i) for i in range(self.n_classes)
                if self.confusion[i, :].sum() + self.confusion[:, i].sum()]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / max(p + r, 1e-12)

    def matthews_correlation(self, cls: int) -> float:
        tp = self.true_positives(cls)
        fp = self.false_positives(cls)
        fn = self.false_negatives(cls)
        tn = int(self.confusion.sum()) - tp - fp - fn
        denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        return (tp * tn - fp * fn) / denom if denom else 0.0

    def confusion_matrix(self) -> np.ndarray:
        return self.confusion.copy()

    def stats(self) -> str:
        lines = [
            "========================Evaluation Metrics=================",
            f" # of classes:    {self.n_classes}",
            f" Examples:        {self.count}",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
        ]
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n} accuracy: "
                         f"{self.top_n_accuracy():.4f}")
        lines.append("=" * 59)
        return "\n".join(lines)


class EvaluationBinary:
    """Per-output binary evaluation at threshold 0.5 (reference
    EvaluationBinary)."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.tp = self.fp = self.tn = self.fn = None

    def eval(self, labels, predictions, mask=None):
        labels = to_host(labels) > 0.5
        preds = to_host(predictions) > self.threshold
        if self.tp is None:
            n = labels.shape[-1]
            self.tp = np.zeros(n, np.int64)
            self.fp = np.zeros(n, np.int64)
            self.tn = np.zeros(n, np.int64)
            self.fn = np.zeros(n, np.int64)
        w = np.ones(labels.shape, bool) if mask is None else \
            np.broadcast_to(to_host(mask).astype(bool)[..., None],
                            labels.shape)
        self.tp += np.sum(labels & preds & w, axis=0)
        self.fp += np.sum(~labels & preds & w, axis=0)
        self.tn += np.sum(~labels & ~preds & w, axis=0)
        self.fn += np.sum(labels & ~preds & w, axis=0)

    def merge(self, other: "EvaluationBinary") -> "EvaluationBinary":
        if other.tp is None:
            return self
        if self.tp is None:
            self.tp, self.fp = other.tp.copy(), other.fp.copy()
            self.tn, self.fn = other.tn.copy(), other.fn.copy()
        else:
            self.tp += other.tp
            self.fp += other.fp
            self.tn += other.tn
            self.fn += other.fn
        return self

    def accuracy(self, i: int) -> float:
        tot = self.tp[i] + self.fp[i] + self.tn[i] + self.fn[i]
        return float((self.tp[i] + self.tn[i]) / max(tot, 1))

    def precision(self, i: int) -> float:
        return float(self.tp[i] / max(self.tp[i] + self.fp[i], 1))

    def recall(self, i: int) -> float:
        return float(self.tp[i] / max(self.tp[i] + self.fn[i], 1))

    def f1(self, i: int) -> float:
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / max(p + r, 1e-12)


class ROC:
    """Binary ROC/AUC with exact thresholds (reference ROC with
    thresholdSteps=0 → exact mode). Also PR-curve AUC."""

    def __init__(self):
        self.scores = []
        self.labels = []

    def eval(self, labels, predictions, mask=None):
        labels = to_host(labels)
        preds = to_host(predictions)
        if labels.ndim >= 2 and labels.shape[-1] == 2:
            labels = labels[..., 1]
            preds = preds[..., 1]
        self.scores.append(preds.ravel())
        self.labels.append(labels.ravel())

    def merge(self, other: "ROC") -> "ROC":
        self.scores.extend(other.scores)
        self.labels.extend(other.labels)
        return self

    def _collect(self):
        s = np.concatenate(self.scores)
        l = np.concatenate(self.labels) > 0.5
        return s, l

    def calculate_auc(self) -> float:
        s, l = self._collect()
        order = np.argsort(-s, kind="stable")
        l = l[order]
        tps = np.cumsum(l)
        fps = np.cumsum(~l)
        p, n = tps[-1], fps[-1]
        if p == 0 or n == 0:
            return 0.5
        tpr = np.concatenate([[0], tps / p])
        fpr = np.concatenate([[0], fps / n])
        return float(np.trapezoid(tpr, fpr))

    def calculate_auprc(self) -> float:
        s, l = self._collect()
        order = np.argsort(-s, kind="stable")
        l = l[order]
        tps = np.cumsum(l)
        precision = tps / np.arange(1, l.size + 1)
        recall = tps / max(tps[-1], 1)
        return float(np.trapezoid(precision, recall))


class ROCMultiClass:
    """One-vs-all ROC per class (reference ROCMultiClass)."""

    def __init__(self):
        self.rocs = {}

    def eval(self, labels, predictions, mask=None):
        labels = to_host(labels)
        preds = to_host(predictions)
        n = labels.shape[-1]
        for c in range(n):
            self.rocs.setdefault(c, ROC()).eval(labels[..., c],
                                                preds[..., c])

    def merge(self, other: "ROCMultiClass") -> "ROCMultiClass":
        for c, r in other.rocs.items():
            self.rocs.setdefault(c, ROC()).merge(r)
        return self

    def calculate_auc(self, cls: int) -> float:
        return self.rocs[cls].calculate_auc()

    def average_auc(self) -> float:
        return float(np.mean([r.calculate_auc()
                              for r in self.rocs.values()]))


class ROCBinary:
    """Per-output ROC for multi-label (sigmoid) outputs — one
    independent binary ROC per output column (reference ROCBinary).
    Mask columns via the per-example ``mask`` argument."""

    def __init__(self):
        self.rocs = {}

    def eval(self, labels, predictions, mask=None):
        labels = to_host(labels)
        preds = to_host(predictions)
        if labels.ndim == 1:
            labels = labels[:, None]
            preds = preds[:, None]
        m = to_host(mask) if mask is not None else None
        for c in range(labels.shape[-1]):
            lc, pc = labels[..., c], preds[..., c]
            if m is not None:
                mc = m[..., c] if m.ndim == labels.ndim else m
                keep = mc.ravel() > 0
                lc, pc = lc.ravel()[keep], pc.ravel()[keep]
            self.rocs.setdefault(c, ROC()).eval(lc, pc)

    def merge(self, other: "ROCBinary") -> "ROCBinary":
        for c, r in other.rocs.items():
            self.rocs.setdefault(c, ROC()).merge(r)
        return self

    def num_labels(self) -> int:
        return len(self.rocs)

    def calculate_auc(self, output: int) -> float:
        return self.rocs[output].calculate_auc()

    def calculate_auprc(self, output: int) -> float:
        return self.rocs[output].calculate_auprc()

    def average_auc(self) -> float:
        return float(np.mean([r.calculate_auc()
                              for r in self.rocs.values()]))

    def stats(self) -> str:
        lines = ["ROCBinary (per-output AUC):"]
        for c, r in sorted(self.rocs.items()):
            lines.append(f"  out {c}: AUC={r.calculate_auc():.4f} "
                         f"AUPRC={r.calculate_auprc():.4f}")
        lines.append(f"  average AUC: {self.average_auc():.4f}")
        return "\n".join(lines)


class EvaluationCalibration:
    """Reliability/calibration histograms (reference
    EvaluationCalibration)."""

    def __init__(self, bins: int = 10):
        self.bins = bins
        self.bin_counts = np.zeros(bins, np.int64)
        self.bin_correct = np.zeros(bins, np.int64)
        self.bin_prob_sum = np.zeros(bins, np.float64)

    def eval(self, labels, predictions, mask=None):
        labels = to_host(labels)
        preds = to_host(predictions)
        li = _to_class_indices(labels)
        pi = np.argmax(preds.reshape(-1, preds.shape[-1]), axis=-1)
        conf = np.max(preds.reshape(-1, preds.shape[-1]), axis=-1)
        idx = np.minimum((conf * self.bins).astype(int), self.bins - 1)
        np.add.at(self.bin_counts, idx, 1)
        np.add.at(self.bin_correct, idx, (pi == li).astype(np.int64))
        np.add.at(self.bin_prob_sum, idx, conf)

    def merge(self,
              other: "EvaluationCalibration") -> "EvaluationCalibration":
        if other.bins != self.bins:
            raise ValueError("merge: bin-count mismatch")
        self.bin_counts += other.bin_counts
        self.bin_correct += other.bin_correct
        self.bin_prob_sum += other.bin_prob_sum
        return self

    def reliability(self):
        with np.errstate(invalid="ignore"):
            acc = self.bin_correct / np.maximum(self.bin_counts, 1)
            avg_conf = self.bin_prob_sum / np.maximum(self.bin_counts, 1)
        return avg_conf, acc, self.bin_counts

    def expected_calibration_error(self) -> float:
        conf, acc, counts = self.reliability()
        total = counts.sum()
        if total == 0:
            return 0.0
        return float(np.sum(counts / total * np.abs(conf - acc)))


class RegressionEvaluation:
    """Per-column regression metrics (reference RegressionEvaluation):
    MSE, MAE, RMSE, RSE, R², pearson correlation — streaming sums."""

    def __init__(self):
        self.n = 0
        self._sums = None

    def eval(self, labels, predictions, mask=None):
        y = to_host(labels).astype(np.float64)
        p = to_host(predictions).astype(np.float64)
        if y.ndim == 1:
            y, p = y[:, None], p[:, None]
        if y.ndim == 3:
            y = y.reshape(-1, y.shape[-1])
            p = p.reshape(-1, p.shape[-1])
        if self._sums is None:
            c = y.shape[1]
            self._sums = {k: np.zeros(c) for k in
                          ("se", "ae", "y", "y2", "p", "p2", "yp")}
        s = self._sums
        s["se"] += np.sum((y - p) ** 2, axis=0)
        s["ae"] += np.sum(np.abs(y - p), axis=0)
        s["y"] += y.sum(axis=0)
        s["y2"] += (y ** 2).sum(axis=0)
        s["p"] += p.sum(axis=0)
        s["p2"] += (p ** 2).sum(axis=0)
        s["yp"] += (y * p).sum(axis=0)
        self.n += y.shape[0]

    def merge(self,
              other: "RegressionEvaluation") -> "RegressionEvaluation":
        if other._sums is None:
            return self
        if self._sums is None:
            self._sums = {k: v.copy() for k, v in other._sums.items()}
        else:
            for k in self._sums:
                self._sums[k] += other._sums[k]
        self.n += other.n
        return self

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self._sums["se"][col] / max(self.n, 1))

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self._sums["ae"][col] / max(self.n, 1))

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def r_squared(self, col: int = 0) -> float:
        s = self._sums
        ss_tot = s["y2"][col] - s["y"][col] ** 2 / self.n
        return float(1.0 - s["se"][col] / max(ss_tot, 1e-12))

    def pearson_correlation(self, col: int = 0) -> float:
        s, n = self._sums, self.n
        cov = s["yp"][col] - s["y"][col] * s["p"][col] / n
        vy = s["y2"][col] - s["y"][col] ** 2 / n
        vp = s["p2"][col] - s["p"][col] ** 2 / n
        return float(cov / max(np.sqrt(vy * vp), 1e-12))

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self._sums["se"]) / max(self.n, 1))
