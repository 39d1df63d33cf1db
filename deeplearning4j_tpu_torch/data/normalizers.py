"""Normalizers (port of ``deeplearning4j_tpu/data/normalizers.py``) —
reference: ``org.nd4j.linalg.dataset.api.preprocessor``:
NormalizerStandardize, NormalizerMinMaxScaler, ImagePreProcessingScaler
(fit / transform / revert + serializable statistics). Host numpy, as
the iterators' batches are; ``state_dict`` is the JAX package's JSON, so
a ``normalizer.json`` of either package's zip loads in the other.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet


class Normalizer:
    def fit(self, data):
        """Accepts a DataSet or an iterator of DataSets (streaming fit,
        like the reference's fit(DataSetIterator))."""
        raise NotImplementedError

    def transform(self, features: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def revert(self, features: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform_dataset(self, ds: DataSet) -> DataSet:
        return DataSet(self.transform(ds.features), ds.labels,
                       ds.features_mask, ds.labels_mask)

    # serialization (reference NormalizerSerializer)
    def state_dict(self) -> dict:
        raise NotImplementedError

    def load_state_dict(self, d: dict):
        raise NotImplementedError


def _feature_axes(arr: np.ndarray):
    # statistics per trailing feature/channel axis
    return tuple(range(arr.ndim - 1))


class NormalizerStandardize(Normalizer):
    """Zero-mean unit-variance per feature (reference
    NormalizerStandardize; streaming via Welford-style accumulation)."""

    def __init__(self):
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def fit(self, data):
        if isinstance(data, DataSet):
            datasets = [data]
        else:
            datasets = data
        n = 0
        s = None
        s2 = None
        for ds in datasets:
            f = ds.features.astype(np.float64)
            flat = f.reshape(-1, f.shape[-1])
            if s is None:
                s = flat.sum(axis=0)
                s2 = (flat ** 2).sum(axis=0)
            else:
                s += flat.sum(axis=0)
                s2 += (flat ** 2).sum(axis=0)
            n += flat.shape[0]
        self.mean = (s / n).astype(np.float32)
        var = s2 / n - (s / n) ** 2
        self.std = np.sqrt(np.maximum(var, 1e-12)).astype(np.float32)
        return self

    def transform(self, features):
        return (features - self.mean) / self.std

    def revert(self, features):
        return features * self.std + self.mean

    def state_dict(self):
        return {"type": "standardize", "mean": self.mean.tolist(),
                "std": self.std.tolist()}

    def load_state_dict(self, d):
        self.mean = np.asarray(d["mean"], np.float32)
        self.std = np.asarray(d["std"], np.float32)
        return self


class NormalizerMinMaxScaler(Normalizer):
    """Scale to [lo, hi] per feature (reference NormalizerMinMaxScaler)."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0):
        self.lo, self.hi = lo, hi
        self.min: Optional[np.ndarray] = None
        self.max: Optional[np.ndarray] = None

    def fit(self, data):
        datasets = [data] if isinstance(data, DataSet) else data
        mn = mx = None
        for ds in datasets:
            flat = ds.features.reshape(-1, ds.features.shape[-1])
            m1, m2 = flat.min(axis=0), flat.max(axis=0)
            mn = m1 if mn is None else np.minimum(mn, m1)
            mx = m2 if mx is None else np.maximum(mx, m2)
        self.min, self.max = mn, mx
        return self

    def transform(self, features):
        rng = np.maximum(self.max - self.min, 1e-12)
        unit = (features - self.min) / rng
        return unit * (self.hi - self.lo) + self.lo

    def revert(self, features):
        rng = np.maximum(self.max - self.min, 1e-12)
        return (features - self.lo) / (self.hi - self.lo) * rng + self.min

    def state_dict(self):
        return {"type": "minmax", "lo": self.lo, "hi": self.hi,
                "min": self.min.tolist(), "max": self.max.tolist()}

    def load_state_dict(self, d):
        self.lo, self.hi = d["lo"], d["hi"]
        self.min = np.asarray(d["min"], np.float32)
        self.max = np.asarray(d["max"], np.float32)
        return self


class ImagePreProcessingScaler(Normalizer):
    """uint8 [0,255] → [lo,hi] (reference ImagePreProcessingScaler);
    no fit needed."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0):
        self.lo, self.hi = lo, hi

    def fit(self, data):
        return self

    def transform(self, features):
        return features.astype(np.float32) / 255.0 * (self.hi - self.lo) \
            + self.lo

    def revert(self, features):
        return (features - self.lo) / (self.hi - self.lo) * 255.0

    def state_dict(self):
        return {"type": "image", "lo": self.lo, "hi": self.hi}

    def load_state_dict(self, d):
        self.lo, self.hi = d["lo"], d["hi"]
        return self


def normalizer_from_state(d: dict) -> Normalizer:
    t = d["type"]
    n = {"standardize": NormalizerStandardize,
         "minmax": NormalizerMinMaxScaler,
         "image": ImagePreProcessingScaler}[t]()
    return n.load_state_dict(d)
