"""DataSet containers (port of ``deeplearning4j_tpu/data/dataset.py``;
reference ``org.nd4j.linalg.dataset.DataSet`` / ``MultiDataSet``):
features, labels and their masks as host numpy arrays, with batching,
shuffling and splitting. The networks move a batch to their device when
they take it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


class DataSet:
    def __init__(self, features, labels=None, features_mask=None,
                 labels_mask=None):
        self.features = np.asarray(features)
        self.labels = None if labels is None else np.asarray(labels)
        self.features_mask = (None if features_mask is None
                              else np.asarray(features_mask))
        self.labels_mask = (None if labels_mask is None
                            else np.asarray(labels_mask))

    def num_examples(self) -> int:
        return self.features.shape[0]

    def shuffle(self, seed: Optional[int] = None) -> "DataSet":
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.num_examples())
        return self._take(idx)

    def _take(self, idx) -> "DataSet":
        return DataSet(
            self.features[idx], self.labels[idx],
            None if self.features_mask is None else self.features_mask[idx],
            None if self.labels_mask is None else self.labels_mask[idx])

    def split_test_and_train(self, n_train: int
                             ) -> Tuple["DataSet", "DataSet"]:
        return (self._take(slice(0, n_train)),
                self._take(slice(n_train, None)))

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        return [self._take(slice(i, i + batch_size))
                for i in range(0, self.num_examples(), batch_size)]

    def sample(self, n: int, seed: Optional[int] = None) -> "DataSet":
        rng = np.random.default_rng(seed)
        return self._take(rng.choice(self.num_examples(), n,
                                     replace=False))

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        return DataSet(
            np.concatenate([d.features for d in datasets]),
            np.concatenate([d.labels for d in datasets]),
            None if datasets[0].features_mask is None else
            np.concatenate([d.features_mask for d in datasets]),
            None if datasets[0].labels_mask is None else
            np.concatenate([d.labels_mask for d in datasets]))

    def __repr__(self):
        return (f"DataSet(features{self.features.shape}, "
                f"labels{self.labels.shape})")


class MultiDataSet:
    """Multiple feature/label arrays (reference
    org.nd4j.linalg.dataset.MultiDataSet) for ComputationGraph."""

    def __init__(self, features: Sequence, labels: Sequence,
                 features_masks=None, labels_masks=None):
        self.features = [np.asarray(f) for f in features]
        self.labels = [np.asarray(l) for l in labels]
        self.features_masks = features_masks
        self.labels_masks = labels_masks

    def num_examples(self) -> int:
        return self.features[0].shape[0]


#: the batch attributes that carry masks
_MASKS = ("features_mask", "labels_mask", "features_masks", "labels_masks")


def has_masks(ds) -> bool:
    """Whether a batch (a ``DataSet``, a ``MultiDataSet`` or any object
    with their mask attributes) carries a features or labels mask."""
    for attr in _MASKS:
        m = getattr(ds, attr, None)
        if m is not None and not (isinstance(m, (list, tuple))
                                  and all(a is None for a in m)):
            return True
    return False
