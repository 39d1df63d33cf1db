"""Real handwritten-digit data, checked into the repo (port of
``deeplearning4j_tpu/data/digits.py``).

Reference analog: ``MnistDataSetIterator``'s role as the canonical
real-image smoke dataset (deeplearning4j-datasets ``MnistDataFetcher``).
The package downloads nothing, so without MNIST's IDX files
``MnistDataSetIterator`` falls back to a *synthetic* generator and
says so (``data/mnist.py``).  To keep at least one REAL
image-classification measurement honest, the UCI Optical Recognition
of Handwritten Digits dataset (1,797 pen-written 8×8 digit images —
real human handwriting, shipped with scikit-learn and re-packed under
``resources/datasets/digits_real.npz``) is bundled here with a
deterministic train/test split.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator

_NPZ = Path(__file__).resolve().parents[2] / "resources" / "datasets" / \
    "digits_real.npz"


#: the train/test split is a FIXED property of the dataset — varying it
#: with a user seed would leak test samples into training
_SPLIT_SEED = 7


def load_real_digits(train: bool = True, test_fraction: float = 0.2):
    """Returns ``(features [N,8,8,1] float32 in [0,1], one-hot labels
    [N,10])`` for the deterministic train or test split."""
    with np.load(_NPZ) as z:
        images, labels = z["images"], z["labels"]
    rng = np.random.default_rng(_SPLIT_SEED)
    order = rng.permutation(len(images))
    n_test = int(len(images) * test_fraction)
    idx = order[n_test:] if train else order[:n_test]
    x = (images[idx].astype(np.float32) / 16.0)[..., None]
    y = np.eye(10, dtype=np.float32)[labels[idx]]
    return x, y


class RealDigitsDataSetIterator(ListDataSetIterator):
    """Iterator over the checked-in REAL handwritten digits (the
    network-free stand-in for the reference's MNIST iterator; every
    sample is a genuine human-written digit)."""

    def __init__(self, batch_size: int = 64, train: bool = True,
                 seed: int = 7):
        # seed varies only the epoch shuffle order; the split itself is
        # fixed (see _SPLIT_SEED)
        x, y = load_real_digits(train=train)
        super().__init__(DataSet(x, y), batch_size=batch_size,
                         shuffle=train, seed=seed)
