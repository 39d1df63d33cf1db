"""DataSet iterators (port of the first two classes of
``deeplearning4j_tpu/data/iterators.py``) — reference:
``org.nd4j.linalg.dataset.api.iterator.DataSetIterator`` and
``ListDataSetIterator``: batches of host numpy arrays, each network
moving a batch to its device when it takes it. The normalizer hook
(``set_pre_processor``), ``AsyncDataSetIterator`` and the record readers
come with the data slice (ROADMAP A9).
"""
from __future__ import annotations

from typing import Iterator

from deeplearning4j_tpu_torch.data.dataset import DataSet


class DataSetIterator:
    """Base iterator; subclasses override ``__iter__``."""

    def __init__(self, batch_size: int = 32):
        self.batch_size = batch_size

    def reset(self):
        pass

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError


class ListDataSetIterator(DataSetIterator):
    """Iterates a list of batches, or one ``DataSet`` cut into
    ``batch_size`` rows, reshuffled each pass with seed ``seed + epoch``
    when ``shuffle`` is set (reference ListDataSetIterator)."""

    def __init__(self, data, batch_size: int = 32, shuffle: bool = False,
                 seed: int = 0):
        super().__init__(batch_size)
        self._data = data
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        if isinstance(self._data, DataSet):
            n = self._data.features.shape[0]
            return -(-n // self.batch_size)
        return len(self._data)

    def __iter__(self):
        data = self._data
        if isinstance(data, DataSet):
            if self.shuffle:
                data = data.shuffle(self.seed + self._epoch)
                self._epoch += 1
            yield from data.batch_by(self.batch_size)
        else:
            yield from data
