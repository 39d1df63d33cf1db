"""Data containers and iterators (port of ``deeplearning4j_tpu/data``).
This slice carries ``DataSet``, ``MultiDataSet``, ``DataSetIterator`` and
``ListDataSetIterator``; the other iterators, record readers and
normalizers come with the MultiLayerNetwork-core slice."""
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterators import (DataSetIterator,
                                                     ListDataSetIterator)

__all__ = ["DataSet", "MultiDataSet", "DataSetIterator",
           "ListDataSetIterator"]
