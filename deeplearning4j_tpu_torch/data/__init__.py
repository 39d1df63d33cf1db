"""Data containers (port of ``deeplearning4j_tpu/data``). This slice
carries ``DataSet`` and ``MultiDataSet``; the iterators, record readers
and normalizers come with the MultiLayerNetwork-core slice."""
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet

__all__ = ["DataSet", "MultiDataSet"]
