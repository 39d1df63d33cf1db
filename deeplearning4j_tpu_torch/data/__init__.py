"""Data containers, iterators and normalisers (port of
``deeplearning4j_tpu/data``): ``DataSet``/``MultiDataSet``, the list,
prefetching, wrapping and bucketing iterators, the MNIST, Iris and real-digits
iterators, and the three normalisers. The record readers, transforms and
image loaders come with later slices."""
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.digits import (RealDigitsDataSetIterator,
                                                  load_real_digits)
from deeplearning4j_tpu_torch.data.iterators import (
    AsyncDataSetIterator, BucketedSequenceIterator, DataSetIterator,
    IteratorDataSetIterator, ListDataSetIterator)
from deeplearning4j_tpu_torch.data.mnist import (IrisDataSetIterator,
                                                 MnistDataSetIterator)
from deeplearning4j_tpu_torch.data.normalizers import (
    ImagePreProcessingScaler, Normalizer, NormalizerMinMaxScaler,
    NormalizerStandardize, normalizer_from_state)

__all__ = ["DataSet", "MultiDataSet", "DataSetIterator",
           "ListDataSetIterator", "AsyncDataSetIterator",
           "BucketedSequenceIterator",
           "IteratorDataSetIterator", "MnistDataSetIterator",
           "IrisDataSetIterator", "RealDigitsDataSetIterator",
           "load_real_digits", "Normalizer", "NormalizerStandardize",
           "NormalizerMinMaxScaler", "ImagePreProcessingScaler",
           "normalizer_from_state"]
