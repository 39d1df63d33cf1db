"""Layer implementations (port of ``deeplearning4j_tpu/nn/layers``): one
dataclass per layer with ``init`` (parameters and shape inference) and
``apply``. This slice carries the layers the causal LM trains with;
gradients come from autograd and the kernels' backward Functions."""
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.layers.core import (
    DenseLayer, OutputLayer, EmbeddingLayer, EmbeddingSequenceLayer,
    RMSNorm,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    BaseRecurrentLayer, RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.attention import (
    MultiHeadAttention, TransformerDecoderBlock,
)

__all__ = [n for n in dir() if not n.startswith("_")]
