"""Layer implementations (port of ``deeplearning4j_tpu/nn/layers``): one
dataclass per layer with ``init`` (parameters and shape inference) and
``apply``. The ported slices carry the layers the causal LM and BERT's
classifier train with; gradients come from autograd and the kernels'
backward Functions."""
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.layers.core import (
    DenseLayer, OutputLayer, DropoutLayer, EmbeddingLayer,
    EmbeddingSequenceLayer, LayerNormalization, RMSNorm,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    BaseRecurrentLayer, RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.attention import (
    ClsTokenPoolLayer, MultiHeadAttention, PositionalEmbeddingLayer,
    TransformerDecoderBlock, TransformerEncoderBlock,
)

__all__ = [n for n in dir() if not n.startswith("_")]
