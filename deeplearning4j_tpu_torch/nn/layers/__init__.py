"""Layer implementations (port of ``deeplearning4j_tpu/nn/layers``): one
dataclass per layer with ``init`` (parameters and shape inference) and
``apply``. The ported slices carry the layers the causal LM and BERT
train with (its classifier and its masked-LM head), the convolution,
pooling, batch-norm and spatial layers of ResNet-50 and the CNN zoo,
the recurrent layers and the reference's attention layers, and the two
frozen wrappers of transfer learning; gradients come from
autograd and the kernels' backward Functions."""
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.layers.core import (
    ActivationLayer, BatchNormalization, DenseLayer, LossLayer, OutputLayer,
    DropoutLayer, EmbeddingLayer, EmbeddingSequenceLayer,
    LayerNormalization, LocalResponseNormalization, RMSNorm,
)
from deeplearning4j_tpu_torch.nn.layers.conv import (
    ConvolutionLayer, Convolution1DLayer, Convolution3DLayer, CroppingLayer,
    Deconvolution2DLayer, DepthToSpaceLayer, DepthwiseConvolution2DLayer,
    GlobalPoolingLayer, SeparableConvolution2DLayer, SpaceToDepthLayer,
    Subsampling1DLayer, Subsampling3DLayer, SubsamplingLayer,
    Upsampling1DLayer, Upsampling2DLayer, Upsampling3DLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    BaseRecurrentLayer, Bidirectional, ConvLSTM2D, GravesBidirectionalLSTM,
    GravesLSTM, GRU, LastTimeStep, LSTM, MaskZeroLayer, RnnLossLayer,
    RnnOutputLayer, SimpleRnn, TimeDistributed,
)
from deeplearning4j_tpu_torch.nn.layers.attention import (
    ClsTokenPoolLayer, LearnedSelfAttentionLayer, MultiHeadAttention,
    PositionalEmbeddingLayer, RecurrentAttentionLayer, SelfAttentionLayer,
    TransformerDecoderBlock, TransformerEncoderBlock,
)
from deeplearning4j_tpu_torch.nn.layers.special import FrozenLayer
from deeplearning4j_tpu_torch.nn.layers.extra import FrozenLayerWithBackprop

__all__ = [n for n in dir() if not n.startswith("_")]
