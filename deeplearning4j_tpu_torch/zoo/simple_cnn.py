"""SimpleCNN (port of ``deeplearning4j_tpu/zoo/simple_cnn.py``) —
reference: ``org.deeplearning4j.zoo.model.SimpleCNN``: two blocks of a
3×3 SAME convolution, batch norm and 2×2 max pooling (16, then 32
filters, ReLU), a dense layer of 128 and a softmax, AdaDelta."""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import (BatchNormalization,
                                                ConvolutionLayer,
                                                DenseLayer, OutputLayer,
                                                SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo.pretrained import ZooModel


class SimpleCNN(ZooModel):
    def __init__(self, num_classes: int = 10, seed: int = 123,
                 input_shape=(48, 48, 3)):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = input_shape

    def conf(self):
        h, w, c = self.input_shape
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(upd.AdaDelta())
             .weight_init_fn("xavier")
             .activation_fn("relu")
             .list())
        for n_out in (16, 32):
            b = (b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                          padding="SAME"))
                  .layer(BatchNormalization())
                  .layer(SubsamplingLayer(kernel_size=(2, 2),
                                          stride=(2, 2))))
        return (b.layer(DenseLayer(n_out=128))
                 .layer(OutputLayer(n_out=self.num_classes,
                                    activation="softmax", loss="mcxent"))
                 .set_input_type(InputType.convolutional(h, w, c))
                 .build())

    def init(self, device="cuda") -> MultiLayerNetwork:
        """The network with its parameters and state built on
        ``device``."""
        return MultiLayerNetwork(self.conf()).init(device=device)
