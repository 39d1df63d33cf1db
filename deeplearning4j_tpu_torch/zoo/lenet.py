"""LeNet (port of ``deeplearning4j_tpu/zoo/lenet.py``) — reference:
``org.deeplearning4j.zoo.model.LeNet``, the BASELINE's config #1 model.

conv(20, 5×5, SAME) → max 2×2/2 → conv(50, 5×5, SAME) → max 2×2/2 →
dense(500, relu) → softmax(10) on 28×28×1, per the dl4j-examples
LeNetMnistExample: 1 256 080 parameters, Nesterovs(0.01, 0.9).
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer,
                                                DenseLayer, OutputLayer,
                                                SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo.pretrained import ZooModel


class LeNet(ZooModel):
    def __init__(self, num_classes: int = 10, seed: int = 123,
                 updater=None, input_shape=(28, 28, 1)):
        self.num_classes = num_classes
        self.seed = seed
        self.updater = updater or upd.Nesterovs(learning_rate=0.01,
                                                momentum=0.9)
        self.input_shape = input_shape

    def conf(self):
        h, w, c = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater)
                .weight_init_fn("xavier")
                .list()
                .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                        stride=(1, 1), padding="SAME",
                                        activation="identity"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                        pooling_type="max"))
                .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                        stride=(1, 1), padding="SAME",
                                        activation="identity"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                        pooling_type="max"))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_out=self.num_classes,
                                   activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())

    def init(self, device="cuda") -> MultiLayerNetwork:
        """The network with its parameters built on ``device``."""
        return MultiLayerNetwork(self.conf()).init(device=device)
