"""AlexNet (port of ``deeplearning4j_tpu/zoo/alexnet.py``) — reference:
``org.deeplearning4j.zoo.model.AlexNet``, the one-card variant of
Krizhevsky et al. 2012 with local response normalisation: five
convolutions (11×11/4, 5×5, three 3×3; SAME), two LRNs and three 3×3/2
max pools, two dense layers of 4096 with dropout 0.5 and a softmax,
Nesterovs (0.01, 0.9)."""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer,
                                                DenseLayer,
                                                LocalResponseNormalization,
                                                OutputLayer,
                                                SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo.pretrained import ZooModel


class AlexNet(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 updater=None, input_shape=(224, 224, 3)):
        self.num_classes = num_classes
        self.seed = seed
        self.updater = updater or upd.Nesterovs(learning_rate=1e-2,
                                                momentum=0.9)
        self.input_shape = input_shape

    def conf(self):
        h, w, c = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater)
                .weight_init_fn("relu")
                .list()
                .layer(ConvolutionLayer(n_out=96, kernel_size=(11, 11),
                                        stride=(4, 4), padding="SAME",
                                        activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                        pooling_type="max"))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(5, 5),
                                        stride=(1, 1), padding="SAME",
                                        activation="relu", bias_init=1.0))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                        pooling_type="max"))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                        padding="SAME", activation="relu"))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                        padding="SAME", activation="relu",
                                        bias_init=1.0))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3),
                                        padding="SAME", activation="relu",
                                        bias_init=1.0))
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                        pooling_type="max"))
                .layer(DenseLayer(n_out=4096, activation="relu",
                                  dropout=0.5, bias_init=1.0))
                .layer(DenseLayer(n_out=4096, activation="relu",
                                  dropout=0.5, bias_init=1.0))
                .layer(OutputLayer(n_out=self.num_classes,
                                   activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())

    def init(self, device="cuda") -> MultiLayerNetwork:
        """The network with its parameters built on ``device``."""
        return MultiLayerNetwork(self.conf()).init(device=device)
