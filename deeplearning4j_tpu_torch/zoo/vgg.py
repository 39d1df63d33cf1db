"""VGG-16 and VGG-19 (port of ``deeplearning4j_tpu/zoo/vgg.py``) —
reference: ``org.deeplearning4j.zoo.model.VGG16`` and ``VGG19``
(Simonyan & Zisserman): five blocks of 3×3 SAME ReLU convolutions (64,
128, 256, 512, 512 filters), each ended by a 2×2/2 max pool, two dense
layers of 4096 with dropout 0.5 and a softmax, Nesterovs (0.01, 0.9)."""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer,
                                                DenseLayer, OutputLayer,
                                                SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo.pretrained import ZooModel

#: (convolutions, filters) of each block
_VGG16_BLOCKS = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
_VGG19_BLOCKS = [(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)]


class _VGG(ZooModel):
    _blocks = _VGG16_BLOCKS

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 updater=None, input_shape=(224, 224, 3)):
        self.num_classes = num_classes
        self.seed = seed
        self.updater = updater or upd.Nesterovs(learning_rate=1e-2,
                                                momentum=0.9)
        self.input_shape = input_shape

    def conf(self):
        h, w, c = self.input_shape
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater)
             .weight_init_fn("relu")
             .list())
        for n_convs, filters in self._blocks:
            for _ in range(n_convs):
                b = b.layer(ConvolutionLayer(
                    n_out=filters, kernel_size=(3, 3), stride=(1, 1),
                    padding="SAME", activation="relu"))
            b = b.layer(SubsamplingLayer(kernel_size=(2, 2),
                                         stride=(2, 2),
                                         pooling_type="max"))
        return (b.layer(DenseLayer(n_out=4096, activation="relu",
                                   dropout=0.5))
                .layer(DenseLayer(n_out=4096, activation="relu",
                                  dropout=0.5))
                .layer(OutputLayer(n_out=self.num_classes,
                                   activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())

    def init(self, device="cuda") -> MultiLayerNetwork:
        """The network with its parameters built on ``device``."""
        return MultiLayerNetwork(self.conf()).init(device=device)


class VGG16(_VGG):
    _blocks = _VGG16_BLOCKS


class VGG19(_VGG):
    _blocks = _VGG19_BLOCKS
