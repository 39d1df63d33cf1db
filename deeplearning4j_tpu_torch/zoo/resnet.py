"""ResNet-50 (port of ``deeplearning4j_tpu/zoo/resnet.py``) — reference:
``org.deeplearning4j.zoo.model.ResNet50``, the BASELINE's config #2.

The JAX package's graph, node for node under the same names, so
``params_from_jax``/``state_from_jax`` and the zip map one to one:
a 7×7/2 stem convolution, batch norm and ReLU, a 3×3/2 SAME max pool,
then four stages of bottlenecks (3, 4, 6 and 3 blocks of 1×1 → 3×3 →
1×1 convolutions, each followed by batch norm; a 1×1 projection
shortcut on each stage's first block, identity shortcuts elsewhere,
joined by an ``ElementWiseVertex(op="add")`` and a ReLU
``ActivationLayer``), global average pooling and a 1000-way softmax:
25 557 032 parameters at 224×224×3. Channels-last NHWC throughout;
the convolutions go to cuDNN on channels-last views, and the path has
no ported kernel. The zoo's updater is Nesterovs (0.1, 0.9).
"""
from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (ActivationLayer,
                                                BatchNormalization,
                                                ConvolutionLayer,
                                                GlobalPoolingLayer,
                                                OutputLayer,
                                                SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.zoo.pretrained import ZooModel

#: (name, filters of the three convolutions, blocks, first stride)
STAGES = (("res2", (64, 64, 256), 3, (1, 1)),
          ("res3", (128, 128, 512), 4, (2, 2)),
          ("res4", (256, 256, 1024), 6, (2, 2)),
          ("res5", (512, 512, 2048), 3, (2, 2)))


class ResNet50(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 input_shape=(224, 224, 3), updater=None,
                 compute_dtype: Optional[str] = None):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = input_shape
        self.updater = updater or upd.Nesterovs(learning_rate=0.1,
                                                momentum=0.9)
        self.compute_dtype = compute_dtype

    # -- blocks ----------------------------------------------------------
    def _conv_bn(self, b, name, inp, n_out, kernel, stride=(1, 1),
                 padding="SAME", act="relu"):
        b.add_layer(f"{name}_conv",
                    ConvolutionLayer(n_out=n_out, kernel_size=kernel,
                                     stride=stride, padding=padding,
                                     has_bias=False,
                                     activation="identity"), inp)
        b.add_layer(f"{name}_bn",
                    BatchNormalization(activation=act), f"{name}_conv")
        return f"{name}_bn"

    def _bottleneck(self, b, name, inp, filters, stride=(1, 1),
                    downsample=False):
        f1, f2, f3 = filters
        x = self._conv_bn(b, f"{name}_a", inp, f1, (1, 1), stride)
        x = self._conv_bn(b, f"{name}_b", x, f2, (3, 3))
        x = self._conv_bn(b, f"{name}_c", x, f3, (1, 1), act="identity")
        sc = (self._conv_bn(b, f"{name}_sc", inp, f3, (1, 1), stride,
                            act="identity") if downsample else inp)
        b.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, sc)
        b.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                    f"{name}_add")
        return f"{name}_out"

    # -- graph -----------------------------------------------------------
    def conf(self):
        h, w, c = self.input_shape
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater)
             .weight_init_fn("relu")
             .compute_data_type(self.compute_dtype)
             .graph_builder()
             .add_inputs("input"))
        x = self._conv_bn(b, "stem", "input", 64, (7, 7), (2, 2))
        b.add_layer("stem_pool",
                    SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                     padding="SAME",
                                     pooling_type="max"), x)
        x = "stem_pool"
        for sname, filters, blocks, stride in STAGES:
            x = self._bottleneck(b, f"{sname}_0", x, filters,
                                 stride=stride, downsample=True)
            for i in range(1, blocks):
                x = self._bottleneck(b, f"{sname}_{i}", x, filters)
        b.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        b.add_layer("fc", OutputLayer(n_out=self.num_classes,
                                      activation="softmax",
                                      loss="mcxent"), "avgpool")
        b.set_outputs("fc")
        b.set_input_types(input=InputType.convolutional(h, w, c))
        return b.build()

    def init(self, device="cuda") -> ComputationGraph:
        """The graph with its parameters and state built on ``device``."""
        return ComputationGraph(self.conf()).init(device=device)
