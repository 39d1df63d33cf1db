"""Model zoo (port). The ported slices carry the decoder-only LM
(``gpt``: its serving half and its training configuration), BERT's
classifier and masked-LM head (``bert``), LeNet (``lenet``), ResNet-50
(``resnet``), the small CNNs AlexNet, VGG16, VGG19 and SimpleCNN, and
the char-RNN ``TextGenerationLSTM`` (``textgen_lstm``) and the
pretrained-weight repository (``pretrained``). SqueezeNet,
Darknet19/YOLO, UNet, Xception, InceptionResNetV1, NASNet and FaceNet
come with ROADMAP item A14."""
from deeplearning4j_tpu_torch.zoo.alexnet import AlexNet
from deeplearning4j_tpu_torch.zoo.bert import Bert, BertBase, BertTiny
from deeplearning4j_tpu_torch.zoo.lenet import LeNet
from deeplearning4j_tpu_torch.zoo.pretrained import (DL4JResources,
                                                     ZooModel,
                                                     export_pretrained,
                                                     fetch_pretrained)
from deeplearning4j_tpu_torch.zoo.resnet import ResNet50
from deeplearning4j_tpu_torch.zoo.simple_cnn import SimpleCNN
from deeplearning4j_tpu_torch.zoo.textgen_lstm import TextGenerationLSTM
from deeplearning4j_tpu_torch.zoo.vgg import VGG16, VGG19

__all__ = ["AlexNet", "Bert", "BertBase", "BertTiny", "LeNet", "ResNet50",
           "SimpleCNN", "TextGenerationLSTM", "VGG16", "VGG19", "ZooModel",
           "DL4JResources", "export_pretrained", "fetch_pretrained"]
