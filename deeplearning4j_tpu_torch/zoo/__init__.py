"""Model zoo (port). The ported slices carry the decoder-only LM
(``gpt``: its serving half and its training configuration), BERT's
classifier (``bert``), LeNet (``lenet``) and the pretrained-weight
repository (``pretrained``)."""
from deeplearning4j_tpu_torch.zoo.bert import Bert, BertBase, BertTiny
from deeplearning4j_tpu_torch.zoo.lenet import LeNet
from deeplearning4j_tpu_torch.zoo.pretrained import (DL4JResources,
                                                     ZooModel,
                                                     export_pretrained,
                                                     fetch_pretrained)

__all__ = ["Bert", "BertBase", "BertTiny", "LeNet", "ZooModel",
           "DL4JResources", "export_pretrained", "fetch_pretrained"]
