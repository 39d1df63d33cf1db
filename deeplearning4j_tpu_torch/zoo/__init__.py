"""Model zoo (port). The ported slices carry the decoder-only LM
(``gpt``: its serving half and its training configuration) and BERT's
classifier (``bert``)."""
from deeplearning4j_tpu_torch.zoo.bert import Bert, BertBase, BertTiny

__all__ = ["Bert", "BertBase", "BertTiny"]
