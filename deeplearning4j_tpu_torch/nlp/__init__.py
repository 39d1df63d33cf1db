"""NLP (port of ``deeplearning4j_tpu/nlp``; reference
``deeplearning4j-nlp``): the tokenizer SPI and the BERT and causal-LM
data pipelines — ``BertWordPieceTokenizer``, ``BertIterator`` (the
masked-LM and sequence-classification batches ``zoo.Bert`` trains on)
and ``LMSequenceIterator``. Word2Vec, ParagraphVectors, GloVe, FastText
and the vocabulary cache come with ROADMAP item A14.
"""
from deeplearning4j_tpu_torch.nlp.tokenization import (CommonPreprocessor,
                                                       DefaultTokenizer,
                                                       DefaultTokenizerFactory)
from deeplearning4j_tpu_torch.nlp.bert_iterator import (
    BertIterator, BertWordPieceTokenizer, LMSequenceIterator)

__all__ = ["DefaultTokenizer", "DefaultTokenizerFactory",
           "CommonPreprocessor", "BertIterator", "BertWordPieceTokenizer",
           "LMSequenceIterator"]
