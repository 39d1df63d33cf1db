"""BERT, the encoder-only transformer family (port of
``deeplearning4j_tpu/zoo/bert.py``; BASELINE config #4).

The same graph as the JAX package: token and segment embeddings summed
by an ``ElementWiseVertex``, learned positions, LayerNorm, dropout,
``n_layers`` pre-LN ``TransformerEncoderBlock``s and a final LayerNorm,
on a ``ComputationGraph`` with inputs ``tokens`` and ``segments``. The
classifier head pools the CLS token through a tanh dense and ends in a
softmax trained by cross-entropy from the logits. On the card a
fine-tune step runs the flash-attention kernels (K1, K3: non-causal,
key-masked) and the LayerNorm kernels (K8, K9) of every block.

The masked-LM head (:meth:`Bert.conf_mlm`) ends the trunk in an
``RnnOutputLayer`` over the vocabulary, a per-position softmax trained
by cross-entropy from the [B, T, V] logits under the labels mask of the
masked positions (``nlp.BertIterator`` makes such batches). The JAX
graph's fused head flattens that layer's input, so the reference's
``fit`` of this head fails; the port applies the layer per time step,
its documented rule (``ROADMAP.md`` C). On the card an MLM step runs
K1, K3, K8 and K9 as the fine-tune step does.
"""
from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (ClsTokenPoolLayer,
                                                DropoutLayer,
                                                EmbeddingSequenceLayer,
                                                LayerNormalization,
                                                OutputLayer,
                                                PositionalEmbeddingLayer,
                                                RnnOutputLayer,
                                                TransformerEncoderBlock)
from deeplearning4j_tpu_torch.nn.vertices import ElementWiseVertex

class Bert:
    """Configurable BERT encoder. ``BertBase()`` / ``BertTiny()`` give
    the standard sizes. The default updater is BERT's fine-tuning AdamW
    (lr 2e-5, weight decay 0.01, biases and norms undecayed)."""

    def __init__(self, vocab_size: int = 30522, hidden: int = 768,
                 n_layers: int = 12, n_heads: int = 12,
                 max_len: int = 512, ffn_mult: int = 4,
                 type_vocab: int = 2, dropout: float = 0.1,
                 seed: int = 123, updater=None,
                 compute_dtype: Optional[str] = None):
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.max_len = max_len
        self.ffn_mult = ffn_mult
        self.type_vocab = type_vocab
        self.dropout = dropout
        self.seed = seed
        self.updater = updater or upd.AdamW(learning_rate=2e-5,
                                            weight_decay=0.01,
                                            exclude_bias_and_norm=True)
        self.compute_dtype = compute_dtype

    # -- shared encoder trunk -------------------------------------------
    def _trunk(self, seq_len: int):
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater)
             .compute_data_type(self.compute_dtype)
             .graph_builder()
             .add_inputs("tokens", "segments"))
        b.add_layer("tok_emb",
                    EmbeddingSequenceLayer(n_in=self.vocab_size,
                                           n_out=self.hidden,
                                           weight_init="normal"),
                    "tokens")
        b.add_layer("seg_emb",
                    EmbeddingSequenceLayer(n_in=self.type_vocab,
                                           n_out=self.hidden,
                                           weight_init="normal"),
                    "segments")
        b.add_vertex("emb_sum", ElementWiseVertex(op="add"),
                     "tok_emb", "seg_emb")
        b.add_layer("pos_emb",
                    PositionalEmbeddingLayer(max_len=self.max_len),
                    "emb_sum")
        b.add_layer("emb_ln", LayerNormalization(), "pos_emb")
        x = "emb_ln"
        if self.dropout:
            b.add_layer("emb_drop", DropoutLayer(dropout=self.dropout), x)
            x = "emb_drop"
        for i in range(self.n_layers):
            b.add_layer(f"enc_{i}",
                        TransformerEncoderBlock(n_in=self.hidden,
                                                n_heads=self.n_heads,
                                                ffn_mult=self.ffn_mult,
                                                dropout=self.dropout),
                        x)
            x = f"enc_{i}"
        b.add_layer("final_ln", LayerNormalization(), x)
        b.set_input_types(
            tokens=InputType.recurrent(1, seq_len),
            segments=InputType.recurrent(1, seq_len))
        return b, "final_ln"

    # -- heads -----------------------------------------------------------
    def conf_classifier(self, num_classes: int, seq_len: int = 128):
        """Fine-tune head: CLS pooler + softmax (the BASELINE BERT-base
        fine-tune configuration)."""
        b, x = self._trunk(seq_len)
        b.add_layer("pool", ClsTokenPoolLayer(pooler=True), x)
        b.add_layer("cls", OutputLayer(n_out=num_classes,
                                       activation="softmax",
                                       loss="mcxent"), "pool")
        b.set_outputs("cls")
        return b.build()

    def conf_mlm(self, seq_len: int = 128):
        """Masked-LM pretraining head: a per-position softmax over the
        vocabulary (a labels mask scores the masked positions only)."""
        b, x = self._trunk(seq_len)
        b.add_layer("mlm", RnnOutputLayer(n_out=self.vocab_size,
                                          activation="softmax",
                                          loss="mcxent"), x)
        b.set_outputs("mlm")
        return b.build()

    def init_classifier(self, num_classes: int, seq_len: int = 128,
                        device="cuda") -> ComputationGraph:
        """A new classifier graph with random weights (from the model's
        seed) on ``device``, ready for ``fit``."""
        return ComputationGraph(
            self.conf_classifier(num_classes, seq_len)).init(
                {"tokens": (seq_len,), "segments": (seq_len,)},
                device=device)

    def init_mlm(self, seq_len: int = 128,
                 device="cuda") -> ComputationGraph:
        """A new masked-LM graph with random weights (from the model's
        seed) on ``device``, ready for ``fit``."""
        return ComputationGraph(self.conf_mlm(seq_len)).init(
            {"tokens": (seq_len,), "segments": (seq_len,)}, device=device)


def BertBase(**kw) -> Bert:
    """BERT-base: 110M params (12 layers, 768 hidden, 12 heads)."""
    return Bert(vocab_size=kw.pop("vocab_size", 30522), hidden=768,
                n_layers=12, n_heads=12, **kw)


def BertTiny(**kw) -> Bert:
    """2-layer/128-hidden BERT for tests and smoke runs."""
    return Bert(vocab_size=kw.pop("vocab_size", 1000), hidden=128,
                n_layers=2, n_heads=2, **kw)
