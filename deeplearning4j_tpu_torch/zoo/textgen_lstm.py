"""Char-RNN LSTM (port of ``deeplearning4j_tpu/zoo/textgen_lstm.py``) —
reference: ``org.deeplearning4j.zoo.model.TextGenerationLSTM`` and the
GravesLSTM character-modelling example, the BASELINE's config #3.

``layers`` GravesLSTMs of ``hidden`` units (tanh) under a softmax
``RnnOutputLayer`` over the ``vocab_size`` characters, one-hot [B, T, V]
inputs, Adam(1e-3), trained by truncated BPTT in segments of ``tbptt``
steps; ``rnn_time_step`` generates from it a character at a time.
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import GravesLSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo.pretrained import ZooModel


class TextGenerationLSTM(ZooModel):
    def __init__(self, vocab_size: int = 77, hidden: int = 256,
                 layers: int = 2, seed: int = 123, tbptt: int = 50):
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.layers = layers
        self.seed = seed
        self.tbptt = tbptt

    def conf(self):
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(upd.Adam(learning_rate=1e-3))
             .weight_init_fn("xavier")
             .list())
        for _ in range(self.layers):
            b = b.layer(GravesLSTM(n_out=self.hidden, activation="tanh"))
        b = b.layer(RnnOutputLayer(n_out=self.vocab_size,
                                   activation="softmax", loss="mcxent"))
        return (b.backprop_type("TruncatedBPTT")
                .tbptt_fwd_length(self.tbptt)
                .tbptt_back_length(self.tbptt)
                .set_input_type(InputType.recurrent(self.vocab_size))
                .build())

    def init(self, device="cuda") -> MultiLayerNetwork:
        """The network with its parameters built on ``device``."""
        return MultiLayerNetwork(self.conf()).init(
            input_shape=(None, self.vocab_size), device=device)
