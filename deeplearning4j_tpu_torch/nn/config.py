"""Network configuration (port of ``deeplearning4j_tpu/nn/config.py``).

The fluent builder of the reference: ``NeuralNetConfiguration.builder()
.seed(..).updater(..).compute_data_type(..).list().layer(..)...
.tie_weights(..).set_input_type(..).build()`` gives a
:class:`MultiLayerConfiguration`, and ``.graph_builder()`` a
``nn.graph.GraphBuilder`` for a ``ComputationGraph``. Global defaults
(activation, weight init, dropout, ...) flow into layers that leave them
unset. JSON serialisation and input preprocessors come with the
MultiLayerNetwork-core slice; truncated BPTT with the recurrent slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.layers.base import Layer


class InputType:
    """Shape descriptor (reference inputs.InputType). Shapes exclude the
    batch axis; layouts are channels-last, as in the JAX package."""

    def __init__(self, kind: str, shape: Tuple[int, ...]):
        self.kind = kind
        self.shape = tuple(int(s) for s in shape)

    @staticmethod
    def feed_forward(n: int) -> "InputType":
        return InputType("ff", (n,))

    @staticmethod
    def recurrent(n_features: int, timesteps: int = -1) -> "InputType":
        return InputType("rnn", (timesteps, n_features))

    def __repr__(self):
        return f"InputType({self.kind}, {self.shape})"


_GLOBAL_DEFAULTS = ("activation", "weight_init", "l1", "l2",
                    "weight_decay", "dropout")


@dataclass
class MultiLayerConfiguration:
    """Reference: MultiLayerConfiguration. Built via
    ``NeuralNetConfiguration.builder()...list()...build()``."""
    layers: List[Layer] = field(default_factory=list)
    seed: int = 12345
    dtype: str = "float32"
    compute_dtype: Optional[str] = None   # bf16 fwd/bwd, fp32 params
    updater: Any = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    input_type: Optional[InputType] = None
    backprop_type: str = "Standard"        # "TruncatedBPTT" is refused
    input_preprocessors: dict = field(default_factory=dict)
    # weight tying: [dst_layer, dst_param, src_layer, src_param,
    # transpose] — the dst param is not a master parameter; every
    # forward rebuilds it from src, so gradients reach src from both uses
    tied_weights: List[list] = field(default_factory=list)

    def __post_init__(self):
        if self.updater is None:
            self.updater = upd.Sgd(learning_rate=1e-2)


class ListBuilder:
    """Reference: NeuralNetConfiguration.ListBuilder."""

    def __init__(self, global_conf: "NeuralNetConfiguration"):
        self._g = global_conf
        self._layers: List[Layer] = []
        self._input_type: Optional[InputType] = None
        self._tied: List[list] = []

    def layer(self, *args) -> "ListBuilder":
        """layer(l) or layer(index, l) like the reference."""
        l = args[-1]
        for name in _GLOBAL_DEFAULTS:
            if getattr(l, name, None) is None:
                gv = getattr(self._g, name, None)
                if gv is not None:
                    setattr(l, name, gv)
        if len(args) == 2:
            idx = args[0]
            while len(self._layers) <= idx:
                self._layers.append(None)  # type: ignore
            self._layers[idx] = l
        else:
            self._layers.append(l)
        return self

    def set_input_type(self, input_type: InputType) -> "ListBuilder":
        self._input_type = input_type
        return self

    def tie_weights(self, dst_layer: int, dst_param: str,
                    src_layer: int, src_param: str,
                    transpose: bool = False) -> "ListBuilder":
        """Tie layer ``dst_layer``'s ``dst_param`` to ``src_layer``'s
        ``src_param`` (optionally transposed): the dst param stops being
        a master parameter and is rebuilt from src in every forward."""
        self._tied.append([dst_layer, dst_param, src_layer, src_param,
                           bool(transpose)])
        return self

    def build(self) -> MultiLayerConfiguration:
        if any(l is None for l in self._layers):
            raise ValueError("gap in layer indices")
        return MultiLayerConfiguration(
            layers=self._layers,
            seed=self._g.seed_,
            dtype=self._g.dtype_,
            compute_dtype=self._g.compute_dtype_,
            updater=self._g.updater_,
            gradient_normalization=self._g.grad_norm_,
            gradient_normalization_threshold=self._g.grad_norm_threshold_,
            input_type=self._input_type,
            tied_weights=[list(t) for t in self._tied],
        )


class NeuralNetConfiguration:
    """Reference: NeuralNetConfiguration.Builder (fluent global config)."""

    def __init__(self):
        self.seed_ = 12345
        self.dtype_ = "float32"
        self.compute_dtype_ = None
        self.updater_ = upd.Sgd(learning_rate=1e-2)
        self.activation = None
        self.weight_init = None
        self.l1 = None
        self.l2 = None
        self.weight_decay = None
        self.dropout = None
        self.grad_norm_ = None
        self.grad_norm_threshold_ = 1.0

    @staticmethod
    def builder() -> "NeuralNetConfiguration":
        return NeuralNetConfiguration()

    def seed(self, s: int):
        self.seed_ = int(s)
        return self

    def data_type(self, dtype: str):
        self.dtype_ = dtype
        return self

    def compute_data_type(self, dtype: Optional[str]):
        """Mixed precision: run forward/backward math in ``dtype``
        (bfloat16) while params, optimizer state and the loss stay in
        ``data_type`` (fp32)."""
        self.compute_dtype_ = dtype
        return self

    def updater(self, u):
        self.updater_ = u
        return self

    def activation_fn(self, a: str):
        self.activation = a
        return self

    def weight_init_fn(self, w: str):
        self.weight_init = w
        return self

    def dropout_(self, v: float):
        self.dropout = v
        return self

    def gradient_normalization(self, mode: str, threshold: float = 1.0):
        self.grad_norm_ = mode
        self.grad_norm_threshold_ = threshold
        return self

    def list(self) -> ListBuilder:
        return ListBuilder(self)

    def graph_builder(self):
        """Reference: NeuralNetConfiguration.Builder.graphBuilder()."""
        from deeplearning4j_tpu_torch.nn.graph import GraphBuilder
        return GraphBuilder(self)
