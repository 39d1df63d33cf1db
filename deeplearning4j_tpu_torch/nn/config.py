"""Network configuration (port of ``deeplearning4j_tpu/nn/config.py``).

The fluent builder of the reference: ``NeuralNetConfiguration.builder()
.seed(..).updater(..).compute_data_type(..).list().layer(..)...
.tie_weights(..).set_input_type(..).build()`` gives a
:class:`MultiLayerConfiguration`, and ``.graph_builder()`` a
``nn.graph.GraphBuilder`` for a ``ComputationGraph``. Global defaults
(activation, weight init, dropout, ...) flow into layers that leave them
unset; ``ListBuilder.input_pre_processor`` attaches an input preprocessor
(``nn/preprocessors.py``) before a layer. ``to_json``/``from_json`` write
and read the JAX package's JSON, so a ``configuration.json`` of either
package parses in the other. ``ListBuilder.backprop_type("TruncatedBPTT")``
with ``tbptt_fwd_length(k)`` trains sequences in segments of k steps
(``MultiLayerNetwork._fit_tbptt``); ``tbptt_back_length`` is carried for
the JSON and read nowhere, as in the JAX package.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.layers.base import Layer, layer_from_dict
from deeplearning4j_tpu_torch.nn.preprocessors import preprocessor_from_dict


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

    @staticmethod
    def convolutional(height: int, width: int, channels: int
                      ) -> "InputType":
        """[H, W, C] images (the reference's NCHW data is NHWC here)."""
        return InputType("cnn", (height, width, channels))

    @staticmethod
    def convolutional_3d(d: int, h: int, w: int, c: int) -> "InputType":
        return InputType("cnn3d", (d, h, w, c))

    def to_dict(self):
        return {"kind": self.kind, "shape": list(self.shape)}

    @staticmethod
    def from_dict(d):
        return InputType(d["kind"], tuple(d["shape"]))

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
    backprop_type: str = "Standard"        # or "TruncatedBPTT"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    # per-layer-index input preprocessors (reference
    # ListBuilder.inputPreProcessor(idx, proc))
    input_preprocessors: dict = field(default_factory=dict)
    # weight tying: [dst_layer, dst_param, src_layer, src_param,
    # transpose] — the dst param is not a master parameter; every
    # forward rebuilds it from src, so gradients reach src from both uses
    tied_weights: List[list] = field(default_factory=list)

    def __post_init__(self):
        if self.updater is None:
            self.updater = upd.Sgd(learning_rate=1e-2)

    # -- serialization -----------------------------------------------------
    def to_json(self) -> str:
        """The JAX package's ``MultiLayerConfiguration.to_json``, key for
        key and in its order."""
        return json.dumps({
            "layers": [l.to_dict() for l in self.layers],
            "seed": self.seed,
            "dtype": self.dtype,
            "compute_dtype": self.compute_dtype,
            "updater": self.updater.to_dict(),
            "gradient_normalization": self.gradient_normalization,
            "gradient_normalization_threshold":
                self.gradient_normalization_threshold,
            "input_type": self.input_type.to_dict()
                if self.input_type else None,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "input_preprocessors": {
                str(i): p.to_dict()
                for i, p in self.input_preprocessors.items()},
            "tied_weights": [list(t) for t in self.tied_weights],
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        d = json.loads(s)
        conf = MultiLayerConfiguration(
            layers=[layer_from_dict(ld) for ld in d["layers"]],
            seed=d.get("seed", 12345),
            dtype=d.get("dtype", "float32"),
            compute_dtype=d.get("compute_dtype"),
            updater=upd.updater_from_dict(d["updater"]),
            gradient_normalization=d.get("gradient_normalization"),
            gradient_normalization_threshold=d.get(
                "gradient_normalization_threshold", 1.0),
            backprop_type=d.get("backprop_type", "Standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20))
        if d.get("input_type"):
            conf.input_type = InputType.from_dict(d["input_type"])
        conf.input_preprocessors = {
            int(i): preprocessor_from_dict(pd)
            for i, pd in (d.get("input_preprocessors") or {}).items()}
        conf.tied_weights = [list(t) for t in d.get("tied_weights", [])]
        return conf


class ListBuilder:
    """Reference: NeuralNetConfiguration.ListBuilder."""

    def __init__(self, global_conf: "NeuralNetConfiguration"):
        self._g = global_conf
        self._layers: List[Layer] = []
        self._input_type: Optional[InputType] = None
        self._preprocessors: dict = {}
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

    def input_pre_processor(self, idx: int, proc) -> "ListBuilder":
        """Attach an input preprocessor before layer ``idx`` (reference
        ListBuilder.inputPreProcessor)."""
        self._preprocessors[idx] = proc
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

    def backprop_type(self, t: str) -> "ListBuilder":
        """``"Standard"`` or ``"TruncatedBPTT"`` (reference
        ListBuilder.backpropType)."""
        self._g.backprop_type_ = t
        return self

    def tbptt_fwd_length(self, k: int) -> "ListBuilder":
        """The truncated-BPTT segment length (reference
        tBPTTForwardLength)."""
        self._g.tbptt_fwd_ = k
        return self

    def tbptt_back_length(self, k: int) -> "ListBuilder":
        """Carried for the JSON (reference tBPTTBackwardLength); the
        backward of a segment spans the whole segment."""
        self._g.tbptt_back_ = k
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
            backprop_type=self._g.backprop_type_,
            tbptt_fwd_length=self._g.tbptt_fwd_,
            tbptt_back_length=self._g.tbptt_back_,
            input_preprocessors=dict(self._preprocessors),
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
        self.backprop_type_ = "Standard"
        self.tbptt_fwd_ = 20
        self.tbptt_back_ = 20

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

    def l1_(self, v: float):
        """l1 on every layer that sets none (reference l1)."""
        self.l1 = v
        return self

    def l2_(self, v: float):
        """l2 on every layer that sets none (reference l2)."""
        self.l2 = v
        return self

    def weight_decay_(self, v: float):
        """Decoupled weight decay on every layer that sets none
        (reference weightDecay)."""
        self.weight_decay = v
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
