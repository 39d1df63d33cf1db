"""Transfer learning (port of ``deeplearning4j_tpu/nn/transferlearning.py``)
— reference: ``org.deeplearning4j.nn.transferlearning.TransferLearning``
(+``.Builder``), ``FineTuneConfiguration``, ``TransferLearningHelper``.

``TransferLearning.builder(net)...build()`` makes a NEW
``MultiLayerNetwork`` from a trained one: a frozen feature-extractor
prefix (each layer wrapped in ``FrozenLayer``), output layers removed,
layers replaced, appended or widened (``n_out_replace``), and a
``FineTuneConfiguration`` written onto every layer that still trains.
Kept layers keep their trained parameters and state as copies
(``clone()``: the new net never shares a tensor with the source);
replaced, widened and appended layers, and the layer after a widened
one, draw fresh ones from ``torch.Generator().manual_seed(conf.seed +
1)``, as the JAX build draws from ``PRNGKey(conf.seed + 1)`` (the
values differ, the rules do not). The new net lives on the source net's
device. Tied weights survive only between kept, un-reinitialised
layers; a tie dropped because its source went away fills the kept
destination with the trained tied value.

``TransferLearningHelper`` runs the frozen prefix once
(``featurize``) and trains a tail-only network on the features
(``fit_featurized``), copying the tail's parameters back into the full
net; a tie across the split is refused.

Two departures from the JAX file, where it is at fault: a
``FineTuneConfiguration`` skips ``FrozenLayerWithBackprop`` as it skips
``FrozenLayer`` (``ROADMAP.md`` C7: the JAX package writes ``l2`` and
``weight_decay`` onto it, which then move its weights), and the build
and the helper's tail apply the input preprocessors (shape inference
and index) where the JAX ones ignore them.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from deeplearning4j_tpu_torch import dtypes, tree
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.layers.extra import FrozenLayerWithBackprop
from deeplearning4j_tpu_torch.nn.layers.special import FrozenLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, _lname


def _copy(t):
    """A copy of a parameter or state tree (never a view of it)."""
    return tree.map_(torch.clone, t)


@dataclass
class FineTuneConfiguration:
    """Overrides written onto every layer of the new net that is not
    frozen (reference FineTuneConfiguration): ``updater`` and ``seed``
    replace the network's; ``learning_rate``, ``l1``, ``l2``,
    ``weight_decay`` and ``dropout`` are set on each such layer."""
    updater: Any = None
    learning_rate: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    weight_decay: Optional[float] = None
    dropout: Optional[float] = None
    seed: Optional[int] = None

    def _apply(self, conf, layers: List[Layer]) -> None:
        if self.updater is not None:
            conf.updater = self.updater
        if self.seed is not None:
            conf.seed = self.seed
        for layer in layers:
            if isinstance(layer, (FrozenLayer, FrozenLayerWithBackprop)):
                continue
            if self.learning_rate is not None:
                layer.learning_rate = self.learning_rate
            for f in ("l1", "l2", "weight_decay", "dropout"):
                v = getattr(self, f)
                if v is not None:
                    setattr(layer, f, v)


class TransferLearning:
    """Reference: TransferLearning.Builder (the MultiLayerNetwork
    flavour)."""

    class Builder:
        def __init__(self, net: MultiLayerNetwork):
            if not net.params:
                raise ValueError("source network is not initialized")
            self._net = net
            self._ftc: Optional[FineTuneConfiguration] = None
            self._freeze_until: Optional[int] = None
            self._n_removed = 0
            self._appended: List[Layer] = []
            self._replacements: Dict[int, Layer] = {}
            self._nout_replace: Dict[int, tuple] = {}

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._ftc = ftc
            return self

        def set_feature_extractor(self, layer_idx: int):
            """Freeze layers 0 .. ``layer_idx``, both included (reference
            setFeatureExtractor)."""
            self._freeze_until = layer_idx
            return self

        def remove_output_layer(self):
            self._n_removed += 1
            return self

        def remove_layers_from_output(self, n: int):
            self._n_removed += int(n)
            return self

        def add_layer(self, layer: Layer):
            self._appended.append(layer)
            return self

        def replace_layer(self, idx: int, layer: Layer):
            self._replacements[idx] = layer
            return self

        def n_out_replace(self, idx: int, n_out: int,
                          weight_init: Optional[str] = None):
            """Change layer ``idx``'s output width: it and the next
            layer's input side are re-initialised (reference
            nOutReplace)."""
            self._nout_replace[idx] = (int(n_out), weight_init)
            return self

        def build(self) -> MultiLayerNetwork:
            src = self._net
            n_keep = len(src.layers) - self._n_removed
            if n_keep < 0:
                raise ValueError("removed more layers than the net has")
            layers: List[Layer] = [copy.deepcopy(l)
                                   for l in src.layers[:n_keep]]
            params = {_lname(i): _copy(src.params[_lname(i)])
                      for i in range(n_keep)}
            state = {_lname(i): _copy(src.state[_lname(i)])
                     for i in range(n_keep)}
            reinit = set()          # indices that get fresh parameters
            for idx, layer in self._replacements.items():
                if idx >= n_keep:
                    raise ValueError(f"replace_layer({idx}) out of range")
                layers[idx] = copy.deepcopy(layer)
                reinit.add(idx)
            for idx, (n_out, winit) in self._nout_replace.items():
                if idx >= n_keep:
                    raise ValueError(f"n_out_replace({idx}) out of range")
                layers[idx].n_out = n_out
                if winit:
                    layers[idx].weight_init = winit
                reinit.add(idx)
                if idx + 1 < n_keep:
                    reinit.add(idx + 1)     # its input side changed
            base = len(layers)
            layers.extend(copy.deepcopy(l) for l in self._appended)
            reinit.update(range(base, len(layers)))
            if self._freeze_until is not None:
                for i in range(min(self._freeze_until + 1, len(layers))):
                    if not isinstance(layers[i], FrozenLayer):
                        layers[i] = FrozenLayer(underlying=layers[i])

            conf = copy.deepcopy(src.conf)
            conf.layers = layers
            # a tie survives only between kept, un-reinitialised layers:
            # a fresh head on a tied LM gets its own W
            old_ties = list(conf.tied_weights)
            conf.tied_weights = [
                t for t in old_ties
                if (t[0] < n_keep and t[2] < n_keep
                    and t[0] not in reinit and t[2] not in reinit)]
            # a dropped tie whose kept destination is untouched keeps
            # computing what it did: the trained tied value, read from
            # the source's masters (its source layer may be removed)
            surviving = {(t[0], t[1]) for t in conf.tied_weights}
            dropped_fill = {}
            for di, dn, si, sn, tr in old_ties:
                if (di, dn) in surviving or di >= n_keep or di in reinit:
                    continue
                src_p = src.params.get(_lname(si), {})
                if sn in src_p:
                    val = src_p[sn].clone()
                    dropped_fill[(di, dn)] = val.T.contiguous() if tr \
                        else val
            if self._ftc is not None:
                self._ftc._apply(conf, layers)
            new = MultiLayerNetwork(conf)
            new._check_supported()
            new.device = src.device
            dtype = dtypes.resolve(conf.dtype)
            gen = torch.Generator().manual_seed(conf.seed + 1)
            shape = src._input_shape
            new._input_shape = shape
            new._layer_shapes = []
            tied_dst = {(t[0], t[1]) for t in conf.tied_weights}
            for i, layer in enumerate(layers):
                proc = conf.input_preprocessors.get(i)
                if proc is not None:
                    shape = proc.output_shape(shape)
                p, s, shape = layer.init(gen, shape, dtype)
                if i in reinit or _lname(i) not in params:
                    new.params[_lname(i)] = tree.map_(
                        lambda t: t.to(new.device), p)
                    new.state[_lname(i)] = tree.map_(
                        lambda t: t.to(new.device), s)
                else:
                    # trained copies win; a fresh leaf fills a param the
                    # source never kept as a master (a dropped tie's
                    # destination), never one a surviving tie rebuilds
                    kept = params[_lname(i)]
                    merged = {k: v.to(new.device) for k, v in p.items()
                              if (i, k) not in tied_dst and k not in kept}
                    merged.update(kept)
                    for (di, dn), val in dropped_fill.items():
                        if di == i:
                            merged[dn] = val
                    new.params[_lname(i)] = merged
                    new.state[_lname(i)] = state[_lname(i)]
                new._layer_shapes.append(shape)
            new._output_shape = shape
            new._build_optimizer()
            return new

    @staticmethod
    def builder(net: MultiLayerNetwork) -> "TransferLearning.Builder":
        return TransferLearning.Builder(net)


class TransferLearningHelper:
    """Featurize once, train the unfrozen tail (reference
    TransferLearningHelper: featurize(DataSet) and fitFeaturized). With
    ``frozen_until`` the net is first rebuilt with layers 0 ..
    ``frozen_until`` frozen; the tail starts after its last
    ``FrozenLayer``."""

    def __init__(self, net: MultiLayerNetwork,
                 frozen_until: Optional[int] = None):
        if frozen_until is not None:
            net = (TransferLearning.builder(net)
                   .set_feature_extractor(frozen_until).build())
        self.net = net
        idx = -1
        for i, layer in enumerate(net.layers):
            if isinstance(layer, FrozenLayer):
                idx = i
        self._split = split = idx + 1       # the first unfrozen layer
        if split == 0:
            raise ValueError("network has no frozen prefix")
        tail_conf = copy.deepcopy(net.conf)
        tail_conf.layers = net.layers[split:]
        tail_conf.input_preprocessors = {
            i - split: p for i, p in net.conf.input_preprocessors.items()
            if i >= split}
        # ties are indexed by layer: onto the tail's indices; a tie
        # across the split has no source on the tail
        retied = []
        for di, dn, si, sn, tr in net.conf.tied_weights:
            if di >= split and si >= split:
                retied.append([di - split, dn, si - split, sn, tr])
            elif di >= split or si >= split:
                raise ValueError(
                    f"tie_weights layer_{di}.{dn} <- layer_{si}.{sn} "
                    f"crosses the frozen/unfrozen split at {split}; "
                    f"freeze through both ends or neither")
        tail_conf.tied_weights = retied
        tail = MultiLayerNetwork(tail_conf)
        tail.device = net.device
        for i in range(split, len(net.layers)):
            tail.params[_lname(i - split)] = _copy(net.params[_lname(i)])
            tail.state[_lname(i - split)] = _copy(net.state[_lname(i)])
        tail._input_shape = net._layer_shapes[split - 1]
        tail._layer_shapes = net._layer_shapes[split:]
        tail._output_shape = net._output_shape
        tail._build_optimizer()
        self._tail = tail

    def unfrozen_mln(self) -> MultiLayerNetwork:
        return self._tail

    def featurize(self, dataset) -> DataSet:
        """A host ``DataSet`` of the frozen prefix's output for
        ``dataset``'s features (run on the net's device, in the
        parameters' dtype, as the JAX ``activate_selected_layers``), with
        its labels (reference featurize)."""
        feats = self.net.activate_selected_layers(0, self._split - 1,
                                                  dataset.features)
        return DataSet(feats.cpu().numpy(), dataset.labels)

    def fit_featurized(self, dataset_or_iter, epochs: int = 1):
        """Train the tail on featurized data, then copy its parameters
        and state back into the full net."""
        self._tail.fit(dataset_or_iter, epochs=epochs)
        for i in range(self._split, len(self.net.layers)):
            self.net.params[_lname(i)] = _copy(
                self._tail.params[_lname(i - self._split)])
            self.net.state[_lname(i)] = _copy(
                self._tail.state[_lname(i - self._split)])
        return self

    def output(self, x):
        return self.net.output(x)
