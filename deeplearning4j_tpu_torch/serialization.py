"""ModelSerializer (port of the zip half of
``deeplearning4j_tpu/serialization.py``) — reference:
``org.deeplearning4j.util.ModelSerializer``.

A checkpoint is the JAX package's zip, entry for entry:

  configuration.json   the network's configuration (``to_json``)
  params.npz           one array per parameter, keyed by its path in the
                       JAX pytree's notation (``['layer_0']/['W']``)
  state.npz            the layers' non-trainable state, keyed the same way
  updater.npz          the optimizer state as the JAX package's optax
                       pytree paths, e.g. for Adam
                       ``.inner_states/['layer_0']/.inner_state/[1]/[0]/.mu/['layer_0']/['W']``
  normalizer.json      optional fitted normaliser statistics
  meta.json            iteration and epoch counters, format version,
                       input shapes

so the bridge is two-way: a JAX zip restores in the port and a port zip
restores in the JAX package, the optimizer state included, and training
resumes on the same trajectory. ``updater.npz``'s paths are built from
the optax chain each side builds: per parameter group (a layer, or a
graph node) the ``multi_transform`` group, the group's chain
(``nn.multilayer.group_chain``: gradient normalisation, the decoupled
weight decay where the layer has one, then the updater; a frozen group's
``set_to_zero`` keeps no state and has no key), the group's own
updater's chain (``Updater.optax_chain``) and the state field
(:data:`_FIELDS`), then the parameter path under the group. The
configuration carries the frozen wrappers, constraints and weight-noise
beans as the JAX JSON does.

``write_model`` is atomic (``resilience/checkpoint.py``): the zip is
built in memory, written to a same-directory tmp file, fsynced and moved
into place with ``os.replace``; the CRC32 manifest follows. The
``ckpt_write`` fault site fires before the zip is built and
``ckpt_commit`` between the fsync and the replace, as in the JAX
package. Restores build the network on ``device`` (the card unless the
caller asks for the CPU). The sharded (orbax) ``ShardedCheckpointer``
comes with ROADMAP A14.
"""
from __future__ import annotations

import io
import json
import os
import zipfile
import zlib
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from deeplearning4j_tpu_torch import tree
from deeplearning4j_tpu_torch.resilience import checkpoint as _ckpt
from deeplearning4j_tpu_torch.resilience import faults as _faults

#: the port's optimizer-state name → (stage of ``Updater.optax_chain``,
#: optax state field); any other name is a ``"moments"`` field of the
#: same name
_FIELDS = {"schedule_count": ("lr", "count")}


def _dict_path(keys) -> str:
    """``('layer_0', 'W')`` as the JAX package writes a pytree path of
    dict keys: ``['layer_0']/['W']``."""
    return "/".join(f"[{k!r}]" for k in keys)


def _named_arrays(t) -> Dict[str, np.ndarray]:
    """The leaves of a nested dict of tensors as host arrays keyed by
    :func:`_dict_path` (``params.npz``, ``state.npz``)."""
    return {_dict_path(path): leaf.detach().cpu().numpy()
            for path, leaf in _paths(t)}


def _paths(t, keys=()):
    """(key path, leaf) of every leaf of a nested dict."""
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _paths(v, keys + (k,))
    else:
        yield keys, t


def _updater_keys(net) -> Dict[Tuple[str, ...], str]:
    """Every leaf of ``net.opt_state`` (by its key path) → its key in the
    JAX package's ``updater.npz``."""
    from deeplearning4j_tpu_torch.nn.multilayer import group_chain
    layers = net._group_layers()
    out = {}
    for group, state in net.opt_state.items():
        if not state:               # a frozen group: optax's EmptyState
            continue
        at = group_chain(layers[group]).index("updater")
        updater = net._chains[group].updater
        for path, _ in _paths(state):
            stage, field = _FIELDS.get(path[0], ("moments", path[0]))
            key = (f".inner_states/[{group!r}]/.inner_state/[{at}]/"
                   f"[{updater.optax_chain.index(stage)}]/.{field}")
            if len(path) > 1:       # a tree over the group's parameters
                key += "/" + _dict_path((group,) + path[1:])
            out[(group,) + path] = key
    return out


def _live_opt_state(net):
    """``net.opt_state``, or — while a ZeRO ``ParallelWrapper`` owns it
    (it moved the whole state to the host at its first sharded step and
    trains 1/N shards) — the shards gathered into the whole layout, a
    collective every rank of the wrapper's group joins. Any later
    assignment of ``net.opt_state`` (a restore, a replicated fit) breaks
    the identity and takes the state back."""
    wref = getattr(net, "_zero_wrapper", None)
    w = wref() if wref is not None else None
    if (w is not None and w._dp_state is not None
            and net.opt_state is w._evicted_opt):
        return w.gather_opt_state()
    return net.opt_state


def _writestr_det(zf: zipfile.ZipFile, name: str, data) -> None:
    """A zip entry with a fixed timestamp, so the same content gives the
    same archive."""
    info = zipfile.ZipInfo(name, date_time=(1980, 1, 1, 0, 0, 0))
    info.compress_type = zipfile.ZIP_DEFLATED
    zf.writestr(info, data)


def _save_npz(zf: zipfile.ZipFile, name: str, arrays) -> None:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    _writestr_det(zf, name, buf.getvalue())


def _load_into(zf: zipfile.ZipFile, name: str, template, key_of):
    """A tree of ``template``'s structure, each leaf read from the npz
    entry ``name`` under ``key_of(path)`` and checked against the
    template leaf's shape; it takes that leaf's dtype and device."""
    with zf.open(name) as f:
        data = np.load(io.BytesIO(f.read()))

        def load(path, t):
            key = key_of(path)
            if key not in data:
                raise ValueError(f"checkpoint missing leaf {key}")
            a = tree.to_torch(data[key])
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"checkpoint leaf {key}: shape "
                                 f"{tuple(a.shape)} != {tuple(t.shape)}")
            return a.to(t.device, dtype=t.dtype)

        return tree.map_with_path(load, template)


class ModelSerializer:
    @staticmethod
    def write_model(net, path, save_updater: bool = True,
                    normalizer=None) -> None:
        """Write ``net`` (a ``MultiLayerNetwork`` or ``ComputationGraph``)
        to the zip ``path``, atomically, with its optimizer state when
        ``save_updater`` and ``normalizer``'s statistics when given."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        _faults.inject("ckpt_write")
        meta = {"iteration": net.iteration, "epoch": net.epoch,
                "format_version": _ckpt.FORMAT_VERSION}
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
            _writestr_det(zf, "configuration.json", net.conf.to_json())
            _save_npz(zf, "params.npz", _named_arrays(net.params))
            _save_npz(zf, "state.npz", _named_arrays(net.state))
            opt_state = _live_opt_state(net)
            if save_updater and opt_state is not None:
                keys = _updater_keys(net)
                _save_npz(zf, "updater.npz", {
                    keys[(g,) + p]: leaf.detach().cpu().numpy()
                    for g, st in opt_state.items()
                    for p, leaf in _paths(st)})
            if normalizer is not None:
                _writestr_det(zf, "normalizer.json",
                              json.dumps(normalizer.state_dict()))
            ishape = getattr(net, "_input_shape", None)
            if ishape:
                meta["input_shape"] = list(ishape)
            shapes = getattr(net, "_shapes", None)
            if shapes and hasattr(net.conf, "inputs"):
                meta["input_shapes"] = {
                    n: list(shapes[n]) for n in net.conf.inputs}
            _writestr_det(zf, "meta.json", json.dumps(meta))
        data = buf.getvalue()
        tmp = _ckpt.tmp_path_for(path)
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            _faults.inject("ckpt_commit")
            os.replace(tmp, path)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        _ckpt.fsync_dir(path.parent)
        # the manifest after the replace: losing it to a crash only
        # downgrades verification to the zip-level checks
        _ckpt.write_manifest(path, {"iteration": net.iteration,
                                    "epoch": net.epoch},
                             crc32=zlib.crc32(data) & 0xFFFFFFFF)

    @staticmethod
    def _restore(zf: zipfile.ZipFile, net, meta: dict,
                 load_updater: bool):
        net.params = _load_into(zf, "params.npz", net.params, _dict_path)
        net.state = _load_into(zf, "state.npz", net.state, _dict_path)
        if load_updater and "updater.npz" in zf.namelist():
            keys = _updater_keys(net)
            net.opt_state = _load_into(zf, "updater.npz", net.opt_state,
                                       keys.__getitem__)
        net.iteration = meta.get("iteration", 0)
        net.epoch = meta.get("epoch", 0)
        return net

    @staticmethod
    def restore_multi_layer_network(path, load_updater: bool = True,
                                    device="cuda"):
        """The ``MultiLayerNetwork`` of the zip ``path``, built on
        ``device``, with its optimizer state when ``load_updater``."""
        from deeplearning4j_tpu_torch.nn.config import \
            MultiLayerConfiguration
        from deeplearning4j_tpu_torch.nn.multilayer import \
            MultiLayerNetwork
        with zipfile.ZipFile(Path(path)) as zf:
            conf = MultiLayerConfiguration.from_json(
                zf.read("configuration.json").decode())
            meta = json.loads(zf.read("meta.json").decode())
            net = MultiLayerNetwork(conf)
            ishape = tuple(meta.get("input_shape") or ()) or None
            net.init(input_shape=ishape, device=device)
            return ModelSerializer._restore(zf, net, meta, load_updater)

    @staticmethod
    def restore_computation_graph(path, load_updater: bool = True,
                                  device="cuda"):
        """The ``ComputationGraph`` of the zip ``path``, built on
        ``device``, with its optimizer state when ``load_updater``."""
        from deeplearning4j_tpu_torch.nn.graph import (
            ComputationGraph, ComputationGraphConfiguration)
        with zipfile.ZipFile(Path(path)) as zf:
            conf = ComputationGraphConfiguration.from_json(
                zf.read("configuration.json").decode())
            meta = json.loads(zf.read("meta.json").decode())
            net = ComputationGraph(conf)
            ishapes = meta.get("input_shapes")
            net.init(input_shapes={k: tuple(v)
                                   for k, v in ishapes.items()}
                     if ishapes else None, device=device)
            return ModelSerializer._restore(zf, net, meta, load_updater)

    @staticmethod
    def restore_normalizer(path):
        """The normaliser stored in the zip ``path``, or None."""
        from deeplearning4j_tpu_torch.data.normalizers import \
            normalizer_from_state
        with zipfile.ZipFile(Path(path)) as zf:
            if "normalizer.json" not in zf.namelist():
                return None
            return normalizer_from_state(
                json.loads(zf.read("normalizer.json").decode()))


class ShardedCheckpointer:
    """The JAX package's orbax-backed sharded checkpointer: not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ShardedCheckpointer (orbax, sharded and async) comes with "
            "ROADMAP A14; ModelSerializer writes the single-host zip")
