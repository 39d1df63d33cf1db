"""Warmup — build every declared shape bucket before traffic (port of
``deeplearning4j_tpu/perf/warmup.py``).

The training and serving stacks bound their programs by snapping shapes
to buckets (``BucketedSequenceIterator`` time buckets,
``ParallelInference`` batch buckets, the power-of-two prompt buckets of
``generate`` and the gateway), but each bucket still pays its build at
FIRST use, on a real step or request. This module moves those builds
ahead of traffic, from abstract shapes (:func:`sds`: no data), through
the same sentried entry points live calls use: on the card a capturable
entry point captures its CUDA graph now, and the first real step or
request on a warmed bucket adds no trace (``perf.sentry.total_traces``).

Warmup changes no state: the parameters, optimizer and layer state,
``iteration``, the draws of the next ``fit`` and the serving pool stay
as they were (a graph's warm run works on scratch copies of the state it
is given, and puts back the generators it drew from).

Use::

    specs = warmup_plan([32, 64], feature_dims=(64,), label_dims=(10,))
    net.warmup(specs)                       # train step + output
    pi.warmup(feature_shape=(64,))          # every serving bucket
    model.warmup_decode(net, batch_sizes=(1, 8), prompt_lens=(1024,),
                        n_new=128)          # generate()'s buckets
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple, Union

from deeplearning4j_tpu_torch.perf.sentry import ShapeDtype

ShapeLike = Union[Tuple[int, ...], Dict[str, Tuple[int, ...]],
                  Sequence[Tuple[int, ...]]]


def sds(shape, dtype="float32", device="cuda") -> ShapeDtype:
    """Abstract tensor stand-in (shape, dtype, device; no storage)."""
    import torch
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return ShapeDtype(tuple(int(n) for n in shape), dt,
                      torch.device(device))


@dataclass(frozen=True)
class WarmupSpec:
    """One shape bucket to build ahead. ``features``/``labels`` are
    batch-inclusive shape tuples — or, for a ComputationGraph, a dict
    (by input name) / sequence (by output position) of them."""
    features: ShapeLike
    labels: Optional[ShapeLike] = None
    features_mask: Optional[Tuple[int, ...]] = None
    labels_mask: Optional[Tuple[int, ...]] = None
    dtype: str = "float32"
    labels_dtype: Optional[str] = None    # None -> same as dtype
    train: bool = True                    # warm the train step
    serve: bool = True                    # warm the output program
    steps_per_loop: int = 0               # >0: also warm the K-step loop


def _label_dtype(spec: WarmupSpec) -> str:
    return spec.labels_dtype or spec.dtype


def _feature_sds(spec: WarmupSpec, conf, device):
    """Spec features -> the network's feed structure."""
    graph_inputs = getattr(conf, "inputs", None)
    f = spec.features
    if graph_inputs is not None:
        if isinstance(f, dict):
            return {n: sds(s, spec.dtype, device) for n, s in f.items()}
        shapes = [f] if isinstance(f[0], int) else list(f)
        return {n: sds(s, spec.dtype, device)
                for n, s in zip(graph_inputs, shapes)}
    return sds(f, spec.dtype, device)


def _label_sds(spec: WarmupSpec, conf, device):
    graph_inputs = getattr(conf, "inputs", None)
    y = spec.labels
    if y is None:
        raise ValueError("WarmupSpec.labels is required for train "
                         "warmup (set train=False for serve-only "
                         "buckets)")
    dt = _label_dtype(spec)
    if graph_inputs is not None:
        if isinstance(y, dict):
            shapes = list(y.values())
        elif isinstance(y[0], int):
            shapes = [y]            # one output, bare shape tuple
        else:
            shapes = list(y)
        return [sds(s, dt, device) for s in shapes]
    return sds(y, dt, device)


def _mask_sds(shape, device):
    # the networks feed masks as float32, whatever the features' dtype
    return sds(shape, "float32", device) if shape else None


def warmup_network(net, specs: Iterable[WarmupSpec]) -> Dict[str, Any]:
    """Build a ``MultiLayerNetwork``/``ComputationGraph``'s train step,
    K-step loop and output program for every spec. The live parameter,
    optimizer-state and layer-state trees are the structure donors (a
    warmup never writes them) and the data shapes abstract. Returns
    ``{"compiled": n_new_executables, "seconds": build_wall_time}``."""
    from deeplearning4j_tpu_torch.rng import fold_in

    if not getattr(net, "params", None):
        raise RuntimeError("warmup needs an initialized network — "
                           "call init() first")
    graph = hasattr(net.conf, "inputs")
    dev = net.device
    compiled, seconds = 0, 0.0
    rng = fold_in(net.conf.seed, 0)
    trees = (net.params, net.opt_state, net.state)
    for spec in specs:
        x = _feature_sds(spec, net.conf, dev)
        fm = _mask_sds(spec.features_mask, dev)
        if spec.train:
            y = _label_sds(spec, net.conf, dev)
            lm = _mask_sds(spec.labels_mask, dev)
            if graph:
                masks = {} if fm is None else {net.conf.inputs[0]: fm}
                lmasks = {} if lm is None else {net.conf.outputs[0]: lm}
                args = (*trees, x, y, masks, lmasks, rng)
            else:
                args = (*trees, x, y, fm, lm, rng)
            dt = net._step_program().warmup(*args)
            compiled += dt > 0
            seconds += dt
        if spec.train and spec.steps_per_loop > 0 \
                and not spec.features_mask and not spec.labels_mask:
            k = spec.steps_per_loop
            stack = lambda a: ShapeDtype((k,) + tuple(a.shape), a.dtype,
                                         a.device)
            rngs = (rng,) * k
            if graph:
                xs = {n: stack(s) for n, s in x.items()}
                ys = [stack(s) for s in _label_sds(spec, net.conf, dev)]
                dt = net._loop_program().warmup(*trees, xs, ys, {}, {},
                                                rngs)
            else:
                dt = net._loop_program().warmup(
                    *trees, stack(x), stack(_label_sds(spec, net.conf,
                                                       dev)), rngs)
            compiled += dt > 0
            seconds += dt
            # the loop runs the step's executable: on the card its graph
            # for one step's shapes is captured now
            net._step_program().prepare(*args)
        if spec.serve:
            if graph:
                dt = net._output_program().warmup(net.params, net.state,
                                                  x, {}, False)
            else:
                dt = net._output_program().warmup(net.params, net.state,
                                                  x, fm, False)
            compiled += dt > 0
            seconds += dt
    return {"compiled": compiled, "seconds": seconds}


def warmup_inference(pi, feature_shape: Tuple[int, ...],
                     dtype: str = "float32") -> Dict[str, Any]:
    """Build a ``ParallelInference`` queue's forward for every declared
    batch bucket. ``feature_shape`` is ONE example's shape (no batch
    dim)."""
    specs = [WarmupSpec(features=(b,) + tuple(feature_shape),
                        dtype=dtype, train=False, serve=True)
             for b in pi.buckets]
    return warmup_network(pi.net, specs)


def warmup(target, specs: Optional[Iterable[WarmupSpec]] = None,
           **kw) -> Dict[str, Any]:
    """Generic entry: dispatches on the target's type (a network, or a
    ``ParallelInference``)."""
    if hasattr(target, "buckets") and hasattr(target, "net"):
        return warmup_inference(target, **kw)
    return warmup_network(target, specs or [])


def warmup_plan(source, *, batch_size: Optional[int] = None,
                feature_dims: Tuple[int, ...] = (),
                label_dims: Optional[Tuple[int, ...]] = None,
                seq_labels: bool = True,
                dtype: str = "float32",
                labels_dtype: Optional[str] = None,
                train: bool = True, serve: bool = True,
                steps_per_loop: int = 0) -> list:
    """Derive the WarmupSpec set from an existing bucket table.

    ``source`` is one of:

    - a ``BucketedSequenceIterator`` (or anything with TIME buckets in
      ``.buckets`` and a ``.base``): one spec per bucket length,
      features ``[batch_size, T, *feature_dims]`` with the [B, T] masks
      the iterator attaches when it pads; labels ``[B, T, *label_dims]``
      when ``seq_labels`` else ``[B, *label_dims]``;
    - a ``ParallelInference`` (BATCH buckets in ``.buckets``): one
      serve-only spec per bucket, features ``[bucket, *feature_dims]``;
    - a plain iterable of ints: treated as batch buckets.
    """
    time_bucketed = hasattr(source, "buckets") and hasattr(source, "base")
    if not time_bucketed:
        buckets = (source.buckets if hasattr(source, "buckets")
                   else list(source))
        return [WarmupSpec(
            features=(b,) + tuple(feature_dims),
            labels=((b,) + tuple(label_dims)
                    if label_dims is not None else None),
            dtype=dtype, labels_dtype=labels_dtype,
            train=train and label_dims is not None, serve=serve)
            for b in buckets]
    bsz = batch_size or getattr(source, "batch_size", None)
    if not bsz:
        raise ValueError("warmup_plan needs batch_size for "
                         "time-bucketed sources")
    out = []
    for t in source.buckets:
        lab = None
        lmask = None
        if label_dims is not None:
            lab = ((bsz, t) + tuple(label_dims) if seq_labels
                   else (bsz,) + tuple(label_dims))
            lmask = (bsz, t) if seq_labels else None
        out.append(WarmupSpec(
            features=(bsz, t) + tuple(feature_dims),
            labels=lab, features_mask=(bsz, t), labels_mask=lmask,
            dtype=dtype, labels_dtype=labels_dtype,
            train=train and lab is not None, serve=serve,
            steps_per_loop=steps_per_loop))
    return out
