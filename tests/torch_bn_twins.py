"""The batch-norm twins of ``ParallelWrapper`` (ROADMAP A15), shared by
``tests/test_torch_parallel.py`` (SYNC, ENCODED, AVERAGING, ASYNC, and
the bytes of a SYNC step) and ``tests/test_torch_zero.py`` (SYNC under
the sharded update, with and without the gather overlap), both at 2 gloo
ranks: the JAX side, run on 2 of this process's CPU devices, and the
checks. The net is ``tests/torch_dp_worker.py``'s ``bn_conf``: a conv
net with a batch norm over conv channels and one over dense features.

What the JAX wrapper computes, mode by mode (``deeplearning4j_tpu/
parallel/wrapper.py``): SYNC is one ``jit`` over the global batch, so
the batch norms normalise with the statistics of all 8 rows, and the
running statistics come from them; the other modes are ``shard_map``
steps whose new state each device computes from its own 4 rows and
returns unchecked under ``P()``, so ``net.state`` reads device 0's chain.
The port's ranks must end with that state, every rank alike.

Bands (``tests/test_torch_parallel.py``'s for the wrapper): each step's
loss 1e-5 relative; the params and the running means and variances
after 3 steps 99.9 % within 1e-6, at most the mode's share past 1e-4
(1e-5 in SYNC and AVERAGING, 1e-4 in ENCODED and ASYNC, where a
gradient within rounding of ±τ may take another code), all within
2 · lr · steps; every rank's params and state equal to the bit.
The SYNC step's all-reduced bytes lie within [1.00, 1.05] of the fp32
gradient bytes (``tests/test_collective_volume.py:46``'s reading: the
batch-norm statistics, forward and backward, and the loss ride along),
with one all-reduce a gradient leaf: one gradient family a step.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import InputType as JaxInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.updaters import Adam as JaxAdam
from deeplearning4j_tpu.parallel import ParallelWrapper as JaxWrapper

import torch_dp_worker as worker

LOSS_RTOL = 1e-5
STEPS = 3
#: the share of params and statistics allowed past 1e-4, by mode
OFF_SHARE = {"sync": 1e-5, "averaging": 1e-5, "encoded": 1e-4,
             "async": 1e-4, "sharded": 1e-5, "overlap": 1e-5}
#: the SYNC step's all-reduced bytes over the fp32 gradient bytes
VOLUME_BAND = (1.00, 1.05)

_JAX = types.SimpleNamespace(
    NeuralNetConfiguration=JaxConf, InputType=JaxInputType, Adam=JaxAdam,
    **{k: getattr(jlayers, k) for k in (
        "ConvolutionLayer", "BatchNormalization", "SubsamplingLayer",
        "DenseLayer", "OutputLayer")})


def _flat(tree_, prefix):
    out = {}
    for k, v in tree_.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def bn_inputs(inp):
    """Add the JAX net's initial weights and three global batches of
    ``worker.BN_ROWS`` rows to ``inp``."""
    net = JaxNet(worker.bn_conf(_JAX)).init()
    inp.update(_flat(jax.tree.map(np.asarray, net.params), "bn/weights"))
    rng = np.random.default_rng(21)
    for i in range(STEPS):
        inp[f"bn/x{i}"] = rng.standard_normal(
            (worker.BN_ROWS,) + worker.BN_SHAPE).astype(np.float32)
        inp[f"bn/y{i}"] = np.eye(worker.BN_CLASSES, dtype=np.float32)[
            rng.integers(0, worker.BN_CLASSES, worker.BN_ROWS)]


def jax_bn(inp, modes):
    """Each mode of ``modes`` on 2 devices, one ``fit`` a batch, from the
    weights of ``inp``: {mode: (losses, params, state)}."""
    kws = {"sharded": {"sharded_update": True},
           "overlap": {"sharded_update": True, "gather_overlap": True}}
    out = {}
    for mode in modes:
        net = JaxNet(worker.bn_conf(_JAX)).init()
        weights = {name: {} for name in net.params}   # pooling holds none
        for key, a in inp.items():
            if key.startswith("bn/weights/"):
                name, leaf = key[len("bn/weights/"):].split("/")
                weights[name][leaf] = jnp.asarray(a)   # a fresh copy: the
        net.params = weights                       # step donates it
        w = JaxWrapper(net, workers=2, averaging_frequency=2,
                       prefetch_buffer=0, **kws.get(mode, {"mode": mode}))
        losses = []
        for i in range(STEPS):
            w.fit([JaxDataSet(inp[f"bn/x{i}"], inp[f"bn/y{i}"])])
            losses.append(float(net.score_))
        out[mode] = (losses,
                     _flat(jax.tree.map(np.asarray, net.params), "params"),
                     _flat(jax.tree.map(np.asarray, net.state), "state"))
    return out


def _band(got, ref, off_share, what):
    assert set(got) == set(ref), (what, sorted(got), sorted(ref))
    d = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
    assert (d <= 1e-6).mean() >= 0.999, (what, (d <= 1e-6).mean())
    assert (d > 1e-4).mean() <= off_share, (what, (d > 1e-4).sum())
    assert d.max() <= 2 * worker.BN_LR * STEPS, (what, d.max())


def check_bn(ranks, ref, mode):
    """Every rank's losses, params and running statistics against the JAX
    wrapper's in the mode's bands, and equal to the bit across ranks."""
    losses, params, state = ref
    assert any(k.endswith("/mean") for k in state)
    for res, log in ranks:
        np.testing.assert_allclose(log[f"bn/{mode}/losses"], losses,
                                   rtol=LOSS_RTOL, atol=0)
        for what, want in (("params", params), ("state", state)):
            got = {k[len(f"bn/{mode}/"):]: v for k, v in res.items()
                   if k.startswith(f"bn/{mode}/{what}/")}
            _band(got, want, OFF_SHARE[mode], f"{mode} {what}")
    (a, _), *rest = ranks
    keys = [k for k in a if k.startswith(f"bn/{mode}/")]
    assert keys
    for b, _ in rest:
        for k in keys:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def check_volume(log):
    """One SYNC step's all-reduced bytes against the fp32 gradient
    bytes, and one all-reduce a gradient leaf."""
    v = log["bn/volume"]
    assert v["grad_calls"] == v["leaves"], v
    assert v["grad_bytes"] == v["param_bytes"], v
    lo, hi = VOLUME_BAND
    assert lo * v["param_bytes"] <= v["total"] <= hi * v["param_bytes"], v
