"""The ZeRO twins at 2 gloo ranks (``tests/torch_zero_twins.py``, whose
docstring states what each holds and within which band;
``tests/test_torch_zero_4.py`` runs them at 4), the ComputationGraph
under the wrapper at 2 ranks, and the layout's host-side pieces in this
process against the JAX package's.

The graph twins (rank side in ``tests/torch_zero_worker.py``
``graph_cases``), from the JAX weights and the same global batches, each
rank fed its block of rows:
- ``tests/test_parallel.py:328``: the 2-input, 2-output graph trained
  one epoch (8 global batches of 32) in SYNC, ENCODED, AVERAGING
  (averaging every 2 steps) and ASYNC, and in SYNC under the sharded
  update, against the JAX wrapper at ``workers=2``: every step's loss
  within 1e-5 relative, the params in ``tests/test_torch_parallel.py``'s
  bands for the mode (99.9 % within 1e-6, at most 1e-5 of them past 1e-4
  in SYNC and AVERAGING and 1e-4 in ENCODED and ASYNC, all within
  2 · lr · steps); both ranks' params equal to the bit; the two outputs'
  shapes;
- ``:345``: ``SparkComputationGraph`` over both training masters, three
  epochs: a finite score under the JAX test's bar of 1.2, and both
  ranks' params equal to the bit;
- BertTiny's classifier (dropout 0, the model's AdamW with biases and
  norms undecayed) under the sharded update, 3 steps of 4 rows: against
  replicated SYNC in the JAX band of ``test_sharded_update.py:69``, and
  against the JAX sharded wrapper in ``tests/test_torch_bert.py``'s f32
  bands (losses 1e-5 relative; each tensor 99.5 % within 1e-6 and all
  within lr/3);
- the conv net with batch norm of ``tests/torch_bn_twins.py`` under the
  sharded update, with and without the gather overlap: each rank's params
  and running statistics against the JAX wrapper's (a ``shard_map`` step:
  device 0's state), in that file's bands, every rank's equal;
- a masked batch under the wrapper raises ``NotImplementedError`` naming
  the JAX adapter's gap (a ``DataSet`` with a labels mask, a
  ``MultiDataSet`` with features masks).

In this process: ``FlatShardLayout``'s sizes, padding, flatten, shard
and unflatten, ``sharded_leaf`` and ``per_device_bytes`` against the JAX
package's on the same trees (exact), and the twin of
``tests/test_elastic.py:276`` (``repad_flat_leaves`` 8 → 4 → 8 bit for
bit, scalars through, ``LayoutMismatch`` on a non-zero tail).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.config import InputType as JaxInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.nn.vertices import ElementWiseVertex as JaxEWV
from deeplearning4j_tpu.parallel import ParallelWrapper as JaxWrapper
from deeplearning4j_tpu.parallel import zero as jzero
from deeplearning4j_tpu.zoo.bert import BertTiny as JaxBertTiny
from deeplearning4j_tpu_torch import tree
from deeplearning4j_tpu_torch.parallel import zero as pzero

import torch_bn_twins as bn
import torch_zero_twins as twins
import torch_zero_worker as worker
from torch_zero_twins import *  # noqa: F401,F403  (the twins, collected here)

GRAPH_LR = 0.05
BERT_LR = 2e-5           # BertTiny's default AdamW learning rate
BERT_B = 4
#: the share of params allowed past 1e-4, by mode (test_torch_parallel.py)
OFF_SHARE = {"sync": 1e-5, "averaging": 1e-5, "encoded": 1e-4,
             "async": 1e-4, "sharded": 1e-5}
#: the batch-norm twins' sharded modes (``tests/torch_bn_twins.py``)
BN_MODES = ("sharded", "overlap")


@pytest.fixture(scope="module")
def world():
    return 2


def _jax_graph():
    """``tests/test_parallel.py`` ``_multi_io_graph``."""
    conf = (JaxConf.builder().seed(1)
            .updater(jupd.Adam(learning_rate=GRAPH_LR))
            .graph_builder()
            .add_inputs("a", "b")
            .add_layer("da", JaxDense(n_out=8, activation="tanh"), "a")
            .add_layer("db", JaxDense(n_out=8, activation="tanh"), "b")
            .add_vertex("sum", JaxEWV(op="add"), "da", "db")
            .add_layer("out1", JaxOutput(n_out=2, activation="softmax",
                                         loss="mcxent"), "sum")
            .add_layer("out2", JaxOutput(n_out=1, activation="identity",
                                         loss="mse"), "sum")
            .set_outputs("out1", "out2")
            .set_input_types(a=JaxInputType.feed_forward(3),
                             b=JaxInputType.feed_forward(3))
            .build())
    return JaxGraph(conf).init()


def _graph_inputs(inp):
    """``_multi_io_data()`` of ``tests/test_parallel.py``, the graph's
    and BertTiny's JAX weights, and BertTiny's batch."""
    rng = np.random.default_rng(0)
    xa = rng.normal(size=(256, 3)).astype(np.float32)
    xb = rng.normal(size=(256, 3)).astype(np.float32)
    inp["g/xa"], inp["g/xb"] = xa, xb
    inp["g/y1"] = np.eye(2, dtype=np.float32)[((xa + xb).sum(1) > 0)
                                              .astype(int)]
    inp["g/y2"] = (xa - xb).sum(1, keepdims=True).astype(np.float32)
    inp.update(twins._flat(jax.tree.map(np.asarray, _jax_graph().params),
                           "g/weights"))
    bert = JaxBertTiny(max_len=worker.BERT_T, dropout=0.0)
    inp.update(twins._flat(jax.tree.map(
        np.asarray, bert.init_classifier(2, worker.BERT_T).params),
        "bert/weights"))
    rng = np.random.default_rng(11)
    t = worker.BERT_T
    inp["bert/tok"] = rng.integers(0, 1000, (BERT_B, t))
    split = rng.integers(1, t, BERT_B)
    inp["bert/seg"] = (np.arange(t)[None, :] >= split[:, None]).astype(
        np.int64)
    inp["bert/y"] = np.eye(2, dtype=np.float32)[rng.integers(0, 2, BERT_B)]
    bn.bn_inputs(inp)


def _jax_graphs(inp):
    """The graph in each mode and under the sharded update at
    ``workers=2``, one ``fit`` a batch (its loss); BertTiny's classifier
    under the sharded update, 3 steps."""
    data = [JaxMDS([inp["g/xa"][i:i + 32], inp["g/xb"][i:i + 32]],
                   [inp["g/y1"][i:i + 32], inp["g/y2"][i:i + 32]])
            for i in range(0, 256, 32)]
    params = _unflat(inp, "g/weights")
    out = {}
    for mode in worker.GRAPH_MODES:
        net = _jax_graph()
        net.params = jax.tree.map(jnp.asarray, params)
        kw = ({"sharded_update": True} if mode == "sharded"
              else {"mode": mode})
        w = JaxWrapper(net, workers=2, averaging_frequency=2,
                       prefetch_buffer=0, **kw)
        losses = []
        for _ in range(worker.GRAPH_EPOCHS):
            for ds in data:
                w.fit([ds])
                losses.append(float(net.score_))
        out[f"graph/{mode}"] = (losses, twins._flat(
            jax.tree.map(np.asarray, net.params), "params"))
    net = JaxBertTiny(max_len=worker.BERT_T, dropout=0.0).init_classifier(
        2, worker.BERT_T)
    net.params = jax.tree.map(jnp.asarray, _unflat(inp, "bert/weights"))
    w = JaxWrapper(net, workers=2, sharded_update=True, prefetch_buffer=0)
    losses = []
    for _ in range(3):
        w.fit([JaxMDS([inp["bert/tok"], inp["bert/seg"]],
                      [inp["bert/y"]])])
        losses.append(float(net.score_))
    out["bert"] = (losses, twins._flat(jax.tree.map(np.asarray,
                                                    net.params), "params"))
    out["bn"] = bn.jax_bn(inp, BN_MODES)
    return out


def _unflat(inp, prefix):
    out = {}
    for key, a in twins._under(inp, prefix).items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return out


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    return twins.zero_runs(world, tmp_path_factory, _graph_inputs,
                           _jax_graphs)


# -- the graph under the wrapper ---------------------------------------------
@pytest.mark.parametrize("mode", worker.GRAPH_MODES)
def test_graph_trains_as_jax(runs, mode):
    losses, ref = runs["jax"][f"graph/{mode}"]
    steps = len(losses)
    for res, log in runs["ranks"]:
        np.testing.assert_allclose(log[f"graph/{mode}/losses"], losses,
                                   rtol=twins.LOSS_RTOL, atol=0)
        twins._param_check(twins._under(res, f"graph/{mode}"), ref,
                           GRAPH_LR, steps, OFF_SHARE[mode])
        assert log[f"graph/{mode}/out_shapes"] == [[16, 2], [16, 1]]
    (a, _), (b, _) = runs["ranks"]
    keys = [k for k in a if k.startswith(f"graph/{mode}/params/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("mode", BN_MODES)
def test_sharded_update_trains_batch_norm_as_jax(runs, mode):
    """The batch-norm net under the sharded update (and its overlap): the
    rank's own statistics, rank 0's state kept on every rank, against the
    JAX sharded wrapper's ``net.state`` (device 0's)."""
    bn.check_bn(runs["ranks"], runs["jax"]["bn"][mode], mode)


@pytest.mark.parametrize("name", ["averaging", "encoded"])
def test_spark_computation_graph_fits(runs, name):
    (a, la), (b, lb) = runs["ranks"]
    for log in (la, lb):
        score = log[f"spark/{name}/score"]
        assert np.isfinite(score) and score < 1.2, score
    keys = [k for k in a if k.startswith(f"spark/{name}/params/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_bert_classifier_sharded_update(runs):
    losses, ref = runs["jax"]["bert"]
    for res, log in runs["ranks"]:
        np.testing.assert_allclose(log["bert/sh/losses"],
                                   log["bert/rep/losses"], rtol=1e-5,
                                   atol=1e-7)
        rep, sh = (twins._under(res, f"bert/{m}/params")
                   for m in ("rep", "sh"))
        assert rep and set(rep) == set(sh)
        for k in rep:
            np.testing.assert_allclose(sh[k], rep[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        np.testing.assert_allclose(log["bert/sh/losses"], losses,
                                   rtol=twins.LOSS_RTOL, atol=0)
        got = twins._under(res, "bert/sh")
        assert set(got) == set(ref)
        for k, want in ref.items():
            d = np.abs(got[k] - want).ravel()
            assert (d <= 1e-6).mean() >= 0.995, (k, (d <= 1e-6).mean())
            assert d.max() <= BERT_LR / 3, (k, d.max())


def test_masked_batch_raises_naming_the_gap(runs):
    for _, log in runs["ranks"]:
        for name in ("masked_dataset", "masked_graph"):
            msg = log["refused"][name]
            assert msg.startswith("NotImplementedError") \
                and "passes no masks" in msg \
                and "wrapper.py:163-164" in msg, (name, msg)


# -- the layout's host-side pieces, in this process --------------------------
def _tree():
    rng = np.random.default_rng(5)
    return {"l0": {"W": rng.normal(size=(5, 13)).astype(np.float32),
                   "b": rng.normal(size=(13,)).astype(np.float32)},
            "l1": {"W": rng.normal(size=(13, 3)).astype(np.float32),
                   "gamma": rng.normal(size=(7,)).astype(np.float32),
                   "s": np.float32(2.5).reshape(())}}


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_flat_layout_matches_jax(n):
    host = _tree()
    jl = jzero.FlatShardLayout(jax.tree.map(jnp.asarray, host), n)
    pl = pzero.FlatShardLayout(tree.map_(torch.tensor, host), n)
    order = [a for a in jax.tree.leaves(host)]        # sorted keys
    porder = list(tree.leaves(host))                  # insertion order
    perm = [next(i for i, b in enumerate(porder) if b is a) for a in order]
    assert [pl.sizes[i] for i in perm] == jl.sizes
    assert [pl.padded[i] for i in perm] == jl.padded
    jf = jl.flatten(jax.tree.map(jnp.asarray, host))
    pf = pl.flatten(tree.map_(torch.tensor, host))
    for path in (("l0", "W"), ("l0", "b"), ("l1", "W"), ("l1", "gamma"),
                 ("l1", "s")):
        np.testing.assert_array_equal(
            pf[path[0]][path[1]].numpy(), np.asarray(jf[path[0]][path[1]]))
        for r in range(n):
            np.testing.assert_array_equal(
                pl.shard(pf, r)[path[0]][path[1]].numpy(),
                np.asarray(jl.shard(jf, r)[path[0]][path[1]]))
    back = pl.unflatten(pf)
    for a, b in zip(tree.leaves(back), tree.leaves(host)):
        np.testing.assert_array_equal(a.numpy(), b)
        assert a.shape == b.shape


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_leaf_and_per_device_bytes_match_jax(n):
    host = _tree()
    flat = pzero.FlatShardLayout(tree.map_(torch.tensor, host),
                                 n).flatten(tree.map_(torch.tensor, host))
    flat["count"] = torch.zeros((), dtype=torch.int32)
    jflat = tree.map_(lambda t: jnp.asarray(t.numpy()), flat)
    paths = tree.leaves(tree.map_with_path(lambda p, _: p, flat))
    for path in paths:
        a, b = flat, jflat
        for k in path:
            a, b = a[k], b[k]
        assert pzero.sharded_leaf(a, n) == jzero.sharded_leaf(b, n), path
    for shards in (1, n):
        assert pzero.per_device_bytes(flat, shards) == \
            jzero.per_device_bytes(jflat, shards)
    # numpy leaves count too
    assert pzero.per_device_bytes(host) == jzero.per_device_bytes(host)


def test_repad_flat_leaves_bit_identity_8_to_4_to_8():
    """Twin of ``tests/test_elastic.py:276``."""
    rng = np.random.RandomState(0)
    sizes = [10, 64, 7, 1]
    pad = lambda s, n: ((s + n - 1) // n) * n
    src8 = []
    for s in sizes:
        v = np.zeros(pad(s, 8), np.float32)
        v[:s] = rng.randn(s)
        src8.append(v)
    ref4 = [np.zeros(pad(s, 4), np.float32) for s in sizes]
    ref8 = [np.zeros(pad(s, 8), np.float32) for s in sizes]
    at4 = pzero.repad_flat_leaves(src8, ref4)
    back8 = pzero.repad_flat_leaves(at4, ref8)
    for a, b in zip(src8, back8):
        assert a.shape == b.shape and np.array_equal(a, b)
    for a, j in zip(at4, jzero.repad_flat_leaves(src8, ref4)):
        np.testing.assert_array_equal(a, j)
    assert pzero.repad_flat_leaves([np.float32(3.0)],
                                   [np.zeros((), np.float32)])[0] == 3.0
    bad = np.ones(16, np.float32)
    with pytest.raises(pzero.LayoutMismatch, match="non-zero"):
        pzero.repad_flat_leaves([bad], [np.zeros(12, np.float32)])
    assert issubclass(pzero.LayoutMismatch, ValueError)


@pytest.mark.parametrize("masked", [False, True])
def test_mse_matches_jax(masked):
    """``mse`` (alias ``l2``), the multi-IO graph's regression loss:
    value and gradient against the JAX loss on [B, T, F] predictions,
    with and without a [B, T] mask and with per-feature weights, 1e-6
    relative (the same f32 sums in another order)."""
    from deeplearning4j_tpu.ops import losses as jlosses
    from deeplearning4j_tpu_torch.ops import losses as plosses
    rng = np.random.default_rng(6)
    labels = rng.normal(size=(3, 5, 4)).astype(np.float32)
    preds = rng.normal(size=(3, 5, 4)).astype(np.float32)
    weights = np.array([1.0, 0.5, 2.0, 1.0], np.float32)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32) if masked \
        else None
    jm = None if mask is None else jnp.asarray(mask)
    pm = None if mask is None else torch.tensor(mask)
    for w in (None, weights):
        theirs = jlosses.mse(jnp.asarray(labels), jnp.asarray(preds),
                             mask=jm, weights=w)
        p = torch.tensor(preds, requires_grad=True)
        ours = plosses.get("mse")(torch.tensor(labels), p, mask=pm,
                                  weights=w)
        np.testing.assert_allclose(ours.item(), float(theirs), rtol=1e-6)
        jg = jax.grad(lambda z: jlosses.mse(jnp.asarray(labels), z,
                                            mask=jm, weights=w))(
            jnp.asarray(preds))
        (g,) = torch.autograd.grad(ours, p)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6,
                                   atol=1e-7)
    assert plosses.get("l2") is plosses.mse
