"""Truncated BPTT, stored-state inference and the char-RNN of the port
(``nn/multilayer.py`` ``_fit_tbptt``/``rnn_time_step``, ``nn/config.py``,
``zoo/textgen_lstm.py``, ``data/iterators.py``
``BucketedSequenceIterator``, a recurrent ``ComputationGraph``) against
the JAX package on the CPU, from the same numpy batches and the JAX
weights carried across.

Twins of ``tests/test_multilayer.py:96`` (tBPTT trains), ``:123``
(``rnn_time_step``), ``:196`` (a masked sequence fit), ``:257`` (tBPTT
under bf16 compute), ``:280`` (the scanned and the sequential tBPTT
paths, one loop in the port), ``tests/test_constraints.py:118``
(constraints and weight noise in the tBPTT path),
``tests/test_data.py:363, 394`` (bucketing), the ``TextGenerationLSTM``
case of ``tests/test_zoo_pretrained.py:21-30`` and the LSTM graph of
``tests/test_train_loop.py:86-128``; and pins of the JAX rules a port
could miss: every segment of a batch draws the batch's one seed, the
optimizer's count moves once a segment and ``iteration`` once a batch,
``score_`` is the last segment's loss read back once a batch, listeners
fire once a batch, tBPTT batches never join a ``steps_per_loop``
region.

Bands:
- float32, the port against JAX after 3 batches (up to 4 segment
  updates each): each batch's score within 1e-5 relative, every
  parameter within the JAX train-loop test's 2e-5 relative and 2e-6
  absolute;
- bf16 compute (Sgd): each score within 2e-2 relative, and every
  parameter within 2e-2 of its leaf's largest magnitude (both sides
  round the forward and backward to bf16, at other points: XLA fuses
  and sums in f32, PyTorch rounds op by op; a few bf16 ulps, 2^-8
  each, a step over 6 updates); masters and optimizer state f32;
- ``rnn_time_step`` step by step against one ``output`` over the
  sequence: 1e-6 absolute (the input GEMM at another shape), and
  against the JAX network's ``output`` 1e-5 (the JAX test holds its own
  ``rnn_time_step`` to its ``output``);
- the golden zip: the JAX test's rtol 1e-5, atol 1e-6;
- the recurrent graph's loss (1e-5 relative) and gradients (1e-5 of each
  leaf's largest) against the JAX composition of its forward and
  ``mcxent``; grouped against single fits equal to the bit.
"""
import functools
import pathlib
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import BucketedSequenceIterator as JBucketed
from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.data import ListDataSetIterator as JListIt
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import constraints as jcons
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu.serialization import ModelSerializer as JSerializer
from deeplearning4j_tpu.zoo import TextGenerationLSTM as JTextGen
from deeplearning4j_tpu_torch import tree
from deeplearning4j_tpu_torch.data import (BucketedSequenceIterator,
                                           DataSet, ListDataSetIterator,
                                           MultiDataSet)
from deeplearning4j_tpu_torch.nn import constraints as pcons
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                MultiLayerConfiguration,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers.base import fold_in
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serialization import ModelSerializer
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

GOLDENS = pathlib.Path(__file__).resolve().parents[1] / "resources" / \
    "pretrained"
J = types.SimpleNamespace(conf=JConf, L=jl, upd=jupd, cons=jcons,
                          InputType=JInputType)
P = types.SimpleNamespace(conf=NeuralNetConfiguration, L=pl, upd=pupd,
                          cons=pcons, InputType=InputType)
RTOL, ATOL = 2e-5, 2e-6
SCORE_RTOL = 1e-5
BF16_RTOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _signs(x):
    """Labels: the sign of the first feature, one-hot over 2 classes."""
    return np.stack([(x[..., 0] > 0), (x[..., 0] <= 0)], -1).astype(
        np.float32)


def _lengths_mask(b, t, seed):
    lengths = np.random.default_rng(seed).integers(t // 2, t + 1, b)
    return (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)


# -- the networks ---------------------------------------------------------
def _conf(lib, case):
    """The configuration of ``case`` built with package ``lib``."""
    L = lib.L
    b = lib.conf.builder().seed(7)
    if case in SGD:
        b = b.updater(lib.upd.Sgd(learning_rate=SGD[case]))
    else:
        b = b.updater(lib.upd.Adam(learning_rate=0.02))
    if case == "bf16":
        b = b.compute_data_type("bfloat16")
    b = b.list()
    if case == "labels-2d":
        b = (b.layer(L.LastTimeStep(underlying=L.LSTM(n_out=4)))
             .layer(L.OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent")))
    else:
        if case == "scanned":
            first = L.GravesLSTM(n_out=5, constraints=[
                lib.cons.MaxNormConstraint(max_norm=0.5)])
        else:
            first = L.LSTM(n_out=4)
        b = b.layer(first)
        b = b.layer(L.RnnOutputLayer(n_out=2, activation="softmax",
                                     loss="mcxent"))
    if case != "standard-masked":
        b = b.backprop_type("TruncatedBPTT").tbptt_fwd_length(
            4).tbptt_back_length(4)
    return b.set_input_type(lib.InputType.recurrent(3)).build()


#: the cases trained by Sgd, and its learning rate: under bf16 compute
#: an update proportional to the gradient keeps the two packages' bf16
#: rounding in proportion (Adam's normalised step would turn a
#: near-zero gradient's rounding into a whole step)
SGD = {"bf16": 0.5}
#: case → (batch, time steps, masked)
FIT_CASES = {
    # k | T: the JAX scanned path; with a max-norm constraint
    # (test_constraints.py:118, without the noise)
    "scanned": (6, 8, False),
    "tail-masked": (5, 10, True),     # k ∤ T, masks cut per segment
    "labels-2d": (4, 6, False),       # a [B, C] label for every segment
    "standard-masked": (8, 5, True),  # test_multilayer.py:196
    "bf16": (4, 8, False),            # test_multilayer.py:257
}


def _pair(case, t):
    jnet = JMLN(_conf(J, case)).init(input_shape=(t, 3))
    net = MultiLayerNetwork(_conf(P, case)).init(
        input_shape=(t, 3), device="cpu")
    return net.params_from_jax(jax.tree.map(np.asarray, jnet.params)), jnet


def _batches(case, n=3):
    b, t, masked = FIT_CASES[case]
    out = []
    for i in range(n):
        x = np.random.default_rng(10 * i + len(case)).normal(
            size=(b, t, 3)).astype(np.float32)
        y = _signs(x[:, -1]) if case == "labels-2d" else _signs(x)
        m = _lengths_mask(b, t, i) if masked else None
        out.append((x, y, m))
    return out


def _near_jax(net, jnet, rtol, atol, leaf_rtol=0.0):
    """Every port parameter against the JAX one at its key path, within
    ``rtol``/``atol`` plus ``leaf_rtol`` of the leaf's largest value."""
    def check(path, t):
        want = np.asarray(functools.reduce(dict.__getitem__, path,
                                           jnet.params))
        np.testing.assert_allclose(
            t.numpy(), want, rtol=rtol,
            atol=atol + leaf_rtol * np.abs(want).max(),
            err_msg=".".join(path))
    tree.map_with_path(check, net.params)


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_matches_jax(case):
    """[``test_multilayer.py:96, 196, 257``, ``test_constraints.py:118``]
    three batches of ``fit`` on the same weights: every batch's score and
    the parameters after the last. Under tBPTT the optimizer's count is
    the number of segments run."""
    net, jnet = _pair(case, FIT_CASES[case][1])
    bf16 = case == "bf16"
    for x, y, m in _batches(case):
        jnet.fit(x, y, features_mask=m, labels_mask=m)
        net.fit(x, y, features_mask=m, labels_mask=m)
        np.testing.assert_allclose(
            net.score(), jnet.score(),
            rtol=BF16_RTOL if bf16 else SCORE_RTOL)
    if bf16:
        _near_jax(net, jnet, 0, 0, leaf_rtol=BF16_RTOL)
        assert all(t.dtype == torch.float32
                   for t in [*tree.leaves(net.params),
                             *tree.leaves(net.opt_state)])
    else:
        _near_jax(net, jnet, RTOL, ATOL)
    k, t = net.conf.tbptt_fwd_length, FIT_CASES[case][1]
    segments = 1 if case == "standard-masked" else -(-t // k)
    if case not in SGD:            # Sgd keeps no count
        assert int(net.opt_state["layer_0"]["count"]) == 3 * segments
    assert net.iteration == 3


def test_one_loop_for_the_scanned_and_sequential_paths():
    """[``test_multilayer.py:280``] the JAX package's scanned path (no
    masks, k | T) and its sequential path (forced by an all-ones
    mask) train alike: in the port both are one loop, the mask of ones
    held to the JAX test's band."""
    a, _ = _pair("scanned", 8)
    b, _ = _pair("scanned", 8)
    ones = np.ones((6, 8), np.float32)
    for x, y, _ in _batches("scanned", 5):
        a.fit(x, y)
        b.fit(x, y, features_mask=ones)
    for p, q in zip(tree.leaves(a.params), tree.leaves(b.params)):
        np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_segments_share_the_batch_seed_and_one_read_back(monkeypatch):
    """The traps of ``_fit_tbptt`` (JAX ``nn/multilayer.py:646-721``):
    every segment of a batch gets ``fold_in(seed, iteration)``; each
    segment is one update (the optimizer's count) while ``iteration``
    and the listeners move once a batch; ``score_`` is the last
    segment's loss and the only read-back of the batch; under
    ``steps_per_loop`` the batches run alone; and weight noise with a
    max-norm constraint keeps the norms (``test_constraints.py:118``)."""
    conf = (NeuralNetConfiguration.builder().seed(4)
            .updater(pupd.Adam(learning_rate=0.5)).list()
            .layer(pl.LSTM(n_out=6, constraints=[
                pcons.MaxNormConstraint(max_norm=0.5)],
                weight_noise=pcons.WeightNoise(stddev=0.1)))
            .layer(pl.RnnOutputLayer(n_out=2, activation="softmax",
                                     loss="mcxent"))
            .backprop_type("TruncatedBPTT").tbptt_fwd_length(3)
            .set_input_type(InputType.recurrent(3)).build())
    net = MultiLayerNetwork(conf).init(input_shape=(8, 3), device="cpu")
    seeds, losses, seen, reads = [], [], [], []

    def update(x, y, m, lm, rng, **rnn):
        seeds.append((net.iteration, rng))
        loss = orig(x, y, m, lm, rng, **rnn)
        losses.append(loss)
        return loss

    class Listener:
        def on_epoch_start(self, n):
            pass

        def on_epoch_end(self, n):
            pass

        def iteration_done(self, n, iteration, epoch):
            seen.append((iteration, n.score_))

    orig = net._update
    monkeypatch.setattr(net, "_update", update)
    monkeypatch.setattr(net, "_fit_group",
                        lambda group: pytest.fail("tBPTT batch grouped"))
    float_ = torch.Tensor.__float__
    monkeypatch.setattr(torch.Tensor, "__float__",
                        lambda t: (reads.append(1), float_(t))[1])
    net.set_listeners(Listener())
    x = np.random.default_rng(0).standard_normal((4, 8, 3)).astype(
        np.float32)
    x2 = np.ascontiguousarray(x[::-1])
    batches = [DataSet(x, _signs(x)), DataSet(x2, _signs(x2))]
    net.fit(ListDataSetIterator(batches), steps_per_loop=4)
    assert [it for it, _ in seeds] == [0] * 3 + [1] * 3   # 8 = 3 + 3 + 2
    assert [s for _, s in seeds] == [fold_in(4, 0)] * 3 + [fold_in(4, 1)] * 3
    assert int(net.opt_state["layer_0"]["count"]) == 6
    assert net.iteration == 2 and len(reads) == 2
    assert seen == [(1, float_(losses[2])), (2, float_(losses[5]))]
    for key in ("W", "U"):
        norms = torch.linalg.vector_norm(net.params["layer_0"][key], dim=0)
        assert (norms <= 0.5 + 1e-4).all(), (key, norms.max())


# -- stored-state inference -----------------------------------------------
def test_rnn_time_step_matches_output_and_jax():
    """[``test_multilayer.py:123``] one step at a time from the stored
    carries gives the whole sequence's outputs, on the char-RNN's two
    GravesLSTMs, and the JAX network's; ``rnn_clear_previous_state``
    starts over; a [B, T, F] call continues from the stored carries
    too."""
    jnet = JTextGen(vocab_size=6, hidden=5, layers=2, tbptt=3).init()
    net = TextGenerationLSTM(vocab_size=6, hidden=5, layers=2,
                             tbptt=3).init(device="cpu")
    net.params_from_jax(jax.tree.map(np.asarray, jnet.params))
    x = np.random.default_rng(1).normal(size=(2, 6, 6)).astype(np.float32)
    full = net.output(x)
    for _ in range(2):
        net.rnn_clear_previous_state()
        steps = torch.stack([net.rnn_time_step(x[:, i]) for i in range(6)],
                            dim=1)
        torch.testing.assert_close(steps, full, rtol=0, atol=1e-6)
    net.rnn_clear_previous_state()
    net.rnn_time_step(x[:, :4])
    torch.testing.assert_close(net.rnn_time_step(x[:, 4:]), full[:, 4:],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(steps.numpy(), np.asarray(jnet.output(x)),
                               rtol=0, atol=1e-5)


# -- the char-RNN, its zip and its JSON -----------------------------------
def test_text_generation_lstm_golden_zip_and_json():
    """[``test_zoo_pretrained.py:21-30``] the JAX-minted golden restores
    in the port and reproduces its minting forward; the configuration's
    JSON is the JAX package's, truncated BPTT included, and parses back
    in both; a port zip of the trained char-RNN restores in the JAX
    package with the same outputs."""
    net = TextGenerationLSTM.init_pretrained(base_dir=GOLDENS,
                                             device="cpu")
    io = np.load(GOLDENS / "TextGenerationLSTM" / "default_golden_io.npz")
    np.testing.assert_allclose(net.output(io["x"]).numpy(), io["y"],
                               rtol=1e-5, atol=1e-6)
    assert net.conf.backprop_type == "TruncatedBPTT"
    js = TextGenerationLSTM(vocab_size=12, hidden=16).conf().to_json()
    assert js == JTextGen(vocab_size=12, hidden=16).conf().to_json()
    assert MultiLayerConfiguration.from_json(js).to_json() == js
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/charrnn.zip"
        net.fit(io["x"], np.roll(io["x"], -1, axis=1))
        ModelSerializer.write_model(net, path)
        back = JSerializer.restore_multi_layer_network(path)
        np.testing.assert_allclose(np.asarray(back.output(io["x"])),
                                   net.output(io["x"]).numpy(),
                                   rtol=1e-5, atol=1e-6)


# -- bucketing ---------------------------------------------------------------
def _same_datasets(got, want):
    for attr in ("features", "labels", "features_mask", "labels_mask"):
        a, b = getattr(got, attr), getattr(want, attr)
        assert (a is None) == (b is None), attr
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=attr)


def test_bucketed_sequence_iterator_matches_jax():
    """[``test_data.py:363, 394``] variable-T batches snap to the bucket
    lengths (one past the largest passes as it is); the padding is
    masked, a given mask kept, per-sequence labels and their mask left
    alone — equal to the JAX iterator's batches."""
    def batches(lib_ds):
        out = [lib_ds(np.ones((2, t, 3), np.float32),
                      np.ones((2, t, 4), np.float32))
               for t in (5, 17, 33, 300)]
        out.append(lib_ds(np.ones((1, 10, 3), np.float32),
                          np.ones((1, 10, 4), np.float32),
                          features_mask=np.concatenate(
                              [np.ones((1, 7)), np.zeros((1, 3))], 1)))
        out.append(lib_ds(np.ones((2, 5, 3), np.float32),
                          np.ones((2, 4), np.float32),
                          labels_mask=np.ones((2, 1), np.float32)))
        return out

    got = list(BucketedSequenceIterator(
        ListDataSetIterator(batches(DataSet)), buckets=(16, 32, 64)))
    want = list(JBucketed(JListIt(batches(JDataSet)), buckets=(16, 32, 64)))
    assert [d.features.shape[1] for d in got] == [16, 32, 64, 300, 16, 16]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_datasets(g, w)


# -- a recurrent graph ---------------------------------------------------
def _rnn_graph(lib, graph_cls, device=None):
    conf = (lib.conf.builder().seed(5)
            .updater(lib.upd.Adam(learning_rate=0.02))
            .graph_builder()
            .add_inputs("in")
            .add_layer("rnn", lib.L.LSTM(n_out=8), "in")
            .add_layer("out", lib.L.RnnOutputLayer(
                n_out=2, activation="softmax", loss="mcxent"), "rnn")
            .set_outputs("out")
            .set_input_types(**{"in": lib.InputType.recurrent(4, 6)})
            .build())
    net = graph_cls(conf)
    return net.init() if device is None else net.init(device=device)


def _graph_batches(n=6, b=8, t=6, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((b, t, 4)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (b, t))]
        m = (np.arange(t)[None, :]
             < rng.integers(3, t + 1, (b, 1))).astype(np.float32)
        out.append((x, y, m))
    return out


def test_recurrent_graph_region_and_jax_composition():
    """[``test_train_loop.py:86-128``] the LSTM → RnnOutputLayer graph
    with masked batches: grouped into K-step regions (no per-batch
    dispatch) it equals single fits to the bit, and the LSTM node's
    layer state stays as it was; its loss and gradients equal the JAX
    composition of the graph's forward and ``mcxent`` (the JAX graph's
    own fit takes the fused branch that the port fixed, ``ROADMAP.md``
    C)."""
    jnet = _rnn_graph(J, JGraph)
    make = lambda: _rnn_graph(P, ComputationGraph, "cpu").params_from_jax(
        jax.tree.map(np.asarray, jnet.params))
    data = _graph_batches()
    a, b = make(), make()
    for x, y, m in data:
        a.fit([x], [y], features_masks=[m], labels_masks=[m])
    calls = []
    orig = b._fit_batch
    b._fit_batch = lambda *z, **k: (calls.append(1), orig(*z, **k))[1]
    b.fit([MultiDataSet([x], [y], features_masks=[m], labels_masks=[m])
           for x, y, m in data], steps_per_loop=3)
    assert not calls and a.iteration == b.iteration == 6
    for p, q in zip([*tree.leaves(a.params), *tree.leaves(a.opt_state)],
                    [*tree.leaves(b.params), *tree.leaves(b.opt_state)]):
        assert torch.equal(p, q)
    assert a.state["rnn"] == {} and b.state["rnn"] == {}
    x, y, m = data[0]

    def jloss(params):
        acts, _ = jnet._forward(params, jnet.state, {"in": jnp.asarray(x)},
                                train=False, rng=None,
                                masks={"in": jnp.asarray(m)})
        return jlosses.mcxent(jnp.asarray(y), acts["out"],
                              mask=jnp.asarray(m))

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(jnet.params)
    loss, grads, _ = make()._loss_and_grads([x], [y], [m], [m])
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)

    def check(path, g):
        w = np.asarray(jgrads[path[0]][path[1]])
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), path
    tree.map_with_path(check, grads)
