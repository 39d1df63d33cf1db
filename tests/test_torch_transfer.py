"""Transfer learning on the CPU: the port's ``TransferLearning.Builder``,
``FineTuneConfiguration`` and ``TransferLearningHelper`` against the JAX
package's, from the same carried-across weights and numpy batches.

Twins of ``tests/test_training_tools.py:41`` (freeze and replace the
head), ``:71`` (``n_out_replace``), ``:83`` (``featurize`` /
``fit_featurized``), ``tests/test_gpt.py:476`` (ties on the helper's
tail, a tie across the split refused), ``:516`` (the tied LM's head
swap) and ``tests/test_integration_frozen.py:155`` (a dropped tie keeps
the trained value), and a small-LM twin: ``set_feature_extractor`` on
``CausalTransformerLM`` with a fine-tune chain, 3 steps. After a build,
the re-initialised layers take the JAX net's fresh values (the two
generators differ); the kept ones must already be equal.

Tolerances (float32): losses 1e-5 relative a step; parameters as in
``tests/test_torch_train.py`` — 99.9 % of the elements within 1e-6 and
all within 1e-4 after Adam steps (an element whose gradient lies within
f32 rounding of zero may step differently, by at most a third of a
step); frozen groups equal to the bit, on both sides, to their values
before ``fit``. Featurized activations: 1e-5 absolute (the same f32
forward in another order).
"""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.data import ListDataSetIterator as JListIt
from deeplearning4j_tpu.nn import FineTuneConfiguration as JFTC
from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import TransferLearning as JTL
from deeplearning4j_tpu.nn import TransferLearningHelper as JHelper
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.zoo.gpt import GPTNano as JGPTNano
from deeplearning4j_tpu_torch import tree
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn import (FineTuneConfiguration,
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration,
                                         TransferLearning,
                                         TransferLearningHelper)
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.nn.config import InputType
from deeplearning4j_tpu_torch.nn.layers import (DenseLayer, FrozenLayer,
                                                OutputLayer, RnnOutputLayer)
from deeplearning4j_tpu_torch.zoo.gpt import GPTNano

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(params):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _carry(pnet, jnet):
    """The JAX net's parameters into the port net (its optimizer state
    restarts, as the JAX build's does)."""
    return pnet.params_from_jax(_host(jnet.params))


def _diffs(jnet, pnet):
    jp = _host(jnet.params)
    pp = tree.map_(lambda t: t.detach().float().numpy(), pnet.params)
    assert jax.tree.structure(jp) == jax.tree.structure(pp)
    return np.concatenate([np.abs(a - b).ravel() for a, b in zip(
        jax.tree.leaves(jp), jax.tree.leaves(pp))])


def _assert_close(jnet, pnet):
    d = _diffs(jnet, pnet)
    assert (d <= 1e-6).mean() >= 0.999, (d <= 1e-6).mean()
    assert d.max() <= 1e-4, d.max()


def _assert_frozen(pnet, before, names):
    for name in names:
        for a, b in zip(tree.leaves(pnet.params[name]),
                        tree.leaves(before[name])):
            assert torch.equal(a, b), name


def _mlp(conf, inputs, dense, out, upd, seed=7):
    return (conf.builder().seed(seed)
            .updater(upd.Adam(learning_rate=1e-2)).list()
            .layer(dense(n_out=16, activation="relu"))
            .layer(dense(n_out=16, activation="relu"))
            .layer(out(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(inputs.feed_forward(8)).build())


def _pair():
    jnet = JNet(_mlp(JConf, JInputType, JDense, JOut, jupd)).init()
    pnet = MultiLayerNetwork(_mlp(NeuralNetConfiguration, InputType,
                                  DenseLayer, OutputLayer, pupd)).init(
        device="cpu")
    return jnet, _carry(pnet, jnet)


def _data(n=64, n_in=8, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, n_in)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def test_transfer_freeze_and_replace_head():
    jnet, pnet = _pair()
    x, y = _data()
    jnet.fit(JListIt(JDataSet(x, y), batch_size=32), epochs=3)
    pnet.fit(ListDataSetIterator(DataSet(x, y), batch_size=32), epochs=3)
    _assert_close(jnet, pnet)
    w0 = pnet.params["layer_0"]["W"].clone()

    def build(tl, ftc, upd, out, src):
        return (tl.builder(src)
                .fine_tune_configuration(ftc(updater=upd.Sgd(
                    learning_rate=1e-2)))
                .set_feature_extractor(1)
                .remove_output_layer()
                .add_layer(out(n_out=5, activation="softmax",
                               loss="mcxent"))
                .build())

    jnew = build(JTL, JFTC, jupd, JOut, jnet)
    pnew = build(TransferLearning, FineTuneConfiguration, pupd,
                 OutputLayer, pnet)
    assert isinstance(pnew.layers[0], FrozenLayer)
    assert isinstance(pnew.layers[1], FrozenLayer)
    assert pnew.layers[2].n_out == 5
    assert pnew.device == pnet.device
    # the frozen weights carried over exactly, as copies
    assert torch.equal(pnew.params["layer_0"]["W"], w0)
    assert (pnew.params["layer_0"]["W"].data_ptr()
            != pnet.params["layer_0"]["W"].data_ptr())
    assert pnew.opt_state["layer_0"] == pnew.opt_state["layer_1"] == {}
    assert pnew.conf.to_json() == jnew.conf.to_json()
    _carry(pnew, jnew)                  # the fresh head: JAX's values
    before = tree.map_(torch.clone, pnew.params)
    y5 = np.eye(5, dtype=np.float32)[
        np.random.default_rng(1).integers(0, 5, 64)]
    jnew.fit(JListIt(JDataSet(x, y5), batch_size=32), epochs=3)
    pnew.fit(ListDataSetIterator(DataSet(x, y5), batch_size=32), epochs=3)
    assert pnew.score() == pytest.approx(jnew.score(), rel=TOL)
    _assert_frozen(pnew, before, ("layer_0", "layer_1"))
    np.testing.assert_array_equal(np.asarray(jnew.params["layer_0"]["W"]),
                                  before["layer_0"]["W"].numpy())
    assert not torch.equal(pnew.params["layer_2"]["W"],
                           before["layer_2"]["W"])
    _assert_close(jnew, pnew)
    assert pnew.output(x).shape == (64, 5)


def test_transfer_nout_replace():
    jnet, pnet = _pair()
    jnew = JTL.builder(jnet).n_out_replace(1, 24,
                                           weight_init="xavier").build()
    pnew = TransferLearning.builder(pnet).n_out_replace(
        1, 24, weight_init="xavier").build()
    assert pnew.layers[1].n_out == 24
    assert tuple(pnew.params["layer_1"]["W"].shape) == (16, 24)
    assert tuple(pnew.params["layer_2"]["W"].shape) == (24, 3)
    # the source's layer objects are untouched
    assert pnet.layers[1].n_out == 16
    assert torch.equal(pnew.params["layer_0"]["W"],
                       pnet.params["layer_0"]["W"])
    _carry(pnew, jnew)
    x = np.random.default_rng(2).normal(size=(4, 8)).astype(np.float32)
    np.testing.assert_allclose(pnew.output(x).numpy(),
                               np.asarray(jnew.output(x)), atol=TOL)


def test_transfer_helper_featurize():
    jnet, pnet = _pair()
    x, y = _data()
    jh = JHelper(jnet, frozen_until=1)
    ph = TransferLearningHelper(pnet, frozen_until=1)
    jf, pf = jh.featurize(JDataSet(x, y)), ph.featurize(DataSet(x, y))
    assert pf.features.shape == (64, 16)
    np.testing.assert_allclose(pf.features, np.asarray(jf.features),
                               atol=TOL)
    before = tree.map_(torch.clone, ph.net.params)
    jh.fit_featurized(JListIt(jf, batch_size=32), epochs=2)
    ph.fit_featurized(ListDataSetIterator(pf, batch_size=32), epochs=2)
    assert ph.unfrozen_mln().score() == pytest.approx(
        jh.unfrozen_mln().score(), rel=TOL)
    after = ph.net.params["layer_2"]["W"]
    assert (after - before["layer_2"]["W"]).abs().max() > 0
    _assert_frozen(ph.net, before, ("layer_0", "layer_1"))
    _assert_close(jh.net, ph.net)
    # the source net is untouched and still usable
    assert torch.equal(pnet.params["layer_2"]["W"],
                       before["layer_2"]["W"])
    assert pnet.output(x).shape == (64, 3)
    # the tail's output is the full net's
    np.testing.assert_allclose(ph.unfrozen_mln().output(pf.features),
                               ph.output(x), rtol=1e-5)


def test_tied_weights_transfer_learning():
    def build(conf, dense, out, inputs, tie):
        b = (conf.builder().seed(3).list()
             .layer(dense(n_out=8, activation="tanh"))
             .layer(dense(n_out=8, activation="tanh"))
             .layer(out(n_out=8, activation="identity", loss="mse")))
        b.tie_weights(*tie)
        return b.set_input_type(inputs.feed_forward(8)).build()

    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    y = rng.standard_normal((16, 8)).astype(np.float32)
    tie = (2, "W", 1, "W", True)
    jnet = JNet(build(JConf, JDense, JOut, JInputType, tie)).init()
    pnet = _carry(MultiLayerNetwork(build(
        NeuralNetConfiguration, DenseLayer, OutputLayer, InputType,
        tie)).init(device="cpu"), jnet)
    jh, ph = JHelper(jnet, frozen_until=0), TransferLearningHelper(
        pnet, frozen_until=0)
    assert ph.unfrozen_mln().conf.tied_weights == [[1, "W", 0, "W", True]]
    jh.fit_featurized(JDataSet(x, y))
    ph.fit_featurized(DataSet(x, y))
    assert np.isfinite(ph.unfrozen_mln().score_)
    assert ph.unfrozen_mln().score_ == pytest.approx(
        jh.unfrozen_mln().score_, rel=TOL)
    _assert_close(jh.net, ph.net)
    assert ph.featurize(DataSet(x, y)).features.shape == (16, 8)
    crossing = MultiLayerNetwork(build(
        NeuralNetConfiguration, DenseLayer, OutputLayer, InputType,
        (1, "W", 0, "W", True))).init(device="cpu")
    with pytest.raises(ValueError, match="crosses"):
        TransferLearningHelper(crossing, frozen_until=0)


def test_tied_lm_head_swap_transfer():
    jm = JGPTNano(vocab_size=16, max_len=64, seed=5, tie_embeddings=True)
    pm = GPTNano(vocab_size=16, max_len=64, seed=5, tie_embeddings=True)
    jnet = jm.init(seq_len=24)
    pnet = _carry(pm.init(24, device="cpu"), jnet)
    head = f"layer_{pm.n_layers + 2}"

    def swap(tl, out, net):
        return (tl.builder(net).remove_output_layer()
                .add_layer(out(n_out=7, activation="softmax",
                               loss="mcxent")).build())

    jnew, pnew = swap(JTL, JRnnOut, jnet), swap(TransferLearning,
                                                RnnOutputLayer, pnet)
    assert pnew.conf.tied_weights == []          # the stale tie dropped
    assert "W" in pnew.params[head]              # a fresh untied head
    _carry(pnew, jnew)
    x = np.random.default_rng(0).integers(0, 16, (2, 24)).astype(np.int32)
    out = pnew.output(x).numpy()
    assert out.shape == (2, 24, 7)
    np.testing.assert_allclose(out, np.asarray(jnew.output(x)), atol=TOL)
    kept = TransferLearning.builder(pnet).build()
    assert kept.conf.tied_weights == pnet.conf.tied_weights
    assert "W" not in kept.params[head]
    assert kept.output(x).shape == (2, 24, 16)


def test_dropped_tie_with_removed_source_restores_trained_value():
    def conf(c, dense, out, upd, inputs):
        return (c.builder().seed(3)
                .updater(upd.Sgd(learning_rate=1e-2)).list()
                .layer(dense(n_out=4, activation="tanh"))
                .layer(dense(n_out=4, activation="tanh"))
                .layer(out(n_out=4, activation="softmax", loss="mcxent"))
                .tie_weights(0, "W", 1, "W")
                .set_input_type(inputs.feed_forward(4)).build())

    jnet = JNet(conf(JConf, JDense, JOut, jupd, JInputType)).init()
    pnet = _carry(MultiLayerNetwork(conf(
        NeuralNetConfiguration, DenseLayer, OutputLayer, pupd,
        InputType)).init(device="cpu"), jnet)
    x, y = _data(32, 4, 4)
    for _ in range(3):
        jnet.fit(x, y)
        pnet.fit(x, y)
    trained_src = pnet.params["layer_1"]["W"].clone()

    def surgery(tl, out, net):
        return (tl.builder(net).remove_layers_from_output(2)
                .add_layer(out(n_out=4, activation="softmax",
                               loss="mcxent")).build())

    jnew = surgery(JTL, JOut, jnet)
    pnew = surgery(TransferLearning, OutputLayer, pnet)
    assert pnew.conf.tied_weights == [] == jnew.conf.tied_weights
    assert torch.equal(pnew.params["layer_0"]["W"], trained_src)
    np.testing.assert_allclose(pnew.params["layer_0"]["W"].numpy(),
                               np.asarray(jnew.params["layer_0"]["W"]),
                               atol=TOL)


def test_small_lm_feature_extractor_matches_jax():
    """``set_feature_extractor(2)`` on GPTNano (embedding and blocks 1-2
    frozen, the tie to the frozen embedding kept) with a fine-tune chain
    (Adam, a per-layer rate, decay and l2): 3 steps on both sides."""
    kw = dict(vocab_size=16, max_len=64, seed=5, tie_embeddings=True)
    jnet = JGPTNano(**kw).init(seq_len=24)
    pnet = _carry(GPTNano(**kw).init(24, device="cpu"), jnet)
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 16, (4, 24)).astype(np.int32),
                rng.integers(0, 16, (4, 24)).astype(np.int32))
               for _ in range(4)]
    jnet.fit(*batches[0])
    pnet.fit(*batches[0])

    def build(tl, ftc, upd, net):
        return (tl.builder(net)
                .fine_tune_configuration(ftc(
                    updater=upd.Adam(learning_rate=1e-3),
                    learning_rate=5e-3, weight_decay=0.01, l2=1e-4))
                .set_feature_extractor(2).build())

    jnew = build(JTL, JFTC, jupd, jnet)
    pnew = build(TransferLearning, FineTuneConfiguration, pupd, pnet)
    assert pnew.conf.to_json() == jnew.conf.to_json()
    assert pnew.conf.tied_weights == pnet.conf.tied_weights
    _carry(pnew, jnew)
    frozen = [f"layer_{i}" for i in range(3)]
    assert sorted(pnew._frozen()) == frozen
    before = tree.map_(torch.clone, pnew.params)
    for x, y in batches[1:]:
        jnew.fit(x, y)
        pnew.fit(x, y)
        assert pnew.score() == pytest.approx(jnew.score(), rel=TOL)
    _assert_frozen(pnew, before, frozen)
    jp = _host(jnew.params)
    for name in frozen:
        tree.map_(lambda b, a: np.testing.assert_array_equal(a, b.numpy()),
                  before[name], jp[name])
    for name in set(pnew.params) - set(frozen):
        assert any(not torch.equal(a, b) for a, b in zip(
            tree.leaves(pnew.params[name]), tree.leaves(before[name])))
    _assert_close(jnew, pnew)
    # the trainable groups' chain: a copy of the global Adam at the
    # per-layer rate, after the decay
    assert pnew._chains["layer_3"].updater.learning_rate == 5e-3
    assert pnew._chains["layer_3"].weight_decay == 0.01
    assert pnew.conf.updater.learning_rate == 1e-3
