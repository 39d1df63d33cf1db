"""The zip bridge on the CPU: the port's ``ModelSerializer``,
``resilience/checkpoint.py``, the configurations' JSON and the
pretrained repository, held against the JAX package's.

Twins of ``tests/test_multilayer.py`` (config JSON round trip, checkpoint
round trip, fit from an iterator and evaluate), of
``tests/test_checkpoint_resume.py`` (resume equals the uninterrupted
run, dropping the updater state diverges, keep-last-K) and of
``tests/test_zoo_pretrained.py`` (the checked-in goldens, the checksum
gate, export), and the bridge itself: a JAX zip restores in the port and
resumes along the JAX trajectory, a port zip restores in the JAX package
and resumes along the port's, for a MultiLayerNetwork and a BertTiny
graph; the ``ckpt_write`` and ``ckpt_commit`` fault plans fire at the
same write in both packages and leave no tmp file.

Tolerances:
- the configuration JSON: equal strings, both ways.
- one package's own round trip: outputs equal to 1e-6 relative (the same
  tensors restored), resumed trajectories equal to the bit (the same
  code on the same state), as in the reference tests.
- across packages: the same f32 math in another order; the steps'
  losses agree to 1e-5 relative and every parameter to 1e-5 absolute
  after 3 resumed Adam steps of lr 1e-2 (measured 3e-8 for the MLP),
  the graph's parameters to 1e-6 after 2 steps of AdamW at lr 5e-5.
"""
import json
import shutil
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import \
    ListDataSetIterator as JListIt
from deeplearning4j_tpu.data.normalizers import \
    NormalizerStandardize as JStandardize
from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import \
    MultiLayerConfiguration as JMLConf
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.resilience import faults as jfaults
from deeplearning4j_tpu.serialization import ModelSerializer as JSerializer
from deeplearning4j_tpu.zoo.bert import BertTiny as JBertTiny
from deeplearning4j_tpu_torch import tree
from deeplearning4j_tpu_torch.data import (DataSet, ListDataSetIterator,
                                           NormalizerStandardize)
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                MultiLayerConfiguration,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.preprocessors import (
    CnnToFeedForwardPreProcessor, ComposableInputPreProcessor,
    FeedForwardToCnnPreProcessor)
from deeplearning4j_tpu_torch.resilience import checkpoint, faults
from deeplearning4j_tpu_torch.serialization import (ModelSerializer,
                                                    ShardedCheckpointer)
from deeplearning4j_tpu_torch.train import CheckpointListener
from deeplearning4j_tpu_torch.zoo import BertTiny, LeNet
from deeplearning4j_tpu_torch.zoo.pretrained import (DL4JResources,
                                                     export_pretrained,
                                                     fetch_pretrained)

GOLDENS = Path(__file__).resolve().parents[1] / "resources" / "pretrained"
CROSS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp(builder, inputs, dense, out, upd, seed=9, updater="Adam", lr=1e-2,
         **ukw):
    return (builder.builder().seed(seed)
            .updater(getattr(upd, updater)(learning_rate=lr, **ukw)).list()
            .layer(dense(n_out=12, activation="tanh"))
            .layer(out(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(inputs.feed_forward(6)).build())


def _jconf(**kw):
    return _mlp(JConf, JInputType, JDense, JOut, jupd, **kw)


def _pconf(**kw):
    return _mlp(NeuralNetConfiguration, InputType, pl.DenseLayer,
                pl.OutputLayer, pupd, **kw)


def _data():
    rng = np.random.RandomState(3)
    x = rng.randn(32, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 32)]
    return x, y


def _pnet(**kw):
    return MultiLayerNetwork(_pconf(**kw)).init(device="cpu")


def _pfit(net, epochs):
    x, y = _data()
    net.fit(ListDataSetIterator([DataSet(x, y)], batch_size=32),
            epochs=epochs)


def _jfit(net, epochs):
    x, y = _data()
    net.fit(JListIt([JDataSet(x, y)], batch_size=32), epochs=epochs)


def _host(params):
    return {k: {n: t.detach().numpy() for n, t in v.items()}
            for k, v in params.items()}


def _worst(jparams, pparams):
    jp = jax.tree.map(np.asarray, jparams)
    return max(np.abs(jp[k][n] - a).max()
               for k, v in _host(pparams).items() for n, a in v.items())


# -- configuration JSON ------------------------------------------------------
def _lenet_like(conf, inputs, layers, pre):
    return (conf.builder().seed(4).weight_init_fn("xavier").list()
            .layer(layers.DenseLayer(n_out=16, activation="relu"))
            .layer(layers.ConvolutionLayer(n_out=2, kernel_size=(2, 2),
                                           padding="SAME", stride=(2, 1)))
            .layer(layers.SubsamplingLayer(pooling_type="avg"))
            .layer(layers.OutputLayer(n_out=2, activation="softmax",
                                      loss="mcxent"))
            .input_pre_processor(1, pre.FeedForwardToCnnPreProcessor(
                height=4, width=4, channels=1))
            .input_pre_processor(3, pre.CnnToFeedForwardPreProcessor())
            .set_input_type(inputs.feed_forward(8)).build())


def test_config_json_is_the_jax_packages_both_ways():
    """Twin of ``tests/test_multilayer.py::test_config_json_roundtrip``,
    and the JSON is the JAX package's, string for string."""
    from deeplearning4j_tpu.nn import layers as jl
    from deeplearning4j_tpu.nn import preprocessors as jpre
    from deeplearning4j_tpu_torch.nn import preprocessors as ppre
    pairs = [(_jconf(), _pconf()),
             (_jconf(updater="Nesterovs", momentum=0.8),
              _pconf(updater="Nesterovs", momentum=0.8)),
             (_lenet_like(JConf, JInputType, jl, jpre),
              _lenet_like(NeuralNetConfiguration, InputType, pl, ppre)),
             (jax_lenet_conf(), LeNet().conf())]
    for jc, pc in pairs:
        s = pc.to_json()
        assert s == jc.to_json()
        assert MultiLayerConfiguration.from_json(s).to_json() == s
        assert JMLConf.from_json(s).to_json() == s
    # a composable preprocessor: the JAX package writes it, but its
    # from_json leaves the chain as dicts (ROADMAP C); the port reads
    # both packages' JSON into working preprocessors
    jc, pc = pairs[2]
    jc.input_preprocessors[3] = jpre.ComposableInputPreProcessor(
        processors=(jpre.CnnToFeedForwardPreProcessor(),))
    pc.input_preprocessors[3] = ComposableInputPreProcessor(
        processors=(CnnToFeedForwardPreProcessor(),))
    assert pc.to_json() == jc.to_json()
    back = MultiLayerConfiguration.from_json(jc.to_json())
    assert back.to_json() == pc.to_json()
    assert isinstance(back.input_preprocessors[3].processors[0],
                      CnnToFeedForwardPreProcessor)
    net = MultiLayerNetwork(back).init(device="cpu")
    assert net.num_params() == MultiLayerNetwork(pc).init(
        device="cpu").num_params()


def jax_lenet_conf():
    from deeplearning4j_tpu.zoo import LeNet as JLeNet
    return JLeNet().conf()


def test_graph_config_json_is_the_jax_packages_both_ways():
    from deeplearning4j_tpu.nn.graph import \
        ComputationGraphConfiguration as JGraphConf
    from deeplearning4j_tpu_torch.nn.vertices import (MergeVertex,
                                                      PreprocessorVertex)
    jconf = JBertTiny(max_len=16).init_classifier(2, 16).conf
    pconf = BertTiny(max_len=16).conf_classifier(2, 16)
    s = pconf.to_json()
    assert s == jconf.to_json()
    assert ComputationGraphConfiguration.from_json(s).to_json() == s
    assert JGraphConf.from_json(s).to_json() == s
    g = (NeuralNetConfiguration.builder().graph_builder()
         .add_inputs("a", "b")
         .add_vertex("m", MergeVertex(), "a", "b")
         .add_vertex("p", PreprocessorVertex(
             FeedForwardToCnnPreProcessor(height=2, width=2, channels=2)),
             "m")
         .add_layer("out", pl.OutputLayer(n_out=2), "p")
         .set_outputs("out").build())
    s = g.to_json()
    back = ComputationGraphConfiguration.from_json(s)
    assert back.to_json() == s and JGraphConf.from_json(s).to_json() == s
    assert isinstance(back.nodes[1].obj.preprocessor,
                      FeedForwardToCnnPreProcessor)


def test_refused_layer_options_still_parse_and_refuse():
    # the per-layer options parse and now train; their beans cross in
    # the JAX JSON both ways
    from deeplearning4j_tpu_torch.nn.constraints import (DropConnect,
                                                         MaxNormConstraint)
    conf = _pconf()
    conf.layers[0].l2 = 1e-4
    back = MultiLayerConfiguration.from_json(conf.to_json())
    assert back.layers[0].l2 == 1e-4
    MultiLayerNetwork(back).init(device="cpu").fit(*_data())
    d = json.loads(conf.to_json())
    d["layers"][0]["constraints"] = [{"@class": "MaxNormConstraint",
                                      "apply_to_bias": False,
                                      "max_norm": 0.5}]
    d["layers"][0]["weight_noise"] = {"@class": "DropConnect",
                                      "apply_to_bias": False,
                                      "weight_retain_prob": 0.9}
    back = MultiLayerConfiguration.from_json(json.dumps(d))
    assert back.layers[0].constraints == [MaxNormConstraint(max_norm=0.5)]
    assert back.layers[0].weight_noise == DropConnect(
        weight_retain_prob=0.9)
    assert JMLConf.from_json(back.to_json()).to_json() == back.to_json()
    # a FrozenLayerWithBackprop carrying l2 is still refused (C7)
    from deeplearning4j_tpu_torch.nn.layers import FrozenLayerWithBackprop
    conf = _pconf()
    conf.layers[0] = FrozenLayerWithBackprop(underlying=conf.layers[0],
                                             l2=1e-4)
    with pytest.raises(NotImplementedError, match="C7"):
        MultiLayerNetwork(conf).init(device="cpu")


# -- one package's own round trip ---------------------------------------------
XOR_X = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32)
XOR_Y = np.array([[1, 0], [0, 1], [0, 1], [1, 0]], np.float32)


def _xor_net():
    conf = (NeuralNetConfiguration.builder().seed(42)
            .updater(pupd.Adam(learning_rate=0.05))
            .weight_init_fn("xavier").list()
            .layer(pl.DenseLayer(n_out=8, activation="tanh"))
            .layer(pl.OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.feed_forward(2)).build())
    return MultiLayerNetwork(conf).init(device="cpu")


def test_checkpoint_roundtrip(tmp_path):
    """Twin of ``tests/test_multilayer.py::test_checkpoint_roundtrip``."""
    net = _xor_net()
    for _ in range(20):
        net.fit(XOR_X, XOR_Y)
    path = tmp_path / "model.zip"
    ModelSerializer.write_model(net, path)
    net2 = ModelSerializer.restore_multi_layer_network(path, device="cpu")
    np.testing.assert_allclose(net.output(XOR_X).numpy(),
                               net2.output(XOR_X).numpy(), rtol=1e-6)
    assert net2.iteration == net.iteration
    net.fit(XOR_X, XOR_Y)
    net2.fit(XOR_X, XOR_Y)
    np.testing.assert_allclose(net.output(XOR_X).numpy(),
                               net2.output(XOR_X).numpy(), rtol=1e-5)
    assert checkpoint.verify_checkpoint(path) == (True, "ok")


def test_fit_iterator_and_evaluate():
    """Twin of ``tests/test_multilayer.py::test_fit_iterator_and_evaluate``."""
    ds = DataSet(XOR_X.repeat(8, 0), XOR_Y.repeat(8, 0))
    it = ListDataSetIterator(ds, batch_size=8, shuffle=True)
    net = _xor_net()
    net.fit(it, epochs=60)
    e = net.evaluate(it)
    assert e.accuracy() == 1.0
    assert "Accuracy" in e.stats()


def test_resume_equals_uninterrupted(tmp_path):
    """Twin of ``tests/test_checkpoint_resume.py::
    test_resume_equals_uninterrupted``: to the bit in one package."""
    ref = _pnet()
    _pfit(ref, 6)
    net = _pnet()
    _pfit(net, 3)
    path = tmp_path / "ckpt.zip"
    ModelSerializer.write_model(net, path, save_updater=True)
    del net
    back = ModelSerializer.restore_multi_layer_network(str(path),
                                                       device="cpu")
    _pfit(back, 3)
    for a, b in zip(tree.leaves(ref.params), tree.leaves(back.params)):
        assert torch.equal(a, b)
    x, y = _data()
    assert ref.score(DataSet(x, y)) == back.score(DataSet(x, y))


def test_resume_without_updater_state_diverges(tmp_path):
    ref = _pnet()
    _pfit(ref, 6)
    net = _pnet()
    _pfit(net, 3)
    path = tmp_path / "ckpt_noupd.zip"
    ModelSerializer.write_model(net, path, save_updater=False)
    with zipfile.ZipFile(path) as zf:
        assert "updater.npz" not in zf.namelist()
    back = ModelSerializer.restore_multi_layer_network(str(path),
                                                       device="cpu")
    _pfit(back, 3)
    assert max(np.abs(a - b).max() for a, b in zip(
        (t.numpy() for t in tree.leaves(ref.params)),
        (t.numpy() for t in tree.leaves(back.params)))) > 1e-4


def test_checkpoint_listener_keep_last(tmp_path):
    """Twin of ``tests/test_checkpoint_resume.py::
    test_checkpoint_listener_keep_last``; each pruned checkpoint's
    manifest goes with it."""
    x, y = _data()
    ds = DataSet(x, y)
    net = _pnet()
    net.add_listeners(CheckpointListener(tmp_path, save_every_n_epochs=1,
                                         keep_last=2))
    net.fit(ListDataSetIterator([ds], batch_size=32), epochs=5)
    ckpts = sorted(tmp_path.glob("checkpoint_*.zip"))
    assert [p.name for p in ckpts] == ["checkpoint_epoch_3.zip",
                                       "checkpoint_epoch_4.zip"]
    assert sorted(p.name for p in tmp_path.glob("*.manifest.json")) == [
        p.name + ".manifest.json" for p in ckpts]
    assert all(checkpoint.verify_checkpoint(p)[0] for p in ckpts)
    back = ModelSerializer.restore_multi_layer_network(str(ckpts[-1]),
                                                       device="cpu")
    s = back.score(ds)
    back.fit(ListDataSetIterator([ds], batch_size=32), epochs=1)
    assert back.score(ds) <= s + 1e-6


def test_sharded_checkpointing_is_refused_naming_a14(tmp_path):
    with pytest.raises(NotImplementedError, match="A14"):
        CheckpointListener(tmp_path, save_every_n_epochs=1, sharded=True)
    with pytest.raises(NotImplementedError, match="A14"):
        ShardedCheckpointer(tmp_path)


# -- the bridge ----------------------------------------------------------------
def _jnet(**kw):
    return JNet(_jconf(**kw)).init()


def _jzip_keys(path):
    with zipfile.ZipFile(path) as zf:
        return {name: set(np.load(zf.open(name)).files)
                for name in ("params.npz", "state.npz", "updater.npz")}


@pytest.mark.parametrize("updater,ukw", [
    ("Adam", {}), ("Nesterovs", {"momentum": 0.9}),
    ("AdamW", {"weight_decay": 0.01}), ("AdaDelta", {}),
    ("Sgd", {"schedule": "exp"})])
def test_port_zip_has_the_jax_zips_entries_and_keys(tmp_path, updater,
                                                    ukw):
    """The same network written by both packages: the same entries, the
    same npz keys — optax's state paths included, whose chain positions
    differ by updater (AdaDelta's moments sit at [1], AdamW's schedule
    would at [2], Sgd's learning-rate count at [1])."""
    if ukw.get("schedule") == "exp":
        jk = dict(ukw, schedule=jupd.ExponentialSchedule(0.1, 0.9))
        pk = dict(ukw, schedule=pupd.ExponentialSchedule(0.1, 0.9))
    else:
        jk = pk = ukw
    jnet = _jnet(updater=updater, **jk)
    pnet = _pnet(updater=updater, **pk)
    _jfit(jnet, 1)
    _pfit(pnet, 1)
    JSerializer.write_model(jnet, tmp_path / "j.zip")
    ModelSerializer.write_model(pnet, tmp_path / "p.zip")
    with zipfile.ZipFile(tmp_path / "j.zip") as a, \
            zipfile.ZipFile(tmp_path / "p.zip") as b:
        assert a.namelist() == b.namelist()
        assert a.read("configuration.json") == b.read("configuration.json")
        assert json.loads(a.read("meta.json")) == json.loads(
            b.read("meta.json"))
    keys = _jzip_keys(tmp_path / "j.zip")
    assert keys == _jzip_keys(tmp_path / "p.zip")
    if updater != "Sgd":
        assert any(".inner_state/[1]/" in k for k in keys["updater.npz"])
    else:
        assert keys["updater.npz"] == {
            f".inner_states/['layer_{i}']/.inner_state/[1]/[1]/.count"
            for i in range(2)}


def test_jax_zip_resumes_in_the_port_on_the_jax_trajectory(tmp_path):
    jnet = _jnet()
    _jfit(jnet, 3)
    path = tmp_path / "jax.zip"
    JSerializer.write_model(jnet, path)
    back = ModelSerializer.restore_multi_layer_network(path, device="cpu")
    assert (back.iteration, back.epoch) == (jnet.iteration, jnet.epoch)
    assert _worst(jnet.params, back.params) == 0.0
    mu = jax.tree.map(np.asarray, jnet.opt_state.inner_states[
        "layer_0"].inner_state[1][0].mu["layer_0"])
    np.testing.assert_array_equal(back.opt_state["layer_0"]["mu"]["W"],
                                  mu["W"])
    assert int(back.opt_state["layer_0"]["count"]) == 3
    for _ in range(3):
        _jfit(jnet, 1)
        _pfit(back, 1)
        assert np.isclose(back.score_, jnet.score_, rtol=CROSS_TOL, atol=0)
    assert _worst(jnet.params, back.params) <= CROSS_TOL
    # without the updater state the port's resumed run leaves the JAX one
    cold = ModelSerializer.restore_multi_layer_network(
        path, load_updater=False, device="cpu")
    _pfit(cold, 3)
    assert _worst(jnet.params, cold.params) > 100 * CROSS_TOL


def test_port_zip_resumes_in_jax_on_the_port_trajectory(tmp_path):
    pnet = _pnet()
    pnet.params_from_jax(jax.tree.map(np.asarray, _jnet().params))
    x, y = _data()
    norm = NormalizerStandardize().fit(DataSet(x, y))
    _pfit(pnet, 3)
    path = tmp_path / "port.zip"
    ModelSerializer.write_model(pnet, path, normalizer=norm)
    jback = JSerializer.restore_multi_layer_network(str(path))
    assert jback.iteration == pnet.iteration
    assert _worst(jback.params, pnet.params) == 0.0
    for _ in range(3):
        _jfit(jback, 1)
        _pfit(pnet, 1)
        assert np.isclose(pnet.score_, jback.score_, rtol=CROSS_TOL, atol=0)
    assert _worst(jback.params, pnet.params) <= CROSS_TOL
    jnorm = JSerializer.restore_normalizer(str(path))
    np.testing.assert_array_equal(jnorm.transform(x), norm.transform(x))
    # and the JAX normaliser back through a JAX zip into the port
    JSerializer.write_model(jback, tmp_path / "j.zip",
                            normalizer=JStandardize().fit(JDataSet(x, y)))
    pnorm = ModelSerializer.restore_normalizer(tmp_path / "j.zip")
    np.testing.assert_array_equal(pnorm.transform(x), norm.transform(x))
    assert ModelSerializer.restore_normalizer(
        tmp_path / "port.zip").state_dict() == norm.state_dict()


def _at(nested, path):
    for k in path:
        nested = nested[k]
    return nested


def _tiny_batch(rng, b=4, t=16):
    tok = rng.integers(0, 1000, (b, t))
    lens = rng.integers(4, t + 1, b)
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    seg = (np.arange(t)[None, :] >= (lens // 2)[:, None]).astype(np.int64)
    return tok, seg, mask, np.eye(2, dtype=np.float32)[
        rng.integers(0, 2, b)]


def test_bert_tiny_graph_zips_cross_both_ways(tmp_path):
    kw = dict(max_len=16, dropout=0.0)
    jnet = JBertTiny(**kw).init_classifier(2, 16)
    pnet = BertTiny(**kw).init_classifier(2, 16, device="cpu")
    pnet.params_from_jax(jax.tree.map(np.asarray, jnet.params))
    rng = np.random.default_rng(3)
    batches = [_tiny_batch(rng) for _ in range(4)]

    def step(net, b):
        tok, seg, mask, y = b
        net.fit([tok, seg], [y], features_masks=[mask, mask])

    for b in batches[:2]:
        step(pnet, b)
    ModelSerializer.write_model(pnet, tmp_path / "p.zip")
    jback = JSerializer.restore_computation_graph(str(tmp_path / "p.zip"))
    JSerializer.write_model(jback, tmp_path / "j.zip")
    pback = ModelSerializer.restore_computation_graph(tmp_path / "j.zip",
                                                      device="cpu")
    assert _jzip_keys(tmp_path / "p.zip") == _jzip_keys(tmp_path / "j.zip")
    for b in batches[2:]:
        step(pnet, b)
        step(jback, b)
        step(pback, b)
        assert np.isclose(jback.score_, pnet.score_, rtol=CROSS_TOL, atol=0)
        assert pback.score_ == pnet.score_
    jp = jax.tree.map(np.asarray, jback.params)
    assert max(tree.leaves(tree.map_with_path(
        lambda path, t: float(np.abs(_at(jp, path) - t.numpy()).max()),
        pnet.params))) <= 1e-6
    for a, b in zip(tree.leaves(pback.params), tree.leaves(pnet.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("site", ["ckpt_write", "ckpt_commit"])
def test_checkpoint_fault_plans_fire_at_the_same_write(tmp_path, site):
    """The same plan in both packages: the second of three writes raises
    (before the zip is built, or between the tmp file's fsync and its
    replace), the first checkpoint stays whole, and no tmp file is
    left."""
    plan = f"{site}:error=OSError:nth=2:max=1"
    runs = {"jax": (_jnet(), JSerializer, jfaults),
            "port": (_pnet(), ModelSerializer, faults)}
    raised = {}
    for name, (net, ser, fmod) in runs.items():
        d = tmp_path / name
        d.mkdir()
        raised[name] = []
        with fmod.active(plan):
            for i in range(3):
                net.iteration = i
                try:
                    ser.write_model(net, d / "ckpt.zip")
                except OSError:
                    raised[name].append(i)
                    assert json.loads(zipfile.ZipFile(
                        d / "ckpt.zip").read("meta.json"))[
                            "iteration"] == 0
        assert sorted(p.name for p in d.iterdir()) == [
            "ckpt.zip", "ckpt.zip.manifest.json"]
        assert checkpoint.verify_checkpoint(d / "ckpt.zip") == (True, "ok")
    assert raised == {"jax": [1], "port": [1]}
    faults.reset()
    ModelSerializer.write_model(runs["port"][0], tmp_path / "off.zip")
    assert faults.evaluations() == 0          # no plan: the sites cost 0


def test_verify_checkpoint_catches_damage(tmp_path):
    net = _pnet()
    path = tmp_path / "c.zip"
    ModelSerializer.write_model(net, path)
    m = json.loads(checkpoint.manifest_path(path).read_text())
    assert m["crc32"] == checkpoint.file_crc32(path)
    assert m["format_version"] == checkpoint.FORMAT_VERSION
    from deeplearning4j_tpu.resilience.checkpoint import \
        verify_checkpoint as jverify
    assert jverify(path) == (True, "ok")
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    path.write_bytes(bytes(blob))
    assert checkpoint.verify_checkpoint(path) == (
        False, "crc32 mismatch vs manifest")
    checkpoint.manifest_path(path).unlink()
    path.write_bytes(bytes(blob[:len(blob) // 3]))
    ok, why = checkpoint.verify_checkpoint(path)
    assert not ok and "zip" in why
    assert checkpoint.verify_checkpoint(tmp_path / "none.zip") == (
        False, "missing")
    checkpoint.atomic_write_bytes(tmp_path / "a.bin", b"xyz")
    assert (tmp_path / "a.bin").read_bytes() == b"xyz"
    assert not list(tmp_path.glob(".a.bin.tmp-*"))


# -- the pretrained repository --------------------------------------------------
def test_jax_minted_lenet_golden_restores_in_the_port():
    """Twin of ``tests/test_zoo_pretrained.py::
    test_init_pretrained_matches_golden_forward`` for LeNet: the JAX
    package's checked-in zip, its updater state included, restores in
    the port and reproduces the minting forward pass."""
    net = LeNet.init_pretrained(base_dir=GOLDENS, device="cpu")
    io = np.load(GOLDENS / "LeNet" / "default_golden_io.npz")
    np.testing.assert_allclose(net.output(io["x"]).numpy(), io["y"],
                               rtol=1e-5, atol=1e-6)
    assert LeNet.pretrained_available(base_dir=GOLDENS)
    assert not LeNet.pretrained_available("imagenet", base_dir=GOLDENS)


def test_checksum_gate_and_export_roundtrip(tmp_path):
    dst = tmp_path / "LeNet"
    shutil.copytree(GOLDENS / "LeNet", dst)
    art = dst / "default.zip"
    blob = bytearray(art.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    art.write_bytes(bytes(blob))
    with pytest.raises(IOError, match="checksum mismatch"):
        fetch_pretrained("LeNet", "default", tmp_path)
    with pytest.raises(FileNotFoundError, match="no pretrained"):
        fetch_pretrained("LeNet", "default", tmp_path / "empty")
    with pytest.raises(RuntimeError, match="downloads nothing"):
        DL4JResources.resolve("https://example.invalid/lenet.zip")
    assert DL4JResources.resolve("file:///x/y") == Path("/x/y")
    net = LeNet(num_classes=10, seed=5, input_shape=(14, 14, 1)).init(
        device="cpu")
    x = np.random.default_rng(3).normal(size=(2, 14, 14, 1)).astype(
        np.float32)
    repo = tmp_path / "repo"
    export_pretrained(net, "LeNet", "custom", base_dir=repo)
    back = LeNet.init_pretrained("custom", base_dir=repo, device="cpu")
    np.testing.assert_allclose(back.output(x).numpy(),
                               net.output(x).numpy(), rtol=1e-6)
    manifest = json.loads((repo / "LeNet" / "manifest.json").read_text())
    assert manifest["custom"]["format"] == "multilayer"
    from deeplearning4j_tpu.zoo import LeNet as JLeNet
    jback = JLeNet.init_pretrained("custom", base_dir=repo)
    np.testing.assert_allclose(np.asarray(jback.output(x)),
                               net.output(x).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_zip_of_a_zero_wrapped_net_holds_the_live_moments(tmp_path):
    """While a ZeRO ``ParallelWrapper`` owns the optimizer state (here
    at one rank of an in-process gloo group) the zip folds its live
    shards back, not the host copy evicted at its first step (the JAX
    package's ``_zero_wrapper`` rule): the restored net resumes on the
    wrapper's trajectory."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                                   initialize_distributed)
    assert not dist.is_initialized()
    initialize_distributed()
    try:
        net = _pnet()
        w = ParallelWrapper(net, sharded_update=True, prefetch_buffer=0)
        x, y = _data()
        w.fit(ListDataSetIterator([DataSet(x, y)] * 3))
        stale = net.opt_state
        assert int(stale["layer_0"]["count"]) == 0
        path = tmp_path / "zero.zip"
        ModelSerializer.write_model(net, path)
        back = ModelSerializer.restore_multi_layer_network(path,
                                                           device="cpu")
        live = w.gather_opt_state()
        assert int(back.opt_state["layer_0"]["count"]) == 3
        for a, b in zip(tree.leaves(back.opt_state), tree.leaves(live)):
            assert torch.equal(a, b.cpu())
        w.fit(ListDataSetIterator([DataSet(x, y)]))
        back.fit(x, y)
        for a, b in zip(tree.leaves(back.params), tree.leaves(net.params)):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()



def _transferred(pkg_conf, inputs, dense, out, upd, tl, ftc, jax_side,
                 layer_updater):
    """A 3-layer net transferred with a frozen first layer under a
    fine-tune chain (Adam, a per-layer rate, decay, l2); with
    ``layer_updater`` its middle layer keeps its own updater bean."""
    kw = ({"updater": upd.Nesterovs(learning_rate=0.05, momentum=0.8)}
          if layer_updater else {})
    conf = (pkg_conf.builder().seed(4)
            .updater(upd.Sgd(learning_rate=0.1)).list()
            .layer(dense(n_out=10, activation="tanh"))
            .layer(dense(n_out=10, activation="tanh", **kw))
            .layer(out(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(inputs.feed_forward(6)).build())
    src = JNet(conf).init() if jax_side else MultiLayerNetwork(conf).init(
        device="cpu")
    return (tl.builder(src)
            .fine_tune_configuration(ftc(updater=upd.Adam(
                learning_rate=1e-2), learning_rate=5e-3,
                weight_decay=0.01, l2=1e-4))
            .set_feature_extractor(0).build())


@pytest.mark.parametrize("layer_updater", [True, False],
                         ids=["layer_updater", "layer_rate"])
def test_transferred_net_zips_cross_both_ways(tmp_path, layer_updater):
    """A transferred net (a frozen prefix, per-group updaters, weight
    decay, l2) written by both packages: the same entries and
    ``updater.npz`` keys (none for the frozen group, the updater at [2]
    after ``add_decayed_weights``, each group's own updater); a JAX zip
    resumes in the port on the JAX trajectory and a port zip in JAX on
    the port's, the frozen group equal to the bit. A per-layer updater
    bean the JAX package cannot read back (its ``layer_from_dict`` takes
    it for a layer, ROADMAP.md C8), from either package's zip; the port
    reads it."""
    from deeplearning4j_tpu.nn import FineTuneConfiguration as JFTC
    from deeplearning4j_tpu.nn import TransferLearning as JTL
    from deeplearning4j_tpu_torch.nn import (FineTuneConfiguration,
                                             TransferLearning)
    jnet = _transferred(JConf, JInputType, JDense, JOut, jupd, JTL, JFTC,
                        True, layer_updater)
    pnet = _transferred(NeuralNetConfiguration, InputType, pl.DenseLayer,
                        pl.OutputLayer, pupd, TransferLearning,
                        FineTuneConfiguration, False, layer_updater)
    pnet.params_from_jax(jax.tree.map(np.asarray, jnet.params))
    _jfit(jnet, 2)
    _pfit(pnet, 2)
    JSerializer.write_model(jnet, tmp_path / "j.zip")
    ModelSerializer.write_model(pnet, tmp_path / "p.zip")
    with zipfile.ZipFile(tmp_path / "j.zip") as a, \
            zipfile.ZipFile(tmp_path / "p.zip") as b:
        assert a.read("configuration.json") == b.read("configuration.json")
    keys = _jzip_keys(tmp_path / "j.zip")
    assert keys == _jzip_keys(tmp_path / "p.zip")
    upd_keys = keys["updater.npz"]
    assert not any("['layer_0']/.inner_state" in k for k in upd_keys)
    assert any(k.startswith(".inner_states/['layer_1']/.inner_state/[2]/"
                            "[0]/" + (".trace" if layer_updater else ".mu"))
               for k in upd_keys)
    assert any(k.startswith(".inner_states/['layer_2']/.inner_state/[2]/"
                            "[0]/.mu") for k in upd_keys)
    frozen = pnet.params["layer_0"]["W"].clone()
    pback = ModelSerializer.restore_multi_layer_network(tmp_path / "j.zip",
                                                        device="cpu")
    for _ in range(2):
        _jfit(jnet, 1)
        _pfit(pback, 1)
        assert np.isclose(pback.score_, jnet.score_, rtol=CROSS_TOL, atol=0)
    assert _worst(jnet.params, pback.params) <= CROSS_TOL
    assert torch.equal(pback.params["layer_0"]["W"], frozen)
    if layer_updater:
        for path in ("j.zip", "p.zip"):
            with pytest.raises(ValueError, match="Unknown layer class"):
                JSerializer.restore_multi_layer_network(str(tmp_path / path))
        return
    jback = JSerializer.restore_multi_layer_network(str(tmp_path / "p.zip"))
    for _ in range(2):
        _jfit(jback, 1)
        _pfit(pnet, 1)
        assert np.isclose(pnet.score_, jback.score_, rtol=CROSS_TOL, atol=0)
    assert _worst(jback.params, pnet.params) <= CROSS_TOL
    assert torch.equal(pnet.params["layer_0"]["W"], frozen)
    np.testing.assert_array_equal(np.asarray(jback.params["layer_0"]["W"]),
                                  frozen.numpy())
