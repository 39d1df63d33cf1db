"""The training slice as a whole on the CPU: the port's GPTNano trained
through ``CausalTransformerLM.init`` → ``MultiLayerNetwork.fit`` against
the JAX package's, from the same carried-across weights and the same
numpy batches, with the model's default AdamW on both sides.

Tolerances:
- float32 losses: 1e-5 relative per step (the same math in another
  summation order; measured ~2e-7).
- float32 parameters after 3 steps: 99.9 % of the elements within 1e-6,
  all within 1e-4. Adam scales every element's step to about the
  learning rate (3e-4) whatever its gradient's size, so an element whose
  gradient lies within f32 rounding of zero may step differently on the
  two sides; the bound keeps such an element under a third of one step.
- bfloat16 compute: both packages cast the f32 masters to bf16 inside
  the gradient and round at every op, in different places, so the
  gradients differ at the bf16 level and Adam turns that into
  differences of a fraction of lr per step; losses within 2e-3 relative
  (measured ≤ 5.5e-4). Each parameter tensor on its own has 97 % of
  its elements within 1e-4, a third of one step (measured ≥ 98.4 %, the
  worst a 128-element bias with 2 elements outside): a tensor given a
  wrong update, such as a wrong dγ, moves most of its elements by about
  lr a step and fails. Every element is within 2 · lr · steps, the most
  two Adam trajectories of 3 steps of about lr each can part when
  near-zero gradients point opposite ways (measured ≤ 1.5e-3).
- remat against no remat, one package: recomputing the same f32 ops
  gives the same numbers, 1e-6.
"""
import inspect

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.zoo.gpt import GPTNano as JaxGPTNano
from deeplearning4j_tpu_torch import tree
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo.gpt import (CausalTransformerLM,
                                              GPTNano)

LR = 3e-4            # the model's default AdamW learning rate
STEPS = 3
KW = dict(vocab_size=16, max_len=64, seed=5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seq_len=24, **kw):
    jm = JaxGPTNano(**KW, **kw)
    jnet = jm.init(seq_len=seq_len)
    pm = GPTNano(**KW, **kw)
    pnet = pm.init(seq_len, device="cpu")
    pnet.params_from_jax(jax.tree.map(np.asarray, jnet.params))
    return jm, jnet, pm, pnet


def _batches(n, b=4, t=24, vocab=16, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (b, t)).astype(np.int32),
             rng.integers(0, vocab, (b, t)).astype(np.int32))
            for _ in range(n)]


def _leaf_diffs(jnet, pnet):
    """|JAX − port| per parameter tensor, by its key path."""
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), jnet.params)
    pp = tree.map_(lambda t: t.detach().float().numpy(), pnet.params)
    assert jax.tree.structure(jp) == jax.tree.structure(pp)
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    return {k: np.abs(a - b).ravel() for k, a, b in zip(
        paths, jax.tree.leaves(jp), jax.tree.leaves(pp))}


def _param_diffs(jnet, pnet):
    return np.concatenate(list(_leaf_diffs(jnet, pnet).values()))


@pytest.mark.parametrize("kw", [{}, {"tie_embeddings": True}],
                         ids=["untied", "tied"])
def test_fit_steps_match_jax_f32(kw):
    _, jnet, _, pnet = _pair(**kw)
    for x, y in _batches(STEPS):
        jnet.fit(x, y)
        pnet.fit(x, y)
        assert np.isclose(pnet.score(), jnet.score(), rtol=1e-5, atol=0)
    d = _param_diffs(jnet, pnet)
    assert (d <= 1e-6).mean() >= 0.999, (d <= 1e-6).mean()
    assert d.max() <= 1e-4, d.max()
    assert pnet.iteration == STEPS
    assert pnet.num_params() == jnet.num_params()
    if kw:
        # tied: the head's W is no master parameter on either side
        assert "W" not in pnet.params["layer_6"]


def test_fit_steps_match_jax_bf16_compute():
    _, jnet, _, pnet = _pair(compute_dtype="bfloat16")
    for x, y in _batches(STEPS, seed=1):
        jnet.fit(x, y)
        pnet.fit(x, y)
        assert np.isclose(pnet.score(), jnet.score(), rtol=2e-3, atol=0)
    # the masters and the optimizer state stay f32
    assert all(t.dtype == torch.float32
               for t in tree.leaves(pnet.params))
    for key, d in _leaf_diffs(jnet, pnet).items():
        assert (d <= 1e-4).mean() >= 0.97, (key, (d <= 1e-4).mean())
        assert d.max() <= 2 * LR * STEPS, (key, d.max())


def test_remat_equals_plain_block():
    nets = [GPTNano(**KW, remat=remat).init(24, device="cpu")
            for remat in (False, True)]
    for x, y in _batches(2, seed=2):
        for net in nets:
            net.fit(x, y)
        assert nets[0].score() == pytest.approx(nets[1].score(),
                                                rel=1e-6)
    for a, b in zip(tree.leaves(nets[0].params),
                    tree.leaves(nets[1].params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def toy_lm():
    """Twin of ``tests/test_gpt.py``'s fixture: GPTNano trained on a
    deterministic repeating token pattern, on the CPU."""
    model = GPTNano(vocab_size=16, max_len=64, seed=5)
    net = model.init(seq_len=24, device="cpu")
    period = 5
    tokens = np.arange(24 + 1) % period + 1          # 1..5 repeating
    x = np.tile(tokens[:24], (8, 1)).astype(np.int32)
    y = np.tile(tokens[1:25], (8, 1)).astype(np.int32)
    s0 = None
    for _ in range(60):
        net.fit(x, y)
        s0 = s0 if s0 is not None else net.score()
    return model, net, s0, period


def test_lm_trains(toy_lm):
    model, net, s0, _ = toy_lm
    assert net.score() < s0 * 0.2, (net.score(), s0)


def test_generate_matches_training_forward(toy_lm):
    """The KV-cached decode of the trained network agrees with the
    training-time forward, and continues the pattern."""
    model, net, _, period = toy_lm
    prompt = (np.arange(9) % period + 1)[None, :].astype(np.int32)
    out = model.generate(net, prompt, n_new=6)
    probs = net.output(prompt).numpy()               # [1, 9, V]
    assert out[0, 9] == int(np.argmax(probs[0, -1]))
    np.testing.assert_array_equal(out[0, 9:],
                                  np.arange(9, 15) % period + 1)
    np.testing.assert_array_equal(
        out, model.generate(net.params, prompt, n_new=6))


def test_output_and_score_match_jax():
    class DataSet:
        def __init__(self, x, y):
            self.features, self.labels = x, y

    _, jnet, _, pnet = _pair()
    (x, y), = _batches(1, seed=3)
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-5,
                               rtol=0)
    ds = DataSet(x, y)
    assert pnet.score(ds) == pytest.approx(jnet.score(ds), rel=1e-5)


def test_iterator_fit_with_steps_per_loop_equals_single_fits():
    batches = _batches(3, seed=4)
    a = GPTNano(**KW).init(24, device="cpu")
    b = GPTNano(**KW).init(24, device="cpu")
    for x, y in batches:
        a.fit(x, y)
    b.fit(iter(batches), epochs=1, steps_per_loop=2)
    assert b.iteration == 3 and b.epoch == 1
    for p, q in zip(tree.leaves(a.params), tree.leaves(b.params)):
        assert torch.equal(p, q)


def test_params_from_jax_checks_the_tree():
    jm = JaxGPTNano(**KW)
    jtree = jax.tree.map(np.asarray, jm.init(seq_len=24).params)
    net = GPTNano(**KW).init(24, device="cpu")
    jtree["layer_2"]["Wg"] = jtree["layer_2"]["Wg"][:, :-1]
    with pytest.raises(ValueError, match="Wg"):
        net.params_from_jax(jtree)
    del jtree["layer_2"]
    with pytest.raises(ValueError, match="keys"):
        net.params_from_jax(jtree)
    with pytest.raises(RuntimeError, match="init"):
        MultiLayerNetwork(GPTNano(**KW).conf(24)).params_from_jax(jtree)


def test_unported_options_raise_naming_the_slice():
    with pytest.raises(NotImplementedError, match="parallel/"):
        GPTNano(**KW, sequence_parallel="ring")

    def net_with(**layer_kw):
        conf = (NeuralNetConfiguration.builder().list()
                .layer(pl.EmbeddingSequenceLayer(n_in=8, n_out=4))
                .layer(pl.RnnOutputLayer(n_out=8, activation="softmax",
                                         loss="sparse_mcxent",
                                         **layer_kw))
                .set_input_type(InputType.recurrent(1, 5)).build())
        return MultiLayerNetwork(conf)

    for kw in ({"l2": 1e-4}, {"learning_rate": 0.1},
               {"weight_decay": 0.1}, {"trainable": False}):
        with pytest.raises(NotImplementedError, match="slice"):
            net_with(**kw).init(device="cpu")
    net = net_with().init(device="cpu")
    with pytest.raises(NotImplementedError, match="listeners"):
        net.set_listeners(object())
    net.conf.backprop_type = "TruncatedBPTT"
    with pytest.raises(NotImplementedError, match="recurrent slice"):
        MultiLayerNetwork(net.conf).init(device="cpu")


def test_entry_points_default_to_the_card():
    for fn in (MultiLayerNetwork.init, CausalTransformerLM.init):
        assert inspect.signature(fn).parameters["device"].default == \
            "cuda"
