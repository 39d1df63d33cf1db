"""The BERT masked-LM head on the CPU: ``Bert(...).conf_mlm``/``init_mlm``
and the ``ComputationGraph``'s ``RnnOutputLayer`` output, against the
JAX package.

The JAX graph's ``fit`` of this head fails (its fused head flattens the
[B, T, F] input, ``ROADMAP.md`` C), so the five reference tests that
train it stay red. Their twins here pin the documented rule instead —
the layer applied per time step (``deeplearning4j_tpu/nn/layers/
recurrent.py:378-392``): the port's loss and gradients are held against
a composition inside the test, the JAX ``mcxent`` with the labels mask
over the JAX graph's unfused forward (which the JAX ``output`` runs, and
which applies the layer per time step) and its ``jax.grad``, at the same
weights. The JAX ``output`` itself does not take the faulty branch, so
the port's ``output`` is held against it. Twins of
``tests/test_zoo.py:130`` (``test_bert_mlm_head_shapes_and_step``),
``:154`` (``test_bert_mlm_labels_mask_scopes_loss``),
``tests/test_bert_iterator.py:177`` (``test_bert_mlm_end_to_end_trains``),
``tests/test_examples.py``'s ``bert_pretrain_mlm`` and
``tests/test_train_loop.py:128`` (masked batches in a K-step region) on
BertTiny, dropout 0 where the two are compared.

Tolerances (float32, the same math in another summation order):
- probabilities: 1e-5 absolute;
- the loss: 1e-5 relative;
- each gradient: 1e-4 of its leaf's largest magnitude (measured
  ≤ 2.3e-6; the port takes log_softmax of the logits, the composition the
  log of the softmax clipped at 1e-7, which no probability here reaches);
- a K-step region against single fits: equal to the bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu.zoo.bert import BertTiny as JBertTiny
from deeplearning4j_tpu_torch import tree
from deeplearning4j_tpu_torch.data import MultiDataSet
from deeplearning4j_tpu_torch.nlp import (BertIterator,
                                          BertWordPieceTokenizer)
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.zoo import BertBase, BertTiny

PROB_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
T, B, V = 12, 4, 1000

CORPUS = ["the quick brown fox jumps over the lazy dog",
          "pack my box with five dozen liquor jugs",
          "how vexingly quick daft zebras jump",
          "the five boxing wizards jump quickly"] * 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**kw):
    """The port's BertTiny MLM graph (dropout 0) and the JAX graph of the
    same configuration holding its weights."""
    kw = {"max_len": T, "dropout": 0.0, **kw}
    net = BertTiny(**kw).init_mlm(T, device="cpu")
    jnet = JGraph(JBertTiny(**kw).conf_mlm(T))
    jnet.params = jax.tree.map(jnp.asarray, tree.map_(
        lambda t: t.numpy(), net.params))
    jnet.state = jax.tree.map(jnp.asarray, tree.map_(
        lambda t: t.numpy(), net.state))
    return net, jnet


def _batch(seed, b=B, v=V, padded=False):
    rng = np.random.default_rng(seed)
    tok = rng.integers(5, v, (b, T)).astype(np.int32)
    seg = np.zeros((b, T), np.int32)
    y = np.eye(v, dtype=np.float32)[tok]
    lmask = (rng.random((b, T)) < 0.3).astype(np.float32)
    lmask[:, 1] = 1.0
    fmask = None
    if padded:
        lens = rng.integers(4, T + 1, b)
        fmask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
        lmask = lmask * fmask
    return tok, seg, y, fmask, lmask


def _jax_loss(jnet, tok, seg, y, fmask, lmask):
    """The JAX ``mcxent`` under the labels mask over the JAX graph's
    unfused forward, as a function of the parameters."""
    masks = (None if fmask is None
             else {"tokens": jnp.asarray(fmask),
                   "segments": jnp.asarray(fmask)})
    lm = None if lmask is None else jnp.asarray(lmask)

    def loss(params):
        acts, _ = jnet._forward(params, jnet.state,
                                {"tokens": jnp.asarray(tok),
                                 "segments": jnp.asarray(seg)},
                                train=False, rng=None, masks=masks)
        return jlosses.mcxent(jnp.asarray(y), acts["mlm"], mask=lm)

    return loss


def _worst(grads, jgrads):
    jg = jax.tree.map(np.asarray, jgrads)

    def rel(path, t):
        want = jg
        for k in path:
            want = want[k]
        return (float(np.abs(t.numpy() - want).max()
                      / max(np.abs(want).max(), 1e-30)), ".".join(path))

    return max(tree.leaves(tree.map_with_path(rel, grads)))


@pytest.mark.parametrize("case", ("plain", "labels_mask", "key_masks"))
def test_mlm_loss_and_grads_match_the_jax_composition(case):
    """The fused [B, T, V] head (log_softmax of the per-time-step
    logits, the [B, T] labels mask scoping the sum over time) against
    the JAX mcxent over the unfused forward, and its gradients."""
    net, jnet = _pair()
    tok, seg, y, fmask, lmask = _batch(1, padded=case == "key_masks")
    if case == "plain":
        lmask = None
    jloss, jgrads = jax.jit(jax.value_and_grad(
        _jax_loss(jnet, tok, seg, y, fmask, lmask)))(jnet.params)
    fms = None if fmask is None else [fmask, fmask]
    lms = None if lmask is None else [lmask]
    loss, grads, _ = net._loss_and_grads([tok, seg], [y], fms, lms)
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * float(jloss)
    worst, where = _worst(grads, jgrads)
    assert worst <= GRAD_TOL, where
    assert set(grads["mlm"]) == {"W", "b"}


def test_bert_mlm_head_shapes_and_step():
    """[``test_zoo.py:130``] one fit with one-hot labels is finite; the
    output is [B, T, V] probabilities equal to the JAX ``output``'s."""
    net, jnet = _pair()
    tok, seg, y, _, _ = _batch(2)
    want = np.asarray(jnet.output(tok, seg)[0])
    out = net.output(tok, seg)[0]
    assert tuple(out.shape) == (B, T, V) == want.shape
    np.testing.assert_allclose(out.numpy(), want, atol=PROB_TOL, rtol=0)
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-5)
    net.fit([tok, seg], [y])
    assert np.isfinite(net.score())
    assert net.iteration == 1


def test_bert_mlm_labels_mask_scopes_loss():
    """[``test_zoo.py:154``] the labels mask restricts the loss to the
    scored positions: the masked score is the composition's masked loss,
    not the full one."""
    tok, seg, y, _, _ = _batch(3)
    lmask = np.zeros((B, T), np.float32)
    lmask[:, :2] = 1.0
    net, jnet = _pair()
    want = float(jax.jit(_jax_loss(jnet, tok, seg, y, None, lmask))(
        jnet.params))
    net.fit([tok, seg], [y], labels_masks=[lmask])
    s_masked = net.score()
    net2, _ = _pair()
    net2.fit([tok, seg], [y])
    s_full = net2.score()
    assert np.isfinite(s_masked) and np.isfinite(s_full)
    assert s_masked != s_full
    assert abs(s_masked - want) <= LOSS_RTOL * want


def test_mlm_update_is_the_optimizers_step_on_the_composed_gradient():
    """``fit`` applies the model's AdamW to the gradient the composition
    gives: the parameters after one step match the JAX optimizer's
    update of the JAX gradients."""
    import optax
    net, jnet = _pair()
    jnet._build_optimizer()
    tok, seg, y, fmask, lmask = _batch(4, padded=True)
    jgrads = jax.jit(jax.grad(_jax_loss(jnet, tok, seg, y, fmask,
                                        lmask)))(jnet.params)
    jparams = jax.jit(lambda g, s, p: optax.apply_updates(
        p, jnet._optimizer.update(g, s, p)[0]))(jgrads, jnet.opt_state,
                                                jnet.params)
    net.fit([tok, seg], [y], features_masks=[fmask, fmask],
            labels_masks=[lmask])
    # AdamW moves every element by about lr: compare the steps
    step = tree.map_with_path(
        lambda path, t: (float(np.abs(t.numpy() - np.asarray(
            _at(jparams, path))).max()), ".".join(path)), net.params)
    worst, where = max(tree.leaves(step))
    assert worst <= net.conf.updater.learning_rate / 3, where


def _at(t, path):
    for k in path:
        t = t[k]
    return t


def test_bert_mlm_end_to_end_trains():
    """[``test_bert_iterator.py:177``] BertTiny's MLM head trained through
    the port's ``BertIterator`` (key masks, labels masks, one-hot labels):
    the loss falls."""
    tok = BertWordPieceTokenizer(BertWordPieceTokenizer.build_vocab(CORPUS))
    net = BertTiny(vocab_size=len(tok.vocab), max_len=32,
                   updater=upd.Adam(learning_rate=1e-3),
                   seed=7).init_mlm(seq_len=16, device="cpu")
    it = BertIterator(tok, CORPUS, batch_size=4, seq_len=16, seed=4)
    s0 = None
    for _ in range(4):
        net.fit(it)
        s0 = s0 if s0 is not None else net.score()
    assert np.isfinite(net.score())
    assert net.score() < s0, (s0, net.score())


def test_bert_pretrain_mlm_example_flow():
    """[``test_examples.py``'s ``bert_pretrain_mlm``] the example's flow
    on the port, at its fast setting: two epochs with a fresh masking
    each, the loss falling, and the fill-in-the-blank probe's [1, 16, V]
    probabilities."""
    corpus = CORPUS[:4] + ["sphinx of black quartz judge my vow"]
    corpus = corpus * 8
    vocab = BertWordPieceTokenizer.build_vocab(corpus)
    tok = BertWordPieceTokenizer(vocab)
    net = BertTiny(vocab_size=len(vocab), max_len=32,
                   updater=upd.Adam(learning_rate=1e-3),
                   seed=11).init_mlm(seq_len=16, device="cpu")
    it = BertIterator(tok, corpus, batch_size=8, seq_len=16,
                      task="mask_lm", seed=1)
    s0 = None
    for _ in range(2):
        net.fit(it)
        it.reset()
        s0 = s0 if s0 is not None else net.score()
    assert net.score() < s0
    ids, segs, _ = it._encode_fixed("the quick brown fox")
    masked = list(ids)
    masked[3] = vocab["[MASK]"]
    probs = net.output(np.asarray([masked], np.int32),
                       np.asarray([segs], np.int32))[0]
    assert tuple(probs.shape) == (1, 16, len(vocab))
    assert torch.isfinite(probs).all()


def test_masked_mlm_batches_keep_the_region():
    """[``test_train_loop.py:128``, on the MLM head] batches with key and
    labels masks of one structure group into K-step regions (no
    per-batch dispatch), and the grouped fit equals single fits to the
    bit."""
    data = [_batch(10 + i, padded=True) for i in range(6)]
    a, _ = _pair()
    b, _ = _pair()
    for tok, seg, y, fm, lm in data:
        a.fit([tok, seg], [y], features_masks=[fm, fm], labels_masks=[lm])
    calls = []
    orig = b._fit_batch
    b._fit_batch = lambda *x, **k: (calls.append(1), orig(*x, **k))[1]
    b.fit([MultiDataSet([tok, seg], [y], features_masks=[fm, fm],
                        labels_masks=[lm])
           for tok, seg, y, fm, lm in data], steps_per_loop=3)
    assert not calls
    assert a.iteration == b.iteration == 6 and a.score_ == b.score_
    for x, z in zip(tree.leaves(a.params), tree.leaves(b.params)):
        assert torch.equal(x, z)


def test_mlm_config_json_is_the_jax_packages():
    """``conf_mlm``'s JSON is the JAX package's, string for string, and
    BERT-base's head has the JAX net's parameter count (checked on the
    meta device)."""
    assert BertTiny(max_len=T).conf_mlm(T).to_json() == \
        JBertTiny(max_len=T).conf_mlm(T).to_json()
    from deeplearning4j_tpu.zoo.bert import BertBase as JBertBase
    shapes = jax.eval_shape(lambda: JGraph(JBertBase().conf_mlm(128)).init(
        {"tokens": (128,), "segments": (128,)}).params)
    net = BertBase().init_mlm(128, device="meta")
    assert net.num_params() == sum(int(np.prod(s.shape))
                                   for s in jax.tree.leaves(shapes))
    assert tuple(net.params["mlm"]["W"].shape) == (768, 30522)
