"""The fine-tune slice on the CPU: BERT's layers, activations and loss,
and the port's BertTiny classifier built by ``init_classifier`` and
trained by ``ComputationGraph.fit``, against the JAX package's, from the
same carried-across weights (``ComputationGraph.params_from_jax``) and
the same numpy batches: padded sentence pairs with key masks, as GLUE
fine-tuning feeds them, and the model's default AdamW (lr 2e-5) on both
sides. Dropout is 0 where the two are compared step for step: a
``torch.Generator`` draws other masks than ``jax.random``.

Tolerances:
- float32 layer outputs and gradients, classifier outputs: 1e-5
  absolute — the same math in another summation order.
- float32 training: losses 1e-5 relative per step (measured ≤ 3.7e-7).
  After three steps each parameter tensor on its own has 99.5 % of its
  elements within 1e-6 and all within lr/3. Adam scales every element's
  step to about lr whatever its gradient's size, so an element whose
  gradient lies within f32 rounding of zero may step a little
  differently on the two sides: over four seeds at most one element of
  a tensor left 1e-6 (worst 3.1e-6, one of the 256 of the segment
  embedding). A tensor given a wrong update moves most of its elements
  by about lr a step and fails.
- bfloat16 compute: both packages cast the f32 masters to bf16 inside
  the gradient and round at every op, in different places. Losses within
  5e-3 relative (measured ≤ 3.2e-3). Each parameter tensor on its own
  has 95 % of its elements within lr/3 (measured ≥ 97.6 %): a tensor
  given a wrong update moves most of its elements by about lr a step and
  fails; every element is within 2 · lr · steps, the most two Adam
  trajectories of about lr a step can part (measured ≤ 8.9e-5 of 1.2e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu.zoo.bert import BertBase as JBertBase
from deeplearning4j_tpu.zoo.bert import BertTiny as JBertTiny
from deeplearning4j_tpu_torch import tree
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.ops import activations as pact
from deeplearning4j_tpu_torch.ops import losses as plosses
from deeplearning4j_tpu_torch.zoo import BertBase, BertTiny

TOL = 1e-5
LR = 2e-5            # the model's default AdamW learning rate
STEPS = 3
T, B = 16, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch(tree_, grad=False):
    return jax.tree.map(
        lambda a: torch.tensor(np.asarray(a)).requires_grad_(grad), tree_)


def _close(ours, theirs, tol=TOL, what=""):
    ours = jax.tree.map(lambda t: t.detach().float().numpy(), ours,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))
    jax.tree.map(lambda o, t: np.testing.assert_allclose(
        o, np.asarray(t, np.float32), atol=tol, rtol=0, err_msg=what),
        ours, theirs)


# -- layers: forward and gradients against JAX apply --------------------------
def _layer_cases():
    f, t = 16, 9
    rng = np.random.default_rng(0)
    xf = rng.normal(size=(3, t, f)).astype(np.float32)
    mask = np.ones((3, t), np.float32)
    mask[1, 6:] = 0.0
    mask[2, 2:] = 0.0
    return [
        # (id, jax layer, port layer, input shape for init, x, mask)
        ("layer_norm", jl.LayerNormalization(), pl.LayerNormalization(),
         (t, f), xf, None),
        ("positional", jl.PositionalEmbeddingLayer(max_len=12),
         pl.PositionalEmbeddingLayer(max_len=12), (t, f), xf, None),
        ("encoder_block", jl.TransformerEncoderBlock(n_heads=4),
         pl.TransformerEncoderBlock(n_heads=4), (t, f), xf, None),
        ("encoder_block_key_mask", jl.TransformerEncoderBlock(n_heads=2),
         pl.TransformerEncoderBlock(n_heads=2), (t, f), xf, mask),
        ("cls_pooler", jl.ClsTokenPoolLayer(pooler=True, n_out=5),
         pl.ClsTokenPoolLayer(pooler=True, n_out=5), (t, f), xf, mask),
        ("cls_raw", jl.ClsTokenPoolLayer(), pl.ClsTokenPoolLayer(),
         (t, f), xf, None),
        ("dropout_eval", jl.DropoutLayer(dropout=0.3),
         pl.DropoutLayer(dropout=0.3), (t, f), xf, None),
    ]


@pytest.mark.parametrize("case", _layer_cases(), ids=lambda c: c[0])
def test_layer_forward_and_grads_match_jax(case):
    _, jlayer, player, shape, x, mask = case
    jparams, _, jshape = jlayer.init(jax.random.PRNGKey(1), shape)
    pparams, _, pshape = player.init(torch.Generator().manual_seed(1),
                                     shape)
    assert tuple(pshape) == tuple(jshape)
    assert jax.tree.map(np.shape, jparams) == jax.tree.map(
        lambda t: tuple(t.shape), pparams,
        is_leaf=lambda t: isinstance(t, torch.Tensor))
    jm = None if mask is None else jnp.asarray(mask)
    jy, _ = jlayer.apply(jparams, {}, jnp.asarray(x), mask=jm)
    w = np.random.default_rng(2).normal(size=jy.shape).astype(np.float32)

    def loss(p, x):
        y, _ = jlayer.apply(p, {}, x, mask=jm)
        return jnp.sum(y * w)

    jgrads = jax.grad(loss, argnums=(0, 1))(jparams, jnp.asarray(x))
    params = _to_torch(jparams, grad=True)
    tx = torch.tensor(x).requires_grad_()
    pm = None if mask is None else torch.tensor(mask)
    y, _ = player.apply(params, {}, tx, mask=pm)
    _close(y, jy, what="forward")
    (y * torch.tensor(w)).sum().backward()
    grads = jax.tree.map(lambda t: t.grad, params,
                         is_leaf=lambda t: isinstance(t, torch.Tensor))
    _close(grads, jgrads[0], what="param grads")
    _close(tx.grad, jgrads[1], what="input grad")
    assert (player.propagate_mask(pm, None) is None) == (
        jlayer.propagate_mask(jm, None) is None)


def test_encoder_block_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation; the erf form
    differs by ~1e-3, which the f32 parity above would catch."""
    x = torch.linspace(-4, 4, 101)
    tanh_form = pact.get("gelu_tanh")(x)
    assert (tanh_form - pact.get("gelu")(x)).abs().max() > 1e-4
    np.testing.assert_allclose(
        tanh_form.numpy(), np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()))),
        atol=1e-6, rtol=0)


def test_dropout_layer_is_seeded_inverted_dropout():
    layer = pl.DropoutLayer(dropout=0.25)
    assert pl.DropoutLayer().dropout == 0.5
    x = torch.ones(64, 64)
    y, _ = layer.apply({}, {}, x, train=True, rng=7)
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.03
    y2, _ = layer.apply({}, {}, x, train=True, rng=7)
    assert torch.equal(y, y2)
    assert torch.equal(layer.apply({}, {}, x, train=False)[0], x)


@pytest.mark.parametrize("name", ["gelu", "gelu_tanh", "tanh", "relu"])
def test_activations_match_jax(name):
    x = np.random.default_rng(3).normal(size=(5, 7)).astype(np.float32) * 3
    np.testing.assert_allclose(
        pact.get(name)(torch.tensor(x)).numpy(),
        np.asarray(jact.get(name)(jnp.asarray(x))), atol=1e-6, rtol=0)


@pytest.mark.parametrize("from_logits", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_mcxent_matches_jax(from_logits, masked):
    rng = np.random.default_rng(4)
    z = rng.normal(size=(6, 5, 4)).astype(np.float32)
    preds = z if from_logits else np.asarray(jax.nn.softmax(z, axis=-1))
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (6, 5))]
    mask = (rng.random((6, 5)) > 0.3).astype(np.float32) if masked else None
    weights = np.array([1.0, 2.0, 0.5, 1.5], np.float32)
    for w in (None, weights):
        kw = {"from_logits": True} if from_logits else {}
        theirs = jlosses.mcxent(jnp.asarray(labels), jnp.asarray(preds),
                                mask=None if mask is None
                                else jnp.asarray(mask), weights=w, **kw)
        tp = torch.tensor(preds).requires_grad_()
        ours = plosses.get("mcxent")(
            torch.tensor(labels), tp,
            mask=None if mask is None else torch.tensor(mask), weights=w,
            **kw)
        assert ours.item() == pytest.approx(float(theirs), rel=TOL)
        jg = jax.grad(lambda p: jlosses.mcxent(
            jnp.asarray(labels), p,
            mask=None if mask is None else jnp.asarray(mask), weights=w,
            **kw))(jnp.asarray(preds))
        ours.backward()
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg),
                                   atol=TOL, rtol=0)
    assert plosses.get("negativeloglikelihood") is plosses.mcxent


def test_adamw_mask_excludes_bert_biases_and_norms_and_decays_pos():
    """The model's AdamW: no decay on BERT's ``b1``, ``b2``, ``bo``,
    ``b``, ``gamma`` and ``beta``; ``pos`` and every weight matrix
    decay, as the JAX package's optax mask decides."""
    u = BertTiny().updater
    assert isinstance(u, pupd.AdamW) and u.exclude_bias_and_norm
    assert (u.learning_rate, u.weight_decay) == (LR, 0.01)
    for key in ("b1", "b2", "bo", "b", "gamma", "beta"):
        assert not u._decays(("enc_0", key))
    for key in ("pos", "W", "W1", "W2", "Wq", "Wk", "Wv", "Wo"):
        assert u._decays(("enc_0", key))


# -- the classifier graph against the JAX one ---------------------------------
def _pair(compute_dtype=None):
    kw = dict(max_len=T, dropout=0.0, compute_dtype=compute_dtype)
    jnet = JBertTiny(**kw).init_classifier(2, T)
    pnet = BertTiny(**kw).init_classifier(2, T, device="cpu")
    pnet.params_from_jax(jax.tree.map(np.asarray, jnet.params))
    return jnet, pnet


def _batch(rng, b=B):
    """A padded sentence-pair batch: tokens, segments 0 then 1 from a
    per-row split, a key mask of each row's length (>= 4), one-hot
    labels."""
    tok = rng.integers(0, 1000, (b, T))
    lens = rng.integers(4, T + 1, b)
    split = rng.integers(1, lens)
    seg = (np.arange(T)[None, :] >= split[:, None]).astype(np.int64)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)]
    return tok, seg, mask, y


def _leaf_diffs(jnet, pnet):
    """|JAX − port| per parameter tensor, by its key path."""
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), jnet.params)
    pp = tree.map_(lambda t: t.detach().float().numpy(), pnet.params)
    assert jax.tree.structure(jp) == jax.tree.structure(pp)
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    return {k: np.abs(a - b).ravel() for k, a, b in zip(
        paths, jax.tree.leaves(jp), jax.tree.leaves(pp))}


def test_classifier_output_matches_jax_with_and_without_key_mask():
    jnet, pnet = _pair()
    assert pnet.num_params() == jnet.num_params()
    tok, seg, mask, _ = _batch(np.random.default_rng(10))
    ours = pnet.output(tok, seg)[0].numpy()
    np.testing.assert_allclose(ours, np.asarray(jnet.output(tok, seg)[0]),
                               atol=TOL, rtol=0)
    # the JAX output() takes no mask: its forward with the masks
    acts, _ = jnet._forward(
        jnet.params, jnet.state,
        {"tokens": jnp.asarray(tok), "segments": jnp.asarray(seg)},
        train=False, rng=None,
        masks={"tokens": jnp.asarray(mask), "segments": jnp.asarray(mask)})
    masked = pnet.output(tok, seg, features_masks=[mask, mask])[0].numpy()
    np.testing.assert_allclose(masked, np.asarray(acts["cls"]), atol=TOL,
                               rtol=0)
    assert np.abs(masked - ours).max() > 1e-3    # the mask took effect
    np.testing.assert_allclose(
        pnet.output_single(tok, seg, features_masks=[mask, mask]).numpy(),
        masked, atol=0, rtol=0)


def test_fit_steps_match_jax_f32():
    jnet, pnet = _pair()
    rng = np.random.default_rng(11)
    for _ in range(STEPS):
        tok, seg, mask, y = _batch(rng)
        jnet.fit([tok, seg], [y], features_masks=[mask, mask])
        pnet.fit([tok, seg], [y], features_masks=[mask, mask])
        assert np.isclose(pnet.score(), jnet.score(), rtol=TOL, atol=0)
    for key, d in _leaf_diffs(jnet, pnet).items():
        assert (d <= 1e-6).mean() >= 0.995, (key, (d <= 1e-6).mean())
        assert d.max() <= LR / 3, (key, d.max())
    assert pnet.iteration == STEPS


def test_fit_steps_match_jax_bf16_compute():
    jnet, pnet = _pair(compute_dtype="bfloat16")
    rng = np.random.default_rng(11)
    for _ in range(STEPS):
        tok, seg, mask, y = _batch(rng)
        jnet.fit([tok, seg], [y], features_masks=[mask, mask])
        pnet.fit([tok, seg], [y], features_masks=[mask, mask])
        assert np.isclose(pnet.score(), jnet.score(), rtol=5e-3, atol=0)
    # the masters and the optimizer state stay f32
    assert all(t.dtype == torch.float32
               for t in tree.leaves(pnet.params))
    assert all(t.dtype in (torch.float32, torch.int32)
               for t in tree.leaves(pnet.opt_state))
    assert pnet.output(*_batch(rng)[:2])[0].dtype == torch.float32
    for key, d in _leaf_diffs(jnet, pnet).items():
        assert (d <= LR / 3).mean() >= 0.95, (key, (d <= LR / 3).mean())
        assert d.max() <= 2 * LR * STEPS, (key, d.max())


def test_bert_tiny_classifier_learns():
    """Twin of ``tests/test_zoo.py::test_bert_tiny_classifier_learns``
    (dropout 0.1, the port's own random weights)."""
    net = BertTiny(max_len=T).init_classifier(num_classes=2, seq_len=T,
                                              device="cpu")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 1000, (8, T))
    seg = np.zeros((8, T), np.int64)
    y = np.eye(2, dtype=np.float32)[(tok[:, 0] < 500).astype(int)]
    for _ in range(60):
        net.fit([tok, seg], [y])
    assert net.score() < 0.3
    out = net.output(tok, seg)[0]
    assert out.shape == (8, 2)
    assert np.allclose(out.sum(-1).numpy(), 1, atol=1e-3)


def test_bert_base_param_count_matches_jax():
    """BERT-base's 110M parameters: the JAX count from ``eval_shape``
    (no arrays), the port's from a graph on the meta device."""
    conf = JBertBase().conf_classifier(2, 128)
    shapes = jax.eval_shape(lambda: JGraph(conf).init(
        {"tokens": (128,), "segments": (128,)}).params)
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    net = BertBase().init_classifier(2, 128, device="meta")
    assert net.num_params() == want
    assert 109e6 < want < 111e6
    layer_keys = {n.name for n in net.order if n.kind == "layer"}
    assert set(net.params) == layer_keys
    assert jax.tree.map(lambda s: tuple(s.shape), shapes) == tree.map_(
        lambda t: tuple(t.shape), net.params)


def test_mlm_head_raises_naming_the_reference_fault():
    for call in (lambda: BertTiny().conf_mlm(8),
                 lambda: BertTiny().init_mlm(8, device="cpu")):
        with pytest.raises(NotImplementedError, match="graph.py:290-298"):
            call()
