"""The training slice's building blocks against the JAX package on the
CPU: every ported layer class (forward and gradients, JAX parameters
carried across), the updaters against optax, the sparse cross-entropy
against the JAX loss, and the configuration builder.

Tolerances (float32 unless stated): 1e-5 absolute for layer outputs and
gradients — the same math in another summation order; 1e-6 for the
updaters over three steps — elementwise arithmetic in the same order as
optax, the only difference the last bit of a division or square root;
1e-5 for the loss and its gradient. bfloat16 logits: the loss is taken
in f32 on both sides (1e-5 relative); the logit gradient is rounded to
bf16 once in the port and twice in JAX (the softmax and the one-hot
terms are rounded before their sum), so 2 bf16 ulps of the largest
gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu_torch.nn import config as pconf
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.nn import weights as pweights
from deeplearning4j_tpu_torch.nn.layers.base import fold_in, split_seed
from deeplearning4j_tpu_torch.ops import activations as pact
from deeplearning4j_tpu_torch.ops import losses as plosses

TOL = 1e-5
UPD_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch(tree, grad=False):
    return jax.tree.map(
        lambda a: torch.tensor(np.asarray(a)).requires_grad_(grad), tree)


def _close(ours, theirs, tol=TOL, what=""):
    ours = jax.tree.map(lambda t: t.detach().float().numpy(), ours,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))
    jax.tree.map(lambda o, t: np.testing.assert_allclose(
        o, np.asarray(t, np.float32), atol=tol, rtol=0, err_msg=what),
        ours, theirs)


# -- layers: forward and gradients against JAX apply ---------------------------
def _layer_cases():
    f, t = 16, 9
    rng = np.random.default_rng(0)
    xf = rng.normal(size=(3, t, f)).astype(np.float32)
    x2 = rng.normal(size=(4, 6)).astype(np.float32)
    ids = rng.integers(0, 10, (3, t)).astype(np.int32)
    mask = np.ones((3, t), np.float32)
    mask[1, 6:] = 0.0
    return [
        # (id, jax layer, port layer, input shape for init, x, mask)
        ("dense", jl.DenseLayer(n_in=6, n_out=5, activation="silu"),
         pl.DenseLayer(n_in=6, n_out=5, activation="silu"), (6,), x2,
         None),
        ("output", jl.OutputLayer(n_in=6, n_out=5, activation="softmax"),
         pl.OutputLayer(n_in=6, n_out=5, activation="softmax"), (6,), x2,
         None),
        ("embedding", jl.EmbeddingLayer(n_in=10, n_out=6),
         pl.EmbeddingLayer(n_in=10, n_out=6), (1,), ids[:, :1], None),
        ("embedding_seq",
         jl.EmbeddingSequenceLayer(n_in=10, n_out=6,
                                   weight_init="normal"),
         pl.EmbeddingSequenceLayer(n_in=10, n_out=6,
                                   weight_init="normal"), (t, 1), ids,
         None),
        ("rmsnorm", jl.RMSNorm(), pl.RMSNorm(), (t, f), xf, None),
        ("rnn_output", jl.RnnOutputLayer(n_out=10, activation="softmax"),
         pl.RnnOutputLayer(n_out=10, activation="softmax"), (t, f), xf,
         None),
        ("mha_gqa_rope_causal",
         jl.MultiHeadAttention(n_in=f, n_out=f, n_heads=4, n_kv_heads=2,
                               causal=True, rope=True),
         pl.MultiHeadAttention(n_in=f, n_out=f, n_heads=4, n_kv_heads=2,
                               causal=True, rope=True), (t, f), xf, None),
        ("mha_key_mask",
         jl.MultiHeadAttention(n_in=f, n_out=f, n_heads=2),
         pl.MultiHeadAttention(n_in=f, n_out=f, n_heads=2), (t, f), xf,
         mask),
        ("decoder_block",
         jl.TransformerDecoderBlock(n_heads=4, n_kv_heads=2,
                                    ffn_mult=8 / 3),
         pl.TransformerDecoderBlock(n_heads=4, n_kv_heads=2,
                                    ffn_mult=8 / 3), (t, f), xf, None),
        ("decoder_block_remat",
         jl.TransformerDecoderBlock(n_heads=4, n_kv_heads=2, remat=True),
         pl.TransformerDecoderBlock(n_heads=4, n_kv_heads=2, remat=True),
         (t, f), xf, None),
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
    floating = np.issubdtype(x.dtype, np.floating)
    jm = None if mask is None else jnp.asarray(mask)
    jy, _ = jlayer.apply(jparams, {}, jnp.asarray(x), mask=jm)
    w = np.random.default_rng(2).normal(size=jy.shape).astype(np.float32)

    def loss(p, x):
        y, _ = jlayer.apply(p, {}, x, mask=jm)
        return jnp.sum(y * w)

    jgrads = jax.grad(loss, argnums=(0, 1) if floating else 0)(
        jparams, jnp.asarray(x))
    params = _to_torch(jparams, grad=True)
    tx = torch.tensor(x)
    if floating:
        tx.requires_grad_()
    y, _ = player.apply(params, {}, tx,
                        mask=None if mask is None else torch.tensor(mask))
    _close(y, jy, what="forward")
    (y * torch.tensor(w)).sum().backward()
    grads = jax.tree.map(lambda t: t.grad, params,
                         is_leaf=lambda t: isinstance(t, torch.Tensor))
    if floating:
        _close(grads, jgrads[0], what="param grads")
        _close(tx.grad, jgrads[1], what="input grad")
    else:
        _close(grads, jgrads, what="param grads")


def test_decoder_block_remat_equals_plain_with_dropout():
    """``remat`` recomputes the block in the backward; the dropout seed
    is an argument of the block, so the recomputation draws the same
    mask and the gradients equal the stored-activation run's."""
    x = torch.tensor(np.random.default_rng(3).normal(
        size=(2, 9, 16)).astype(np.float32))
    outs = []
    for remat in (False, True):
        blk = pl.TransformerDecoderBlock(n_heads=4, n_kv_heads=2,
                                         dropout=0.3, remat=remat)
        params, _, _ = blk.init(torch.Generator().manual_seed(4), (9, 16))
        for t in pweights_leaves(params):
            t.requires_grad_()
        y, _ = blk.apply(params, {}, x, train=True, rng=1234)
        y.square().sum().backward()
        outs.append((y.detach(), [t.grad for t in pweights_leaves(params)]))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def pweights_leaves(tree):
    from deeplearning4j_tpu_torch import tree as ptree
    return list(ptree.leaves(tree))


def test_dropout_is_seeded_inverted_dropout():
    layer = pl.DenseLayer(n_in=4, n_out=4, dropout=0.25)
    x = torch.ones((256, 64))
    a = layer._maybe_dropout(x, True, 7)
    b = layer._maybe_dropout(x, True, 7)
    assert torch.equal(a, b)                          # same seed, same mask
    assert not torch.equal(a, layer._maybe_dropout(x, True, 8))
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    assert torch.allclose(a[kept], torch.tensor(1 / 0.75))
    assert torch.equal(layer._maybe_dropout(x, False, 7), x)
    with pytest.raises(ValueError, match="rng"):
        layer._maybe_dropout(x, True, None)
    assert len(set(split_seed(5, 3))) == 3
    assert fold_in(5, 1) != fold_in(5, 2) == fold_in(5, 2)


# -- updaters against optax ------------------------------------------------------------
def _upd_tree(rng):
    return {"W": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32),
            "ln": {"gamma": (1 + rng.normal(size=(4,))).astype(np.float32)},
            "mha": {"Wq": rng.normal(size=(4, 4)).astype(np.float32),
                    "bo": rng.normal(size=(4,)).astype(np.float32)}}


@pytest.mark.parametrize("name,kw", [
    ("Adam", {"learning_rate": 1e-2}),
    ("AdamW", {"learning_rate": 1e-2, "weight_decay": 0.1}),
    ("AdamW", {"learning_rate": 3e-4, "weight_decay": 0.1,
               "exclude_bias_and_norm": True}),
    ("Sgd", {"learning_rate": 0.1}),
], ids=["adam", "adamw", "adamw_masked", "sgd"])
def test_updater_matches_optax_over_three_steps(name, kw):
    rng = np.random.default_rng(0)
    p0 = _upd_tree(rng)
    grads = [_upd_tree(rng) for _ in range(3)]
    opt = getattr(jupd, name)(**kw).to_optax()
    jp = jax.tree.map(jnp.asarray, p0)
    st = opt.init(jp)
    ours = getattr(pupd, name)(**kw)
    pp = _to_torch(p0)
    pst = ours.init_state(pp)
    for g in grads:
        u, st = opt.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, u)
        pu, pst = ours.update(_to_torch(g), pst, pp)
        pp = jax.tree.map(lambda a, d: a + d, pp, pu)
        _close(pp, jp, tol=UPD_TOL, what=name)


def test_adamw_mask_keeps_bias_and_norm_undecayed():
    """With a zero gradient only the decay moves a parameter: the masked
    keys (``b…``, ``gamma``) stay put, the others shrink by lr·wd·p."""
    p = _to_torch(_upd_tree(np.random.default_rng(1)))
    zero = jax.tree.map(torch.zeros_like, p)
    opt = pupd.AdamW(learning_rate=0.1, weight_decay=0.5,
                     exclude_bias_and_norm=True)
    u, _ = opt.update(zero, opt.init_state(p), p)
    for key in ("b",):
        assert (u[key] == 0).all()
    assert (u["ln"]["gamma"] == 0).all() and (u["mha"]["bo"] == 0).all()
    torch.testing.assert_close(u["W"], -0.1 * 0.5 * p["W"])
    torch.testing.assert_close(u["mha"]["Wq"], -0.1 * 0.5 * p["mha"]["Wq"])


@pytest.mark.parametrize("mode", [
    None, "ClipElementWiseAbsoluteValue", "ClipL2PerLayer",
    "ClipL2PerParamType", "RenormalizeL2PerLayer",
    "RenormalizeL2PerParamType"])
def test_gradient_normalization_matches_jax(mode):
    g = _upd_tree(np.random.default_rng(2))
    tr = jupd.gradient_normalization(mode, 0.5)
    jg = jax.tree.map(jnp.asarray, g)
    want, _ = tr.update(jg, tr.init(jg), jg)
    got = pupd.gradient_normalization(mode, 0.5)(_to_torch(g))
    _close(got, want, tol=UPD_TOL, what=str(mode))


def test_unported_updater_options_raise():
    with pytest.raises(NotImplementedError, match="schedule"):
        pupd.Adam(schedule=object()).init_state({})
    with pytest.raises(ValueError, match="gradient normalization"):
        pupd.gradient_normalization("bogus")


# -- the loss --------------------------------------------------------------------------
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_sparse_mcxent_from_logits_matches_jax(dname, masked,
                                               monkeypatch):
    # small row chunks: the chunked logsumexp and backward are exercised
    monkeypatch.setattr(plosses, "_CHUNK_BYTES", 4 * 11 * 3)
    rng = np.random.default_rng(3)
    logits = (3 * rng.normal(size=(2, 5, 11))).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32) if masked \
        else None
    jd = jnp.bfloat16 if dname == "bfloat16" else jnp.float32
    jl_ = jnp.asarray(logits, jd)
    jm = None if mask is None else jnp.asarray(mask)
    jloss, jgrad = jax.value_and_grad(
        lambda z: jlosses.sparse_mcxent(jnp.asarray(labels), z, mask=jm,
                                        from_logits=True))(jl_)
    tl = torch.tensor(logits).to(getattr(torch, dname)).requires_grad_()
    loss = plosses.sparse_mcxent(
        torch.tensor(labels), tl, mask=None if mask is None
        else torch.tensor(mask), from_logits=True)
    assert loss.dtype == torch.float32
    loss.backward()
    assert tl.grad.dtype == tl.dtype
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    g, jg = tl.grad.float().numpy(), np.asarray(jgrad, np.float32)
    tol = TOL if dname == "float32" else 2 * 2.0 ** -8 * np.abs(jg).max()
    np.testing.assert_allclose(g, jg, atol=tol, rtol=0)


def test_sparse_mcxent_probabilities_and_weights_match_jax():
    rng = np.random.default_rng(4)
    probs = rng.random((3, 4, 6)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    labels = rng.integers(0, 6, (3, 4)).astype(np.int32)
    weights = rng.random(6).astype(np.float32)
    want = jlosses.sparse_mcxent(jnp.asarray(labels), jnp.asarray(probs),
                                 weights=weights)
    got = plosses.sparse_mcxent(torch.tensor(labels), torch.tensor(probs),
                                weights=weights)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert plosses.wants_f32_logits(plosses.sparse_mcxent, False)
    assert not plosses.wants_f32_logits(plosses.sparse_mcxent, True)
    assert plosses.get("SPARSE_MCXENT") is plosses.sparse_mcxent


# -- activations, weights, configuration -------------------------------------------------
def test_activations_and_weight_inits():
    x = torch.linspace(-3, 3, 13)
    from deeplearning4j_tpu.ops import activations as jact
    for name in ("identity", "linear", "softmax", "silu", "swish", "relu",
                 "gelu", "gelu_tanh", "tanh"):
        np.testing.assert_allclose(
            pact.get(name)(x).numpy(),
            np.asarray(jact.get(name)(jnp.asarray(x.numpy()))),
            atol=1e-6)
    with pytest.raises(NotImplementedError, match="elu"):
        pact.get("elu")
    g = torch.Generator().manual_seed(0)
    w = pweights.get("xavier")(g, (300, 500))
    assert abs(w.std().item() - (2 / 800) ** 0.5) < 1e-3
    e = pweights.get("normal")(g, (400, 256))
    assert abs(e.std().item() - 256 ** -0.5) < 1e-3
    with pytest.raises(NotImplementedError, match="he_uniform"):
        pweights.get("he_uniform")


def test_config_builder_flows_defaults_and_ties():
    conf = (pconf.NeuralNetConfiguration.builder().seed(9)
            .compute_data_type("bfloat16").dropout_(0.1)
            .updater(pupd.Adam(learning_rate=1e-3)).list()
            .layer(pl.EmbeddingSequenceLayer(n_in=8, n_out=4))
            .layer(pl.RnnOutputLayer(n_out=8, activation="softmax",
                                     loss="sparse_mcxent"))
            .tie_weights(1, "W", 0, "W", transpose=True)
            .set_input_type(pconf.InputType.recurrent(1, 5)).build())
    assert conf.seed == 9 and conf.compute_dtype == "bfloat16"
    assert isinstance(conf.updater, pupd.Adam)
    assert all(l.dropout == 0.1 for l in conf.layers)
    assert conf.tied_weights == [[1, "W", 0, "W", True]]
    assert conf.input_type.shape == (5, 1)
    assert isinstance(pconf.MultiLayerConfiguration().updater, pupd.Sgd)
    with pytest.raises(ValueError, match="gap"):
        pconf.NeuralNetConfiguration.builder().list().layer(
            2, pl.RMSNorm()).build()


def test_sequence_parallel_attention_is_refused():
    """A sequence-parallel attention is refused where it cannot run: an
    unknown mode even with no context (as in JAX), and the zigzag ring
    (causal only) on a non-causal layer under a context. A known mode
    builds, and with no context runs as the local layer."""
    from deeplearning4j_tpu_torch.parallel.mesh import distributed_context

    class OneRank:               # a {"seq": 1} mesh: nothing is sent
        axis_names = ("seq",)
        group = lambda self, axis: None
        size = lambda self, axis=None: 1
        index = lambda self, axis: 0

    x = torch.randn(2, 4, 8, generator=torch.Generator().manual_seed(0))
    layer = pl.MultiHeadAttention(n_in=8, n_out=8, n_heads=2,
                                  sequence_parallel="ring")
    params, _, _ = layer.init(torch.Generator().manual_seed(1), (4, 8))
    local = pl.MultiHeadAttention(n_in=8, n_out=8, n_heads=2)
    assert torch.equal(layer.apply(params, {}, x)[0],
                       local.apply(params, {}, x)[0])
    typo = pl.MultiHeadAttention(n_in=8, n_out=8, n_heads=2,
                                 sequence_parallel="ulyses")
    with pytest.raises(ValueError, match="sequence_parallel"):
        typo.apply(params, {}, x)
    zz = pl.MultiHeadAttention(n_in=8, n_out=8, n_heads=2,
                               sequence_parallel="zigzag_ring")
    with distributed_context(OneRank()):
        with pytest.raises(ValueError, match="causal-only"):
            zz.apply(params, {}, x)
