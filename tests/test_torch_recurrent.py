"""The recurrent layers of the port (``nn/layers/recurrent.py``), the
reference's attention layers (``nn/layers/attention.py``:
``SelfAttentionLayer``, ``LearnedSelfAttentionLayer``,
``RecurrentAttentionLayer``) and ``LossLayer``, against the JAX
package's classes on the CPU: the same numpy input and parameters on
both sides (the port's init, its shapes checked against the JAX
init's), the output, the final carries, the gradient of the input and of
every parameter; each class's JSON bean both ways; the refusal under a
sequence-parallel context.

Twins of ``tests/test_layers.py:128-177`` (the LSTM, GravesLSTM, GRU
and SimpleRnn gradchecks, masks holding the state, stored-state
continuation, the bidirectional modes, LastTimeStep under a mask),
``:269`` and ``:311`` (RecurrentAttentionLayer), ``:275``
(GravesBidirectionalLSTM), and of the recurrent and attention rows of
``tests/test_layer_registry_roundtrip.py:65-74, 106-109``. A JAX
gradcheck in f64 against finite differences becomes here a twin of the
JAX layer's autograd gradients.

Tolerances (float32): the output, the carries and every gradient within
1e-5 of the largest magnitude of the compared tensor — the same f32
math in another summation order, carried through at most 6 steps; a
held carry or a masked output equal to the bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.layers.base import \
    layer_from_dict as j_layer_from_dict
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn.layers.base import \
    layer_from_dict as p_layer_from_dict

TOL = 1e-5
GEN = torch.Generator().manual_seed(0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree_, path=""):
    """A nested dict of arrays or tensors as ``{"a.b": numpy array}``."""
    if isinstance(tree_, dict):
        out = {}
        for k in sorted(tree_):
            out.update(_flat(tree_[k], f"{path}.{k}" if path else k))
        return out
    if isinstance(tree_, torch.Tensor):
        tree_ = tree_.detach()
    return {path: np.asarray(tree_, np.float32)}


def _flat_live(tree_, path=""):
    """``_flat`` without the copy to numpy (keeps the autograd graph)."""
    if isinstance(tree_, dict):
        out = {}
        for k in sorted(tree_):
            out.update(_flat_live(tree_[k], f"{path}.{k}" if path else k))
        return out
    return {path: tree_}


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(
        np.float32)


def _init_both(jlayer, player, shape):
    """The port layer's parameters as numpy, after checking their shapes
    and the output shape against the JAX layer's ``init`` traced
    abstractly."""
    box = {}

    def init():
        p, s, box["out"] = jlayer.init(jax.random.PRNGKey(1), shape)
        return p, s

    jp, _ = jax.eval_shape(init)
    pp, _, pout = player.init(GEN, shape)
    assert tuple(pout) == tuple(box["out"])
    pp = jax.tree.map(lambda a: np.asarray(a.detach()), pp,
                      is_leaf=lambda a: isinstance(a, torch.Tensor))
    assert jax.tree.map(np.shape, jp) == jax.tree.map(np.shape, pp)
    return pp


def _t(tree_, grad=False):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a))
                        .requires_grad_(grad), tree_)


def _twin(jlayer, player, params, x, *, mask=None, initial_state=None,
          seed=0):
    """The errors of the port's layer against the JAX one on ``x``: the
    output, every carry it returns, and the gradients of
    ``sum(y·w) + Σ sum(carry·w_c)`` (random fixed weights) for the input
    and every parameter. The JAX side runs as one jitted program."""
    kw = {} if initial_state is None else {
        "initial_state": jax.tree.map(jnp.asarray, initial_state)}
    jm = None if mask is None else jnp.asarray(mask)
    y_shape, s_shape = jax.eval_shape(lambda p, xx: jlayer.apply(
        p, {}, xx, mask=jm, **kw), params, x)
    rng = np.random.default_rng(seed + 100)
    w = rng.normal(size=y_shape.shape).astype(np.float32)
    ws = {k: rng.normal(size=v.shape).astype(np.float32)
          for k, v in _flat(jax.tree.map(
              lambda a: np.zeros(a.shape, np.float32), s_shape)).items()}

    def weigh(y, s, lib):
        total = (y * lib(w)).sum()
        flat = _flat_live(s)
        for k in ws:
            total = total + (flat[k] * lib(ws[k])).sum()
        return total

    def loss(p, xx):
        y, s = jlayer.apply(p, {}, xx, mask=jm, **kw)
        return weigh(y, s, jnp.asarray), (y, s)

    (_, (jy, js)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    tp = _t(params, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    pkw = {} if initial_state is None else {
        "initial_state": _t(initial_state)}
    ty, ts = player.apply(tp, {}, tx,
                          mask=None if mask is None else torch.tensor(mask),
                          **pkw)
    weigh(ty, ts, torch.tensor).backward()
    assert tuple(ty.shape) == tuple(jy.shape)
    errs = {"out": _rel(ty.detach().numpy(), np.asarray(jy)),
            "dx": _rel(tx.grad.numpy(), np.asarray(jgx))}
    for k, v in _flat(js).items():
        errs[f"carry.{k}"] = _rel(_flat(ts)[k], v)
    grads = _flat(jax.tree.map(lambda a: a.grad, tp,
                               is_leaf=lambda a: isinstance(a, torch.Tensor)))
    for k, v in _flat(jgp).items():
        errs[f"d{k}"] = _rel(grads[k], v)
    return errs


def _mask(b, t, lengths):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32)


# -- the cells --------------------------------------------------------------
CELL_CASES = [
    # (id, class name, kwargs, input shape without the batch)
    ("lstm", "LSTM", dict(n_out=3), (4, 2)),
    ("lstm-hardsigmoid", "LSTM",
     dict(n_out=4, gate_activation="hardsigmoid", activation="softsign",
          forget_gate_bias_init=0.5), (4, 3)),
    ("graves-lstm", "GravesLSTM", dict(n_out=2), (3, 2)),
    ("gru", "GRU", dict(n_out=3), (3, 2)),
    ("gru-reset-after", "GRU", dict(n_out=3, reset_after=True), (4, 2)),
    ("simple-rnn", "SimpleRnn", dict(n_out=3), (3, 2)),
]


@pytest.mark.parametrize("masked", (False, True), ids=("plain", "masked"))
@pytest.mark.parametrize("case", CELL_CASES, ids=lambda c: c[0])
def test_cell_matches_jax(case, masked):
    """[``test_layers.py:128-139``, ``:161``] each cell's output, final
    carries and gradients: from zeros without a mask, and under a mask
    from a given initial state, as truncated BPTT and ``rnn_time_step``
    pass it."""
    _, name, kw, shape = case
    jlayer, player = getattr(jl, name)(**kw), getattr(pl, name)(**kw)
    params = _init_both(jlayer, player, shape)
    if name == "GravesLSTM":     # peepholes start at 0: give them weight
        params["P"] = _x(params["P"].shape, 7)
    mask = carries = None
    if masked:
        mask = _mask(3, shape[0], (shape[0], 2, 1))
        carries = {k: _x((3, kw["n_out"]), 11 + i)
                   for i, k in enumerate(("h", "c") if "LSTM" in name
                                         else ("h",))}
    errs = _twin(jlayer, player, params,
                 _x((3,) + shape, CELL_CASES.index(case)), mask=mask,
                 initial_state=carries)
    assert max(errs.values()) <= TOL, errs


def test_lstm_masking_holds_state():
    """[``test_layers.py:146``] masked outputs are zero and the carry of
    a row whose mask ends after step 3 equals its carry after 3 steps,
    to the bit."""
    layer = pl.LSTM(n_out=4)
    params, state, _ = layer.init(GEN, (5, 3))
    x = torch.tensor(_x((2, 5, 3), 0))
    mask = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]],
                        dtype=torch.float32)
    y, s = layer.apply(params, state, x, mask=mask)
    assert torch.equal(y[0, 3:], torch.zeros_like(y[0, 3:]))
    _, s3 = layer.apply(params, state, x[:, :3], mask=mask[:, :3])
    assert torch.equal(s["h"][0], s3["h"][0])
    assert torch.equal(s["c"][0], s3["c"][0])


def test_lstm_stored_state_continuation():
    """[``test_layers.py:161``] the second half from the first half's
    carries equals the whole sequence's second half."""
    layer = pl.GravesLSTM(n_out=3)
    params, state, _ = layer.init(GEN, (6, 2))
    params["P"] = torch.tensor(_x((3, 3), 5))
    x = torch.tensor(_x((1, 6, 2), 1))
    full, _ = layer.apply(params, state, x)
    _, s1 = layer.apply(params, state, x[:, :3])
    second, _ = layer.apply(params, state, x[:, 3:], initial_state=s1)
    torch.testing.assert_close(second, full[:, 3:], rtol=0, atol=0)


# -- the wrappers -----------------------------------------------------------
WRAP_CASES = [
    # (id, class name, kwargs by package, input shape, masked); the mask
    # path of Bidirectional is the same in every mode
    *[(f"bidirectional-{m}", "Bidirectional",
       lambda lib, m=m: dict(fwd=lib.LSTM(n_out=3), mode=m), (4, 2),
       False) for m in ("concat", "add", "mul", "average")],
    ("bidirectional-concat-masked", "Bidirectional",
     lambda lib: dict(fwd=lib.LSTM(n_out=3)), (4, 2), True),
    ("graves-bidirectional-masked", "GravesBidirectionalLSTM",
     lambda lib: dict(n_out=3), (5, 2), True),
    ("bidirectional-last-step-masked", "Bidirectional",
     lambda lib: dict(fwd=lib.LastTimeStep(underlying=lib.GRU(n_out=2))),
     (4, 2), True),
    *[(f"last-time-step-{'masked' if m else 'plain'}", "LastTimeStep",
       lambda lib: dict(underlying=lib.LSTM(n_out=3)), (5, 2), m)
      for m in (False, True)],
    *[(f"mask-zero-{'masked' if m else 'plain'}", "MaskZeroLayer",
       lambda lib: dict(underlying=lib.SimpleRnn(n_out=3)), (5, 2), m)
      for m in (False, True)],
    ("time-distributed", "TimeDistributed",
     lambda lib: dict(underlying=lib.DenseLayer(n_out=3,
                                                activation="tanh")),
     (4, 2), False),
]


@pytest.mark.parametrize("case", WRAP_CASES, ids=lambda c: c[0])
def test_wrapper_matches_jax(case):
    """[``test_layers.py:168-177``, ``:275``] the bidirectional modes
    (under a mask the backward pass reverses each row's valid prefix),
    GravesBidirectionalLSTM's sum, LastTimeStep's last valid step,
    MaskZeroLayer's derived mask, TimeDistributed."""
    _, name, kw, shape, masked = case
    jlayer = getattr(jl, name)(**kw(jl))
    player = getattr(pl, name)(**kw(pl))
    params = _init_both(jlayer, player, shape)
    x = _x((3,) + shape, WRAP_CASES.index(case) + 20)
    if name == "MaskZeroLayer":
        x[1, 3:] = 0.0       # rows of the mask value end that sequence
    mask = _mask(3, shape[0], (shape[0], 3, 1)) if masked else None
    errs = _twin(jlayer, player, params, x, mask=mask)
    assert max(errs.values()) <= TOL, errs


def test_graves_bidirectional_sums_and_forwards_options():
    """[``test_layers.py:275``] the reference's summed output width, and
    the wrapper's options handed to the wrapped GravesLSTM."""
    layer = pl.GravesBidirectionalLSTM(n_out=3)
    params, state, out = layer.init(GEN, (5, 2))
    y, _ = layer.apply(params, state, torch.tensor(_x((2, 5, 2), 3)))
    assert tuple(y.shape) == (2, 5, 3) and out == (5, 3)
    l2 = pl.GravesBidirectionalLSTM(n_out=3, weight_init="uniform",
                                    dropout=0.1)
    assert l2.fwd.weight_init == "uniform" and l2.fwd.dropout == 0.1


# -- ConvLSTM2D --------------------------------------------------------------
@pytest.mark.parametrize("kw", (
    dict(n_out=3, kernel_size=(2, 2)),
    dict(n_out=2, kernel_size=(3, 3), padding="SAME"),
    dict(n_out=2, kernel_size=(3, 2), stride=(2, 1), padding="SAME",
         return_sequences=False, gate_activation="sigmoid"),
), ids=("valid", "same", "strided-last"))
def test_conv_lstm_2d_matches_jax(kw):
    """Keras' gate packing, the input convolution of every frame at the
    layer's padding, the recurrent one at SAME."""
    jlayer, player = jl.ConvLSTM2D(**kw), pl.ConvLSTM2D(**kw)
    params = _init_both(jlayer, player, (3, 5, 5, 2))
    errs = _twin(jlayer, player, params, _x((2, 3, 5, 5, 2), 40))
    assert max(errs.values()) <= TOL, errs


# -- attention and loss layers ----------------------------------------------
ATT_CASES = [
    # (id, class name, kwargs, input shape, masked); the loss layers
    # take no mask
    *[(f"{i}-{'masked' if m else 'plain'}", name, kw, shape, m)
      for i, name, kw, shape in (
          ("self-attention", "SelfAttentionLayer",
           dict(n_out=4, n_heads=2), (5, 4)),
          ("learned-self-attention", "LearnedSelfAttentionLayer",
           dict(n_out=4, n_heads=2, n_queries=3), (5, 4)),
          ("recurrent-attention", "RecurrentAttentionLayer",
           dict(n_out=4, n_heads=2), (3, 2)))
      for m in (False, True)],
    ("loss", "LossLayer", dict(loss="mse", activation="sigmoid"), (4, 3),
     False),
    ("rnn-loss", "RnnLossLayer", dict(loss="mse", activation="tanh"),
     (4, 3), False),
]


@pytest.mark.parametrize("case", ATT_CASES, ids=lambda c: c[0])
def test_attention_and_loss_layers_match_jax(case):
    """[``test_layers.py:269``, ``:311``] the three attention layers of
    the reference (the mask a key mask, and in the recurrent layer the
    steps it holds) and the loss-only layers."""
    _, name, kw, shape, masked = case
    jlayer, player = getattr(jl, name)(**kw), getattr(pl, name)(**kw)
    params = _init_both(jlayer, player, shape)
    mask = _mask(2, shape[0], (shape[0], 2)) if masked else None
    errs = _twin(jlayer, player, params,
                 _x((2,) + shape, ATT_CASES.index(case) + 60), mask=mask)
    assert max(errs.values()) <= TOL, errs


def test_recurrent_attention_mask_holds_state():
    """[``test_layers.py:311``] masked positions emit zeros, and the valid
    prefix does not depend on what lies past the mask."""
    layer = pl.RecurrentAttentionLayer(n_out=4, n_heads=2)
    params, state, _ = layer.init(GEN, (5, 3))
    x = torch.tensor(_x((2, 5, 3), 9))
    m = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], dtype=torch.float32)
    y, _ = layer.apply(params, state, x, mask=m)
    assert torch.equal(y[0, 3:], torch.zeros_like(y[0, 3:]))
    x2 = x.clone()
    x2[0, 3:] = 123.0
    y2, _ = layer.apply(params, state, x2, mask=m)
    torch.testing.assert_close(y2[0, :3], y[0, :3], rtol=1e-5, atol=0)


# -- the registry and JSON ---------------------------------------------------
REGISTRY_ROWS = {
    "LSTM": dict(n_out=4), "GravesLSTM": dict(n_out=4),
    "GravesBidirectionalLSTM": dict(n_out=4), "GRU": dict(n_out=4),
    "SimpleRnn": dict(n_out=4), "RnnLossLayer": dict(loss="mse"),
    "LossLayer": dict(loss="mse"),
    "ConvLSTM2D": dict(n_out=3, kernel_size=(2, 2)),
    "SelfAttentionLayer": dict(n_heads=2),
    "LearnedSelfAttentionLayer": dict(n_heads=2, n_queries=3),
    "RecurrentAttentionLayer": dict(n_out=4, n_heads=2),
    "Bidirectional": "fwd", "LastTimeStep": "underlying",
    "MaskZeroLayer": "underlying", "TimeDistributed": "underlying",
}


@pytest.mark.parametrize("name", sorted(REGISTRY_ROWS))
def test_json_bean_crosses_both_ways(name):
    """[``test_layer_registry_roundtrip.py:65-74, 106-109``] the port's
    bean parses in the JAX package and back to the same dict, and the
    JAX bean parses in the port."""
    kw = REGISTRY_ROWS[name]
    if isinstance(kw, str):      # a wrapper around an LSTM (a Dense)
        inner = "DenseLayer" if name == "TimeDistributed" else "LSTM"
        pkw = {kw: getattr(pl, inner)(n_out=3)}
        jkw = {kw: getattr(jl, inner)(n_out=3)}
    else:
        pkw = jkw = kw
    player, jlayer = getattr(pl, name)(**pkw), getattr(jl, name)(**jkw)
    d = player.to_dict()
    assert d == jlayer.to_dict()
    assert j_layer_from_dict(d).to_dict() == d
    assert p_layer_from_dict(jlayer.to_dict()).to_dict() == d


def test_recurrence_refused_under_a_sequence_parallel_context():
    """A recurrent layer beside sequence-parallel attention: its carry
    would have to pass rank to rank, so the network refuses it under
    the context, naming the difference by design (``ROADMAP.md`` C9)."""
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import distributed_context

    class OneRank:
        axis_names = ("seq",)

        def group(self, axis):
            return None

        def size(self, axis=None):
            return 1

        def index(self, axis):
            return 0

    for rnn in (pl.LSTM(n_out=4), pl.Bidirectional(fwd=pl.GRU(n_out=2)),
                pl.RecurrentAttentionLayer(n_out=4, n_heads=2)):
        conf = (NeuralNetConfiguration.builder().list()
                .layer(pl.MultiHeadAttention(n_out=4, n_heads=2,
                                             sequence_parallel="ring"))
                .layer(rnn)
                .layer(pl.RnnOutputLayer(n_out=2, activation="softmax",
                                         loss="mcxent"))
                .set_input_type(InputType.recurrent(4, 6)).build())
        net = MultiLayerNetwork(conf).init(device="cpu")
        x = _x((2, 6, 4), 0)
        with distributed_context(OneRank()):
            with pytest.raises(NotImplementedError,
                               match="by design .ROADMAP.md C9"):
                net.output(x)
        assert tuple(net.output(x).shape) == (2, 6, 2)
