"""The port's int8 serving options and beam search against the JAX
package's, on the CPU.

Twins of ``tests/test_gpt.py``'s int8 and beam tests, on GPTNano-sized
LMs trained by the JAX package (the toy LM of ``test_gpt.py``: a
repeating 1..5 pattern, 60 steps) and carried across with
``params_from_jax``. Tolerances:

- tokens: exact (greedy, beam, int8 weights, int8 cache);
- ``_quant_kv`` and ``QuantizedWeight`` codes: equal to JAX's; their f32
  scales: equal to the bit (both round half to even after the same f32
  division);
- f32 logits through the int8 paths, port against JAX: 1e-5 absolute
  (the same math in another summation order, 4 layers deep; the logits
  are O(4));
- the JAX test's own bands where it states one (a dequantised weight
  within scale/2 of the master; > 0.9 of tokens equal when both int8
  options compose).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.zoo.gpt import GPTNano as JaxGPTNano
from deeplearning4j_tpu.zoo.gpt import QuantizedWeight as JaxQW
from deeplearning4j_tpu.zoo.gpt import _quant_kv as jax_quant_kv
from deeplearning4j_tpu_torch import tree
from deeplearning4j_tpu_torch.zoo.gpt import (GPTNano, QuantizedWeight,
                                              _quant_kv, _top_k)

LOGIT_TOL = 1e-5
PERIOD = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train_toy(tied: bool):
    """``test_gpt.py``'s toy LM in the JAX package: GPTNano(vocab 16)
    trained 60 steps on the repeating pattern 1..5."""
    net = JaxGPTNano(vocab_size=16, max_len=64, seed=5,
                     tie_embeddings=tied).init(seq_len=24)
    toks = np.arange(25) % PERIOD + 1
    x = np.tile(toks[:24], (8, 1)).astype(np.int32)
    y = np.tile(toks[1:25], (8, 1)).astype(np.int32)
    for _ in range(60):
        net.fit(x, y)
    return net, jax.tree.map(np.asarray, net.params)


@pytest.fixture(scope="module")
def toy():
    return _train_toy(False)


@pytest.fixture(scope="module")
def toy_tied():
    return _train_toy(True)


def _models(tied=False, **kw):
    """(JAX model, port model) of the toy LM's configuration."""
    cfg = dict(vocab_size=16, max_len=64, seed=5, tie_embeddings=tied, **kw)
    return JaxGPTNano(**cfg), GPTNano(**cfg)


def _pattern(t0, start=0):
    return ((np.arange(start, start + t0) % PERIOD) + 1)[None, :].astype(
        np.int32)


# -- the quantisers, bit for bit ---------------------------------------------
def test_quantisers_bit_equal_to_jax(toy):
    """Every 2-D leaf of the JAX-trained masters quantises to the JAX
    package's codes and scales (the decode tree ``_cast_decode`` builds,
    per-row for the embedding, per-column elsewhere); ``_quant_kv`` on
    the same k/v gives the same codes and scales, ties at .5 and
    all-zero slices included."""
    net, masters = toy
    jm, pm = _models(serve_quant="int8")
    j_tree = jm._cast_decode(net.params)
    p_tree = pm._cast_decode(pm.params_from_jax(masters, device="cpu"))
    seen = []

    def check(path, pl):
        jl = j_tree
        for k in path:
            jl = jl[k]
        if isinstance(pl, QuantizedWeight):
            seen.append(path)
            assert isinstance(jl, JaxQW) and jl.axis == pl.axis
            assert pl.w8.dtype == torch.int8
            np.testing.assert_array_equal(pl.w8.numpy(), np.asarray(jl.w8))
            np.testing.assert_array_equal(
                pl.scale.numpy().view(np.int32),
                np.asarray(jl.scale).view(np.int32))
        else:
            assert not isinstance(jl, JaxQW), path
            np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))

    tree.map_with_path(check, p_tree)
    n_q = len(seen)
    assert n_q == 1 + 4 * 7 + 1          # embedding, 7 a block, the head
    rng = np.random.default_rng(3)
    kv = rng.standard_normal((3, 2, 2, 16, 20)).astype(np.float32) * 3
    kv[0, 0, 0, :, 0] = 0.0                               # all-zero slice
    kv[1, 1, 1, :, 2] = np.r_[127.0, 0.5, -0.5, 1.5, 2.5, np.zeros(11)]
    for axis in (3,):
        jw, js = jax_quant_kv(jnp.asarray(kv), axis)
        pw, ps = _quant_kv(torch.tensor(kv), axis)
        assert pw.dtype == torch.int8 and ps.dtype == torch.float32
        np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(ps.numpy().view(np.int32),
                                      np.asarray(js).view(np.int32))
    # the bf16 input the serving cache quantises
    kv16 = torch.tensor(kv).bfloat16()
    jw, js = jax_quant_kv(jnp.asarray(kv16.float().numpy()).astype(
        jnp.bfloat16), 3)
    pw, ps = _quant_kv(kv16, 3)
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ps.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))


def test_int8_quantized_weight_roundtrip():
    """Twin of ``test_gpt.py::test_int8_quantized_weight_roundtrip``:
    dequantisation error <= scale/2, ``x @ qw`` equals ``x @`` the
    dequantised matrix (``Tensor.__matmul__`` hands a non-tensor operand
    back with ``NotImplemented``), ``.T`` flips the channel axis, and
    the row gather is exact in the default f32."""
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.standard_normal((32, 48)), dtype=torch.float32)
    for axis in (0, 1):
        qw = QuantizedWeight.quantize(w, axis)
        assert qw.w8.dtype == torch.int8
        deq = qw._dequant(torch.float32)
        err = (deq - w).abs()
        assert bool((err <= qw.scale.expand_as(w) * 0.5 + 1e-7).all())
        x = torch.tensor(rng.standard_normal((4, 32)), dtype=torch.float32)
        assert torch.Tensor.__matmul__(x, qw) is NotImplemented
        torch.testing.assert_close(x @ qw, x @ deq, rtol=1e-6, atol=0)
        assert qw.T.axis == 1 - axis and qw.T.w8.shape == (48, 32)
        rows = qw[torch.tensor([1, 3])]
        torch.testing.assert_close(rows, deq[torch.tensor([1, 3])],
                                   rtol=1e-6, atol=1e-7)


def test_serve_quant_validation():
    """Twin of ``test_serve_quant_validation`` and
    ``test_cache_quant_validation``: anything but None or "int8"
    raises."""
    with pytest.raises(ValueError, match="serve_quant"):
        GPTNano(serve_quant="int4")
    with pytest.raises(ValueError, match="cache_quant"):
        GPTNano(cache_quant="int4")


def test_decode_params_cache_the_quantised_tree(toy):
    """The prepare-cache holds the QUANTISED tree: a repeat call returns
    the same object, whose 2-D leaves are ``QuantizedWeight``s; replacing
    a leaf of the masters invalidates it."""
    _, masters = toy
    _, pm = _models(serve_quant="int8", compute_dtype="bfloat16")
    params = pm.params_from_jax(masters, device="cpu")
    a = pm._decode_params(params)
    assert pm._decode_params(params) is a
    assert isinstance(a["layer_0"]["W"], QuantizedWeight)
    assert a["layer_0"]["W"].axis == 0 and a["layer_1"]["mha"]["Wq"].axis == 1
    assert a["layer_0"]["W"].act_dtype == torch.bfloat16
    assert a["layer_1"]["ln1"]["gamma"].dtype == torch.bfloat16
    params["layer_1"]["Wg"] = params["layer_1"]["Wg"] * 2
    b = pm._decode_params(params)
    assert b is not a
    np.testing.assert_array_equal(
        b["layer_1"]["Wg"].w8.numpy(),
        QuantizedWeight.quantize(params["layer_1"]["Wg"], 1).w8.numpy())


# -- the int8 decode paths against JAX ----------------------------------------
@pytest.mark.parametrize("opts", [
    {"serve_quant": "int8"}, {"cache_quant": "int8"},
    {"serve_quant": "int8", "cache_quant": "int8"}],
    ids=["weights", "cache", "both"])
def test_int8_path_logits_match_jax(toy, opts):
    """f32 prefill logits and 6 teacher-forced decode steps through the
    int8 paths, port against JAX from the same masters: within
    ``LOGIT_TOL``; the prefill's int8 cache codes equal JAX's, its
    scales within 1e-5 relative."""
    net, masters = toy
    jm, pm = _models(**opts)
    jp = jm._decode_params(net)
    pp = pm._decode_params(pm.params_from_jax(masters, device="cpu"))
    rng = np.random.default_rng(0)
    t0, tb, n = 13, 16, 6
    pad = np.zeros((2, tb), np.int32)
    pad[:, :t0] = rng.integers(0, 16, (2, t0))
    jl, jc = jm._prefill_forward(jp, jnp.asarray(pad), tb + n, t0)
    pl, pc = pm._prefill_forward(pp, torch.as_tensor(pad, dtype=torch.int64),
                                 tb + n, t0)
    errs = [float(np.abs(np.asarray(jl) - pl.numpy()).max())]
    if "cache_quant" in opts:
        for (jw, js), (pw, ps) in zip(jc, pc):
            np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
            # the k/v they are the abs-max of agree to f32 rounding
            # some layers deep
            np.testing.assert_allclose(ps.numpy(), np.asarray(js),
                                       rtol=1e-5, atol=0)
    forced = rng.integers(0, 16, (2, n))
    for i in range(n):
        jl, jc = jm._token_logits(jp, jnp.asarray(forced[:, i], jnp.int32),
                                  jc, t0 + i, 2)
        pl, pc = pm._token_logits(pp, torch.as_tensor(forced[:, i]), pc,
                                  t0 + i, 2)
        errs.append(float(np.abs(np.asarray(jl) - pl.numpy()).max()))
    assert max(errs) <= LOGIT_TOL, errs


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_int8_serving_matches_f32_greedy(tied, toy, toy_tied):
    """Twin of ``test_int8_serving_matches_f32_greedy``: int8 weights
    give the full-precision greedy continuation, through the tied and
    the untied head and through beam search — and the JAX package's
    int8 tokens."""
    net, masters = toy_tied if tied else toy
    jq, pq = _models(tied=tied, serve_quant="int8")
    _, pm = _models(tied=tied)
    params = pm.params_from_jax(masters, device="cpu")
    prompt = _pattern(9)
    ref = pm.generate(params, prompt, n_new=8)
    got = pq.generate(params, prompt, n_new=8)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.asarray(jq.generate(net, prompt,
                                                              n_new=8)))
    np.testing.assert_array_equal(
        pq.generate_beam(params, prompt, n_new=8, beams=2), ref)


def test_int8_kv_cache_decode_matches(toy):
    """Twin of ``test_int8_kv_cache_decode_matches``: the int8 cache
    reproduces the float-cache greedy output (and the JAX package's int8
    tokens), composes with beam search, and with int8 weights too keeps
    > 0.9 of the tokens."""
    net, masters = toy
    _, pm = _models()
    params = pm.params_from_jax(masters, device="cpu")
    prompt = np.random.default_rng(1).integers(0, 16, (2, 16)).astype(
        np.int32)
    base = pm.generate(params, prompt, n_new=16)
    jq, pq = _models(cache_quant="int8")
    got = pq.generate(params, prompt, n_new=16)
    np.testing.assert_array_equal(got, base)
    np.testing.assert_array_equal(
        got, np.asarray(jq.generate(net, prompt, n_new=16)))
    beam = pq.generate_beam(params, prompt, n_new=8, beams=3)
    assert beam.shape == (2, 24)
    np.testing.assert_array_equal(
        beam, np.asarray(jq.generate_beam(net, prompt, n_new=8, beams=3)))
    _, pboth = _models(cache_quant="int8", serve_quant="int8")
    both = pboth.generate(params, prompt, n_new=16)
    assert (both == base).mean() > 0.9, (both, base)


# -- beam search -------------------------------------------------------------
def test_top_k_breaks_ties_as_jax():
    """``_top_k`` orders equal values lower index first, as
    ``jax.lax.top_k`` does (``torch.topk`` promises no order), on rows
    built of ties: all equal, repeated maxima, -inf and bf16-rounded
    values."""
    rng = np.random.default_rng(2)
    rows = [np.zeros(12), np.r_[1, 3, 3, 2, 3, 0, 3, 1, 1, 2, 2, 2],
            np.r_[-np.inf, 2, -np.inf, 2, 5, 5, 0, 0, -np.inf, 1, 1, 5],
            rng.integers(0, 3, 12)]
    x = np.asarray(rows, np.float32)
    x16 = torch.tensor(rng.standard_normal((4, 64)) * 0.01).bfloat16()
    for arr in (x, x16.float().numpy()):
        for k in (1, 3, arr.shape[1]):
            jv, ji = jax.lax.top_k(jnp.asarray(arr), k)
            pv, pi = _top_k(torch.tensor(arr), k)
            np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_beam_search_matches_greedy_at_one_beam(toy):
    """Twin of ``test_beam_search_matches_greedy_at_one_beam``."""
    _, masters = toy
    _, pm = _models()
    params = pm.params_from_jax(masters, device="cpu")
    prompt = _pattern(9)
    np.testing.assert_array_equal(
        pm.generate_beam(params, prompt, n_new=6, beams=1),
        pm.generate(params, prompt, n_new=6))


def test_beam_search_exact_at_full_width():
    """Twin of ``test_beam_search_exact_at_full_width``: with beams ==
    vocab_size and n_new == 2 beam search is exhaustive, so it equals
    the brute-force best 2-token continuation (scored by the JAX
    network's output) and the JAX package's beam, on an undertrained
    model."""
    V = 16
    jm = JaxGPTNano(vocab_size=V, max_len=64, seed=13)
    net = jm.init(seq_len=20)
    rng = np.random.default_rng(3)
    net.fit(rng.integers(1, V, (8, 20)).astype(np.int32),
            rng.integers(1, V, (8, 20)).astype(np.int32))
    pm = GPTNano(vocab_size=V, max_len=64, seed=13)
    params = pm.params_from_jax(jax.tree.map(np.asarray, net.params),
                                device="cpu")
    prompt = np.asarray([[1, 2, 3, 4, 5, 6]], np.int32)
    t0 = prompt.shape[1]
    beam = pm.generate_beam(params, prompt, n_new=2, beams=V)
    cands = np.asarray([[a, c] for a in range(V) for c in range(V)],
                       np.int32)
    seqs = np.concatenate([np.tile(prompt, (V * V, 1)), cands], axis=1)
    probs = np.asarray(net.output(seqs[:, :-1]))
    lp = (np.log(probs[np.arange(V * V), t0 - 1, cands[:, 0]] + 1e-30)
          + np.log(probs[np.arange(V * V), t0, cands[:, 1]] + 1e-30))
    np.testing.assert_array_equal(beam[0, t0:], cands[int(np.argmax(lp))])
    np.testing.assert_array_equal(
        beam, np.asarray(jm.generate_beam(net, prompt, n_new=2, beams=V)))


def test_beam_search_batched_and_guards(toy):
    """Twin of ``test_beam_search_batched_and_guards``."""
    _, masters = toy
    _, pm = _models()
    params = pm.params_from_jax(masters, device="cpu")
    prompts = np.concatenate([_pattern(8), _pattern(8, 2)])
    out = pm.generate_beam(params, prompts, n_new=4, beams=3)
    assert out.shape == (2, 12) and out.dtype == np.int32
    np.testing.assert_array_equal(out[:, :8], prompts)
    np.testing.assert_array_equal(out, pm.generate(params, prompts, n_new=4))
    np.testing.assert_array_equal(
        pm.generate_beam(params, prompts, n_new=0, beams=3), prompts)
    with pytest.raises(ValueError, match="beams"):
        pm.generate_beam(params, prompts, n_new=2, beams=99)
    with pytest.raises(ValueError, match="max_len"):
        pm.generate_beam(params, prompts, n_new=60, beams=2)
