"""The port's causal LM against the JAX package's, on the CPU.

JAX GPTNano weights are carried across with ``params_from_jax`` and the
same numpy prompts go through both packages. Tolerances: float32 logits
1e-4 absolute (the same math in another summation order, a few layers
deep); greedy decoding token-identical. The bfloat16 band: both
packages cast the weights to bf16 and round at every op, in different
places (each framework's bf16 matmul, softmax and mean accumulate
differently), so logits agree to 0.1 absolute at these O(1) scales.
"""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.zoo.gpt import GPTNano as JaxGPTNano
from deeplearning4j_tpu.zoo.gpt import prompt_bucket as jax_bucket
from deeplearning4j_tpu_torch.zoo.gpt import (CausalTransformerLM,
                                              GPTMini, GPTNano,
                                              prompt_bucket)

F32_TOL = 1e-4
BF16_TOL = 0.1


def _pair(**kw):
    """(jax model, jax net, port model, port params on the CPU)."""
    jm = JaxGPTNano(vocab_size=64, max_len=64, seed=7, **kw)
    net = jm.init()
    pm = GPTNano(vocab_size=64, max_len=64, seed=7, **kw)
    tree = jax.tree.map(np.asarray, net.params)
    return jm, net, pm, pm.params_from_jax(tree, device="cpu")


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _prompt(t0, b=1, seed=0, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (b, t0)).astype(
        np.int32)


def test_prefill_and_token_logits_match_jax(pair):
    jm, net, pm, params = pair
    t0, n_steps = 13, 6
    tb = prompt_bucket(t0)
    prompt = _prompt(t0, b=2)
    pad = np.zeros((2, tb), np.int32)
    pad[:, :t0] = prompt
    j_logits, j_caches = jm._prefill_forward(net.params, pad,
                                             tb + n_steps, t0)
    logits, caches = pm._prefill_forward(
        params, torch.as_tensor(pad, dtype=torch.int64), tb + n_steps, t0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=F32_TOL, rtol=0)
    for c, jc in zip(caches, j_caches):
        np.testing.assert_allclose(c.numpy(), np.asarray(jc),
                                   atol=F32_TOL, rtol=0)
    # teacher-forced decode steps: the same token fed to both
    forced = _prompt(n_steps, b=2, seed=1)
    for i in range(n_steps):
        j_logits, j_caches = jm._token_logits(net.params, forced[:, i],
                                              j_caches, t0 + i, 2)
        logits, caches = pm._token_logits(
            params, torch.as_tensor(forced[:, i], dtype=torch.int64),
            caches, t0 + i, 2)
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("kw", [{}, {"tie_embeddings": True}])
def test_greedy_generate_token_identical_to_jax(kw):
    jm, net, pm, params = _pair(**kw)
    for t0, n_new in ((9, 12), (30, 8)):
        prompt = _prompt(t0, b=2, seed=t0)
        want = np.asarray(jm.generate(net, prompt, n_new=n_new))
        got = pm.generate(params, prompt, n_new=n_new)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_bf16_compute_band_against_jax():
    jm, net, pm, params = _pair(compute_dtype="bfloat16")
    t0 = 20
    prompt = _prompt(t0, seed=3)
    tb = prompt_bucket(t0)
    pad = np.zeros((1, tb), np.int32)
    pad[:, :t0] = prompt
    j_logits, _ = jm._prefill_forward(jm._decode_params(net), pad, tb, t0)
    p16 = pm._decode_params(params)
    assert p16["layer_1"]["mha"]["Wq"].dtype == torch.bfloat16
    logits, caches = pm._prefill_forward(
        p16, torch.as_tensor(pad, dtype=torch.int64), tb, t0)
    assert logits.dtype == torch.bfloat16
    assert caches[0].dtype == torch.bfloat16
    np.testing.assert_allclose(logits.float().numpy(),
                               np.asarray(j_logits, np.float32),
                               atol=BF16_TOL, rtol=0)
    out = pm.generate(params, prompt, n_new=5)
    assert out.shape == (1, t0 + 5)


def test_init_params_shapes_and_rules_match_jax():
    jm = JaxGPTNano(vocab_size=96, max_len=64, seed=1,
                    tie_embeddings=True)
    tree = jax.tree.map(np.asarray, jm.init().params)
    pm = GPTNano(vocab_size=96, max_len=64, seed=1, tie_embeddings=True)
    ours = pm.init_params(device="cpu")
    flat = lambda t, pre="": (
        {k2: v2 for k, v in t.items()
         for k2, v2 in flat(v, f"{pre}{k}.").items()}
        if isinstance(t, dict) else {pre[:-1]: tuple(t.shape)})
    assert flat(ours) == flat(tree)
    head = f"layer_{pm.n_layers + 2}"
    assert "W" not in ours[head]                  # tied: no head W
    # init rules: normal/sqrt(F) embedding, xavier blocks, ones, zeros
    f = pm.hidden
    assert abs(ours["layer_0"]["W"].std().item() - f ** -0.5) < 0.01
    wg = ours["layer_1"]["Wg"]
    assert abs(wg.std().item()
               - (2 / (wg.shape[0] + wg.shape[1])) ** 0.5) < 0.01
    assert (ours["layer_1"]["ln1"]["gamma"] == 1).all()
    assert (ours["layer_1"]["mha"]["bo"] == 0).all()
    # the same seed draws the same values (on any device)
    again = pm.init_params(device="cpu")
    assert torch.equal(again["layer_2"]["Wd"], ours["layer_2"]["Wd"])


def test_params_from_jax_rejects_mismatched_trees(pair):
    jm, net, pm, _ = pair
    tree = jax.tree.map(np.asarray, net.params)
    tree["layer_1"]["Wg"] = tree["layer_1"]["Wg"][:, :-1]
    with pytest.raises(ValueError, match="Wg"):
        pm.params_from_jax(tree, device="cpu")
    del tree["layer_2"]
    with pytest.raises(ValueError, match="keys"):
        pm.params_from_jax(tree, device="cpu")


def test_filter_logits_matches_jax():
    from deeplearning4j_tpu.zoo.gpt import CausalTransformerLM as JaxLM
    logits = np.random.default_rng(4).normal(size=(3, 40)).astype(
        np.float32)
    for top_k, top_p in ((5, None), (None, 0.7), (8, 0.5)):
        want = np.asarray(JaxLM._filter_logits(
            logits, top_k, np.float32(top_p or 1.0), top_p is not None))
        got = CausalTransformerLM._filter_logits(
            torch.tensor(logits), top_k, top_p or 1.0,
            top_p is not None).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(got[~np.isinf(got)],
                                   want[~np.isinf(want)])


def test_sampled_generate_is_reproducible_and_in_vocab(pair):
    _, _, pm, params = pair
    prompt = _prompt(7, b=2)
    outs = [pm.generate(params, prompt, n_new=10, temperature=0.9,
                        top_k=10, top_p=0.9,
                        generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    np.testing.assert_array_equal(outs[0], outs[1])
    gen = outs[0][:, 7:]
    assert ((gen >= 0) & (gen < 64)).all()
    with pytest.raises(ValueError, match="top_k"):
        pm.generate(params, prompt, n_new=2, temperature=1.0, top_k=0)
    with pytest.raises(ValueError, match="top_p"):
        pm.generate(params, prompt, n_new=2, temperature=1.0, top_p=1.5)


def test_generate_guards(pair):
    _, _, pm, params = pair
    prompt = _prompt(5)
    np.testing.assert_array_equal(pm.generate(params, prompt, n_new=0),
                                  prompt)
    with pytest.raises(ValueError, match="max_len"):
        pm.generate(params, _prompt(60), n_new=10)


def test_decode_params_cast_once_and_invalidated():
    _, _, pm, params = _pair(compute_dtype="bfloat16")
    a = pm._decode_params(params)
    assert pm._decode_params(params) is a          # cached
    params["layer_1"]["Wg"] = params["layer_1"]["Wg"] * 2
    b = pm._decode_params(params)                  # leaf replaced
    assert b is not a
    torch.testing.assert_close(b["layer_1"]["Wg"],
                               (params["layer_1"]["Wg"]).bfloat16())


def test_unported_options_rejected_and_presets():
    with pytest.raises(ValueError, match="serve_quant"):
        GPTNano(serve_quant="int8")
    with pytest.raises(ValueError, match="cache_quant"):
        GPTNano(cache_quant="int8")
    mini = GPTMini()
    assert (mini.hidden, mini.n_layers, mini.n_heads) == (384, 6, 6)
    for t in (1, 5, 16, 17, 100, 1025):
        assert prompt_bucket(t) == jax_bucket(t)
        assert prompt_bucket(t, 512) == jax_bucket(t, 512)
