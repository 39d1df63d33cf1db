"""The long-context slice as a whole on the CPU: the port's GPTNano
trained through ``CausalTransformerLM.init`` → ``MultiLayerNetwork.fit``
with every attention backward on the split pair (K4 dq, K5 dk/dv),
beside the JAX package's network from the same carried-across weights
and the same numpy batches.

At the full model's 32 768-token context the port takes the split
backward by the JAX package's own test (``_FUSED_BWD_DQ_VMEM``); at a
CPU test's size it is forced by patching
``cuda_kernels._FUSED_BWD_DQ_VMEM`` to 0. On the CPU the port's
attention normally takes the einsum (its plain version); here the gate
is opened so that each block's attention runs the flash path's plain
versions — forward, then the split backward — as the card runs their
kernels. The JAX side stays on its CPU einsum route, which computes the
same function.

Tolerances, those of ``tests/test_torch_train.py``:
- float32: losses within 1e-5 relative per step; parameters after 3
  steps 99.9 % of the elements within 1e-6, all within 1e-4.
- bfloat16 compute: losses within 2e-3 relative; each parameter tensor
  97 % of its elements within 1e-4, every element within 2 · lr · steps.
  (The flash plain versions compute in f32 from the bf16 operands and
  round each output once; the JAX einsum rounds at every op.)
"""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.zoo.gpt import GPTNano as JaxGPTNano
from deeplearning4j_tpu_torch import tree
from deeplearning4j_tpu_torch.nn.layers import attention
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM, GPTNano

LR = 3e-4            # the model's default AdamW learning rate
STEPS = 3
KW = dict(vocab_size=16, max_len=64, seed=5)
#: the port's own budget, as imported (the fixture patches it to 0)
FUSED_BUDGET = ck._FUSED_BWD_DQ_VMEM
#: the long-context configuration the card trains (chip_smoke.py)
LONGCTX = dict(vocab_size=50257, hidden=768, n_layers=12, n_heads=6,
               ffn_mult=8 / 3, tie_embeddings=True, max_len=32768,
               compute_dtype="bfloat16")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def split_path(monkeypatch):
    """Attention through the flash path on the CPU, its backward on the
    split pair; counts the calls of each backward's plain version."""
    monkeypatch.setattr(ck, "_FUSED_BWD_DQ_VMEM", 0)
    monkeypatch.setattr(
        attention, "_use_flash",
        lambda q, k, causal=False: (not (causal and q.shape[1] > k.shape[1])
                                    and q.dtype != torch.float64))
    calls = {}
    for name in ("flash_attention_bwd_reference",
                 "flash_attention_bwd_dq_reference",
                 "flash_attention_bwd_dkv_reference"):
        fn = getattr(ck, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ck, name, spy)
    return calls


def _pair(seq_len=24, **kw):
    jnet = JaxGPTNano(**KW, **kw).init(seq_len=seq_len)
    pnet = GPTNano(**KW, **kw).init(seq_len, device="cpu")
    pnet.params_from_jax(jax.tree.map(np.asarray, jnet.params))
    return jnet, pnet


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


def _split_calls_per_step(n_layers=4):
    return {"flash_attention_bwd_dq_reference": n_layers,
            "flash_attention_bwd_dkv_reference": n_layers}


@pytest.mark.parametrize("kw", [{}, {"tie_embeddings": True}],
                         ids=["untied", "tied"])
def test_fit_through_split_backward_matches_jax_f32(kw, split_path):
    jnet, pnet = _pair(**kw)
    for i, (x, y) in enumerate(_batches(STEPS)):
        jnet.fit(x, y)
        pnet.fit(x, y)
        assert np.isclose(pnet.score(), jnet.score(), rtol=1e-5, atol=0)
        # every block's backward went through K4's and K5's plain
        # versions, none through the fused one
        assert split_path == {k: (i + 1) * n for k, n in
                              _split_calls_per_step().items()}
    d = np.concatenate(list(_leaf_diffs(jnet, pnet).values()))
    assert (d <= 1e-6).mean() >= 0.999, (d <= 1e-6).mean()
    assert d.max() <= 1e-4, d.max()
    assert pnet.iteration == STEPS


def test_fit_through_split_backward_matches_jax_bf16_compute(split_path):
    jnet, pnet = _pair(compute_dtype="bfloat16")
    for x, y in _batches(STEPS, seed=1):
        jnet.fit(x, y)
        pnet.fit(x, y)
        assert np.isclose(pnet.score(), jnet.score(), rtol=2e-3, atol=0)
    assert split_path == {k: STEPS * n for k, n in
                          _split_calls_per_step().items()}
    assert all(t.dtype == torch.float32
               for t in tree.leaves(pnet.params))
    for key, d in _leaf_diffs(jnet, pnet).items():
        assert (d <= 1e-4).mean() >= 0.97, (key, (d <= 1e-4).mean())
        assert d.max() <= 2 * LR * STEPS, (key, d.max())


def test_split_and_fused_backward_train_alike(split_path, monkeypatch):
    """The same network trained 2 steps with the split backward and with
    the fused one (the port's own constant restored): the same function,
    so the same losses and parameters to f32 rounding."""
    nets = []
    for budget in (0, FUSED_BUDGET):
        monkeypatch.setattr(ck, "_FUSED_BWD_DQ_VMEM", budget)
        net = GPTNano(**KW).init(40, device="cpu")
        for x, y in _batches(2, t=40, seed=2):
            net.fit(x, y)
        nets.append(net)
    assert split_path["flash_attention_bwd_reference"] == 2 * 4
    assert split_path["flash_attention_bwd_dq_reference"] == 2 * 4
    assert nets[0].score() == pytest.approx(nets[1].score(), rel=1e-6)
    for a, b in zip(tree.leaves(nets[0].params),
                    tree.leaves(nets[1].params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_long_context_config_takes_the_split_backward():
    """The configuration the card trains: 6 heads of 128, a 32 768-token
    context — past the fused backward's budget, so K4 + K5 run in every
    block — built without allocating it."""
    model = CausalTransformerLM(**LONGCTX)
    d = model.hidden // model.n_heads
    assert d == 128 and model.max_len == 32768
    assert ck._split_bwd(32768, d)
    assert not ck._split_bwd(1024, d)      # the train phase stays fused
    conf = model.conf(32768)
    assert len(conf.layers) == model.n_layers + 3
