"""The threshold codec K10 (encode) and K11 (decode) through their plain
PyTorch versions, against the JAX package's Pallas kernels run in
interpret mode (``threshold_encode``/``threshold_decode`` called outside
``shard_map``, so the kernels and not their jnp fallbacks run), and the
rest of ``parallel/compression.py`` — ``encode_threshold``/
``decode_threshold``, the bitmap codec, ``AdaptiveThresholdAlgorithm`` —
against its JAX counterparts. On the CPU the port's wrappers run the
plain versions, so they are exercised too; the CUDA kernels themselves
are held against the plain versions on the card by ``chip_smoke.py``.

Tolerance: none. The codec is strict comparisons, one f32 subtraction
(the residual g − q) and bit packing, so the packed words (as int32, bit
31 included), their count, the residuals and the decoded values are
held bit for bit (NaN where NaN), with values exactly ±τ, a NaN and ±inf
among the inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu.parallel import compression as jcomp
from deeplearning4j_tpu_torch import tree
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops.kernel_registry import LM_LEAVES
from deeplearning4j_tpu_torch.parallel import compression as comp
from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM

#: representable in bf16 (3 / 256), so ±τ survives the bf16 cast exactly
TAU = 0.01171875
#: a leaf past one JAX grid block (32 768 words): its word count rounds
#: up to two blocks
LONG = 16 * 32768 + 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grad(shape, seed=0):
    """N(0, 0.01) values with ±τ exactly, a NaN and ±inf at the front."""
    g = (np.random.default_rng(seed).standard_normal(shape) * 0.01
         ).astype(np.float32)
    flat = g.reshape(-1)
    flat[:6] = [TAU, -TAU, np.nan, np.inf, -np.inf, 0.0]
    return g


def _as(g, dtype):
    t = torch.tensor(g)
    return t if dtype == "float32" else t.to(torch.bfloat16)


@pytest.mark.parametrize("shape,dtype", [
    ((10001,), "float32"), ((37, 53), "float32"), ((37, 53), "bfloat16"),
    ((LONG,), "float32")], ids=["10001", "37x53", "37x53-bf16", "long"])
def test_plain_encode_is_bit_identical_to_jax_kernel(shape, dtype):
    g = _grad(shape)
    jw, jr = pk.threshold_encode(jnp.asarray(g).astype(dtype), TAU)
    jw, jr = np.asarray(jw), np.asarray(jr)
    for fn in (ck.threshold_encode_reference, ck.threshold_encode):
        words, resid = fn(_as(g, dtype), TAU)
        assert words.dtype == torch.int32 and jw.dtype == np.int32
        assert words.shape == jw.shape == (ck.threshold_words(g.size),)
        np.testing.assert_array_equal(words.numpy(), jw)
        assert resid.dtype == torch.float32 and resid.shape == shape
        np.testing.assert_array_equal(resid.numpy(), jr)
    assert (jw < 0).any()            # code 2 at j = 15 sets bit 31
    # 2 bits an element on the wire, the padding words 0
    n_used = -(-g.size // 16)
    assert not jw[n_used:].any()


@pytest.mark.parametrize("shape", [(10001,), (37, 53), (LONG,)],
                         ids=["10001", "37x53", "long"])
def test_plain_decode_of_jax_words_equals_jax_decode(shape):
    g = _grad(shape, seed=1)
    jw, _ = pk.threshold_encode(jnp.asarray(g), TAU)
    want = np.asarray(pk.threshold_decode(jw, TAU, g.size, shape))
    words = torch.tensor(np.asarray(jw))
    for fn in (ck.threshold_decode_reference, ck.threshold_decode):
        got = fn(words, TAU, g.size, shape)
        assert got.dtype == torch.float32 and got.shape == shape
        np.testing.assert_array_equal(got.numpy(), want)
    # without a shape: the flat leaf
    flat = ck.threshold_decode(words, TAU, g.size)
    np.testing.assert_array_equal(flat.numpy(), want.reshape(-1))


def test_tau_as_a_device_tensor_equals_tau_as_a_number():
    """The accumulator passes τ as its 0-dim f32 state tensor (read where
    it lives); a number gives the same words."""
    g = torch.tensor(_grad((10001,), seed=2))
    t = torch.tensor(TAU, dtype=torch.float32)
    for a, b in zip(ck.threshold_encode(g, t), ck.threshold_encode(g, TAU)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    words, _ = ck.threshold_encode(g, t)
    assert torch.equal(ck.threshold_decode(words, t, g.numel()),
                       ck.threshold_decode(words, TAU, g.numel()))
    with pytest.raises(ValueError, match="one value"):
        ck.threshold_encode(g, torch.tensor([TAU, TAU]))


def test_cpu_tensors_launch_no_kernel():
    before = (ck.threshold_encode.launches, ck.threshold_decode.launches)
    words, _ = ck.threshold_encode(torch.zeros(100), TAU)
    ck.threshold_decode(words, TAU, 100)
    assert (ck.threshold_encode.launches,
            ck.threshold_decode.launches) == before


def test_word_count_is_the_jax_entrys():
    for size in (1, 15, 16, 17, 2048, 2049, 16 * 32768, LONG,
                 16 * 3 * 32768 + 1):
        c = -(-size // 16)
        c = -(-c // 128) * 128
        bc = min(c, 32768)
        assert ck.threshold_words(size) == -(-c // bc) * bc, size
    assert ck.threshold_words(0) == 0


def test_encode_decode_threshold_match_jax():
    g = _grad((41, 17), seed=3)
    g[np.isnan(g) | np.isinf(g)] = 0.5
    tau = np.float32(TAU)
    js, jr = jcomp.encode_threshold(jnp.asarray(g), jnp.asarray(tau))
    s, r = comp.encode_threshold(torch.tensor(g), torch.tensor(tau))
    assert s.dtype == torch.int8
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(
        comp.decode_threshold(s, torch.tensor(tau)).numpy(),
        np.asarray(jcomp.decode_threshold(js, jnp.asarray(tau))))


@pytest.mark.parametrize("shape", [(100,), (7, 13), (5,)])
def test_bitmap_codec_matches_jax(shape):
    sign = np.random.default_rng(4).integers(-1, 2, shape).astype(np.int8)
    jp, jn = jcomp.encode_bitmap(jnp.asarray(sign))
    p, n = comp.encode_bitmap(torch.tensor(sign))
    assert p.dtype == n.dtype == torch.uint8
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    back = comp.decode_bitmap(p, n, sign.size, shape)
    np.testing.assert_array_equal(back.numpy(), sign)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(jcomp.decode_bitmap(jp, jn, sign.size, shape)))


def test_adaptive_threshold_matches_jax_over_steps():
    """τ adapts identically, to the bit, over a run of dense and sparse
    steps (f32 products and quotients on both sides)."""
    kw = dict(initial_threshold=2e-3, target_sparsity=0.05, decay=1.07)
    ja = jcomp.AdaptiveThresholdAlgorithm(**kw)
    pa = comp.AdaptiveThresholdAlgorithm(**kw)
    jt, pt = ja.init_state(), pa.init_state()
    assert pt.dtype == torch.float32 and pt.shape == ()
    for frac in (0.5, 0.2, 0.01, 0.06, 0.0, 0.05, 1.0):
        jt = ja.update(jt, jnp.float32(frac))
        pt = pa.update(pt, torch.tensor(frac, dtype=torch.float32))
        assert pt.item() == float(jt), (frac, pt.item(), float(jt))


def test_accumulator_state_matches_jax_layout():
    params = {"a": torch.ones(3, 4), "b": {"c": torch.ones(5)}}
    acc = comp.EncodedGradientsAccumulator()
    st = acc.init_state(params)
    assert st["tau"].item() == np.float32(1e-3)
    assert tree.map_(lambda t: tuple(t.shape), st["residual"]) == \
        {"a": (3, 4), "b": {"c": (5,)}}
    ast = acc.init_async_state(params)
    assert set(ast) == {"residual", "inflight", "tau"}
    assert all(float(t.abs().sum()) == 0
               for t in tree.leaves({k: ast[k] for k in ("residual",
                                                         "inflight")}))


def test_dp_packed_counts_are_the_train_lms_leaves():
    """The registry's K10/K11 count per dp_packed step is the train LM's
    number of parameter leaves: counted from a depth-cut net's params
    (3 + 10 a block), and from the full model's parameter tree."""
    kw = dict(vocab_size=64, hidden=64, n_heads=2, max_len=32,
              ffn_mult=8 / 3, tie_embeddings=True)
    for depth in (1, 2):
        net = CausalTransformerLM(n_layers=depth, **kw).init(
            16, device="cpu")
        assert len(list(tree.leaves(net.params))) == 3 + 10 * depth
    full = CausalTransformerLM(vocab_size=50257, hidden=768, n_layers=12,
                               n_heads=6, max_len=1024, ffn_mult=8 / 3,
                               tie_embeddings=True)
    assert len(list(tree.leaves(full.param_shapes()))) == LM_LEAVES
