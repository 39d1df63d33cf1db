"""The ring's building blocks on the CPU, without ranks: the port's
block entries ``flash_block_fwd``/``flash_block_bwd`` (their plain
versions, as a CPU tensor runs them) against the JAX entries of the same
names run directly, which puts the Pallas kernels in interpret mode, at
every (rank, source) block pair of a 4-rank causal ring; the exact
merge ``_merge_blocks``; the zigzag order, permutation and the
sequence shards of ``parallel/mesh.py``; the fused/split choice of the
block backward; and the layer's typo check. The ranks' twins are in
``tests/torch_sp_twins.py``.

Tolerances: the block entries, f32, 2e-5 absolute on the outputs and
lse, and 5e-5 of the largest gradient on dq, dk, dv (the same math in
another summation order: ``tests/test_torch_flash_split.py``'s bands);
the merge to 1e-6 (torch's and XLA's ``logaddexp`` differ in
the last bit), its −inf rows exactly; the permutations exactly.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import MultiHeadAttention as JaxMHA
from deeplearning4j_tpu.ops import pallas_kernels as jax_pk
from deeplearning4j_tpu.parallel import ring_attention as jax_ring
from deeplearning4j_tpu_torch.nn.layers import MultiHeadAttention
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.parallel import mesh, ring_attention

N = 4                      # ring size of the block pairs
B, T, H, HKV, D = 2, 64, 4, 2, 16
ATOL = 2e-5
GRAD_REL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block_inputs(seed, masked):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, HKV, D)).astype(np.float32)
    v = rng.normal(size=(B, T, HKV, D)).astype(np.float32)
    g = rng.normal(size=(B, T, H, D)).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.random((B, T)) > 0.3).astype(np.float32)
    return q, k, v, g, mask


def _fold(x):
    """[B, T, heads, D] → the JAX entries' [B·heads, T, D]."""
    b, t, h, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)


def _unfold(x, heads):
    x = np.asarray(x)
    return x.reshape(B, heads, x.shape[1], x.shape[2]).transpose(0, 2, 1, 3)


def _jax_km(mask):
    return None if mask is None else jnp.repeat(jnp.asarray(mask), HKV, 0)


#: (m, src, causal, masked): every pair of a 4-rank causal ring (a key
#: mask on the odd ones), and two pairs without the causal rule
PAIRS = ([(m, s, True, (m + s) % 2 == 1) for m in range(N)
          for s in range(N)]
         + [(1, 2, False, False), (2, 1, False, True)])


@pytest.mark.parametrize("m,src,causal,masked", PAIRS)
def test_block_entries_match_jax(m, src, causal, masked):
    """GQA blocks (H 4 over Hkv 2) at the ring pair's global offsets
    (m·T, src·T): the forward's out and lse, then the backward from a
    global out and lse (those of the rank's own diagonal block), against
    the JAX entries in interpret mode."""
    q, k, v, g, mask = _block_inputs(10 * m + src, masked)
    offs = (m * T, src * T)
    jkm = _jax_km(mask)
    jo, jl = jax_pk.flash_block_fwd(
        _fold(q), _fold(k), _fold(v), jkm, jnp.asarray(offs, jnp.int32),
        causal, groups=H // HKV)
    t = lambda a: None if a is None else torch.tensor(a)
    o, lse = ck.flash_block_fwd(t(q), t(k), t(v), t(mask), offs, causal)
    np.testing.assert_allclose(o.numpy(), _unfold(jo, H), atol=ATOL,
                               rtol=0)
    want_lse = np.asarray(jl)[..., 0].reshape(B, H, T)
    assert np.array_equal(np.isinf(lse.numpy()), np.isinf(want_lse))
    fin = np.isfinite(want_lse)
    np.testing.assert_allclose(lse.numpy()[fin], want_lse[fin], atol=ATOL,
                               rtol=0)
    # the global out and lse the backward takes: the diagonal block's
    go, gl = ck.flash_block_fwd(t(q), t(k), t(v), t(mask), (m * T, m * T),
                                causal)
    theirs = jax_pk.flash_block_bwd(
        _fold(q), _fold(k), _fold(v), _fold(go.numpy()),
        jnp.asarray(gl.numpy()).reshape(B * H, T, 1), _fold(g), jkm,
        jnp.asarray(offs, jnp.int32), causal, groups=H // HKV)
    ours = ck.flash_block_bwd(t(q), t(k), t(v), go, gl, t(g), t(mask),
                              offs, causal)
    for name, a, th, heads in zip(("dq", "dk", "dv"), ours, theirs,
                                  (H, HKV, HKV)):
        th = _unfold(th, heads)
        assert a.shape == th.shape, name
        rel = np.abs(a.numpy() - th).max() / max(np.abs(th).max(), 1e-30)
        assert rel <= GRAD_REL, (name, rel)


def test_dead_block_returns_zeros_and_neg_inf():
    """A causal block wholly above the diagonal (keys of source 2 for
    the queries of rank 1): out exactly 0, lse −inf, and zero gradients
    — nothing a merge could turn into NaN."""
    q, k, v, g, _ = _block_inputs(7, False)
    t = torch.tensor
    o, lse = ck.flash_block_fwd(t(q), t(k), t(v), None, (T, 2 * T), True)
    assert torch.equal(o, torch.zeros_like(o))
    assert bool(torch.isneginf(lse).all())
    go, gl = ck.flash_block_fwd(t(q), t(k), t(v), None, (T, T), True)
    for x in ck.flash_block_bwd(t(q), t(k), t(v), go, gl, t(g), None,
                                (T, 2 * T), True):
        assert torch.equal(x, torch.zeros_like(x))
    out, ls = ring_attention._merge_blocks(go.float(), gl, o, lse)
    assert torch.equal(out, go.float()) and torch.equal(ls, gl)


def test_merge_blocks_matches_jax():
    """The exact merge against the JAX one (its [B·H, T, ·] layout),
    with rows that are −inf on one side, on the other, and on both."""
    rng = np.random.default_rng(3)
    out = rng.normal(size=(B, T, H, D)).astype(np.float32)
    o_b = rng.normal(size=(B, T, H, D)).astype(np.float32)
    lse = rng.normal(size=(B, H, T)).astype(np.float32)
    lse_b = rng.normal(size=(B, H, T)).astype(np.float32)
    lse[:, :, :5] = -np.inf
    lse_b[:, :, 3:8] = -np.inf
    out[:, :5] = 0.0
    o_b[:, 3:8] = 0.0
    got_o, got_l = ring_attention._merge_blocks(
        torch.tensor(out), torch.tensor(lse), torch.tensor(o_b),
        torch.tensor(lse_b))
    col = lambda x: jnp.asarray(x).reshape(B * H, T, 1)
    want_o, want_l = jax_ring._merge_blocks(_fold(out), col(lse),
                                            _fold(o_b), col(lse_b))
    np.testing.assert_allclose(got_o.numpy(), _unfold(want_o, H),
                               rtol=1e-6, atol=1e-7)
    want_l = np.asarray(want_l).reshape(B, H, T)
    assert np.array_equal(np.isneginf(got_l.numpy()), np.isneginf(want_l))
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=1e-6, atol=1e-6)
    assert bool(torch.isneginf(got_l[:, :, 3:5]).all())
    assert bool(torch.isfinite(got_o).all())


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_zigzag_permutation_equals_jax(n):
    assert ring_attention.zigzag_order(n) == jax_ring.zigzag_order(n)
    x = np.arange(2 * 48 * 3, dtype=np.float32).reshape(2, 48, 3)
    got = ring_attention.zigzag_permute(torch.tensor(x), n)
    want = np.asarray(jax_ring.zigzag_permute(jnp.asarray(x), n))
    np.testing.assert_array_equal(got.numpy(), want)
    back = ring_attention.zigzag_unpermute(got, n)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        ring_attention.zigzag_unpermute(torch.tensor(want), n).numpy(),
        np.asarray(jax_ring.zigzag_unpermute(jnp.asarray(want), n)))
    # rank m's shard is the m-th of n chunks of the permuted sequence
    for m in range(n):
        shard = mesh.shard_sequence(torch.tensor(x), "zigzag_ring", n, m)
        np.testing.assert_array_equal(
            shard.numpy(), want[:, m * 48 // n:(m + 1) * 48 // n])
    shards = [mesh.shard_sequence(torch.tensor(x), mode, n, m)
              for mode in ("zigzag_ring", "ring") for m in range(n)]
    np.testing.assert_array_equal(
        mesh.unshard_sequence(shards[:n], "zigzag_ring").numpy(), x)
    np.testing.assert_array_equal(
        mesh.unshard_sequence(shards[n:], "ring").numpy(), x)


def test_indivisible_sequences_raise():
    x = torch.zeros(2, 30)
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention.zigzag_permute(x, 4)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_sequence(x, "zigzag_ring", 4, 0)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_sequence(x, "ring", 4, 0)
    assert mesh.shard_sequence(x, "ring", 3, 1).shape == (2, 10)


def test_sequence_segments_are_the_global_positions():
    assert mesh.sequence_segments("ring", 4, 2, 8) == ((16, 8),)
    assert mesh.sequence_segments("ulysses", 4, 0, 8) == ((0, 8),)
    # zigzag: chunks (m, 2n−1−m) of 2n, of c = T_loc / 2 tokens each
    assert mesh.sequence_segments("zigzag_ring", 4, 1, 8) == ((4, 4),
                                                              (24, 4))
    with pytest.raises(ValueError, match="unknown"):
        mesh.sequence_segments("ulyses", 4, 0, 8)


@pytest.mark.parametrize("t,d", [(1024, 128), (16384, 128), (24576, 64),
                                 (24577, 128), (32768, 128)])
def test_block_bwd_dispatch_equals_the_jax_condition(t, d, monkeypatch):
    """``flash_block_bwd`` takes the split pair exactly where the JAX
    ``flash_block_bwd`` (its ``_flash_bwd`` at the ring's default
    blocks) does on the block's own query length; on the CPU it runs the
    chosen kernels' plain versions."""
    block_q, block_k = jax_pk._ring_block_defaults(None, None, t)
    _, _, tq, _, dp = jax_pk._flash_blocks(t, t, d, block_q, block_k)
    split = not tq * dp * 4 <= jax_pk._FUSED_BWD_DQ_VMEM
    assert ck._split_bwd(t, d) == split
    calls = []
    for name in ("flash_attention_bwd_reference",
                 "flash_attention_bwd_dq_reference",
                 "flash_attention_bwd_dkv_reference"):
        monkeypatch.setattr(ck, name,
                            lambda *a, _n=name, **kw: calls.append(_n)
                            or (None, None))
    monkeypatch.setattr(ck, "_split_bwd", lambda tq_, d_: split)
    x = torch.zeros(1, 8, 2, d)
    lse = torch.zeros(1, 2, 8)
    ck.flash_block_bwd(x, x, x, x, lse, x, None, (t, 0), True)
    assert calls == (["flash_attention_bwd_dq_reference",
                      "flash_attention_bwd_dkv_reference"] if split
                     else ["flash_attention_bwd_reference"])


def test_block_counters_stay_zero_on_cpu():
    """The plain versions launch nothing: K1's and K3's counters do not
    move on the CPU."""
    q, k, v, g, _ = _block_inputs(5, False)
    t = torch.tensor
    before = (ck.flash_attention.launches, ck.flash_attention_bwd.launches)
    o, lse = ck.flash_block_fwd(t(q), t(k), t(v), None, (0, 0), True)
    ck.flash_block_bwd(t(q), t(k), t(v), o, lse, t(g), None, (0, 0), True)
    assert (ck.flash_attention.launches,
            ck.flash_attention_bwd.launches) == before


def test_unknown_mode_raises_without_a_context():
    """The typo half of ``tests/test_parallel.py:621``: a mistyped mode
    raises even on one device, with no context active, as in JAX."""
    bad = MultiHeadAttention(n_in=16, n_out=16, n_heads=2,
                             sequence_parallel="ulyses")
    params, _, _ = bad.init(torch.Generator().manual_seed(0), (8, 16))
    with pytest.raises(ValueError, match="sequence_parallel"):
        bad.apply(params, {}, torch.zeros(1, 8, 16))
    jbad = JaxMHA(n_in=16, n_out=16, n_heads=2, sequence_parallel="ulyses")
    jparams, _, _ = jbad.init(jax.random.PRNGKey(0), (8, 16))
    with pytest.raises(ValueError, match="sequence_parallel"):
        jbad.apply(jparams, {}, jnp.zeros((1, 8, 16)))


@pytest.mark.parametrize("mode", ["ring", "ulysses", "zigzag_ring"])
def test_layer_without_a_context_is_local(mode):
    """Outside a context a sequence-parallel layer is the local layer,
    as the JAX layer is (``:574``'s reference side): its output equals
    the JAX layer's from the same weights."""
    layer = JaxMHA(n_in=16, n_out=16, n_heads=8, causal=True, rope=True,
                   sequence_parallel=mode)
    params, _, _ = layer.init(jax.random.PRNGKey(0), (32, 16))
    x = np.random.default_rng(1).normal(size=(2, 32, 16)).astype(
        np.float32)
    want, _ = layer.apply(params, {}, jnp.asarray(x))
    ours = MultiHeadAttention(n_in=16, n_out=16, n_heads=8, causal=True,
                              rope=True, sequence_parallel=mode)
    got, _ = ours.apply({k: torch.tensor(np.asarray(v))
                         for k, v in params.items()}, {}, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)
    assert not math.isnan(float(got.sum()))


class _OneRank:
    """A one-rank ``{"seq": 1}`` mesh without a process group: at group
    size 1 the ring sends nothing and the network sums nothing."""
    axis_names = ("seq",)

    def group(self, axis):
        return None

    def size(self, axis=None):
        return 1

    def index(self, axis):
        return 0


def test_sp_step_runs_the_registry_block_pairs(monkeypatch):
    """The ``sp`` path's launches a step, counted from the code: GPTNano
    with ``sequence_parallel="zigzag_ring"`` under a one-rank context
    calls ``flash_block_fwd`` and ``flash_block_bwd`` ``SP_PAIRS`` times
    a layer a step (the card's K1 and K3 counts of the registry, whose
    ``sp`` row holds ``SP_PAIRS`` · 12 for the 12-layer model), and its
    step equals the same step without the context."""
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.parallel.mesh import distributed_context
    from deeplearning4j_tpu_torch.zoo.gpt import GPTNano
    calls = {"fwd": 0, "bwd": 0}
    for key, name in (("fwd", "flash_block_fwd"),
                      ("bwd", "flash_block_bwd")):
        fn = getattr(ring_attention, name)

        def spy(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ring_attention, name, spy)
    model = GPTNano(vocab_size=16, max_len=64, seed=5,
                    sequence_parallel="zigzag_ring")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 16, (2, 33))
    x, y = toks[:, :-1], toks[:, 1:]
    net, local = model.init(32, device="cpu"), model.init(32, device="cpu")
    with distributed_context(_OneRank()):
        net.fit(x, y)
    local.fit(x, y)
    pairs = kernel_registry.SP_PAIRS
    assert calls == {"fwd": pairs * model.n_layers,
                     "bwd": pairs * model.n_layers}
    rows = {e.key: e.per_step.get("sp", 0) for e in kernel_registry.ported()}
    assert rows["K1"] == rows["K3"] == pairs * 12
    assert rows["K4"] == rows["K5"] == 0
    np.testing.assert_allclose(net.score(), local.score(), rtol=2e-5)


def test_ulysses_alias_keeps_the_jax_import_location():
    """``tests/test_parallel.py:696``: ``ring_attention.ulysses_attention``
    is ``ulysses_self_attention``; at one rank it is the local attention
    (the gloo ranks' twins hold it at 2 and 4)."""
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        scaled_dot_attention
    from deeplearning4j_tpu_torch.parallel import ulysses_self_attention
    assert ring_attention.ulysses_attention is ulysses_self_attention
    q = torch.randn(2, 32, 8, 4, generator=torch.Generator().manual_seed(2))
    np.testing.assert_allclose(
        ring_attention.ulysses_attention(q, q, q, _OneRank()).numpy(),
        scaled_dot_attention(q, q, q).numpy(), rtol=2e-4, atol=2e-5)
