"""Head dims between the flash kernels' own (16, 32, 64, 128, 256) on the
CPU: the zero pad of ``ops/cuda_kernels.py`` (ROADMAP C11).

The kernels are compiled at five head dims; any other up to 256 reaches
them zero-padded to the next, at the softmax scale of the real dim, the
pad sliced off the outputs. Here the launch helpers themselves run
(``_flash_cuda`` for K1, ``_flash_bwd_cuda`` for K3, ``_split_launch``
for K4 and K5) on CPU tensors against a stand-in library whose C entries
read the operands through the pointers, strides, head dim and scale they
are given and run the plain versions on them: the plain kernels on the
zero-padded inputs at the scale the helper passes. Their out, lse, dq,
dk and dv equal the unpadded plain versions' to 1e-6 at D in {2, 24, 48,
80, 96, 160, 192, 256}, with grouped-query heads, causal rows at offsets
and a key mask (f32: the pad adds exact zeros to every dot product, so
the two differ only by the order the shorter sums are taken in). Every
entry receives the padded head dim and the real dim's scale; a head dim
above 256 is refused naming C11.

Then the layer the reference computes off the TPU at head dim 2,
``SelfAttentionLayer(n_out=4, n_heads=2)``: its forward and the
gradients of its parameters and input against the JAX layer's within
``tests/test_torch_layers.py``'s band (1e-5), on the einsum and on the
flash path's plain versions (the dispatch gate opened on the CPU); and
the same layer at head dims 160, 192 and 256.
"""
import ctypes
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers.attention import \
    SelfAttentionLayer as JSelfAttention
from deeplearning4j_tpu_torch.nn.layers import attention
from deeplearning4j_tpu_torch.nn.layers.attention import SelfAttentionLayer
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck

DIMS = (2, 24, 48, 80, 96, 160, 192, 256)
TOL = 1e-6
LAYER_TOL = 1e-5        # tests/test_torch_layers.py's band


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _view(ptr, shape, strides):
    """The f32 tensor at address ``ptr`` with ``shape`` and ``strides``
    (in elements), sharing its memory."""
    n = 1 + sum((s - 1) * st for s, st in zip(shape, strides))
    buf = (ctypes.c_float * n).from_address(ptr)
    return torch.as_strided(torch.frombuffer(buf, dtype=torch.float32),
                            shape, strides)


def _dense(ptr, shape):
    """The contiguous f32 tensor at ``ptr``."""
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    return _view(ptr, shape, strides)


class _PlainLib:
    """A stand-in for the kernels' libraries: each C entry takes the
    arguments the launch helper passes (``ops/cuda_kernels.py``
    ``_LIBS``), reads its operands through their pointers and strides,
    runs the plain version at the head dim and scale it is given, and
    writes its outputs where the pointers say. ``calls`` records
    (entry, head dim, scale)."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _bhd(b, t, h, d, ptr, strides):
        return _view(ptr, (b, t, h, d), (*strides, 1))

    def dl4j_flash_attention_fwd(self, dtype, d, q, k, v, km, o, lse, b, t,
                                 tk, h, h_kv, *rest):
        strides, (causal, q_off, scale, _) = rest[:9], rest[9:]
        self.calls.append(("fwd", d, scale))
        qt = self._bhd(b, t, h, d, q, strides[0:3])
        kt = self._bhd(b, tk, h_kv, d, k, strides[3:6])
        vt = self._bhd(b, tk, h_kv, d, v, strides[6:9])
        mask = None if km is None else _dense(km, (b, tk))
        out, l = ck.flash_attention_reference(
            qt, kt, vt, bool(causal), mask, return_lse=True,
            offsets=(q_off, 0), scale=scale)
        _dense(o, (b, t, h, d)).copy_(out)
        if lse is not None:
            _dense(lse, (b, h, t)).copy_(l)
        return 0

    def dl4j_flash_attention_bwd(self, dtype, d, q, k, v, o, do, lse, km,
                                 dq, dk, dv, dq_acc, delta, b, t, tk, h,
                                 h_kv, *rest):
        strides, (causal, q_off, scale, _) = rest[:15], rest[15:]
        self.calls.append(("bwd", d, scale))
        qt = self._bhd(b, t, h, d, q, strides[0:3])
        kt = self._bhd(b, tk, h_kv, d, k, strides[3:6])
        vt = self._bhd(b, tk, h_kv, d, v, strides[6:9])
        ot = self._bhd(b, t, h, d, o, strides[9:12])
        dot = self._bhd(b, t, h, d, do, strides[12:15])
        mask = None if km is None else _dense(km, (b, tk))
        got = ck.flash_attention_bwd_reference(
            qt, kt, vt, ot, _dense(lse, (b, h, t)), dot, bool(causal), mask,
            offsets=(q_off, 0), scale=scale)
        for ptr, x in zip((dq, dk, dv), got):
            _dense(ptr, tuple(x.shape)).copy_(x)
        return 0

    def dl4j_flash_attention_bwd_delta(self, dtype, d, o, do, delta, b, t,
                                       h, *rest):
        self.calls.append(("delta", d, None))
        ot = self._bhd(b, t, h, d, o, rest[0:3])
        dot = self._bhd(b, t, h, d, do, rest[3:6])
        _dense(delta, (b, h, t)).copy_(ck._delta_reference(ot, dot))
        return 0

    def _split(self, name, fn, d, q, k, v, do, lse, delta, km, outs, b, t,
               tk, h, h_kv, rest):
        strides, (causal, q_off, k_off, scale, _) = rest[:12], rest[12:]
        self.calls.append((name, d, scale))
        qt = self._bhd(b, t, h, d, q, strides[0:3])
        kt = self._bhd(b, tk, h_kv, d, k, strides[3:6])
        vt = self._bhd(b, tk, h_kv, d, v, strides[6:9])
        dot = self._bhd(b, t, h, d, do, strides[9:12])
        mask = None if km is None else _dense(km, (b, tk))
        got = fn(qt, kt, vt, None, _dense(lse, (b, h, t)), dot,
                 bool(causal), mask, offsets=(q_off, k_off),
                 delta=_dense(delta, (b, h, t)), scale=scale)
        for ptr, x in zip(outs, got if isinstance(got, tuple) else (got,)):
            _dense(ptr, tuple(x.shape)).copy_(x)
        return 0

    def dl4j_flash_attention_bwd_dq(self, dtype, d, q, k, v, do, lse,
                                    delta, km, dq, b, t, tk, h, h_kv,
                                    *rest):
        return self._split("dq", ck.flash_attention_bwd_dq_reference, d, q,
                           k, v, do, lse, delta, km, (dq,), b, t, tk, h,
                           h_kv, rest)

    def dl4j_flash_attention_bwd_dkv(self, dtype, d, q, k, v, do, lse,
                                     delta, km, dk, dv, b, t, tk, h, h_kv,
                                     *rest):
        return self._split("dkv", ck.flash_attention_bwd_dkv_reference, d,
                           q, k, v, do, lse, delta, km, (dk, dv), b, t, tk,
                           h, h_kv, rest)


@pytest.fixture
def plain_lib(monkeypatch):
    """The launch helpers bound to :class:`_PlainLib` on the CPU (no
    stream, launch counters restored afterwards)."""
    lib = _PlainLib()
    monkeypatch.setattr(ck, "_lib", lambda name="flash_attention": lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    for fn in (ck.flash_attention, ck.flash_attention_bwd):
        monkeypatch.setattr(fn, "launches", fn.launches)
    return lib


def _case(d, h, h_kv, masked, seed, t=37, tk=53):
    rng = np.random.default_rng(seed)
    mk = lambda n, heads: torch.tensor(
        rng.standard_normal((2, n, heads, d)), dtype=torch.float32)
    q, k, v, do = mk(t, h), mk(tk, h_kv), mk(tk, h_kv), mk(t, h)
    mask = None
    if masked:
        m = (rng.random((2, tk)) > 0.3).astype(np.float32)
        m[:, 0] = 1
        mask = torch.tensor(m)
    return q, k, v, do, mask


#: (query heads, kv heads, causal, offsets, key mask)
CASES = {"gqa": (4, 2, False, None, False),
         "causal_offsets": (2, 2, True, (40, 16), False),
         "key_mask": (2, 1, False, None, True),
         "causal_masked": (4, 2, True, (16, 0), True)}


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=TOL, err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", DIMS)
def test_padded_launches_equal_the_unpadded_plain_versions(plain_lib, d,
                                                           case):
    """K1, K3 and the split pair K4 + K5 (Delta on the unpadded out and
    dO) through their launch helpers: out, lse, dq, dk, dv to 1e-6 of the
    plain versions at the real head dim."""
    h, h_kv, causal, offs, masked = CASES[case]
    q, k, v, do, mask = _case(d, h, h_kv, masked, d)
    offsets = ck._offsets(q.shape[1], k.shape[1], causal, offs)
    ref_out, ref_lse = ck.flash_attention_reference(
        q, k, v, causal, mask, return_lse=True, offsets=offsets)
    out, lse = ck._flash_cuda(q, k, v, mask, causal,
                              offsets[0] - offsets[1], True)
    assert out.shape == q.shape and out.is_contiguous()
    _close(out, ref_out, "out")
    live = torch.isfinite(ref_lse)
    assert torch.equal(live, torch.isfinite(lse))
    _close(lse[live], ref_lse[live], "lse")
    ref = ck.flash_attention_bwd_reference(q, k, v, ref_out, ref_lse, do,
                                           causal, mask, offsets)
    fused = ck._flash_bwd_cuda(q, k, v, ref_out, ref_lse, do, mask, causal,
                               offsets[0] - offsets[1])
    dq, = ck._split_launch("dl4j_flash_attention_bwd_dq", q, k, v, ref_out,
                           ref_lse, do, causal, mask, offsets, None)
    dk, dv = ck._split_launch("dl4j_flash_attention_bwd_dkv", q, k, v,
                              ref_out, ref_lse, do, causal, mask, offsets,
                              None)
    for name, got, want in zip(("dq", "dk", "dv"), fused, ref):
        assert got.shape == want.shape
        _close(got, want, f"K3 {name}")
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert got.shape == want.shape
        _close(got, want, f"K4/K5 {name}")
    dp = ck._kernel_dim(d)
    assert dp in ck._HEAD_DIMS and dp >= d
    for entry, dim, scale in plain_lib.calls:
        if entry == "delta":
            assert dim == d            # the pre-pass runs unpadded
        else:
            assert dim == dp, (entry, dim)


@pytest.mark.parametrize("d", (2, 24, 64, 80, 128, 160, 256))
def test_no_launch_helper_scales_by_the_padded_dim(plain_lib, d):
    """Every entry K1, K3, K4 and K5 receive takes 1/√d of the real head
    dim as its softmax scale, the padded dim as its head dim; a dim the
    kernels hold goes unpadded."""
    q, k, v, do, mask = _case(d, 2, 2, True, 7, t=9, tk=11)
    out, lse = ck._flash_cuda(q, k, v, mask, False, 0, True)
    ck._flash_bwd_cuda(q, k, v, out, lse, do, mask, False, 0)
    for entry in ("dl4j_flash_attention_bwd_dq",
                  "dl4j_flash_attention_bwd_dkv"):
        ck._split_launch(entry, q, k, v, out, lse, do, False, mask, None,
                         None)
    scaled = [(e, dim, s) for e, dim, s in plain_lib.calls if s is not None]
    assert [e for e, _, _ in scaled] == ["fwd", "bwd", "dq", "dkv"]
    for entry, dim, scale in scaled:
        assert dim == ck._kernel_dim(d), entry
        assert scale == 1.0 / math.sqrt(d), (entry, scale)
    if d in ck._HEAD_DIMS:
        assert ck._pad_head(q, d) is q


def test_fused_split_choice_is_made_at_the_real_dim(monkeypatch):
    """The backward's choice of K3 or K4 + K5 reads the real head dim
    (the JAX condition's padding to 128 lanes is its own): a head dim of
    80 picks as 80 does, not as its kernel dim 128."""
    seen = []
    real = ck._split_bwd
    monkeypatch.setattr(ck, "_split_bwd",
                        lambda tq, d: seen.append(d) or real(tq, d))
    q, k, v, do, _ = _case(80, 2, 2, False, 3, t=8, tk=8)
    out, lse = ck.flash_attention_reference(q, k, v, return_lse=True)
    ck.flash_attention_bwd(q, k, v, out, lse, do)
    assert seen == [80]


def test_head_dim_above_128_is_refused_naming_c11(plain_lib):
    """The refusal now starts above 256, the largest kernel dim: every
    head dim in (128, 256] runs at 256 (the padded cases above)."""
    for d in (129, 160, 256):
        assert ck._kernel_dim(d) == 256
    for d in (257, 512):
        with pytest.raises(ValueError, match="C11"):
            ck._kernel_dim(d)
    q, k, v, _, _ = _case(320, 2, 2, False, 1, t=4, tk=4)
    with pytest.raises(ValueError, match="C11"):
        ck._flash_cuda(q, k, v, None, False, 0, True)
    assert not plain_lib.calls


# -- the layer the reference computes at head dim 2 ---------------------------
def _jax_layer_grads(layer, params, x, mask, w):
    def f(p, xx):
        y, _ = layer.apply(p, {}, xx, mask=mask)
        return jnp.sum(y * w)
    y, _ = layer.apply(params, {}, x, mask=mask)
    return y, jax.grad(f, argnums=(0, 1))(params, x)


@pytest.mark.parametrize("path", ["einsum", "flash"])
def test_self_attention_at_head_dim_2_matches_jax(monkeypatch, path):
    """``SelfAttentionLayer(n_out=4, n_heads=2)`` (head dim 2, the
    reference's own test layer): output and the gradients of W and x
    against the JAX layer within 1e-5, on the einsum and, with the gate
    opened, on the flash path's plain versions."""
    if path == "flash":
        monkeypatch.setattr(
            attention, "_use_flash",
            lambda q, k, causal=False: (
                not (causal and q.shape[1] > k.shape[1])
                and q.dtype != torch.float64))
    jlayer = JSelfAttention(n_out=4, n_heads=2)
    jparams, _, out_shape = jlayer.init(jax.random.PRNGKey(0), (5, 4))
    assert out_shape == (5, 4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 4)).astype(np.float32)
    w = rng.standard_normal((2, 5, 4)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1] * 5], np.float32)
    jy, (jgp, jgx) = _jax_layer_grads(jlayer, jparams, jnp.asarray(x),
                                      jnp.asarray(mask), jnp.asarray(w))
    layer = SelfAttentionLayer(n_out=4, n_heads=2)
    params = {k: torch.tensor(np.asarray(a), requires_grad=True)
              for k, a in jparams.items()}
    xt = torch.tensor(x, requires_grad=True)
    calls = []
    real = ck.flash_attention_reference
    monkeypatch.setattr(ck, "flash_attention_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    y, _ = layer.apply(params, {}, xt, mask=torch.tensor(mask))
    (y * torch.tensor(w)).sum().backward()
    assert bool(calls) == (path == "flash")
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=LAYER_TOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx),
                               atol=LAYER_TOL, rtol=0)
    assert set(params) == set(jgp)
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp[k]),
                                   atol=LAYER_TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("d", (160, 192, 256))
@pytest.mark.parametrize("path", ["einsum", "flash"])
def test_self_attention_at_head_dims_past_128_matches_jax(monkeypatch, d,
                                                          path):
    """``SelfAttentionLayer(n_out=2·d, n_heads=2)`` at head dims 160, 192
    and 256, which the JAX layer computes by its einsum off the TPU
    (``deeplearning4j_tpu/nn/layers/attention.py:87-94``) and the port's
    card runs through the kernels at 256: output and the gradients of
    the parameters and the input against the JAX layer's within 1e-5
    (f32) of the larger of 1 and the leaf's largest value (the head dim
    2 test's band, scaled: at 320 features the gradients reach ~2), on
    the einsum and on the flash path's plain versions."""
    if path == "flash":
        monkeypatch.setattr(
            attention, "_use_flash",
            lambda q, k, causal=False: (
                not (causal and q.shape[1] > k.shape[1])
                and q.dtype != torch.float64))
    n = 2 * d
    jlayer = JSelfAttention(n_out=n, n_heads=2)
    jparams, _, _ = jlayer.init(jax.random.PRNGKey(1), (6, n))
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 6, n)).astype(np.float32)
    w = rng.standard_normal((2, 6, n)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 0], [1] * 6], np.float32)
    jy, (jgp, jgx) = _jax_layer_grads(jlayer, jparams, jnp.asarray(x),
                                      jnp.asarray(mask), jnp.asarray(w))
    layer = SelfAttentionLayer(n_out=n, n_heads=2)
    params = {k: torch.tensor(np.asarray(a), requires_grad=True)
              for k, a in jparams.items()}
    xt = torch.tensor(x, requires_grad=True)
    y, _ = layer.apply(params, {}, xt, mask=torch.tensor(mask))
    (y * torch.tensor(w)).sum().backward()
    pairs = [("y", y.detach().numpy(), jy), ("dx", xt.grad.numpy(), jgx)]
    pairs += [(f"d{k}", p.grad.numpy(), jgp[k]) for k, p in params.items()]
    for what, got, want in pairs:
        want = np.asarray(want)
        band = LAYER_TOL * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, atol=band, rtol=0,
                                   err_msg=what)
