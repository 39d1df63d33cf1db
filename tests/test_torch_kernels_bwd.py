"""The training slice's kernels — K3 (flash-attention backward), K6
(RMSNorm backward) and K7 (residual add + RMSNorm) — through their plain
PyTorch versions, against the JAX package's Pallas kernels run in
interpret mode (``_flash_bwd``, ``_rms_bwd_call``, ``_add_rms_fwd_call``
called directly, or the differentiable entries under
``DL4J_TPU_KERNEL_FORCE``). On the CPU each port wrapper and each
autograd Function runs its plain version, so the Functions' wiring is
exercised too; the kernels themselves are held against the plain
versions on the card by ``chip_smoke.py``.

Tolerances:
- float32: 2e-5 absolute for attention gradients and 1e-5 for the norms
  — the same math in another summation order.
- bfloat16 attention gradients: the JAX kernel multiplies bf16 tiles
  (p and ds rounded to bf16 before their products, q pre-scaled in
  bf16); the plain version upcasts and computes in f32, rounding each
  output once. The band is 2e-2 of the gradient's largest magnitude
  (a few bf16 roundings, 2^-8 each, summed over up to 200 keys;
  measured at most 7.1e-3 over the cases below).
- bfloat16 K6: both compute in f32 and round once — 2 bf16 ulps (one
  ulp = 2^-8 relative; one for the rounding, one for the summation
  order of dγ). K7's sum s: one bf16 rounding of the same f32 sum on
  both sides — equal. K7's normed output: the plain expression rounds in
  bf16 at every op, the kernel once — 8 ulps, as for K2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import fused_norms as jax_norms
from deeplearning4j_tpu.ops import pallas_kernels as jax_pk
from deeplearning4j_tpu_torch.ops import cuda_kernels, fused_norms

F32_ATTN_TOL = 2e-5
BF16_ATTN_REL = 2e-2
F32_NORM_TOL = 1e-5
BF16_BWD_ULPS = 2
BF16_FWD_ULPS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _ulps(ours, other):
    return (np.abs(ours - other)
            / (2.0 ** -8 * np.abs(other) + 1e-3)).max()


# -- K3: flash-attention backward ----------------------------------------------
BWD_CASES = [
    # (causal, tq, tk, h, h_kv, masked)
    (True, 64, 64, 4, 4, False),
    (True, 200, 200, 4, 2, False),      # GQA groups 2, T not a multiple
    (False, 64, 64, 4, 2, True),        # key mask, GQA
    (False, 130, 130, 4, 4, True),      # key mask, ragged tile
    (False, 40, 200, 4, 2, False),      # Tq != Tk
    (True, 40, 100, 4, 4, False),       # Tq < Tk causal: end-aligned
]


def _bwd_inputs(seed, b, tq, tk, h, h_kv, d, masked):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, tq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, tk, h_kv, d)).astype(np.float32)
    v = rng.normal(size=(b, tk, h_kv, d)).astype(np.float32)
    g = rng.normal(size=(b, tq, h, d)).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.random((b, tk)) > 0.3)
        mask[:, 0] = True
        mask = mask.astype(np.float32)
    return q, k, v, g, mask


def _jax_bwd(q, k, v, out, lse, g, mask, causal, dtype):
    """The JAX kernel ``_flash_bwd`` (interpret mode) on folded
    [B·H, T, D] operands; returns dq, dk, dv in [B, T, H, D]."""
    b, tq, h, d = q.shape
    tk, h_kv = k.shape[1], k.shape[2]
    fold = lambda x: jnp.asarray(x, dtype).transpose(0, 2, 1, 3).reshape(
        b * x.shape[2], x.shape[1], d)
    km = None if mask is None else jnp.repeat(jnp.asarray(mask), h_kv, 0)
    dq, dk, dv = jax_pk._flash_bwd(
        fold(q), fold(k), fold(v), fold(out),
        jnp.asarray(lse).reshape(b * h, tq, 1), fold(g), km,
        jax_pk._static_offs(tk - tq if causal else 0), causal, 64, 64,
        groups=h // h_kv)
    unfold = lambda x, n, heads: np.asarray(x, np.float32).reshape(
        b, heads, n, d).transpose(0, 2, 1, 3)
    return unfold(dq, tq, h), unfold(dk, tk, h_kv), unfold(dv, tk, h_kv)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,tq,tk,h,h_kv,masked", BWD_CASES)
def test_flash_bwd_plain_matches_jax_kernel(causal, tq, tk, h, h_kv,
                                            masked, dname):
    b, d = 2, 32
    dt = getattr(torch, dname)
    q, k, v, g, mask = _bwd_inputs(tq * 7 + tk, b, tq, tk, h, h_kv, d,
                                   masked)
    tq_, tk_, tv_, tg_ = (_t(x, dt) for x in (q, k, v, g))
    tm = None if mask is None else _t(mask)
    out, lse = cuda_kernels.flash_attention(tq_, tk_, tv_, causal=causal,
                                            mask=tm, return_lse=True)
    ours = cuda_kernels.flash_attention_bwd(tq_, tk_, tv_, out, lse, tg_,
                                            causal=causal, mask=tm)
    assert [x.dtype for x in ours] == [dt] * 3
    assert ours[1].shape == (b, tk, h_kv, d)
    # both sides read the same rounded operands, out and lse
    same = lambda x: _np(x)
    theirs = _jax_bwd(same(tq_), same(tk_), same(tv_), same(out),
                      lse.numpy(), same(tg_), mask, causal,
                      jnp.bfloat16 if dname == "bfloat16" else jnp.float32)
    for name, o, t in zip(("dq", "dk", "dv"), ours, theirs):
        o = _np(o)
        if dname == "float32":
            np.testing.assert_allclose(o, t, atol=F32_ATTN_TOL, rtol=0,
                                       err_msg=name)
        else:
            rel = np.abs(o - t).max() / np.abs(t).max()
            assert rel <= BF16_ATTN_REL, (name, rel)


def test_flash_bwd_plain_row_without_live_key_has_zero_grads():
    """A fully key-masked example: lse = -inf is taken as 0 and every p
    is 0, so all three gradients are exactly 0 there, as in the JAX
    kernel."""
    b, t, h, d = 2, 64, 2, 32
    q, k, v, g, _ = _bwd_inputs(5, b, t, t, h, h, d, False)
    mask = np.ones((b, t), np.float32)
    mask[1] = 0.0
    args = [_t(x) for x in (q, k, v)]
    out, lse = cuda_kernels.flash_attention(*args, mask=_t(mask),
                                            return_lse=True)
    assert torch.isinf(lse[1]).all()
    dq, dk, dv = cuda_kernels.flash_attention_bwd(*args, out, lse, _t(g),
                                                  mask=_t(mask))
    for x in (dq, dk, dv):
        assert (x[1] == 0).all()
    theirs = _jax_bwd(q, k, v, _np(out), lse.numpy(), g, mask, False,
                      jnp.float32)
    for o, th in zip((dq, dk, dv), theirs):
        np.testing.assert_allclose(_np(o), th, atol=F32_ATTN_TOL, rtol=0)


@pytest.mark.parametrize("causal,tq,tk,h,h_kv,masked", [
    (True, 96, 96, 4, 2, False), (False, 64, 96, 4, 4, True)])
def test_flash_attention_fn_grads_match_jax_grad(causal, tq, tk, h, h_kv,
                                                 masked, monkeypatch):
    """The port's ``_FlashAttentionFn`` (autograd through
    ``flash_attention`` on CPU tensors: the plain forward with lse, then
    the plain backward) against ``jax.grad`` of the JAX
    ``flash_attention`` (its custom vjp, kernels in interpret mode)."""
    monkeypatch.setenv("DL4J_TPU_KERNEL_FORCE", "1")
    b, d = 2, 32
    q, k, v, w, mask = _bwd_inputs(3 + tq, b, tq, tk, h, h_kv, d, masked)
    jm = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        o = jax_pk.flash_attention(q, k, v, causal=causal, mask=jm,
                                   block_q=64, block_k=64)
        return jnp.sum(o * w)

    theirs = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq_, tk_, tv_ = (_t(x).requires_grad_() for x in (q, k, v))
    o = cuda_kernels.flash_attention(tq_, tk_, tv_, causal=causal,
                                     mask=None if mask is None
                                     else _t(mask))
    assert o.grad_fn is not None and "FlashAttention" in o.grad_fn.name()
    (o * _t(w)).sum().backward()
    for x, th in zip((tq_, tk_, tv_), theirs):
        np.testing.assert_allclose(_np(x.grad), np.asarray(th),
                                   atol=F32_ATTN_TOL, rtol=0)


def test_flash_bwd_counts_no_launch_on_cpu():
    """The launch counter counts kernel launches only: the plain version
    on the CPU leaves it untouched."""
    before = cuda_kernels.flash_attention_bwd.launches
    q, k, v, g, _ = _bwd_inputs(1, 1, 16, 16, 2, 2, 16, False)
    args = [_t(x) for x in (q, k, v)]
    out, lse = cuda_kernels.flash_attention(*args, return_lse=True)
    cuda_kernels.flash_attention_bwd(*args, out, lse, _t(g))
    assert cuda_kernels.flash_attention_bwd.launches == before


# -- K6: RMSNorm backward ----------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 5, 96), (37, 768), (3, 130)])
def test_rms_bwd_plain_matches_jax_kernel_f32(shape):
    rng = np.random.default_rng(4)
    x = rng.normal(size=shape).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    dx, dg = fused_norms.rms_norm_bwd(_t(x), _t(g), _t(dy))
    f = shape[-1]
    jdx, jdg = jax_norms._rms_bwd_call(
        jnp.asarray(x.reshape(-1, f)), jnp.asarray(g),
        jnp.asarray(dy.reshape(-1, f)), 1e-6)
    np.testing.assert_allclose(_np(dx).reshape(-1, f), np.asarray(jdx),
                               atol=F32_NORM_TOL, rtol=0)
    np.testing.assert_allclose(_np(dg), np.asarray(jdg),
                               atol=F32_NORM_TOL * 10, rtol=1e-6)


def test_rms_bwd_plain_matches_jax_kernel_bf16():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(40, 768)).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=768)).astype(np.float32)
    dy = rng.normal(size=(40, 768)).astype(np.float32)
    bf = lambda a: _t(a, torch.bfloat16)
    dx, dg = fused_norms.rms_norm_bwd(bf(x), bf(g), bf(dy))
    assert dx.dtype == dg.dtype == torch.bfloat16
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    jdx, jdg = jax_norms._rms_bwd_call(jb(x), jb(g), jb(dy), 1e-6)
    assert _ulps(_np(dx), np.asarray(jdx, np.float32)) <= BF16_BWD_ULPS
    assert _ulps(_np(dg), np.asarray(jdg, np.float32)) <= BF16_BWD_ULPS


# -- K7: residual add + RMSNorm ------------------------------------------------------
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_add_rms_plain_matches_jax_kernel(dname):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(33, 768)).astype(np.float32)
    d = rng.normal(size=(33, 768)).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=768)).astype(np.float32)
    dt = getattr(torch, dname)
    y, s = fused_norms.add_rms_norm(_t(x, dt), _t(d, dt), _t(g, dt))
    assert y.dtype == s.dtype == dt
    jd = jnp.bfloat16 if dname == "bfloat16" else jnp.float32
    jy, js = jax_norms._add_rms_fwd_call(jnp.asarray(x, jd),
                                         jnp.asarray(d, jd),
                                         jnp.asarray(g, jd), 1e-6)
    jy, js = np.asarray(jy, np.float32), np.asarray(js, np.float32)
    if dname == "float32":
        np.testing.assert_allclose(_np(y), jy, atol=F32_NORM_TOL, rtol=0)
        np.testing.assert_allclose(_np(s), js, atol=0, rtol=0)
    else:
        np.testing.assert_array_equal(_np(s), js)
        assert _ulps(_np(y), jy) <= BF16_FWD_ULPS


# -- the autograd Functions against the JAX custom vjps ------------------------------
def _norm_inputs(seed, shape=(3, 7, 96)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    d = rng.normal(size=shape).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    ds = rng.normal(size=shape).astype(np.float32)
    return x, d, g, dy, ds


def _check(ours, theirs, dname):
    for o, t in zip(ours, theirs):
        o, t = _np(o), np.asarray(t, np.float32)
        if dname == "float32":
            np.testing.assert_allclose(o, t, atol=F32_NORM_TOL * 10,
                                       rtol=1e-5)
        else:
            # the JAX vjp runs its kernel in f32 and rounds once; so does
            # the port's plain backward — with dγ summed over 21 rows
            assert _ulps(o, t) <= BF16_BWD_ULPS


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_rms_norm_fn_grads_match_jax_vjp(dname, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_KERNEL_FORCE", "1")
    x, _, g, dy, _ = _norm_inputs(7)
    dt = getattr(torch, dname)
    jd = jnp.bfloat16 if dname == "bfloat16" else jnp.float32
    _, vjp = jax.vjp(lambda x, g: jax_norms.rms_norm(x, g),
                     jnp.asarray(x, jd), jnp.asarray(g, jd))
    theirs = vjp(jnp.asarray(dy, jd))
    tx, tg = _t(x, dt).requires_grad_(), _t(g, dt).requires_grad_()
    y = fused_norms.rms_norm(tx, tg)
    assert "RmsNorm" in y.grad_fn.name()
    ours = torch.autograd.grad(y, (tx, tg), _t(dy, dt))
    _check(ours, theirs, dname)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_add_rms_norm_fn_grads_match_jax_vjp(dname, monkeypatch):
    """Both cotangents — of the normed output and of the residual sum s
    — flow into both addends, through K6 on the STORED s."""
    monkeypatch.setenv("DL4J_TPU_KERNEL_FORCE", "1")
    x, d, g, dy, ds = _norm_inputs(8)
    dt = getattr(torch, dname)
    jd = jnp.bfloat16 if dname == "bfloat16" else jnp.float32
    _, vjp = jax.vjp(lambda x, d, g: jax_norms.add_rms_norm(x, d, g),
                     *(jnp.asarray(a, jd) for a in (x, d, g)))
    theirs = vjp((jnp.asarray(dy, jd), jnp.asarray(ds, jd)))
    tx, td, tg = (_t(a, dt).requires_grad_() for a in (x, d, g))
    y, s = fused_norms.add_rms_norm(tx, td, tg)
    assert "AddRmsNorm" in y.grad_fn.name()
    ours = torch.autograd.grad((y, s), (tx, td, tg),
                               (_t(dy, dt), _t(ds, dt)))
    _check(ours, theirs, dname)
    # dx and dδ are the same total
    assert torch.equal(ours[0], ours[1])


def test_norm_launch_counters_untouched_on_cpu():
    x, d, g, dy, _ = _norm_inputs(9)
    before = (fused_norms.rms_norm.launches,
              fused_norms.rms_norm_bwd.launches,
              fused_norms.add_rms_norm.launches)
    tx = _t(x).requires_grad_()
    y = fused_norms.rms_norm(tx, _t(g))
    y2, _ = fused_norms.add_rms_norm(y, _t(d), _t(g))
    y2.sum().backward()
    assert tx.grad is not None
    assert (fused_norms.rms_norm.launches,
            fused_norms.rms_norm_bwd.launches,
            fused_norms.add_rms_norm.launches) == before
