"""The LayerNorm kernels K8 (forward) and K9 (backward) through their
plain PyTorch versions, against the JAX package's Pallas kernels run in
interpret mode (``_ln_fwd_call`` and ``_ln_bwd_call`` called directly,
or ``layer_norm`` under ``DL4J_TPU_KERNEL_FORCE``) and against its plain
expression ``layer_norm_reference`` and that expression's ``jax.vjp``.
On the CPU the port's wrappers and ``_LayerNormFn`` run the plain
versions, so the Function's wiring is exercised too; the Triton kernels
themselves are held against the plain versions on the card by
``chip_smoke.py``.

Tolerances:
- float32: 1e-5 absolute for the normed output and dx — the same math
  in another summation order (measured ≤ 1.5e-6); dγ and dβ, sums over
  the rows, 1e-5 relative with a 1e-5 floor (measured ≤ 2.3e-5 absolute
  on sums of ~30 over 1024 rows).
- bfloat16 forward: the JAX kernel computes in f32 and rounds once; the
  plain expression (the port's and JAX's gate-off path) rounds in bf16
  at every op (mean, variance, subtraction, square root, division,
  product, sum). 8 bf16 ulps of the output (one ulp = 2^-8 relative,
  with a 1e-3 floor), as for RMSNorm; measured ≤ 4.0 against the
  kernel. Against JAX's own plain expression, the same ops in bf16:
  2 ulps (measured equal).
- bfloat16 backward: both compute in f32 and round each output once;
  dγ and dβ are summed in another order: 2 ulps (measured ≤ 1.51).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import fused_norms as jax_norms
from deeplearning4j_tpu_torch.ops import fused_norms

F32_TOL = 1e-5
BF16_FWD_ULPS = 8
BF16_BWD_ULPS = 2
# (rows, F): rows not a multiple of 8 (the TPU kernel's sublane), F a
# multiple of 128 and not
SHAPES = [(37, 768), (21, 200), (3, 130)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running
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
    other = np.asarray(other, np.float32)
    return (np.abs(ours - other)
            / (2.0 ** -8 * np.abs(other) + 1e-3)).max()


def _inputs(seed, rows, f):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, f)) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=f)).astype(np.float32)
    b = (0.1 * rng.normal(size=f)).astype(np.float32)
    dy = rng.normal(size=(rows, f)).astype(np.float32)
    return x, g, b, dy


def _jdt(dname):
    return jnp.bfloat16 if dname == "bfloat16" else jnp.float32


# -- K8: forward --------------------------------------------------------------
@pytest.mark.parametrize("rows,f", SHAPES)
def test_ln_fwd_plain_matches_jax_kernel_and_reference_f32(rows, f):
    x, g, b, _ = _inputs(rows + f, rows, f)
    ours = _np(fused_norms.layer_norm(_t(x), _t(g), _t(b)))
    kern = np.asarray(jax_norms._ln_fwd_call(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5))
    ref = np.asarray(jax_norms.layer_norm_reference(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    np.testing.assert_allclose(ours, kern, atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(ours, ref, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("rows,f", SHAPES[:2])
def test_ln_fwd_plain_matches_jax_bf16(rows, f):
    x, g, b, _ = _inputs(rows * f, rows, f)
    bf = lambda a: _t(a, torch.bfloat16)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    ours = fused_norms.layer_norm(bf(x), bf(g), bf(b))
    assert ours.dtype == torch.bfloat16
    ours = _np(ours)
    kern = jax_norms._ln_fwd_call(jb(x), jb(g), jb(b), 1e-5)
    assert _ulps(ours, kern) <= BF16_FWD_ULPS
    # the same expression in bf16 on both sides
    ref = jax_norms.layer_norm_reference(jb(x), jb(g), jb(b))
    assert _ulps(ours, ref) <= BF16_BWD_ULPS


def test_ln_fwd_three_dim_rows_and_population_variance():
    """[B, T, F] normalises each row over F with the population
    variance (``jnp.var``): torch's default, the unbiased one, would
    differ by a factor (F-1)/F under the root."""
    x, g, b, _ = _inputs(3, 12, 40)
    x3 = x.reshape(3, 4, 40)
    ours = _np(fused_norms.layer_norm(_t(x3), _t(g), _t(b)))
    ref = np.asarray(jax_norms.layer_norm_reference(
        jnp.asarray(x3), jnp.asarray(g), jnp.asarray(b)))
    np.testing.assert_allclose(ours, ref, atol=F32_TOL, rtol=0)
    xt = _t(x3)
    biased = (xt - xt.mean(-1, keepdim=True)) / torch.sqrt(
        xt.var(-1, keepdim=True) + 1e-5) * _t(g) + _t(b)
    assert np.abs(_np(biased) - ref).max() > 10 * F32_TOL


# -- K9: backward -------------------------------------------------------------
@pytest.mark.parametrize("rows,f", SHAPES)
def test_ln_bwd_plain_matches_jax_kernel_f32(rows, f):
    x, g, _, dy = _inputs(rows + 2 * f, rows, f)
    dx, dg, db = fused_norms.layer_norm_bwd(_t(x), _t(g), _t(dy))
    jdx, jdg, jdb = jax_norms._ln_bwd_call(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(dy), 1e-5)
    np.testing.assert_allclose(_np(dx), np.asarray(jdx), atol=F32_TOL,
                               rtol=0)
    for o, t in ((dg, jdg), (db, jdb)):
        np.testing.assert_allclose(_np(o), np.asarray(t), atol=F32_TOL,
                                   rtol=F32_TOL)


@pytest.mark.parametrize("rows,f", SHAPES[:2])
def test_ln_bwd_plain_matches_jax_kernel_bf16(rows, f):
    x, g, _, dy = _inputs(rows * 3 + f, rows, f)
    bf = lambda a: _t(a, torch.bfloat16)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    ours = fused_norms.layer_norm_bwd(bf(x), bf(g), bf(dy))
    assert [o.dtype for o in ours] == [torch.bfloat16] * 3
    theirs = jax_norms._ln_bwd_call(jb(x), jb(g), jb(dy), 1e-5)
    for o, t in zip(ours, theirs):
        assert _ulps(_np(o), t) <= BF16_BWD_ULPS


# -- _LayerNormFn against the JAX custom vjp and the expression's vjp ---------
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_layer_norm_fn_grads_match_jax_vjp(dname, monkeypatch):
    x, g, b, dy = _inputs(11, 21, 96)
    x3, dy3 = x.reshape(3, 7, 96), dy.reshape(3, 7, 96)
    dt, jd = getattr(torch, dname), _jdt(dname)
    args = [jnp.asarray(a, jd) for a in (x3, g, b)]
    _, ref_vjp = jax.vjp(jax_norms.layer_norm_reference, *args)
    monkeypatch.setenv("DL4J_TPU_KERNEL_FORCE", "1")   # interpret kernel
    _, kern_vjp = jax.vjp(jax_norms.layer_norm, *args)
    tx, tg, tb = (_t(a, dt).requires_grad_() for a in (x3, g, b))
    y = fused_norms.layer_norm(tx, tg, tb)
    assert "LayerNorm" in y.grad_fn.name()
    ours = torch.autograd.grad(y, (tx, tg, tb), _t(dy3, dt))
    for o, t in zip(ours, kern_vjp(jnp.asarray(dy3, jd))):
        o = _np(o)
        if dname == "float32":
            np.testing.assert_allclose(o, np.asarray(t), atol=10 * F32_TOL,
                                       rtol=F32_TOL)
        else:
            # the JAX vjp runs its kernel in f32 and rounds once, as the
            # port's plain backward does
            assert _ulps(o, t) <= BF16_BWD_ULPS
    if dname == "float32":
        # autodiff of the plain expression: the same gradient in f32 (in
        # bf16 it rounds at every op, up to ~31 ulps away: no yardstick)
        for o, t in zip(ours, ref_vjp(jnp.asarray(dy3, jd))):
            np.testing.assert_allclose(_np(o), np.asarray(t),
                                       atol=10 * F32_TOL, rtol=F32_TOL)


def test_layer_norm_launch_counters_untouched_on_cpu():
    """The counters count kernel launches only: the plain versions on
    the CPU leave them as they were."""
    x, g, b, _ = _inputs(12, 5, 64)
    before = (fused_norms.layer_norm.launches,
              fused_norms.layer_norm_bwd.launches)
    tx = _t(x).requires_grad_()
    fused_norms.layer_norm(tx, _t(g), _t(b)).sum().backward()
    assert tx.grad is not None
    assert (fused_norms.layer_norm.launches,
            fused_norms.layer_norm_bwd.launches) == before
