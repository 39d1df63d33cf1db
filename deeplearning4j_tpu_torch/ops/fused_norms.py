"""RMSNorm and LayerNorm kernels for Hopper in Triton, and their plain
versions.

Counterpart of ``deeplearning4j_tpu/ops/fused_norms.py``. Five Triton
kernels, each beside its plain PyTorch version:

- K2, RMSNorm forward (TPU kernel ``_rms_fwd_kernel``): one program per
  row, the whole row in one block (``BLOCK = next_pow2(F)``, masked
  lanes), f32 math with γ upcast, the output in x's dtype;
- K6, RMSNorm backward (``_rms_bwd_kernel``): programs over row blocks;
  each recomputes rstd from x (no saved residual), writes
  dx = (g·γ − x·c·rstd²)·rstd with c = mean(g·γ·x), and an f32 partial
  dγ over its rows; a second launch sums the partials in a fixed order,
  so dγ is deterministic (the TPU kernel's sequential ``+=`` over its
  grid). Plain version :func:`rms_norm_bwd_reference`;
- K7, residual add + RMSNorm forward (``_add_rms_fwd_kernel``): one
  program per row, s = x + d in f32, s stored in x's dtype, the norm
  taken from the f32 s. Plain version :func:`add_rms_norm_reference`;
- K8, LayerNorm forward (``_ln_fwd_kernel``): one program per row as
  K2; the mean first, then the variance of the CENTRED row (two passes
  over registers, as the TPU kernel does: E[x²] − E[x]² cancels on
  bf16-sized data), y = (x − μ)/sqrt(var + eps)·γ + β in f32, stored in
  x's dtype. The TPU kernel's padding of F to 128 lanes is the masking
  of the lanes past F. Plain version :func:`layer_norm_reference`;
- K9, LayerNorm backward (``_ln_bwd_kernel``): programs over runs of
  whole rows, as K6; each recomputes μ and rstd from x (only x and γ
  are saved), writes dx = (g − mean(g) − x̂·mean(g·x̂))·rstd with
  g = dy·γ, and f32 partials of dγ = Σ dy·x̂ and dβ = Σ dy side by side
  in one [programs, 2F] buffer; K6's reduce launch sums them in a fixed
  order. Plain version :func:`layer_norm_bwd_reference`.

All five are bound by bytes (a few flops per element read): each reads
its rows once and writes them once, the least traffic the function
allows. :func:`rms_norm`, :func:`add_rms_norm` and :func:`layer_norm` are
differentiable through :class:`_RmsNormFn` (forward K2, backward K6),
:class:`_AddRmsNormFn` (forward K7, backward K6 on the stored sum plus
the residual stream's own gradient) and :class:`_LayerNormFn` (forward
K8, backward K9). For a CUDA tensor a wrapper launches its kernel; for a
CPU tensor it runs the plain version; a CUDA input a kernel does not
take raises.

The plain forward versions compute in x's own dtype, as the JAX
package's gate-off expressions do, so in bfloat16 they differ from the
kernels by a few bf16 roundings (see the tolerances in
``chip_smoke.py`` and ``tests/test_torch_ops.py``). The plain backwards
compute the kernels' formulas in f32.
"""
from __future__ import annotations

import functools
import types

import torch

from deeplearning4j_tpu_torch.obs import devtime

#: default trailing-axis epsilon (same constant as the JAX package's
#: ``fused_norms.RMSNORM_EPS`` and ``nn.layers.core.RMSNORM_EPS``)
RMSNORM_EPS = 1e-6
#: default LayerNorm epsilon (the JAX package's ``LAYERNORM_EPS``)
LAYERNORM_EPS = 1e-5

_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: widest row one program holds (the whole row sits in registers)
_MAX_F = 16384
#: K6's programs: at most this many, each over a run of whole rows
_BWD_PROGRAMS = 1024


def rms_norm_reference(x, gamma, eps: float = RMSNORM_EPS):
    """The plain version — port of the JAX ``rms_norm_reference``
    expression, same ops in the same order, in x's dtype."""
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * gamma


def rms_norm_bwd_reference(x, gamma, dy, eps: float = RMSNORM_EPS):
    """Plain version of K6: (dx, dγ) of RMSNorm over the trailing axis,
    the TPU kernel's formula in f32 with rstd recomputed from x; dx in
    x's dtype, dγ (summed over all rows) in γ's."""
    f = x.shape[-1]
    xf, df, gf = x.float(), dy.float(), gamma.float()
    rstd = torch.rsqrt((xf * xf).sum(-1, keepdim=True) / f + eps)
    gg = df * gf
    c = (gg * xf).sum(-1, keepdim=True) / f
    dx = (gg - xf * (c * rstd * rstd)) * rstd
    dg = (df * xf * rstd).reshape(-1, f).sum(0)
    return dx.to(x.dtype), dg.to(gamma.dtype)


def add_rms_norm_reference(x, delta, gamma, eps: float = RMSNORM_EPS):
    """Plain version of K7: the unfused residual-then-norm pair, as the
    JAX package's gate-off path writes it (``s = x + delta``, then the
    :func:`rms_norm_reference` expression); returns ``(normed, s)``."""
    s = x + delta
    return rms_norm_reference(s, gamma, eps), s


def layer_norm_reference(x, gamma, beta, eps: float = LAYERNORM_EPS):
    """The plain version of K8 — port of the JAX ``layer_norm_reference``
    expression, same ops in the same order, in x's dtype (``jnp.var`` is
    the population variance: ``unbiased=False``)."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) / torch.sqrt(var + eps)
    return y * gamma + beta


def layer_norm_bwd_reference(x, gamma, dy, eps: float = LAYERNORM_EPS):
    """Plain version of K9: (dx, dγ, dβ) of LayerNorm over the trailing
    axis, the TPU kernel's formula in f32 with μ and rstd recomputed from
    x; dx in x's dtype, dγ and dβ (summed over all rows) in γ's."""
    f = x.shape[-1]
    xf, df, gf = x.float(), dy.float(), gamma.float()
    xc = xf - xf.sum(-1, keepdim=True) / f
    rstd = torch.rsqrt((xc * xc).sum(-1, keepdim=True) / f + eps)
    xhat = xc * rstd
    gh = df * gf
    m1 = gh.sum(-1, keepdim=True) / f
    m2 = (gh * xhat).sum(-1, keepdim=True) / f
    dx = (gh - m1 - xhat * m2) * rstd
    dg = (df * xhat).reshape(-1, f).sum(0)
    db = df.reshape(-1, f).sum(0)
    return dx.to(x.dtype), dg.to(gamma.dtype), db.to(gamma.dtype)


@functools.lru_cache(maxsize=1)
def _triton_kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def rms_fwd(x_ptr, g_ptr, o_ptr, stride_x, stride_o, F, eps,
                BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        live = cols < F
        x = tl.load(x_ptr + row * stride_x + cols, mask=live,
                    other=0.0).to(tl.float32)
        ms = tl.sum(x * x, axis=0) / F
        rstd = tl.rsqrt(ms + eps)
        g = tl.load(g_ptr + cols, mask=live, other=0.0).to(tl.float32)
        y = x * rstd * g
        tl.store(o_ptr + row * stride_o + cols,
                 y.to(o_ptr.dtype.element_ty), mask=live)

    @triton.jit
    def rms_bwd(x_ptr, g_ptr, dy_ptr, dx_ptr, part_ptr, R, F, rows_per,
                eps, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        live = cols < F
        g = tl.load(g_ptr + cols, mask=live, other=0.0).to(tl.float32)
        dg = tl.zeros((BLOCK,), tl.float32)
        r0 = pid * rows_per
        r1 = tl.minimum(r0 + rows_per, R)
        for r in range(r0, r1):
            off = r.to(tl.int64) * F + cols
            x = tl.load(x_ptr + off, mask=live, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + off, mask=live,
                         other=0.0).to(tl.float32)
            rstd = tl.rsqrt(tl.sum(x * x, axis=0) / F + eps)
            gg = dy * g
            c = tl.sum(gg * x, axis=0) / F
            dx = (gg - x * (c * rstd * rstd)) * rstd
            tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty),
                     mask=live)
            dg += dy * x * rstd
        tl.store(part_ptr + pid.to(tl.int64) * F + cols, dg, mask=live)

    @triton.jit
    def rms_bwd_reduce(part_ptr, dg_ptr, n_part, F,
                       BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        # the partials' columns summed in a fixed order (dγ of K6; dγ
        # and dβ side by side for K9): a tree within each BLOCK_P-row
        # chunk, chunks in sequence
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        live = cols < F
        acc = tl.zeros((BLOCK_C,), tl.float32)
        for p0 in range(0, n_part, BLOCK_P):
            rows = p0 + tl.arange(0, BLOCK_P)
            m = (rows[:, None] < n_part) & live[None, :]
            blk = tl.load(part_ptr + rows[:, None].to(tl.int64) * F
                          + cols[None, :], mask=m, other=0.0)
            acc += tl.sum(blk, axis=0)
        tl.store(dg_ptr + cols, acc.to(dg_ptr.dtype.element_ty),
                 mask=live)

    @triton.jit
    def add_rms_fwd(x_ptr, d_ptr, g_ptr, y_ptr, s_ptr, F, eps,
                    BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        live = cols < F
        off = row * F + cols
        s = (tl.load(x_ptr + off, mask=live, other=0.0).to(tl.float32)
             + tl.load(d_ptr + off, mask=live, other=0.0).to(tl.float32))
        tl.store(s_ptr + off, s.to(s_ptr.dtype.element_ty), mask=live)
        # the norm of the f32 sum, not of the stored (rounded) one
        rstd = tl.rsqrt(tl.sum(s * s, axis=0) / F + eps)
        g = tl.load(g_ptr + cols, mask=live, other=0.0).to(tl.float32)
        tl.store(y_ptr + off, (s * rstd * g).to(y_ptr.dtype.element_ty),
                 mask=live)

    @triton.jit
    def ln_fwd(x_ptr, g_ptr, b_ptr, y_ptr, F, eps, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        live = cols < F
        off = row * F + cols
        x = tl.load(x_ptr + off, mask=live, other=0.0).to(tl.float32)
        # two passes over registers: the mean, then the variance of the
        # centred row (the lanes past F held at 0 in both)
        mu = tl.sum(x, axis=0) / F
        xc = tl.where(live, x - mu, 0.0)
        var = tl.sum(xc * xc, axis=0) / F
        g = tl.load(g_ptr + cols, mask=live, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + cols, mask=live, other=0.0).to(tl.float32)
        y = xc / tl.sqrt(var + eps) * g + b
        tl.store(y_ptr + off, y.to(y_ptr.dtype.element_ty), mask=live)

    @triton.jit
    def ln_bwd(x_ptr, g_ptr, dy_ptr, dx_ptr, part_ptr, R, F, rows_per, eps,
               BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        live = cols < F
        g = tl.load(g_ptr + cols, mask=live, other=0.0).to(tl.float32)
        dg = tl.zeros((BLOCK,), tl.float32)
        db = tl.zeros((BLOCK,), tl.float32)
        r0 = pid * rows_per
        r1 = tl.minimum(r0 + rows_per, R)
        for r in range(r0, r1):
            off = r.to(tl.int64) * F + cols
            x = tl.load(x_ptr + off, mask=live, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + off, mask=live,
                         other=0.0).to(tl.float32)
            xc = tl.where(live, x - tl.sum(x, axis=0) / F, 0.0)
            rstd = tl.rsqrt(tl.sum(xc * xc, axis=0) / F + eps)
            xhat = xc * rstd
            gh = dy * g                       # 0 past F (dy loads 0)
            m1 = tl.sum(gh, axis=0) / F
            m2 = tl.sum(gh * xhat, axis=0) / F
            dx = (gh - m1 - xhat * m2) * rstd
            tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty),
                     mask=live)
            dg += dy * xhat
            db += dy
        # this program's partials: dγ in [0, F), dβ in [F, 2F) of its row
        base = part_ptr + pid.to(tl.int64) * 2 * F
        tl.store(base + cols, dg, mask=live)
        tl.store(base + F + cols, db, mask=live)

    return types.SimpleNamespace(
        triton=triton, rms_fwd=rms_fwd, rms_bwd=rms_bwd,
        bwd_reduce=rms_bwd_reduce, add_rms_fwd=add_rms_fwd, ln_fwd=ln_fwd,
        ln_bwd=ln_bwd)


def _check(name: str, x, gamma, *rows, beta=None) -> int:
    """Raise on anything the Triton kernels do not take; returns F."""
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name} kernel takes {_KERNEL_DTYPES}, not "
                         f"{x.dtype}")
    f = x.shape[-1]
    for pname, p in (("gamma", gamma), ("beta", beta)):
        if p is not None and (not p.is_cuda or p.shape != (f,)
                              or not p.is_contiguous()):
            raise ValueError(f"{name}: {pname} must be a contiguous CUDA "
                             f"[{f}] tensor, got {tuple(p.shape)} on "
                             f"{p.device}")
    for r in (x,) + rows:
        if not r.is_cuda or r.shape != x.shape or r.dtype != x.dtype \
                or not r.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous CUDA rows "
                             f"of one shape and dtype ({tuple(x.shape)} "
                             f"{x.dtype}), got {tuple(r.shape)} "
                             f"{r.dtype} on {r.device}")
    if f > _MAX_F:
        raise ValueError(f"{name} kernel takes rows up to {_MAX_F} "
                         f"features, got {f}")
    return f


def _warps(block: int) -> int:
    return 4 if block <= 2048 else 8


def _row_runs(triton, rows: int):
    """(rows per program, programs) of a backward kernel: at most
    ``_BWD_PROGRAMS`` programs, each over a run of whole rows."""
    rows_per = triton.cdiv(rows, min(rows, _BWD_PROGRAMS))
    return rows_per, triton.cdiv(rows, rows_per)


def _reduce_partials(k, part, out) -> None:
    """``out`` = the column sums of the f32 partials ``part`` [programs,
    C], in a fixed order, cast to ``out``'s dtype (one launch)."""
    n_prog, c = part.shape
    k.bwd_reduce[(k.triton.cdiv(c, 32),)](part, out, n_prog, c,
                                          BLOCK_P=64, BLOCK_C=32,
                                          num_warps=4)


def _rms_triton(x, gamma, eps: float):
    f = _check("rms_norm", x, gamma)
    x2 = x.reshape(-1, f)
    out = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows:
        k = _triton_kernels()
        block = k.triton.next_power_of_2(f)
        with torch.cuda.device(x.device):
            k.rms_fwd[(rows,)](x2, gamma, out, x2.stride(0),
                               out.stride(0), f, float(eps), BLOCK=block,
                               num_warps=_warps(block))
        rms_norm.launches += 1
    return out.reshape(x.shape)


def _rms_bwd_triton(x, gamma, dy, eps: float):
    f = _check("rms_norm_bwd", x, gamma, dy)
    x2, dy2 = x.reshape(-1, f), dy.reshape(-1, f)
    rows = x2.shape[0]
    dx = torch.empty_like(x2)
    dg = torch.empty((f,), dtype=gamma.dtype, device=x.device)
    if not rows:
        return dx.reshape(x.shape), dg.zero_()
    k = _triton_kernels()
    rows_per, n_prog = _row_runs(k.triton, rows)
    part = torch.empty((n_prog, f), dtype=torch.float32, device=x.device)
    block = k.triton.next_power_of_2(f)
    with torch.cuda.device(x.device):
        k.rms_bwd[(n_prog,)](x2, gamma, dy2, dx, part, rows, f, rows_per,
                             float(eps), BLOCK=block,
                             num_warps=_warps(block))
        _reduce_partials(k, part, dg)
    rms_norm_bwd.launches += 1
    return dx.reshape(x.shape), dg


def _add_rms_triton(x, delta, gamma, eps: float):
    f = _check("add_rms_norm", x, gamma, delta)
    x2, d2 = x.reshape(-1, f), delta.reshape(-1, f)
    y = torch.empty_like(x2)
    s = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows:
        k = _triton_kernels()
        block = k.triton.next_power_of_2(f)
        with torch.cuda.device(x.device):
            k.add_rms_fwd[(rows,)](x2, d2, gamma, y, s, f, float(eps),
                                   BLOCK=block, num_warps=_warps(block))
        add_rms_norm.launches += 1
    return y.reshape(x.shape), s.reshape(x.shape)


def _ln_triton(x, gamma, beta, eps: float):
    f = _check("layer_norm", x, gamma, beta=beta)
    x2 = x.reshape(-1, f)
    y = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows:
        k = _triton_kernels()
        block = k.triton.next_power_of_2(f)
        with torch.cuda.device(x.device):
            k.ln_fwd[(rows,)](x2, gamma, beta, y, f, float(eps),
                              BLOCK=block, num_warps=_warps(block))
        layer_norm.launches += 1
    return y.reshape(x.shape)


def _ln_bwd_triton(x, gamma, dy, eps: float):
    f = _check("layer_norm_bwd", x, gamma, dy)
    x2, dy2 = x.reshape(-1, f), dy.reshape(-1, f)
    rows = x2.shape[0]
    dx = torch.empty_like(x2)
    dgb = torch.empty((2 * f,), dtype=gamma.dtype, device=x.device)
    if not rows:
        dgb.zero_()
        return dx.reshape(x.shape), dgb[:f], dgb[f:]
    k = _triton_kernels()
    rows_per, n_prog = _row_runs(k.triton, rows)
    part = torch.empty((n_prog, 2 * f), dtype=torch.float32,
                       device=x.device)
    block = k.triton.next_power_of_2(f)
    with torch.cuda.device(x.device):
        k.ln_bwd[(n_prog,)](x2, gamma, dy2, dx, part, rows, f, rows_per,
                            float(eps), BLOCK=block,
                            num_warps=_warps(block))
        _reduce_partials(k, part, dgb)
    layer_norm_bwd.launches += 1
    return dx.reshape(x.shape), dgb[:f], dgb[f:]


def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in xs)


class _RmsNormFn(torch.autograd.Function):
    """RMSNorm with its backward kernel: forward K2, backward K6 (the
    port of the JAX ``_rms`` custom vjp); x and γ are saved, rstd is
    recomputed."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        if x.is_cuda:
            return _rms_triton(x, gamma, eps)
        return rms_norm_reference(x, gamma, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dg = rms_norm_bwd(x, gamma, dy.contiguous(), ctx.eps)
        return dx, dg, None


class _AddRmsNormFn(torch.autograd.Function):
    """Residual add + RMSNorm (the port of the JAX ``_add_rms`` custom
    vjp): forward K7 returns ``(normed, s)``; the backward runs K6 on
    the STORED s and adds the residual stream's own cotangent; the total
    flows to both addends."""

    @staticmethod
    def forward(ctx, x, delta, gamma, eps):
        if x.is_cuda:
            y, s = _add_rms_triton(x, delta, gamma, eps)
        else:
            y, s = add_rms_norm_reference(x, delta, gamma, eps)
        ctx.save_for_backward(s, gamma)
        ctx.eps = eps
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        s, gamma = ctx.saved_tensors
        dxs, dg = rms_norm_bwd(s, gamma, dy.contiguous(), ctx.eps)
        dtot = dxs + ds.to(dxs.dtype)
        return dtot, dtot, dg, None


class _LayerNormFn(torch.autograd.Function):
    """LayerNorm with its backward kernel: forward K8, backward K9 (the
    port of the JAX ``_ln`` custom vjp); x and γ are saved, μ and rstd
    are recomputed. Returns the gradients of x, γ and β."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        if x.is_cuda:
            return _ln_triton(x, gamma, beta, eps)
        return layer_norm_reference(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dg, db = layer_norm_bwd(x, gamma, dy.contiguous(), ctx.eps)
        return dx, dg, db, None


def rms_norm(x, gamma, eps: float = RMSNORM_EPS):
    """RMSNorm over the trailing axis: the Triton kernel K2 for a CUDA
    tensor, :func:`rms_norm_reference` for a CPU tensor. Differentiable
    (backward: :func:`rms_norm_bwd`)."""
    with devtime.scope("ops.rms_norm"):
        if _wants_grad(x, gamma):
            return _RmsNormFn.apply(x, gamma, eps)
        if x.is_cuda:
            return _rms_triton(x, gamma, eps)
        return rms_norm_reference(x, gamma, eps)


def rms_norm_bwd(x, gamma, dy, eps: float = RMSNORM_EPS):
    """(dx, dγ) of :func:`rms_norm` for the output gradient ``dy``: the
    Triton kernel K6 for a CUDA tensor, :func:`rms_norm_bwd_reference`
    for a CPU tensor."""
    with devtime.scope("ops.rms_norm_bwd"):
        if x.is_cuda:
            return _rms_bwd_triton(x, gamma, dy, eps)
        return rms_norm_bwd_reference(x, gamma, dy, eps)


def add_rms_norm(x, delta, gamma, eps: float = RMSNORM_EPS):
    """Residual add + RMSNorm in one pass: returns ``(normed, s)`` with
    ``s = x + delta`` (the block's next residual). The Triton kernel K7
    for a CUDA tensor, :func:`add_rms_norm_reference` for a CPU tensor.
    Differentiable (backward: K6 on s)."""
    with devtime.scope("ops.add_rms_norm"):
        if _wants_grad(x, delta, gamma):
            return _AddRmsNormFn.apply(x, delta, gamma, eps)
        if x.is_cuda:
            return _add_rms_triton(x, delta, gamma, eps)
        return add_rms_norm_reference(x, delta, gamma, eps)


def layer_norm(x, gamma, beta, eps: float = LAYERNORM_EPS):
    """LayerNorm over the trailing axis: the Triton kernel K8 for a CUDA
    tensor, :func:`layer_norm_reference` for a CPU tensor.
    Differentiable (backward: :func:`layer_norm_bwd`)."""
    with devtime.scope("ops.layer_norm"):
        if _wants_grad(x, gamma, beta):
            return _LayerNormFn.apply(x, gamma, beta, eps)
        if x.is_cuda:
            return _ln_triton(x, gamma, beta, eps)
        return layer_norm_reference(x, gamma, beta, eps)


def layer_norm_bwd(x, gamma, dy, eps: float = LAYERNORM_EPS):
    """(dx, dγ, dβ) of :func:`layer_norm` for the output gradient ``dy``:
    the Triton kernel K9 for a CUDA tensor,
    :func:`layer_norm_bwd_reference` for a CPU tensor."""
    with devtime.scope("ops.layer_norm_bwd"):
        if x.is_cuda:
            return _ln_bwd_triton(x, gamma, dy, eps)
        return layer_norm_bwd_reference(x, gamma, dy, eps)


#: launches of the Triton kernels (the counts the smoke run reads)
rms_norm.launches = 0
rms_norm_bwd.launches = 0
add_rms_norm.launches = 0
layer_norm.launches = 0
layer_norm_bwd.launches = 0
