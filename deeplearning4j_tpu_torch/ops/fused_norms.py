"""RMSNorm and LayerNorm kernels for Hopper — three in Triton, the two
backwards in CUDA C++ — and their plain versions.

Counterpart of ``deeplearning4j_tpu/ops/fused_norms.py``. Five kernels,
each beside its plain PyTorch version:

- K2, RMSNorm forward (TPU kernel ``_rms_fwd_kernel``; Triton): one
  program per row, the whole row in one block (``BLOCK = next_pow2(F)``,
  masked lanes), f32 math with γ upcast, the output in x's dtype;
- K6, RMSNorm backward (``_rms_bwd_kernel``; CUDA, ``csrc/norm_bwd.cu``):
  rstd recomputed from x (no saved residual),
  dx = (g·γ − x·c·rstd²)·rstd with c = mean(g·γ·x), and dγ summed over
  the rows on chip in a fixed order, so that it is the same to the bit
  from call to call (the TPU kernel's sequential ``+=`` over its grid).
  Plain version :func:`rms_norm_bwd_reference`;
- K7, residual add + RMSNorm forward (``_add_rms_fwd_kernel``; Triton):
  one program per row, s = x + d in f32, s stored in x's dtype, the norm
  taken from the f32 s. Plain version :func:`add_rms_norm_reference`;
- K8, LayerNorm forward (``_ln_fwd_kernel``; Triton): one program per row
  as K2; the mean first, then the variance of the CENTRED row (two
  passes over registers, as the TPU kernel does: E[x²] − E[x]² cancels
  on bf16-sized data), y = (x − μ)/sqrt(var + eps)·γ + β in f32, stored
  in x's dtype. The TPU kernel's padding of F to 128 lanes is the masking
  of the lanes past F. Plain version :func:`layer_norm_reference`;
- K9, LayerNorm backward (``_ln_bwd_kernel``; CUDA, the second
  instantiation of K6's kernel): μ and rstd recomputed from x (only x
  and γ are saved), dx = (g − mean(g) − x̂·mean(g·x̂))·rstd with g = dy·γ,
  and dγ = Σ dy·x̂ and dβ = Σ dy side by side in one [2F] buffer, summed
  as K6's dγ. Plain version :func:`layer_norm_bwd_reference`.

All five are bound by bytes (a few flops per element read): each reads
its rows once and writes them once, the least traffic the function
allows. The CUDA kernel's design (a persistent grid, a warp a row fed by
1-D TMA, dγ and dβ reduced through a thread-block cluster's shared
memory and finished by the last cluster) is set out in
``csrc/norm_bwd.cu``; its wrapper here computes the grid, the row
partition and the scratch. :func:`rms_norm`, :func:`add_rms_norm` and
:func:`layer_norm` are differentiable through :class:`_RmsNormFn`
(forward K2, backward K6), :class:`_AddRmsNormFn` (forward K7, backward
K6 on the stored sum plus the residual stream's own gradient) and
:class:`_LayerNormFn` (forward K8, backward K9). For a CUDA tensor a
wrapper launches its kernel; for a CPU tensor it runs the plain version;
a CUDA input a kernel does not take raises.

The plain forward versions compute in x's own dtype, as the JAX
package's gate-off expressions do, so in bfloat16 they differ from the
kernels by a few bf16 roundings (see the tolerances in
``chip_smoke.py`` and ``tests/test_torch_ops.py``). The plain backwards
compute the kernels' formulas in f32.
"""
from __future__ import annotations

import ctypes
import functools
import math
import types

import torch

from deeplearning4j_tpu_torch.obs import devtime
from deeplearning4j_tpu_torch.ops import cuda_kernels

#: default trailing-axis epsilon (same constant as the JAX package's
#: ``fused_norms.RMSNORM_EPS`` and ``nn.layers.core.RMSNORM_EPS``)
RMSNORM_EPS = 1e-6
#: default LayerNorm epsilon (the JAX package's ``LAYERNORM_EPS``)
LAYERNORM_EPS = 1e-5

_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: widest row one program holds (the whole row sits in registers)
_MAX_F = 16384


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

    return types.SimpleNamespace(
        triton=triton, rms_fwd=rms_fwd, add_rms_fwd=add_rms_fwd,
        ln_fwd=ln_fwd)


def _check(name: str, x, gamma, *rows, beta=None) -> int:
    """Raise on anything the kernels do not take; returns F."""
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


# ---------------------------------------------------------------------------
# K6 and K9: the CUDA kernel of csrc/norm_bwd.cu
# ---------------------------------------------------------------------------
_NORM_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: warps a block of ``csrc/norm_bwd.cu``: on its warp paths a block
#: takes this many rows at once, a warp a row
_NORM_WARPS = 8
#: widest row of the warp paths (at most 32 elements a lane in registers)
_WARP_MAX_F = 1024
#: the kernel's paths (``PATH_*`` in ``csrc/norm_bwd.cu``): a block a
#: row, by elements or by 16-byte chunks; a warp a row, by elements, by
#: 16-byte chunks, or by TMA row copies into a ring
(_PATH_BLOCK, _PATH_BLOCK_VEC, _PATH_WARP, _PATH_WARP_VEC,
 _PATH_WARP_TMA) = range(5)
#: rows a warp (on a full grid) from which the TMA ring takes over from
#: 16-byte register loads, for RMSNorm (False) and LayerNorm (True): a
#: ring prefetches a warp's next rows, so it needs at least 2; measured
#: on the H100 (``tools/torch_norm_bwd_timing.py``), the ring is a few
#: per cent ahead on LayerNorm's rows (three reductions a row) and a few
#: per cent behind on RMSNorm's (one), at every main-path row count
_TMA_ROWS_PER_WARP = {False: math.inf, True: 2}
#: (device, dtype, LayerNorm, path, F) -> (co-resident blocks, cluster
#: size), from the occupancy API once per configuration
_GRID_LIMITS = {}
#: (device, stream) -> the int32 tickets [8] of the kernel's finish, one
#: per cluster rank: 0 between launches (each finishing block resets its
#: own), so one set per stream, whose launches run in order
_TICKETS = {}


def _row_partition(rows: int, grid: int):
    """The rows each block of the kernel takes, as ``[(start, end)]`` in
    block order: block b the contiguous run ``[b·rows // grid,
    (b+1)·rows // grid)`` — the kernel's own formula, a function of
    (rows, grid) alone, so that every sum of dγ and dβ runs in the same
    order from call to call."""
    return [(b * rows // grid, (b + 1) * rows // grid)
            for b in range(grid)]


def _bwd_grid(rows: int, unit: int, max_blocks: int, cluster: int) -> int:
    """Blocks of one launch: enough for ``rows`` at ``unit`` rows a block
    at once, at most the co-resident ``max_blocks``, a whole number of
    clusters."""
    blocks = -(-rows // unit)
    want = -(-blocks // cluster) * cluster
    return max(cluster, min(max_blocks, want))


def _norm_path(f: int, *rows) -> int:
    """The kernel's path for these rows: a warp a row up to
    ``_WARP_MAX_F`` features, a block a row past it; 16-byte accesses
    (on the warp path TMA row copies, which :func:`_norm_bwd_cuda` trades
    for 16-byte register loads by ``_TMA_ROWS_PER_WARP``) when the rows
    are whole 16-byte chunks on 16-byte bases."""
    chunks = (f * rows[0].element_size() % 16 == 0
              and all(r.data_ptr() % 16 == 0 for r in rows))
    if f <= _WARP_MAX_F:
        return _PATH_WARP_TMA if chunks else _PATH_WARP
    return _PATH_BLOCK_VEC if chunks else _PATH_BLOCK


def _grid_limits(lib, x, ln: bool, path: int, f: int):
    key = (x.device.index, x.dtype, ln, path, f)
    hit = _GRID_LIMITS.get(key)
    if hit is None:
        res = (ctypes.c_int * 2)()
        err = lib.dl4j_norm_bwd_grid(_NORM_DTYPES[x.dtype], int(ln), path,
                                     f, ctypes.addressof(res))
        cuda_kernels._raise_on(lib, err, "norm_bwd grid query",
                               "configuration refused")
        hit = _GRID_LIMITS[key] = (res[0], res[1])
    return hit


def _tickets(device, stream: int):
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(8, dtype=torch.int32, device=device)
    return t


def _norm_bwd_cuda(name: str, x, gamma, dy, eps: float, ln: bool):
    """Launch K6 (``ln`` False: dx, dγ) or K9 (dx, dγ, dβ) of
    ``csrc/norm_bwd.cu``; returns dx and the [F] or [2F] buffer of dγ
    (then dβ) in γ's dtype, or None for it when there are no rows (no
    launch)."""
    f = _check(name, x, gamma, dy)
    x2, dy2 = x.reshape(-1, f), dy.reshape(-1, f)
    rows = x2.shape[0]
    dx = torch.empty_like(x2)
    ncol = 2 * f if ln else f
    if not rows:
        return dx.reshape(x.shape), None
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _norm_bwd_cuda(name, x, gamma, dy, eps, ln)
    out = torch.empty((ncol,), dtype=gamma.dtype, device=x.device)
    lib = cuda_kernels._lib("norm_bwd")
    path = _norm_path(f, x2, dy2, dx)
    max_blocks, cluster = _grid_limits(lib, x2, ln, path, f)
    if (path == _PATH_WARP_TMA
            and rows < _TMA_ROWS_PER_WARP[ln] * _NORM_WARPS * max_blocks):
        path = _PATH_WARP_VEC
        max_blocks, cluster = _grid_limits(lib, x2, ln, path, f)
    grid = _bwd_grid(rows, _NORM_WARPS if path >= _PATH_WARP else 1,
                     max_blocks, cluster)
    part = torch.empty((grid // cluster, ncol), dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.dl4j_norm_bwd(
        _NORM_DTYPES[x.dtype], _NORM_DTYPES[gamma.dtype], int(ln), path,
        x2.data_ptr(), dy2.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
        part.data_ptr(), _tickets(x.device, stream).data_ptr(),
        out.data_ptr(), rows, f, float(eps), grid, cluster, stream)
    cuda_kernels._raise_on(lib, err, name, "arguments refused")
    return dx.reshape(x.shape), out


def _rms_bwd_cuda(x, gamma, dy, eps: float):
    dx, dg = _norm_bwd_cuda("rms_norm_bwd", x, gamma, dy, eps, False)
    if dg is None:
        return dx, torch.zeros((x.shape[-1],), dtype=gamma.dtype,
                               device=x.device)
    rms_norm_bwd.launches += 1
    return dx, dg


def _ln_bwd_cuda(x, gamma, dy, eps: float):
    dx, dgb = _norm_bwd_cuda("layer_norm_bwd", x, gamma, dy, eps, True)
    f = x.shape[-1]
    if dgb is None:
        dgb = torch.zeros((2 * f,), dtype=gamma.dtype, device=x.device)
    else:
        layer_norm_bwd.launches += 1
    return dx, dgb[:f], dgb[f:]


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
    CUDA kernel K6 (``csrc/norm_bwd.cu``) for a CUDA tensor,
    :func:`rms_norm_bwd_reference` for a CPU tensor."""
    with devtime.scope("ops.rms_norm_bwd"):
        if x.is_cuda:
            return _rms_bwd_cuda(x, gamma, dy, eps)
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
    the CUDA kernel K9 (``csrc/norm_bwd.cu``) for a CUDA tensor,
    :func:`layer_norm_bwd_reference` for a CPU tensor."""
    with devtime.scope("ops.layer_norm_bwd"):
        if x.is_cuda:
            return _ln_bwd_cuda(x, gamma, dy, eps)
        return layer_norm_bwd_reference(x, gamma, dy, eps)


#: launches of the kernels (the counts the smoke run reads)
rms_norm.launches = 0
rms_norm_bwd.launches = 0
add_rms_norm.launches = 0
layer_norm.launches = 0
layer_norm_bwd.launches = 0
