"""RMSNorm forward: a Triton kernel for Hopper and its plain version.

Counterpart of ``deeplearning4j_tpu/ops/fused_norms.py``. This slice
ports the RMSNorm forward (the TPU kernel ``_rms_fwd_kernel``), which
``zoo.gpt._rms`` runs in every block of prefill, dense decode and the
paged decode step. The backward, the fused residual-add variant and
LayerNorm come with the training slice (``ops/kernel_registry.py``).

:func:`rms_norm` launches the Triton kernel for a CUDA tensor and runs
:func:`rms_norm_reference` for a CPU tensor; a CUDA input the kernel
does not take raises.

The kernel: one program per row, the whole row in one block
(``BLOCK = next_pow2(F)``, masked lanes), f32 math with γ upcast, the
output in x's dtype. It is bound by bytes (~3 flops per element read):
the design reads each row once and writes it once, the least traffic
the function allows. The plain version computes in x's own dtype, as
the JAX package's gate-off expression does, so in bfloat16 the two
differ by a few bf16 roundings (see the tolerances in ``chip_smoke.py``
and ``tests/test_torch_ops.py``).
"""
from __future__ import annotations

import functools

import torch

from deeplearning4j_tpu_torch.obs import devtime

#: default trailing-axis epsilon (same constant as the JAX package's
#: ``fused_norms.RMSNORM_EPS`` and ``nn.layers.core.RMSNORM_EPS``)
RMSNORM_EPS = 1e-6

_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: widest row one program holds (the whole row sits in registers)
_MAX_F = 16384


def rms_norm_reference(x, gamma, eps: float = RMSNORM_EPS):
    """The plain version — port of the JAX ``rms_norm_reference``
    expression, same ops in the same order, in x's dtype."""
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * gamma


@functools.lru_cache(maxsize=1)
def _triton_kernel():
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

    return triton, rms_fwd


def _rms_triton(x, gamma, eps: float):
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"rms_norm kernel takes {_KERNEL_DTYPES}, not "
                         f"{x.dtype}")
    f = x.shape[-1]
    if not gamma.is_cuda or gamma.shape != (f,) \
            or not gamma.is_contiguous():
        raise ValueError(f"rms_norm: gamma must be a contiguous CUDA "
                         f"[{f}] tensor, got {tuple(gamma.shape)} on "
                         f"{gamma.device}")
    if not x.is_contiguous():
        raise ValueError("rms_norm kernel takes a contiguous x")
    if f > _MAX_F:
        raise ValueError(f"rms_norm kernel takes rows up to {_MAX_F} "
                         f"features, got {f}")
    x2 = x.reshape(-1, f)
    out = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows:
        triton, kern = _triton_kernel()
        block = triton.next_power_of_2(f)
        with torch.cuda.device(x.device):
            kern[(rows,)](x2, gamma, out, x2.stride(0), out.stride(0), f,
                          float(eps), BLOCK=block,
                          num_warps=4 if block <= 2048 else 8)
        rms_norm.launches += 1
    return out.reshape(x.shape)


def rms_norm(x, gamma, eps: float = RMSNORM_EPS):
    """RMSNorm over the trailing axis: the Triton kernel for a CUDA
    tensor, :func:`rms_norm_reference` for a CPU tensor."""
    with devtime.scope("ops.rms_norm"):
        if x.is_cuda:
            return _rms_triton(x, gamma, eps)
        return rms_norm_reference(x, gamma, eps)


#: launches of the Triton kernel (the count the smoke run reads)
rms_norm.launches = 0
