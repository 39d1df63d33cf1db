"""The bf16 rounding band of the tensor-core K1 (flash forward), K4
(flash dq), K5 (flash dk/dv) and K3 (fused flash backward), on the CPU.

On the card, K1 and K4 take bf16 operands straight into ``mma.sync`` and
round the probabilities P (K1, before P·V) and dS (K4, before dS·K) to
bf16, as the TPU kernels do (``pallas_kernels.py:175-177``,
``:442-443``); their plain versions, which ``chip_smoke.py`` holds them
against, compute in f32 from the same bf16 inputs and round each output
once. The JAX kernels run here in interpret mode round where the CUDA
kernels round (and more: they also fold the softmax scale into the bf16
q tile), so their distance from the plain versions bounds the rounding
the redesign adds. These tests hold that distance, at T = 512, causal,
with grouped-query heads (4 query heads on 2 kv heads) at head dim 128
and 64-row by 64-key tiles, within the card's unchanged bf16 tolerances:

- K1: 2e-2 absolute on the output (``chip_smoke.py`` ``FLASH_TOL``);
  measured 7.8e-3, 1.56e-2 and 7.8e-3 over the three seeds: one bf16
  ulp of an output near 2, where the two f32 results straddle a rounding
  boundary and the two roundings land one ulp apart.
- K4: 1e-2 of the largest |dq| (``chip_smoke.py`` ``K3_TOL``); measured
  3.8e-3, 4.3e-3 and 3.5e-3.

K5 (the dk/dv pass) and K3 (the fused backward) share the key-stationary
tensor-core loop of ``csrc/flash_mma.cuh``: P rounded to bf16 before
Pᵀ·dO, dS before dSᵀ·Q and (K3) dS·K, as the TPU kernels round them
(``pallas_kernels.py:477-479``, ``:532-537``). Their JAX kernels also
round each query head's dk/dv to bf16 before summing the group
(``_reduce_kv_rows``), where the CUDA kernels sum in f32 and round once.
Both bands are held at 1e-2 of each gradient's largest magnitude
(``K3_TOL``):

- K5: the JAX split kernels against the split plain versions; measured
  dq 3.8e-3, 4.3e-3, 3.6e-3; dk 4.8e-3, 6.1e-3, 5.1e-3; dv 5.1e-3,
  5.5e-3, 5.8e-3 over the three seeds.
- K3: the JAX fused kernel against the fused plain version; measured
  the same values (the fused and split JAX kernels round alike).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_kernels as jax_pk
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from test_torch_flash_split import _jax_split_bwd

T, B, H, H_KV, D = 512, 1, 4, 2, 128
K1_TOL = 2e-2
K4_TOL = 1e-2
K3_TOL = 1e-2      # K3 and K5: each of dq, dk, dv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, so that test workers running side by side do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_inputs(seed):
    """q, k, v, dO rounded to bf16: numpy f32 arrays holding bf16 values,
    and the same as bf16 tensors."""
    rng = np.random.default_rng(seed)
    shapes = ((B, T, H, D), (B, T, H_KV, D), (B, T, H_KV, D), (B, T, H, D))
    ts = [torch.tensor(rng.normal(size=s).astype(np.float32)).bfloat16()
          for s in shapes]
    return [t.float().numpy() for t in ts], ts


SEEDS = (0, 1, 2)


@pytest.mark.parametrize("seed", SEEDS)
def test_k1_bf16_band_covers_the_probability_rounding(seed):
    (q, k, v, _), (tq, tk, tv, _) = _bf16_inputs(seed)
    plain = ck.flash_attention_reference(tq, tk, tv, causal=True)
    assert plain.dtype == torch.bfloat16
    kern = np.asarray(jax_pk.flash_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=True,
        block_q=64, block_k=64), np.float32)
    err = np.abs(plain.float().numpy() - kern).max()
    assert 0 < err <= K1_TOL, err


@pytest.mark.parametrize("seed", SEEDS)
def test_k4_bf16_band_covers_the_ds_rounding(seed):
    (q, k, v, g), (tq, tk, tv, tg) = _bf16_inputs(seed)
    out, lse = ck.flash_attention_reference(tq, tk, tv, causal=True,
                                            return_lse=True)
    plain = ck.flash_attention_bwd_dq_reference(tq, tk, tv, out, lse, tg,
                                                causal=True).float().numpy()
    kern, _, _ = _jax_split_bwd(q, k, v, out.float().numpy(), lse.numpy(),
                                g, None, True, (0, 0), jnp.bfloat16)
    rel = np.abs(plain - kern).max() / np.abs(plain).max()
    assert 0 < rel <= K4_TOL, rel


def _rel_errs(plain, kern):
    """Each gradient's max |plain − kernel| over its max |plain|."""
    return [np.abs(p.float().numpy() - k).max()
            / np.abs(p.float().numpy()).max() for p, k in zip(plain, kern)]


@pytest.mark.parametrize("seed", SEEDS)
def test_k5_bf16_band_covers_the_p_and_ds_rounding(seed):
    (q, k, v, g), (tq, tk, tv, tg) = _bf16_inputs(seed)
    out, lse = ck.flash_attention_reference(tq, tk, tv, causal=True,
                                            return_lse=True)
    args = (tq, tk, tv, out, lse, tg)
    plain = (ck.flash_attention_bwd_dq_reference(*args, causal=True),
             *ck.flash_attention_bwd_dkv_reference(*args, causal=True))
    kern = _jax_split_bwd(q, k, v, out.float().numpy(), lse.numpy(), g,
                          None, True, (0, 0), jnp.bfloat16)
    rels = _rel_errs(plain, kern)
    assert all(0 < r <= K3_TOL for r in rels), rels


def _jax_fused_bwd(q, k, v, out, lse, g):
    """The JAX ``_flash_bwd`` on its fused kernel (interpret mode, blocks
    of 64, causal) on folded [B·H, T, D] bf16 operands; dq, dk, dv in
    [B, T, H, D]."""
    fold = lambda x: jnp.asarray(x, jnp.bfloat16).transpose(
        0, 2, 1, 3).reshape(B * x.shape[2], T, D)
    assert T * 128 * 4 <= jax_pk._FUSED_BWD_DQ_VMEM     # the fused path
    dq, dk, dv = jax_pk._flash_bwd(
        fold(q), fold(k), fold(v), fold(out),
        jnp.asarray(lse).reshape(B * H, T, 1), fold(g), None,
        jnp.zeros((2,), jnp.int32), True, 64, 64, groups=H // H_KV)
    unfold = lambda x, heads: np.asarray(x, np.float32).reshape(
        B, heads, T, D).transpose(0, 2, 1, 3)
    return unfold(dq, H), unfold(dk, H_KV), unfold(dv, H_KV)


@pytest.mark.parametrize("seed", SEEDS)
def test_k3_bf16_band_covers_the_p_and_ds_rounding(seed):
    (q, k, v, g), (tq, tk, tv, tg) = _bf16_inputs(seed)
    out, lse = ck.flash_attention_reference(tq, tk, tv, causal=True,
                                            return_lse=True)
    plain = ck.flash_attention_bwd_reference(tq, tk, tv, out, lse, tg,
                                             causal=True)
    assert [x.dtype for x in plain] == [torch.bfloat16] * 3
    kern = _jax_fused_bwd(q, k, v, out.float().numpy(), lse.numpy(), g)
    rels = _rel_errs(plain, kern)
    assert all(0 < r <= K3_TOL for r in rels), rels
