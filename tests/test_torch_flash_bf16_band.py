"""The bf16 rounding band of the tensor-core K1 (flash forward) and K4
(flash dq), on the CPU.

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
