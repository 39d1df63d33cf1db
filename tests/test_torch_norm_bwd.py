"""K6 (RMSNorm backward) and K9 (LayerNorm backward) as the one CUDA
kernel of ``csrc/norm_bwd.cu``: what of it the CPU can hold.

- The wrapper's row partition is a pure function of (rows, grid) that
  covers every row once, in contiguous runs in block order, and the
  kernel computes the same formula; the grid is a whole number of
  clusters within the co-resident limit; the wrapper picks the
  kernel's path (a warp or a block a row, TMA or 16-byte or element
  accesses) by width and alignment, with the kernel's constants.
- The registry and the build name the CUDA source for both rows, and no
  Triton body of either is left.
- The plain versions against the JAX package's Pallas kernels (interpret
  mode) at the rows the kernel takes off its TMA path: a byte length
  not a multiple of 16 (F = 197) and wide rows (F = 4096). Tolerances as
  in ``test_torch_kernels_bwd.py`` and ``test_torch_layer_norm.py``:
  f32 1e-5 for dx (the same math in another summation order), dγ and dβ
  1e-5 relative with a floor; bf16 2 ulps (both sides compute in f32
  and round each output once).

The kernel itself runs only on the card: ``chip_smoke.py``'s kernels
phase holds it against the plain versions there.
"""
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import fused_norms as jax_norms
from deeplearning4j_tpu_torch.ops import (cuda_build, cuda_kernels,
                                          fused_norms, kernel_registry)

F32_TOL = 1e-5
BF16_BWD_ULPS = 2
_SOURCE = "deeplearning4j_tpu_torch/csrc/norm_bwd.cu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cu_text() -> str:
    return (cuda_build.CSRC_DIR / "norm_bwd.cu").read_text()


# -- the row partition and the grid ----------------------------------------
@pytest.mark.parametrize("grid", [1, 132, 264])
@pytest.mark.parametrize("rows", [0, 1, 7, 131, 8192, 16387])
def test_row_partition_covers_every_row_once_in_block_order(rows, grid):
    runs = fused_norms._row_partition(rows, grid)
    assert len(runs) == grid
    assert runs[0][0] == 0 and runs[-1][1] == rows
    for (s0, e0), (s1, _) in zip(runs, runs[1:]):
        assert e0 == s1                 # contiguous, in block order
    assert all(e >= s for s, e in runs)
    covered = [r for s, e in runs for r in range(s, e)]
    assert covered == list(range(rows))
    # balanced: the runs differ by at most one row
    sizes = [e - s for s, e in runs]
    assert max(sizes) - min(sizes) <= 1
    # a pure function of (rows, grid)
    assert fused_norms._row_partition(rows, grid) == runs


def test_kernel_computes_the_wrappers_partition():
    """Both kernels take block b's rows by the wrapper's formula."""
    text = _cu_text()
    assert text.count("rows * blockIdx.x / gridDim.x") == 2
    assert text.count("rows * (blockIdx.x + 1) / gridDim.x") == 2


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_cluster_slices_and_their_owners_cover_every_column_once(cluster):
    """The finish's slices of the columns, rank q's [lo(q), lo(q + 1)),
    and the owner a warp-path block pushes column j to: the kernel's two
    formulas, evaluated here for every column of every width the kernel
    takes up to 2 x 1024 (the warp path's widest LayerNorm row), and the
    launch entry's refusal of a cluster that is not a power of two."""
    text = _cu_text()
    assert "return (ncol * q) >> sh;" in text
    assert "return (((j + 1) << sh) + ncol - 1) / ncol - 1;" in text
    assert "(cluster & (cluster - 1))" in text
    sh = cluster.bit_length() - 1
    for ncol in range(1, 2 * fused_norms._WARP_MAX_F + 1):
        lo = [(ncol * q) >> sh for q in range(cluster + 1)]
        assert lo[0] == 0 and lo[-1] == ncol
        assert all(a <= b for a, b in zip(lo, lo[1:]))
        owner = [(((j + 1) << sh) + ncol - 1) // ncol - 1
                 for j in range(ncol)]
        assert owner == [q for q in range(cluster)
                         for _ in range(lo[q], lo[q + 1])]


@pytest.mark.parametrize("rows,unit,max_blocks,cluster,want", [
    (16384, 8, 264, 8, 264),      # the train path: every co-resident block
    (2048, 8, 264, 8, 256),       # a warp a row, 256 blocks
    (7, 8, 264, 8, 8),            # one cluster, most blocks without rows
    (1000, 1, 1056, 8, 1000),     # a block a row
    (16, 1, 132, 4, 16),
    (3, 1, 132, 4, 4),            # rounded up to a whole cluster
])
def test_bwd_grid_is_whole_clusters_within_the_limit(rows, unit,
                                                     max_blocks, cluster,
                                                     want):
    grid = fused_norms._bwd_grid(rows, unit, max_blocks, cluster)
    assert grid == want
    assert grid % cluster == 0 and cluster <= grid <= max_blocks


def test_wrapper_constants_are_the_kernels():
    text = _cu_text()
    nt = int(re.search(r"constexpr int NT = (\d+);", text).group(1))
    assert nt // 32 == fused_norms._NORM_WARPS
    assert int(re.search(r"constexpr int WARP_MAX_F = (\d+);",
                         text).group(1)) == fused_norms._WARP_MAX_F
    assert int(re.search(r"constexpr int MAX_F = (\d+);",
                         text).group(1)) == fused_norms._MAX_F
    # the kernel's dtype and path codes
    assert "enum { F32 = 0, BF16 = 1, F16 = 2 };" in text
    assert fused_norms._NORM_DTYPES == {torch.float32: 0,
                                        torch.bfloat16: 1,
                                        torch.float16: 2}
    for name in ("BLOCK", "BLOCK_VEC", "WARP", "WARP_VEC", "WARP_TMA"):
        code = int(re.search(rf"PATH_{name} = (\d+),", text).group(1))
        assert getattr(fused_norms, f"_PATH_{name}") == code


P = fused_norms     # the path codes


@pytest.mark.parametrize("dtype,f,offset,path", [
    (torch.bfloat16, 768, 0, P._PATH_WARP_TMA),     # the main paths
    (torch.float32, 768, 0, P._PATH_WARP_TMA),
    (torch.float32, 200, 0, P._PATH_WARP_TMA),      # 800 bytes: chunks
    (torch.bfloat16, 200, 0, P._PATH_WARP_TMA),
    (torch.bfloat16, 197, 0, P._PATH_WARP),         # 394 bytes
    (torch.float32, 197, 0, P._PATH_WARP),
    (torch.bfloat16, 768, 1, P._PATH_WARP),         # a base off 16 bytes
    (torch.bfloat16, 4096, 0, P._PATH_BLOCK_VEC),   # too wide for a warp
    (torch.float32, 16384, 0, P._PATH_BLOCK_VEC),
    (torch.bfloat16, 4097, 0, P._PATH_BLOCK),
    (torch.bfloat16, 4096, 1, P._PATH_BLOCK),
])
def test_path_by_width_and_alignment(dtype, f, offset, path):
    n = 4
    flat = torch.zeros(n * f + 8, dtype=dtype)
    x = flat[offset:offset + n * f].view(n, f)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    dx = torch.empty_like(x)
    assert fused_norms._norm_path(f, x, x, dx) == path


# -- the registry, the build, the Triton bodies gone ------------------------
@pytest.mark.parametrize("key", ["K6", "K9"])
def test_registry_rows_name_the_cuda_kernel(key):
    e = {e.key: e for e in kernel_registry.KERNELS}[key]
    assert e.status == "ported"
    assert e.route == "cuda"
    assert e.source == _SOURCE
    # chip_smoke.py builds a CUDA row's library by its source's stem
    sources, entries = cuda_kernels._LIBS["norm_bwd"]
    assert sources == ("norm_bwd.cu",)
    assert set(entries) == {"dl4j_norm_bwd_grid", "dl4j_norm_bwd"}


def test_no_triton_body_of_k6_or_k9_left():
    src = inspect.getsource(fused_norms)
    for name in ("def rms_bwd(", "def ln_bwd(", "def rms_bwd_reduce(",
                 "_reduce_partials", "_row_runs"):
        assert name not in src, name
    k = inspect.getsource(fused_norms._triton_kernels)
    assert k.count("@triton.jit") == 3      # K2, K7, K8


# -- plain versions against the JAX kernels, off the TMA path ---------------
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
    dy = rng.normal(size=(rows, f)).astype(np.float32)
    return x, g, dy


@pytest.mark.parametrize("rows,f", [(9, 197), (3, 4096)])
def test_rms_bwd_plain_matches_jax_kernel_off_the_tma_path(rows, f):
    x, g, dy = _inputs(rows + f, rows, f)
    dx, dg = fused_norms.rms_norm_bwd(_t(x), _t(g), _t(dy))
    jdx, jdg = jax_norms._rms_bwd_call(jnp.asarray(x), jnp.asarray(g),
                                       jnp.asarray(dy), 1e-6)
    np.testing.assert_allclose(_np(dx), np.asarray(jdx), atol=F32_TOL,
                               rtol=0)
    np.testing.assert_allclose(_np(dg), np.asarray(jdg),
                               atol=F32_TOL * 10, rtol=1e-6)


@pytest.mark.parametrize("rows,f", [(9, 197), (3, 4096)])
def test_ln_bwd_plain_matches_jax_kernel_off_the_tma_path(rows, f):
    x, g, dy = _inputs(2 * rows + f, rows, f)
    ours = fused_norms.layer_norm_bwd(_t(x), _t(g), _t(dy))
    theirs = jax_norms._ln_bwd_call(jnp.asarray(x), jnp.asarray(g),
                                    jnp.asarray(dy), 1e-5)
    np.testing.assert_allclose(_np(ours[0]), np.asarray(theirs[0]),
                               atol=F32_TOL, rtol=0)
    for o, t in zip(ours[1:], theirs[1:]):
        np.testing.assert_allclose(_np(o), np.asarray(t), atol=F32_TOL,
                                   rtol=F32_TOL)


@pytest.mark.parametrize("ln", [False, True], ids=["K6", "K9"])
def test_bwd_plain_matches_jax_kernel_bf16_unaligned_rows(ln):
    x, g, dy = _inputs(31, 13, 197)
    bf = lambda a: _t(a, torch.bfloat16)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    if ln:
        ours = fused_norms.layer_norm_bwd(bf(x), bf(g), bf(dy))
        theirs = jax_norms._ln_bwd_call(jb(x), jb(g), jb(dy), 1e-5)
    else:
        ours = fused_norms.rms_norm_bwd(bf(x), bf(g), bf(dy))
        theirs = jax_norms._rms_bwd_call(jb(x), jb(g), jb(dy), 1e-6)
    assert all(o.dtype == torch.bfloat16 for o in ours)
    for o, t in zip(ours, theirs):
        assert _ulps(_np(o), t) <= BF16_BWD_ULPS


@pytest.mark.parametrize("ln", [False, True], ids=["K6", "K9"])
def test_bwd_of_no_rows_is_zero_gradients(ln):
    """Zero rows (the kernel is not launched for them on the card): dx
    empty, dγ (and dβ) zeros of γ's dtype, the counters untouched."""
    x = torch.zeros((0, 64), dtype=torch.bfloat16)
    g = torch.ones(64, dtype=torch.bfloat16)
    fn = fused_norms.layer_norm_bwd if ln else fused_norms.rms_norm_bwd
    before = fn.launches
    out = fn(x, g, x)
    assert out[0].shape == (0, 64)
    for p in out[1:]:
        assert p.shape == (64,) and p.dtype == torch.bfloat16
        assert not p.float().abs().sum()
    assert fn.launches == before
