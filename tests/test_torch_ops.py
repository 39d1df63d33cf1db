"""Port kernels' plain versions against the JAX package's kernels.

On the CPU the port's kernel wrappers run their plain PyTorch versions
(``ops.fused_norms.rms_norm_reference``, ``ops.cuda_kernels.
flash_attention_reference``); the kernels themselves are checked against those on
the card by ``chip_smoke.py``. Here the same numpy inputs go through the
JAX package — its Pallas kernels in interpret mode and its plain
expressions — and through the port.

Tolerances:
- float32: 1e-5 (RMSNorm) and 2e-5 (attention) absolute — the same
  math, summed in another order.
- bfloat16 RMSNorm: the JAX kernel computes in f32 and rounds once; the
  plain expression (JAX's gate-off path and the port's) rounds in bf16
  at every op (square, mean, rsqrt, two products), each of them up to
  ~3.5 ulp from the exact value, and the two frameworks round the mean
  differently. The band is 8 bf16 ulps of the output (one ulp = 2^-8
  relative), measured against the kernel and against JAX's plain
  expression.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers.attention import \
    scaled_dot_attention as jax_sdpa
from deeplearning4j_tpu.ops import fused_norms as jax_norms
from deeplearning4j_tpu.ops import pallas_kernels as jax_pk
from deeplearning4j_tpu_torch.nn.layers.attention import (
    _use_flash, repeat_kv_heads, rotary_embedding, scaled_dot_attention)
from deeplearning4j_tpu_torch.ops import cuda_kernels, fused_norms
from deeplearning4j_tpu_torch.ops.kernel_registry import (
    BEAM_NEW, CHARRNN_ATT_T, KERNELS, LM_LEAVES, on_path, ported)

F32_NORM_TOL = 1e-5
F32_ATTN_TOL = 2e-5
BF16_NORM_ULPS = 8


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


# -- RMSNorm ------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 5, 96), (7, 768), (3, 130)])
def test_rms_norm_plain_matches_jax_f32(shape, monkeypatch):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape[-1:]).astype(np.float32)
    ours = fused_norms.rms_norm(_t(x), _t(g)).numpy()
    ref = np.asarray(jax_norms.rms_norm_reference(x, g))
    np.testing.assert_allclose(ours, ref, atol=F32_NORM_TOL, rtol=0)
    monkeypatch.setenv("DL4J_TPU_KERNEL_FORCE", "1")   # interpret kernel
    kern = np.asarray(jax_norms.rms_norm(jnp.asarray(x), jnp.asarray(g)))
    np.testing.assert_allclose(ours, kern, atol=F32_NORM_TOL, rtol=0)


def test_rms_norm_plain_matches_jax_bf16(monkeypatch):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 768)).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=768)).astype(np.float32)
    ours = fused_norms.rms_norm(_t(x, torch.bfloat16),
                                _t(g, torch.bfloat16))
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    xb, gb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    ref = np.asarray(jax_norms.rms_norm_reference(xb, gb), np.float32)
    monkeypatch.setenv("DL4J_TPU_KERNEL_FORCE", "1")
    kern = np.asarray(jax_norms.rms_norm(xb, gb), np.float32)
    for other in (kern, ref):
        ulps = np.abs(ours - other) / (2.0 ** -8 * np.abs(other) + 1e-3)
        assert ulps.max() <= BF16_NORM_ULPS, ulps.max()


# -- flash attention -----------------------------------------------------------
def _qkv(seed, b, tq, tk, h, h_kv, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, tq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, tk, h_kv, d)).astype(np.float32)
    v = rng.normal(size=(b, tk, h_kv, d)).astype(np.float32)
    return q, k, v


def _key_mask(b, tk, seed=3):
    m = (np.random.default_rng(seed).random((b, tk)) > 0.3)
    m[:, 0] = True
    return m.astype(np.float32)


CASES = [
    # (causal, tq, tk, h, h_kv, masked)
    (True, 64, 64, 4, 4, False),
    (True, 200, 200, 4, 2, False),       # GQA groups 2, ragged tiles
    (False, 64, 64, 4, 2, True),         # key mask
    (False, 200, 200, 4, 4, True),
    (True, 40, 200, 4, 2, False),        # Tq != Tk: end-aligned diagonal
    (False, 64, 200, 4, 4, True),
]


@pytest.mark.parametrize("causal,tq,tk,h,h_kv,masked", CASES)
def test_flash_plain_matches_jax(causal, tq, tk, h, h_kv, masked):
    b, d = 2, 32
    q, k, v = _qkv(tq * 7 + tk, b, tq, tk, h, h_kv, d)
    mask = _key_mask(b, tk) if masked else None
    ours = cuda_kernels.flash_attention(
        _t(q), _t(k), _t(v), causal=causal,
        mask=None if mask is None else _t(mask), block_k=64).numpy()
    kern = np.asarray(jax_pk.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        mask=None if mask is None else jnp.asarray(mask), block_q=64,
        block_k=64))
    np.testing.assert_allclose(ours, kern, atol=F32_ATTN_TOL, rtol=0)
    ein = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v),
                              None if mask is None else jnp.asarray(mask),
                              causal))
    np.testing.assert_allclose(ours, ein, atol=F32_ATTN_TOL, rtol=0)


def _length_mask(t, lengths):
    """A padded batch's key mask: row i live on its first lengths[i]
    keys (lengths >= 1: a row with no live key is the documented
    einsum/kernel difference)."""
    return (np.arange(t)[None, :]
            < np.asarray(lengths)[:, None]).astype(np.float32)


@pytest.mark.parametrize("t,lengths", [(128, (1, 47, 128)),
                                       (100, (1, 64, 99))])
def test_flash_plain_matches_jax_d64_key_masked(t, lengths):
    """The fine-tune path's attention: head dim 64, not causal, keys
    masked by padded lengths. Out and lse against the JAX kernels in
    interpret mode, out against the einsum the CPU path runs."""
    b, h, d = len(lengths), 2, 64
    q, k, v = _qkv(t + d, b, t, t, h, h, d)
    mask = _length_mask(t, lengths)
    out, lse = cuda_kernels.flash_attention(_t(q), _t(k), _t(v),
                                            mask=_t(mask), return_lse=True)
    kern = np.asarray(jax_pk.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=jnp.asarray(mask), block_q=64, block_k=64))
    np.testing.assert_allclose(out.numpy(), kern, atol=F32_ATTN_TOL, rtol=0)
    fold = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(
        b * h, t, d)
    _, j_lse = jax_pk.flash_block_fwd(
        fold(q), fold(k), fold(v), km=jnp.repeat(jnp.asarray(mask), h, 0),
        block_q=64, block_k=64)
    np.testing.assert_allclose(lse.reshape(b * h, t).numpy(),
                               np.asarray(j_lse)[..., 0],
                               atol=F32_ATTN_TOL, rtol=0)
    ein = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(mask), False))
    np.testing.assert_allclose(out.numpy(), ein, atol=F32_ATTN_TOL, rtol=0)


def test_flash_plain_lse_matches_jax_block_fwd():
    """The optional lse output: the JAX kernel's per-row logsumexp
    (``flash_block_fwd``, folded [B·H, T, 1]) against the port's
    [B, H, T]."""
    b, t, h, h_kv, d = 2, 96, 4, 2, 32
    q, k, v = _qkv(11, b, t, t, h, h_kv, d)
    out, lse = cuda_kernels.flash_attention(_t(q), _t(k), _t(v),
                                            causal=True, return_lse=True)
    fold = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(
        b * x.shape[2], t, d)
    j_out, j_lse = jax_pk.flash_block_fwd(
        fold(q), fold(k), fold(v), causal=True, block_q=64, block_k=64,
        groups=h // h_kv)
    np.testing.assert_allclose(
        out.permute(0, 2, 1, 3).reshape(b * h, t, d).numpy(),
        np.asarray(j_out), atol=F32_ATTN_TOL, rtol=0)
    np.testing.assert_allclose(lse.reshape(b * h, t).numpy(),
                               np.asarray(j_lse)[..., 0],
                               atol=F32_ATTN_TOL, rtol=0)


def test_flash_plain_row_without_live_key_is_zero():
    """A fully key-masked example: the kernel semantics (denominator
    clamped at 1e-30) give exact zeros, like the JAX kernel."""
    b, t, h, d = 2, 64, 2, 32
    q, k, v = _qkv(5, b, t, t, h, h, d)
    mask = np.ones((b, t), np.float32)
    mask[1] = 0.0
    ours = cuda_kernels.flash_attention(_t(q), _t(k), _t(v),
                                        mask=_t(mask)).numpy()
    kern = np.asarray(jax_pk.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=jnp.asarray(mask), block_q=64, block_k=64))
    assert (ours[1] == 0).all() and (kern[1] == 0).all()
    np.testing.assert_allclose(ours, kern, atol=F32_ATTN_TOL, rtol=0)


# -- attention helpers -----------------------------------------------------------
def test_rotary_and_repeat_kv_match_jax():
    from deeplearning4j_tpu.nn.layers.attention import (
        repeat_kv_heads as j_rep, rotary_embedding as j_rope)
    x = np.random.default_rng(6).normal(size=(2, 9, 4, 16)).astype(
        np.float32)
    np.testing.assert_allclose(
        rotary_embedding(_t(x), 10000.0, offset=5).numpy(),
        np.asarray(j_rope(jnp.asarray(x), 10000.0, offset=5)),
        atol=1e-5, rtol=0)
    np.testing.assert_array_equal(repeat_kv_heads(_t(x), 8).numpy(),
                                  np.asarray(j_rep(jnp.asarray(x), 8)))


@pytest.mark.parametrize("causal,tq,tk", [(True, 12, 12), (True, 5, 12),
                                          (False, 12, 7)])
def test_scaled_dot_attention_cpu_matches_jax(causal, tq, tk):
    q, k, v = _qkv(9, 2, tq, tk, 4, 2, 16)
    mask = _key_mask(2, tk)
    ours = scaled_dot_attention(_t(q), _t(k), _t(v), _t(mask),
                                causal).numpy()
    ref = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(mask), causal))
    np.testing.assert_allclose(ours, ref, atol=F32_ATTN_TOL, rtol=0)


def test_use_flash_gate_keeps_semantic_refusals():
    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 4, 2, 16)
    # CPU tensors never take the kernel
    assert not _use_flash(q, q, causal=True)
    # the semantic refusals hold whatever the device
    assert not _use_flash(q, k, causal=True)          # causal Tq > Tk
    assert not _use_flash(q.double(), q.double())     # float64


def test_registry_lists_every_tpu_kernel():
    keys = [e.key for e in KERNELS]
    assert keys == [f"K{i}" for i in range(1, 12)]
    assert {e.key for e in ported()} == set(keys)
    for e in ported():
        assert e.route in ("cuda", "triton")
        assert callable(e.plain_fn())
        assert isinstance(e.launches(), int)
        # every ported row names the main paths that launch it
        assert e.paths and set(e.paths) <= {"serve", "train", "finetune",
                                            "longctx", "dp", "dp_packed",
                                            "sp", "zero", "dp_graph",
                                            "eval", "serve_opts", "beam",
                                            "train_opts", "finetune_opts",
                                            "serve_fault", "checkpoint",
                                            "transfer", "transfer_agree",
                                            "mlm", "charrnn_agree"}
        # the stepped phases' expected launches per step: one positive
        # count for each stepped path of the row, none for the gateways
        stepped = set(e.paths) - {"serve", "serve_opts", "serve_fault"}
        assert set(e.per_step) == stepped
        assert all(n > 0 for n in e.per_step.values())
    assert {e.key for e in on_path("serve")} == {"K1", "K2"}
    assert {e.key for e in on_path("serve_opts")} == {"K1", "K2"}
    assert {e.key for e in on_path("serve_fault")} == {"K1", "K2"}
    # the K-step regions, the fine-tune steps around a zip checkpoint
    # and the masked-LM step on BERT-base's trunk launch what the train
    # and fine-tune steps do
    for path, like in (("train_opts", "train"),
                       ("finetune_opts", "finetune"),
                       ("checkpoint", "finetune"), ("mlm", "finetune")):
        assert {e.key: e.per_step[path] for e in on_path(path)} == \
            {e.key: e.per_step[like] for e in on_path(like)}
    # one generate_beam call: K1 once a block of its one prefill, K2 at
    # the 25 norms of the prefill and of each of BEAM_NEW - 1 steps
    assert {e.key: e.per_step["beam"] for e in on_path("beam")} == {
        "K1": 12, "K2": 25 * BEAM_NEW}
    assert {e.key for e in on_path("train")} == {"K1", "K2", "K3", "K6",
                                                 "K7"}
    # the char-RNN launches none; the attention net of charrnn_agree K1
    # and K3 once a layer and once a step of its recurrent attention
    assert not on_path("charrnn")
    assert {e.key: e.per_step["charrnn_agree"]
            for e in on_path("charrnn_agree")} == {
        "K1": CHARRNN_ATT_T + 2, "K3": CHARRNN_ATT_T + 2}
    # the transferred LM: train's forward; the backward through the six
    # trainable blocks (K3) and their two norms each and the final norm
    # (K6) only; transfer_agree: 4 blocks, 2 of them frozen
    assert {e.key: e.per_step["transfer"] for e in on_path("transfer")} \
        == {"K1": 12, "K2": 13, "K3": 6, "K6": 13, "K7": 12}
    assert {e.key: e.per_step["transfer_agree"]
            for e in on_path("transfer_agree")} == {
        "K1": 4, "K2": 5, "K3": 2, "K6": 5, "K7": 4}
    assert {e.key: e.per_step["finetune"]
            for e in on_path("finetune")} == {"K1": 12, "K3": 12,
                                              "K8": 26, "K9": 26}
    # the long-context step: K4 + K5 in K3's place
    assert {e.key: e.per_step["longctx"]
            for e in on_path("longctx")} == {"K1": 12, "K2": 13, "K4": 12,
                                             "K5": 12, "K6": 25, "K7": 12}
    # data-parallel: the train step's kernels; the packed exchange adds
    # the codec, once a gradient leaf (and rank, one on the card)
    train = {e.key: e.per_step["train"] for e in on_path("train")}
    assert {e.key: e.per_step["dp"] for e in on_path("dp")} == train
    assert {e.key: e.per_step["dp_packed"]
            for e in on_path("dp_packed")} == {**train, "K10": LM_LEAVES,
                                               "K11": LM_LEAVES}
    # sequence-parallel: the long-context LM's zigzag ring at one rank,
    # K1 and K3 once a block pair (four a layer), the norms as longctx
    assert {e.key: e.per_step["sp"] for e in on_path("sp")} == {
        "K1": 48, "K2": 13, "K3": 48, "K6": 25, "K7": 12}
    # the ZeRO sharded update runs the train step's kernels; the graph
    # under the wrapper the fine-tune step's
    assert {e.key: e.per_step["zero"] for e in on_path("zero")} == train
    assert {e.key: e.per_step["dp_graph"]
            for e in on_path("dp_graph")} == {"K1": 12, "K3": 12,
                                              "K8": 26, "K9": 26}
    # evaluation: the fine-tune model's forward alone, per batch — K1
    # once a block, K8 at every LayerNorm; no backward kernel
    assert {e.key: e.per_step["eval"] for e in on_path("eval")} == {
        "K1": 12, "K8": 26}
    for e in KERNELS:
        if e.status == "todo":
            assert e.port is None and e.route is None and not e.paths
            assert not e.per_step


# -- the CUDA build -------------------------------------------------------------
def test_cuda_build_caches_by_source_hash_under_lock(tmp_path, monkeypatch):
    """The build at first use: one nvcc run per source version, the
    library keyed by a hash of the sources (an edit rebuilds, a repeat
    does not), the compiler's report kept beside it, a failed compile
    raised with its stderr. A stand-in ``nvcc`` records its calls."""
    from deeplearning4j_tpu_torch.ops import cuda_build
    src, bld, bindir = tmp_path / "csrc", tmp_path / "build", tmp_path / "bin"
    for d in (src, bindir):
        d.mkdir()
    calls = tmp_path / "calls"
    nvcc = bindir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {calls}\n"
        "grep -q FAIL \"$(eval echo \\${$#})\" && "
        "{ echo 'error: no' >&2; exit 2; }\n"
        "while [ \"$1\" != -o ]; do shift; done\n"
        "echo 'ptxas info : Used 8 registers' >&2\n"
        "touch \"$2\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:/usr/bin:/bin")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", src)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", bld)
    (src / "k.cu").write_text("// v1\n")
    first = cuda_build.build("k", ["k.cu"])
    assert first.exists() and first.parent == bld
    assert "sm_90a" in first.with_suffix(".log").read_text()
    assert cuda_build.build("k", ["k.cu"]) == first   # cached: no nvcc
    assert len(calls.read_text().splitlines()) == 1
    (src / "k.cu").write_text("// v2\n")
    second = cuda_build.build("k", ["k.cu"])
    assert second != first and second.exists()
    assert len(calls.read_text().splitlines()) == 2
    (src / "k.cu").write_text("// FAIL\n")
    with pytest.raises(RuntimeError, match="error: no"):
        cuda_build.build("k", ["k.cu"])
    assert not list(bld.glob("*.tmp"))


def test_cuda_build_key_covers_the_shared_headers(tmp_path, monkeypatch):
    """A source may include any header under ``csrc/``: editing one
    rebuilds every library, so no stale library is loaded."""
    from deeplearning4j_tpu_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    key = cuda_build._key([tmp_path / "k.cu"])
    assert cuda_build._key([tmp_path / "k.cu"]) == key
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert cuda_build._key([tmp_path / "k.cu"]) != key


def test_the_real_cuda_sources_share_one_header():
    """K3 and the split pair K4/K5 include the one backward header, K1,
    K3 and K4/K5 the one tensor-core header; the build key hashes
    both."""
    from deeplearning4j_tpu_torch.ops import cuda_build
    headers = sorted(p.name for p in cuda_build.CSRC_DIR.glob("*.cuh"))
    assert headers == ["flash_bwd_common.cuh", "flash_mma.cuh"]
    for header, sources in (
            ("flash_bwd_common.cuh", ("flash_attention_bwd.cu",
                                      "flash_attention_bwd_split.cu")),
            ("flash_mma.cuh", ("flash_attention.cu",
                               "flash_attention_bwd.cu",
                               "flash_attention_bwd_split.cu"))):
        for src in sources:
            text = (cuda_build.CSRC_DIR / src).read_text()
            assert f'#include "{header}"' in text, (src, header)
