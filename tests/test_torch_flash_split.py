"""The long-context leg's kernels — K4 (the split dq pass) and K5 (the
split dk/dv pass) — through their plain PyTorch versions, against the
JAX package's split kernels run in interpret mode (``_flash_bwd`` with
``_FUSED_BWD_DQ_VMEM`` patched to 0, blocks of 64), and the port's
choice between them and the fused K3 against the JAX condition. On the
CPU every wrapper runs its plain version; the kernels themselves are
held against the plain versions on the card by ``chip_smoke.py``. To
force the split backward on the CPU, patch
``cuda_kernels._FUSED_BWD_DQ_VMEM`` to 0, as here.

Tolerances, as for K3 (``tests/test_torch_kernels_bwd.py``):
- float32: 5e-5 of the largest gradient — the same math in another
  summation order.
- bfloat16: the JAX kernels round p and ds to bf16 before their
  products (and pre-scale q in bf16); the plain versions compute in f32
  and round each output once: 2e-2 of the largest gradient.
- split against fused plain versions: both f32 math on the same inputs,
  2e-5 absolute in float32; in bfloat16 each rounds its f32 result once,
  so one bf16 ulp (2^-8) of the largest gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_kernels as jax_pk
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck

F32_REL = 5e-5
BF16_REL = 2e-2
F32_ATTN_TOL = 2e-5


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


def _inputs(seed, b, tq, tk, h, h_kv, d, masked):
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


def _forward(q, k, v, mask, causal, offsets):
    """The port's plain forward with its lse at the given causal
    offsets: out [B, Tq, H, D] and lse [B, H, Tq]."""
    b, t, h, d = q.shape
    groups = h // k.shape[2]
    fold = lambda x: x.permute(0, 2, 1, 3).reshape(b * x.shape[2],
                                                   x.shape[1], d)
    expand = lambda x: fold(x).repeat_interleave(groups, dim=0)
    km = None if mask is None else mask.repeat_interleave(h, dim=0)
    out, lse = ck._reference_scan(fold(q), expand(k), expand(v), km,
                                  offsets, causal, return_lse=True)
    return (out.reshape(b, h, t, d).permute(0, 2, 1, 3),
            lse.reshape(b, h, t))


def _jax_split_bwd(q, k, v, out, lse, g, mask, causal, offsets, dtype):
    """The JAX ``_flash_bwd`` forced onto its split kernels (interpret
    mode, blocks of 64) on folded [B·H, T, D] operands; returns dq, dk,
    dv in [B, T, H, D]."""
    b, tq, h, d = q.shape
    tk, h_kv = k.shape[1], k.shape[2]
    fold = lambda x: jnp.asarray(x, dtype).transpose(0, 2, 1, 3).reshape(
        b * x.shape[2], x.shape[1], d)
    km = None if mask is None else jnp.repeat(jnp.asarray(mask), h_kv, 0)
    prev = jax_pk._FUSED_BWD_DQ_VMEM
    jax_pk._FUSED_BWD_DQ_VMEM = 0
    try:
        dq, dk, dv = jax_pk._flash_bwd(
            fold(q), fold(k), fold(v), fold(out),
            jnp.asarray(lse).reshape(b * h, tq, 1), fold(g), km,
            jnp.asarray(offsets, jnp.int32), causal, 64, 64,
            groups=h // h_kv)
    finally:
        jax_pk._FUSED_BWD_DQ_VMEM = prev
    unfold = lambda x, n, heads: np.asarray(x, np.float32).reshape(
        b, heads, n, d).transpose(0, 2, 1, 3)
    return unfold(dq, tq, h), unfold(dk, tk, h_kv), unfold(dv, tk, h_kv)


def _assert_close(name, ours, theirs, dname):
    ours = _np(ours)
    rel = np.abs(ours - theirs).max() / max(np.abs(theirs).max(), 1e-30)
    assert rel <= (F32_REL if dname == "float32" else BF16_REL), (name,
                                                                  rel)


SPLIT_CASES = [
    # (causal, tq, tk, h, h_kv, masked, d, offsets)
    (True, 130, 130, 4, 2, False, 16, None),     # ragged T, GQA
    (False, 130, 130, 4, 4, True, 64, None),     # key mask, D 64
    (True, 64, 200, 4, 2, False, 16, None),      # Tq < Tk, end-aligned
    (False, 40, 200, 4, 4, True, 16, None),      # Tq != Tk, key mask
    (True, 200, 200, 4, 2, True, 64, None),      # causal, mask, GQA
    (True, 130, 130, 4, 4, False, 16, (128, 64)),  # ring-style offsets
]


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,tq,tk,h,h_kv,masked,d,offsets",
                         SPLIT_CASES)
def test_split_plain_matches_jax_split_kernels(causal, tq, tk, h, h_kv,
                                               masked, d, offsets, dname):
    """K4's and K5's plain versions (through their wrappers, and called
    with 64-row tiles so that the tile loops and the causal skips run)
    against the JAX split kernels on the same rounded inputs, out and
    lse."""
    b = 2
    dt = getattr(torch, dname)
    q, k, v, g, mask = _inputs(tq * 3 + tk + d, b, tq, tk, h, h_kv, d,
                               masked)
    tq_, tk_, tv_, tg_ = (_t(x, dt) for x in (q, k, v, g))
    tm = None if mask is None else _t(mask)
    offs = offsets or ((tk - tq, 0) if causal else (0, 0))
    out, lse = _forward(tq_, tk_, tv_, tm, causal, offs)
    kw = dict(causal=causal, mask=tm, offsets=offsets)
    theirs = _jax_split_bwd(_np(tq_), _np(tk_), _np(tv_), _np(out),
                            lse.numpy(), _np(tg_), mask, causal, offs,
                            jnp.bfloat16 if dname == "bfloat16"
                            else jnp.float32)
    args = (tq_, tk_, tv_, out.to(dt), lse, tg_)
    for block in (512, 64):
        if block == 512:
            dq = ck.flash_attention_bwd_dq(*args, **kw)
            dk, dv = ck.flash_attention_bwd_dkv(*args, **kw)
        else:
            dq = ck.flash_attention_bwd_dq_reference(*args, **kw,
                                                     block=block)
            dk, dv = ck.flash_attention_bwd_dkv_reference(*args, **kw,
                                                          block=block)
        assert [x.dtype for x in (dq, dk, dv)] == [dt] * 3
        assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
        for name, o, th in zip(("dq", "dk", "dv"), (dq, dk, dv), theirs):
            _assert_close(f"{name} block={block}", o, th, dname)


@pytest.mark.parametrize("t", [1024, 24576, 24577, 32768])
@pytest.mark.parametrize("d", [64, 128])
def test_dispatch_equals_the_jax_condition(t, d):
    """The port picks the split pair exactly where the JAX ``_flash_bwd``
    does, from the JAX padding and budget (no kernel runs)."""
    assert ck._FUSED_BWD_DQ_VMEM == jax_pk._FUSED_BWD_DQ_VMEM
    block_q, _, tq, _, dp = jax_pk._flash_blocks(t, t, d, 1024, 512)
    assert ck._flash_blocks(t, d) == (block_q, tq, dp)
    assert ck._split_bwd(t, d) == (not tq * dp * 4
                                   <= jax_pk._FUSED_BWD_DQ_VMEM)
    # the boundary: 12 MiB exactly stays fused; dp is 128 at D = 64 too
    assert ck._split_bwd(t, d) == (t > 24576)


@pytest.fixture
def spies(monkeypatch):
    """Counts calls of the plain versions ``flash_attention_bwd``
    dispatches to."""
    calls = {}
    for name in ("flash_attention_bwd_reference",
                 "flash_attention_bwd_dq_reference",
                 "flash_attention_bwd_dkv_reference"):
        fn = getattr(ck, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ck, name, spy)
    return calls


@pytest.mark.parametrize("budget,split", [(None, False), (0, True)])
def test_dispatch_picks_before_the_device(budget, split, spies,
                                          monkeypatch):
    """On the CPU the dispatch takes the plain version of the kernel(s)
    it picked: the fused one under the default budget, the split pair
    (once each) with the budget at 0 — and the two agree."""
    if budget is not None:
        monkeypatch.setattr(ck, "_FUSED_BWD_DQ_VMEM", budget)
    q, k, v, g, _ = _inputs(11, 2, 96, 96, 4, 2, 32, False)
    args = [_t(x) for x in (q, k, v)]
    out, lse = ck.flash_attention(*args, causal=True, return_lse=True)
    got = ck.flash_attention_bwd(*args, out, lse, _t(g), causal=True)
    want = {"flash_attention_bwd_dq_reference": 1,
            "flash_attention_bwd_dkv_reference": 1} if split else \
        {"flash_attention_bwd_reference": 1}
    assert spies == want
    other = ck.flash_attention_bwd_reference(*args, out, lse, _t(g),
                                             causal=True)
    for a, b in zip(got, other):
        np.testing.assert_allclose(_np(a), _np(b), atol=F32_ATTN_TOL,
                                   rtol=0)


@pytest.mark.parametrize("causal,tq,tk,h,h_kv,masked", [
    (True, 96, 96, 4, 2, False), (False, 64, 96, 4, 4, True)])
def test_flash_attention_fn_grads_through_split_match_jax_grad(
        causal, tq, tk, h, h_kv, masked, monkeypatch, spies):
    """The port's ``_FlashAttentionFn`` with its backward on the split
    branch (port budget 0) against ``jax.grad`` through the JAX
    ``flash_attention`` on its split kernels (interpret mode, JAX budget
    0)."""
    monkeypatch.setenv("DL4J_TPU_KERNEL_FORCE", "1")
    monkeypatch.setattr(jax_pk, "_FUSED_BWD_DQ_VMEM", 0)
    monkeypatch.setattr(ck, "_FUSED_BWD_DQ_VMEM", 0)
    b, d = 2, 32
    q, k, v, w, mask = _inputs(5 + tq, b, tq, tk, h, h_kv, d, masked)
    jm = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        o = jax_pk.flash_attention(q, k, v, causal=causal, mask=jm,
                                   block_q=64, block_k=64)
        return jnp.sum(o * w)

    theirs = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq_, tk_, tv_ = (_t(x).requires_grad_() for x in (q, k, v))
    o = ck.flash_attention(tq_, tk_, tv_, causal=causal,
                           mask=None if mask is None else _t(mask))
    (o * _t(w)).sum().backward()
    assert spies == {"flash_attention_bwd_dq_reference": 1,
                     "flash_attention_bwd_dkv_reference": 1}
    for x, th in zip((tq_, tk_, tv_), theirs):
        np.testing.assert_allclose(_np(x.grad), np.asarray(th),
                                   atol=F32_ATTN_TOL, rtol=0)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,tq,tk,h_kv,masked", [
    (True, 300, 300, 2, False), (False, 200, 260, 4, True),
    (True, 100, 300, 4, True)])
def test_split_and_fused_plain_versions_agree(causal, tq, tk, h_kv,
                                              masked, dname):
    """The blockwise split pair (64-row tiles) and the whole-matrix
    fused plain version compute the same function."""
    dt = getattr(torch, dname)
    q, k, v, g, mask = _inputs(tq + tk, 1, tq, tk, 4, h_kv, 32, masked)
    tq_, tk_, tv_, tg_ = (_t(x, dt) for x in (q, k, v, g))
    tm = None if mask is None else _t(mask)
    out, lse = ck.flash_attention(tq_, tk_, tv_, causal=causal, mask=tm,
                                  return_lse=True)
    args = (tq_, tk_, tv_, out, lse, tg_)
    split = (ck.flash_attention_bwd_dq_reference(
        *args, causal=causal, mask=tm, block=64),
        *ck.flash_attention_bwd_dkv_reference(*args, causal=causal,
                                              mask=tm, block=64))
    fused = ck.flash_attention_bwd_reference(*args, causal=causal,
                                             mask=tm)
    for a, f in zip(split, fused):
        a, f = _np(a), _np(f)
        if dname == "float32":
            np.testing.assert_allclose(a, f, atol=F32_ATTN_TOL, rtol=0)
        else:
            assert np.abs(a - f).max() <= 2.0 ** -8 * np.abs(f).max()


def test_split_rows_without_live_key_get_zero_grads():
    """A fully key-masked example (lse = −inf, taken as 0, every p 0)
    and, under causal Tq > Tk, the leading rows that see no key: their
    gradients are exactly 0 in the split pair, as in the JAX kernels
    (twin of ``test_flash_plain_row_without_live_key_is_zero``)."""
    b, t, h, d = 2, 96, 2, 32
    q, k, v, g, _ = _inputs(7, b, t, t, h, h, d, False)
    mask = np.ones((b, t), np.float32)
    mask[1] = 0.0
    args = [_t(x) for x in (q, k, v)]
    out, lse = ck.flash_attention(*args, mask=_t(mask), return_lse=True)
    assert torch.isinf(lse[1]).all()
    dq = ck.flash_attention_bwd_dq(*args, out, lse, _t(g), mask=_t(mask))
    dk, dv = ck.flash_attention_bwd_dkv(*args, out, lse, _t(g),
                                        mask=_t(mask))
    for x in (dq, dk, dv):
        assert (x[1] == 0).all() and (x[0] != 0).any()
    theirs = _jax_split_bwd(q, k, v, _np(out), lse.numpy(), g, mask, False,
                            (0, 0), jnp.float32)
    for name, o, th in zip(("dq", "dk", "dv"), (dq, dk, dv), theirs):
        _assert_close(name, o, th, "float32")
    # causal, Tq > Tk: rows 0..tq-tk-1 see no key (end-aligned diagonal)
    tq, tk = 96, 40
    q, k, v, g, _ = _inputs(8, 1, tq, tk, h, h, d, False)
    args = [_t(x) for x in (q, k, v)]
    out, lse = _forward(*args, None, True, (tk - tq, 0))
    dq = ck.flash_attention_bwd_dq(*args, out, lse, _t(g), causal=True)
    assert (dq[:, :tq - tk] == 0).all() and (dq[:, tq - tk:] != 0).any()


def test_split_counters_stay_zero_on_cpu(monkeypatch):
    """The K4 and K5 launch counters count kernel launches only: the
    plain versions on the CPU leave them untouched."""
    monkeypatch.setattr(ck, "_FUSED_BWD_DQ_VMEM", 0)
    before = (ck.flash_attention_bwd_dq.launches,
              ck.flash_attention_bwd_dkv.launches,
              ck.flash_attention_bwd.launches)
    q, k, v, g, _ = _inputs(1, 1, 16, 16, 2, 2, 16, False)
    args = [_t(x) for x in (q, k, v)]
    out, lse = ck.flash_attention(*args, return_lse=True)
    ck.flash_attention_bwd(*args, out, lse, _t(g))
    ck.flash_attention_bwd_dq(*args, out, lse, _t(g))
    ck.flash_attention_bwd_dkv(*args, out, lse, _t(g))
    assert (ck.flash_attention_bwd_dq.launches,
            ck.flash_attention_bwd_dkv.launches,
            ck.flash_attention_bwd.launches) == before
