#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py               # phases 1-6 (needs one card)
    python3 chip_smoke.py --phases train,train_agree,kernels
    python3 chip_smoke.py --phases profile    # device-time breakdown

Drives ``deeplearning4j_tpu_torch`` (never JAX, never the JAX package):

1. device — card name, count, and ``nvidia-smi`` name/power limit; then
   every ported CUDA kernel of ``ops/kernel_registry.py`` is built from
   the checkout's sources (one ``nvcc`` per CUDA source, all started
   together), whatever the phases;
2. serve — the full-width GPT-2-small-class LM (vocab 50257, hidden 768,
   12 layers, 6 heads of 128, SwiGLU 8/3, tied embeddings, bfloat16,
   random weights from a seed) behind ``ServingGateway(max_slots=32,
   block=16, max_context=2048)``: 32 seeded requests, prompts of 16 to
   1500 tokens, 64 new tokens each;
3. agree — the same model in float32: the card's prefill logits and 8
   teacher-forced decode steps against the port on the CPU (the plain
   versions), for one 300-token prompt;
4. train — the same model built by ``CausalTransformerLM(...).init(1024)``
   (bfloat16 compute, the model's AdamW) trained by ``net.fit(x, y)`` on
   one fixed batch of 16 x 1024 random tokens: 2 warm steps, then 8
   timed steps; every loss finite and the last below the first, and each
   training kernel launched its expected number of times per step;
5. train_agree — the same model in float32 (TF32 off), one step at
   B = 2, T = 256: the card's loss and every gradient against the port
   on the CPU;
6. kernels — holds each ported kernel against its plain PyTorch version
   on the card at its main path's shapes, in bfloat16 and float32, and
   times the kernel, the plain version and a PyTorch library call that
   computes the same function (a yardstick the port never calls). The
   CUDA kernels (K1, K3, milliseconds each at these shapes) are timed by
   CUDA events around a run of launches; everything else by the replay
   of a CUDA graph of 20 calls, which keeps the host's launch path out
   of the time. For the small norm kernels (K2, K6, K7) the host-side
   time per launch (CUDA events around 20 launches) is printed beside
   it as ``host_ms``. This phase runs last, so that nothing it leaves
   behind in the process can slow the host-bound serve step
   (``PERF.md`` records such a slowdown, cause not isolated).

Each main path (serve, train) zeroes the launch counters of the kernels
just before it runs and reads them just after; it fails if a kernel the
registry lists for that path was not launched.

``profile`` (not in the default run) prints the device busy time, idle
share and top kernels of one 2048-bucket prefill, of 8 decode steps with
32 active slots and of one training step, from ``torch.profiler``. Each
window's wall time is taken before the first profiled window, and the
decode window's wall once more after the last one, to show whether
profiling changed it.

Any failed phase exits non-zero before the result lines. The last two
lines are the ``kernels`` JSON object (when the kernels phase and a path
ran) and the device JSON object.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time

PHASES = ("device", "serve", "agree", "train", "train_agree", "kernels")

# published peaks of one H100 SXM (dense): the bound of a kernel is the
# larger of its operations over the peak rate for their type and its
# bytes over the memory rate
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# tolerances, kernel vs plain version on the same card inputs:
# flash f32 — the same f32 math in another summation order, __expf;
# flash bf16 — both accumulate in f32 from the same bf16 inputs and
# round the output once: at most one bf16 ulp of |o| < 4;
# rms f32 — f32 math both sides; rms bf16 — the plain version rounds in
# bf16 at every op, the kernel once: 8 bf16 ulps (2^-8 relative each)
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
RMS_TOL_F32 = 1e-4
RMS_TOL_BF16_ULPS = 8
# flash backward (K3), max |err| over max |plain|: f32 — the same f32
# math in another order (and dq's atomics in a run-dependent order);
# bf16 — both sides compute in f32 from the same bf16 inputs and round
# each output once: at most one bf16 ulp (2^-8) of the largest value
K3_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# K1's f32 row logsumexp (values < 16): both sides sum the same f32
# scores in another order (the kernel with __expf), whatever the input
# dtype
LSE_TOL = 1e-4
# RMSNorm backward (K6): both sides f32 math; bf16 rounds once on each
# side, dγ summed in another order — 2 bf16 ulps
K6_TOL_F32 = 1e-4
K6_TOL_BF16_ULPS = 2
AGREE_TOL = 2e-3     # f32 logits, card vs CPU, 12 layers deep
# train_agree, f32 with TF32 off: the loss to 1e-5 relative; each
# gradient tensor to 1e-3 of its largest magnitude (f32 sums in another
# order through 12 layers and back)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-3

SERVE = dict(vocab_size=50257, hidden=768, n_layers=12, n_heads=6,
             max_len=2048, ffn_mult=8 / 3, tie_embeddings=True)
TRAIN = dict(SERVE, max_len=1024)
TRAIN_B, TRAIN_T = 16, 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warm: int = 3) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Device time per call: ``iters`` calls of ``fn`` captured in one
    CUDA graph and replayed between CUDA events, so the host's launch
    path is not in the window (the graph launches the work back to
    back). ``fn`` may not synchronise with the host."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # warm up off the capture
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


# -- phase 1 ---------------------------------------------------------------
def phase_device(state):
    import torch
    state["kind"] = torch.cuda.get_device_name(0)
    state["count"] = torch.cuda.device_count()
    log(f"device: {state['kind']} count={state['count']} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    state["smi"] = smi.stdout.strip().splitlines()[0]
    log(state["smi"])
    state["card"] = f"[{state['smi']}]"


# -- phase 2 ---------------------------------------------------------------
def _build_all():
    """Build every ported CUDA library at once, one nvcc each."""
    from pathlib import Path
    from deeplearning4j_tpu_torch.ops import cuda_build, kernel_registry
    # a CUDA row's library is named after its source file
    libs = {Path(e.source).stem: (Path(e.source).name,)
            for e in kernel_registry.ported() if e.route == "cuda"}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs) or 1) as ex:
        futs = {name: ex.submit(cuda_build.build, name, srcs)
                for name, srcs in libs.items()}
        for name, fut in futs.items():
            path = fut.result()
            rep = path.with_suffix(".log").read_text().splitlines()
            log(f"built {name} -> {path.name} "
                f"({time.perf_counter() - t0:.1f}s)")
            for line in rep:
                if "registers" in line or "smem" in line or "spill" in line:
                    log(f"  ptxas: {line.strip()}")


def _flash_case(dt, tb, h, h_kv, causal, masked, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda hh: torch.randn((1, tb, hh, 128), generator=g,
                                device="cuda").to(dt)
    q, k, v = mk(h), mk(h_kv), mk(h_kv)
    mask = None
    if masked:
        mask = (torch.rand((1, tb), generator=g, device="cuda") > 0.3)
        mask[:, 0] = True
        mask = mask.float()
    return q, k, v, mask


def _flash_flops(tb, h, causal, mask):
    """Two products (q·k and p·v) of 2·D flops per live (query, key)
    pair and head — the pairs these inputs make live."""
    if causal:
        pairs = tb * (tb + 1) / 2
    else:
        pairs = tb * (tb if mask is None else float(mask.sum()))
    return 4 * pairs * 128 * h


def phase_kernels(state):
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import kernel_registry
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ents = {e.key: e for e in kernel_registry.ported()}
    card = state["card"]
    rows = {}

    # K1 flash attention forward
    e = ents["K1"]
    flash, plain = e.port_fn(), e.plain_fn()
    cases = [(tb, 6, 6, True, False) for tb in (16, 200, 1024, 2048)]
    cases += [(200, 6, 2, True, False), (2048, 6, 2, True, False),
              (200, 6, 6, False, True), (1024, 6, 6, False, True)]
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for i, (tb, h, h_kv, causal, masked) in enumerate(cases):
            q, k, v, mask = _flash_case(dt, tb, h, h_kv, causal, masked, i)
            out = flash(q, k, v, causal=causal, mask=mask)
            ref = plain(q, k, v, causal=causal, mask=mask)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = err <= FLASH_TOL[dname] and torch.isfinite(out).all()
            line = (f"K1 flash {dname} Tb={tb} H={h} Hkv={h_kv} "
                    f"causal={causal} mask={masked}: max_abs_err={err:.3e}"
                    f" tol={FLASH_TOL[dname]:.0e}")
            t_k = time_ms(lambda: flash(q, k, v, causal=causal, mask=mask))
            t_p = device_ms(lambda: plain(q, k, v, causal=causal,
                                          mask=mask), iters=5)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib_kw = {"enable_gqa": True} if h != h_kv else {}
            if mask is not None:
                lib_kw["attn_mask"] = mask.bool()[:, None, None, :]
            t_l = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, **lib_kw))
            nbytes = (2 * q.numel() + k.numel() + v.numel()
                      ) * q.element_size()
            if mask is not None:
                nbytes += mask.numel() * mask.element_size()
            b_ms, b_by = bound_ms(
                _flash_flops(tb, h, causal, mask), nbytes,
                PEAK_BF16_FLOPS if dname == "bfloat16" else PEAK_F32_FLOPS)
            line += (f" kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
                     f"sdpa_ms={t_l:.4f} bound_ms={b_ms:.5f}({b_by}) {card}")
            if (dname, tb, h_kv, masked) == ("bfloat16", 2048, 6, False):
                rows["K1"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                  bound_ms=b_ms, bound_by=b_by)
            log(line)
            if not ok:
                raise AssertionError(f"K1 disagrees with its plain "
                                     f"version: {line}")
            rows.setdefault("K1_err", 0.0)
            rows["K1_err"] = max(rows["K1_err"], err)

    # K2 RMSNorm forward
    e = ents["K2"]
    rms, rms_plain = e.port_fn(), e.plain_fn()
    f = 768
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for n in (32, 2048, TRAIN_B * TRAIN_T):
            g = torch.Generator(device="cuda").manual_seed(n)
            x = torch.randn((n, f), generator=g, device="cuda").to(dt)
            gamma = (1 + 0.1 * torch.randn((f,), generator=g,
                                           device="cuda")).to(dt)
            out = rms(x, gamma)
            ref = rms_plain(x, gamma)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            if dname == "bfloat16":
                ulps = (diff / (ref.float().abs() * 2.0 ** -8 + 1e-3)
                        ).max().item()
                ok = ulps <= RMS_TOL_BF16_ULPS
                tol = f"max_ulps={ulps:.2f} tol={RMS_TOL_BF16_ULPS}ulps"
            else:
                ok = err <= RMS_TOL_F32
                tol = f"tol={RMS_TOL_F32:.0e}"
            ok = ok and bool(torch.isfinite(out).all())
            t_h = time_ms(lambda: rms(x, gamma))
            t_k = device_ms(lambda: rms(x, gamma))
            t_p = device_ms(lambda: rms_plain(x, gamma))
            t_l = device_ms(lambda: F.rms_norm(x, (f,), gamma, eps=1e-6))
            nbytes = (2 * x.numel() + f) * x.element_size()
            b_ms, b_by = bound_ms(4 * x.numel(), nbytes,
                                  PEAK_F32_FLOPS)
            line = (f"K2 rms {dname} rows={n} F={f}: max_abs_err={err:.3e}"
                    f" {tol} kernel_ms={t_k:.4f} host_ms={t_h:.4f} "
                    f"plain_ms={t_p:.4f} F.rms_norm_ms={t_l:.4f} "
                    f"bound_ms={b_ms:.5f}({b_by}) {card}")
            log(line)
            if not ok:
                raise AssertionError(f"K2 disagrees with its plain "
                                     f"version: {line}")
            if (dname, n) == ("bfloat16", 2048):
                rows["K2"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                  bound_ms=b_ms, bound_by=b_by)
            rows.setdefault("K2_err", 0.0)
            rows["K2_err"] = max(rows["K2_err"], err)
    _check_flash_bwd(ents["K3"], rows, card)
    _check_norm_bwd(ents["K6"], rows, card)
    _check_add_norm(ents["K7"], rows, card)
    state["kernel_rows"] = rows


def _rel_err(out, ref) -> float:
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def _flash_bwd_case(dt, b, t, h, h_kv, causal, masked, seed):
    """Inputs of one K3 case: q, k, v, the output gradient and the key
    mask, with the forward's out and lse from K1."""
    import torch
    from deeplearning4j_tpu_torch.ops.cuda_kernels import flash_attention
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda hh: torch.randn((b, t, hh, 128), generator=g,
                                device="cuda").to(dt)
    q, k, v, do = mk(h), mk(h_kv), mk(h_kv), mk(h)
    mask = None
    if masked:
        mask = (torch.rand((b, t), generator=g, device="cuda") > 0.3)
        mask[:, 0] = True
        mask = mask.float()
    out, lse = flash_attention(q, k, v, causal=causal, mask=mask,
                               return_lse=True)
    return q, k, v, out, lse, do, mask


def _check_flash_bwd(e, rows, card):
    """K3 against its plain version at [1, T, 6, 128]; then, at the
    training shape [16, 1024, 6, 128] bf16 causal, K1 with its lse and
    K3 against their plain versions, and K3 timed."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops.cuda_kernels import (
        flash_attention_reference)
    bwd, plain = e.port_fn(), e.plain_fn()
    cases = [(t, 6, True, False) for t in (200, 1024, 2048)]
    cases += [(2048, 2, True, False), (1024, 6, False, True)]
    err_max = 0.0
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for i, (t, h_kv, causal, masked) in enumerate(cases):
            q, k, v, out, lse, do, mask = _flash_bwd_case(
                dt, 1, t, 6, h_kv, causal, masked, 100 + i)
            got = bwd(q, k, v, out, lse, do, causal=causal, mask=mask)
            ref = plain(q, k, v, out, lse, do, causal=causal, mask=mask)
            torch.cuda.synchronize()
            errs = [(a.float() - r.float()).abs().max().item()
                    for a, r in zip(got, ref)]
            rels = [_rel_err(a, r) for a, r in zip(got, ref)]
            ok = (max(rels) <= K3_TOL[dname]
                  and all(bool(torch.isfinite(a).all()) for a in got))
            line = (f"K3 flash_bwd {dname} T={t} H=6 Hkv={h_kv} "
                    f"causal={causal} mask={masked}: max_abs_err(dq,dk,dv)"
                    f"={','.join(f'{x:.3e}' for x in errs)} rel="
                    f"{max(rels):.3e} tol={K3_TOL[dname]:.0e} {card}")
            log(line)
            if not ok:
                raise AssertionError(f"K3 disagrees with its plain "
                                     f"version: {line}")
            err_max = max(err_max, *errs)
    # the training path's shape: K1's out and lse, then K3 on them, held
    # against their plain versions, then timed
    b, t, h = TRAIN_B, TRAIN_T, 6
    q, k, v, out, lse, do, _ = _flash_bwd_case(torch.bfloat16, b, t, h, h,
                                               True, False, 7)
    ref_out, ref_lse = flash_attention_reference(q, k, v, causal=True,
                                                 return_lse=True)
    got = bwd(q, k, v, out, lse, do, causal=True)
    ref = plain(q, k, v, out, lse, do, causal=True)
    torch.cuda.synchronize()
    o_err = (out.float() - ref_out.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    errs = [(a.float() - r.float()).abs().max().item()
            for a, r in zip(got, ref)]
    rel = max(_rel_err(a, r) for a, r in zip(got, ref))
    line = (f"K1+K3 bfloat16 [{b},{t},{h},128] causal: K1 out "
            f"max_abs_err={o_err:.3e} tol={FLASH_TOL['bfloat16']:.0e} lse "
            f"max_abs_err={lse_err:.3e} tol={LSE_TOL:.0e}; K3 max_abs_err"
            f"(dq,dk,dv)={','.join(f'{x:.3e}' for x in errs)} rel="
            f"{rel:.3e} tol={K3_TOL['bfloat16']:.0e} {card}")
    log(line)
    finite = all(bool(torch.isfinite(x).all()) for x in (out, lse, *got))
    if not (o_err <= FLASH_TOL["bfloat16"] and lse_err <= LSE_TOL
            and rel <= K3_TOL["bfloat16"] and finite):
        raise AssertionError(f"K1 or K3 disagrees with its plain version "
                             f"at the training shape: {line}")
    del ref_out, ref_lse, ref
    rows["K1_err"] = max(rows["K1_err"], o_err)
    rows["K3_err"] = max(err_max, *errs)
    t_k = time_ms(lambda: bwd(q, k, v, out, lse, do, causal=True),
                  iters=10)
    t_p = time_ms(lambda: plain(q, k, v, out, lse, do, causal=True),
                  iters=3, warm=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        torch.autograd.grad(o, (qt, kt, vt), dot)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    t_l = device_ms(sdpa_fwd_bwd) - device_ms(sdpa_fwd)
    pairs = b * t * (t + 1) / 2
    flops = 5 * 2 * 128 * pairs * h
    nbytes = 8 * q.numel() * q.element_size() + lse.numel() * 4
    b_ms, b_by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"K3 flash_bwd bfloat16 [{b},{t},{h},128] causal: "
        f"kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
        f"sdpa_bwd_ms={t_l:.4f} bound_ms={b_ms:.5f}({b_by}) {card}")
    rows["K3"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                      bound_ms=b_ms, bound_by=b_by)


def _norm_inputs(dt, n, f, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, f), generator=g, device="cuda").to(dt)
    d = torch.randn((n, f), generator=g, device="cuda").to(dt)
    gamma = (1 + 0.1 * torch.randn((f,), generator=g,
                                   device="cuda")).to(dt)
    return x, d, gamma


def _ulps(out, ref) -> float:
    diff = (out.float() - ref.float()).abs()
    return (diff / (ref.float().abs() * 2.0 ** -8 + 1e-3)).max().item()


def _norm_shapes():
    return [(dname, n) for dname in ("bfloat16", "float32")
            for n in (TRAIN_B * TRAIN_T, 2048)]


def _check_norm_bwd(e, rows, card):
    """K6 against its plain version; yardstick: the backward of autograd
    through ``F.rms_norm``."""
    import torch
    import torch.nn.functional as F
    bwd, plain = e.port_fn(), e.plain_fn()
    f = 768
    for dname, n in _norm_shapes():
        x, dy, gamma = _norm_inputs(getattr(torch, dname), n, f, n + 1)
        got = bwd(x, gamma, dy)
        ref = plain(x, gamma, dy)
        torch.cuda.synchronize()
        err = max((a.float() - r.float()).abs().max().item()
                  for a, r in zip(got, ref))
        if dname == "bfloat16":
            ulps = max(_ulps(a, r) for a, r in zip(got, ref))
            ok = ulps <= K6_TOL_BF16_ULPS
            tol = f"max_ulps={ulps:.2f} tol={K6_TOL_BF16_ULPS}ulps"
        else:
            rel = max(_rel_err(a, r) for a, r in zip(got, ref))
            ok = rel <= K6_TOL_F32
            tol = f"rel={rel:.3e} tol={K6_TOL_F32:.0e}"
        ok = ok and all(bool(torch.isfinite(a).all()) for a in got)
        xr = x.detach().clone().requires_grad_()
        gr = gamma.detach().clone().requires_grad_()
        lib_fwd = lambda: F.rms_norm(xr, (f,), gr, eps=1e-6)
        t_h = time_ms(lambda: bwd(x, gamma, dy))
        t_k = device_ms(lambda: bwd(x, gamma, dy))
        t_p = device_ms(lambda: plain(x, gamma, dy))
        t_l = (device_ms(lambda: torch.autograd.grad(lib_fwd(), (xr, gr),
                                                     dy))
               - device_ms(lib_fwd))
        nbytes = (3 * x.numel() + 2 * f) * x.element_size()
        b_ms, b_by = bound_ms(10 * x.numel(), nbytes, PEAK_F32_FLOPS)
        line = (f"K6 rms_bwd {dname} rows={n} F={f}: max_abs_err="
                f"{err:.3e} {tol} kernel_ms={t_k:.4f} host_ms={t_h:.4f} "
                f"plain_ms={t_p:.4f} F.rms_norm_bwd_ms={t_l:.4f} "
                f"bound_ms={b_ms:.5f}({b_by}) {card}")
        log(line)
        if not ok:
            raise AssertionError(f"K6 disagrees with its plain version: "
                                 f"{line}")
        if (dname, n) == ("bfloat16", TRAIN_B * TRAIN_T):
            rows["K6"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                              bound_ms=b_ms, bound_by=b_by)
        rows["K6_err"] = max(rows.get("K6_err", 0.0), err)


def _check_add_norm(e, rows, card):
    """K7 against its plain version; yardstick: ``x + d`` then
    ``F.rms_norm``. The stored sum must equal the plain one exactly (one
    rounding of the same f32 sum)."""
    import torch
    import torch.nn.functional as F
    fused, plain = e.port_fn(), e.plain_fn()
    f = 768
    for dname, n in _norm_shapes():
        x, d, gamma = _norm_inputs(getattr(torch, dname), n, f, n + 2)
        y, s = fused(x, d, gamma)
        ry, rs = plain(x, d, gamma)
        torch.cuda.synchronize()
        err = (y.float() - ry.float()).abs().max().item()
        s_err = (s.float() - rs.float()).abs().max().item()
        if dname == "bfloat16":
            ulps = _ulps(y, ry)
            ok = ulps <= RMS_TOL_BF16_ULPS
            tol = f"max_ulps={ulps:.2f} tol={RMS_TOL_BF16_ULPS}ulps"
        else:
            ok = err <= RMS_TOL_F32
            tol = f"tol={RMS_TOL_F32:.0e}"
        ok = ok and s_err == 0 and bool(torch.isfinite(y).all())
        t_h = time_ms(lambda: fused(x, d, gamma))
        t_k = device_ms(lambda: fused(x, d, gamma))
        t_p = device_ms(lambda: plain(x, d, gamma))
        t_l = device_ms(lambda: F.rms_norm(x + d, (f,), gamma, eps=1e-6))
        nbytes = (4 * x.numel() + f) * x.element_size()
        b_ms, b_by = bound_ms(5 * x.numel(), nbytes, PEAK_F32_FLOPS)
        line = (f"K7 add_rms {dname} rows={n} F={f}: max_abs_err="
                f"{err:.3e} sum_err={s_err:.1e} {tol} kernel_ms={t_k:.4f}"
                f" host_ms={t_h:.4f} plain_ms={t_p:.4f} "
                f"add+F.rms_norm_ms={t_l:.4f} bound_ms={b_ms:.5f}({b_by})"
                f" {card}")
        log(line)
        if not ok:
            raise AssertionError(f"K7 disagrees with its plain version: "
                                 f"{line}")
        if (dname, n) == ("bfloat16", TRAIN_B * TRAIN_T):
            rows["K7"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                              bound_ms=b_ms, bound_by=b_by)
        rows["K7_err"] = max(rows.get("K7_err", 0.0), err)


# -- phase 3 ---------------------------------------------------------------
def phase_serve(state):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.obs import metrics
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.serving.gateway import ServingGateway
    from deeplearning4j_tpu_torch.zoo.gpt import (CausalTransformerLM,
                                                  prompt_bucket)
    card = state["card"]
    model = CausalTransformerLM(compute_dtype="bfloat16", **SERVE)
    params = model.init_params(seed=0, device="cuda")
    gw = ServingGateway(model, params, max_slots=32, block=16,
                        max_context=2048, queue_limit=64,
                        default_max_new=64)
    try:
        t0 = time.perf_counter()
        warm = gw.warmup()
        log(f"serve: warmup buckets={warm['buckets']} "
            f"{time.perf_counter() - t0:.1f}s")
        rng = np.random.default_rng(0)
        lens = rng.integers(16, 1501, size=32)
        buckets = [prompt_bucket(int(t), 2048) for t in lens]
        assert buckets.count(1024) >= 3 and buckets.count(2048) >= 3, \
            buckets
        prompts = [rng.integers(0, model.vocab_size, int(t)) for t in lens]
        step0 = metrics.SERVING_STEP.snapshot()[""]
        pre0 = metrics.SERVING_PREFILL.snapshot()[""]
        gw.pause()
        for e in kernel_registry.ported():
            e.reset()
        serve_kernels = kernel_registry.on_path("serve")
        t_start = time.perf_counter()
        streams = [gw.submit(p, max_new=64) for p in prompts]
        gw.resume()
        outs = [st.result(timeout=600) for st in streams]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        launches = {e.key: e.launches() for e in kernel_registry.ported()}
        for p, st, o in zip(prompts, streams, outs):
            gen = o[len(p):]
            assert st.error() is None
            assert gen.shape == (64,), gen.shape
            assert ((gen >= 0) & (gen < model.vocab_size)).all()
        sched = gw._sched
        sched.pager.check_invariants()
        assert sched.pager.free_pages() == sched.pager.n_pages - 1
        for e in serve_kernels:
            assert launches[e.key] > 0, \
                f"{e.key} was never launched by the serving run"
        step1 = metrics.SERVING_STEP.snapshot()[""]
        pre1 = metrics.SERVING_PREFILL.snapshot()[""]
        n_steps = step1["count"] - step0["count"]
        step_ms = (step1["sum"] - step0["sum"]) / n_steps * 1e3
        prefill_ms = ((pre1["sum"] - pre0["sum"])
                      / (pre1["count"] - pre0["count"]) * 1e3)
        ttft = sorted(st.ttft_s for st in streams)
        tokens = 64 * len(streams)
        state.setdefault("launches", {})["serve"] = launches
        log(f"serve: requests={len(streams)} aborted=0 "
            f"buckets={sorted(set(buckets))} p50_ttft_s="
            f"{ttft[len(ttft) // 2]:.4f} max_ttft_s={ttft[-1]:.4f} "
            f"tokens_per_s={tokens / wall:.1f} wall_s={wall:.3f} "
            f"steps={n_steps} mean_step_ms={step_ms:.3f} "
            f"mean_prefill_ms={prefill_ms:.3f} {card}")
        log(f"serve: launches {launches} (K1 expects 12 per admission "
            f"= {12 * len(streams)}; K2 25 per admission and per step "
            f"= {25 * (len(streams) + n_steps)}) {card}")
        # the first non-kernel hot spot: the paged step's full page-table
        # gather, timed alone at the step's shape, against the step
        (pool,) = sched.pager.pool
        pt = torch.randint(1, sched.pager.n_pages,
                           (32, sched.max_pages_per_seq), device="cuda")
        hd2 = 2 * (model.hidden // model.n_heads)
        gather_ms = time_ms(lambda: pool[0, pt].permute(0, 2, 3, 1, 4)
                            .reshape(32, model.n_kv_heads, hd2, -1))
        log(f"serve: paged gather per layer ms={gather_ms:.4f} x12 = "
            f"{12 * gather_ms:.3f} ms = "
            f"{100 * 12 * gather_ms / step_ms:.1f}% of the mean step "
            f"{card}")
    finally:
        gw.shutdown(drain=False)


# -- phase 4 ---------------------------------------------------------------
def phase_agree(state):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    torch.backends.cuda.matmul.allow_tf32 = False
    model = CausalTransformerLM(**SERVE)         # float32
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, model.vocab_size, 300)
    forced = rng.integers(0, model.vocab_size, 8)
    results = {}
    for dev in ("cuda", "cpu"):
        params = model.init_params(seed=1, device=dev)
        toks = torch.zeros((1, 512), dtype=torch.int64, device=dev)
        toks[0, :300] = torch.as_tensor(prompt, device=dev)
        with torch.no_grad():
            logits, caches = model._prefill_forward(params, toks, 512 + 8,
                                                    300)
            seq = [logits.float().cpu()]
            for i, tok in enumerate(forced):
                logits, caches = model._token_logits(
                    params, torch.as_tensor([int(tok)], device=dev),
                    caches, 300 + i, 1)
                seq.append(logits.float().cpu())
        results[dev] = torch.stack(seq)
        del params, caches
    err = (results["cuda"] - results["cpu"]).abs().max().item()
    same = (results["cuda"].argmax(-1) == results["cpu"].argmax(-1)).all()
    log(f"agree: f32 prefill + 8 decode logits card vs CPU "
        f"max_abs_err={err:.3e} tol={AGREE_TOL:.0e} argmax_equal="
        f"{bool(same)} {state['card']}")
    if not (err <= AGREE_TOL and same):
        raise AssertionError("card and CPU logits disagree")


# -- phase 5 ---------------------------------------------------------------
def _train_batch(seed: int, b: int, t: int, vocab: int):
    """Random tokens from ``np.random.default_rng(seed)``: inputs and
    their next-token labels, [b, t] int32 each."""
    import numpy as np
    toks = np.random.default_rng(seed).integers(0, vocab, (b, t + 1))
    return (toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32))


def phase_train(state):
    import math
    import torch
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    card = state["card"]
    model = CausalTransformerLM(compute_dtype="bfloat16", **TRAIN)
    t0 = time.perf_counter()
    net = model.init(TRAIN_T)
    x, y = _train_batch(0, TRAIN_B, TRAIN_T, model.vocab_size)
    log(f"train: init {net.num_params()} params "
        f"{time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(2):                       # warm steps
        net.fit(x, y)
        losses.append(net.score())
    for e in kernel_registry.ported():
        e.reset()
    torch.cuda.synchronize()
    steps = 8
    t_start = time.perf_counter()
    for _ in range(steps):
        net.fit(x, y)                        # ends in a device sync
        losses.append(net.score())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {e.key: e.launches() for e in kernel_registry.ported()}
    state.setdefault("launches", {})["train"] = launches
    step_ms = wall / steps * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train: losses {' '.join(f'{l:.4f}' for l in losses)} {card}")
    log(f"train: B={TRAIN_B} T={TRAIN_T} steps={steps} mean_step_ms="
        f"{step_ms:.3f} tokens_per_s={TRAIN_B * TRAIN_T / wall * steps:.1f}"
        f" max_memory_allocated_gb={peak_gb:.3f} {card}")
    per_step = {e.key: e.train_per_step
                for e in kernel_registry.on_path("train")}
    log(f"train: launches over {steps} steps {launches} (per step "
        f"expected {per_step}) {card}")
    assert all(math.isfinite(l) for l in losses), losses
    assert losses[-1] < losses[0], losses
    for key, n in per_step.items():
        want = steps * n
        assert launches[key] == want, \
            f"{key}: {launches[key]} launches in {steps} steps, " \
            f"expected {want}"


# -- phase 6 ---------------------------------------------------------------
def phase_train_agree(state):
    import torch
    from deeplearning4j_tpu_torch import tree
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = CausalTransformerLM(**TRAIN)         # float32
    x, y = _train_batch(1, 2, 256, model.vocab_size)
    results = {}
    for dev in ("cuda", "cpu"):
        net = model.init(256, device=dev)
        loss, grads, _ = net._loss_and_grads(
            torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))
        results[dev] = (loss.item(), tree.map_(lambda g: g.cpu(), grads))
        del net, grads
    (l_card, g_card), (l_cpu, g_cpu) = results["cuda"], results["cpu"]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    rels = tree.map_with_path(
        lambda path, a, b: (_rel_err(a, b), ".".join(path)), g_card, g_cpu)
    worst, worst_key = max(tree.leaves(rels))
    log(f"train_agree: f32 B=2 T=256 one step, card vs CPU: loss "
        f"{l_card:.6f} vs {l_cpu:.6f} rel={loss_rel:.3e} "
        f"tol={TRAIN_LOSS_RTOL:.0e}; worst gradient {worst_key} "
        f"max|d|/max|g|={worst:.3e} tol={TRAIN_GRAD_TOL:.0e} "
        f"{state['card']}")
    if not (loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_TOL):
        raise AssertionError("card and CPU training step disagree")


def _wall_ms(fn) -> float:
    """Host-clock time of ``fn``, from a synchronised card to a
    synchronised card."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _device_window(name: str, fn, wall_ms: float, card: str) -> None:
    """Run ``fn`` under ``torch.profiler`` and sum the device time of
    every kernel, memcpy and memset (user-annotation ranges are not
    counted). Prints the busy time, its idle share of ``wall_ms`` (an
    unprofiled run of the same work) and the ten largest device items by
    name."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    count = collections.Counter()
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name] += e.device_time_total / 1e3
            count[e.name] += 1
    busy = sum(by_name.values())
    log(f"profile {name}: wall_ms={wall_ms:.3f} device_busy_ms={busy:.3f}"
        f" idle_share={1 - busy / wall_ms:.3f} {card}")
    for key, ms in by_name.most_common(10):
        log(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}% x{count[key]:<5d} "
            f"{key[:90]}")


def phase_profile(state):
    """Device-time breakdown of the serving path — the prefill of the
    longest prompt (bucket 2048), then 8 decode steps with all 32 slots
    active — and of one training step of the train phase's model and
    batch. Every wall time is taken before the first profiled window,
    and the decode window's once more after the last one: a host-bound
    step ran slower after the kernels phase, and this shows whether
    profiling alone does that."""
    import numpy as np
    from deeplearning4j_tpu_torch.serving.gateway import TokenStream
    from deeplearning4j_tpu_torch.serving.scheduler import DecodeScheduler
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    card = state["card"]
    model = CausalTransformerLM(compute_dtype="bfloat16", **SERVE)
    params = model.init_params(seed=0, device="cuda")
    sched = DecodeScheduler(model, params, max_slots=32, block=16,
                            max_context=2048)
    sched.warmup()
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 1501, size=32)
    prompts = [rng.integers(0, model.vocab_size, int(t)) for t in lens]
    stream = lambda i: TokenStream(prompts[i], 64, "profile", None, None,
                                   None)
    reqs = [stream(i) for i in range(len(prompts))]
    first, *rest = list(np.argsort(-lens))
    for i in rest:
        sched.admit(reqs[i])
    tmodel = CausalTransformerLM(compute_dtype="bfloat16", **TRAIN)
    net = tmodel.init(TRAIN_T)
    x, y = _train_batch(0, TRAIN_B, TRAIN_T, tmodel.vocab_size)
    for _ in range(2):
        net.fit(x, y)
    decode = lambda: [sched.step() for _ in range(8)]
    train_step = lambda: net.fit(x, y)
    walls = {"prefill": _wall_ms(lambda: sched.admit(reqs[first])),
             "decode": _wall_ms(decode), "train": _wall_ms(train_step)}
    sched.evict(reqs[first])            # its slot and pages, once more
    _device_window(f"prefill t0={lens[first]} (bucket 2048)",
                   lambda: sched.admit(stream(first)), walls["prefill"],
                   card)
    _device_window("8 decode steps x 32 slots", decode, walls["decode"],
                   card)
    _device_window(f"train step B={TRAIN_B} T={TRAIN_T}", train_step,
                   walls["train"], card)
    log(f"profile: 8 decode steps x 32 slots wall_ms before any profiling"
        f"={walls['decode']:.3f}, after it={_wall_ms(decode):.3f} {card}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list from {PHASES + ('profile',)}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one NVIDIA "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import deeplearning4j_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from a checkout of the repository "
              "(deeplearning4j_tpu_torch not found)", file=sys.stderr)
        return 2
    state = {}
    phase_device(state)
    _build_all()
    for name in phases:
        if name == "device":
            continue
        t0 = time.perf_counter()
        log(f"== phase {name}")
        try:
            globals()[f"phase_{name}"](state)
        except Exception as e:
            import traceback
            traceback.print_exc()
            print(f"chip_smoke: phase {name} FAILED: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            return 1
        log(f"== phase {name} ok ({time.perf_counter() - t0:.1f}s)")
    if "kernels" in phases and state.get("launches"):
        from deeplearning4j_tpu_torch.ops import kernel_registry
        rows = state["kernel_rows"]
        ran = state["launches"]              # path -> {key: launches}
        kernels = []
        for e in kernel_registry.ported():
            r = rows[e.key]
            by_path = {p: ran[p][e.key] for p in e.paths if p in ran}
            kernels.append({
                "name": e.name, "route": e.route, "source": e.source,
                "replaces": e.replaces,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": rows[f"{e.key}_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": state["kind"],
        "count": state["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
