#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py               # phases 1-4 (needs one card)
    python3 chip_smoke.py --phases kernels
    python3 chip_smoke.py --phases profile    # device-time breakdown

Drives ``deeplearning4j_tpu_torch`` (never JAX, never the JAX package):

1. device — card name, count, and ``nvidia-smi`` name/power limit;
2. kernels — builds every ported kernel of ``ops/kernel_registry.py``
   from the checkout's sources (one ``nvcc`` per CUDA source, all
   started together), then holds each against its plain PyTorch version
   on the card at the serving path's shapes, in bfloat16 and float32,
   and times the kernel, the plain version and a PyTorch library call
   that computes the same function (a yardstick the port never calls);
3. serve — the full-width GPT-2-small-class LM (vocab 50257, hidden 768,
   12 layers, 6 heads of 128, SwiGLU 8/3, tied embeddings, bfloat16,
   random weights from a seed) behind ``ServingGateway(max_slots=32,
   block=16, max_context=2048)``: 32 seeded requests, prompts of 16 to
   1500 tokens, 64 new tokens each. Every kernel's launch counter is
   zeroed just before the requests and read just after;
4. agree — the same model in float32: the card's prefill logits and 8
   teacher-forced decode steps against the port on the CPU (the plain
   versions), for one 300-token prompt.

``profile`` (not in the default run) prints the device busy time, idle
share and top kernels of one 2048-bucket prefill and of 8 decode steps
with 32 active slots, from ``torch.profiler``.

Any failed phase exits non-zero before the result lines. The last two
lines are the ``kernels`` JSON object and the device JSON object.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time

PHASES = ("device", "kernels", "serve", "agree")

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
AGREE_TOL = 2e-3     # f32 logits, card vs CPU, 12 layers deep

SERVE = dict(vocab_size=50257, hidden=768, n_layers=12, n_heads=6,
             max_len=2048, ffn_mult=8 / 3, tie_embeddings=True)


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
    _build_all()
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
            t_p = time_ms(lambda: plain(q, k, v, causal=causal, mask=mask),
                          iters=5)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib_kw = {"enable_gqa": True} if h != h_kv else {}
            if mask is not None:
                lib_kw["attn_mask"] = mask.bool()[:, None, None, :]
            t_l = time_ms(lambda: F.scaled_dot_product_attention(
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
        for n in (32, 1024, 2048):
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
            t_k = time_ms(lambda: rms(x, gamma))
            t_p = time_ms(lambda: rms_plain(x, gamma))
            t_l = time_ms(lambda: F.rms_norm(x, (f,), gamma, eps=1e-6))
            nbytes = (2 * x.numel() + f) * x.element_size()
            b_ms, b_by = bound_ms(4 * x.numel(), nbytes,
                                  PEAK_F32_FLOPS)
            line = (f"K2 rms {dname} rows={n} F={f}: max_abs_err={err:.3e}"
                    f" {tol} kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
                    f"F.rms_norm_ms={t_l:.4f} bound_ms={b_ms:.5f}({b_by})"
                    f" {card}")
            log(line)
            if not ok:
                raise AssertionError(f"K2 disagrees with its plain "
                                     f"version: {line}")
            if (dname, n) == ("bfloat16", 2048):
                rows["K2"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                  bound_ms=b_ms, bound_by=b_by)
            rows.setdefault("K2_err", 0.0)
            rows["K2_err"] = max(rows["K2_err"], err)
    state["kernel_rows"] = rows


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
        for key, n in launches.items():
            assert n > 0, f"{key} was never launched by the serving run"
        step1 = metrics.SERVING_STEP.snapshot()[""]
        pre1 = metrics.SERVING_PREFILL.snapshot()[""]
        n_steps = step1["count"] - step0["count"]
        step_ms = (step1["sum"] - step0["sum"]) / n_steps * 1e3
        prefill_ms = ((pre1["sum"] - pre0["sum"])
                      / (pre1["count"] - pre0["count"]) * 1e3)
        ttft = sorted(st.ttft_s for st in streams)
        tokens = 64 * len(streams)
        state["launches"] = launches
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


def _device_window(name: str, fn, card: str) -> None:
    """Run ``fn`` twice on work of the same shape: once on the host
    clock alone (the wall time), once under ``torch.profiler`` (the
    device time of every kernel, memcpy and memset; user-annotation
    ranges are not counted). Prints the busy time, the idle share of
    the wall and the ten largest device items by name."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
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
    """Device-time breakdown of the serving path: prefills of the two
    longest prompts (bucket 2048), then 2 x 8 decode steps with all 32
    slots active."""
    import numpy as np
    from deeplearning4j_tpu_torch.serving.gateway import TokenStream
    from deeplearning4j_tpu_torch.serving.scheduler import DecodeScheduler
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    model = CausalTransformerLM(compute_dtype="bfloat16", **SERVE)
    params = model.init_params(seed=0, device="cuda")
    sched = DecodeScheduler(model, params, max_slots=32, block=16,
                            max_context=2048)
    sched.warmup()
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 1501, size=32)
    reqs = [TokenStream(rng.integers(0, model.vocab_size, int(t)), 64,
                        "profile", None, None, None) for t in lens]
    order = list(np.argsort(-lens))
    longest = iter(order[:2])
    _device_window(f"prefill t0={lens[order[0]]},{lens[order[1]]} "
                   "(bucket 2048)", lambda: sched.admit(reqs[next(longest)]),
                   state["card"])
    for i in order[2:]:
        sched.admit(reqs[i])
    _device_window("8 decode steps x 32 slots",
                   lambda: [sched.step() for _ in range(8)],
                   state["card"])


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
    if "kernels" in phases and "serve" in phases:
        from deeplearning4j_tpu_torch.ops import kernel_registry
        rows = state["kernel_rows"]
        kernels = []
        for e in kernel_registry.ported():
            r = rows[e.key]
            kernels.append({
                "name": e.name, "route": e.route, "source": e.source,
                "replaces": e.replaces,
                "launches": state["launches"][e.key],
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
