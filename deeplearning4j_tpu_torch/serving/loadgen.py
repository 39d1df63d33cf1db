"""Synthetic serving load generator — open/closed-loop multi-tenant
traffic.

Port of ``deeplearning4j_tpu/serving/loadgen.py``: generates sustained
multi-tenant traffic against a :class:`~deeplearning4j_tpu_torch.
serving.gateway.ServingGateway`, reports the serving SLO quartet —
p50/p99 TTFT, per-token latency, aggregate tokens/sec, shed rate — and
compares against the request-at-a-time baseline (sequential B=1
``generate()`` calls). Everything it measures client-side also
flows through the ``dl4j_tpu_serving_*`` families.

Three load models:

- **open loop**: arrivals are a seeded Poisson process at ``rate``
  req/s regardless of completions (overload shows up as shed rate and
  TTFT tail);
- **closed loop**: ``clients`` concurrent callers each submit, wait,
  and immediately resubmit (sustainable throughput at a fixed
  concurrency);
- **burst**: every request submitted up front from ONE thread while the
  gateway's worker is parked, then collected — the saturation
  throughput (later requests' TTFT includes their real queue wait).

:func:`smoke_report` and :func:`shared_prefix_report` build their small
model on the device the caller names — the card by default.
"""
from __future__ import annotations

import argparse
import json
import random
import threading
import time
from typing import Any, Dict, Optional

import numpy as np


def _pct(vals, q):
    return float(np.percentile(np.asarray(vals), q)) if vals else None


def gen_requests(*, n_requests: int, tenants=("tenant0", "tenant1"),
                 prompt_lens=(8, 48), max_new: int = 32,
                 vocab_size: int = 256, seed: int = 0):
    """Deterministic synthetic request list: per-request tenant, prompt
    (uniform length in ``prompt_lens`` bounds), token budget — the JAX
    package's list for the same arguments."""
    rng = np.random.default_rng(seed)
    lo, hi = prompt_lens
    out = []
    for i in range(n_requests):
        t0 = int(rng.integers(lo, hi + 1))
        out.append({
            "tenant": tenants[i % len(tenants)],
            "prompt": rng.integers(0, vocab_size, t0).astype(np.int32),
            "max_new": max_new,
        })
    return out


def gen_shared_prefix_requests(*, n_requests: int,
                               tenants=("tenant0", "tenant1"),
                               prefix_len: int = 96,
                               suffix_lens=(2, 8), max_new: int = 32,
                               vocab_size: int = 256, seed: int = 0):
    """The multi-tenant SHARED-PREFIX trace: every request carries the
    same long system prompt (``prefix_len`` tokens) followed by a short
    per-request user suffix — the traffic where copy-on-write prefix
    sharing pays (admission cost goes with the suffix, not the prompt).
    Deterministic per seed, and the JAX package's list for the same
    arguments."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab_size, prefix_len).astype(np.int32)
    lo, hi = suffix_lens
    out = []
    for i in range(n_requests):
        sfx = rng.integers(
            0, vocab_size, int(rng.integers(lo, hi + 1))).astype(np.int32)
        out.append({
            "tenant": tenants[i % len(tenants)],
            "prompt": np.concatenate([system, sfx]),
            "max_new": max_new,
        })
    return out


def run_trace(gateway, requests, *, mode: str = "closed",
              rate: float = 50.0, clients: int = 8,
              deadline_s: Optional[float] = None,
              timeout_s: float = 120.0, seed: int = 0
              ) -> Dict[str, Any]:
    """Drive ``requests`` through ``gateway`` under the given load model
    (``"open"``, ``"closed"`` or ``"burst"``) and gather the SLO stats.
    Returns the stats dict (the JAX package's keys)."""
    from deeplearning4j_tpu_torch.obs import metrics as M
    from deeplearning4j_tpu_torch.parallel.inference import QueueFullError

    lock = threading.Lock()
    streams: list = []
    shed = [0]
    submit_errors = [0]
    # the histograms and counters are process-cumulative: snapshot so
    # THIS trace's numbers are not polluted by earlier gateways
    step0 = dict(M.SERVING_STEP.snapshot().get("", {}))
    hits0 = M.SERVING_PREFIX_HITS.snapshot().get("", 0)
    saved0 = M.SERVING_PREFIX_SAVED.snapshot().get("", 0)
    acc0 = dict(M.SERVING_SPEC_ACCEPT.snapshot().get("", {}))
    t_bench0 = time.perf_counter()

    def submit(r):
        try:
            st = gateway.submit(r["prompt"], max_new=r["max_new"],
                                tenant=r["tenant"], deadline_s=deadline_s)
            with lock:
                streams.append(st)
            return st
        except QueueFullError:
            with lock:
                shed[0] += 1
            return None
        except Exception:
            # any other submit rejection (trace vs pool limits, a
            # shutdown race) is COUNTED, so the report cannot read as a
            # clean run, and never kills a client thread
            with lock:
                submit_errors[0] += 1
            return None

    def collect():
        for st in list(streams):
            try:
                st.result(timeout=timeout_s)
            except Exception:
                pass

    if mode == "burst":
        # park the worker while the queue is stuffed, so the first
        # admission sweep sees every request at once
        paused = hasattr(gateway, "pause") and gateway.pause()
        for req in requests:
            submit(req)
        if paused:
            gateway.resume()
        collect()
    elif mode == "open":
        # seeded Poisson arrivals: exponential gaps at `rate` req/s,
        # submissions never wait on completions
        r = random.Random(seed)
        for req in requests:
            submit(req)
            time.sleep(r.expovariate(rate))
        collect()
    elif mode == "closed":
        work = list(requests)

        def client():
            while True:
                with lock:
                    if not work:
                        return
                    req = work.pop()
                st = submit(req)
                if st is not None:
                    try:
                        st.result(timeout=timeout_s)
                    except Exception:
                        pass
        threads = [threading.Thread(target=client)
                   for _ in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout_s + 30)
    else:
        raise ValueError(f"mode={mode!r} (open | closed | burst)")
    wall = time.perf_counter() - t_bench0

    ttfts, completed, failed, tokens = [], 0, 0, 0
    for st in streams:
        tokens += st.n_generated()
        if st.ttft_s is not None:
            ttfts.append(st.ttft_s)
        if st.error() is not None:
            failed += 1
        elif st.done():
            completed += 1
    # per-token latency from the gateway's own step histogram (this
    # trace's delta)
    step1 = M.SERVING_STEP.snapshot().get("", {})
    d_count = step1.get("count", 0) - step0.get("count", 0)
    d_sum = step1.get("sum", 0.0) - step0.get("sum", 0.0)
    per_token_ms = 1e3 * d_sum / d_count if d_count else None
    # prefix-sharing / spec-decode deltas (zero / None on a gateway
    # running without them)
    hits = M.SERVING_PREFIX_HITS.snapshot().get("", 0) - hits0
    saved = M.SERVING_PREFIX_SAVED.snapshot().get("", 0) - saved0
    acc1 = M.SERVING_SPEC_ACCEPT.snapshot().get("", {})
    da_count = acc1.get("count", 0) - acc0.get("count", 0)
    da_sum = acc1.get("sum", 0.0) - acc0.get("sum", 0.0)
    return {
        "mode": mode,
        "requests": len(requests),
        "submitted": len(streams),
        "shed_at_submit": shed[0],
        "submit_errors": submit_errors[0],
        "completed": completed,
        "failed": failed,
        "tokens": tokens,
        "wall_s": round(wall, 3),
        "tokens_per_sec": round(tokens / wall, 2) if wall > 0 else None,
        "ttft_p50_ms": (round(1e3 * _pct(ttfts, 50), 3)
                        if ttfts else None),
        "ttft_p99_ms": (round(1e3 * _pct(ttfts, 99), 3)
                        if ttfts else None),
        "per_token_mean_ms": (round(per_token_ms, 3)
                              if per_token_ms else None),
        "shed_rate": round(shed[0] / max(1, len(requests)), 4),
        "prefix_hit_rate": (round(hits / len(streams), 4)
                            if streams else None),
        "prefill_tokens_saved": int(saved),
        "spec_accept_rate": (round(da_sum / da_count, 4)
                             if da_count else None),
    }


def baseline_tokens_per_sec(model, params, requests,
                            repeat: int = 1) -> float:
    """Request-at-a-time baseline: each request is one B=1
    ``generate()`` call, sequential — the serving the gateway replaces.
    ``params`` (or a ``MultiLayerNetwork``) sits on the device that
    decodes. Call once before timing, so kernels are built."""
    t0 = time.perf_counter()
    tokens = 0
    for _ in range(repeat):
        for r in requests:
            model.generate(params, r["prompt"][None], n_new=r["max_new"])
            tokens += r["max_new"]
    return tokens / (time.perf_counter() - t0)


def _smoke_model(max_len: int):
    """The reports' small weight-read-bound LM (h=256, 4 layers, GQA)."""
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    return CausalTransformerLM(vocab_size=512, hidden=256, n_layers=4,
                               n_heads=4, n_kv_heads=2, max_len=max_len,
                               seed=3)


def smoke_report(n_requests: int = 32, max_new: int = 32,
                 max_slots: int = 16, device="cuda") -> Dict[str, Any]:
    """The JAX package's smoke config on ``device``: a small LM, a
    burst multi-tenant trace, continuous vs request-at-a-time
    tokens/sec. (The JAX report's retrace count has no counterpart
    until the port has a compile lifecycle; the warmup report stands in
    its place.)"""
    from deeplearning4j_tpu_torch.serving.gateway import ServingGateway

    model = _smoke_model(128)
    params = model.init_params(device=device)
    requests = gen_requests(n_requests=n_requests, max_new=max_new,
                            prompt_lens=(4, 28),
                            vocab_size=model.vocab_size, seed=1)
    # a first baseline pass builds the kernels (excluded: both sides are
    # measured warm)
    baseline_tokens_per_sec(model, params, requests)
    base_tps = baseline_tokens_per_sec(model, params, requests)
    gw = ServingGateway(model, params, max_slots=max_slots, block=16,
                        max_context=64, queue_limit=n_requests + 8,
                        default_max_new=max_new)
    warm = gw.warmup(prompt_lens=range(1, 29))
    stats = run_trace(gw, requests, mode="burst")
    gw.shutdown()
    cont_tps = stats["tokens_per_sec"] or 0.0
    return {
        "model": f"causal-LM v512 L4 h256 ({device})",
        "n_requests": n_requests,
        "max_new": max_new,
        "max_slots": max_slots,
        "continuous_tokens_per_sec": round(cont_tps, 2),
        "request_at_a_time_tokens_per_sec": round(base_tps, 2),
        "speedup": round(cont_tps / base_tps, 3) if base_tps else None,
        "ttft_p50_ms": stats["ttft_p50_ms"],
        "ttft_p99_ms": stats["ttft_p99_ms"],
        "per_token_mean_ms": stats["per_token_mean_ms"],
        "shed_rate": stats["shed_rate"],
        "completed": stats["completed"],
        "failed": stats["failed"],
        "warmup": warm,
    }


def shared_prefix_report(n_requests: int = 32, prefix_len: int = 216,
                         max_new: int = 16, max_slots: int = 32,
                         spec_k: int = 4, device="cuda"
                         ) -> Dict[str, Any]:
    """The JAX package's shared-prefix measurement on ``device``: one
    long system prompt, short user suffixes
    (:func:`gen_shared_prefix_requests`), two gateways — A: no sharing,
    single-token decode; B: prefix sharing + speculative decode. Reports
    the A-vs-B p50 TTFT and tokens/sec ratios, the prefix-hit rate, the
    prefill tokens saved and the spec accept rate (each gateway's best
    of two burst trials)."""
    from deeplearning4j_tpu_torch.serving.gateway import ServingGateway

    model = _smoke_model(256)
    params = model.init_params(device=device)
    requests = gen_shared_prefix_requests(
        n_requests=n_requests, prefix_len=prefix_len, suffix_lens=(2, 8),
        max_new=max_new, vocab_size=model.vocab_size, seed=1)
    hi = max(len(r["prompt"]) for r in requests)
    mc = min(model.max_len, ((hi + max_new + 15) // 16 + 1) * 16)

    def run(trials=2, **kw):
        gw = ServingGateway(model, params, max_slots=max_slots, block=16,
                            max_context=mc, queue_limit=n_requests + 8,
                            default_max_new=max_new, **kw)
        warm = gw.warmup(prompt_lens=range(1, hi + 1))
        runs = [run_trace(gw, requests, mode="burst")
                for _ in range(trials)]
        stats = min(runs, key=lambda s: s["ttft_p50_ms"] or 1e18)
        stats["ttft_p50_ms"] = min(s["ttft_p50_ms"] for s in runs
                                   if s["ttft_p50_ms"])
        stats["tokens_per_sec"] = max(s["tokens_per_sec"] for s in runs
                                      if s["tokens_per_sec"])
        stats["trials"] = trials
        stats["warmup"] = warm
        gw.shutdown()
        return stats

    base = run()
    both = run(prefix_sharing=True, spec_k=spec_k)
    b_ttft, s_ttft = base["ttft_p50_ms"], both["ttft_p50_ms"]
    b_tps, s_tps = base["tokens_per_sec"], both["tokens_per_sec"]
    return {
        "model": f"causal-LM v512 L4 h256 ({device})",
        "n_requests": n_requests,
        "prefix_len": prefix_len,
        "max_new": max_new,
        "max_slots": max_slots,
        "spec_k": spec_k,
        "baseline_ttft_p50_ms": b_ttft,
        "shared_ttft_p50_ms": s_ttft,
        "ttft_speedup": (round(b_ttft / s_ttft, 3)
                         if b_ttft and s_ttft else None),
        "baseline_tokens_per_sec": b_tps,
        "shared_tokens_per_sec": s_tps,
        "tokens_per_sec_speedup": (round(s_tps / b_tps, 3)
                                   if b_tps and s_tps else None),
        "prefix_hit_rate": both["prefix_hit_rate"],
        "prefill_tokens_saved": both["prefill_tokens_saved"],
        "spec_accept_rate": both["spec_accept_rate"],
        "completed": both["completed"],
        "failed": both["failed"],
    }


# The JAX package's ``subprocess_report`` runs these reports in a fresh
# process forced onto JAX's CPU backend, so a benchmark on another
# backend can call them. The port names the device instead
# (``device=``), so it has no counterpart.


def _main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shared-prefix", action="store_true",
                    help="run shared_prefix_report (else smoke_report)")
    ap.add_argument("--device", default="cuda",
                    help="device of the model and the pool (default: "
                         "cuda)")
    args = ap.parse_args(argv)
    report = shared_prefix_report if args.shared_prefix else smoke_report
    print(json.dumps(report(device=args.device)), flush=True)


if __name__ == "__main__":
    _main()
