"""The compile lifecycle (port of ``deeplearning4j_tpu/perf/``): built
kernels and captured programs as managed artifacts.

- :mod:`~deeplearning4j_tpu_torch.perf.compile_cache` — the kernel
  build cache: where ``nvcc``'s libraries and Triton's cache live,
  shared by a checkout's processes and restarts;
- :mod:`~deeplearning4j_tpu_torch.perf.compile_store` — the
  content-addressed, fenced store above it: (torch + CUDA, device
  capability, program fingerprint)-keyed entries with corrupt-entry
  quarantine, its ``kernels/`` plane the build directory;
- :mod:`~deeplearning4j_tpu_torch.perf.warmup` — build every declared
  shape bucket (on the card: capture its CUDA graph) before traffic;
- :mod:`~deeplearning4j_tpu_torch.perf.sentry` — count the distinct
  signatures of every entry point, keep a CUDA graph per signature on
  the card, warn or raise on retrace storms.
"""
from deeplearning4j_tpu_torch.perf import compile_cache as compile_cache
from deeplearning4j_tpu_torch.perf import compile_store as compile_store
from deeplearning4j_tpu_torch.perf import sentry as sentry
from deeplearning4j_tpu_torch.perf import warmup as warmup
from deeplearning4j_tpu_torch.perf.compile_store import (
    CompileStore as CompileStore,
    program_fingerprint as program_fingerprint)
from deeplearning4j_tpu_torch.perf.sentry import (
    RetraceBudgetExceeded as RetraceBudgetExceeded)
from deeplearning4j_tpu_torch.perf.warmup import (
    WarmupSpec as WarmupSpec, warmup_plan as warmup_plan)


def compile_report() -> dict:
    """One-shot compile-lifecycle summary for end-of-run reporters: the
    sentry's totals and the build cache's state. Walks the cache dir —
    don't call it per iteration (:func:`compile_cache.counters` is the
    cheap read)."""
    cache = compile_cache.cache_stats()
    return {
        "compile_time_s": round(sentry.total_compile_time_s(), 3),
        "traces": sentry.total_traces(),
        "per_function": sentry.stats(),
        "cache_dir": cache["dir"],
        "cache_entries": cache["entries"],
        "cache_hits": cache["persistent_hits"],
        "cache_misses": cache["persistent_misses"],
    }


__all__ = ["compile_cache", "compile_store", "CompileStore",
           "program_fingerprint", "sentry", "warmup", "WarmupSpec",
           "warmup_plan", "RetraceBudgetExceeded", "compile_report"]
