"""Runtime flags — the port's environment-variable registry (port of
``deeplearning4j_tpu/environment.py``).

Every variable the port reads is declared here with its type, default
and purpose, and read through :func:`get_flag`, so the whole surface is
greppable and :func:`describe` prints the live values. Names, defaults
and parsers are the JAX package's. The JAX compile cache's eligibility
floors (``DL4J_TPU_COMPILE_CACHE_MIN_BYTES``, ``_MIN_SECS``) have no
counterpart: every kernel build is kept. Only the flags the port reads are
registered; each later slice registers its own. The JAX package's
TPU roofline figures and its TPU size crossovers are not flags here: a
size threshold in the port needs its own measurement on the card.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict


def _bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclass(frozen=True)
class Flag:
    name: str
    default: Any
    parse: Callable[[str], Any]
    doc: str


FLAGS: Dict[str, Flag] = {}


def _register(name, default, parse, doc):
    FLAGS[name] = Flag(name, default, parse, doc)


# -- distributed bring-up (parallel/mesh.py initialize_distributed) --------
_register("DL4J_TPU_COORD", None, str,
          "process-group coordinator address host:port")
_register("DL4J_TPU_NPROC", None, int,
          "number of processes in the multi-process job")
_register("DL4J_TPU_PROC_ID", None, int,
          "this process's rank in the multi-process job")

# -- telemetry spine (obs/: span tracer + metrics + worker health) ---------
_register("DL4J_TPU_TRACE", "", str,
          "span tracer (obs/trace.py): '' off; '1' writes Chrome-trace "
          "JSONL to dl4j_tpu_trace_<pid>.jsonl; any other value is the "
          "output path (drop the file into chrome://tracing/Perfetto)")
_register("DL4J_TPU_TRACE_RING", 4096, int,
          "in-memory span ring size")
_register("DL4J_TPU_METRICS_PORT", 0, int,
          "serve Prometheus /metrics + /healthz on this port from "
          "startup (0: don't autostart; obs.metrics.start_server() "
          "starts it on demand, port 0 -> ephemeral)")
_register("DL4J_TPU_STALE_WORKER_SECS", 30.0, float,
          "heartbeat age beyond which /healthz flags a worker stale")

# -- compile lifecycle (perf/: kernel build cache, store, retrace sentry) --
_register("DL4J_TPU_COMPILE_CACHE",
          os.path.expanduser("~/.dl4j_tpu/compile_cache"), str,
          "kernel build cache dir (perf/compile_cache.py): where nvcc's "
          "libraries and Triton's cache go, shared across processes and "
          "restarts; honoured only when the variable is set (the default "
          "is the JAX package's XLA cache dir; unset, or '' | '0' | "
          "'off' | 'none', builds go to the package's own _build/)")
_register("DL4J_TPU_COMPILE_STORE", "", str,
          "content-addressed compile store root (perf/compile_store.py), "
          "fenced by (store version, torch + CUDA version, device "
          "capability); when set it supersedes DL4J_TPU_COMPILE_CACHE: "
          "its fenced kernels/ plane becomes the build dir ('' | '0' | "
          "'off' disables)")
_register("DL4J_TPU_RETRACE_BUDGET", 16, int,
          "distinct UNPLANNED argument signatures tolerated per sentried "
          "entry point before the retrace sentry warns (warmed-up "
          "signatures don't count against it)")
_register("DL4J_TPU_RETRACE_STRICT", False, _bool,
          "retrace sentry raises RetraceBudgetExceeded instead of "
          "warning when an entry point blows its retrace budget")

# -- resilience (resilience/faults.py) -------------------------------------
_register("DL4J_TPU_FAULT_PLAN", "", str,
          "deterministic fault-injection plan (resilience/faults.py): "
          "'' off (one-branch path); a named plan (worker-crash, "
          "serving-crash, preempt, ...) or "
          "'site:error=OSError:p=0.5:seed=3;...' rule syntax")


def get_flag(name: str) -> Any:
    """Read a declared flag from the environment (typed, defaulted)."""
    flag = FLAGS[name]
    raw = os.environ.get(name)
    if raw is None:
        return flag.default
    return flag.parse(raw)


def describe() -> str:
    """The live flag table."""
    lines = [f"{'variable':<28} {'value':<24} purpose"]
    for name, flag in sorted(FLAGS.items()):
        val = get_flag(name)
        lines.append(f"{name:<28} {str(val):<24} {flag.doc}")
    return "\n".join(lines)


def apply_startup_flags() -> None:
    """Apply the flags that configure process-wide singletons: the span
    tracer, the metrics server and the fault plan (called from the
    package's ``__init__``; safe to call again). With none of the three
    set, nothing more is imported."""
    if os.environ.get("DL4J_TPU_TRACE", "").strip():
        from deeplearning4j_tpu_torch.obs import trace as obs_trace
        obs_trace.configure_from_env()
    if get_flag("DL4J_TPU_METRICS_PORT"):
        from deeplearning4j_tpu_torch.obs import metrics as obs_metrics
        obs_metrics.start_server()
    if os.environ.get("DL4J_TPU_FAULT_PLAN", "").strip():
        from deeplearning4j_tpu_torch.resilience import faults
        faults.configure_from_env()
