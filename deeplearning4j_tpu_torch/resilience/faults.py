"""Deterministic fault injection (port of
``deeplearning4j_tpu/resilience/faults.py``).

Seedable fault *plans* whose rules fire at named *sites* threaded
through the real code paths. The sites the port carries:

==================  ========================================================
site                where it fires
==================  ========================================================
``step``            ``MultiLayerNetwork``/``ComputationGraph`` fit, before
                    a batch or a ``steps_per_loop`` group is staged (a fire
                    leaves the params, the optimizer state and
                    ``iteration`` as they were)
``worker_step``     ``ParallelWrapper.fit``, after each batch is drawn
``serving``         the serving gateway's worker, before each decode step
                    (inside its ``try``: a fire sheds the in-flight
                    streams, as a failed step does)
``iterator``        every batch a ``data/`` iterator yields
                    (``DataSetIterator._apply_pp``), before the normaliser
``ckpt_write``      ``ModelSerializer.write_model``, before the zip is built
``ckpt_commit``     ``ModelSerializer.write_model``, after the tmp file's
                    fsync and before its ``os.replace`` (a fire removes
                    the tmp file and leaves the old checkpoint in place)
==================  ========================================================

The JAX package's other sites (``host_death``, ``coordinator``,
``router``, ``replica_spawn``: the elastic fleet and the serving router,
which the port does not carry) are validated by name too, so a plan
written for the JAX package parses; nothing in the port evaluates them.

Plans are env-gated (``DL4J_TPU_FAULT_PLAN``) and the **off path is one
branch**: :func:`inject` returns after a single module-global ``None``
check — no callback runs, no counter moves (:func:`evaluations` stays
0).

Plan syntax — ``;``-separated rules, each ``site[:key=value]...``::

    DL4J_TPU_FAULT_PLAN="step:error=ConnectionError:nth=2:max=1"

``site`` may be an ``fnmatch`` glob. Keys: ``error`` (exception class
name from :data:`ERRORS`, or ``sigterm``/``exit`` for process-level
faults), ``p`` (per-evaluation probability, seeded → deterministic),
``nth`` (fire on exactly the nth evaluation), ``every`` (every kth),
``max`` (max fires), ``seed``. :data:`NAMED_PLANS` gives a shared
vocabulary. Every fire increments
``dl4j_tpu_faults_injected_total{site=...}``.
"""
from __future__ import annotations

import fnmatch
import logging
import os
import random
import signal
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Union

logger = logging.getLogger("deeplearning4j_tpu_torch")


class InjectedFault(RuntimeError):
    """Default exception a fault rule raises."""


#: exception classes a rule may raise by name (`error=` key), plus the
#: process-level kinds ``sigterm`` (self-delivered preemption notice)
#: and ``exit`` (hard crash via ``os._exit`` — no finally blocks, the
#: closest in-process analog of kill -9)
ERRORS = {
    "InjectedFault": InjectedFault,
    "RuntimeError": RuntimeError,
    "OSError": OSError,
    "IOError": OSError,
    "ConnectionError": ConnectionError,
    "TimeoutError": TimeoutError,
    "ValueError": ValueError,
    "MemoryError": MemoryError,
    "FloatingPointError": FloatingPointError,
}

#: error kinds that need a module the port does not carry yet: the
#: numerics observatory's ``NonFiniteError`` (``obs/numerics.py``)
#: comes with ROADMAP item A14, and a plan naming it is refused at
#: parse time
_UNPORTED_ERRORS = {"NonFiniteError": "obs/numerics.py (ROADMAP A14)"}

#: every site of the JAX package (the port's six are in the table
#: above) — literal rule sites are validated against this at parse
#: time, so a mistyped plan fails loudly instead of never firing
KNOWN_SITES = frozenset({"ckpt_write", "ckpt_commit", "step",
                         "iterator", "worker_step", "serving",
                         "host_death", "coordinator", "router",
                         "replica_spawn"})

#: the named plans (the JAX package's): accepted by ``FaultPlan.parse``
#: and ``DL4J_TPU_FAULT_PLAN`` itself
NAMED_PLANS = {
    # checkpoint IO flakes: refuse some writes, kill one commit window
    "ckpt-io-flake": "ckpt_write:error=OSError:p=0.5:seed=3:max=3;"
                     "ckpt_commit:error=OSError:nth=2:max=1",
    # one mid-training step failure (the chip-drop analog)
    "worker-crash": "step:error=ConnectionError:nth=6:max=1",
    # data pipeline flake mid-epoch
    "etl-flake": "iterator:error=OSError:nth=9:max=1",
    # serving dispatch worker takes a poisoned batch
    "serving-crash": "serving:error=RuntimeError:nth=2:max=1",
    # self-delivered SIGTERM mid-fit (preemption notice)
    "preempt": "step:error=sigterm:nth=5:max=1",
    # one host of an elastic fleet gets its preemption notice mid-run
    # (elastic step site): graceful leave -> survivors evict + re-form
    "host-preempt": "host_death:error=sigterm:nth=4:max=1",
    # coordination-plane IO flakes: lease renewals / agreement rounds
    # hit a flaky shared filesystem
    "coord-flake": "coordinator:error=OSError:p=0.4:seed=9:max=2",
    # one serving replica hard-dies mid-trace (`error=exit` = the
    # in-process kill -9 analog, fired at the gateway worker's per-
    # iteration serving site): the router must stop routing to it
    # within a lease window and the supervisor respawns capacity
    "replica-crash": "serving:error=exit:nth=25:max=1",
    # the routing plane itself flakes: one forwarded request hits a
    # connection error -> re-route, shed only within budget
    "router-flake": "router:error=ConnectionError:nth=3:max=1",
    # a replica dies during bring-up, before its first lease: the
    # supervisor must observe the missing lease and spawn again
    "spawn-crash": "replica_spawn:error=exit:nth=1:max=1",
}

_EXIT_CODE = 17         # `error=exit` status — distinguishable from crashes


class FaultRule:
    """One parsed rule: a site pattern plus deterministic firing state."""

    def __init__(self, site: str, error: str = "InjectedFault",
                 p: float = 1.0, nth: int = 0, every: int = 0,
                 max_fires: int = 1 << 30, seed: int = 0):
        if error in _UNPORTED_ERRORS:
            raise NotImplementedError(
                f"fault rule {site!r}: error={error} needs "
                f"{_UNPORTED_ERRORS[error]}, which the port does not "
                "carry yet")
        if error not in ERRORS and error not in ("sigterm", "exit"):
            raise ValueError(
                f"fault rule {site!r}: unknown error kind {error!r} "
                f"(one of {sorted(ERRORS)} | sigterm | exit)")
        self.site = site
        self.error = error
        self.p = float(p)
        self.nth = int(nth)
        self.every = int(every)
        self.max_fires = int(max_fires)
        self.seed = int(seed)
        self.evals = 0
        self.fires = 0
        self._rng = random.Random(self.seed)

    def matches(self, site: str) -> bool:
        return self.site == site or fnmatch.fnmatchcase(site, self.site)

    def should_fire(self) -> bool:
        """Evaluate once (call with the plan lock held) — deterministic
        for a given (seed, evaluation-ordinal) pair."""
        self.evals += 1
        if self.fires >= self.max_fires:
            return False
        if self.nth:
            return self.evals == self.nth
        if self.every:
            return self.evals % self.every == 0
        if self.p >= 1.0:
            return True
        return self._rng.random() < self.p

    def describe(self) -> str:
        parts = [self.site, f"error={self.error}"]
        if self.nth:
            parts.append(f"nth={self.nth}")
        elif self.every:
            parts.append(f"every={self.every}")
        elif self.p < 1.0:
            parts.append(f"p={self.p}:seed={self.seed}")
        if self.max_fires < (1 << 30):
            parts.append(f"max={self.max_fires}")
        return ":".join(parts)


class FaultPlan:
    """An ordered list of :class:`FaultRule` — the unit of activation."""

    def __init__(self, rules: List[FaultRule]):
        self.rules = list(rules)

    @staticmethod
    def parse(spec: Union[str, "FaultPlan"]) -> "FaultPlan":
        if isinstance(spec, FaultPlan):
            return spec
        spec = NAMED_PLANS.get(spec.strip(), spec)
        rules = []
        for chunk in spec.split(";"):
            chunk = chunk.strip()
            if not chunk:
                continue
            fields = chunk.split(":")
            kwargs: Dict[str, object] = {}
            for f in fields[1:]:
                if "=" not in f:
                    raise ValueError(
                        f"fault plan field {f!r} (rule {chunk!r}) is "
                        "not key=value")
                k, v = f.split("=", 1)
                k = {"max": "max_fires"}.get(k, k)
                if k == "error":
                    kwargs[k] = v
                elif k == "p":
                    kwargs[k] = float(v)
                elif k in ("nth", "every", "max_fires", "seed"):
                    kwargs[k] = int(v)
                else:
                    raise ValueError(
                        f"fault plan key {k!r} (rule {chunk!r}) unknown")
            site = fields[0]
            # a literal (non-glob) site that matches nothing would arm
            # a plan that silently never fires — reject it here; globs
            # stay free-form for forward compatibility
            if not any(c in site for c in "*?[") and \
                    site not in KNOWN_SITES:
                raise ValueError(
                    f"fault plan site {site!r} unknown "
                    f"(one of {sorted(KNOWN_SITES)}, or a glob)")
            rules.append(FaultRule(site, **kwargs))
        if not rules:
            raise ValueError(f"fault plan {spec!r} has no rules")
        return FaultPlan(rules)

    def describe(self) -> str:
        return ";".join(r.describe() for r in self.rules)


_lock = threading.Lock()
_plan: Optional[FaultPlan] = None   # the one branch the off path pays
_evaluations = 0                    # bumps ONLY while a plan is active


def inject(site: str) -> None:
    """Hot-path hook. With no plan active this returns after a single
    module-global check — the whole cost of shipping fault injection in
    production code paths."""
    if _plan is None:
        return
    _inject_active(site)


def _inject_active(site: str) -> None:
    global _evaluations
    fire_rule = None
    with _lock:
        plan = _plan
        if plan is None:            # deactivated between check and lock
            return
        _evaluations += 1
        for rule in plan.rules:
            if rule.matches(site) and rule.should_fire():
                rule.fires += 1
                fire_rule = rule
                break
    if fire_rule is None:
        return
    from deeplearning4j_tpu_torch import obs
    obs.metrics.FAULTS_INJECTED.labels(site=site).inc()
    logger.warning("fault injection: firing %r at site %r (fire %d)",
                   fire_rule.error, site, fire_rule.fires)
    if fire_rule.error == "exit":
        os._exit(_EXIT_CODE)
    if fire_rule.error == "sigterm":
        os.kill(os.getpid(), signal.SIGTERM)
        return                      # the preemption handler takes over
    raise ERRORS[fire_rule.error](
        f"injected fault at site {site!r} "
        f"(rule {fire_rule.describe()}, fire {fire_rule.fires})")


def activate(plan: Union[str, FaultPlan]) -> FaultPlan:
    """Install ``plan`` (a spec string, plan name, or FaultPlan) as the
    process-wide active plan."""
    global _plan
    plan = FaultPlan.parse(plan)
    with _lock:
        _plan = plan
    logger.warning("fault injection ACTIVE: %s", plan.describe())
    return plan


def deactivate() -> None:
    global _plan
    with _lock:
        _plan = None


@contextmanager
def active(plan: Union[str, FaultPlan]):
    """``with faults.active("step:nth=3"):`` — scoped activation for
    tests and drills."""
    p = activate(plan)
    try:
        yield p
    finally:
        deactivate()


def plan() -> Optional[FaultPlan]:
    return _plan


def evaluations() -> int:
    """Total site evaluations while a plan was active — stays 0 for the
    whole life of a process that never activates a plan."""
    return _evaluations


def stats() -> Dict[str, Dict[str, int]]:
    """Per-rule ``{pattern: {evals, fires}}`` of the active plan."""
    with _lock:
        if _plan is None:
            return {}
        return {r.describe(): {"evals": r.evals, "fires": r.fires}
                for r in _plan.rules}


def reset() -> None:
    """Tests only: drop the plan and zero the evaluation counter."""
    global _plan, _evaluations
    with _lock:
        _plan = None
        _evaluations = 0


def configure_from_env() -> Optional[FaultPlan]:
    """Activate the plan named by ``DL4J_TPU_FAULT_PLAN`` (called by
    ``environment.apply_startup_flags`` at package import; unset/empty
    → no plan)."""
    from deeplearning4j_tpu_torch import environment
    raw = str(environment.get_flag("DL4J_TPU_FAULT_PLAN") or "").strip()
    if not raw:
        return None
    return activate(raw)
