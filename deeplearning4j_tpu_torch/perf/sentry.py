"""Retrace sentry: trace and compile accounting for every entry point of
the port's hot paths, and the CUDA graphs those entry points replay
(port of ``deeplearning4j_tpu/perf/sentry.py``).

The JAX package compiles one XLA executable per distinct argument
signature of a ``jax.jit`` entry point. The port's counterpart of that
executable is a captured ``torch.cuda.CUDAGraph``: :func:`jit` wraps a
function as a :class:`SentryJit` that keeps, per signature, the
function itself on the CPU, or, on the card for an entry point declared
``capture=True``, a graph of one call of it. The counters are the JAX
sentry's, name by name:

- a *trace* is the first call of a distinct signature (the argument
  tree's structure plus each tensor's shape, dtype and device), or a
  :meth:`SentryJit.warmup` of one not yet seen;
- *compiles* are first calls not covered by a warmup;
- *warmed* counts the executables made by ``warmup`` ahead of traffic,
  *aot_hits* the live calls they serve;
- the budget meters the distinct UNPLANNED signatures: past it the
  sentry warns on logger ``deeplearning4j_tpu_torch.perf``, and raises
  :class:`RetraceBudgetExceeded` under :func:`strict` (or
  ``DL4J_TPU_RETRACE_STRICT``). Signatures declared by ``warmup`` are
  planned and never count.

A call made while another entry point traces its own first call (a loop
program calling its step) is accounted as JAX accounts a jitted function
called inside another's trace: a new signature is a trace and a compile,
a seen one nothing; inside a replayed or warmed run it is not accounted.

**The graphs.** A captured signature's executable (:class:`_Graph`) is
built at ``warmup``, or at the first call when the signature was never
warmed: one warm run on a side stream, then the capture. At ``warmup``
the warm run works on scratch copies of the state and input tensors, and
the registered generators' states are put back after it, so that it
changes nothing and draws nothing; what a program writes in place
(serving's KV pool, by closure) a warmup's inactive rows write only to
the pool's trash page. At a first call the warm run IS the call: it runs
on the caller's arguments, its results are the call's, and the capture
that follows it runs nothing, so the call launches each kernel once, as
the eager call does. Every later call copies its tensor arguments into
the graph's static inputs (skipping a tensor that IS the static input)
and replays. The programs of the port are functional in their tensor
arguments. The argument kinds an entry point declares:

- ``state`` (the JAX ``donate_argnums``): the graph's own state tensors.
  The function returns their new values first, in the same tree
  structure, and the graph copies them into the state tensors itself;
  the call returns the state tensors. A caller that keeps them across a
  replay sees the replay's values, as a ``torch.optim`` optimizer's
  parameters do; the tensors the caller passed in are never written.
- ``const``: read in place by identity (serving's prepared parameters,
  a network's trees in ``output``). A call with another tensor object
  there captures the signature again (no trace: JAX would not retrace
  for new values either).
- ``seeds``: integer seeds (or tuples of them). Under capture the
  function receives symbolic seeds (:class:`TapeSeed`, an
  ``rng.SymbolicSeed``); every random draw takes its generator from
  ``rng.generator``, which gives each draw site its own generator on
  the device, registered with the graph
  (``CUDAGraph.register_generator_state``). Before each replay each
  site's generator is seeded with the value the eager step computes for
  it (``split_seed``/``fold_in`` over the call's seed), so a replay
  draws exactly what the eager step draws.
- ``generators``: a callable returning persistent generators the
  function draws from (the serving sampler's), registered with the
  graph: replays advance them as eager calls do.
- any other tensor: copied into the graph's static input each call.
  A Python flag (a bool) or string keys a variant of the graph: a new
  value captures again, uncounted. A Python int or float is refused
  (``TypeError``) in an entry point declared capturable, on the CPU
  too: each value would key a graph and a memory pool of its own, so
  such a value comes in as a 0-d tensor on the device.

Outputs that are not state are cloned after the replay: the next replay
overwrites the graph's own output tensors, never what a caller holds.
Each graph has a memory pool of its own: PyTorch lets graphs share a
pool only when they replay in the order they were captured, and the
signatures of an entry point replay in the order traffic brings them.

The launch counters of the port's kernels (``fn.launches``,
``ops/kernel_registry.py``) see no Python wrapper run during a replay:
each graph records how far each counter moved while it was captured
(the capture itself launches nothing, so the counters are put back),
and adds that again at every replay. The warm run launches for real and
is counted: at a first call it is the call, so a captured path counts
what its eager run counts; a ``warmup`` counts one run of each program
it captures (its eager counterpart runs the function once too).

A capture that fails on the card raises; there is no quiet fall-back to
the eager function. ``capture=False`` entry points (and every entry
point on the CPU) run the function itself.

Metrics surface through :func:`stats`, :func:`total_traces` and
:func:`total_compile_time_s` (``perf.compile_report``, the
``obs.metrics`` perf collector).
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

from deeplearning4j_tpu_torch import rng
from deeplearning4j_tpu_torch.rng import SymbolicSeed

_log = logging.getLogger("deeplearning4j_tpu_torch.perf")

_LOCK = threading.RLock()
# weakrefs: stats live exactly as long as their SentryJit (and thus the
# network) does. Call under _LOCK.
_REGISTRY: List["weakref.ref[FunctionStats]"] = []


def _live_stats() -> List["FunctionStats"]:
    out = [s for s in (r() for r in _REGISTRY) if s is not None]
    if len(out) != len(_REGISTRY):
        _REGISTRY[:] = [r for r in _REGISTRY if r() is not None]
    return out


# strict()/budget() context overrides (None -> read the env flags)
_STRICT_OVERRIDE: Optional[bool] = None
_BUDGET_OVERRIDE: Optional[int] = None


class RetraceBudgetExceeded(RuntimeError):
    """An entry point traced more distinct unplanned signatures than its
    retrace budget allows (retrace storm)."""


def _flag(name):
    from deeplearning4j_tpu_torch import environment
    return environment.get_flag(name)


def _is_strict() -> bool:
    if _STRICT_OVERRIDE is not None:
        return _STRICT_OVERRIDE
    return bool(_flag("DL4J_TPU_RETRACE_STRICT"))


def _default_budget() -> int:
    if _BUDGET_OVERRIDE is not None:
        return _BUDGET_OVERRIDE
    return int(_flag("DL4J_TPU_RETRACE_BUDGET"))


class ShapeDtype(NamedTuple):
    """An abstract tensor: shape, dtype and device, no storage
    (``perf.warmup.sds``; the counterpart of ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: Any
    device: Any


# -- argument trees ----------------------------------------------------------
def _flatten(tree, leaves: list):
    """The structure of ``tree`` (dicts, lists, tuples, None) as a
    hashable key; its leaves appended to ``leaves``."""
    if isinstance(tree, dict):
        return ("d", tuple((k, _flatten(v, leaves))
                           for k, v in tree.items()))
    if isinstance(tree, tuple) and not isinstance(tree, ShapeDtype):
        return ("t", tuple(_flatten(v, leaves) for v in tree))
    if isinstance(tree, list):
        return ("l", tuple(_flatten(v, leaves) for v in tree))
    if tree is None:
        return None
    leaves.append(tree)
    return "*"


def _unflatten(struct, it):
    if struct is None:
        return None
    if struct == "*":
        return next(it)
    kind, items = struct
    if kind == "d":
        return {k: _unflatten(s, it) for k, s in items}
    seq = [_unflatten(s, it) for s in items]
    return tuple(seq) if kind == "t" else seq


def _is_array(leaf) -> bool:
    return (getattr(leaf, "shape", None) is not None
            and hasattr(leaf, "dtype"))


def _device_str(dev) -> str:
    """A device's name with its index (``cuda`` names the current card:
    ``cuda:0``), so that a stand-in on ``cuda`` signs as the tensors it
    stands for."""
    if dev is None:
        return "cpu"
    dev = str(dev)
    if dev == "cuda":
        import torch
        return f"cuda:{torch.cuda.current_device()}"
    return dev


def _leaf_sig(leaf):
    if _is_array(leaf):
        return (tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""),
                _device_str(getattr(leaf, "device", None)))
    return ("py", type(leaf).__name__)


def signature(tree) -> tuple:
    """Hashable signature of an argument tree: its structure and each
    leaf's (shape, dtype, device); a Python value contributes its type
    only (its value keys a graph variant, not a signature). Works on
    tensors, numpy arrays and :class:`ShapeDtype` stand-ins alike."""
    leaves: list = []
    struct = _flatten(tree, leaves)
    return (struct, tuple(_leaf_sig(leaf) for leaf in leaves))


# -- symbolic seeds and the draw sites of a capture ---------------------------
class TapeSeed(SymbolicSeed):
    """A seed under capture: the root (one seed argument of the captured
    call) or a ``split_seed``/``fold_in`` of another. Its value is
    recomputed from each replay's root values."""

    __slots__ = ("tape", "parent", "op", "arg")

    def __init__(self, tape, parent, op, arg):
        self.tape, self.parent, self.op, self.arg = tape, parent, op, arg

    def split(self, n: int):
        return tuple(TapeSeed(self.tape, self, "split", (n, i))
                     for i in range(n))

    def fold(self, data: int) -> "TapeSeed":
        return TapeSeed(self.tape, self, "fold", int(data))

    def generator(self, device):
        """This draw site's generator (see :meth:`_Tape.draw`)."""
        return self.tape.draw(device, self)

    def value(self, roots, memo) -> int:
        key = id(self)
        if key in memo:
            return memo[key]
        if self.op == "root":
            v = int(roots[self.arg])
        else:
            p = self.parent.value(roots, memo)
            v = (rng.split_seed(p, self.arg[0])[self.arg[1]]
                 if self.op == "split" else rng.fold_in(p, self.arg))
        memo[key] = v
        return v

    def __int__(self):
        raise TypeError("a seed under CUDA-graph capture is symbolic: draw "
                        "through rng.generator(device, seed)")


class _Tape:
    """The draw sites of one captured program: one generator each, in
    the order the function reaches them."""

    def __init__(self):
        self.sites: List[Tuple[Any, TapeSeed]] = []
        self.roots: List[TapeSeed] = []
        self.values: Optional[list] = None   # warm run: concrete roots
        self._next = 0

    def root(self) -> TapeSeed:
        r = TapeSeed(self, None, "root", len(self.roots))
        self.roots.append(r)
        return r

    def draw(self, device, seed: TapeSeed):
        import torch
        if self.values is not None:             # the warm run: record
            gen = torch.Generator(device=device)
            gen.manual_seed(seed.value(self.values, {}))
            self.sites.append((gen, seed))
            return gen
        if self._next >= len(self.sites):
            raise RuntimeError("the captured run drew from more random "
                               "sites than its warm run")
        gen, _ = self.sites[self._next]
        self.sites[self._next] = (gen, seed)
        self._next += 1
        return gen

    def reseed(self, values) -> None:
        memo: dict = {}
        for gen, seed in self.sites:
            gen.manual_seed(seed.value(values, memo))


_LOCAL = threading.local()


@contextlib.contextmanager
def _mode(mode: Optional[str], capturing: Optional[bool] = None):
    """The calling thread's sentry mode while an entry point builds
    ("trace") or runs ("run") its executable, and whether a graph is
    being captured (then a nested entry point runs its function inside
    the outer graph); nested entry points read them."""
    prev = (getattr(_LOCAL, "mode", None),
            getattr(_LOCAL, "capturing", False))
    _LOCAL.mode = mode
    _LOCAL.capturing = prev[1] if capturing is None else capturing
    try:
        yield
    finally:
        _LOCAL.mode, _LOCAL.capturing = prev


# -- the kernels' launch counters ---------------------------------------------
def _counters() -> list:
    from deeplearning4j_tpu_torch.ops import kernel_registry
    return [e.port_fn() for e in kernel_registry.ported()]


# -- executables ----------------------------------------------------------------
class FunctionStats:
    """Per-entry-point counters (one per SentryJit; :func:`stats` merges
    the instances that share a name)."""

    def __init__(self, name: str, budget: Optional[int]):
        self.name = name
        self.budget = budget          # None -> global flag/override
        self.traces = 0               # total traces (incl. planned)
        self.compiles = 0             # first calls not covered by warmup
        self.warmed = 0               # executables made ahead of traffic
        self.aot_hits = 0             # live calls served by a warmed one
        self.compile_time_s = 0.0     # wall time building executables
        self.signatures: set = set()  # every distinct traced signature
        self.planned: set = set()     # declared via warmup()

    def note_plan(self, sig):
        with _LOCK:
            self.planned.add(sig)

    def note_trace(self, sig):
        with _LOCK:
            self.traces += 1
            self.signatures.add(sig)
            unplanned = len(self.signatures - self.planned)
            budget = (self.budget if self.budget is not None
                      else _default_budget())
            over = unplanned > budget
        if over:
            msg = (f"retrace sentry: {self.name!r} traced {unplanned} "
                   f"distinct unplanned shapes (budget {budget}) — "
                   "likely a retrace storm; bucket the offending "
                   "shapes (BucketedSequenceIterator / ParallelInference "
                   "buckets) or declare them via warmup()")
            if _is_strict():
                raise RetraceBudgetExceeded(msg)
            _log.warning(msg)

    def unplanned(self) -> int:
        with _LOCK:
            return len(self.signatures - self.planned)

    def snapshot(self) -> Dict[str, Any]:
        with _LOCK:
            return {
                "traces": self.traces,
                "distinct_shapes": len(self.signatures),
                "unplanned_shapes": len(self.signatures - self.planned),
                "planned_shapes": len(self.planned),
                "compiles": self.compiles,
                "warmed": self.warmed,
                "aot_hits": self.aot_hits,
                "compile_time_s": self.compile_time_s,
            }


class _Eager:
    """The executable of a signature that is not captured: the function
    itself."""

    captured = False

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, args):
        return self.fn(*args)


def _split(tree):
    leaves: list = []
    return _flatten(tree, leaves), leaves


def _materialize(leaf):
    """A stand-in as zeros of its shape, dtype and device; any other
    leaf as it is."""
    import torch
    if isinstance(leaf, ShapeDtype):
        return torch.zeros(leaf.shape, dtype=leaf.dtype, device=leaf.device)
    return leaf


class _Graph:
    """One signature of a captured entry point: static inputs, the CUDA
    graph of one call, its draw sites and its launch counts."""

    captured = True

    def __init__(self, owner: "SentryJit", args):
        import torch
        self.owner = owner
        self.kinds = [("state" if i in owner.state else
                       "const" if i in owner.const else
                       "seed" if i in owner.seeds else "input")
                      for i in range(len(args))]
        self.structs, self.static = [], []
        device = None
        for a in args:
            leaves: list = []
            self.structs.append(_flatten(a, leaves))
            self.static.append(leaves)
            for leaf in leaves:
                if _is_array(leaf) and str(getattr(leaf, "device",
                                                   "")).startswith("cuda"):
                    device = leaf.device
        self.device = torch.device(device)
        for i, kind in enumerate(self.kinds):
            if kind == "seed":
                continue
            self.static[i] = [
                self._static_leaf(leaf, kind) for leaf in self.static[i]]
        self.tape = _Tape()
        self.graph = None

    def _static_leaf(self, leaf, kind):
        if not _is_array(leaf):
            return leaf
        if kind == "const" and not isinstance(leaf, ShapeDtype):
            return leaf                      # read in place
        t = _materialize(leaf)
        if t is leaf:
            t = leaf.detach().clone()
        return t

    def _args(self, seeds) -> list:
        out = []
        for i, kind in enumerate(self.kinds):
            if kind == "seed":
                out.append(seeds[i])
            else:
                out.append(_unflatten(self.structs[i],
                                      iter(self.static[i])))
        return out

    def _seed_values(self, args) -> list:
        vals = []
        for i, kind in enumerate(self.kinds):
            if kind == "seed":
                leaves: list = []
                _flatten(args[i], leaves)
                vals.extend(leaves)
        return vals

    def _seed_roots(self, args) -> Dict[int, Any]:
        out = {}
        for i, kind in enumerate(self.kinds):
            if kind == "seed":
                leaves: list = []
                struct = _flatten(args[i], leaves)
                out[i] = _unflatten(
                    struct, iter(self.tape.root() for _ in leaves))
        return out

    def capture(self, args, live: bool = False):
        """The warm run, then the capture. ``live`` (a first call): the
        warm run is the call, on the caller's arguments; returns what
        the call returns. Otherwise (``warmup``) the warm run works on
        scratch copies and the persistent generators are put back after
        it; returns None."""
        import torch
        owner = self.owner
        gens = list(owner.generators()) if owner.generators else []
        roots = self._seed_roots(args)
        # the warm run, its draws recorded
        self.tape.values = self._seed_values(args)
        warm = []
        for i, kind in enumerate(self.kinds):
            if kind == "seed":
                warm.append(roots[i])
            elif live:
                warm.append(args[i])
            else:
                leaves = [leaf.clone() if torch.is_tensor(leaf)
                          and kind != "const" else leaf
                          for leaf in self.static[i]]
                warm.append(_unflatten(self.structs[i], iter(leaves)))
        saved = [g.get_state() for g in gens]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), _mode("trace", capturing=True):
            result = owner._fn(*warm)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        if not live:
            for g, st in zip(gens, saved):
                g.set_state(st)
            result = None
        del warm
        self.tape.values = None
        graph = torch.cuda.CUDAGraph()
        for g in gens + [g for g, _ in self.tape.sites]:
            graph.register_generator_state(g)
        counters = _counters()
        before = [c.launches for c in counters]
        n_state = sum(k == "state" for k in self.kinds)
        # the capture on the warm run's stream: what the warm run set up
        # for it (cuBLAS's workspace, the norm kernels' tickets) is what
        # the graph then reads
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"), \
                _mode("trace", capturing=True):
            out = owner._fn(*self._args(roots))
            if n_state:
                if not isinstance(out, tuple) or len(out) < n_state:
                    raise TypeError(f"{owner.name}: a program with state "
                                    "arguments returns their new values "
                                    "first")
                for j, i in enumerate(owner.state):
                    leaves: list = []
                    if _flatten(out[j], leaves) != self.structs[i]:
                        raise TypeError(f"{owner.name}: state output {j} "
                                        "changed its tree structure")
                    for dst, src in zip(self.static[i], leaves):
                        if dst is not src:
                            dst.copy_(src)
        if self.tape._next != len(self.tape.sites):
            raise RuntimeError(f"{owner.name}: the captured run drew from "
                               "fewer random sites than its warm run")
        self.launches = [(c, c.launches - b)
                         for c, b in zip(counters, before)]
        for c, b in zip(counters, before):
            c.launches = b
        self.graph, self.out, self.n_state = graph, out, n_state
        self.stream = side          # its handle stays this graph's
        if result is None or not n_state:
            return result
        # the call's new state becomes the graph's state tensors, which
        # the next replay reads
        for j, i in enumerate(owner.state):
            leaves: list = []
            _flatten(result[j], leaves)
            for dst, src in zip(self.static[i], leaves):
                if dst is not src:
                    dst.copy_(src)
        state = [_unflatten(self.structs[i], iter(self.static[i]))
                 for i in owner.state]
        return (*state, *result[n_state:])

    def __call__(self, args):
        import torch
        for i, kind in enumerate(self.kinds):
            if kind in ("state", "input"):
                leaves: list = []
                _flatten(args[i], leaves)
                for dst, src in zip(self.static[i], leaves):
                    if torch.is_tensor(dst) and dst is not src:
                        dst.copy_(src)
        if self.tape.sites:
            self.tape.reseed(self._seed_values(args))
        self.graph.replay()
        for c, n in self.launches:
            c.launches += n
        if not self.n_state:
            return _clone(self.out)
        state = [_unflatten(self.structs[i], iter(self.static[i]))
                 for i in self.owner.state]
        rest = tuple(_clone(o) for o in self.out[self.n_state:])
        return (*state, *rest)


def _clone(tree):
    leaves: list = []
    struct = _flatten(tree, leaves)
    return _unflatten(struct, iter(
        leaf.clone() if hasattr(leaf, "clone") else leaf
        for leaf in leaves))


class _Captured:
    """The graphs of one captured signature, one per combination of its
    Python flags and its ``const`` tensors' identities. One call at a
    time: a replay's static inputs and outputs are shared by every
    caller (``ParallelInference``'s in-place mode calls ``output`` from
    many threads)."""

    captured = True

    def __init__(self, owner: "SentryJit"):
        self.owner = owner
        self.variants: Dict[tuple, _Graph] = {}
        self._lock = threading.RLock()

    def _key(self, args) -> tuple:
        """(the const tensors' identities, the Python flags)."""
        ids, values = [], []
        for i, a in enumerate(args):
            if i in self.owner.seeds:
                continue
            leaves: list = []
            _flatten(a, leaves)
            for leaf in leaves:
                if not _is_array(leaf):
                    values.append((type(leaf).__name__, leaf))
                elif i in self.owner.const:
                    ids.append(id(leaf))
        return tuple(ids), tuple(values)

    def _new(self, key, args) -> _Graph:
        # const tensors rebound (new parameters): the graphs that read
        # the old ones go, and with them their pools
        self.variants = {k: v for k, v in self.variants.items()
                         if k[0] == key[0]}
        return _Graph(self.owner, args)

    def build(self, args) -> None:
        """Capture this variant ahead of its first call (``warmup``)."""
        key = self._key(args)
        with self._lock:
            if key not in self.variants:
                g = self._new(key, args)
                g.capture(args)
                self.variants[key] = g

    def __call__(self, args):
        key = self._key(args)
        with self._lock:
            g = self.variants.get(key)
            if g is not None:
                return g(args)
            g = self._new(key, args)
            out = g.capture(args, live=True)
            self.variants[key] = g
            return out


class SentryJit:
    """An entry point with trace accounting, AOT warmup and, on the
    card, a CUDA graph per signature (see the module docstring).

    ``fn`` takes positional arguments; ``state``, ``const`` and
    ``seeds`` are argument positions; ``capture`` (a flag, or a
    callable asked at each call) turns graph capture on for calls whose
    tensors live on the card, outside :func:`eager`; ``generators``
    returns the persistent generators ``fn`` draws from. The counters do
    not depend on whether a call replays a graph or runs the function."""

    def __init__(self, fn, name: Optional[str] = None,
                 budget: Optional[int] = None, *, capture=False,
                 state: Tuple[int, ...] = (), const: Tuple[int, ...] = (),
                 seeds: Tuple[int, ...] = (),
                 generators: Optional[Callable[[], list]] = None):
        self._fn = fn
        self.name = name or getattr(fn, "__name__", "jit_fn")
        self.capture = capture
        self.state, self.const, self.seeds = state, const, seeds
        self.generators = generators
        self._seen: set = set()               # signatures traced (jit cache)
        self._warmed: set = set()             # signatures warmed ahead
        self._graphs: Dict[tuple, _Captured] = {}   # sig -> its graphs
        self._eager = _Eager(fn)
        self.stats = FunctionStats(self.name, budget)
        with _LOCK:
            _REGISTRY.append(weakref.ref(self.stats))

    @property
    def __wrapped__(self):
        return self._fn

    def _captures(self, args) -> bool:
        """Whether this call runs a graph; refuses, in an entry point
        declared capturable, a Python int or float among the arguments
        that are not seeds (each value would key a graph of its own)."""
        if not (self.capture() if callable(self.capture) else self.capture):
            return False
        on_card = False
        for i, a in enumerate(args):
            leaves: list = []
            _flatten(a, leaves)
            for leaf in leaves:
                if _is_array(leaf):
                    on_card = on_card or str(getattr(
                        leaf, "device", "")).startswith("cuda")
                elif (i not in self.seeds and isinstance(leaf, (int, float))
                      and not isinstance(leaf, bool)):
                    raise TypeError(
                        f"{self.name}: argument {i} holds the Python "
                        f"{type(leaf).__name__} {leaf!r}; a capturable "
                        "entry point takes numbers as 0-d tensors on the "
                        "device (each value would capture a graph)")
        return on_card and not _EAGER_DEPTH

    def _executable(self, sig, args):
        if not self._captures(args):
            return self._eager
        exe = self._graphs.get(sig)
        if exe is None:                  # one, whichever thread is first
            exe = self._graphs.setdefault(sig, _Captured(self))
        return exe

    def _build(self, sig, args):
        """The executable, its graph captured ahead of the call."""
        exe = self._executable(sig, args)
        if exe.captured:
            with _mode("trace"):
                exe.build(args)
        return exe

    @staticmethod
    def _run(exe, args):
        with _mode("run"):
            return exe(args)

    def __call__(self, *args):
        sig = signature(args)
        st = self.stats
        mode = getattr(_LOCAL, "mode", None)
        if mode == "trace" and sig not in self._seen:
            # called inside another entry point's first call: JAX traces
            # this function inside the outer trace, once a signature
            self._seen.add(sig)
            st.note_trace(sig)
            with _LOCK:
                st.compiles += 1
        if getattr(_LOCAL, "capturing", False):
            return self._fn(*args)           # part of the outer graph
        exe = self._executable(sig, args)
        if mode is not None:
            return self._run(exe, args)
        if sig in self._warmed:
            out = self._run(exe, args)
            with _LOCK:
                st.aot_hits += 1
            return out
        if sig in self._seen:
            return self._run(exe, args)
        self._seen.add(sig)
        try:
            st.note_trace(sig)
            t0 = time.perf_counter()
            with _mode("trace"):
                out = exe(args)
        except BaseException:
            self._seen.discard(sig)
            raise
        with _LOCK:
            st.compiles += 1
            st.compile_time_s += time.perf_counter() - t0
        return out

    def run(self, *args):
        """Call this signature's executable with no accounting (the body
        of a loop program that replays its step); on the card a missing
        graph is captured by this call, as at a first call."""
        return self._run(self._executable(signature(args), args), args)

    def prepare(self, *args) -> None:
        """Build this signature's executable with no accounting (on the
        card: capture its graph; nothing to build for the function
        itself), for a loop program's warmup."""
        self._build(signature(args), args)

    def warmup(self, *args) -> float:
        """Build the executable of the given signature ahead of traffic
        (tensors and :class:`ShapeDtype` stand-ins mix freely), keep it
        for dispatch, and mark the signature PLANNED: on the card a
        capturable entry point captures its graph now; elsewhere a
        capturable entry point's function runs once on the arguments
        (stand-ins as zeros), its result dropped, as the JAX package's
        lowering runs its body (the others run nothing: a stateful step
        is not run ahead).
        Idempotent per signature. Returns the build's seconds (0.0 when
        the signature was already traced)."""
        st = self.stats
        self._captures(args)          # refuses Python numbers first
        sig = signature(args)
        st.note_plan(sig)
        with _LOCK:
            if sig in st.signatures:
                return 0.0
        t0 = time.perf_counter()
        if sig not in self._seen:
            self._seen.add(sig)
            st.note_trace(sig)
        exe = self._build(sig, args)
        if not exe.captured and self.capture:
            # the body runs once, as JAX's lowering traces it: on
            # stand-in zeros, its result dropped
            with _mode("trace"):
                self._fn(*(_unflatten(struct, iter(
                    _materialize(leaf) for leaf in leaves))
                    for struct, leaves in map(_split, args)))
        self._warmed.add(sig)
        dt = max(time.perf_counter() - t0, 1e-9)
        with _LOCK:
            st.warmed += 1
            st.compile_time_s += dt
        return dt

    def graphs(self) -> int:
        """The CUDA graphs this entry point holds."""
        return sum(len(e.variants) for e in self._graphs.values())


def jit(fn, *, name: Optional[str] = None, budget: Optional[int] = None,
        **kw) -> SentryJit:
    """An entry point with retrace accounting (see the module doc)."""
    return SentryJit(fn, name=name, budget=budget, **kw)


# -- global controls --------------------------------------------------------
_EAGER_DEPTH = 0


@contextlib.contextmanager
def eager():
    """Within the context (every thread), capturable entry points run
    their functions instead of replaying graphs; the counters move as
    they would otherwise. The eager half of a captured-vs-eager
    comparison on the card."""
    global _EAGER_DEPTH
    with _LOCK:
        _EAGER_DEPTH += 1
    try:
        yield
    finally:
        with _LOCK:
            _EAGER_DEPTH -= 1


@contextlib.contextmanager
def strict(budget: Optional[int] = None):
    """Within the context, blowing a retrace budget RAISES
    :class:`RetraceBudgetExceeded` instead of warning; ``budget``
    optionally overrides every function's budget."""
    global _STRICT_OVERRIDE, _BUDGET_OVERRIDE
    prev = (_STRICT_OVERRIDE, _BUDGET_OVERRIDE)
    _STRICT_OVERRIDE = True
    if budget is not None:
        _BUDGET_OVERRIDE = budget
    try:
        yield
    finally:
        _STRICT_OVERRIDE, _BUDGET_OVERRIDE = prev


def stats() -> Dict[str, Dict[str, Any]]:
    """Merged per-name counter snapshot for every sentried entry point
    that traced or warmed at least once."""
    with _LOCK:
        recs = [(s.name, s.snapshot()) for s in _live_stats()]
    out: Dict[str, Dict[str, Any]] = {}
    for name, snap in recs:
        if snap["traces"] == 0 and snap["warmed"] == 0:
            continue
        if name not in out:
            out[name] = snap
        else:
            agg = out[name]
            for k, v in snap.items():
                agg[k] = agg[k] + v
    return out


def total_traces() -> int:
    """Total traces across every sentried entry point — the
    zero-new-traces assertion anchor for warmup tests."""
    with _LOCK:
        return sum(s.traces for s in _live_stats())


def total_compile_time_s() -> float:
    with _LOCK:
        return sum(s.compile_time_s for s in _live_stats())


def reset() -> None:
    """Zero every counter and forget dead entries (stats of live
    SentryJit instances are zeroed in place — their executables and
    graphs survive)."""
    with _LOCK:
        for s in _live_stats():
            s.traces = s.compiles = s.warmed = s.aot_hits = 0
            s.compile_time_s = 0.0
            s.signatures.clear()
            s.planned.clear()
