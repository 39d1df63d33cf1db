"""Process-wide span tracer — Chrome-trace/Perfetto timelines (port of
``deeplearning4j_tpu/obs/trace.py``, standard library only).

Where a step's wall time went — the data iterator's wait, the
host→device copy, the launches queued on the card, the blocking device
sync — across every thread (fit loop, serving worker):

- **One clock.** :func:`now` (``time.perf_counter``) is the package's
  step clock.
- **One branch when off.** Tracing is gated by ``DL4J_TPU_TRACE``;
  disabled, :func:`span` returns a shared no-op context manager and
  :func:`add_span` returns after a single module-global check — no
  event is allocated on the step path (:func:`events_recorded` stays
  put).
- **Chrome-trace JSONL.** Events are complete-span ``"ph": "X"``
  records (``ts``/``dur`` in microseconds, ``pid``/``tid``), held in a
  bounded ring (``DL4J_TPU_TRACE_RING``) and streamed to a JSONL file:
  first line ``[``, then one event object per line with a trailing
  comma — the Chrome trace "JSON array format", which tolerates the
  missing ``]``, so the file opens in ``chrome://tracing`` / Perfetto
  and stays line-parseable (:func:`read_trace`). The viewers nest the
  spans of one ``tid`` by interval containment.

Flags (``environment.py``): ``DL4J_TPU_TRACE`` — '' (off, default),
truthy ('1'/'true'/'on') for a default ``dl4j_tpu_trace_<pid>.jsonl``
in the working directory, or an explicit output path;
``DL4J_TPU_TRACE_RING`` — the in-memory ring's size.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

now = time.perf_counter     #: the package's step clock (monotonic s)

_TRUTHY = {"1", "true", "on", "yes"}
_FALSEY = {"", "0", "off", "none", "false", "no"}

_lock = threading.Lock()
_enabled = False            # the one branch the off path pays
_ring: Optional[deque] = None
_fh = None                  # open JSONL handle (None -> ring only)
_path: Optional[str] = None
_events_recorded = 0
_seen_tids: set = set()
_tls = threading.local()    # .name: worker label for this thread


def enabled() -> bool:
    return _enabled


def enable(path: Optional[str] = None,
           ring: Optional[int] = None) -> Optional[str]:
    """Turn the tracer on. ``path`` (optional) streams events to a
    Chrome-trace JSONL file; events always land in the in-memory ring
    (``ring`` entries, default ``DL4J_TPU_TRACE_RING``). Returns the
    active file path (None when ring-only)."""
    global _enabled, _ring, _fh, _path
    if ring is None:
        from deeplearning4j_tpu_torch import environment
        ring = environment.get_flag("DL4J_TPU_TRACE_RING")
    with _lock:
        if _fh is not None:
            _close_locked()
        _ring = deque(maxlen=max(1, int(ring)))
        _seen_tids.clear()
        if path is not None:
            _path = os.fspath(path)
            _fh = open(_path, "w")
            _fh.write("[\n")    # Chrome JSON array format (']' optional)
        else:
            _path = None
        _enabled = True
    return _path


def disable() -> None:
    """Stop tracing and close the output file (ring kept for
    inspection until the next :func:`enable`/:func:`reset`)."""
    global _enabled
    with _lock:
        _enabled = False
        _close_locked()


def _close_locked() -> None:
    global _fh
    if _fh is not None:
        try:
            _fh.flush()
            _fh.close()
        except OSError:
            pass
        _fh = None


def configure_from_env() -> Optional[str]:
    """Start the tracer from ``DL4J_TPU_TRACE`` (called by
    ``environment.apply_startup_flags`` at package import). Truthy →
    default per-pid file; any other non-falsey value → output path."""
    from deeplearning4j_tpu_torch import environment
    raw = str(environment.get_flag("DL4J_TPU_TRACE")).strip()
    if raw.lower() in _FALSEY:
        return None
    if raw.lower() in _TRUTHY:
        return enable(f"dl4j_tpu_trace_{os.getpid()}.jsonl")
    return enable(raw)


def reset() -> None:
    """Tests only: disable, drop the ring, zero the counter."""
    global _ring, _path, _events_recorded
    disable()
    with _lock:
        _ring = None
        _path = None
        _events_recorded = 0
        _seen_tids.clear()


atexit.register(disable)    # flush + close the JSONL on exit


# -- recording ---------------------------------------------------------------

def set_thread_name(name: str) -> None:
    """Label the calling thread in the timeline (worker id — e.g.
    ``proc0``, ``prefetch``, ``serving``). Emitted as a Chrome ``M``
    metadata event on the thread's first recorded span."""
    _tls.name = str(name)
    if _enabled:
        with _lock:
            _seen_tids.discard(threading.get_ident())   # re-announce


def _emit(*evs: Dict[str, Any]) -> None:
    """Append events of the calling thread to ring+file, under one lock
    and in one write. Caller checked ``_enabled``."""
    global _events_recorded
    tid = evs[0]["tid"]
    with _lock:
        if _ring is None:
            return
        if tid not in _seen_tids:
            _seen_tids.add(tid)
            name = getattr(_tls, "name", None) or \
                threading.current_thread().name
            meta = {"ph": "M", "name": "thread_name", "pid": evs[0]["pid"],
                    "tid": tid, "args": {"name": name}}
            _ring.append(meta)
            if _fh is not None:
                _fh.write(json.dumps(meta, separators=(",", ":"))
                          + ",\n")
        _ring.extend(evs)
        _events_recorded += len(evs)
        if _fh is not None:
            _fh.write("".join(_line(ev) for ev in evs))


#: event name -> its JSON string (the names are a small fixed set)
_json_names: Dict[str, str] = {}


def _line(ev: Dict[str, Any]) -> str:
    """One event as a line of the JSONL file. A complete span without
    args — the fit loops' hot case — is formatted directly: a few µs
    less than ``json.dumps`` a span, which is what keeps the spans'
    own cost small beside a millisecond step."""
    if ev["ph"] != "X" or "args" in ev:
        return json.dumps(ev, separators=(",", ":")) + ",\n"
    name = _json_names.get(ev["name"])
    if name is None:
        name = _json_names[ev["name"]] = json.dumps(ev["name"])
    return (f'{{"ph":"X","name":{name},"ts":{ev["ts"]!r},'
            f'"dur":{ev["dur"]!r},"pid":{ev["pid"]},"tid":{ev["tid"]}}},\n')


def _span(name: str, t0: float, t1: float, args, pid: int,
          tid: int) -> Dict[str, Any]:
    ev: Dict[str, Any] = {
        "ph": "X", "name": name,
        "ts": round(t0 * 1e6, 3), "dur": round((t1 - t0) * 1e6, 3),
        "pid": pid, "tid": tid,
    }
    if args:
        ev["args"] = args
    return ev


def add_span(name: str, t0: float, t1: float,
             args: Optional[Dict[str, Any]] = None) -> None:
    """Record a completed span from explicit :func:`now` timestamps —
    the zero-context-manager-overhead API the fit loops use."""
    if not _enabled:        # the off path: one branch, no allocation
        return
    _emit(_span(name, t0, t1, args, os.getpid(), threading.get_ident()))


def add_spans(spans) -> None:
    """Record several completed spans ``(name, t0, t1, args)`` of the
    calling thread at once (one lock, one write): a step's phases."""
    if not _enabled:
        return
    pid, tid = os.getpid(), threading.get_ident()
    _emit(*(_span(n, t0, t1, a, pid, tid) for n, t0, t1, a in spans))


def counter(name: str, values: Dict[str, Any],
            t: Optional[float] = None) -> None:
    """Record one sample on a Perfetto counter track (Chrome ``C``
    event): ``values`` maps series name → number, so e.g. per-layer
    gradient norms render as stacked counter series alongside the
    span timeline. Same off-path contract as :func:`add_span`."""
    if not _enabled:
        return
    ev: Dict[str, Any] = {
        "ph": "C", "name": name,
        "ts": round((now() if t is None else t) * 1e6, 3),
        "pid": os.getpid(), "tid": threading.get_ident(),
        "args": {k: float(v) for k, v in values.items()},
    }
    _emit(ev)


def async_span(name: str, aid, t0: float, t1: float,
               args: Optional[Dict[str, Any]] = None,
               cat: str = "request") -> None:
    """Record one phase of an ASYNC track (Chrome nestable async
    ``b``/``e`` event pair sharing ``id``): request-scoped spans live
    here because a request's life overlaps other requests on the same
    worker thread — complete-span (``X``) nesting by interval
    containment would interleave them into garbage, while async
    tracks render one lane per ``id``. Same off-path contract as
    :func:`add_span` (one branch, zero events)."""
    if not _enabled:
        return
    base = {"cat": cat, "id": format(int(aid), "x"),
            "pid": os.getpid(), "tid": threading.get_ident()}
    b: Dict[str, Any] = {"ph": "b", "name": name,
                         "ts": round(t0 * 1e6, 3), **base}
    if args:
        b["args"] = args
    _emit(b)
    _emit({"ph": "e", "name": name, "ts": round(t1 * 1e6, 3), **base})


def instant(name: str, args: Optional[Dict[str, Any]] = None) -> None:
    """Record a point-in-time marker (Chrome ``i`` event)."""
    if not _enabled:
        return
    ev: Dict[str, Any] = {
        "ph": "i", "name": name, "s": "t",
        "ts": round(now() * 1e6, 3),
        "pid": os.getpid(), "tid": threading.get_ident(),
    }
    if args:
        ev["args"] = args
    _emit(ev)


class _NullSpan:
    """Shared no-op context manager — the disabled :func:`span` path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "args", "t0")

    def __init__(self, name, args):
        self.name = name
        self.args = args

    def __enter__(self):
        self.t0 = now()
        return self

    def __exit__(self, *exc):
        add_span(self.name, self.t0, now(), self.args)
        return False


def span(name: str, args: Optional[Dict[str, Any]] = None):
    """``with obs.span("fit/step"): ...`` — nested spans build the
    timeline; when tracing is off this returns a shared no-op context
    manager (one branch, nothing allocated per call)."""
    if not _enabled:
        return _NULL_SPAN
    return _Span(name, args)


# -- inspection --------------------------------------------------------------

def events_recorded() -> int:
    """Total span/instant events recorded since the last reset — the
    zero-overhead-when-disabled assertion anchor."""
    return _events_recorded


def events(last: Optional[int] = None) -> List[Dict[str, Any]]:
    """Snapshot of the in-memory ring (most recent ``last``, or all)."""
    with _lock:
        evs = list(_ring) if _ring is not None else []
    return evs[-last:] if last else evs


def trace_path() -> Optional[str]:
    return _path


def flush() -> None:
    with _lock:
        if _fh is not None:
            _fh.flush()


def read_trace(path: str) -> List[Dict[str, Any]]:
    """Parse a trace JSONL written by this module (or any Chrome-trace
    JSON array file) back into a list of event dicts."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        text = f.read()
    stripped = text.strip()
    if stripped.startswith("[") and stripped.endswith("]"):
        try:                        # complete JSON array / traceEvents
            doc = json.loads(stripped)
            return doc.get("traceEvents", doc) \
                if isinstance(doc, dict) else doc
        except ValueError:
            pass
    for line in text.splitlines():
        line = line.strip().rstrip(",")
        if not line or line in ("[", "]"):
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            continue                # partial last line of a live file
    return out
