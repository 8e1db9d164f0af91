"""Span tracer emitting Chrome/Perfetto ``trace_event`` JSON (the port's own
copy of ``repro/obs/trace.py``; span and instant names are the JAX ones).

One process-wide tracer records *complete* events (``ph: "X"``) around the
serving and calibration hot paths — scheduler admission, batched prefill,
decode steps, preemption, copy-on-write page copies, checkpoint I/O,
calibration R-factor accumulation, live-traffic recalibration
(``serve.recalib_capture/solve/check/swap``) — plus *instant* events
(``ph: "i"``) for compiles (CUDA-graph captures in the port), prefix-cache evictions and rejected
recalibration solves. The output loads directly in
``chrome://tracing`` / https://ui.perfetto.dev.

Design constraints (docs/observability.md has the span taxonomy):

  * **Near-zero overhead when disabled.** Tracing is off by default; the
    module-level ``span()``/``instant()`` helpers check one global and
    return a shared no-op context manager, so an untraced hot path pays a
    function call and an attribute load — no allocation, no clock read.
  * **Thread-safe when enabled.** Spans carry the recording thread's id
    (checkpointing writes on a background thread) and the event list is
    appended under a lock; per-thread spans nest strictly because they
    come from ``with`` blocks on that thread.
  * **Zero dependencies.** Stdlib only: ``time.perf_counter`` timestamps
    (microseconds relative to ``enable()``), ``json`` on save.
  * **Bounded memory on demand.** ``enable(max_events=N)`` turns the event
    list into a ring (``deque(maxlen=N)``): long-running serving keeps the
    most recent N events and counts the rest in ``tracer.dropped``
    (``launch/serve.py --trace-max-events`` wires this).

Usage (the launchers wire ``--trace-out`` to this):

    from repro_torch.obs import trace
    trace.enable()
    with trace.span("serve.decode_step", batch=4):
        ...
    trace.instant("serve.decode_compile", sig="(4, 8, True)")
    trace.save("trace.json")
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


class _NullSpan:
    """Shared do-nothing context manager returned while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One recording ``with`` block: timestamps at enter, emits at exit."""

    __slots__ = ("_tracer", "_name", "_args", "_ts")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._ts = self._tracer._now_us()
        return self

    def __exit__(self, *exc) -> bool:
        t = self._tracer
        t._emit({"name": self._name, "ph": "X", "ts": self._ts,
                 "dur": t._now_us() - self._ts, "pid": t._pid,
                 "tid": threading.get_ident(),
                 **({"args": self._args} if self._args else {})})
        return False


class Tracer:
    """Collects trace events; ``save()`` writes Perfetto-loadable JSON."""

    def __init__(self, max_events: Optional[int] = None):
        self._lock = threading.Lock()
        # deque(maxlen=None) == unbounded append; a positive cap makes it a
        # ring holding the most recent events (bounded-memory serving)
        self._events: deque = deque(maxlen=max_events)
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self.dropped = 0

    # ------------------------------------------------------------- recording
    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _emit(self, event: dict) -> None:
        with self._lock:
            if (self._events.maxlen is not None
                    and len(self._events) == self._events.maxlen):
                self.dropped += 1
            self._events.append(event)

    @property
    def max_events(self) -> Optional[int]:
        return self._events.maxlen

    def set_max_events(self, max_events: Optional[int]) -> None:
        """Re-cap the ring in place, keeping the newest events."""
        with self._lock:
            if max_events == self._events.maxlen:
                return
            old = list(self._events)
            if max_events is not None and len(old) > max_events:
                self.dropped += len(old) - max_events
            self._events = deque(old, maxlen=max_events)

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        self._emit({"name": name, "ph": "i", "s": "t", "ts": self._now_us(),
                    "pid": self._pid, "tid": threading.get_ident(),
                    **({"args": args} if args else {})})

    def name_thread(self, name: str) -> None:
        """Label the calling thread's lane in the trace viewer (``M``
        metadata event) — background workers call this once at start so
        their spans render on a named track."""
        self._emit({"name": "thread_name", "ph": "M", "pid": self._pid,
                    "tid": threading.get_ident(), "args": {"name": name}})

    # --------------------------------------------------------------- output
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def tail(self, n: int) -> List[dict]:
        """The most recent ``n`` events (postmortem bundles grab this)."""
        with self._lock:
            return list(self._events)[-n:] if n > 0 else []

    def save(self, path: str) -> int:
        """Write ``{"traceEvents": [...]}`` JSON; returns the event count."""
        with self._lock:
            events = list(self._events)
        doc = {"traceEvents": [
            {"name": "process_name", "ph": "M", "pid": self._pid, "tid": 0,
             "args": {"name": "repro_torch"}},
            *events,
        ], "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(events)


# --------------------------------------------------------------------------
# Module-level singleton: call sites never thread a tracer object around.
# --------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None


def enable(max_events: Optional[int] = None) -> Tracer:
    """Install (or return) the process tracer; spans record from now on.

    ``max_events`` caps the in-memory event list as a ring of the most
    recent events (``None`` = unbounded, the default). Re-enabling an
    existing tracer with an explicit cap re-caps it in place.
    """
    global _TRACER
    if _TRACER is None:
        _TRACER = Tracer(max_events=max_events)
    elif max_events is not None:
        _TRACER.set_max_events(max_events)
    return _TRACER


def disable() -> None:
    """Drop the tracer; ``span()``/``instant()`` become no-ops again."""
    global _TRACER
    _TRACER = None


def enabled() -> bool:
    return _TRACER is not None


def current() -> Optional[Tracer]:
    return _TRACER


def span(name: str, **args):
    """Context manager timing ``name``; free no-op when tracing is off."""
    t = _TRACER
    return t.span(name, **args) if t is not None else _NULL_SPAN


def instant(name: str, **args) -> None:
    """Point-in-time marker (compiles, evictions); no-op when off."""
    t = _TRACER
    if t is not None:
        t.instant(name, **args)


def name_thread(name: str) -> None:
    """Label the calling thread's trace lane; no-op when off."""
    t = _TRACER
    if t is not None:
        t.name_thread(name)


def save(path: str) -> int:
    """Write the active tracer's events to ``path``; 0 when tracing is off."""
    t = _TRACER
    return t.save(path) if t is not None else 0
