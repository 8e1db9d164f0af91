"""Per-request flight recorder: bounded ring of lifecycle events + postmortem
(the port's own copy of ``repro/obs/flight.py``).

A serving engine under load is a black box exactly when you need it not to
be: a pool-invariant assertion in the chaos soak, a numerics ``fail``
verdict, or a recalibration gate rejection tells you *that* something went
wrong, never *which request did what* in the steps leading up to it. The
``FlightRecorder`` closes that gap with a fixed-capacity ring buffer of
per-request lifecycle events — submit, admit, prefix-hit length, prefill
bucket, first token, per-round speculative proposed/accepted, preemption,
fork, recalibration capture/swap/reject, finish/evict — each stamped with
the engine step index at which it happened.

Design constraints:

  * **Bounded memory.** The ring is a ``collections.deque(maxlen=capacity)``;
    a long-running engine holds at most ``capacity`` events and counts the
    rest in ``dropped``. The monotonic ``seq`` stamp survives drops, so
    event order (and gaps) stay reconstructible from the tail.
  * **Cheap when attached, free when not.** Call sites guard with
    ``if flight is not None``; a record is one dict build and a deque
    append under a lock (the lock matters only for the HTTP telemetry
    thread and recalib worker reading concurrently).
  * **Zero dependencies.** Stdlib only, like the rest of ``repro_torch.obs``.

``dump()`` writes the postmortem bundle — ring tail, metrics snapshot,
engine config, span-trace tail — as strict JSON. The engine wires it to
its failure paths (step exceptions, recalib gate rejections), and
test harnesses can dump it when an invariant trips.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

# The event taxonomy (docs/observability.md holds the prose table). Kept as
# a frozenset so tests can assert recorded events stay inside it.
EVENT_TYPES = frozenset({
    "submit",           # request entered the waiting queue
    "admit",            # scheduler moved it into the running batch
    "prefix_hit",       # prompt tokens satisfied from the prefix cache
    "prefill",          # batched suffix prefill (with padded bucket size)
    "first_token",      # first generated token (TTFT point)
    "spec_round",       # one speculative draft+verify round (proposed/accepted)
    "preempt",          # evicted back to the waiting queue under pool pressure
    "fork",             # copy-on-write fork into a child request
    "recalib_capture",  # activations streamed into the traffic calibrator
    "recalib_swap",     # bound-cleared factor hot-swap applied
    "recalib_reject",   # solve attempt failed a readiness gate
    "finish",           # request completed; final stats attached
    "evict",            # pool pages released
    "step_exception",   # engine.step() raised; recorded before the dump
})


def _json_safe(obj):
    """Strict-JSON-ready copy: non-finite floats become None (a metrics
    snapshot can legally carry inf/nan — e.g. a clearance gauge before any
    data — but the bundle must parse everywhere)."""
    if isinstance(obj, float):
        return obj if obj == obj and abs(obj) != float("inf") else None
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


class FlightRecorder:
    """Bounded ring buffer of per-request lifecycle events.

    ``capacity`` bounds memory; ``dump_path`` is where :meth:`dump` writes
    the postmortem bundle unless overridden per call.
    """

    def __init__(self, capacity: int = 4096,
                 dump_path: str = "POSTMORTEM_serve.json"):
        if capacity <= 0:
            raise ValueError(f"flight recorder capacity must be > 0, "
                             f"got {capacity}")
        self.capacity = int(capacity)
        self.dump_path = dump_path
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._step = -1          # -1 = before the first engine step
        self.dropped = 0

    # ------------------------------------------------------------- recording
    def begin_step(self, idx: int) -> None:
        """Stamp subsequent events with engine step ``idx`` (the engine
        calls this at the top of ``step()``; scheduler/pool records made
        inside the step inherit it without plumbing)."""
        self._step = int(idx)

    @property
    def step(self) -> int:
        return self._step

    def record(self, event: str, req_id: Optional[str] = None,
               **fields: Any) -> None:
        """Append one event; oldest entry drops once past capacity."""
        with self._lock:
            ev: Dict[str, Any] = {"seq": self._seq, "step": self._step,
                                  "t": time.perf_counter(), "event": event}
            if req_id is not None:
                ev["req_id"] = req_id
            if fields:
                ev.update(fields)
            self._seq += 1
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(ev)

    # --------------------------------------------------------------- reading
    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def events(self) -> List[dict]:
        """Ring contents, oldest first."""
        with self._lock:
            return list(self._ring)

    def events_for(self, req_id: str) -> List[dict]:
        """All retained events for one request, in record order."""
        return [e for e in self.events() if e.get("req_id") == req_id]

    # ------------------------------------------------------------ postmortem
    def dump(self, *, reason: str, metrics: Optional[dict] = None,
             config: Optional[dict] = None,
             path: Optional[str] = None) -> str:
        """Write the postmortem bundle as strict JSON; returns the path.

        Bundle contents: the failure ``reason``, the full ring tail (with
        ``seq``/``dropped`` so truncation is visible), the metrics snapshot
        and engine config the caller passes, and the tail of the active
        span trace when tracing is on.
        """
        from repro_torch.obs import trace  # local import: avoid cycle at import time

        tracer = trace.current()
        trace_tail = tracer.tail(256) if tracer is not None else []
        bundle = {
            "reason": reason,
            "wallclock": time.time(),
            "capacity": self.capacity,
            "dropped": self.dropped,
            "next_seq": self._seq,
            "events": self.events(),
            "metrics": metrics if metrics is not None else {},
            "config": config if config is not None else {},
            "trace_tail": trace_tail,
        }
        out = path if path is not None else self.dump_path
        with open(out, "w") as f:
            # default=str: config values may be dtypes/paths; allow_nan off
            # keeps the bundle strict JSON for any downstream parser.
            json.dump(_json_safe(bundle), f, default=str, allow_nan=False)
        return out
