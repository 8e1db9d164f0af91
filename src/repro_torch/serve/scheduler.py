"""Continuous-batching scheduler: request queue + admission control (port of
``repro/serve/scheduler.py:33-212``).

Requests join the running batch as soon as a slot and enough cache blocks
for their worst case are available (FIFO, no overtaking), and leave it the
step they reach max-tokens or ``eos_id``. Admission counts the prefix
cache's evictable blocks as capacity, since the pool reclaims them on
demand. When the pool runs dry mid-decode the youngest running request is
preempted: its pages are freed (or parked in the prefix cache's LRU if
registered) and it goes back to the front of the queue, to be re-prefilled
over prompt + tokens generated so far (sampling keys are folded per output
index, so it resumes on the same trajectory, and its own committed blocks
are prefix-cache hits).

The queue series (``serve_queue_depth``, ``serve_queue_wait_seconds``,
``serve_requests_admitted_total``, ``serve_preemptions_total``) go into the
engine's registry, admission and preemption are traced (``serve.admit``,
``serve.preempt``), and an attached flight recorder gets the ``admit``,
``evict`` and ``preempt`` events, all as in the JAX scheduler.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, List, Optional

import numpy as np

from repro_torch.obs import trace
from repro_torch.obs.metrics import LATENCY_BUCKETS, Registry


@dataclasses.dataclass
class Request:
    """One generation request plus its lifecycle metrics."""
    req_id: int
    prompt: np.ndarray                       # (T0,) int32
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    eos_id: Optional[int] = None
    cacheable: bool = False                  # eligible for prefix caching
    #                                          (set by the engine)
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    cache_len: int = 0                       # logical positions written to cache
    admit_seq: int = -1                      # order of (latest) admission
    preemptions: int = 0
    arrival_time: float = dataclasses.field(default_factory=time.perf_counter)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    spec_proposed: int = 0                   # draft tokens proposed for this
    spec_accepted: int = 0                   # request / accepted by the target

    @property
    def done(self) -> bool:
        if len(self.out_tokens) >= self.max_new_tokens:
            return True
        return bool(self.eos_id is not None and self.out_tokens
                    and self.out_tokens[-1] == self.eos_id)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def prefill_tokens(self) -> np.ndarray:
        """The prompt, plus — after a preemption — everything generated."""
        if not self.out_tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out_tokens, np.int32)])

    def cache_budget(self) -> int:
        """Worst-case cache positions this request may still occupy."""
        remaining = self.max_new_tokens - len(self.out_tokens)
        return len(self.prompt) + len(self.out_tokens) + max(remaining, 0)


class Scheduler:
    """FIFO admission against pool capacity and a running-slot cap."""

    def __init__(self, pool, max_running: int = 8,
                 registry: Optional[Registry] = None,
                 headroom_tokens: int = 0, flight=None):
        self.pool = pool
        self.max_running = max_running
        # optional obs.flight.FlightRecorder: admission, preemption and
        # eviction land here so a postmortem shows the scheduling history
        self.flight = flight
        # extra cache positions every running request may transiently write
        # past its budget (speculative decoding: a verify round can land up
        # to spec_k uncommitted tail tokens before rollback)
        self.headroom_tokens = headroom_tokens
        self.waiting: Deque[Request] = collections.deque()
        self.running: List[Request] = []
        self._admit_seq = 0
        reg = registry if registry is not None else Registry()
        self.registry = reg
        reg.gauge("serve_queue_depth", "requests waiting for admission",
                  fn=lambda waiting=self.waiting: len(waiting))
        self._h_queue_wait = reg.histogram(
            "serve_queue_wait_seconds", LATENCY_BUCKETS,
            "arrival -> (latest) admission wait")
        self._c_admitted = reg.counter(
            "serve_requests_admitted_total",
            "admissions (re-admission after preemption counts again)")
        self._c_preemptions = reg.counter(
            "serve_preemptions_total", "requests preempted under pool pressure")

    @property
    def preemptions(self) -> int:
        return int(self._c_preemptions.value)

    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def admit(self) -> List[Request]:
        """Move queue heads into the running set while a slot and enough
        blocks for their worst case are available. Capacity admitted earlier
        in the same call is held back, so one call never promises the same
        blocks twice."""
        admitted: List[Request] = []
        reserved = 0
        if not self.waiting:
            # nothing to admit: no span either (every steady decode step)
            return admitted
        with trace.span("serve.admit", waiting=len(self.waiting),
                        running=len(self.running)):
            # prefix-cached blocks in the LRU are evictable on demand, so
            # they count as admissible capacity (a hit needs even less)
            avail = self.pool.available_blocks
            while self.waiting and len(self.running) < self.max_running:
                req = self.waiting[0]
                need = self.pool.blocks_for(req.cache_budget()
                                            + self.headroom_tokens)
                if (need + reserved > avail
                        or len(admitted) + 1 > self.pool.free_slots):
                    break
                reserved += need
                self.waiting.popleft()
                req.admit_seq = self._admit_seq
                self._admit_seq += 1
                self.running.append(req)
                admitted.append(req)
                self._c_admitted.inc()
                wait = time.perf_counter() - req.arrival_time
                self._h_queue_wait.observe(wait)
                if self.flight is not None:
                    self.flight.record("admit", req_id=req.req_id,
                                       queue_wait_s=wait, blocks=need,
                                       preemptions=req.preemptions)
        return admitted

    def adopt(self, req: Request) -> None:
        """Insert an already-provisioned request (a fork) into the running
        set directly, bypassing the admission queue."""
        if len(self.running) >= self.max_running:
            raise ValueError("running set full")
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        self.running.append(req)

    def evict(self, req: Request) -> None:
        """Finished request: free its blocks and leave the running set."""
        self.pool.free(req.req_id)
        self.running.remove(req)
        req.finish_time = time.perf_counter()
        if self.flight is not None:
            self.flight.record("evict", req_id=req.req_id,
                               out_tokens=len(req.out_tokens))

    def preempt_youngest(self) -> Optional[Request]:
        """Free the most recently admitted request and requeue it at the
        front; returns it, or None if nothing is running."""
        if not self.running:
            return None
        victim = max(self.running, key=lambda r: r.admit_seq)
        with trace.span("serve.preempt", req_id=victim.req_id,
                        generated=len(victim.out_tokens)):
            self.pool.free(victim.req_id)
            self.running.remove(victim)
            victim.cache_len = 0
            victim.preemptions += 1
            self._c_preemptions.inc()
            self.waiting.appendleft(victim)
            if self.flight is not None:
                self.flight.record("preempt", req_id=victim.req_id,
                                   generated=len(victim.out_tokens),
                                   preemptions=victim.preemptions)
        return victim
