"""Live-traffic recalibration (port of ``repro/serve/recalibrate.py``): stream
serving activations back into COALA and hot-swap refreshed factors into a
running engine without draining.

The paper's scenario (3), too little calibration data, comes with explicit
error bounds, so a running server can tell when calibration drawn from its
own traffic has seen enough tokens to give a trustworthy approximation:

  * ``TrafficCalibrator`` is a ``core.calibrate.Calibrator`` fed by live
    traffic: a sampled fraction of requests have their served token streams
    replayed through the **dense base model**'s capture path
    (``LM.capture_prefill``) into the per-layer streaming R factors offline
    calibration uses, so ``compress_model`` and the ``obs.numerics``
    monitors work unchanged. Each served position is captured once — the
    prompt at admission, the generated inputs at completion — which by
    causality are the activations serving computed; the traffic R equals an
    offline ``Calibrator`` fed the same streams, as RᵀR.

  * ``RecalibWorker`` watches three numerics grades and recompresses once
    the bound clears: **data** (every target layer has streamed
    ``min_token_factor × n`` tokens; 0.25 by default, since the
    μ-regularized solve is the paper's cure for the under-streamed regime),
    **conditioning** (no layer's μ-augmented R̃ grades FAIL) and **bound**
    (every layer's residual within ``max_residual_excess`` of the attainable
    Σ-tail bound). Ranks are pinned from the serving factors' own
    compression (``rank_map_from_reports``), so the new model has the
    served model's exact shapes and ``ContinuousEngine.hot_swap`` is a value
    copy into the tensors the captured CUDA graphs read: no capture, and
    ``post_warmup_compiles`` stays 0.

The worker solves inline by default: ``on_step`` polls the gates between
engine steps, deterministic and test-friendly. ``async_solve=True`` moves
the solve to a background thread that stages the new models; the engine
applies the staged swap at the top of its next ``step()``. On the card that
thread works on its own CUDA stream: it waits on an event recorded after
the R factors it reads, records one after the solve, and the swap waits on
that one.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.calibrate import Calibrator
from repro_torch.core.compress import compress_model
from repro_torch.models.common import CPU_CTX
from repro_torch.obs import numerics, trace

FAIL = numerics.FAIL


@dataclass(frozen=True)
class RecalibPolicy:
    """When is traffic-derived calibration trustworthy enough to ship?
    (The JAX package's policy and defaults.) ``min_token_factor`` is the
    data gate (tokens per layer >= factor × features). A swap is attempted
    at most every ``check_every`` engine steps, and after a solve only once
    ``min_new_tokens`` fresh tokens have streamed in."""
    sample_rate: float = 1.0        # fraction of requests captured
    min_token_factor: float = 0.25  # data gate: tokens >= factor * n
    max_residual_excess: float = 2.0  # bound gate: residual <= excess * bound
    fail_cond: float = 1e8          # conditioning gate on μ-augmented R̃
    check_every: int = 2            # poll cadence, in engine steps
    min_new_tokens: int = 32        # fresh tokens between solve attempts
    capture_generated: bool = True  # replay generated inputs at completion


class _Snapshot:
    """The R factors and token counts one solve reads, taken on the engine's
    thread (``compress_model`` and the monitors duck-type a calibrator)."""

    def __init__(self, cal: Calibrator):
        self._r = cal.r_factors()
        self._seen = cal.tokens_seen()

    def r_factors(self) -> Dict[str, torch.Tensor]:
        return self._r

    thin_r_factors = r_factors          # already square: square_r keeps them

    def tokens_seen(self) -> Dict[str, int]:
        return self._seen


class TrafficCalibrator(Calibrator):
    """``Calibrator`` fed by live traffic through ``model``, the dense base
    the served factors were compressed from.

    Capture is incremental and exactly-once per served position: a sampled
    request's prompt is replayed at admission and its generated *inputs*
    (every emitted token but the last, which no forward consumed) at
    completion, each time recording only positions not yet captured — the
    slicing lives in ``record``, so the model's capture path is offline
    calibration's. Sampling draws from ``np.random.RandomState(seed)`` in
    admission order, the JAX calibrator's stream."""

    def __init__(self, model, *, ctx=None, policy: RecalibPolicy = None,
                 compute_dtype=torch.float32, seed: int = 0):
        super().__init__()
        self.model = model
        self.ctx = CPU_CTX if ctx is None else ctx
        self.policy = policy or RecalibPolicy()
        self.compute_dtype = compute_dtype
        self._rng = np.random.RandomState(seed)
        self._rec_start = 0
        # req_id -> stream positions captured so far; sampling is sticky
        # (a request is in or out for its whole lifetime)
        self._sampled: Dict[int, int] = {}
        self._rejected: set = set()
        self.sampled_requests = 0
        self.captured_tokens = 0
        # full streams captured from finished requests, for offline replay
        self.captured_streams: List[np.ndarray] = []

    # ------------------------------------------------------------ capture
    def record(self, path: str, x: torch.Tensor) -> None:
        if self._rec_start and x.ndim >= 3:
            x = x[:, self._rec_start:]
        super().record(path, x)

    def capture_tokens(self, tokens, *, start: int = 0) -> None:
        """Replay ``tokens`` (T,) through the capture path, recording only
        positions >= ``start`` (each conditioned on its full prefix). The
        JAX calibrator's ``capture``: here that name is the base class's
        hook installer."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if len(tokens) <= start:
            return
        with trace.span("serve.recalib_capture", tokens=len(tokens) - start,
                        start=start):
            self._rec_start = start
            try:
                self.model.capture_prefill(tokens, self, ctx=self.ctx,
                                           compute_dtype=self.compute_dtype)
            finally:
                self._rec_start = 0
        self.captured_tokens += len(tokens) - start

    def _admit(self, req_id: int) -> bool:
        if req_id in self._sampled:
            return True
        if req_id in self._rejected:
            return False
        if self._rng.random_sample() < self.policy.sample_rate:
            self._sampled[req_id] = 0
            self.sampled_requests += 1
            return True
        self._rejected.add(req_id)
        return False

    def on_prefill(self, req) -> None:
        """Admission-time capture of the tokens this prefill computes over
        (the prompt, or prompt + generated-so-far for a resumed preemptee)."""
        if not self._admit(req.req_id):
            return
        stream = np.asarray(req.prefill_tokens(), np.int32)
        done = self._sampled[req.req_id]
        self.capture_tokens(stream, start=done)
        self._sampled[req.req_id] = max(done, len(stream))

    def on_finish(self, req) -> None:
        """Completion-time capture of the generated inputs (everything the
        decode loop fed back in: ``out_tokens[:-1]``)."""
        done = self._sampled.pop(req.req_id, None)
        self._rejected.discard(req.req_id)
        if done is None:
            return
        stream = np.concatenate(
            [np.asarray(req.prompt, np.int32),
             np.asarray(req.out_tokens[:-1], np.int32)])
        if self.policy.capture_generated and len(stream) > done:
            self.capture_tokens(stream, start=done)
            done = len(stream)
        self.captured_streams.append(stream[:done])


class RecalibWorker:
    """Watches the numerics gates over a ``TrafficCalibrator`` and hot-swaps
    recompressed models into a live ``ContinuousEngine``.

    ``base_model`` is the dense ``LM`` the served model was compressed from
    (``cal.model``, whose traffic it captures); ``rank_map`` pins the
    target's ranks and, with ``draft_ratio`` > 0, ``draft_rank_map`` the
    speculative draft's. Attach with ``engine.attach_recalibrator(worker)``;
    the engine then calls ``on_prefill``/``on_finish`` on the capture path
    and ``on_step`` at the top of every ``step()``."""

    def __init__(self, base_model, cal: TrafficCalibrator, ccfg, *,
                 rank_map: Dict[str, int],
                 draft_ratio: float = 0.0,
                 draft_rank_map: Optional[Dict[str, int]] = None,
                 async_solve: bool = False):
        if base_model.cfg.family == "encdec":
            raise NotImplementedError(
                "live recompression of an encoder-decoder is not ported: its "
                "traffic capture would need each request's frames")
        if not rank_map:
            raise ValueError("rank_map is empty: nothing to recompress "
                             "(pin it from the initial compression's "
                             "reports via rank_map_from_reports)")
        self.model = base_model
        self.cal = cal
        self.ccfg = ccfg
        self.rank_map = dict(rank_map)
        self.draft_ratio = float(draft_ratio)
        self.draft_rank_map = dict(draft_rank_map) if draft_rank_map else None
        if self.draft_ratio > 0 and not self.draft_rank_map:
            raise ValueError("draft recompression needs draft_rank_map")
        self.policy = cal.policy
        self.async_solve = async_solve
        # observable state
        self.swaps = 0
        self.solve_attempts = 0
        self.last_status = "collecting"
        self.last_excess = float("nan")
        self.last_swap_seconds = float("nan")
        self.last_solve_seconds = float("nan")
        self.tokens_at_first_swap: Optional[int] = None
        self._steps = 0
        self._tokens_at_last_solve = -(10 ** 9)
        self._staged = None
        self._error: Optional[Exception] = None
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._metrics = {}
        # set by engine.attach_recalibrator (a weak reference): lets the
        # async solve reach the flight recorder and the postmortem dump when
        # a gate rejects
        self._engine = None

    # ------------------------------------------------------------ metrics
    def bind_metrics(self, **counters) -> None:
        """Engine-owned ``serve_recalib_*`` counters the worker increments
        (``attach_recalibrator`` wires them up)."""
        self._metrics = counters

    def _inc(self, name: str, by=1) -> None:
        c = self._metrics.get(name)
        if c is not None:
            c.inc(by)

    # ------------------------------------------------------------ hooks
    def on_prefill(self, engine, req) -> None:
        before_r, before_t = self.cal.sampled_requests, self.cal.captured_tokens
        self.cal.on_prefill(req)
        self._inc("sampled", self.cal.sampled_requests - before_r)
        self._inc("tokens", self.cal.captured_tokens - before_t)
        self._record_capture(engine, req, self.cal.captured_tokens - before_t,
                             at="prefill")

    def on_finish(self, engine, req) -> None:
        before_t = self.cal.captured_tokens
        self.cal.on_finish(req)
        self._inc("tokens", self.cal.captured_tokens - before_t)
        self._record_capture(engine, req, self.cal.captured_tokens - before_t,
                             at="finish")

    @staticmethod
    def _record_capture(engine, req, tokens: int, *, at: str) -> None:
        fl = getattr(engine, "flight", None)
        if fl is not None and tokens > 0:
            fl.record("recalib_capture", req_id=req.req_id,
                      tokens=int(tokens), at=at)

    def on_step(self, engine) -> None:
        """Between-steps hook: apply any staged swap, then (inline) poll
        the gates every ``check_every`` steps; in async mode start the
        solver thread instead, so ``step()`` never waits on a solve."""
        self._steps += 1
        with self._lock:
            staged, self._staged = self._staged, None
            error, self._error = self._error, None
        if error is not None:
            raise RuntimeError("recalibration: the async solve failed") \
                from error
        if staged is not None:
            self._apply(engine, *staged)
        if self._steps % max(self.policy.check_every, 1) != 0:
            return
        if self.async_solve:
            if (self._thread is None or not self._thread.is_alive()) \
                    and self._should_solve():
                snap, ready = self._snapshot()
                self._thread = threading.Thread(
                    target=self._solve_and_stage, args=(snap, ready),
                    daemon=True)
                self._thread.start()
        else:
            self.poll(engine)

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for a running async solve; True when none is left running."""
        t = self._thread
        if t is not None:
            t.join(timeout)
            return not t.is_alive()
        return True

    # ------------------------------------------------------------ gates
    def min_tokens_seen(self) -> int:
        seen = self.cal.tokens_seen()
        return min((seen.get(p, 0) for p in self.rank_map), default=0)

    def clearance(self) -> float:
        """min over target layers of tokens_seen / (min_token_factor × n):
        the data gate clears at >= 1.0. A layer with no stream yet pins 0."""
        seen = self.cal.tokens_seen()
        dims = {p: s.n for p, s in self.cal.streams.items()}
        worst = math.inf
        for p in self.rank_map:
            if p not in dims:
                return 0.0
            need = self.policy.min_token_factor * dims[p]
            worst = min(worst, seen.get(p, 0) / max(need, 1e-9))
        return 0.0 if worst is math.inf else float(worst)

    def _should_solve(self) -> bool:
        if self.clearance() < 1.0:
            self.last_status = "collecting"
            return False
        if (self.cal.captured_tokens - self._tokens_at_last_solve
                < self.policy.min_new_tokens):
            return False
        return True

    # ------------------------------------------------------------ solve/swap
    def poll(self, engine) -> bool:
        """Inline gate check + solve + swap; returns True if a swap landed."""
        if not self._should_solve():
            return False
        snap, _ = self._snapshot()
        result = self._solve(snap)
        if result is None:
            return False
        self._apply(engine, *result, None)
        return True

    def _snapshot(self):
        """(the calibrator's current factors and counts, and on the card an
        event after the work that computed them on this thread's stream)."""
        snap = _Snapshot(self.cal)
        ready = None
        if self.model.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.model.device))
        return snap, ready

    def _solve_and_stage(self, snap, ready) -> None:
        """The async solve: on the card on a stream of its own that waits
        for ``ready``; the staged result carries an event recorded after
        the solve, which the swap waits on."""
        done = None
        try:
            if ready is None:
                result = self._solve(snap)
            else:
                stream = torch.cuda.Stream(self.model.device)
                with torch.cuda.stream(stream):
                    stream.wait_event(ready)
                    result = self._solve(snap)
                    done = torch.cuda.Event()
                    done.record(stream)
                # the snapshot's tensors belong to the engine's stream: hold
                # them until this stream has finished reading them
                done.synchronize()
        except Exception as e:      # raised on the engine's thread instead
            with self._lock:
                self._error = e
            return
        if result is not None:
            with self._lock:
                self._staged = (*result, done)

    def _solve(self, snap):
        """Recompress against ``snap``'s R factors and vet the result;
        returns (model, draft model or None) or None when a gate fails."""
        self.solve_attempts += 1
        self._tokens_at_last_solve = self.cal.captured_tokens
        t0 = time.perf_counter()
        with trace.span("serve.recalib_solve",
                        tokens=self.cal.captured_tokens):
            new_model, reports = compress_model(
                self.model, snap, self.ccfg, rank_map=self.rank_map)
            draft_model = None
            if self.draft_ratio > 0:
                dcfg = dataclasses.replace(self.ccfg, ratio=self.draft_ratio,
                                           rank=0)
                draft_model, _ = compress_model(
                    self.model, snap, dcfg, rank_map=self.draft_rank_map)
        with trace.span("serve.recalib_check"):
            pol = numerics.NumericsPolicy(
                fail_cond=self.policy.fail_cond,
                min_token_factor=self.policy.min_token_factor,
                warn_residual_excess=self.policy.max_residual_excess,
                fail_residual_excess=self.policy.max_residual_excess)
            mus = {r.path: r.mu for r in reports}
            target_rf = {p: r for p, r in snap.r_factors().items()
                         if p in self.rank_map}
            conds = numerics.check_augmented_r_factors(
                target_rf, mus, snap.tokens_seen(), pol)
            comp = numerics.check_compression(reports, pol)
            excesses = [h.residual / max(h.bound, 1e-12) for h in comp]
            self.last_excess = max(excesses) if excesses else float("nan")
            cond_fail = [h for h in conds
                         if not math.isfinite(h.cond)
                         or h.cond >= self.policy.fail_cond]
            bound_fail = [h for h in comp if h.level == FAIL]
        self.last_solve_seconds = time.perf_counter() - t0
        if cond_fail or bound_fail:
            self.last_status = "cond_fail" if cond_fail else "bound_fail"
            trace.instant("serve.recalib_reject", status=self.last_status,
                          layers=len(cond_fail) + len(bound_fail))
            eng = self._engine() if self._engine is not None else None
            fl = getattr(eng, "flight", None)
            if fl is not None:
                fl.record("recalib_reject", status=self.last_status,
                          layers=len(cond_fail) + len(bound_fail),
                          excess=float(self.last_excess)
                          if math.isfinite(self.last_excess) else None)
                eng.dump_postmortem(f"recalib_{self.last_status}")
            return None
        self.last_status = "cleared"
        return new_model, draft_model

    def _apply(self, engine, new_model, draft_model, done) -> None:
        t0 = time.perf_counter()
        if done is not None:
            # the swap's copies run after the solver stream's last write
            torch.cuda.current_stream(engine.device).wait_event(done)
        engine.hot_swap(new_model, draft_model)
        self.last_swap_seconds = time.perf_counter() - t0
        self.swaps += 1
        self._inc("swaps")
        if self.tokens_at_first_swap is None:
            self.tokens_at_first_swap = self.cal.captured_tokens
        self.last_status = "swapped"

    def summary(self) -> Dict[str, float]:
        return {
            "swaps": self.swaps,
            "solve_attempts": self.solve_attempts,
            "sampled_requests": self.cal.sampled_requests,
            "captured_tokens": self.cal.captured_tokens,
            "clearance": self.clearance(),
            "residual_excess": self.last_excess,
            "status": self.last_status,
        }
