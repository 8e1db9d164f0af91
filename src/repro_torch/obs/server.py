"""Live telemetry HTTP endpoints for a running ``ContinuousEngine`` (the
port's own copy of ``repro/obs/server.py``).

``--metrics-out`` and ``--trace-out`` only write at process exit, so a
live engine is a black box until it stops. ``TelemetryServer`` attaches a
stdlib ``http.server`` background thread to a running engine and serves:

  * ``GET /metrics``  — Prometheus text exposition straight from the
    engine's shared ``Registry`` (the same text ``tools/check_prom.py``
    lints in CI, now scraped mid-run);
  * ``GET /healthz``  — JSON health: *readiness* (warmup complete, or the
    first step has run on warmup-off engines) and *liveness* (``step()``
    progressed within ``step_deadline_s`` while work was pending).
    200 when ready and live, 503 otherwise;
  * ``GET /requests`` — JSON snapshot of in-flight request states
    (waiting + running: tokens in/out, cache length, preemptions, TTFT);
  * ``GET /snapshot`` — the ``engine.metrics()`` dict as strict JSON
    (``allow_nan=False`` — the zero-finished NaN fix makes this safe).

Design constraints:

  * **Zero dependencies, zero hot-path cost.** Stdlib ``http.server`` on
    a daemon thread; the serving loop never blocks on it. Reads take no
    engine locks — the registry tolerates torn reads by design, and the
    request snapshot copies list references before iterating.
  * **Engine is swappable.** ``attach()`` re-points the server at a new
    engine, so one server (one port) spans the dense → COALA engine
    sequence ``launch/serve.py`` runs back to back.
  * **Port 0 works.** Binding port 0 picks an ephemeral port, exposed as
    ``server.port`` — tests and benchmarks never race over a fixed one.
  * **No cycle.** The server holds the attached engine and the engine never
    holds the server, so re-attaching or closing the server frees a
    dropped engine at once (its pages, weight copies and CUDA graphs).
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


def _request_view(req) -> dict:
    """JSON-safe summary of one scheduler ``Request``."""
    return {
        "req_id": req.req_id,
        "state": req.state,
        "prompt_tokens": int(len(req.prompt)),
        "out_tokens": len(req.out_tokens),
        "max_new_tokens": req.max_new_tokens,
        "cache_len": req.cache_len,
        "preemptions": req.preemptions,
        "spec_proposed": req.spec_proposed,
        "spec_accepted": req.spec_accepted,
        "ttft_s": req.ttft,
    }


class TelemetryServer:
    """Background HTTP server exposing a live engine's telemetry.

    ``port=0`` binds an ephemeral port (read ``server.port``). The engine
    may be attached at construction or later via :meth:`attach`; endpoints
    answer 503 until one is attached.
    """

    def __init__(self, engine=None, *, port: int = 0,
                 host: str = "127.0.0.1", step_deadline_s: float = 60.0):
        self._engine = engine
        self.step_deadline_s = float(step_deadline_s)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args) -> None:  # keep stdout clean
                pass

            def do_GET(self) -> None:
                outer._handle(self)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="telemetry", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- lifecycle
    def attach(self, engine) -> None:
        """Point the server at (a new) engine; safe while serving."""
        self._engine = engine

    def url(self, path: str = "") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    # -------------------------------------------------------------- handlers
    def _handle(self, h: BaseHTTPRequestHandler) -> None:
        path = h.path.split("?", 1)[0]
        eng = self._engine
        try:
            if eng is None:
                self._send(h, 503, "application/json",
                           json.dumps({"error": "no engine attached"}))
            elif path == "/metrics":
                self._send(h, 200, "text/plain; version=0.0.4",
                           eng.registry.prometheus())
            elif path == "/healthz":
                body, code = self._healthz(eng)
                self._send(h, code, "application/json", body)
            elif path == "/requests":
                self._send(h, 200, "application/json", self._requests(eng))
            elif path == "/snapshot":
                self._send(h, 200, "application/json",
                           json.dumps(eng.metrics(), allow_nan=False))
            else:
                self._send(h, 404, "application/json",
                           json.dumps({"error": f"no such endpoint {path}"}))
        except Exception as e:  # a broken endpoint must not kill the thread
            try:
                self._send(h, 500, "application/json",
                           json.dumps({"error": repr(e)}))
            except Exception:
                pass

    def _healthz(self, eng):
        last = getattr(eng, "last_step_time", None)
        ready = bool(getattr(eng, "warmed", False) or last is not None)
        age = (time.perf_counter() - last) if last is not None else None
        has_work = eng.scheduler.has_work()
        # liveness: an idle engine is live by definition; one with pending
        # work must have stepped within the deadline (or not started yet)
        live = ((not has_work) or last is None
                or age < self.step_deadline_s)
        body = json.dumps({
            "ready": ready, "live": live, "has_work": has_work,
            "last_step_age_s": age,
            "waiting": len(eng.scheduler.waiting),
            "running": len(eng.scheduler.running),
        })
        return body, (200 if ready and live else 503)

    def _requests(self, eng) -> str:
        sched = eng.scheduler
        waiting = list(sched.waiting)
        running = list(sched.running)
        return json.dumps({
            "waiting": [_request_view(r) for r in waiting],
            "running": [_request_view(r) for r in running],
        })

    @staticmethod
    def _send(h: BaseHTTPRequestHandler, code: int, ctype: str,
              body) -> None:
        data = body.encode() if isinstance(body, str) else body
        h.send_response(code)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)
