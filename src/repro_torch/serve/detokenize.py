"""Async host pipeline: detokenize + stream callbacks off the dispatch thread
(the port's own copy of ``repro/serve/detokenize.py``).

``ContinuousEngine.step()`` must return as soon as the next device step is
dispatched — per-token host work (detokenizing the emitted token, invoking
the user's stream callback) has no business on that thread. This module
gives the engine a single background worker thread fed by a FIFO queue:
every token the engine emits is enqueued as an O(1) handoff, and the worker
detokenizes and runs callbacks in emission order (one queue, one consumer,
so per-request event order is exactly the emission order — token-identical
to the synchronous inline path, which ``async_detok=False`` keeps as the
in-tree oracle).

The worker names its own lane in the span tracer (``trace.name_thread``),
so a ``--trace-out`` capture shows detokenize/callback spans on a separate
track from the device-dispatch thread — the MaxText MLPerf harness's
background detokenize thread, in this engine's vocabulary.

The thread starts lazily on the first emission (engines without callbacks
or a detokenizer never spawn it) and is a daemon; ``flush()`` blocks until
every enqueued event has been delivered (``ContinuousEngine.run()`` and
``run_offline()`` flush before returning). Callback exceptions are counted
(``callback_errors``) and swallowed — a user callback must not be able to
kill the serving pipeline.

The engine hands the worker Python ints (the token, its index), never a
tensor: a callback on this thread cannot touch a tensor that a CUDA graph
owns or race the dispatch thread's device work.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Optional

from repro_torch.obs import trace


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One streamed token, as delivered to a request's ``stream_callback``."""
    req_id: int
    index: int                  # 0-based position in the request's output
    token: int
    text: Optional[str]         # detokenized piece (None without detokenizer)
    done: bool                  # True on the request's final token


def deliver(req, token: int, index: int, done: bool,
            detokenizer: Optional[Callable[[int], str]]) -> None:
    """Detokenize one token into ``req.text`` and fire its callback — the
    shared delivery step of the async worker and the synchronous oracle."""
    piece = None
    if detokenizer is not None:
        piece = detokenizer(token)
        req.text += piece
    if req.stream_callback is not None:
        req.stream_callback(StreamEvent(req_id=req.req_id, index=index,
                                        token=token, text=piece, done=done))


class DetokenizeWorker:
    """FIFO background consumer for detokenize + stream-callback work."""

    def __init__(self, detokenizer: Optional[Callable[[int], str]] = None,
                 name: str = "serve-detokenize"):
        self.detokenizer = detokenizer
        self.callback_errors = 0
        self._name = name
        self._q: queue.Queue = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run, daemon=True,
                                                name=self._name)
                self._thread.start()

    def submit(self, req, token: int, index: int, done: bool) -> None:
        """Enqueue one emission; O(1) on the caller (dispatch) thread."""
        self._ensure_thread()
        self._q.put((req, token, index, done))

    def _run(self) -> None:
        trace.name_thread("detokenize")
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                req, token, index, done = item
                with trace.span("serve.detokenize", req_id=req.req_id,
                                index=index, done=done):
                    try:
                        deliver(req, token, index, done, self.detokenizer)
                    except Exception:
                        self.callback_errors += 1
            finally:
                self._q.task_done()

    def flush(self) -> None:
        """Block until every enqueued event has been delivered."""
        self._q.join()

    def close(self) -> None:
        """Drain, then stop the worker thread (it restarts on next use)."""
        self.flush()
        with self._lock:
            t = self._thread
            if t is None or not t.is_alive():
                return
            self._q.put(None)
            self._thread = None
        t.join()
