"""The port's host pipeline and live telemetry, on the CPU: the detokenize
worker against the inline oracle, the offline lane, ``TelemetryServer``
against a live port engine, and the serving launcher's fixed-batch mode and
its ``--offline --detok-async --telemetry-port`` flags.

The cases mirror the JAX package's own on its engine:
tests/test_warmup.py:112-160 (async detokenize parity and callback order,
offline-lane parity and input order; its traces are imported) and
tests/test_telemetry.py (endpoints over loopback, /metrics linted by
tools/check_prom.py). SMOKE smollm with projections x3 and random norm
scales (``varied_tree``), fp32, greedy.
"""
import gc
import json
import os
import sys
import threading
import urllib.error
import urllib.request
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.obs import FlightRecorder, TelemetryServer
from repro_torch.serve import ContinuousEngine
from repro_torch.serve.detokenize import DetokenizeWorker, StreamEvent
from test_torch_serve_prefix import varied_tree
from test_warmup import _serve_staggered, _trace

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "tools"))
from check_prom import lint  # noqa: E402

torch.set_num_threads(1)

NAME = "smollm_135m"


@pytest.fixture(scope="module")
def smollm():
    tree = varied_tree(jax.tree.map(np.asarray, j_build(j_smoke(NAME)).init(
        jax.random.PRNGKey(0))))
    cfg = get_smoke_config(NAME)
    return cfg, params_from_numpy(tree, cfg, device="cpu")


def _engine(model, **kw):
    """tests/test_warmup.py's engine knobs."""
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 24)
    kw.setdefault("max_running", 2)
    kw.setdefault("prefill_bucket_sizes", (8,))
    return ContinuousEngine(model, **kw)


# ---------------------------------------------------------------------------
# detokenize worker and offline lane
# ---------------------------------------------------------------------------

def test_async_detok_parity_and_callback_order(smollm):
    cfg, model = smollm
    reqs = _trace(cfg, seed=5)
    detok = lambda t: f"<{t}>"          # noqa: E731
    threads = set()

    def serve(async_on):
        events = []

        def cb(e):
            threads.add((async_on, threading.current_thread().name))
            events.append(e)
        eng = _engine(model, detokenizer=detok, async_detok=async_on)
        fins = _serve_staggered(eng, reqs, stream_callback=cb)
        eng.flush_stream()
        return fins, events

    sync_fins, sync_events = serve(False)
    async_fins, async_events = serve(True)
    for s, a in zip(sync_fins, async_fins):
        assert s.out_tokens == a.out_tokens          # token-exact greedy
        assert s.text == a.text == "".join(f"<{t}>" for t in s.out_tokens)
    for fins, events in ((sync_fins, sync_events), (async_fins, async_events)):
        for r in fins:
            evs = [e for e in events if e.req_id == r.req_id]
            assert [e.token for e in evs] == r.out_tokens
            assert [e.index for e in evs] == list(range(len(evs)))
            assert [e.done for e in evs] == [False] * (len(evs) - 1) + [True]
            assert [e.text for e in evs] == [f"<{t}>" for t in r.out_tokens]
            assert all(type(e.token) is int for e in evs)   # never a tensor
    key = lambda e: (e.req_id, e.index, e.token, e.text, e.done)  # noqa: E731
    assert sorted(map(key, sync_events)) == sorted(map(key, async_events))
    # inline on the dispatch thread, or on the worker's own
    assert {n for a, n in threads if not a} == {threading.current_thread().name}
    assert {n for a, n in threads if a} == {"serve-detokenize"}


def test_no_detok_work_without_detokenizer_or_callback(smollm):
    cfg, model = smollm
    eng = _engine(model)
    _serve_staggered(eng, _trace(cfg, seed=2))
    assert eng._detok._thread is None          # the worker never started
    assert all(r.text == "" for r in eng.finished)


def test_worker_counts_callback_errors_and_restarts():
    class Req:
        req_id, text = 0, ""

        @staticmethod
        def stream_callback(e: StreamEvent):
            if e.index == 1:
                raise RuntimeError("user callback")
    w = DetokenizeWorker(lambda t: str(t))
    r = Req()
    for i, t in enumerate((7, 8, 9)):
        w.submit(r, t, i, i == 2)
    w.flush()
    assert r.text == "789" and w.callback_errors == 1
    w.close()
    w.submit(r, 1, 3, True)                    # a closed worker restarts
    w.close()
    assert r.text == "7891"


def test_offline_lane_parity(smollm):
    cfg, model = smollm
    reqs = _trace(cfg, seed=7)
    online = _engine(model)
    ids = [online.submit(p, n) for p, n in reqs]
    fin = {r.req_id: r for r in online.run()}
    offline = _engine(model)
    results = offline.run_offline(reqs)
    assert len(results) == len(reqs)
    for (prompt, _), rid, res in zip(reqs, ids, results):
        np.testing.assert_array_equal(res.prompt, prompt)  # input order kept
        assert res.out_tokens == fin[rid].out_tokens       # token parity
    m = offline.metrics()
    assert m["requests"] == len(reqs)
    assert m["prefill_batches"] < len(reqs)
    # dict requests with submit() kwargs, unsorted
    again = _engine(model).run_offline(
        [dict(prompt_tokens=p, max_new_tokens=n) for p, n in reqs],
        sort_by_length=False)
    assert [r.out_tokens for r in again] == [r.out_tokens for r in results]


def test_stream_yields_finished_requests(smollm):
    cfg, model = smollm
    eng = _engine(model)
    for p, n in _trace(cfg, seed=1):
        eng.submit(p, n)
    got = list(eng.stream())
    assert sorted(r.req_id for r in got) == list(range(5))
    assert all(r.done and r.state == "finished" for r in got)


# ---------------------------------------------------------------------------
# telemetry server (tests/test_telemetry.py on the port's engine)
# ---------------------------------------------------------------------------

def _get(server, path):
    """(status, body, content-type); HTTP errors return, not raise."""
    try:
        with urllib.request.urlopen(server.url(path), timeout=10) as r:
            return r.getcode(), r.read().decode(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), e.headers.get("Content-Type")


@pytest.fixture()
def server():
    srv = TelemetryServer(port=0)
    yield srv
    srv.close()


def _prompt(cfg, n, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (n,)).astype(
        np.int32)


def _drain(eng, cfg, n_requests=2, new_tokens=3):
    for i in range(n_requests):
        eng.submit(_prompt(cfg, 5 + i, seed=i), new_tokens)
    while eng.has_work():
        eng.step()


def _strict(body):
    return json.loads(body, parse_constant=lambda c: pytest.fail(f"non-strict {c}"))


def test_server_lifecycle(smollm, server):
    """Distinct ephemeral ports, 503 before attach, 404 on an unknown path,
    and re-attaching one port to the next engine."""
    cfg, model = smollm
    other = TelemetryServer(port=0)
    try:
        assert server.port > 0 and other.port != server.port
    finally:
        other.close()
    code, body, _ = _get(server, "/metrics")
    assert code == 503 and "no engine" in json.loads(body)["error"]
    server.attach(_engine(model, num_blocks=64, max_running=4))
    assert _get(server, "/metrics")[0] == 200
    assert _get(server, "/nope")[0] == 404
    eng1 = _engine(model, num_blocks=64, max_running=4)
    server.attach(eng1)
    _drain(eng1, cfg, n_requests=1)
    server.attach(_engine(model, num_blocks=64, max_running=4))
    assert _strict(_get(server, "/snapshot")[1])["requests"] == 0


def test_metrics_snapshot_and_requests_endpoints(smollm, server):
    cfg, model = smollm
    eng = _engine(model, num_blocks=64, max_running=1)
    server.attach(eng)
    snap = _strict(_get(server, "/snapshot")[1])     # nothing finished yet
    assert snap["requests"] == 0 and snap["mean_ttft_s"] is None
    eng.submit(_prompt(cfg, 5, seed=0), 8)
    eng.submit(_prompt(cfg, 6, seed=1), 8)
    eng.step()                       # admits one, queues the other
    code, body, _ = _get(server, "/requests")
    reqs = json.loads(body)
    assert code == 200
    assert len(reqs["running"]) == 1 and len(reqs["waiting"]) == 1
    run = reqs["running"][0]
    assert run["state"] == "running" and run["out_tokens"] >= 1
    assert run["prompt_tokens"] == 5 and run["ttft_s"] > 0
    assert reqs["waiting"][0]["state"] == "waiting"
    while eng.has_work():
        eng.step()
    assert json.loads(_get(server, "/requests")[1]) == {"waiting": [],
                                                        "running": []}
    code, text, ctype = _get(server, "/metrics")
    assert code == 200 and ctype == "text/plain; version=0.0.4"
    assert lint(text) == []
    assert "serve_requests_finished_total 2" in text
    snap = _strict(_get(server, "/snapshot")[1])
    assert snap["requests"] == 2 and snap["mean_ttft_s"] > 0


def test_healthz_readiness_and_liveness(smollm, server):
    cfg, model = smollm
    eng = _engine(model, num_blocks=64, max_running=4)
    server.attach(eng)
    code, body, _ = _get(server, "/healthz")
    h = json.loads(body)
    assert code == 503 and h["ready"] is False and h["live"] is True
    eng.submit(_prompt(cfg, 5), 8)
    eng.step()
    code, body, _ = _get(server, "/healthz")
    h = json.loads(body)
    assert code == 200 and h["ready"] is True
    assert h["last_step_age_s"] >= 0 and h["running"] == 1
    warm = _engine(model, num_blocks=64, max_running=4)
    server.attach(warm)
    assert _get(server, "/healthz")[0] == 503
    warm.warmup(max_len=16)          # an eager engine captures nothing
    assert warm.warmed and _get(server, "/healthz")[0] == 200
    stalled = _engine(model, num_blocks=64, max_running=4)
    srv = TelemetryServer(stalled, port=0, step_deadline_s=1e-9)
    try:
        stalled.submit(_prompt(cfg, 5), 4)
        stalled.step()               # ready now; the deadline already blown
        code, body, _ = _get(srv, "/healthz")
        h = json.loads(body)
        assert code == 503 and h["ready"] is True and h["live"] is False
        while stalled.has_work():
            stalled.step()           # drained: an idle engine is live again
        assert _get(srv, "/healthz")[0] == 200
    finally:
        srv.close()


def test_endpoint_exception_returns_500(server):
    class Broken:
        class registry:                      # noqa: N801 — stand-in
            @staticmethod
            def prometheus():
                raise RuntimeError("boom")
    server.attach(Broken())
    code, body, _ = _get(server, "/metrics")
    assert code == 500 and "boom" in json.loads(body)["error"]


def test_dropped_engine_is_freed(smollm, server):
    """An engine whose detokenize worker has started and which a server had
    attached is freed as soon as the server lets it go: no cycle through the
    worker's thread or the registry."""
    cfg, model = smollm
    eng = _engine(model, detokenizer=str, flight_recorder=FlightRecorder(64))
    server.attach(eng)
    _drain(eng, cfg)
    eng.flush_stream()
    assert eng._detok._thread.is_alive()
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        server.attach(None)
        assert ref() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_fixed_batch_mode():
    """Without --continuous: ``run_fixed`` on the pipeline's first batch,
    qwen2-vl's with its vision prefix, compressed first; the tokens equal a
    continuous engine's ``generate`` of the same inputs."""
    from repro_torch.launch import serve as launcher
    out = launcher.main(["--arch", "qwen2_vl_2b", "--smoke", "--requests", "3",
                         "--prompt-len", "12", "--new-tokens", "5",
                         "--compress-ratio", "0.6", "--device", "cpu"])
    batch, toks = out["batch"], out["tokens"]
    assert toks.shape == (3, 12 + 5)
    assert set(batch) == {"tokens", "vision_embeds"}
    assert set(out["seconds"]) >= {"calibrate", "compress", "serve_fixed", "init"}
    assert any(lin.is_factored for lin in out["model"].modules()
               if hasattr(lin, "is_factored"))
    cont = ContinuousEngine(out["model"], block_size=4, num_blocks=64,
                            max_running=3)
    np.testing.assert_array_equal(
        cont.generate(batch["tokens"], 5,
                      extras={"vision_embeds": batch["vision_embeds"]}), toks)


def test_launcher_offline_async_with_telemetry(capsys):
    from repro_torch.launch import serve as launcher
    out = launcher.main(["--continuous", "--smoke", "--arch", NAME,
                         "--requests", "4", "--new-tokens", "6", "--offline",
                         "--detok-async", "on", "--telemetry-port", "0",
                         "--device", "cpu"])
    printed = capsys.readouterr().out
    assert f"listening on http://127.0.0.1:{out['telemetry_port']}" in printed
    assert printed.count("eager, offline)") == 2
    for name in ("dense", "coala"):
        assert out["metrics"][name]["requests"] == 4
        assert out["engines"][name].async_detok
