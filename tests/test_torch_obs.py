"""The port's observability (``repro_torch.obs``) against the JAX package's.

* The pure-Python modules — tracer, metrics registry, flight recorder — run
  the cases of ``tests/test_obs.py`` and ``tests/test_flight_recorder.py``
  against both packages (their APIs are the same).
* Numerics monitors: on seeded R factors (well- and ill-conditioned,
  singular, under-streamed) both packages give the same grades and cond₁
  within 1e-4 relative.
* Engine wiring on llama3_1b SMOKE: ``metrics()`` keys and registry names
  equal the JAX golden sets (copied below from ``tests/test_obs.py``), the
  counters and the SLO goodput equal the JAX engine's on the same trace, and
  a traced run holds the JAX span taxonomy and a compile instant.
* Flight events: per request, the sequence of event types equals the JAX
  engine's on ``tests/test_flight_recorder.py``'s seeded traces (forks,
  preemption, ring wraparound on odd seeds).
"""
import json
import os
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core.calibrate import Calibrator as JCalibrator
from repro.models import build_model as j_build
from repro.obs import flight as j_flight
from repro.obs import metrics as j_metrics
from repro.obs import numerics as j_numerics
from repro.obs import trace as j_trace
from repro.serve import ContinuousEngine as JEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.calibrate import Calibrator
from repro_torch.obs import flight, metrics, numerics, trace
from repro_torch.serve import ContinuousEngine

from test_flight_recorder import _check_recorder, _run_trace
from test_torch_serve_prefix import varied_tree

torch.set_num_threads(1)
sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "tools"))
from check_prom import lint  # noqa: E402

PKGS = {"jax": types.SimpleNamespace(trace=j_trace, metrics=j_metrics,
                                     flight=j_flight),
        "torch": types.SimpleNamespace(trace=trace, metrics=metrics,
                                       flight=flight)}

# frozen compatibility schema of engine.metrics() (tests/test_obs.py)
METRICS_KEYS = {
    "requests", "requests_per_sec", "new_tokens", "tokens_per_sec",
    "mean_ttft_s", "max_ttft_s", "preemptions",
    "decode_compiles", "decode_shapes", "decode_steps", "decode_tok_per_s",
    "prefill_compiles", "prefill_shapes", "prefill_batches",
    "prefill_tok_per_s", "prefill_kernel",
    "prefix_hit_rate", "prefix_hit_tokens", "cached_blocks",
    "cow_copies", "prefix_evictions", "queue_depth",
    "warmup_seconds", "post_warmup_compiles", "slo_goodput",
}

# frozen registry series names (tests/test_obs.py)
REGISTRY_NAMES = {
    "serve_decode_steps_total", "serve_decode_tokens_total",
    "serve_decode_seconds_total", "serve_prefill_batches_total",
    "serve_prefill_tokens_total", "serve_prefill_seconds_total",
    "serve_prompt_tokens_total", "serve_prefix_hit_tokens_total",
    "serve_requests_finished_total", "serve_new_tokens_total",
    "serve_ttft_seconds", "serve_decode_step_seconds",
    "serve_tpot_seconds", "serve_request_e2e_seconds",
    "serve_slo_goodput",
    "serve_running_requests", "serve_decode_compiles",
    "serve_prefill_compiles",
    "serve_warmup_seconds", "serve_post_warmup_compiles",
    "serve_queue_depth", "serve_queue_wait_seconds",
    "serve_requests_admitted_total", "serve_preemptions_total",
    "pool_cow_copies_total", "pool_prefix_evictions_total",
    "pool_free_blocks", "pool_cached_blocks",
}
SPEC_KEYS = {"spec_k", "spec_rounds", "spec_proposed_tokens",
             "spec_accepted_tokens", "spec_accept_rate"}
SPEC_NAMES = {"serve_spec_rounds_total", "serve_spec_proposed_tokens_total",
              "serve_spec_accepted_tokens_total"}
# counters the two engines must agree on (timings and captures excluded)
SAME_SERIES = ("serve_decode_steps_total", "serve_prefill_batches_total",
               "serve_prompt_tokens_total", "serve_prefix_hit_tokens_total",
               "serve_requests_finished_total", "serve_new_tokens_total",
               "serve_requests_admitted_total", "serve_preemptions_total",
               "pool_cow_copies_total", "pool_prefix_evictions_total",
               "pool_free_blocks", "pool_cached_blocks", "serve_queue_depth",
               "serve_running_requests", "serve_queue_wait_seconds_count",
               "serve_ttft_seconds_count", "serve_tpot_seconds_count",
               "serve_request_e2e_seconds_count")


@pytest.fixture(autouse=True)
def _tracing_off():
    """Both packages' process tracers are off around every test."""
    for p in PKGS.values():
        p.trace.disable()
    yield
    for p in PKGS.values():
        p.trace.disable()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX params, port model) with the same varied weights."""
    jmodel = j_build(j_smoke("llama3_1b"))
    tree = varied_tree(jax.tree.map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(0))))
    port = params_from_numpy(tree, get_smoke_config("llama3_1b"),
                             device="cpu")
    return jmodel, jax.tree.map(jnp.asarray, tree), port


def _engines(models, **kw):
    jmodel, jparams, port = models
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 64)
    kw.setdefault("max_running", 4)
    jeng = JEngine(jmodel, jparams, compute_dtype=jnp.float32,
                   cache_dtype=jnp.float32, async_detok=False, **kw)
    return jeng, ContinuousEngine(port, **kw)


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n,)).astype(np.int32)


def _drain(eng, prompts, max_new):
    for i, p in enumerate(prompts):
        eng.submit(p, max_new)
    while eng.has_work():
        eng.step()
    return {r.req_id: list(r.out_tokens) for r in eng.finished}


# ---------------------------------------------------------------------------
# Tracer (tests/test_obs.py::TestTracer, both packages)
# ---------------------------------------------------------------------------

def test_tracer_disabled_is_shared_noop(pkg, tmp_path):
    t = pkg.trace
    assert not t.enabled()
    assert t.span("a") is t.span("b", x=1)
    t.instant("nothing")
    assert t.save(str(tmp_path / "unused.json")) == 0


def test_tracer_span_and_instant_events(pkg, tmp_path):
    t = pkg.trace
    t.enable()
    with t.span("outer", a=1):
        with t.span("inner"):
            pass
        t.instant("tick", s=2)
    path = tmp_path / "t.json"
    assert t.save(str(path)) == 3
    doc = json.loads(path.read_text())
    by_name = {e["name"]: e for e in doc["traceEvents"] if e.get("ph") != "M"}
    assert by_name["inner"]["ph"] == "X" and by_name["tick"]["ph"] == "i"
    out, inn = by_name["outer"], by_name["inner"]
    assert out["ts"] <= inn["ts"]
    assert inn["ts"] + inn["dur"] <= out["ts"] + out["dur"] + 1e-6
    assert out["args"] == {"a": 1}


def test_tracer_thread_safety_and_per_thread_tids(pkg):
    tr = pkg.trace.enable()
    barrier = threading.Barrier(4)      # keep all 4 idents alive at once

    def work(i):
        barrier.wait()
        for _ in range(50):
            with pkg.trace.span(f"w{i}"):
                pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    evs = tr.events()
    assert len(evs) == 200 and len({e["tid"] for e in evs}) == 4


def test_tracer_enable_idempotent_disable_drops(pkg):
    t1 = pkg.trace.enable()
    assert pkg.trace.enable() is t1 and pkg.trace.current() is t1
    pkg.trace.disable()
    assert pkg.trace.current() is None


def test_tracer_ring_mode_bounds_memory(pkg):
    t = pkg.trace.enable(max_events=10)
    for i in range(25):
        t.instant(f"e{i}")
    assert [e["name"] for e in t.events()] == [f"e{i}" for i in range(15, 25)]
    assert t.dropped == 15
    assert [e["name"] for e in t.tail(3)] == ["e22", "e23", "e24"]


def test_tracer_ring_recap_in_place(pkg):
    t = pkg.trace.enable()
    for i in range(8):
        t.instant(f"e{i}")
    assert pkg.trace.enable(max_events=3) is t
    assert [e["name"] for e in t.events()] == ["e5", "e6", "e7"]
    assert t.dropped == 5
    t.instant("e8")
    assert [e["name"] for e in t.events()] == ["e6", "e7", "e8"]


def _nesting_ok(events):
    """Per tid, complete events nest like a call stack."""
    by_tid = {}
    for e in events:
        if e.get("ph") == "X":
            by_tid.setdefault(e["tid"], []).append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in evs:
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]:
                stack.pop()
            if stack and e["ts"] + e["dur"] > \
                    stack[-1]["ts"] + stack[-1]["dur"] + 1e-3:
                return False
            stack.append(e)
    return True


# ---------------------------------------------------------------------------
# Metrics registry (tests/test_obs.py::TestRegistry, both packages)
# ---------------------------------------------------------------------------

def test_counter_gauge_histogram(pkg):
    reg = pkg.metrics.Registry()
    c = reg.counter("x_total")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("depth", fn=lambda: 42)
    assert g.value == 42
    with pytest.raises(ValueError):
        g.set(3)
    h = reg.histogram("lat_seconds", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    assert h.count == 4 and h.max == 5.0
    assert h.quantile(0.5) == 0.1 and h.quantile(1.0) == 5.0


def test_strict_registration(pkg):
    reg = pkg.metrics.Registry()
    reg.counter("a_total")
    with pytest.raises(ValueError):
        reg.counter("a_total")
    with pytest.raises(ValueError):
        reg.gauge("bad name")
    with pytest.raises(ValueError):
        reg.histogram("h", buckets=(1.0, 0.5))


def test_log_buckets(pkg):
    b = pkg.metrics.log_buckets(1e-3, 1.0, per_decade=1)
    assert b[0] == pytest.approx(1e-3) and b[-1] >= 1.0
    assert all(y > x for x, y in zip(b, b[1:]))
    assert pkg.metrics.LATENCY_BUCKETS == j_metrics.LATENCY_BUCKETS


def test_snapshot_and_reset(pkg):
    reg = pkg.metrics.Registry()
    c = reg.counter("n_total")
    h = reg.histogram("t_seconds", buckets=(1.0, 10.0))
    reg.gauge("live", fn=lambda: 7)
    c.inc(3)
    h.observe(0.5)
    snap = reg.snapshot()
    assert snap["n_total"] == 3 and snap["t_seconds_count"] == 1
    assert snap["live"] == 7
    reg.reset()
    snap = reg.snapshot()
    assert snap["n_total"] == 0 and snap["t_seconds_count"] == 0
    assert snap["live"] == 7


def test_prometheus_exposition_lints_clean(pkg):
    reg = pkg.metrics.Registry()
    reg.counter("req_total", "requests").inc(5)
    reg.gauge("depth", "queue depth").set(2)
    h = reg.histogram("lat_seconds", buckets=(0.1, 1.0), help="latency")
    h.observe(0.05)
    h.observe(3.0)
    text = reg.prometheus()
    assert lint(text) == []
    assert 'lat_seconds_bucket{le="+Inf"} 2' in text
    assert "# TYPE req_total counter" in text


# ---------------------------------------------------------------------------
# Flight recorder ring (tests/test_flight_recorder.py, both packages)
# ---------------------------------------------------------------------------

def test_flight_capacity_must_be_positive(pkg):
    for cap in (0, -5):
        with pytest.raises(ValueError):
            pkg.flight.FlightRecorder(capacity=cap)


def test_flight_bounded_with_drop_accounting(pkg):
    fl = pkg.flight.FlightRecorder(capacity=16)
    for i in range(100):
        fl.record("submit", req_id=i)
    assert len(fl) == 16 and fl.dropped == 84
    assert [e["seq"] for e in fl.events()] == list(range(84, 100))


def test_flight_step_stamping_and_order(pkg):
    fl = pkg.flight.FlightRecorder(capacity=32)
    fl.record("submit", req_id=1)
    fl.begin_step(7)
    for ev, rid in [("submit", 2), ("admit", 1), ("admit", 2), ("finish", 1)]:
        fl.record(ev, req_id=rid)
    assert [e["step"] for e in fl.events()] == [-1, 7, 7, 7, 7]
    assert [e["event"] for e in fl.events_for(1)] == \
        ["submit", "admit", "finish"]
    assert pkg.flight.EVENT_TYPES == j_flight.EVENT_TYPES


def test_flight_dump_is_strict_json(pkg, tmp_path):
    fl = pkg.flight.FlightRecorder(capacity=8,
                                   dump_path=str(tmp_path / "pm.json"))
    fl.record("submit", req_id=0, ratio=float("inf"))
    out = fl.dump(reason="unit", metrics={"bad": float("nan"), "ok": 1.5},
                  config={"dtype": torch.float32})
    with open(out) as f:
        bundle = json.load(
            f, parse_constant=lambda c: pytest.fail(f"non-strict {c}"))
    assert bundle["reason"] == "unit"
    assert bundle["metrics"] == {"bad": None, "ok": 1.5}
    assert bundle["events"][0]["ratio"] is None
    assert bundle["capacity"] == 8 and bundle["dropped"] == 0
    assert bundle["next_seq"] == 1


# ---------------------------------------------------------------------------
# Numerics monitors: the port's grades and cond equal the JAX package's
# ---------------------------------------------------------------------------

def _r_with_cond(n=16, k=64, cond=1e9, seed=0):
    """Upper-triangular R of a (k, n) X of the given condition number
    (tests/test_obs.py's fixture)."""
    rng = np.random.RandomState(seed)
    u, _ = np.linalg.qr(rng.standard_normal((k, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    x = u @ np.diag(np.logspace(0, -np.log10(cond), n)) @ v.T
    return np.linalg.qr(x, mode="r").astype(np.float32)


def _singular_r():
    r = np.triu(np.ones((8, 8), np.float32))
    r[3, 3] = 0.0
    return r


R_CASES = {"well": (lambda: _r_with_cond(cond=1e3, seed=1), 64),
           "warn": (lambda: _r_with_cond(cond=3e6, seed=2), 64),
           "ill": (lambda: _r_with_cond(cond=1e9), 64),
           "singular": (_singular_r, 64),
           "few_tokens": (lambda: _r_with_cond(cond=1e2, seed=3), 8)}


def _same_health(ours, theirs):
    assert [h.path for h in ours] == [h.path for h in theirs]
    for a, b in zip(ours, theirs):
        assert a.level == b.level and a.tokens == b.tokens and a.n == b.n
        if np.isfinite(b.cond):
            assert a.cond == pytest.approx(b.cond, rel=1e-4)
        else:
            assert a.cond == b.cond


@pytest.mark.parametrize("case", sorted(R_CASES))
def test_numerics_r_factor_grades_equal(case):
    make, tokens = R_CASES[case]
    r = make()
    ours = numerics.check_r_factors({case: r}, {case: tokens})
    theirs = j_numerics.check_r_factors({case: r}, {case: tokens})
    _same_health(ours, theirs)
    assert numerics.worst_level(ours) == j_numerics.worst_level(theirs)
    assert "layers checked" in numerics.format_report(ours)


def test_numerics_under_streamed_augmented_grades_equal():
    """Fewer tokens than features: the raw R is singular (FAIL in both),
    the μ-augmented R̃ is graded the same by both packages, and μ <= 0
    grades the raw factor."""
    x = np.random.RandomState(0).randn(7, 16).astype(np.float32)
    cal, jcal = Calibrator(), JCalibrator()
    cal.record("layer", torch.as_tensor(x))
    jcal.record("layer", jnp.asarray(x))
    rf = {"layer": cal.r_factors()["layer"]}
    jrf = jcal.r_factors()
    np.testing.assert_allclose(rf["layer"].T @ rf["layer"],
                               np.asarray(jrf["layer"].T @ jrf["layer"]),
                               atol=1e-5)
    for mus in ({"layer": 1e-2}, {"layer": 0.0}):
        ours = numerics.check_augmented_r_factors(rf, mus, {"layer": 7})
        theirs = j_numerics.check_augmented_r_factors(jrf, mus, {"layer": 7})
        _same_health(ours, theirs)
    assert np.isfinite(numerics.check_augmented_r_factors(
        rf, {"layer": 1e-2})[0].cond)


def test_numerics_residual_vs_bound_grades_equal():
    rep = types.SimpleNamespace
    reports = [rep(path="tight", rel_err_weighted=0.105, rel_err_bound=0.10),
               rep(path="loose", rel_err_weighted=0.5, rel_err_bound=0.10),
               rep(path="broken", rel_err_weighted=2.0, rel_err_bound=0.10),
               rep(path="no_rf", rel_err_weighted=float("nan"),
                   rel_err_bound=float("nan"))]
    ours = numerics.check_compression(reports)
    theirs = j_numerics.check_compression(reports)
    assert [(h.path, h.level) for h in ours] == \
        [(h.path, h.level) for h in theirs] == \
        [("tight", "ok"), ("loose", "warn"), ("broken", "fail")]


# ---------------------------------------------------------------------------
# Engine wiring
# ---------------------------------------------------------------------------

def test_metrics_and_registry_golden_sets(models):
    """Empty and after serving: metrics() keys are METRICS_KEYS and the
    registry's names REGISTRY_NAMES (spec keys only in speculative mode, as
    the JAX engine has them); the snapshot expands each histogram."""
    _, _, port = models
    eng = ContinuousEngine(port, block_size=4, num_blocks=64, max_running=4)
    assert set(eng.metrics()) == METRICS_KEYS
    assert set(eng.registry.names()) == REGISTRY_NAMES
    _drain(eng, [_prompt(6)], 3)
    assert set(eng.metrics()) == METRICS_KEYS
    hists = {n for n in REGISTRY_NAMES
             if isinstance(eng.registry.get(n), metrics.Histogram)}
    assert set(eng.registry.snapshot()) == (REGISTRY_NAMES - hists) | {
        f"{n}{suf}" for n in hists
        for suf in ("_count", "_sum", "_mean", "_p50", "_p99", "_max")}
    json.loads(json.dumps(eng.metrics(), allow_nan=False))
    spec = ContinuousEngine(port, block_size=4, num_blocks=64, max_running=4,
                            draft_model=port, spec_k=2)
    assert set(spec.metrics()) == METRICS_KEYS | SPEC_KEYS
    assert set(spec.registry.names()) == REGISTRY_NAMES | SPEC_NAMES


def test_counters_and_slo_goodput_equal_jax_engine(models):
    """A pool too small for the load (queueing, preemption): every counter
    of the two registries, the greedy tokens and the goodput under
    impossible SLOs are equal; a reset zeroes the port's series."""
    jeng, eng = _engines(models, block_size=2, num_blocks=9, max_running=3,
                         slo_ttft_s=1e-9, slo_tpot_s=1e-9)
    prompts = [_prompt(4, seed=i) for i in range(4)]
    for e in (jeng, eng):
        for p in prompts:
            e.submit(p, 6)
    assert eng.registry.get("serve_queue_depth").value == 4
    jtoks, toks = _drain(jeng, [], 0), _drain(eng, [], 0)
    assert toks == jtoks
    js, ps = jeng.registry.snapshot(), eng.registry.snapshot()
    assert js["serve_preemptions_total"] >= 1
    for name in SAME_SERIES:
        assert ps[name] == js[name], name
    jm, m = jeng.metrics(), eng.metrics()
    for key in ("requests", "new_tokens", "preemptions", "decode_steps",
                "prefill_batches", "decode_shapes", "prefill_shapes",
                "queue_depth", "slo_goodput", "prefix_hit_tokens"):
        assert m[key] == jm[key], key
    assert m["slo_goodput"] == 0.0 and m["prefill_kernel"] == 1.0
    eng.reset_metrics()
    snap = eng.registry.snapshot()
    assert snap["serve_ttft_seconds_count"] == 0
    assert snap["serve_queue_wait_seconds_count"] == 0
    assert snap["serve_preemptions_total"] == 0
    assert eng.metrics()["mean_ttft_s"] is None
    assert eng.registry.get("serve_slo_goodput").value == 1.0


def test_generous_slos_meet_every_request(models):
    _, eng = _engines(models, slo_ttft_s=3600.0, slo_tpot_s=3600.0)
    _drain(eng, [_prompt(6, seed=i) for i in range(2)], 4)
    assert eng.metrics()["slo_goodput"] == 1.0
    assert eng.registry.get("serve_tpot_seconds").count == 2
    assert eng.registry.get("serve_request_e2e_seconds").count == 2


def test_trace_validity_over_served_load(models, tmp_path):
    """Serving with tracing on: strict JSON, the JAX span taxonomy, a
    compile instant, spans nesting per thread; tracing off leaves none."""
    _, _, port = models
    trace.enable()
    eng = ContinuousEngine(port, block_size=4, num_blocks=64, max_running=4)
    _drain(eng, [_prompt(5 + 3 * i, seed=i) for i in range(3)], 4)
    path = tmp_path / "serve_trace.json"
    assert trace.save(str(path)) > 0
    doc = json.loads(path.read_text(),
                     parse_constant=lambda c: pytest.fail(f"non-strict {c}"))
    evs = doc["traceEvents"]
    names = {e["name"] for e in evs}
    assert {"serve.admit", "serve.prefill_batch",
            "serve.decode_step"} <= names
    assert {"serve.decode_compile", "serve.prefill_compile"} <= names
    assert all(e["ph"] in ("X", "i", "M") for e in evs)
    assert _nesting_ok(evs)
    trace.disable()
    eng2 = ContinuousEngine(port, block_size=4, num_blocks=64, max_running=4)
    _drain(eng2, [_prompt(6)], 2)
    assert trace.save(str(tmp_path / "unused.json")) == 0


def test_step_exception_dumps_postmortem(models, tmp_path):
    """A raising step records ``step_exception`` and writes the strict-JSON
    postmortem bundle before propagating."""
    _, _, port = models
    fl = flight.FlightRecorder(capacity=64,
                               dump_path=str(tmp_path / "pm.json"))
    eng = ContinuousEngine(port, block_size=4, num_blocks=64, max_running=4,
                           flight_recorder=fl)
    eng.submit(_prompt(6), 3)
    eng.step()

    def boom(*a, **k):
        raise RuntimeError("boom")

    eng._decode_step = boom
    with pytest.raises(RuntimeError, match="boom"):
        eng.step()
    with open(tmp_path / "pm.json") as f:
        bundle = json.load(f)
    assert bundle["reason"] == "step_exception"
    assert bundle["events"][-1]["event"] == "step_exception"
    assert bundle["config"]["step"] == 2
    assert set(bundle["metrics"]) == METRICS_KEYS


@pytest.mark.parametrize("seed", [0, 1])
def test_flight_events_equal_jax_engine(models, seed):
    """The seeded fork-and-preempt traces of tests/test_flight_recorder.py
    (block 2, 14 pages, 3 running; odd seeds wrap the ring): per request,
    the same event types in the same order as the JAX engine, and the JAX
    recorder invariants hold on the port."""
    jmodel, jparams, port = models
    cfg = types.SimpleNamespace(vocab_size=256)
    kw = dict(block_size=2, num_blocks=14, max_running=3)
    jeng = JEngine(jmodel, jparams, compute_dtype=jnp.float32,
                   cache_dtype=jnp.float32, async_detok=False, **kw)
    eng = ContinuousEngine(port, **kw)
    jfl, jfin = _run_trace(cfg, jeng, seed)
    fl, fin = _run_trace(cfg, eng, seed)
    _check_recorder(fl, fin)
    assert sorted(r.req_id for r in fin) == sorted(r.req_id for r in jfin)
    assert fl.dropped == jfl.dropped
    for r in jfin:
        assert [e["event"] for e in fl.events_for(r.req_id)] == \
            [e["event"] for e in jfl.events_for(r.req_id)], r.req_id
    assert [e["event"] for e in fl.events()] == \
        [e["event"] for e in jfl.events()]


def test_engine_is_freed_without_the_cyclic_collector(models):
    """The registry's gauges, the recalibrator and the flight recorder hold
    no strong reference back to the engine: a dropped engine (with its
    pages and weight copies) goes at once, not at a later cyclic
    collection — which on the card may fall inside a CUDA-graph capture."""
    import gc
    import weakref
    from repro_torch.config import CompressConfig
    from repro_torch.serve import RecalibWorker, TrafficCalibrator
    _, _, port = models
    gc_was_on = gc.isenabled()
    gc.disable()
    try:
        eng = ContinuousEngine(port, block_size=4, num_blocks=64,
                               max_running=4, draft_model=port, spec_k=2,
                               flight_recorder=flight.FlightRecorder(64))
        worker = RecalibWorker(port, TrafficCalibrator(port), CompressConfig(),
                               rank_map={"blocks/0/sub0/mixer/wq": 4})
        eng.attach_recalibrator(worker)
        _drain(eng, [_prompt(6)], 3)
        assert eng.registry.snapshot()["serve_running_requests"] == 0
        refs = [weakref.ref(o) for o in (eng, eng.pool, eng.scheduler)]
        del eng
        assert all(r() is None for r in refs)
    finally:
        if gc_was_on:
            gc.enable()
