"""Live-traffic recalibration of the port (``repro_torch.serve.recalibrate``
and ``ContinuousEngine.hot_swap``) against the JAX package's.

One module-scoped setup: llama3_1b SMOKE weights from the JAX package (the
projections scaled and the norm scales varied, so greedy tokens do not
repeat), JAX-COALA-compressed and handed to the port through numpy, with the
rank map of the JAX reports. On ``tests/test_recalibrate.py``'s trace and
policy (``check_every=1``, ``min_new_tokens=8``) the recalibrating port
engine and the JAX one give the same traffic RᵀR (1e-4), the same sampled
requests, the same solve attempts, swap steps, status and clearance, the
same residual excess (1e-4) and token-exact greedy output before and after
the swaps. The invariants of ``tests/test_recalibrate.py`` follow on the
port alone, plus what is the port's own: the caller's model is never
written, a speculative engine swaps target and draft together, and an async
solve lands between steps.
"""
import copy
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CompressConfig as JCompressConfig
from repro.configs import get_smoke_config as j_smoke
from repro.core.calibrate import Calibrator as JCalibrator
from repro.core.compress import compress_model as j_compress
from repro.core.compress import rank_map_from_reports as j_rank_map
from repro.models import build_model as j_build
from repro.serve import ContinuousEngine as JEngine
from repro.serve import RecalibPolicy as JPolicy
from repro.serve import RecalibWorker as JWorker
from repro.serve import TrafficCalibrator as JTraffic
from repro_torch.config import CompressConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.calibrate import Calibrator
from repro_torch.core.compress import compress_model, rank_map_from_reports
from repro_torch.obs import FlightRecorder, numerics
from repro_torch.serve import (ContinuousEngine, RecalibPolicy, RecalibWorker,
                               TrafficCalibrator)

from test_torch_serve_prefix import varied_tree

torch.set_num_threads(1)

CCFG = dict(method="coala", ratio=0.6, lam=4.0, mu=-1.0)
KNOBS = dict(num_blocks=64, max_running=4)


@pytest.fixture(scope="module")
def setup():
    """JAX (model, params, compressed params, rank map) and the port's
    (dense model, compressed model) holding the same weights."""
    cfg = get_smoke_config("llama3_1b")
    jmodel = j_build(j_smoke("llama3_1b"))
    tree = varied_tree(jax.tree.map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(0))))
    jparams = jax.tree.map(jnp.asarray, tree)
    rng = np.random.RandomState(0)
    jcal = JCalibrator()
    for _ in range(3):
        jmodel.capture_forward(jparams, {"tokens": jnp.asarray(
            rng.randint(0, cfg.vocab_size, (2, 32)))}, jcal)
    jcparams, reports = j_compress(jmodel, jparams, jcal,
                                   JCompressConfig(**CCFG))
    dense = params_from_numpy(tree, cfg, device="cpu")
    cmodel = params_from_numpy(jax.tree.map(np.asarray, jcparams), cfg,
                               device="cpu")
    return dict(cfg=cfg, jmodel=jmodel, jparams=jparams, jcparams=jcparams,
                rank_map=j_rank_map(reports), dense=dense, cmodel=cmodel)


def _trace(cfg, n=4, seed=1):
    rng = np.random.RandomState(seed)
    return [(2 * i, rng.randint(0, cfg.vocab_size, (6 + 5 * i,)), 10)
            for i in range(n)]


def _serve(eng, trace, *, after_step=None):
    """Replay ``trace``; returns {req_id: tokens}. ``after_step(step)`` runs
    after every engine step."""
    pending = list(trace)
    step = 0
    while pending or eng.has_work():
        while pending and pending[0][0] <= step:
            _, prompt, nn = pending.pop(0)
            eng.submit(prompt, nn)
        eng.step()
        if after_step is not None:
            after_step(step)
        step += 1
    return {r.req_id: list(r.out_tokens) for r in eng.finished}


def _engine(s, model=None, **kw):
    return ContinuousEngine(s["cmodel"] if model is None else model,
                            **KNOBS, **kw)


def _attach(eng, s, *, async_solve=False, **pol):
    pol.setdefault("check_every", 1)
    pol.setdefault("min_new_tokens", 8)
    cal = TrafficCalibrator(s["dense"], policy=RecalibPolicy(**pol))
    worker = RecalibWorker(s["dense"], cal, CompressConfig(**CCFG),
                           rank_map=s["rank_map"], async_solve=async_solve)
    eng.attach_recalibrator(worker)
    return worker


def _recalib_run(eng, worker, trace):
    """Serve ``trace``; returns (tokens, [(step, swaps) where swaps grew],
    in-flight requests at the first swap)."""
    swaps, in_flight = [], []

    def note(step):
        if worker.swaps > (swaps[-1][1] if swaps else 0):
            swaps.append((step, worker.swaps))
            if len(swaps) == 1:
                in_flight.append(len(eng.scheduler.running))

    toks = _serve(eng, trace, after_step=note)
    return toks, swaps, (in_flight or [0])[0]


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


# ------------------------------------------------------------ against JAX
@pytest.mark.parametrize("rate", [1.0, 0.5])
def test_recalibration_equals_jax_engine(setup, rate):
    s = setup
    trace = _trace(s["cfg"])
    pol = dict(sample_rate=rate, check_every=1, min_new_tokens=8)
    jeng = JEngine(s["jmodel"], s["jcparams"], compute_dtype=jnp.float32,
                   cache_dtype=jnp.float32, async_detok=False, **KNOBS)
    jcal = JTraffic(s["jmodel"], policy=JPolicy(**pol))
    jworker = JWorker(s["jmodel"], s["jparams"], jcal,
                      JCompressConfig(**CCFG), rank_map=s["rank_map"])
    jeng.attach_recalibrator(jworker)
    jtoks, jswaps, _ = _recalib_run(jeng, jworker, trace)

    eng = _engine(s)
    worker = _attach(eng, s, **pol)
    toks, swaps, _ = _recalib_run(eng, worker, trace)

    assert toks == jtoks                      # before and after the swaps
    assert swaps == jswaps
    if rate == 1.0:
        assert len(swaps) >= 1, worker.summary()
    ours, theirs = worker.summary(), jworker.summary()
    for key in ("swaps", "solve_attempts", "sampled_requests",
                "captured_tokens", "status"):
        assert ours[key] == theirs[key], key
    assert ours["clearance"] == pytest.approx(theirs["clearance"], rel=1e-6)
    if np.isfinite(theirs["residual_excess"]):
        assert ours["residual_excess"] == pytest.approx(
            theirs["residual_excess"], rel=1e-4)
    # the same requests were sampled, with the same streams captured
    assert len(worker.cal.captured_streams) == len(jcal.captured_streams)
    for a, b in zip(worker.cal.captured_streams, jcal.captured_streams):
        np.testing.assert_array_equal(a, b)
    assert worker.cal.tokens_seen() == jcal.tokens_seen()
    rf, jrf = worker.cal.r_factors(), jcal.r_factors()
    assert set(rf) == set(jrf)
    for p in jrf:
        g, jg = (rf[p].T @ rf[p]).numpy(), np.asarray(jrf[p].T @ jrf[p])
        assert np.linalg.norm(g - jg) / np.linalg.norm(jg) < 1e-4, p
    m = eng.metrics()
    jm = jeng.metrics()
    for key in ("recalib_swaps", "recalib_sampled_requests",
                "recalib_captured_tokens"):
        assert m[key] == jm[key], key


# ------------------------------------------------------------ capture
def test_traffic_r_matches_offline_replay(setup):
    """Traffic-captured R equals an offline Calibrator fed the same sampled
    streams through the dense model, as RᵀR."""
    s = setup
    eng = _engine(s)
    worker = _attach(eng, s, min_token_factor=1e9)
    _serve(eng, _trace(s["cfg"]))
    cal = worker.cal
    assert cal.sampled_requests == 4 and cal.captured_streams
    offline = Calibrator()
    for stream in cal.captured_streams:
        s["dense"].capture_forward(torch.as_tensor(stream)[None], offline)
    rf_t, rf_o = cal.r_factors(), offline.r_factors()
    assert set(rf_t) == set(rf_o)
    assert cal.tokens_seen() == offline.tokens_seen()
    for p in rf_o:
        g_t, g_o = rf_t[p].T @ rf_t[p], rf_o[p].T @ rf_o[p]
        assert float(torch.linalg.norm(g_t - g_o)
                     / torch.linalg.norm(g_o)) < 1e-4, p


def test_incremental_capture_counts_positions_once(setup):
    """A re-admission after preemption adds only the new positions; the
    completion capture only the generated tail."""
    s = setup
    cal = TrafficCalibrator(s["dense"], policy=RecalibPolicy())

    class Req:
        req_id = 7
        prompt = np.arange(6, dtype=np.int32)
        out_tokens = []

        def prefill_tokens(self):
            return np.concatenate(
                [self.prompt, np.asarray(self.out_tokens, np.int32)])

    req = Req()
    cal.on_prefill(req)
    assert cal.captured_tokens == 6
    req.out_tokens = [1, 2, 3]
    cal.on_prefill(req)
    assert cal.captured_tokens == 9
    req.out_tokens = [1, 2, 3, 4, 5]
    cal.on_finish(req)
    assert cal.captured_tokens == 10
    assert set(cal.tokens_seen().values()) == {10}
    (stream,) = cal.captured_streams
    np.testing.assert_array_equal(stream,
                                  np.concatenate([req.prompt, [1, 2, 3, 4]]))


# ------------------------------------------------------------ swap exactness
def test_identity_hot_swap_is_token_exact(setup):
    """Swapping copies of the live weights after every step with requests
    in flight changes no token of any request."""
    s = setup
    trace = _trace(s["cfg"])
    ref = _serve(_engine(s), trace)
    eng = _engine(s)
    swaps = []

    def swap(step):
        if eng.scheduler.running:
            eng.hot_swap(copy.deepcopy(s["cmodel"]))
            swaps.append(step)

    assert _serve(eng, trace, after_step=swap) == ref
    assert swaps and eng._swap_epoch == len(swaps)


def test_real_swap_mid_trace_keeps_caller_model(setup):
    """A bound-cleared swap lands with requests in flight, every request
    completes, the served weights are the solve's, and the caller's model
    is bit-equal to what it was."""
    s = setup
    before = _state(s["cmodel"])
    eng = _engine(s)
    worker = _attach(eng, s)
    solved = []
    solve = worker._solve
    worker._solve = lambda snap: solved.append(solve(snap)) or solved[-1]
    trace = _trace(s["cfg"])
    _, swaps, in_flight = _recalib_run(eng, worker, trace)
    assert swaps and in_flight > 0, worker.summary()
    assert worker.last_excess <= worker.policy.max_residual_excess
    assert len(eng.finished) == len(trace)
    assert all(len(r.out_tokens) == r.max_new_tokens for r in eng.finished)
    for k, v in s["cmodel"].state_dict().items():
        assert torch.equal(v, before[k]), k
    last = [r for r in solved if r is not None][-1][0].state_dict()
    served = eng._target.state_dict()
    assert all(torch.equal(served[k], v) for k, v in last.items())
    assert any(not torch.equal(served[k], before[k]) for k in before)


def test_hot_swap_rejects_shape_and_key_changes(setup):
    """Rank-unstable factors, a dense model in place of a factored one and
    a draft on a non-speculative engine are refused before any write."""
    s = setup
    eng = _engine(s)
    live = _state(eng._target)
    cal = Calibrator()
    s["dense"].capture_forward(torch.arange(40)[None] % 256, cal)
    smaller = {p: r - 1 for p, r in s["rank_map"].items()}
    bad, _ = compress_model(s["dense"], cal, CompressConfig(**CCFG),
                            rank_map=smaller)
    with pytest.raises(ValueError, match="shape/dtype"):
        eng.hot_swap(bad)
    with pytest.raises(ValueError, match="treedef"):
        eng.hot_swap(s["dense"])
    with pytest.raises(ValueError, match="speculative"):
        eng.hot_swap(s["cmodel"], s["cmodel"])
    for k, v in eng._target.state_dict().items():
        assert torch.equal(v, live[k]), k


# ----------------------------------------------------------------- gating
def test_no_swap_before_data_gate_clears(setup):
    s = setup
    ref = _serve(_engine(s), _trace(s["cfg"]))
    eng = _engine(s)
    worker = _attach(eng, s, min_token_factor=1e9)
    assert _serve(eng, _trace(s["cfg"])) == ref
    assert worker.swaps == 0 and worker.solve_attempts == 0
    assert worker.last_status == "collecting"
    assert 0.0 <= worker.clearance() < 1.0


def test_sampling_rate_zero_captures_nothing(setup):
    s = setup
    eng = _engine(s)
    worker = _attach(eng, s, sample_rate=0.0)
    _serve(eng, _trace(s["cfg"]))
    assert worker.cal.sampled_requests == 0
    assert worker.cal.captured_tokens == 0
    assert worker.swaps == 0 and worker.clearance() == 0.0


def test_augmented_cond_gate_uses_mu():
    """With fewer tokens than features the raw R is singular (inf, FAIL);
    the μ-augmented R̃ the solve uses is finite and passes; μ <= 0 grades
    the raw factor."""
    cal = Calibrator()
    cal.record("layer", torch.as_tensor(
        np.random.RandomState(0).randn(7, 16), dtype=torch.float32))
    rf = cal.r_factors()
    raw = numerics.check_r_factors(rf)
    assert raw[0].cond == float("inf") and raw[0].level == numerics.FAIL
    aug = numerics.check_augmented_r_factors(rf, {"layer": 1e-2})
    assert np.isfinite(aug[0].cond) and aug[0].level != numerics.FAIL
    assert numerics.check_augmented_r_factors(
        rf, {"layer": 0.0})[0].cond == float("inf")


# ---------------------------------------------------------------- metrics
def test_recalib_metrics_only_when_attached(setup):
    s = setup
    plain = _engine(s)
    assert not any("recalib" in k for k in plain.metrics())
    assert not any("recalib" in n for n in plain.registry.snapshot())
    eng = _engine(s)
    worker = _attach(eng, s)
    _serve(eng, _trace(s["cfg"]))
    m = eng.metrics()
    assert m["recalib_swaps"] == worker.swaps >= 1
    assert m["recalib_sampled_requests"] == 4
    assert m["recalib_captured_tokens"] == worker.cal.captured_tokens > 0
    assert m["recalib_clearance"] >= 1.0
    assert np.isfinite(m["recalib_residual_excess"])
    snap = eng.registry.snapshot()
    assert snap["serve_recalib_swaps_total"] == worker.swaps
    assert snap["serve_recalib_captured_tokens_total"] == \
        worker.cal.captured_tokens
    assert snap["serve_recalib_sampled_requests_total"] == 4
    assert snap["serve_recalib_tokens_seen_min"] == worker.min_tokens_seen()
    assert snap["serve_recalib_bound_clearance"] == pytest.approx(
        worker.clearance())


def test_worker_rejects_empty_rank_map(setup):
    s = setup
    cal = TrafficCalibrator(s["dense"], policy=RecalibPolicy())
    ccfg = CompressConfig(**CCFG)
    with pytest.raises(ValueError, match="rank_map"):
        RecalibWorker(s["dense"], cal, ccfg, rank_map={})
    with pytest.raises(ValueError, match="draft_rank_map"):
        RecalibWorker(s["dense"], cal, ccfg, rank_map=s["rank_map"],
                      draft_ratio=0.4)


def test_rank_map_recompression_is_shape_stable(setup):
    """A pinned rank_map reproduces the served model's shapes and dtypes
    from other calibration data, and overrides ratio and rank."""
    s = setup
    cal = Calibrator()
    s["dense"].capture_forward(torch.as_tensor(np.random.RandomState(9).randint(
        0, 256, (1, 40))), cal)
    for ccfg in (CompressConfig(**CCFG),
                 dataclasses.replace(CompressConfig(**CCFG), ratio=0.2,
                                     rank=3)):
        model, reports = compress_model(s["dense"], cal, ccfg,
                                        rank_map=s["rank_map"])
        ref = s["cmodel"].state_dict()
        got = model.state_dict()
        assert list(got) == list(ref)
        assert all(got[k].shape == v.shape and got[k].dtype == v.dtype
                   for k, v in ref.items())
        assert {r.path: r.rank for r in reports} == s["rank_map"]


def test_speculative_target_and_draft_swap_together(setup):
    """In speculative mode the worker recompresses the draft with its own
    pinned ranks and one swap writes both served copies."""
    s = setup
    cal = Calibrator()
    s["dense"].capture_forward(torch.as_tensor(np.random.RandomState(3).randint(
        0, 256, (2, 32))), cal)
    draft, dreports = compress_model(
        s["dense"], cal, dataclasses.replace(CompressConfig(**CCFG),
                                             ratio=0.3))
    eng = _engine(s, draft_model=draft, spec_k=2)
    tcal = TrafficCalibrator(s["dense"], policy=RecalibPolicy(
        check_every=1, min_new_tokens=8))
    worker = RecalibWorker(s["dense"], tcal, CompressConfig(**CCFG),
                           rank_map=s["rank_map"], draft_ratio=0.3,
                           draft_rank_map=rank_map_from_reports(dreports))
    eng.attach_recalibrator(worker)
    solved = []
    solve = worker._solve
    worker._solve = lambda snap: solved.append(solve(snap)) or solved[-1]
    trace = _trace(s["cfg"])
    _serve(eng, trace)
    assert worker.swaps >= 1 and len(eng.finished) == len(trace)
    target, dmodel = [r for r in solved if r is not None][-1]
    for served, new in ((eng._target, target), (eng._draft, dmodel)):
        live = served.state_dict()
        assert all(torch.equal(live[k], v)
                   for k, v in new.state_dict().items())
    with pytest.raises(ValueError, match="shape/dtype"):
        eng.hot_swap(target, target)       # the draft's ranks differ


def test_async_solve_lands_between_steps(setup):
    """An async solve runs off the engine's thread and its staged swap is
    applied on it at the top of a step, before that step admits anything;
    the served weights end as the last staged solve's."""
    s = setup
    fl = FlightRecorder(capacity=4096)
    eng = _engine(s, flight_recorder=fl)
    worker = _attach(eng, s, async_solve=True)
    solved, swapped_on = [], []
    solve = worker._solve
    worker._solve = lambda snap: solved.append(solve(snap)) or solved[-1]
    swap = eng.hot_swap

    def on_main(*a):
        swapped_on.append(threading.current_thread() is threading.main_thread())
        swap(*a)

    eng.hot_swap = on_main
    trace = _trace(s["cfg"]) + [(10, np.arange(20) % 256, 10)]
    _serve(eng, trace, after_step=lambda _: worker.join(timeout=120))
    assert worker.swaps >= 1 and all(swapped_on)
    assert len(eng.finished) == len(trace)
    evs = fl.events()
    for i, e in enumerate(evs):
        if e["event"] == "recalib_swap":
            assert all(p["step"] < e["step"] for p in evs[:i])
    staged = [r for r in solved if r is not None]
    assert len(staged) >= worker.swaps
