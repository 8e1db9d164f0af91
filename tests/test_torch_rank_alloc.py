"""Adaptive per-layer ranks (``core/rank_alloc.py`` and the ``adaptive_rank``
branch of ``compress_model``) vs the JAX package, on the CPU.

The rank maps must be EQUAL, rank for rank: the same water-filling over the
same groups (every rep of a layer position in one group, expert banks left
out). Reports are compared as in tests/test_torch_compress.py (relative
errors and bounds at rtol 1e-4), compressed logits at 1e-4, and the engine's
greedy tokens exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CompressConfig as JCompressConfig
from repro.configs import get_smoke_config as j_smoke
from repro.core import rank_alloc as jrank
from repro.core.calibrate import Calibrator as JCalibrator
from repro.core.calibrate import calibrate_model as j_calibrate
from repro.core.compress import compress_model as j_compress
from repro.core.compress import compressible as j_compressible
from repro.launch.serve import serve_trace as j_serve_trace
from repro.launch.serve import synthetic_trace as j_synthetic_trace
from repro.models import build_model as j_build
from repro.serve import ContinuousEngine as JEngine
from repro_torch.config import CompressConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import rank_alloc
from repro_torch.core.calibrate import calibrate_model
from repro_torch.core.compress import adaptive_ranks, compress_model, compression_summary
from repro_torch.launch.serve import serve_trace, synthetic_trace
from repro_torch.serve import ContinuousEngine

torch.set_num_threads(1)

RATIO = 0.6
KNOBS = dict(block_size=4, num_blocks=14, max_running=3, bucket_sizes=(3,),
             prefill_bucket_sizes=(32,))
TRACE = dict(seed=1, min_prompt=4, max_prompt=20, max_new=12, arrival_every=1)


def _jax_weights(params, r_factors):
    """The weights the reference's adaptive branch collects
    (``repro/core/compress.py:222-243``): per rep of the stack, every 2-D
    ``w`` with an R factor at a compressible path."""
    weights = {}

    def collect(node, path):
        if isinstance(node, dict):
            if "w" in node and getattr(node["w"], "ndim", 0) == 2:
                p = "/".join(path)
                if p in r_factors and j_compressible(tuple(path) + ("w",),
                                                     node["w"].shape):
                    weights[p] = node["w"]
                return
            for k, v in node.items():
                collect(v, path + [k])
        elif isinstance(node, list):
            for i, v in enumerate(node):
                collect(v, path + [str(i)])

    n_rep = jax.tree.leaves(params["blocks"])[0].shape[0]
    for r in range(n_rep):
        collect(jax.tree.map(lambda a: a[r], params["blocks"]), ["blocks", str(r)])
    collect({k: v for k, v in params.items() if k != "blocks"}, [])
    return weights


_CALIBRATED = {}


def _calibrated(name):
    """Both packages from the same JAX parameters, calibrated on the same
    tokens (once per module and config)."""
    if name not in _CALIBRATED:
        _CALIBRATED[name] = _calibrate(name)
    return _CALIBRATED[name]


@pytest.fixture(scope="module", params=["llama3_1b", "deepseek_moe_16b"])
def calibrated(request):
    return _calibrated(request.param)


@pytest.fixture(scope="module")
def llama():
    return _calibrated("llama3_1b")


def _calibrate(name):
    jmodel = j_build(j_smoke(name))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(name)
    rng = np.random.RandomState(0)
    toks = [rng.randint(0, cfg.vocab_size, (4, 24)).astype(np.int32)
            for _ in range(2)]
    jcal = j_calibrate(jmodel, jparams, [{"tokens": jnp.asarray(t)} for t in toks])
    tree = jax.tree.map(np.asarray, jparams)
    tmodel = params_from_numpy(tree, cfg, device="cpu")
    tcal = calibrate_model(tmodel, [torch.from_numpy(t) for t in toks])
    return name, (jmodel, jparams, jcal), (tmodel, tcal), toks


@pytest.mark.parametrize("path,want", [
    ("blocks/3/sub0/mixer/wq", "blocks/*/sub0/mixer/wq"),
    ("enc/12/attn/wo", "enc/*/attn/wo"),
    ("prefix/0/ffn/up", "prefix/0/ffn/up"),
    ("blocks/x/sub0", "blocks/x/sub0")])
def test_default_group_matches_jax(path, want):
    assert rank_alloc.default_group(path) == jrank.default_group(path) == want


def test_adaptive_rank_map_matches_jax(calibrated):
    """On the reference's weights and R factors (through numpy) and on the
    port's own model and calibration: the same map, rank for rank, with every
    rep of a layer position at one rank and more than one distinct rank."""
    name, (_, jparams, jcal), (tmodel, tcal), _ = calibrated
    jrf = jcal.r_factors()
    jw = _jax_weights(jparams, jrf)
    want = jrank.adaptive_rank_map(jw, jrf, RATIO)
    got = rank_alloc.adaptive_rank_map(
        {p: torch.from_numpy(np.array(w)) for p, w in jw.items()},
        {p: torch.from_numpy(np.array(jrf[p])) for p in jw}, RATIO)
    assert got == want
    assert adaptive_ranks(tmodel, tcal.r_factors(), RATIO) == want
    assert not any("/expert" in p for p in want)
    assert len(set(want.values())) > 1
    by_group = {}
    for p, r in want.items():
        by_group.setdefault(rank_alloc.default_group(p), set()).add(r)
    assert all(len(v) == 1 for v in by_group.values())
    cost = sum(r * sum(jw[p].shape) for p, r in want.items())
    assert cost <= RATIO * sum(np.prod(w.shape) for w in jw.values())


def test_adaptive_rank_map_respects_budget_and_min_rank():
    """A tiny budget leaves every group at min_rank; the water-filling gives
    the extra ranks to the group whose spectrum decays slowest."""
    rng = np.random.RandomState(3)
    w = {"blocks/0/a/wq": rng.randn(16, 16).astype(np.float32),
         "blocks/1/a/wq": rng.randn(16, 16).astype(np.float32),
         "blocks/0/a/wk": (rng.randn(16, 16) * 0.01).astype(np.float32)}
    r = {p: np.eye(16, dtype=np.float32) for p in w}
    for ratio in (0.01, 0.3, 0.9):
        want = jrank.adaptive_rank_map({p: jnp.asarray(v) for p, v in w.items()},
                                       {p: jnp.asarray(v) for p, v in r.items()},
                                       ratio, min_rank=2)
        got = rank_alloc.adaptive_rank_map(
            {p: torch.from_numpy(v) for p, v in w.items()},
            {p: torch.from_numpy(v) for p, v in r.items()}, ratio, min_rank=2)
        assert got == want
    assert got["blocks/0/a/wq"] == got["blocks/1/a/wq"] > got["blocks/0/a/wk"]


def test_compress_adaptive_matches_jax(llama):
    """``compress_model(adaptive_rank=True)`` (the reference's
    ``coala_adaptive`` row of Table 2, μ 0): reports and compressed logits."""
    name, (jmodel, jparams, jcal), (tmodel, tcal), toks = llama
    kw = dict(method="coala", ratio=RATIO, mu=0.0, adaptive_rank=True)
    jcc, jreports = j_compress(jmodel, jparams, jcal, JCompressConfig(**kw))
    tcc, treports = compress_model(tmodel, tcal, CompressConfig(**kw))
    jrep = {r.path: r for r in jreports}
    assert sorted(r.path for r in treports) == sorted(jrep) and len(treports) == 14
    for tr in treports:
        jr = jrep[tr.path]
        assert (tr.rank, tr.params_before, tr.params_after, tr.mu) == (
            jr.rank, jr.params_before, jr.params_after, jr.mu)
        np.testing.assert_allclose(tr.rel_err_weighted, jr.rel_err_weighted, rtol=1e-4)
        np.testing.assert_allclose(tr.rel_err_bound, jr.rel_err_bound, rtol=1e-4)
        assert tr.rel_err_weighted >= tr.rel_err_bound * (1 - 1e-4)
    assert compression_summary(treports)["kept_ratio"] <= RATIO
    h = jmodel.capture_forward(jcc, {"tokens": jnp.asarray(toks[0])}, JCalibrator())
    want = np.asarray(jmodel._logits(jcc, h))
    got = tcc.logits(torch.from_numpy(toks[0])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_engine_serves_adaptive_model_like_jax(llama):
    """The JAX adaptive-rank model (odd per-layer ranks), converted through
    numpy, served by the port's engine: greedy tokens equal the JAX
    engine's, request by request, over a preempting pool."""
    name, (jmodel, jparams, jcal), _, _ = llama
    cfg = j_smoke(name)
    jcc, _ = j_compress(jmodel, jparams, jcal, JCompressConfig(
        method="coala", ratio=RATIO, mu=0.0, adaptive_rank=True))
    trace = j_synthetic_trace(6, cfg.vocab_size, **TRACE)
    jeng = JEngine(jmodel, jcc, compute_dtype=jnp.float32, cache_dtype=jnp.float32,
                   prefix_cache=False, paged_kernel=True, prefill_kernel=True,
                   async_detok=False, **KNOBS)
    jm = j_serve_trace(jeng, trace)
    want = {r.req_id: list(r.out_tokens) for r in jeng.finished}
    model = params_from_numpy(jax.tree.map(np.asarray, jcc),
                              get_smoke_config(name), device="cpu")
    ranks = {lin.b_t.shape[1] for lin in model.modules() if hasattr(lin, "b_t")}
    assert len(ranks) > 1
    eng = ContinuousEngine(model, prefix_cache=False, **KNOBS)
    m = serve_trace(eng, synthetic_trace(6, cfg.vocab_size, **TRACE))
    got = {r.req_id: list(r.out_tokens) for r in eng.finished}
    assert jm["preemptions"] >= 1 and m["preemptions"] == jm["preemptions"]
    assert got == want
