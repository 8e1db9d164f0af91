"""The slice as a whole: the port's ContinuousEngine vs the JAX one.

Both engines serve the same staggered synthetic trace on llama3_1b SMOKE
(fp32 compute and cache, paged decode + chunked-prefill paths, no prefix
cache, greedy), over a pool small enough to force preemptions, with the
dense parameters and with JAX-COALA-compressed ones converted through
numpy. Greedy tokens must be identical, request by request.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CompressConfig as JCompressConfig
from repro.configs import get_smoke_config as j_smoke
from repro.core.calibrate import calibrate_model as j_calibrate
from repro.core.compress import compress_model as j_compress
from repro.launch.serve import serve_trace as j_serve_trace
from repro.launch.serve import synthetic_trace as j_synthetic_trace
from repro.models import build_model as j_build
from repro.serve import ContinuousEngine as JEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.serve import serve_trace, synthetic_trace
from repro_torch.serve import ContinuousEngine

torch.set_num_threads(1)

KNOBS = dict(block_size=4, num_blocks=14, max_running=3, bucket_sizes=(3,),
             prefill_bucket_sizes=(32,))
TRACE = dict(seed=1, min_prompt=4, max_prompt=20, max_new=12, arrival_every=1)


def _trace(vocab):
    return synthetic_trace(6, vocab, **TRACE)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX engine tokens for the dense and the COALA-compressed params."""
    cfg = j_smoke("llama3_1b")
    model = j_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    batches = [{"tokens": jnp.asarray(rng.randint(0, cfg.vocab_size, (4, 32)),
                                      jnp.int32)} for _ in range(2)]
    cal = j_calibrate(model, params, batches)
    cparams, _ = j_compress(model, params, cal,
                            JCompressConfig(method="coala", ratio=0.6, lam=4.0,
                                            mu=-1.0))
    trace = j_synthetic_trace(6, cfg.vocab_size, **TRACE)
    out = {}
    for name, p in (("dense", params), ("coala", cparams)):
        eng = JEngine(model, p, compute_dtype=jnp.float32,
                      cache_dtype=jnp.float32, prefix_cache=False,
                      paged_kernel=True, prefill_kernel=True,
                      async_detok=False, **KNOBS)
        m = j_serve_trace(eng, trace)
        toks = {r.req_id: list(r.out_tokens) for r in eng.finished}
        out[name] = (jax.tree.map(np.asarray, p), toks, m)
    return out


def _port_run(tree):
    cfg = get_smoke_config("llama3_1b")
    model = params_from_numpy(tree, cfg, device="cpu")
    eng = ContinuousEngine(model, prefix_cache=False, **KNOBS)
    m = serve_trace(eng, _trace(cfg.vocab_size))
    return {r.req_id: list(r.out_tokens) for r in eng.finished}, m, eng


def test_trace_is_the_jax_trace():
    cfg = get_smoke_config("llama3_1b")
    ours = _trace(cfg.vocab_size)
    theirs = j_synthetic_trace(6, cfg.vocab_size, **TRACE)
    assert len(ours) == len(theirs)
    for (a0, p0, n0), (a1, p1, n1) in zip(ours, theirs):
        assert a0 == a1 and n0 == n1
        np.testing.assert_array_equal(p0, p1)


@pytest.mark.parametrize("name", ["dense", "coala"])
def test_greedy_tokens_identical_to_jax_engine(jax_runs, name):
    tree, jtoks, jm = jax_runs[name]
    toks, m, eng = _port_run(tree)
    assert jm["preemptions"] >= 1, "trace must exercise preemption"
    assert m["preemptions"] == jm["preemptions"]
    assert sorted(toks) == sorted(jtoks) == list(range(6))
    for rid in jtoks:
        assert toks[rid] == jtoks[rid], f"request {rid} diverged"
    assert m["requests"] == 6 and m["new_tokens"] == sum(map(len, jtoks.values()))
    assert m["prefill_batches"] >= 1 and m["decode_steps"] >= 1
    for key in ("requests_per_sec", "tokens_per_sec", "decode_tok_per_s",
                "mean_ttft_s", "prefill_tok_per_s"):
        assert m[key] > 0
    # every page went back to the free list
    assert eng.pool.free_blocks == eng.pool.usable_blocks


def test_engine_rejects_unported_features():
    """Temperature sampling is ported (submit takes it); what the engine
    still refuses: a request that can never fit the pool, CUDA graphs on a
    CPU model (the CPU engine stays eager, with no fallback) and a fork of a
    request that is not running."""
    cfg = get_smoke_config("llama3_1b")
    model = params_from_numpy(
        jax.tree.map(np.asarray, j_build(j_smoke("llama3_1b")).init(
            jax.random.PRNGKey(0))), cfg, device="cpu")
    eng = ContinuousEngine(model, **KNOBS)
    assert not eng.cuda_graphs and eng.prefix_cache
    assert eng.submit(np.arange(5), 4, temperature=0.7, seed=3) == 0
    with pytest.raises(ValueError):
        eng.submit(np.arange(40), 30)        # can never fit the 13-page pool
    with pytest.raises(ValueError, match="cuda_graphs"):
        ContinuousEngine(model, cuda_graphs=True, **KNOBS)
    with pytest.raises(ValueError, match="not running"):
        eng.fork(0)                          # submitted, not yet admitted


def test_launcher_entry_point_serves_both_models():
    """``launch.serve.main`` on the CPU: calibrate, compress, then serve the
    given trace with the dense and the compressed model over a pool small
    enough to preempt; it returns the phase seconds, reports and metrics."""
    from repro_torch.launch import serve as launcher
    out = launcher.main(
        ["--continuous", "--smoke", "--requests", "6", "--new-tokens", "12",
         "--block-size", "4", "--num-blocks", "14", "--max-running", "3",
         "--bucket-sizes", "3", "--prefill-bucket-sizes", "32", "--device", "cpu"],
        trace=_trace(get_smoke_config("llama3_1b").vocab_size))
    assert set(out["seconds"]) == {"init", "calibrate", "compress",
                                   "serve_dense", "serve_coala"}
    assert len(out["reports"]) == 14
    for name in ("dense", "coala"):
        met, eng = out["metrics"][name], out["engines"][name]
        assert met["requests"] == 6 and met["preemptions"] >= 1
        # every page is free or, with the prefix cache on, evictable
        assert eng.pool.available_blocks == eng.pool.usable_blocks
        assert out["models"][name].device.type == "cpu"


def test_shared_prefix_trace_is_the_jax_trace():
    cfg = get_smoke_config("llama3_1b")
    kw = dict(TRACE, shared_prefix=8)
    ours = synthetic_trace(6, cfg.vocab_size, **kw)
    theirs = j_synthetic_trace(6, cfg.vocab_size, **kw)
    for (a0, p0, n0), (a1, p1, n1) in zip(ours, theirs):
        assert a0 == a1 and n0 == n1
        np.testing.assert_array_equal(p0, p1)
    assert all(np.array_equal(p[:8], ours[0][1][:8]) for _, p, _ in ours)


def test_launcher_prefix_cache_warmup_and_temperature_flags():
    """``--shared-prefix``, ``--prefix-cache``, ``--warmup`` and
    ``--temperature`` on the CPU: the shared prefix is hit with the cache
    on and never with it off, warmup enumerates signatures (an eager engine
    captures none) and sampled requests run to their lengths."""
    from repro_torch.launch import serve as launcher
    base = ["--continuous", "--smoke", "--requests", "4", "--new-tokens", "6",
            "--block-size", "4", "--num-blocks", "64", "--max-running", "3",
            "--shared-prefix", "8", "--temperature", "0.8", "--warmup", "on",
            "--device", "cpu"]
    on = launcher.main(base + ["--prefix-cache", "on"])
    off = launcher.main(base + ["--prefix-cache", "off"])
    for name in ("dense", "coala"):
        m_on, m_off = on["metrics"][name], off["metrics"][name]
        assert m_on["prefix_hit_rate"] > 0 and m_off["prefix_hit_tokens"] == 0
        assert m_on["requests"] == 4 and m_on["post_warmup_compiles"] == 0
        assert on["warmup"][name]["prefill_signatures"] > 0
        assert m_on["new_tokens"] == sum(nn for _, _, nn in on["trace"])
