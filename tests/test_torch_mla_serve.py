"""deepseek_v2_lite_16b's MLA model through the port's ``ContinuousEngine``
against the JAX engine, on the CPU (SMOKE).

The JAX engine serves MLA through its gather path (``paged_kernel`` False,
``prefill_kernel`` 0.0): each step gathers a row's pages into one contiguous
cache. The port's MLA attention reads its latent pages through the block
tables in plain torch, within the same step signatures as every other
model. Greedy tokens equal the JAX engine's with the prefix cache on and off
on a staggered trace over a pool that preempts, and on a greedy fork, with
equal prefix-hit, copy-on-write, eviction and preemption counters and
``prefill_kernel``, and so do a speculative engine's (COALA draft at ratio
0.3, k 2) against the JAX spec engine's with the same draft. The weights are the init tree with
projections x3 and random norm scales, so greedy tokens vary.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.launch.serve import serve_trace as j_serve_trace
from repro.launch.serve import synthetic_trace as j_synthetic_trace
from repro.models import build_model as j_build
from repro.serve import ContinuousEngine as JEngine
from repro_torch.config import CompressConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.calibrate import calibrate_model
from repro_torch.core.compress import compress_model
from repro_torch.launch.serve import serve_trace, synthetic_trace
from repro_torch.serve import ContinuousEngine
from test_torch_serve_prefix import greedy_fork, varied_tree

torch.set_num_threads(1)

NAME = "deepseek_v2_lite_16b"
CFG = get_smoke_config(NAME)
COUNTERS = ("prefix_hit_tokens", "cow_copies", "prefix_evictions",
            "preemptions")

# ---------------------------------------------------------------------------
# the slice as a whole: MLA through the engine against the JAX engine
# ---------------------------------------------------------------------------

# 5 staggered requests, prompts 28-68 behind a shared 8-token prefix, 12-20
# new tokens: a 36-page pool preempts once with the prefix cache on and off
KNOBS = dict(block_size=4, num_blocks=36, max_running=3, bucket_sizes=(1, 2, 3),
             prefill_bucket_sizes=(16, 64))
TRACE = dict(seed=2, min_prompt=20, max_prompt=60, min_new=12, max_new=20,
             arrival_every=1, shared_prefix=8)


@pytest.fixture(scope="module")
def varied():
    """(JAX model, JAX params, port model) with the same weights."""
    jmodel = j_build(j_smoke(NAME))
    tree = varied_tree(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))))
    return (jmodel, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, CFG, device="cpu"))


def _jax_engine(varied, **knobs):
    jmodel, jparams, _ = varied
    eng = JEngine(jmodel, jparams, compute_dtype=jnp.float32,
                  cache_dtype=jnp.float32, async_detok=False, **knobs)
    assert not eng.paged_kernel and not eng.prefill_kernel
    return eng


def _finished(eng):
    return {r.req_id: list(r.out_tokens) for r in eng.finished}


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_engine_greedy_tokens_match_jax(varied, prefix_cache):
    """``TRACE`` over the preempting pool, fp32: the tokens, the counters
    and ``prefill_kernel`` equal the JAX engine's."""
    knobs = dict(KNOBS, prefix_cache=prefix_cache)
    jeng = _jax_engine(varied, **knobs)
    jmet = j_serve_trace(jeng, j_synthetic_trace(5, CFG.vocab_size, **TRACE))
    eng = ContinuousEngine(varied[2], **knobs)
    met = serve_trace(eng, synthetic_trace(5, CFG.vocab_size, **TRACE))
    assert _finished(eng) == _finished(jeng) and len(eng.finished) == 5
    assert {k: met[k] for k in COUNTERS} == {k: jmet[k] for k in COUNTERS}
    assert met["preemptions"] >= 1
    assert (met["prefix_hit_tokens"] > 0) == prefix_cache
    assert met["prefill_kernel"] == jmet["prefill_kernel"] == 0.0
    assert not eng.paged_kernel and not eng.prefill_kernel
    assert len({tuple(t) for t in _finished(eng).values()}) == 5


def test_engine_fork_matches_jax(varied):
    """A greedy copy-on-write fork mid-block: the parent's write copies the
    shared latent page; tokens and counters equal the JAX engine's."""
    knobs = dict(block_size=4, num_blocks=64, max_running=4, prefix_cache=True)
    jeng = _jax_engine(varied, **knobs)
    eng = ContinuousEngine(varied[2], **knobs)
    greedy_fork(jeng, CFG.vocab_size)
    greedy_fork(eng, CFG.vocab_size)
    m, jm = eng.metrics(), jeng.metrics()
    assert _finished(eng) == _finished(jeng) and len(eng.finished) == 2
    assert {k: m[k] for k in COUNTERS} == {k: jm[k] for k in COUNTERS}
    assert m["cow_copies"] == 1


def test_speculative_tokens_match_jax(varied):
    """A COALA draft at ratio 0.3 proposing 2 tokens a round, on the
    preempting trace: greedy tokens and the spec counters equal the JAX spec
    engine's with the same draft. (They are not the non-speculative
    tokens, on either side: an MoE layer's capacity comes from the step's
    token count, which a verify round of k + 1 positions a row changes.)"""
    jmodel, jparams, model = varied
    rng = np.random.RandomState(0)
    cal = calibrate_model(model, [torch.as_tensor(rng.randint(0, CFG.vocab_size,
                                                              (4, 24)))
                                  for _ in range(2)])
    draft, _ = compress_model(model, cal, CompressConfig(ratio=0.3, lam=4.0,
                                                         mu=-1.0))
    jeng = _jax_engine(varied, draft_params=jax.tree.map(
        jnp.asarray, params_to_numpy(draft)), spec_k=2, **KNOBS)
    jmet = j_serve_trace(jeng, j_synthetic_trace(5, CFG.vocab_size, **TRACE))
    eng = ContinuousEngine(model, draft_model=draft, spec_k=2, **KNOBS)
    met = serve_trace(eng, synthetic_trace(5, CFG.vocab_size, **TRACE))
    assert _finished(eng) == _finished(jeng) and len(eng.finished) == 5
    for k in COUNTERS + ("spec_rounds", "spec_proposed_tokens",
                         "spec_accepted_tokens"):
        assert met[k] == jmet[k], k
    assert met["spec_rounds"] > 0 and met["prefill_kernel"] == 0.0
