"""The attention-only decoder families of the port against the JAX package,
on the CPU: mistral_7b, smollm_135m, olmo_1b, minicpm_2b, gemma2_27b and
deepseek_moe_16b (SMOKE sizes).

Parameters come from the JAX model's init as numpy, through ``convert``.
For every family: the config is a copy of the JAX one; the parameter round
trip is bit-exact; full-forward logits, ``LM.loss`` (ce and aux) and the
serving path's ``prefill_chunk`` + ``decode_step`` logits over block tables
match the JAX model's at rtol/atol 1e-5 (fp32; sequences longer than
gemma2's SMOKE window of 32, so the window bites). For the five dense
families COALA compression gives the JAX ranks, and ``rel_err_weighted``
and ``rel_err_bound`` within 1e-4 of the JAX reports (deepseek's per-expert
compression is held in test_torch_moe.py). gemma2's greedy tokens through
the port's ``ContinuousEngine`` equal the JAX engine's on a staggered trace
with the prefix cache on and prompts past the window.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CompressConfig as JCompressConfig
from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.core.calibrate import calibrate_model as j_calibrate
from repro.core.compress import compress_model as j_compress
from repro.launch.serve import serve_trace as j_serve_trace
from repro.launch.serve import synthetic_trace as j_synthetic_trace
from repro.models import build_model as j_build
from repro.models.common import CPU_CTX as J_CPU_CTX
from repro.models.transformer import period_specs as j_period_specs
from repro.serve import ContinuousEngine as JEngine
from repro_torch.config import CompressConfig
from repro_torch.configs import (ARCH_IDS, NOT_PORTED, get_config,
                                 get_smoke_config)
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.calibrate import calibrate_model
from repro_torch.core.compress import compress_model
from repro_torch.launch.serve import serve_trace, synthetic_trace
from repro_torch.serve import ContinuousEngine

torch.set_num_threads(1)

FAMILIES = ["mistral_7b", "smollm_135m", "olmo_1b", "minicpm_2b",
            "gemma2_27b", "deepseek_moe_16b"]
DENSE = FAMILIES[:-1]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    name = request.param
    jmodel = j_build(j_smoke(name))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    tmodel = params_from_numpy(tree, get_smoke_config(name), device="cpu")
    return name, jmodel, jparams, tree, tmodel


def _tokens(cfg, shape, seed=1):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                               shape).astype(np.int32)


# ---------------------------------------------------------------------------
# registry and configs
# ---------------------------------------------------------------------------

def test_registry_holds_the_seven_ported_configs():
    """The seven configs of the attention-only GQA families and, since MLA
    and qwen2-vl were ported, deepseek_v2_lite_16b and qwen2_vl_2b: nine
    (the name dates from seven)."""
    assert sorted(ARCH_IDS) == sorted(FAMILIES + ["llama3_1b", "deepseek_v2_lite_16b",
                                                  "qwen2_vl_2b"])
    assert "qwen2_vl_2b" not in NOT_PORTED and len(NOT_PORTED) == 3
    for name, family in NOT_PORTED.items():
        for get in (get_config, get_smoke_config):
            with pytest.raises(NotImplementedError, match=family.split()[0]):
                get(name)


@pytest.mark.parametrize("name", FAMILIES + ["llama3_1b", "deepseek_v2_lite_16b"])
def test_configs_are_copies_of_the_jax_ones(name):
    for ours, theirs in ((get_config(name), j_config(name)),
                         (get_smoke_config(name), j_smoke(name))):
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if f.name == "moe":
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                assert a == b, (name, f.name, a, b)


# ---------------------------------------------------------------------------
# parameters and forward
# ---------------------------------------------------------------------------

def _assert_tree_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_round_trip_bit_exact(family):
    name, _, _, tree, tmodel = family
    _assert_tree_equal(params_to_numpy(tmodel), tree)
    cfg = tmodel.cfg
    has_scale = any(k.endswith("scale") for k in tmodel.state_dict())
    assert has_scale == (not cfg.nonparametric_norm)
    assert len(tmodel.prefix) == cfg.first_k_dense
    assert sum(1 for _ in tmodel.layers()) == cfg.n_layers


def test_full_forward_logits_and_loss(family):
    """T 48 > gemma2's SMOKE window (the local layers' dense_sdpa masks it)."""
    _, jmodel, jparams, _, tmodel = family
    tok = _tokens(tmodel.cfg, (2, 48))
    x = jmodel._embed(jparams, jnp.asarray(tok)).astype(jnp.float32)
    h, _, _ = jmodel._backbone(jparams, x, ctx=J_CPU_CTX)
    want = np.asarray(jmodel._logits(jparams, h))
    np.testing.assert_allclose(tmodel.logits(torch.from_numpy(tok)).numpy(),
                               want, **TOL)
    jl, jm = jmodel.loss(jparams, {"tokens": jnp.asarray(tok)},
                         compute_dtype=jnp.float32)
    with torch.no_grad():
        tl, tm = tmodel.loss(torch.from_numpy(tok), compute_dtype=torch.float32)
    for got, ref in ((tl, jl), (tm["ce"], jm["ce"]), (tm["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got), float(ref), **TOL)
    assert (float(tm["aux"]) > 0) == tmodel.cfg.uses_moe


def _paged_cache_jax(jcfg, num_blocks, bs):
    prefix, period, n_rep = j_period_specs(jcfg)
    one = (num_blocks, bs, jcfg.n_kv_heads, jcfg.head_dim)

    def kv(shape):
        return {"mixer": {"k": jnp.zeros(shape, jnp.float32),
                          "v": jnp.zeros(shape, jnp.float32)}}
    return {"prefix": [kv(one) for _ in prefix],
            "blocks": {f"sub{j}": kv((n_rep,) + one)
                       for j in range(len(period))}}


def test_paged_prefill_and_decode_match_jax(family):
    """Ragged rows past the window, a padding row, three decode steps, then a
    suffix at a nonzero start (a cached-prefix offset)."""
    _, jmodel, jparams, _, tmodel = family
    cfg = tmodel.cfg
    bs, num_blocks, l_pad = 8, 40, 48
    lens = [45, 12, 37]
    tok = np.zeros((4, l_pad), np.int32)
    for i, n in enumerate(lens):
        tok[i, :n] = _tokens(cfg, (n,), seed=10 + i)
    tables = np.zeros((4, 10), np.int32)          # row 3 all-trash
    nxt = 1
    for i, n in enumerate(lens):
        for j in range(-(-(n + 16) // bs)):
            tables[i, j] = nxt
            nxt += 1
    jcache = _paged_cache_jax(jmodel.cfg, num_blocks, bs)
    tcache = tmodel.init_cache(num_blocks, bs)

    def prefill(tok, starts, ln):
        nonlocal jcache
        jl, jcache = jmodel.prefill_chunk(
            jparams, jnp.asarray(tok), jcache, jnp.asarray(starts),
            jnp.asarray(ln), compute_dtype=jnp.float32,
            block_tables=jnp.asarray(tables))
        tl = tmodel.prefill_chunk(torch.from_numpy(tok), tcache,
                                  torch.from_numpy(starts),
                                  torch.from_numpy(ln), torch.from_numpy(tables))
        return np.asarray(jl), tl.numpy()

    def decode(tok, pos):
        nonlocal jcache
        jl, jcache = jmodel.decode_step(
            jparams, jnp.asarray(tok), jcache, jnp.asarray(pos),
            compute_dtype=jnp.float32, block_tables=jnp.asarray(tables))
        tl = tmodel.decode_step(torch.from_numpy(tok), tcache,
                                torch.from_numpy(pos), torch.from_numpy(tables))
        return np.asarray(jl), tl.numpy()

    jl, tl = prefill(tok, np.zeros(4, np.int32), np.array(lens + [1], np.int32))
    np.testing.assert_allclose(tl[:3], jl[:3], **TOL)
    pos = np.array(lens + [0], np.int32)
    for _ in range(3):
        step_tok = np.argmax(jl, -1).astype(np.int32)[:, None]
        step_tok[3] = 0
        jl, tl = decode(step_tok, pos)
        np.testing.assert_allclose(tl[:3], jl[:3], **TOL)
        pos[:3] += 1
    tok2 = np.zeros((4, 8), np.int32)
    tok2[1, :5] = _tokens(cfg, (5,), seed=20)
    jl, tl = prefill(tok2, np.array([0, pos[1], 0, 0], np.int32),
                     np.array([1, 5, 1, 1], np.int32))
    np.testing.assert_allclose(tl[1], jl[1], **TOL)


# ---------------------------------------------------------------------------
# compression (dense families; the MoE's is in test_torch_moe.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DENSE)
def test_coala_reports_match_jax(name):
    jmodel = j_build(j_smoke(name))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               get_smoke_config(name), device="cpu")
    toks = [_tokens(tmodel.cfg, (4, 40), seed=s) for s in (0, 1)]
    jcal = j_calibrate(jmodel, jparams, [{"tokens": jnp.asarray(t)} for t in toks])
    tcal = calibrate_model(tmodel, [torch.from_numpy(t) for t in toks])
    assert set(jcal.r_factors()) == set(tcal.r_factors())
    kw = dict(method="coala", ratio=0.6, lam=4.0, mu=-1.0)
    _, jrep = j_compress(jmodel, jparams, jcal, JCompressConfig(**kw))
    _, trep = compress_model(tmodel, tcal, CompressConfig(**kw))
    want = {r.path: r for r in jrep}
    got = {r.path: r for r in trep}
    assert set(got) == set(want) and len(got) == 7 * tmodel.cfg.n_layers
    for p, r in got.items():
        assert r.rank == want[p].rank, p
        assert math.isclose(r.rel_err_weighted, want[p].rel_err_weighted,
                            abs_tol=1e-4), p
        assert math.isclose(r.rel_err_bound, want[p].rel_err_bound,
                            abs_tol=1e-4), p


# ---------------------------------------------------------------------------
# the slice as a whole: gemma2 through the engine against the JAX engine
# ---------------------------------------------------------------------------

KNOBS = dict(block_size=4, num_blocks=48, max_running=3, bucket_sizes=(1, 2, 3),
             prefill_bucket_sizes=(16, 64))
TRACE = dict(seed=2, min_prompt=20, max_prompt=60, max_new=8, arrival_every=1,
             shared_prefix=8)


def test_gemma2_engine_greedy_tokens_match_jax():
    """5 staggered requests, prompts 28-68 tokens (SMOKE window 32), a shared
    8-token prefix, prefix cache on both sides, fp32."""
    jcfg = j_smoke("gemma2_27b")
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jeng = JEngine(jmodel, jparams, compute_dtype=jnp.float32,
                   cache_dtype=jnp.float32, prefix_cache=True,
                   paged_kernel=True, prefill_kernel=True, async_detok=False,
                   **KNOBS)
    j_serve_trace(jeng, j_synthetic_trace(5, jcfg.vocab_size, **TRACE))
    want = {r.req_id: list(r.out_tokens) for r in jeng.finished}
    tmodel = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               get_smoke_config("gemma2_27b"), device="cpu")
    eng = ContinuousEngine(tmodel, prefix_cache=True, **KNOBS)
    trace = synthetic_trace(5, jcfg.vocab_size, **TRACE)
    assert max(len(p) for _, p, _ in trace) > jcfg.local_window
    met = serve_trace(eng, trace)
    assert {r.req_id: list(r.out_tokens) for r in eng.finished} == want
    assert met["prefix_hit_rate"] > 0
