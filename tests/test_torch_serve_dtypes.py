"""Serving dtypes of the port against the JAX package: the KV cache in bf16
under fp32 or bf16 activations.

The paged kernels' plain versions take q in the compute dtype and the pages
in the cache dtype, and are held against the JAX Pallas kernels in
interpret mode (which promote the scores to fp32 and round P to the pages'
dtype before P·V) and the JAX plain references, on the same numpy inputs
rounded to bf16 the same way. Tolerance: 2e-2 of max(1, max|ref|), the bf16
tolerance of tests/test_torch_kernels.py (a probability rounded to bf16 at
another running maximum differs by up to one bf16 ulp).

At the engine, both ``ContinuousEngine``s serve one staggered trace on
llama3_1b SMOKE (projections x3, random norm scales) with the same
dtypes, the port's engine forced onto the JAX engine's sampled tokens so
that every step's logits are comparable even where bf16 parts the greedy
trajectories. Tolerances, of max(1, max|logit|) per step: 1e-2 with a bf16
cache (fp32 activations; K and V rounded once as they are written), 4e-2
with bf16 activations too (every projection, norm output and the LM head
rounds to bf16, in another order on each side: a few bf16 ulps of a logit
of magnitude ~1; the measured worst is 1.9e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.kernels import ops as jops
from repro.kernels.chunked_prefill import chunked_prefill_ref as j_cp_ref
from repro.kernels.paged_attention import paged_attention_ref as j_pa_ref
from repro.models import build_model as j_build
from repro.serve import ContinuousEngine as JEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels.chunked_prefill import chunked_prefill_split_ref
from repro_torch.kernels.paged_attention import (check_paged_args,
                                                 paged_attention_split_ref)
from repro_torch.models.linear import Linear
from repro_torch.serve import ContinuousEngine
from repro_torch.serve.engine import compute_copy

torch.set_num_threads(1)

TOL = 2e-2
DTYPE_PAIRS = {"q fp32, pages bf16": (torch.float32, torch.bfloat16),
               "q bf16, pages fp32": (torch.bfloat16, torch.float32)}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _randn(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _tables(totals, bs):
    nb = max(max(-(-t // bs) for t in totals), 1)
    tables = np.zeros((len(totals), nb), np.int32)
    nxt = 1
    for i, t in enumerate(totals):
        for j in range(-(-t // bs)):
            tables[i, j] = nxt
            nxt += 1
    return tables, nxt


def _both(np_args, qdt, kvdt):
    """(jax args, torch args): q in ``qdt``, pages in ``kvdt``, ints as is."""
    q, kp, vp, *ints = np_args
    j = (jnp.asarray(q, JDT[qdt]), jnp.asarray(kp, JDT[kvdt]),
         jnp.asarray(vp, JDT[kvdt]), *map(jnp.asarray, ints))
    t = (torch.from_numpy(q).to(qdt), torch.from_numpy(kp).to(kvdt),
         torch.from_numpy(vp).to(kvdt), *map(torch.from_numpy, ints))
    return j, t


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("pair", list(DTYPE_PAIRS))
@pytest.mark.parametrize("hq,hkv,lengths,bs,cap,window", [
    (4, 2, [5, 12, 1], 4, 0.0, 0), (4, 2, [20, 11], 4, 50.0, 0),
    (4, 2, [20, 6, 13], 4, 0.0, 8), (4, 2, [6, 0, 0], 4, 0.0, 0),
    (8, 2, [37, 70, 3], 16, 0.0, 0),
])
def test_mixed_dtype_paged_attention_matches_jax(pair, hq, hkv, lengths, bs, cap,
                                                 window):
    qdt, kvdt = DTYPE_PAIRS[pair]
    tables, nxt = _tables(lengths, bs)
    np_args = (_randn(0, (len(lengths), hq, 16)), _randn(1, (nxt + 2, bs, hkv, 16)),
               _randn(2, (nxt + 2, bs, hkv, 16)), tables,
               np.asarray(lengths, np.int32))
    jargs, targs = _both(np_args, qdt, kvdt)
    got = tops.paged_attention(*targs, cap=cap, window=window)
    assert got.dtype == qdt
    want = jops.paged_attention(*jargs, cap=cap, window=window, impl="pallas")
    _close(got.float().numpy(), want)
    _close(got.float().numpy(), j_pa_ref(*jargs, cap=cap, window=window))
    split = paged_attention_split_ref(*targs, cap=cap, window=window)
    _close(split.float().numpy(), want)
    for i, n in enumerate(lengths):
        if n == 0:
            assert torch.all(got[i] == 0)


@pytest.mark.parametrize("pair", list(DTYPE_PAIRS))
@pytest.mark.parametrize("hq,hkv,starts,lens,bs,cap,window", [
    (4, 2, [0, 8, 4], [5, 7, 1], 4, 0.0, 0), (4, 2, [8, 4], [6, 9], 4, 50.0, 0),
    (4, 2, [16, 0, 8], [5, 11, 3], 4, 0.0, 6),
    # the speculative verifier's shape: L = spec_k + 1, every row past its prefix
    (8, 2, [9, 17, 4, 33], [5, 5, 5, 5], 4, 0.0, 0),
])
def test_mixed_dtype_chunked_prefill_matches_jax(pair, hq, hkv, starts, lens, bs,
                                                 cap, window):
    qdt, kvdt = DTYPE_PAIRS[pair]
    tables, nxt = _tables([s + n for s, n in zip(starts, lens)], bs)
    lq = max(lens)
    np_args = (_randn(0, (len(lens), lq, hq, 16)), _randn(1, (nxt + 2, bs, hkv, 16)),
               _randn(2, (nxt + 2, bs, hkv, 16)), tables,
               np.asarray(starts, np.int32), np.asarray(lens, np.int32))
    jargs, targs = _both(np_args, qdt, kvdt)
    got = tops.chunked_prefill(*targs, cap=cap, window=window)
    assert got.dtype == qdt
    want = np.asarray(jops.chunked_prefill(*jargs, cap=cap, window=window,
                                           block_q=4, impl="pallas"), np.float32)
    want_ref = np.asarray(j_cp_ref(*jargs, cap=cap, window=window), np.float32)
    split = chunked_prefill_split_ref(*targs, cap=cap, window=window)
    for i, n in enumerate(lens):
        _close(got[i, :n].float().numpy(), want[i, :n])
        _close(got[i, :n].float().numpy(), want_ref[i, :n])
        _close(split[i, :n].float().numpy(), want[i, :n])
        assert torch.all(got[i, n:] == 0)


def test_paged_args_take_each_dtype_on_its_own():
    """q and the pages are checked apart: any pair of fp32 and bf16 passes;
    another dtype, or K and V pages in two dtypes, raise."""
    tables = torch.zeros((2, 1), dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)

    def check(qdt, kdt, vdt):
        check_paged_args("paged_attention", torch.zeros((2, 4, 16), dtype=qdt),
                         torch.zeros((3, 4, 2, 16), dtype=kdt),
                         torch.zeros((3, 4, 2, 16), dtype=vdt), tables,
                         (("lengths", lens),))
    for qdt in (torch.float32, torch.bfloat16):
        for kvdt in (torch.float32, torch.bfloat16):
            check(qdt, kvdt, kvdt)
    for args in ((torch.float16, torch.float32, torch.float32),
                 (torch.float32, torch.float16, torch.float16),
                 (torch.float32, torch.bfloat16, torch.float32)):
        with pytest.raises(ValueError):
            check(*args)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _varied(tree, seed=0):
    """Projections x3 and norm scales ~ N(0, 0.25)."""
    rng = np.random.RandomState(seed)

    def tweak(path, x):
        name = jax.tree_util.keystr(path)
        if "embed" in name:
            return x
        if "scale" in name:
            return (rng.standard_normal(x.shape) * 0.5).astype(np.float32)
        return x * np.float32(3.0)
    return jax.tree_util.tree_map_with_path(tweak, tree)


@pytest.fixture(scope="module")
def models():
    jmodel = j_build(j_smoke("llama3_1b"))
    tree = _varied(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))))
    port = params_from_numpy(tree, get_smoke_config("llama3_1b"), device="cpu")
    return jmodel, jax.tree.map(jnp.asarray, tree), port


KNOBS = dict(block_size=4, num_blocks=64, max_running=3)


def _trace():
    rng = np.random.RandomState(0)
    return [(rng.randint(0, 256, (n,)).astype(np.int32), m)
            for n, m in zip([3, 9, 5, 12, 20], [5, 3, 7, 2, 6])]


def _drive(eng):
    for p, n in _trace():
        eng.submit(p, n)
        eng.step()
    eng.run()


@pytest.mark.parametrize("compute,cache,tol", [
    (torch.float32, torch.bfloat16, 1e-2),
    (torch.bfloat16, torch.bfloat16, 4e-2),
])
def test_engine_logits_match_jax(models, compute, cache, tol):
    """Every step's logits within ``tol`` of the JAX engine's at the same
    dtypes, the port's engine forced onto the JAX engine's tokens."""
    jmodel, jparams, port = models
    jeng = JEngine(jmodel, jparams, compute_dtype=JDT[compute],
                   cache_dtype=JDT[cache], async_detok=False, **KNOBS)
    want = []
    sample = jeng._sample_tokens

    def record(logits, reqs, pad_to=0):
        toks = sample(logits, reqs, pad_to=pad_to)
        want.append((np.asarray(logits, np.float32)[:len(reqs)], toks))
        return toks
    jeng._sample_tokens = record
    _drive(jeng)

    eng = ContinuousEngine(port, compute_dtype=compute, cache_dtype=cache, **KNOBS)
    assert eng.pool.pages[0]["k"].dtype == cache
    got = []

    def forced(logits, reqs):
        assert logits.dtype == torch.float32
        got.append(logits[:len(reqs)].numpy())
        return want[len(got) - 1][1]
    eng._sample_tokens = forced
    _drive(eng)
    assert len(got) == len(want) > 10
    for g, (w, _) in zip(got, want):
        assert np.abs(g - w).max() <= tol * max(1.0, np.abs(w).max())
    assert eng.pool.available_blocks == eng.pool.usable_blocks


def test_compute_copy_casts_the_per_call_casts_only(models):
    """The compute copy holds the projections and the embedding in bf16 and
    keeps the fp32 norm scales; the served model is left as it was; at the
    model's own dtype there is no copy."""
    _, _, port = models
    assert compute_copy(port, torch.float32) is port
    cp = compute_copy(port, torch.bfloat16)
    assert cp.embed.dtype == torch.bfloat16 and port.embed.dtype == torch.float32
    for mod in cp.modules():
        if isinstance(mod, Linear):
            assert all(p.dtype == torch.bfloat16 for p in mod.parameters())
    scales = [p for n, p in cp.named_parameters() if n.endswith("scale")]
    assert scales and all(p.dtype == torch.float32 for p in scales)
    assert torch.equal(cp.embed.float(), port.embed.to(torch.bfloat16).float())
    eng = ContinuousEngine(port, **KNOBS)
    assert eng.compute_dtype == eng.cache_dtype == torch.float32
    assert eng.pool.pages[0]["k"].dtype == torch.float32


def test_bf16_spec_engine_serves_the_trace(models):
    """A bf16/bf16 speculative engine with the target as its own draft
    accepts every proposal and finishes every request, both pools drained."""
    _, _, port = models
    eng = ContinuousEngine(port, compute_dtype=torch.bfloat16,
                           cache_dtype=torch.bfloat16, draft_model=port,
                           spec_k=3, **KNOBS)
    assert eng.draft_pool.pages[0]["v"].dtype == torch.bfloat16
    _drive(eng)
    m = eng.metrics()
    assert m["requests"] == 5 and m["spec_rounds"] > 0
    assert [len(r.out_tokens) for r in sorted(eng.finished, key=lambda r: r.req_id)
            ] == [n for _, n in _trace()]
    for pool in (eng.pool, eng.draft_pool):
        assert pool.available_blocks == pool.usable_blocks
