"""The port's prefix cache, copy-on-write fork, eos stopping and warmup
signature set against the JAX ``ContinuousEngine``.

Both engines serve the traces of ``tests/test_prefix_cache.py`` (full-block
hits, mid-block divergence, LRU eviction under pool pressure, preemption of
a request whose blocks are shared, a greedy copy-on-write fork) on llama3_1b SMOKE with fp32 compute and
cache and the prefix cache on. The weights come from one numpy tree handed to
both; the projections are scaled up and the norm scales randomised so the
random model's greedy tokens vary from step to step instead of repeating
(a repeating stream would hide a divergence). Greedy tokens must be
identical request by request, and so must the prefix-hit, copy-on-write,
eviction and preemption counters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.serve import ContinuousEngine as JEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.serve import ContinuousEngine

torch.set_num_threads(1)

COUNTERS = ("prefix_hit_tokens", "cow_copies", "prefix_evictions",
            "preemptions")


def varied_tree(tree, seed=0):
    """The init tree with projections x3 and norm scales ~ N(0, 0.25)."""
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
    """(JAX model, JAX params, port model) with the same weights."""
    jmodel = j_build(j_smoke("llama3_1b"))
    tree = varied_tree(jax.tree.map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(0))))
    port = params_from_numpy(tree, get_smoke_config("llama3_1b"),
                             device="cpu")
    return jmodel, jax.tree.map(jnp.asarray, tree), port


def _engines(models, **knobs):
    jmodel, jparams, port = models
    knobs.setdefault("block_size", 4)
    knobs.setdefault("num_blocks", 64)
    knobs.setdefault("max_running", 4)
    jeng = JEngine(jmodel, jparams, compute_dtype=jnp.float32,
                   cache_dtype=jnp.float32, prefix_cache=True,
                   async_detok=False, **knobs)
    return jeng, ContinuousEngine(port, **knobs)


def _tokens(eng):
    return {r.req_id: list(r.out_tokens) for r in eng.finished}


def _staggered(eng, prompts, news, **kw):
    for p, n in zip(prompts, news):
        eng.submit(p, n, **kw)
        eng.step()                          # join mid-decode
    eng.run()


def _shared_prefix_prompts(rng, vocab, *, prefix_len, tails):
    shared = rng.randint(0, vocab, (prefix_len,)).astype(np.int32)
    return [np.concatenate([shared, rng.randint(0, vocab, (t,)).astype(np.int32)])
            for t in tails]


def full_block_hits(eng, vocab):
    rng = np.random.RandomState(0)
    prompts = _shared_prefix_prompts(rng, vocab, prefix_len=12, tails=(3, 5, 7))
    prompts.append(rng.randint(0, vocab, (6,)).astype(np.int32))
    _staggered(eng, prompts, [5, 5, 4, 5])


def mid_block_divergence(eng, vocab):
    rng = np.random.RandomState(1)
    a = rng.randint(0, vocab, (14,)).astype(np.int32)
    b = np.concatenate([a[:10], rng.randint(0, vocab, (4,)).astype(np.int32)])
    _staggered(eng, [a, b], [5, 5])


def eviction(eng, vocab):
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, vocab, (8,)).astype(np.int32) for _ in range(5)]
    for q in prompts:
        eng.submit(q, 6)
    eng.run()
    eng.submit(prompts[0], 6)               # whatever its lookup now finds
    eng.run()


def shared_preemption(eng, vocab):
    rng = np.random.RandomState(4)
    prompts = _shared_prefix_prompts(rng, vocab, prefix_len=4, tails=(2, 2, 2))
    _staggered(eng, prompts, [10, 10, 10])


def greedy_fork(eng, vocab):
    rng = np.random.RandomState(2)
    rid = eng.submit(rng.randint(0, vocab, (6,)).astype(np.int32), 8)
    eng.step()                 # prefill + 1 decode -> cache_len 7, mid-block
    eng.fork(rid)              # greedy clone: the parent's write copies
    eng.run()


TRACES = {
    "full_block_hits": (full_block_hits, {}),
    "mid_block_divergence": (mid_block_divergence, {}),
    "eviction": (eviction, dict(num_blocks=14, max_running=2)),
    "shared_preemption": (shared_preemption,
                          dict(block_size=2, num_blocks=13, max_running=3)),
    "greedy_fork": (greedy_fork, {}),
}


@pytest.mark.parametrize("name", list(TRACES))
def test_prefix_cache_matches_jax_engine(models, name):
    drive, knobs = TRACES[name]
    vocab = get_smoke_config("llama3_1b").vocab_size
    jeng, eng = _engines(models, **knobs)
    drive(jeng, vocab)
    drive(eng, vocab)
    jm, m = jeng.metrics(), eng.metrics()
    assert _tokens(eng) == _tokens(jeng)
    assert {k: m[k] for k in COUNTERS} == {k: jm[k] for k in COUNTERS}
    assert m["cached_blocks"] == jm["cached_blocks"]
    assert m["prefix_hit_rate"] == pytest.approx(jm["prefix_hit_rate"])
    # each trace exercises what it is named for
    if name == "mid_block_divergence":
        assert m["prefix_hit_tokens"] == 8      # blocks 0-1 only
    elif name == "eviction":
        assert m["prefix_evictions"] > 0
    elif name == "greedy_fork":
        assert m["cow_copies"] == 1
    else:
        assert m["prefix_hit_tokens"] > 0
    if name == "shared_preemption":
        assert m["preemptions"] > 0
    # every page is free or evictable once the traffic drains
    assert eng.pool.available_blocks == eng.pool.usable_blocks


def test_fork_divergent_decode_copies_one_block(models):
    """A fork mid-block shares the parent's table; the parent's next write
    copies the shared tail block once, the sampled child diverges, and the
    parent's tokens are those of the same request served without a fork."""
    vocab = get_smoke_config("llama3_1b").vocab_size
    p = np.random.RandomState(2).randint(0, vocab, (6,)).astype(np.int32)
    ref = _engines(models)[1]
    ref.submit(p, 8)
    ref.run()
    eng = _engines(models)[1]
    rid = eng.submit(p, 8)
    eng.step()                 # prefill + 1 decode -> cache_len 7, mid-block
    shared = eng.pool.table(rid)
    cid = eng.fork(rid, seed=99, temperature=1.5)
    assert eng.pool.table(cid) == shared
    assert eng.pool.ref_count(shared[-1]) == 2
    eng.run()
    fin = {r.req_id: r for r in eng.finished}
    assert eng.metrics()["cow_copies"] == 1
    assert fin[rid].out_tokens == ref.finished[0].out_tokens
    assert len(fin[cid].out_tokens) == 8
    assert fin[cid].out_tokens[:2] == fin[rid].out_tokens[:2]
    assert fin[cid].out_tokens != fin[rid].out_tokens
    assert eng.pool.available_blocks == eng.pool.usable_blocks


def test_eos_stopping_matches_jax_engine(models):
    """Requests stop at their ``eos_id`` token-exactly as in the JAX
    engine (the stop token is emitted, nothing after it)."""
    vocab = get_smoke_config("llama3_1b").vocab_size
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, vocab, (n,)).astype(np.int32) for n in (5, 9, 3)]
    free = _engines(models)[1]
    for q in prompts:
        free.submit(q, 10)
    free.run()
    greedy = _tokens(free)
    # request 0 stops at its 3rd token, request 1 at its 6th, request 2 never
    eos = [greedy[0][2], greedy[1][5], vocab + 1]
    runs = []
    for eng in _engines(models):
        for q, e in zip(prompts, eos):
            eng.submit(q, 10, eos_id=e)
            eng.step()
        eng.run()
        runs.append(_tokens(eng))
    assert runs[1] == runs[0]
    for rid, e in enumerate(eos):
        toks = runs[1][rid]
        cut = greedy[rid].index(e) + 1 if e in greedy[rid] else 10
        assert toks == greedy[rid][:cut]
    assert len(runs[1][0]) <= 3 and len(runs[1][2]) == 10


@pytest.mark.parametrize("knobs,max_len", [
    (dict(block_size=4, num_blocks=64, max_running=4, prefix_cache=True), 40),
    (dict(block_size=4, num_blocks=64, max_running=4, prefix_cache=False), 40),
    (dict(block_size=8, num_blocks=20, max_running=3, bucket_sizes=(1, 3),
          prefill_bucket_sizes=(8, 24), prefix_cache=True), 200),
    (dict(block_size=16, num_blocks=72, max_running=8, prefix_cache=True), 232),
])
def test_warmup_signatures_match_jax_engine(models, knobs, max_len):
    """The closed signature set is pure host code: exactly JAX's lists
    (JAX's decode signatures carry its paged-kernel switch as a third
    element, which the port has no counterpart of)."""
    jmodel, jparams, port = models
    jeng = JEngine(jmodel, jparams, compute_dtype=jnp.float32,
                   cache_dtype=jnp.float32, async_detok=False, **knobs)
    jd, jp = jeng.warmup_signatures(max_len)
    d, p = ContinuousEngine(port, **knobs).warmup_signatures(max_len)
    assert d == [(b, nb) for b, nb, _ in jd]
    assert p == list(jp)
    assert len(p) > 0 and len(d) > 0


def test_reset_metrics_keeps_registry_warm(models):
    """``reset_metrics`` zeroes the request-level counters and keeps the
    prefix registry: the same traffic served again hits the blocks the first
    pass committed, and both engines count the same second pass."""
    vocab = get_smoke_config("llama3_1b").vocab_size
    metrics = []
    for eng in _engines(models):
        full_block_hits(eng, vocab)
        cached = eng.metrics()["cached_blocks"]
        eng.reset_metrics()
        m = eng.metrics()
        assert m["requests"] == m["prefix_hit_tokens"] == m["decode_steps"] == 0
        assert m["cached_blocks"] == cached > 0
        full_block_hits(eng, vocab)
        metrics.append(eng.metrics())
    jm, m = metrics
    for k in COUNTERS + ("requests", "new_tokens", "decode_steps",
                         "prefill_batches", "cached_blocks"):
        assert m[k] == jm[k], k
    assert m["prefix_hit_tokens"] > 24      # the second pass hits every prompt
