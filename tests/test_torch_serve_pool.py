"""The port's refcounted, prefix-cached ``BlockPool`` against the JAX one.

A seeded fuzz (after ``tests/test_paged_pool_properties.py``) drives the same
operation sequence through both pools: alloc with tokens, commit, extend
(with copy-on-write), fork, truncate and free, over a tiny vocabulary and
block size that force prefix collisions, fork chains and eviction churn.
After every operation both pools hold the same tables, refcounts, free
list, LRU order, registry, chains and counters, and both raise
``MemoryError`` on the same operations.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.serve import BlockPool as JBlockPool
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.serve import BlockPool

torch.set_num_threads(1)

VOCAB = 3          # tiny alphabet -> dense prefix collisions
BS = 2             # block size
NUM_BLOCKS = 12
MAX_REQS = 5


@pytest.fixture(scope="module")
def models():
    return (j_build(j_smoke("llama3_1b")),
            build_model(get_smoke_config("llama3_1b"), device="cpu"))


def _pools(models):
    jmodel, model = models
    kw = dict(num_blocks=NUM_BLOCKS, block_size=BS, max_requests=MAX_REQS,
              prefix_cache=True)
    return (JBlockPool(jmodel, dtype=jnp.float32, **kw),
            BlockPool(model, dtype=torch.float32, **kw))


def _state(pool, live):
    return {"free": pool.free_block_ids(), "lru": pool.cached_block_ids(),
            "tables": {r: pool.table(r) for r in live},
            "refs": [pool.ref_count(b) for b in range(NUM_BLOCKS)],
            "registry": dict(pool._registry), "chains": dict(pool._chain),
            "intern": dict(pool._intern), "stats": dict(pool.stats),
            "available": pool.available_blocks, "slots": pool.free_slots}


def _both(pools, fn):
    """Apply ``fn`` to each pool; both raise MemoryError or neither does.
    Returns the two results (None where it raised)."""
    out = []
    for pool in pools:
        try:
            out.append(fn(pool))
        except MemoryError:
            out.append(MemoryError)
    assert (out[0] is MemoryError) == (out[1] is MemoryError), out
    return out


def _fuzz(models, seed, n_ops=80):
    rng = np.random.RandomState(seed)
    pools = _pools(models)
    live = {}                 # rid -> token list
    clen = {}                 # rid -> committed token count
    next_id = 0

    def commit(rid):
        toks = np.asarray(live[rid], np.int32)
        for pool in pools:
            pool.commit(rid, toks)
        clen[rid] = (len(toks) // BS) * BS

    ops_seen = set()
    for _ in range(n_ops):
        op = rng.randint(5)
        if op == 0:                                    # alloc (prefill)
            toks = rng.randint(0, VOCAB, (rng.randint(1, 9),))
            hit = _both(pools, lambda p: p.alloc(next_id, len(toks), tokens=toks))
            if hit[0] is not MemoryError:
                assert hit[0] == hit[1]
                live[next_id] = [int(t) for t in toks]
                commit(next_id)
                next_id += 1
        elif op == 1 and live:                         # extend (decode step)
            rid = list(live)[rng.randint(len(live))]
            live[rid].append(int(rng.randint(VOCAB)))
            res = _both(pools, lambda p: p.extend(rid, len(live[rid])))
            if res[0] is MemoryError:                  # engine would preempt
                live[rid].pop()
                for pool in pools:
                    pool.free(rid)
                del live[rid], clen[rid]
            elif rng.randint(2):
                commit(rid)
        elif op == 2 and live:                         # fork (best-of-n)
            rid = list(live)[rng.randint(len(live))]
            res = _both(pools, lambda p: p.fork(rid, next_id))
            if res[0] is not MemoryError:
                live[next_id] = list(live[rid])
                clen[next_id] = clen[rid]
                next_id += 1
        elif op == 3 and live:                         # free (finish)
            rid = list(live)[rng.randint(len(live))]
            for pool in pools:
                pool.free(rid)
            del live[rid], clen[rid]
        elif op == 4 and live:                         # truncate (rollback)
            rid = list(live)[rng.randint(len(live))]
            n = int(rng.randint(max(clen[rid], 1), len(live[rid]) + 1))
            for pool in pools:
                pool.truncate(rid, n)
            live[rid] = live[rid][:n]
        ops_seen.add(op)
        assert _state(pools[1], live) == _state(pools[0], live)
    for rid in list(live):
        for pool in pools:
            pool.free(rid)
    live.clear()
    assert _state(pools[1], live) == _state(pools[0], live)
    assert pools[1].available_blocks == pools[1].usable_blocks
    return pools[1], ops_seen


@pytest.mark.parametrize("seed", range(8))
def test_pool_fuzz_matches_jax_pool(models, seed):
    _fuzz(models, seed)


def test_pool_fuzz_reaches_every_operation(models):
    """Over the seeds, the fuzz takes every operation and its copy-on-write
    and eviction paths."""
    seen, cow, evictions = set(), 0, 0
    for seed in range(8):
        pool, ops_seen = _fuzz(models, seed)
        seen |= ops_seen
        cow += pool.stats["cow_copies"]
        evictions += pool.stats["evictions"]
    assert seen == set(range(5)) and cow > 0 and evictions > 0


def test_cow_copy_moves_page_data(models):
    """``extend`` onto a fork-shared block copies the page's K/V into the
    new block in every layer, leaving the shared page as it was."""
    pool = _pools(models)[1]
    toks = np.asarray([0, 1, 2], np.int32)             # 2 blocks, 2nd partial
    pool.alloc(1, 3, tokens=toks)
    pool.commit(1, toks)
    tail = pool.table(1)[1]
    for i, layer in enumerate(pool.pages):
        layer["k"][tail] = float(i + 1)
        layer["v"][tail] = -float(i + 1)
    pool.fork(1, 2)
    pool.extend(1, 4)                                  # write pos 3: shared
    new = pool.table(1)[1]
    assert new != tail and pool.table(2)[1] == tail
    assert pool.stats["cow_copies"] == 1
    for i, layer in enumerate(pool.pages):
        assert layer["k"][new].eq(i + 1).all() and layer["v"][new].eq(-(i + 1)).all()
        assert layer["k"][tail].eq(i + 1).all()
