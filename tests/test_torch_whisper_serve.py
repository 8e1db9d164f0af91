"""whisper serving against the JAX engines, on the CPU at SMOKE size: the
encoder–decoder route of the continuous engine, self-attention K/V in the
pool's pages beside the cross K/V in its per-request state slots.

whisper SMOKE (projections x3, random norm scales: ``varied_tree``) serves a
staggered trace whose requests carry their own frames, over a pool small
enough to preempt, with a fork of a running request; the port's
``ContinuousEngine`` must give the JAX ``ContinuousEngine``'s greedy tokens
request by request (the JAX engine reads the pages through its gather path,
the port through the paged-attention kernel's plain version). Also: the
pool's leaf classes and slot stores, the fixed-batch engines against each
other, the ``ValueError``s (a request without frames, the prefix cache, a
draft, the chunked-prefill kernel), the warmup signatures and the serve
launcher on whisper. Prompts take three lengths, since the JAX engine
compiles its prefill once per length.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.serve import ContinuousEngine as JEngine
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.serve import BlockPool, ContinuousEngine, ServeEngine
from test_torch_serve_prefix import varied_tree

torch.set_num_threads(1)

NAME = "whisper_base"
CFG = get_smoke_config(NAME)
# 10 usable pages of 4 tokens for up to 3 running requests of up to 21
# positions: the youngest is preempted and prefilled again, with its frames,
# over prompt + output
KNOBS = dict(block_size=4, num_blocks=11, max_running=3, bucket_sizes=(1, 2, 3))
FORK_AT, FORK_REQ = 1, 0        # step, request id


def trace(n=6, seed=4):
    """(arrival step, prompt, max_new, frames (1, 32, 64)): prompts of 3, 7
    or 11 tokens, 6-10 new tokens, one request a step."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        t0 = int(rng.choice([3, 7, 11]))
        out.append((i, rng.randint(0, 256, (t0,)).astype(np.int32),
                    int(rng.randint(6, 11)),
                    rng.standard_normal((1, CFG.n_audio_frames, CFG.d_model)
                                        ).astype(np.float32)))
    return out


def drive(eng, tr, fork_at=FORK_AT):
    """Replay the trace step by step (either package's engine), forking
    ``FORK_REQ`` at step ``fork_at``; returns (tokens by request id, the
    fork's child id)."""
    pending = list(tr)
    step, child = 0, None
    while pending or eng.has_work():
        while pending and pending[0][0] <= step:
            _, prompt, new, frames = pending.pop(0)
            eng.submit(prompt, new, extras={"frames": frames})
        if step == fork_at:
            child = eng.fork(FORK_REQ)
        eng.step()
        step += 1
    return {r.req_id: list(r.out_tokens) for r in eng.finished}, child


@pytest.fixture(scope="module")
def wh():
    jmodel = j_build(j_smoke(NAME))
    tree = varied_tree(jax.tree.map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(0))))
    port = params_from_numpy(tree, CFG, device="cpu")
    return jmodel, jax.tree.map(jnp.asarray, tree), port


@pytest.fixture(scope="module")
def jax_run(wh):
    jmodel, jparams, _ = wh
    jeng = JEngine(jmodel, jparams, compute_dtype=jnp.float32,
                   cache_dtype=jnp.float32, async_detok=False,
                   prefix_cache=False, **KNOBS)
    toks, child = drive(jeng, trace())
    return toks, child, jeng


def test_pool_keeps_pages_beside_slots(wh):
    """A decoder layer's self K/V are page stores, its cross K/V slot stores
    of ``max_requests + 1`` rows (the last the trash slot), as the JAX pool's
    probe classifies them; ``scatter_prefill`` writes both, ``fork`` copies
    the slot and shares the pages, ``free`` returns the slot."""
    _, _, port = wh
    pool = BlockPool(port, num_blocks=8, block_size=4, max_requests=2)
    hkv, hd = CFG.n_kv_heads, CFG.head_dim
    assert pool.has_state and pool.trash_slot == 2
    assert len(pool._page_layers) == len(pool._state_layers) == CFG.n_layers
    for pages, states in zip(pool._page_layers, pool._state_layers):
        assert set(pages) == {"k", "v"} and set(states) == {"ck", "cv"}
        assert pages["k"].shape == (8, 4, hkv, hd)
        assert states["ck"].shape == (3, CFG.n_audio_frames, hkv, hd)
    pool.alloc(7, 6)
    cache = port.init_contiguous_cache(1, 8)
    for layer in cache:
        for name, t in layer.items():
            t.fill_(2.0 if name in ("ck", "cv") else 1.0)
    pool.scatter_prefill([7], cache, 6)
    table, slot = pool.table(7), pool.slot(7)
    for pages, states in zip(pool._page_layers, pool._state_layers):
        assert float(pages["k"][table[0]].min()) == 1.0
        assert float(pages["v"][table[1], :2].min()) == 1.0
        assert float(pages["v"][table[1], 2:].abs().max()) == 0.0   # past 6
        assert float(states["cv"][slot].min()) == 2.0
        assert float(states["ck"][pool.trash_slot].abs().max()) == 0.0
    pool.fork(7, 8)
    assert pool.table(8) == table and pool.slot(8) != slot
    for states in pool._state_layers:
        assert torch.equal(states["ck"][pool.slot(8)], states["ck"][slot])
    pool.free(7)
    pool.free(8)
    assert pool.free_slots == 2 and pool.available_blocks == pool.usable_blocks


def test_trace_matches_jax_engine_and_serve_engine(wh, jax_run):
    _, _, port = wh
    jtoks, jchild, jeng = jax_run
    eng = ContinuousEngine(port, **KNOBS)
    assert not eng.prefix_cache and not eng.prefill_kernel
    assert eng.paged_kernel and not jeng.paged_kernel      # a difference of form
    toks, child = drive(eng, trace())
    m, jm = eng.metrics(), jeng.metrics()
    assert toks == jtoks and child == jchild and len(toks) == 7
    assert m["preemptions"] == jm["preemptions"] >= 1
    assert {r.req_id: r.preemptions for r in eng.finished} == {
        r.req_id: r.preemptions for r in jeng.finished}
    assert m["decode_shapes"] == jm["decode_shapes"]
    assert m["decode_steps"] == jm["decode_steps"]
    assert m["prefill_batches"] == 0 and m["prefix_hit_tokens"] == 0
    # every request is prefilled alone (encoder + decoder), once more after
    # each preemption; the fork's child starts from its parent's pages and
    # slot
    assert eng.request_prefills == 6 + m["preemptions"]
    fin = {r.req_id: r for r in eng.finished}
    assert fin[child].out_tokens == fin[FORK_REQ].out_tokens
    assert eng.pool.available_blocks == eng.pool.usable_blocks
    assert eng.pool.free_slots == KNOBS["max_running"]
    # each request alone through the fixed-batch engine
    fixed = ServeEngine(port)
    rids = sorted(r for r in fin if r != child)       # in submission order
    for rid, (_, prompt, new, frames) in zip(rids, trace()):
        out = fixed.generate(prompt[None], new, extras={"frames": frames})
        assert list(out[0, len(prompt):]) == fin[rid].out_tokens, rid


def test_serve_engines_match_jax_serve_engine(wh):
    """fp32 fixed batch, 2 rows of 5 tokens with their frames, 6 new: the
    JAX ServeEngine, the port's and the port's continuous engine's
    ``generate``."""
    jmodel, jparams, port = wh
    rng = np.random.RandomState(7)
    prompt = rng.randint(0, 256, (2, 5)).astype(np.int32)
    frames = rng.standard_normal((2, CFG.n_audio_frames, CFG.d_model)
                                 ).astype(np.float32)
    want = np.asarray(JServeEngine(jmodel, jparams, compute_dtype=jnp.float32,
                                   cache_dtype=jnp.float32).generate(
        jnp.asarray(prompt), 6, extras={"frames": jnp.asarray(frames)}))
    got = ServeEngine(port).generate(prompt, 6, extras={"frames": frames})
    np.testing.assert_array_equal(got, want)
    cont = ContinuousEngine(port, block_size=4, num_blocks=64, max_running=2)
    np.testing.assert_array_equal(
        cont.generate(prompt, 6, extras={"frames": frames}), want)


@pytest.mark.parametrize("switch", ["frames", "prefix_cache", "draft",
                                    "prefill_kernel"])
def test_encdec_refusals(wh, switch):
    """A request without frames raises ``ValueError`` naming them (the JAX
    engine fails on ``None`` deeper in, with an ``AttributeError``); forcing
    the prefix cache, a speculative draft or the chunked-prefill kernel
    raises, in both packages."""
    jmodel, jparams, port = wh
    if switch == "frames":
        eng = ContinuousEngine(port, **KNOBS)
        with pytest.raises(ValueError, match="frames"):
            eng.submit(np.arange(4), 3)
        assert not eng.has_work()
        return
    jkw, kw = {"prefix_cache": False}, {}
    if switch == "prefix_cache":
        jkw["prefix_cache"] = kw["prefix_cache"] = True
    elif switch == "draft":
        jkw["draft_params"], kw["draft_model"] = jparams, port
    else:
        jkw["prefill_kernel"] = kw["prefill_kernel"] = True
    with pytest.raises(ValueError):
        JEngine(jmodel, jparams, compute_dtype=jnp.float32,
                cache_dtype=jnp.float32, **KNOBS, **jkw)
    with pytest.raises(ValueError):
        ContinuousEngine(port, **KNOBS, **kw)


def test_warmup_signatures_match_jax(wh):
    jmodel, jparams, port = wh
    jeng = JEngine(jmodel, jparams, compute_dtype=jnp.float32,
                   cache_dtype=jnp.float32, prefix_cache=False, **KNOBS)
    eng = ContinuousEngine(port, **KNOBS)
    jdec, jpre = jeng.warmup_signatures(21)
    dec, pre = eng.warmup_signatures(21)
    assert dec == [(b, nb) for b, nb, _ in jdec] and pre == jpre == []


def test_serve_launcher_on_whisper():
    """The fixed-batch mode serves the pipeline's frames and equals the
    continuous engine's ``generate``; ``--continuous`` raises the engine's
    frames error at the first submit, since the synthetic trace carries no
    frames (the reference crashes there)."""
    fixed = launcher.main(["--arch", NAME, "--smoke", "--requests", "2",
                           "--prompt-len", "8", "--new-tokens", "4",
                           "--device", "cpu"])
    assert set(fixed["batch"]) == {"tokens", "frames"}
    cont = ContinuousEngine(fixed["model"], block_size=4, num_blocks=64,
                            max_running=2)
    np.testing.assert_array_equal(
        cont.generate(fixed["batch"]["tokens"], 4,
                      extras={"frames": fixed["batch"]["frames"]}),
        fixed["tokens"])
    with pytest.raises(ValueError, match="frames"):
        launcher.main(["--continuous", "--arch", NAME, "--smoke",
                       "--requests", "2", "--new-tokens", "4",
                       "--device", "cpu"])
