"""The per-request serving path against the JAX engines, on the CPU.

qwen2-vl SMOKE (projections x3, random norm scales: ``varied_tree``) serves a
staggered trace in which every second request carries a (1, 8, 64) vision
prefix from a seeded numpy generator, over a pool small enough to preempt
a vision request, with a fork of a running vision request; the port's
``ContinuousEngine`` must give the JAX ``ContinuousEngine``'s greedy tokens
request by request, with async detokenization on and off (and each
request's streamed text is its tokens). The port's fixed-batch
``ServeEngine`` must give the JAX ``ServeEngine``'s tokens at fp32 on
smollm, qwen2-vl with a vision prefix, gemma2 (prompts past its SMOKE window
of 32, softcaps) and deepseek-v2's MLA (contiguous latent cache), and the
continuous engine's ``generate`` the same. Speculation refuses a vision
request. The JAX side of the trace runs once (module fixture).
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
from repro_torch.serve import ContinuousEngine, ServeEngine
from test_torch_serve_prefix import varied_tree

torch.set_num_threads(1)

NAME = "qwen2_vl_2b"
# 13 usable pages of 4 tokens for up to 3 running requests: the fork's
# child (a vision request, 8 prefix positions) is preempted once and
# prefilled again over prompt + output with its vision prefix
KNOBS = dict(block_size=4, num_blocks=14, max_running=3, bucket_sizes=(1, 2, 3))
FORK_AT, FORK_REQ = 3, 0        # step, request id (a vision request)


def mixed_trace(cfg, n=6, seed=4):
    """(arrival step, prompt, max_new, extras): prompts 4-16 tokens, 8-12 new
    tokens, every second request with an N(0, 1) vision prefix."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        prompt = rng.randint(0, cfg.vocab_size,
                             (rng.randint(4, 17),)).astype(np.int32)
        new = int(rng.randint(8, 13))
        extras = None
        if i % 2 == 0:
            extras = {"vision_embeds": rng.standard_normal(
                (1, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)}
        out.append((i, prompt, new, extras))
    return out


def drive(eng, trace, **submit_kw):
    """Replay the trace step by step (either package's engine), forking
    ``FORK_REQ`` at step ``FORK_AT``; returns (tokens by request id, the
    fork's child id)."""
    pending = list(trace)
    step = child = 0
    while pending or eng.has_work():
        while pending and pending[0][0] <= step:
            _, prompt, new, extras = pending.pop(0)
            eng.submit(prompt, new, extras=extras, **submit_kw)
        if step == FORK_AT:
            child = eng.fork(FORK_REQ)
        eng.step()
        step += 1
    return {r.req_id: list(r.out_tokens) for r in eng.finished}, child


@pytest.fixture(scope="module")
def vlm():
    jmodel = j_build(j_smoke(NAME))
    tree = varied_tree(jax.tree.map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(0))))
    port = params_from_numpy(tree, get_smoke_config(NAME), device="cpu")
    return jmodel, jax.tree.map(jnp.asarray, tree), port


@pytest.fixture(scope="module")
def jax_trace(vlm):
    jmodel, jparams, port = vlm
    jeng = JEngine(jmodel, jparams, compute_dtype=jnp.float32,
                   cache_dtype=jnp.float32, async_detok=False, **KNOBS)
    toks, _ = drive(jeng, mixed_trace(port.cfg))
    return toks, jeng.metrics(), {r.req_id: r.preemptions for r in jeng.finished}


@pytest.mark.parametrize("async_detok", [False, True])
def test_mixed_vision_trace_matches_jax_engine(vlm, jax_trace, async_detok):
    _, _, port = vlm
    jtoks, jm, jpre = jax_trace
    events = []
    eng = ContinuousEngine(port, detokenizer=lambda t: f"<{t}>",
                           async_detok=async_detok, **KNOBS)
    trace = mixed_trace(port.cfg)
    toks, child = drive(eng, trace, stream_callback=events.append)
    eng.flush_stream()
    m = eng.metrics()
    assert toks == jtoks and len(toks) == 7
    assert m["preemptions"] == jm["preemptions"] >= 1
    fin = {r.req_id: r for r in eng.finished}
    # the preempted request is a vision request, prefilled again with it
    assert {r: p for r, p in jpre.items() if p} == {
        r.req_id: r.preemptions for r in eng.finished if r.preemptions}
    assert all(fin[r].vis_offset == port.cfg.n_vision_tokens
               for r in jpre if jpre[r])
    n_vision = sum(1 for *_, ex in trace if ex is not None)
    assert eng.request_prefills == n_vision + 1 == 4
    # the fork's child continues the parent's greedy trajectory
    assert fin[child].out_tokens == fin[FORK_REQ].out_tokens
    assert fin[child].vis_offset == fin[FORK_REQ].vis_offset > 0
    # each request's events and text are its tokens, in emission order; the
    # child (forked without the callback, as in the reference) gets no
    # events and its text starts at the fork
    for rid, r in fin.items():
        assert r.cacheable == (r.vis_offset == 0)
        assert len(r.out_tokens) == r.max_new_tokens
        evs = [e for e in events if e.req_id == rid]
        start = len(r.out_tokens) - r.text.count("<")
        assert r.text == "".join(f"<{t}>" for t in r.out_tokens[start:])
        if rid == child:
            assert not evs and 0 < start < len(r.out_tokens)
            continue
        assert start == 0
        assert [e.token for e in evs] == r.out_tokens
        assert [e.index for e in evs] == list(range(len(evs)))
        assert [e.done for e in evs] == [False] * (len(evs) - 1) + [True]
    assert eng.pool.available_blocks == eng.pool.usable_blocks


def test_speculation_refuses_a_vision_request(vlm):
    _, _, port = vlm
    eng = ContinuousEngine(port, draft_model=port, spec_k=2, **KNOBS)
    vis = np.zeros((1, port.cfg.n_vision_tokens, port.cfg.d_model), np.float32)
    with pytest.raises(ValueError, match="speculative"):
        eng.submit(np.arange(5), 4, extras={"vision_embeds": vis})
    assert eng.submit(np.arange(5), 4) == 0


@pytest.mark.parametrize("name", ["smollm_135m", NAME, "gemma2_27b",
                                  "deepseek_v2_lite_16b"])
def test_serve_engine_matches_jax_serve_engine(name):
    """fp32 fixed batch: 2 rows, 6 new tokens (gemma2's prompts 40 tokens,
    past its window); the port's continuous engine's ``generate`` too."""
    cfg = get_smoke_config(name)
    jmodel = j_build(j_smoke(name))
    tree = varied_tree(jax.tree.map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(0))))
    jparams = jax.tree.map(jnp.asarray, tree)
    port = params_from_numpy(tree, cfg, device="cpu")
    rng = np.random.RandomState(7)
    prompt = rng.randint(0, cfg.vocab_size,
                         (2, 40 if name == "gemma2_27b" else 9)).astype(np.int32)
    extras = None
    if cfg.family == "vlm":
        extras = {"vision_embeds": rng.standard_normal(
            (2, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)}
    want = np.asarray(JServeEngine(jmodel, jparams, compute_dtype=jnp.float32,
                                   cache_dtype=jnp.float32).generate(
        jnp.asarray(prompt), 6,
        extras=None if extras is None else jax.tree.map(jnp.asarray, extras)))
    got = ServeEngine(port).generate(prompt, 6, extras=extras)
    assert got.dtype == np.int32 and got.shape == (2, prompt.shape[1] + 6)
    np.testing.assert_array_equal(got, want)
    cont = ContinuousEngine(port, block_size=4, num_blocks=64, max_running=2)
    np.testing.assert_array_equal(cont.generate(prompt, 6, extras=extras), want)
