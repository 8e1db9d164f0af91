"""xLSTM serving against the JAX engines, on the CPU at SMOKE size: the
recurrent route of the continuous engine over the pool's per-request state
slots.

xLSTM SMOKE (projections x3, random norm scales: ``varied_tree``) serves a
staggered trace over a pool small enough to preempt a request once, with a
fork of a running request; the port's ``ContinuousEngine`` must give the JAX
``ContinuousEngine``'s greedy tokens (``prefix_cache=False``, the reference's
route for a model without chunked prefill) request by request, and each
request's tokens must equal the port's fixed-batch ``ServeEngine`` on its
prompt alone. Also: the three switches a recurrent model refuses in both
packages (``ValueError``), a freed slot reused with poisoned state, the
warmup signatures, the graph inputs' trash slot, the fixed-batch engines
against each other, and the serve launcher on xLSTM. Prompts take three
lengths, since the JAX engine compiles its prefill once per length.
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
from repro_torch.serve import ContinuousEngine, ServeEngine
from repro_torch.serve.engine import _trash_inputs, _views
from test_torch_serve_prefix import varied_tree

torch.set_num_threads(1)

NAME = "xlstm_1_3b"
# 10 usable pages of 4 tokens for up to 3 running requests of up to 25
# positions: the youngest is preempted (twice on this trace) and prefilled
# again over prompt + output
KNOBS = dict(block_size=4, num_blocks=11, max_running=3, bucket_sizes=(1, 2, 3))
FORK_AT, FORK_REQ = 1, 0        # step, request id


def trace(n=6, seed=4):
    """(arrival step, prompt, max_new): prompts of 5, 9 or 13 tokens, 8-12
    new tokens, one request a step."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        t0 = int(rng.choice([5, 9, 13]))
        out.append((i, rng.randint(0, 256, (t0,)).astype(np.int32),
                    int(rng.randint(8, 13))))
    return out


def drive(eng, tr, fork_at=FORK_AT):
    """Replay the trace step by step (either package's engine), forking
    ``FORK_REQ`` at step ``fork_at``; returns (tokens by request id, the
    fork's child id)."""
    pending = list(tr)
    step, child = 0, None
    while pending or eng.has_work():
        while pending and pending[0][0] <= step:
            _, prompt, new = pending.pop(0)
            eng.submit(prompt, new)
        if step == fork_at:
            child = eng.fork(FORK_REQ)
        eng.step()
        step += 1
    return {r.req_id: list(r.out_tokens) for r in eng.finished}, child


@pytest.fixture(scope="module")
def xl():
    jmodel = j_build(j_smoke(NAME))
    tree = varied_tree(jax.tree.map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(0))))
    port = params_from_numpy(tree, get_smoke_config(NAME), device="cpu")
    return jmodel, jax.tree.map(jnp.asarray, tree), port


@pytest.fixture(scope="module")
def jax_run(xl):
    jmodel, jparams, _ = xl
    jeng = JEngine(jmodel, jparams, compute_dtype=jnp.float32,
                   cache_dtype=jnp.float32, async_detok=False,
                   prefix_cache=False, **KNOBS)
    toks, child = drive(jeng, trace())
    return toks, child, jeng


def test_trace_matches_jax_engine_and_serve_engine(xl, jax_run):
    _, _, port = xl
    jtoks, jchild, jeng = jax_run
    eng = ContinuousEngine(port, **KNOBS)
    assert not eng.prefix_cache and not eng.prefill_kernel
    toks, child = drive(eng, trace())
    m, jm = eng.metrics(), jeng.metrics()
    assert toks == jtoks and child == jchild and len(toks) == 7
    assert m["preemptions"] == jm["preemptions"] >= 1
    assert {r.req_id: r.preemptions for r in eng.finished} == {
        r.req_id: r.preemptions for r in jeng.finished}
    assert m["decode_shapes"] == jm["decode_shapes"]
    assert m["decode_steps"] == jm["decode_steps"]
    assert m["prefill_kernel"] == jm["prefill_kernel"] == 0.0
    assert m["prefill_batches"] == 0 and m["prefix_hit_tokens"] == 0
    # every request is prefilled alone, once more after each preemption; the
    # fork's child is never prefilled unless preempted: it starts from the
    # parent's slot
    assert eng.request_prefills == 6 + m["preemptions"]
    fin = {r.req_id: r for r in eng.finished}
    assert not any(r.cacheable for r in fin.values())
    assert fin[child].out_tokens == fin[FORK_REQ].out_tokens
    assert eng.pool.available_blocks == eng.pool.usable_blocks
    assert eng.pool.free_slots == KNOBS["max_running"]
    # each request alone through the fixed-batch engine
    fixed = ServeEngine(port)
    rids = sorted(r for r in fin if r != child)       # in submission order
    for rid, (_, prompt, new) in zip(rids, trace()):
        out = fixed.generate(prompt[None], new)
        assert list(out[0, len(prompt):]) == fin[rid].out_tokens, rid


@pytest.mark.parametrize("switch", ["prefix_cache", "draft", "prefill_kernel"])
def test_recurrent_model_refuses(xl, switch):
    """Forcing the prefix cache, a speculative draft or the chunked-prefill
    kernel on a recurrent model raises, in both packages."""
    jmodel, jparams, port = xl
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
    # the defaults the refusals leave: both off
    eng = ContinuousEngine(port, prefix_cache=None, prefill_kernel=None,
                           **KNOBS)
    assert (eng.prefix_cache, eng.prefill_kernel, eng.paged_kernel) == (
        False, False, False)


def test_reused_slot_carries_no_old_state(xl):
    """One slot: request A runs to the end, its slot's state is then
    poisoned (the trash slot too), and request B, which takes the same slot,
    gives the tokens it gives alone on a fresh engine."""
    _, _, port = xl
    (_, pa, na), (_, pb, nb), _ = trace(3, seed=9)
    knobs = dict(block_size=4, num_blocks=16, max_running=1,
                 bucket_sizes=(1,))
    eng = ContinuousEngine(port, **knobs)
    eng.submit(pa, na)
    eng.run()
    assert eng.pool.free_slots == 1
    for layer in eng.pool._state_layers:
        for store in layer.values():
            store.fill_(7.0)
    rb = eng.submit(pb, nb)
    eng.run()
    got = next(r for r in eng.finished if r.req_id == rb).out_tokens
    fresh = ContinuousEngine(port, **knobs)
    fresh.submit(pb, nb)
    assert got == fresh.run()[0].out_tokens
    assert got == list(ServeEngine(port).generate(pb[None], nb)[0, len(pb):])


def test_warmup_signatures_match_jax(xl):
    jmodel, jparams, port = xl
    jeng = JEngine(jmodel, jparams, compute_dtype=jnp.float32,
                   cache_dtype=jnp.float32, prefix_cache=False, **KNOBS)
    eng = ContinuousEngine(port, **KNOBS)
    jdec, jpre = jeng.warmup_signatures(25)
    dec, pre = eng.warmup_signatures(25)
    assert dec == [(b, nb) for b, nb, _ in jdec] and pre == jpre == []
    eng.warmup(max_len=25)                  # eager: nothing to capture
    assert eng.post_warmup_compiles() == 0 and eng.warmed


def test_graph_inputs_put_padding_on_the_trash_slot(xl):
    _, _, port = xl
    eng = ContinuousEngine(port, **KNOBS)
    assert eng.pool.trash_slot == KNOBS["max_running"]
    sig = ("decode", 3, 2)
    views = _views(sig, torch.as_tensor(_trash_inputs(sig, eng.pool.trash_slot)),
                   True)
    assert views["slots"].tolist() == [3, 3, 3]
    assert views["tok"].shape == (3, 1) and not views["tables"].any()
    eng.submit(np.arange(5), 4)
    eng.step()
    assert eng.pool.slots([0], rows=3).tolist() == [eng.pool.slot(0), 3, 3]


def test_serve_engines_match_jax_serve_engine(xl):
    """fp32 fixed batch, 2 rows of 9 tokens, 6 new: the JAX ServeEngine, the
    port's and the port's continuous engine's ``generate``."""
    jmodel, jparams, port = xl
    prompt = np.random.RandomState(7).randint(0, 256, (2, 9)).astype(np.int32)
    want = np.asarray(JServeEngine(jmodel, jparams, compute_dtype=jnp.float32,
                                   cache_dtype=jnp.float32).generate(
        jnp.asarray(prompt), 6))
    np.testing.assert_array_equal(ServeEngine(port).generate(prompt, 6), want)
    cont = ContinuousEngine(port, block_size=4, num_blocks=64, max_running=2)
    np.testing.assert_array_equal(cont.generate(prompt, 6), want)


def test_serve_launcher_on_xlstm(capsys):
    """``--prefix-cache auto`` serves a recurrent model with the cache off;
    ``on`` raises, as in the reference; the fixed-batch mode equals the
    continuous engine's ``generate``."""
    out = launcher.main(["--continuous", "--arch", NAME, "--smoke",
                         "--requests", "3", "--new-tokens", "4", "--warmup",
                         "on", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert printed.count("prefix cache off") == 2
    for name in ("dense", "coala"):
        eng = out["engines"][name]
        assert out["metrics"][name]["requests"] == 3
        assert eng.request_prefills == 3 and not eng.prefix_cache
    with pytest.raises(ValueError, match="prefix caching"):
        launcher.main(["--continuous", "--arch", NAME, "--smoke",
                       "--requests", "2", "--new-tokens", "4",
                       "--prefix-cache", "on", "--device", "cpu"])
    fixed = launcher.main(["--arch", NAME, "--smoke", "--requests", "2",
                           "--prompt-len", "8", "--new-tokens", "4",
                           "--device", "cpu"])
    cont = ContinuousEngine(fixed["model"], block_size=4, num_blocks=64,
                            max_running=2)
    np.testing.assert_array_equal(
        cont.generate(fixed["batch"]["tokens"], 4), fixed["tokens"])
