"""jamba serving against the JAX engines, on the CPU at SMOKE size: the
continuous engine on a hybrid model, with the attention layers' K/V in
pages (read by ``paged_attention``'s plain version at decode) beside the
Mamba layers' conv window and SSM state in per-request slots.

jamba SMOKE (8 layers: Mamba, with attention at layers 2 and 6; MoE on the
odd layers; projections x3 and random norm scales: ``varied_tree``) serves
a staggered trace over a pool small enough to preempt, with a fork of a
running request, after both engines' warmup; the port's ``ContinuousEngine`` must give the JAX
``ContinuousEngine``'s greedy tokens (``prefix_cache=False``, the
reference's route for a model without chunked prefill) request by request,
and each request's tokens must equal the port's fixed-batch ``ServeEngine``
on its prompt alone. Also: the three switches a hybrid model refuses in
both packages (``ValueError``), the warmup signatures, the slot stores'
dtype, and the serve launcher on jamba. Prompts take three lengths, since
the JAX engine compiles its prefill once per length.
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
from test_torch_serve_prefix import varied_tree
from test_torch_xlstm_serve import drive, trace

torch.set_num_threads(1)

NAME = "jamba_v0_1_52b"
# 12 usable pages of 4 tokens for up to 4 running requests of up to 25
# positions: the youngest is preempted and prefilled again over prompt +
# output; a fork of request 0 at step 1. Batches of 2 and 3 rows pad to 4,
# so padding rows read the trash slot's state and take MoE capacity
KNOBS = dict(block_size=4, num_blocks=13, max_running=4, bucket_sizes=(1, 4))
WARM_LEN = 25


@pytest.fixture(scope="module")
def jb():
    jmodel = j_build(j_smoke(NAME))
    tree = varied_tree(jax.tree.map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(0))))
    port = params_from_numpy(tree, get_smoke_config(NAME), device="cpu")
    return jmodel, jax.tree.map(jnp.asarray, tree), port


@pytest.fixture(scope="module")
def jax_run(jb):
    jmodel, jparams, _ = jb
    jeng = JEngine(jmodel, jparams, compute_dtype=jnp.float32,
                   cache_dtype=jnp.float32, async_detok=False,
                   prefix_cache=False, **KNOBS)
    jeng.warmup(max_len=WARM_LEN)
    toks, child = drive(jeng, trace())
    return toks, child, jeng


def test_trace_matches_jax_engine_and_serve_engine(jb, jax_run):
    """Greedy tokens equal the JAX engine's through a preemption and a
    fork, both engines warmed first (the warmup's all-padding passes leave
    the trash slot's state, which the padding rows read); every request is
    prefilled alone; the attention layers' pages and the Mamba layers'
    slots are both in use."""
    _, _, port = jb
    jtoks, jchild, jeng = jax_run
    eng = ContinuousEngine(port, **KNOBS)
    eng.warmup(max_len=WARM_LEN)
    assert not eng.prefix_cache and not eng.prefill_kernel
    assert eng.paged_kernel and eng.pool.has_state
    toks, child = drive(eng, trace())
    m, jm = eng.metrics(), jeng.metrics()
    assert toks == jtoks and child == jchild and len(toks) == 7
    assert len({t for ts in toks.values() for t in ts}) > 8   # not degenerate
    assert m["preemptions"] == jm["preemptions"] >= 1
    assert {r.req_id: r.preemptions for r in eng.finished} == {
        r.req_id: r.preemptions for r in jeng.finished}
    assert m["decode_shapes"] == jm["decode_shapes"]
    assert m["decode_steps"] == jm["decode_steps"]
    assert m["prefill_kernel"] == jm["prefill_kernel"] == 0.0
    assert m["prefill_batches"] == 0 and m["prefix_hit_tokens"] == 0
    assert eng.request_prefills == 6 + m["preemptions"]
    fin = {r.req_id: r for r in eng.finished}
    assert eng.pool.available_blocks == eng.pool.usable_blocks
    assert eng.pool.free_slots == KNOBS["max_running"]
    fixed = ServeEngine(port)
    rids = sorted(r for r in fin if r != child)       # in submission order
    for rid, (_, prompt, new) in zip(rids, trace()):
        out = fixed.generate(prompt[None], new)
        assert list(out[0, len(prompt):]) == fin[rid].out_tokens, rid


def test_pool_holds_pages_and_fp32_state_slots(jb):
    """Attention layers hold {"k", "v"} pages in the cache dtype; Mamba
    layers hold {"conv", "h"} slot stores in fp32 whatever it is, one slot
    more than max_running (the trash slot)."""
    _, _, port = jb
    cfg = port.cfg
    eng = ContinuousEngine(port, cache_dtype=torch.bfloat16, **KNOBS)
    n_blocks, n_slots = KNOBS["num_blocks"], KNOBS["max_running"] + 1
    kinds = port.layer_kinds()
    assert kinds == [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    di, ds = cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state
    for kind, layer in zip(kinds, eng.pool.pages):
        if kind == "attn":
            assert set(layer) == {"k", "v"}
            assert layer["k"].dtype == torch.bfloat16
            assert layer["k"].shape == (n_blocks, 4, cfg.n_kv_heads, cfg.head_dim)
        else:
            assert set(layer) == {"conv", "h"}
            assert layer["conv"].shape == (n_slots, cfg.mamba.d_conv - 1, di)
            assert layer["h"].shape == (n_slots, di, ds)
            assert all(v.dtype == torch.float32 for v in layer.values())


def test_padding_rows_write_the_last_ones_state():
    """Rows that share a slot (padding rows, all on the trash slot) write
    the last one's state, as a sequential scatter does, so a graph replay
    and an eager call leave the same trash state on the card."""
    from repro_torch.models.common import last_write_wins
    from repro_torch.models.xlstm import write_state
    slots = torch.tensor([1, 3, 0, 3, 3])
    assert last_write_wins(slots, 4).tolist() == [0, 4, 2, 4, 4]
    keys = torch.as_tensor(np.random.default_rng(0).integers(0, 7, 200))
    want = {int(k): i for i, k in enumerate(keys)}     # a sequential scatter
    assert last_write_wins(keys, 7).tolist() == [want[int(k)] for k in keys]
    cache = {"h": torch.zeros((4, 2))}
    state = torch.arange(10, dtype=torch.float32).view(5, 2)
    write_state(cache, slots, {"h": (2,)}, (state,))
    assert cache["h"].tolist() == [[4, 5], [0, 1], [0, 0], [8, 9]]


@pytest.mark.parametrize("switch", ["prefix_cache", "draft", "prefill_kernel"])
def test_hybrid_model_refuses(jb, switch):
    """Forcing the prefix cache, a speculative draft or the chunked-prefill
    kernel on a hybrid model raises, in both packages."""
    jmodel, jparams, port = jb
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
    eng = ContinuousEngine(port, prefix_cache=None, prefill_kernel=None,
                           **KNOBS)
    assert (eng.prefix_cache, eng.prefill_kernel, eng.paged_kernel) == (
        False, False, True)


def test_warmup_signatures_match_jax(jb):
    """The same signatures as the JAX engine's; an eager warmup runs each
    once on all-padding inputs, as the reference's does, writing only the
    trash page and the trash slot, and a second warmup runs none again. A
    model without an MoE layer, whose padding rows reach no real row, runs
    none."""
    jmodel, jparams, port = jb
    jeng = JEngine(jmodel, jparams, compute_dtype=jnp.float32,
                   cache_dtype=jnp.float32, prefix_cache=False, **KNOBS)
    eng = ContinuousEngine(port, **KNOBS)
    jdec, jpre = jeng.warmup_signatures(WARM_LEN)
    dec, pre = eng.warmup_signatures(WARM_LEN)
    assert dec == [(b, nb) for b, nb, _ in jdec] and pre == jpre == []
    trash = eng.pool.trash_slot
    stores = [st for layer in eng.pool._state_layers for st in layer.values()]
    eng.warmup(max_len=WARM_LEN)            # eager: nothing to capture
    assert eng.post_warmup_compiles() == 0 and eng.warmed
    assert all(bool(st[trash].any()) for st in stores)
    assert not any(bool(st[:trash].any()) for st in stores)
    before = [st.clone() for st in stores]
    eng.warmup(max_len=WARM_LEN)
    assert all(torch.equal(a, b) for a, b in zip(before, stores))
    from repro_torch.models import build_model
    dense = ContinuousEngine(build_model(get_smoke_config("smollm_135m"),
                                         device="cpu").init(
        torch.Generator().manual_seed(0)), **KNOBS)
    dense.warmup(max_len=WARM_LEN)
    assert dense.warmed and not dense._trash_runs
    assert not any(bool(pg.any()) for layer in dense.pool.pages
                   for pg in layer.values())


def test_serve_engine_matches_jax_serve_engine(jb):
    """fp32 fixed batch, 2 rows of 9 tokens, 6 new: the JAX ServeEngine and
    the port's, whose 2-row prefill routes the MoE at the batch's capacity."""
    jmodel, jparams, port = jb
    prompt = np.random.RandomState(7).randint(0, 256, (2, 9)).astype(np.int32)
    want = np.asarray(JServeEngine(jmodel, jparams, compute_dtype=jnp.float32,
                                   cache_dtype=jnp.float32).generate(
        jnp.asarray(prompt), 6))
    np.testing.assert_array_equal(ServeEngine(port).generate(prompt, 6), want)


def test_serve_launcher_on_jamba(capsys):
    """``--arch jamba_v0_1_52b --smoke``: ``--prefix-cache auto`` serves the
    hybrid model with the cache off and ``on`` raises, as in the reference;
    COALA factors ``in_proj``/``out_proj`` and leaves ``x_proj``/``dt_proj``
    dense. An MoE's capacity comes from a call's token count (padding
    included, as in the reference), so a 2-row prefill routes differently
    from two prefills alone: the continuous engine, which prefills each
    request alone and decodes at most 2 rows (under the capacity floor: no
    drop), equals the fixed-batch engine row by row."""
    out = launcher.main(["--continuous", "--arch", NAME, "--smoke",
                         "--requests", "3", "--new-tokens", "4", "--warmup",
                         "on", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert printed.count("prefix cache off") == 2
    for name in ("dense", "coala"):
        eng = out["engines"][name]
        assert out["metrics"][name]["requests"] == 3
        assert eng.request_prefills == 3 and not eng.prefix_cache
    mixer = out["engines"]["coala"].model.blocks[0]["sub0"].mixer
    assert mixer.in_proj.is_factored and mixer.out_proj.is_factored
    assert not mixer.x_proj.is_factored and not mixer.dt_proj.is_factored
    with pytest.raises(ValueError, match="prefix caching"):
        launcher.main(["--continuous", "--arch", NAME, "--smoke",
                       "--requests", "2", "--new-tokens", "4",
                       "--prefix-cache", "on", "--device", "cpu"])
    fixed = launcher.main(["--arch", NAME, "--smoke", "--requests", "2",
                           "--prompt-len", "8", "--new-tokens", "4",
                           "--device", "cpu"])
    serve, prompts = ServeEngine(fixed["model"]), fixed["batch"]["tokens"]
    np.testing.assert_array_equal(serve.generate(prompts, 4), fixed["tokens"])
    rows = np.concatenate([serve.generate(p[None], 4) for p in prompts])
    cont = ContinuousEngine(fixed["model"], block_size=4, num_blocks=64,
                            max_running=2)
    np.testing.assert_array_equal(cont.generate(prompts, 4), rows)
