"""deepseek_moe_16b's MoE layer in the port against the JAX package, on the
CPU (SMOKE: 8 routed experts top-2, one shared expert, min capacity 2).

Routing is held exactly: the expert set of every token, each expert's
capacity selection among tokens of non-zero gate (ties toward the lower
index, as ``jax.lax.top_k``, also between identical rows), and the aux loss
(rtol 1e-6); the layer's output at rtol/atol 1e-5 (fp32), with capacity
dropping tokens. The combine equals a plain scatter-add and repeats bit for
bit. Calibration records the same per-expert paths with RᵀR within 1e-4 of
the JAX calibrator's; per-expert COALA gives the JAX ranks, and
``rel_err_weighted`` / ``rel_err_bound`` within 1e-4 of the JAX reports; an
expert no calibration token reached gets the plain-SVD factors and a NaN
report, and the compressed model's logits agree at 1e-4. One AdamW step with the aux term matches the JAX step, and greedy
tokens through the port's ``ContinuousEngine`` equal the JAX engine's on a
staggered trace with the prefix cache on.
"""
import dataclasses
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CompressConfig as JCompressConfig
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as j_smoke
from repro.core.calibrate import calibrate_model as j_calibrate
from repro.core.compress import compress_model as j_compress
from repro.launch.serve import serve_trace as j_serve_trace
from repro.launch.serve import synthetic_trace as j_synthetic_trace
from repro.models import build_model as j_build
from repro.models import ffn as j_ffn
from repro.models.common import CPU_CTX as J_CPU_CTX
from repro.models.common import ParallelCtx as JParallelCtx
from repro.serve import ContinuousEngine as JEngine
from repro.train import optimizer as jopt
from repro.train.train_loop import make_train_step as j_make_train_step
from repro_torch.config import CompressConfig, TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import baselines as bl
from repro_torch.core.calibrate import calibrate_model
from repro_torch.core.compress import compress_model
from repro_torch.launch.serve import serve_trace, synthetic_trace
from repro_torch.models import ffn
from repro_torch.models.common import CPU_CTX
from repro_torch.serve import ContinuousEngine
from repro_torch.train.train_loop import make_train_state, make_train_step

torch.set_num_threads(1)

NAME = "deepseek_moe_16b"
CFG = get_smoke_config(NAME)
TOL = dict(rtol=1e-5, atol=1e-5)
UNUSED = 5            # the expert the calibration never routes to


@pytest.fixture(scope="module")
def jax_lm():
    jmodel = j_build(j_smoke(NAME))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams, jax.tree.map(np.asarray, jparams)


def _moe_tree(tree):
    """The first MoE layer's parameters (blocks rep 0)."""
    return jax.tree.map(lambda a: a[0], tree["blocks"]["sub0"]["ffn"])


def _port_moe(tree):
    layer = ffn.MoE(CFG, device="cpu")
    sub = _moe_tree(tree)
    with torch.no_grad():
        layer.router.copy_(torch.tensor(sub["router"]))
        for k in ("w_gate", "w_up", "w_down"):
            getattr(layer, k).w.copy_(torch.tensor(sub[k]))
        for k in ("up", "down", "gate"):
            getattr(layer.shared, k).w.copy_(torch.tensor(sub["shared"][k]["w"]))
    return layer, sub


def _x(n, seed=0, dup=0):
    """(n, d) activations; the last ``dup`` rows repeat the first ones."""
    x = np.random.RandomState(seed).standard_normal((n, CFG.d_model)).astype(np.float32)
    if dup:
        x[n - dup:] = x[:dup]
    return x


# ---------------------------------------------------------------------------
# routing and the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,dup", [(37, 0), (64, 16), (5, 2)])
def test_routing_and_capacity_selection_exact(jax_lm, n, dup):
    layer, sub = _port_moe(jax_lm[2])
    x = _x(n, seed=n, dup=dup)
    jgw, jaux = j_ffn._route(jnp.asarray(x), jnp.asarray(sub["router"]), j_smoke(NAME))
    with torch.no_grad():
        gw, aux = ffn.route(torch.from_numpy(x), layer.router, CFG)
    jgw = np.asarray(jgw)
    np.testing.assert_array_equal(gw.numpy() > 0, jgw > 0)
    np.testing.assert_allclose(gw.numpy(), jgw, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    cap = ffn.capacity(n, CFG)
    assert cap == j_ffn._capacity(n, j_smoke(NAME), J_CPU_CTX)
    jw, jidx = jax.lax.top_k(jnp.asarray(jgw).T, cap)
    w, idx = ffn.top_k(torch.from_numpy(jgw).T, cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    # and on the port's own gates: the tokens each expert keeps
    w2, idx2 = ffn.top_k(gw.T, cap)
    for e in range(CFG.moe.num_experts):
        keep = set(np.asarray(jidx)[e][np.asarray(jw)[e] > 0])
        assert set(idx2[e][w2[e] > 0].tolist()) == keep, e


@pytest.mark.parametrize("b,t", [(2, 19), (1, 1), (3, 8)])
def test_moe_layer_matches_jax(jax_lm, b, t):
    layer, sub = _port_moe(jax_lm[2])
    x = _x(b * t, seed=7).reshape(b, t, CFG.d_model)
    jy, jaux = j_ffn.moe_apply(j_smoke(NAME), jax.tree.map(jnp.asarray, sub),
                               jnp.asarray(x), ctx=J_CPU_CTX)
    with torch.no_grad():
        y, aux = layer(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_combine_is_a_deterministic_scatter_add():
    rng = np.random.RandomState(4)
    n, k, e, c, d = 30, 2, 8, 9, 16
    gw = torch.zeros((n, e))
    for t in range(n):
        gw[t, torch.from_numpy(rng.choice(e, k, replace=False))] = \
            torch.from_numpy(rng.rand(k).astype(np.float32))
    w_sel, idx = ffn.top_k(gw.T, c)
    y_e = torch.from_numpy(rng.standard_normal((e, c, d)).astype(np.float32))
    got = ffn.combine(y_e, idx, w_sel, n, k)
    want = torch.zeros((n, d)).index_add_(
        0, idx.reshape(-1), (y_e * (w_sel > 0)[..., None]).reshape(-1, d))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(got, ffn.combine(y_e, idx, w_sel, n, k))


# ---------------------------------------------------------------------------
# calibration and per-expert compression
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def calibrated(jax_lm):
    """Both packages calibrated on the same tokens; then expert ``UNUSED`` of
    the first MoE layer loses its streams in both calibrators, as when no
    calibration token reaches it."""
    jmodel, jparams, tree = jax_lm
    tmodel = params_from_numpy(tree, CFG, device="cpu")
    rng = np.random.RandomState(0)
    toks = [rng.randint(0, CFG.vocab_size, (4, 24)).astype(np.int32)
            for _ in range(2)]
    jcal = j_calibrate(jmodel, jparams, [{"tokens": jnp.asarray(t)} for t in toks])
    tcal = calibrate_model(tmodel, [torch.from_numpy(t) for t in toks])
    for kind in ("in", "hid"):
        for cal in (jcal, tcal):
            del cal.streams[f"blocks/0/sub0/ffn/expert{UNUSED}/{kind}"]
    return jmodel, jparams, tmodel, jcal, tcal


def test_per_expert_calibration_matches_jax(calibrated):
    *_, jcal, tcal = calibrated
    jr, tr = jcal.r_factors(), tcal.r_factors()
    assert set(jr) == set(tr)
    experts = sorted(p for p in jr if "/expert" in p)
    assert experts and all(p.startswith("blocks/") for p in experts)
    assert not any(f"blocks/0/sub0/ffn/expert{UNUSED}/" in p for p in experts)
    assert any(f"blocks/1/sub0/ffn/expert{UNUSED}/" in p for p in experts)
    assert any(p.startswith("prefix/0/ffn/") for p in jr)
    assert any("/ffn/shared/" in p for p in jr)
    assert jcal.tokens_seen() == tcal.tokens_seen()
    for p in jr:
        a, b = np.asarray(jr[p]), tr[p].numpy()
        np.testing.assert_allclose(b.T @ b, a.T @ a, rtol=1e-4, atol=1e-4,
                                   err_msg=p)


def test_per_expert_coala_matches_jax(calibrated):
    jmodel, jparams, tmodel, jcal, tcal = calibrated
    kw = dict(method="coala", ratio=0.6, lam=4.0, mu=-1.0)
    jcp, jrep = j_compress(jmodel, jparams, jcal, JCompressConfig(**kw))
    tcp, trep = compress_model(tmodel, tcal, CompressConfig(**kw))
    want = {r.path: r for r in jrep}
    got = {r.path: r for r in trep}
    assert set(got) == set(want)
    n_moe = CFG.n_layers - CFG.first_k_dense
    assert sum(bool(re.search(r"/e\d+$", p)) for p in got) == \
        3 * CFG.moe.num_experts * n_moe
    for p, r in got.items():
        assert r.rank == want[p].rank and r.mu == pytest.approx(want[p].mu, rel=1e-5), p
        for f in ("rel_err_weighted", "rel_err_bound"):
            a, b = getattr(r, f), getattr(want[p], f)
            assert (math.isnan(a) and math.isnan(b)) or math.isclose(
                a, b, abs_tol=1e-4), (p, f, a, b)
    # the expert nothing reached: plain-SVD factors and a NaN report
    moe = tcp.blocks[0]["sub0"].ffn
    jfn = jax.tree.map(np.asarray, jcp["blocks"]["sub0"]["ffn"])
    for mat in ("w_gate", "w_up", "w_down"):
        rep = got[f"blocks/0/sub0/ffn/{mat}/e{UNUSED}"]
        assert math.isnan(rep.rel_err_weighted) and rep.mu == 0.0
        bank = getattr(moe, mat)
        with torch.no_grad():
            w = getattr(tmodel.blocks[0]["sub0"].ffn, mat).w[UNUSED]
            a, b = bl.plain_svd(w.T, rep.rank)
            got_w = (bank.b_t @ bank.a_t).numpy()
        np.testing.assert_allclose(got_w[UNUSED], (a @ b).T.numpy(),
                                   rtol=1e-5, atol=1e-5)
        jb_t, ja_t = jfn[mat]
        np.testing.assert_allclose(got_w, jb_t[0] @ ja_t[0], rtol=1e-4, atol=1e-4)
    # the converted trees have the same structure (factored banks as tuples)
    assert jax.tree.structure(params_to_numpy(tcp)) == jax.tree.structure(
        jax.tree.map(np.asarray, jcp))
    tok = np.random.RandomState(5).randint(0, CFG.vocab_size, (2, 16)).astype(np.int32)
    x = jmodel._embed(jcp, jnp.asarray(tok)).astype(jnp.float32)
    h, _, _ = jmodel._backbone(jcp, x, ctx=J_CPU_CTX)
    # the factors carry the two SVDs' rounding: logits at 1e-4
    np.testing.assert_allclose(tcp.logits(torch.from_numpy(tok)).numpy(),
                               np.asarray(jmodel._logits(jcp, h)),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# training with the aux term
# ---------------------------------------------------------------------------

def test_train_step_with_aux_matches_jax(jax_lm):
    """One fp32 AdamW step (eps 1e-3, as tests/test_torch_train.py): loss
    (ce + aux), aux and every parameter after the update."""
    jmodel, jparams, tree = jax_lm
    tokens = np.random.RandomState(3).randint(0, CFG.vocab_size, (4, 16)).astype(np.int32)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, schedule="cosine",
              compute_dtype="float32", eps=1e-3)
    jstate = {"params": jparams, "opt": jopt.adamw_init(jparams)}
    jstep = jax.jit(j_make_train_step(jmodel, JTrainConfig(**kw), JParallelCtx()))
    jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(tokens)})
    model = params_from_numpy(tree, CFG, device="cpu")
    state = make_train_state(model)
    state, met = make_train_step(model, TrainConfig(**kw), CPU_CTX)(
        state, {"tokens": torch.from_numpy(tokens)})
    assert float(met["aux"]) > 0
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                               rtol=1e-4)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jstate["params"]))
    got = jax.tree.leaves(params_to_numpy(state["model"]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-6)


# ---------------------------------------------------------------------------
# the slice as a whole: the MoE through the engine against the JAX engine
# ---------------------------------------------------------------------------

KNOBS = dict(block_size=4, num_blocks=48, max_running=3, bucket_sizes=(1, 2, 3),
             prefill_bucket_sizes=(16, 64))
TRACE = dict(seed=2, min_prompt=20, max_prompt=60, max_new=8, arrival_every=1,
             shared_prefix=8)


def test_engine_greedy_tokens_match_jax(jax_lm):
    """5 staggered requests (prompts 28-68, a shared 8-token prefix), prefix
    cache on both sides, fp32: capacity comes from each step's padded token
    count on both sides, so the routing and the tokens agree."""
    jmodel, jparams, tree = jax_lm
    jeng = JEngine(jmodel, jparams, compute_dtype=jnp.float32,
                   cache_dtype=jnp.float32, prefix_cache=True,
                   paged_kernel=True, prefill_kernel=True, async_detok=False,
                   **KNOBS)
    j_serve_trace(jeng, j_synthetic_trace(5, CFG.vocab_size, **TRACE))
    want = {r.req_id: list(r.out_tokens) for r in jeng.finished}
    eng = ContinuousEngine(params_from_numpy(tree, CFG, device="cpu"),
                           prefix_cache=True, **KNOBS)
    met = serve_trace(eng, synthetic_trace(5, CFG.vocab_size, **TRACE))
    assert {r.req_id: list(r.out_tokens) for r in eng.finished} == want
    assert met["prefix_hit_rate"] > 0


def test_moe_config_is_a_copy():
    from repro.config import MoEConfig as JMoEConfig
    from repro_torch.config import MoEConfig
    assert [f.name for f in dataclasses.fields(MoEConfig)] == \
        [f.name for f in dataclasses.fields(JMoEConfig)]
    assert dataclasses.asdict(CFG.moe) == dataclasses.asdict(j_smoke(NAME).moe)
