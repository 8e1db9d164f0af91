"""jamba (family hybrid: Mamba beside attention, MoE on every other layer)
of the port against the JAX package, on the CPU at SMOKE size: the config
copy and layer pattern, the parameter tree through ``convert`` (dense and
factored, bit-exact), the Mamba mixer's prefill and decode with its state,
the LM's logits and loss, calibration, COALA per linear and per expert, one
AdamW step, the pipeline and the compression launcher.

Inputs come from numpy with a seed; weights are the JAX init through
``convert.params_from_numpy``. Tolerances: the mixer and its state 1e-5
(fp32, sums in another order); logits 1e-4 and the loss 1e-5 relative
(eight layers of fp32 rounding); RᵀR at 1e-4 of its largest entry; the
reports' errors at 1e-4 and the factors as A·B at 1e-4 of their largest
entry (SVDs of the same matrices in two libraries); the AdamW step 2e-6 a
leaf.
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
from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.core.calibrate import calibrate_model as j_calibrate
from repro.core.compress import compress_model as j_compress
from repro.models import build_model as j_build
from repro.models import ssm as j_ssm
from repro.models.common import CPU_CTX as J_CPU_CTX
from repro.models.common import ParallelCtx as JParallelCtx
from repro.models.transformer import period_specs as j_period_specs
from repro.train import optimizer as jopt
from repro.train.train_loop import make_train_step as j_make_train_step
from repro_torch.config import CompressConfig, TrainConfig
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.calibrate import calibrate_model
from repro_torch.core.compress import compress_model
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch import compress as launch_compress
from repro_torch.models.common import CPU_CTX
from repro_torch.models.ssm import Mamba
from repro_torch.models.transformer import period_specs
from repro_torch.train import optimizer as topt
from repro_torch.train.train_loop import make_train_state, make_train_step

torch.set_num_threads(1)

NAME = "jamba_v0_1_52b"
CFG = get_smoke_config(NAME)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jb():
    """(JAX model, JAX params, numpy tree, port model), jamba SMOKE."""
    jmodel = j_build(j_smoke(NAME))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, tree, params_from_numpy(tree, CFG, device="cpu")


def _tokens(b, t, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, t)).astype(np.int32)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        elif isinstance(v, tuple):
            for i, x in enumerate(v):
                out[f"{prefix}{k}/{i}"] = np.asarray(x)
        else:
            out[prefix + k] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("get,jget", [(get_config, j_config),
                                      (get_smoke_config, j_smoke)],
                         ids=["full", "smoke"])
def test_config_and_layer_pattern_are_the_jax_ones(get, jget):
    """Field for field (MambaConfig too); ``layer_kind`` and
    ``period_specs`` as the reference's, also at the depth 8 the card runs
    (one period: attention at layer 4, seven Mamba layers, MoE on the odd
    ones)."""
    assert NAME in ARCH_IDS
    ours, theirs = get(NAME), jget(NAME)
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if f.name in ("moe", "mamba", "xlstm"):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    for cfg, jcfg in ((ours, theirs), (dataclasses.replace(ours, n_layers=8),
                                       dataclasses.replace(theirs, n_layers=8))):
        assert [cfg.layer_kind(i) for i in range(cfg.n_layers)] == [
            jcfg.layer_kind(i) for i in range(jcfg.n_layers)]
        pre, per, n_rep = period_specs(cfg)
        jpre, jper, jn = j_period_specs(jcfg)
        assert (len(pre), n_rep) == (len(jpre), jn)
        assert [(s.kind, s.is_moe) for s in per] == [(s.kind, s.is_moe)
                                                    for s in jper]
        assert len(per) == cfg.attn_every
    if get is get_config:
        per = period_specs(dataclasses.replace(ours, n_layers=8))[1]
        assert [s.kind for s in per] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
        assert [s.is_moe for s in per] == [False, True] * 4


@pytest.mark.parametrize("factored", [False, True])
def test_convert_round_trip_bit_exact(jb, factored):
    """Every leaf of the JAX tree — Mamba's four linears and its bare
    ``conv_w``, ``dt_bias``, ``a_log``, ``d_skip``, the attention layer's,
    the MLPs and the expert banks — survives the round trip bit for bit,
    dense and with the mixers' ``in_proj``/``out_proj`` factored."""
    _, _, tree, tmodel = jb
    if factored:
        rng = np.random.RandomState(5)

        def factor(path, node):
            if isinstance(node, dict) and "w" in node and path[-1] in (
                    "in_proj", "out_proj"):
                n_rep, d_in, d_out = node["w"].shape
                return {"b_t": rng.standard_normal((n_rep, d_in, 7)).astype(
                            np.float32),
                        "a_t": rng.standard_normal((n_rep, 7, d_out)).astype(
                            np.float32)}
            if isinstance(node, dict):
                return {k: factor(path + (k,), v) for k, v in node.items()}
            return node
        tree = factor((), tree)
        tmodel = params_from_numpy(tree, CFG, device="cpu")
        assert tmodel.blocks[0]["sub0"].mixer.in_proj.is_factored
    back = params_to_numpy(tmodel)
    la, ta = jax.tree.flatten(back)
    lb, tb = jax.tree.flatten(tree)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    mixer = back["blocks"]["sub0"]["mixer"]
    assert set(mixer) == {"in_proj", "conv_w", "x_proj", "dt_proj", "dt_bias",
                          "a_log", "d_skip", "out_proj"}
    assert ("b_t" in mixer["in_proj"]) == factored
    assert mixer["a_log"].shape == (2, 128, 8)        # (n_rep, d_inner, d_state)
    assert set(back["blocks"]["sub1"]["ffn"]) == {"router", "w_gate", "w_up",
                                                  "w_down"}
    assert set(back["blocks"]["sub2"]["mixer"]) == {"wq", "wk", "wv", "wo"}


def test_init_draws_mambas_leaves_as_the_reference():
    """``LM.init``: conv taps N(0, 1/d_conv), dt = softplus(dt_bias) in
    [1e-3, 1e-1], ``a_log`` = log(1..d_state) on every row, ``d_skip`` 1 —
    the reference's ``mamba_init`` distributions (its draws cannot be
    reproduced)."""
    from repro_torch.models import build_model
    cfg = dataclasses.replace(CFG, d_model=256)
    m = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    mixer = m.blocks[0]["sub0"].mixer
    jp = j_ssm.mamba_init(jax.random.PRNGKey(0), j_smoke(NAME))
    assert isinstance(mixer, Mamba)
    dt = torch.nn.functional.softplus(mixer.dt_bias)
    assert 1e-3 * 0.999 <= float(dt.min()) and float(dt.max()) <= 0.1 * 1.001
    np.testing.assert_allclose(mixer.a_log[3].detach().numpy(),
                               np.asarray(jp["a_log"][0]), rtol=1e-7)
    assert torch.equal(mixer.d_skip, torch.ones_like(mixer.d_skip))
    std = float(mixer.conv_w.std()) * math.sqrt(cfg.mamba.d_conv)
    assert 0.9 < std < 1.1
    assert mixer.dt_bias.dtype == mixer.a_log.dtype == torch.float32


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad", [False, True])
def test_mamba_mixer_prefill_and_decode_match_jax(jb, grad):
    """Layer 0's mixer: a prefill from zeros (no cache), a prefill from a
    given cache (numpy conv window and SSM state), then three decode steps,
    the output and both state leaves after each; with autograd on and off
    (the prefill scan computes dt inside its steps, or for all steps
    before it)."""
    jmodel, jparams, _, tmodel = jb
    cfg = jmodel.cfg
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["sub0"]["mixer"])
    mixer = tmodel.blocks[0]["sub0"].mixer
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    want, _ = j_ssm.mamba_apply(cfg, jp, jnp.asarray(x), ctx=J_CPU_CTX)
    with torch.set_grad_enabled(grad):
        got = mixer(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)

    di, ds = 2 * cfg.d_model, cfg.mamba.d_state
    jc = {"conv": jnp.asarray(rng.standard_normal((2, 3, di)).astype(np.float32)),
          "h": jnp.asarray(rng.standard_normal((2, di, ds)).astype(np.float32))}
    tc = {k: torch.tensor(np.asarray(v)) for k, v in jc.items()}
    want, jc = j_ssm.mamba_apply(cfg, jp, jnp.asarray(x), ctx=J_CPU_CTX,
                                 cache=jc)
    with torch.set_grad_enabled(grad):
        got = mixer(torch.from_numpy(x), cache=tc)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for k in ("conv", "h"):
        np.testing.assert_allclose(tc[k].detach().numpy(), np.asarray(jc[k]), **TOL)
    for i in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, jc = j_ssm.mamba_apply(cfg, jp, jnp.asarray(xt), ctx=J_CPU_CTX,
                                     cache=jc, pos=jnp.int32(11 + i))
        with torch.set_grad_enabled(grad):
            got = mixer(torch.from_numpy(xt), cache=tc, pos=11 + i)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
        for k in ("conv", "h"):
            np.testing.assert_allclose(tc[k].detach().numpy(), np.asarray(jc[k]), **TOL,
                                       err_msg=f"step {i} {k}")


def test_logits_and_loss_match_jax(jb):
    jmodel, jparams, _, tmodel = jb
    tok = _tokens(2, 24)
    x = jmodel._embed(jparams, jnp.asarray(tok)).astype(jnp.float32)
    want = np.asarray(jmodel._logits(
        jparams, jmodel._backbone(jparams, x, ctx=J_CPU_CTX)[0]))
    got = tmodel.logits(torch.from_numpy(tok)).numpy()
    assert got.shape == want.shape == (2, 24, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    jl, jparts = jmodel.loss(jparams, {"tokens": jnp.asarray(tok)},
                             compute_dtype=jnp.float32)
    with torch.no_grad():
        tl, parts = tmodel.loss(torch.from_numpy(tok),
                                compute_dtype=torch.float32)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(parts["aux"]), float(jparts["aux"]),
                               rtol=1e-5)
    assert float(parts["aux"]) > 0.0                     # the MoE layers'


def test_contiguous_prefill_and_decode_match_jax(jb):
    """``prefill`` then 4 greedy ``decode_step``s over a contiguous cache
    (the Mamba layers' fp32 state beside the attention layers' K/V)."""
    jmodel, jparams, _, tmodel = jb
    tok = _tokens(2, 10, seed=3)
    jc = jmodel.init_cache(2, 16, dtype=jnp.float32)
    jl, jc = jmodel.prefill(jparams, jnp.asarray(tok), jc,
                            compute_dtype=jnp.float32)
    tc = tmodel.init_contiguous_cache(2, 16)
    assert set(tc[0]) == {"conv", "h"} and set(tc[2]) == {"k", "v"}
    tl = tmodel.prefill(torch.from_numpy(tok), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, -1], **TOL)
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)
    for i in range(4):
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(nxt[:, None]), jc,
                                    jnp.int32(10 + i), compute_dtype=jnp.float32)
        tl = tmodel.decode_step(torch.from_numpy(nxt[:, None]), tc, 10 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    h = np.asarray(jc["blocks"]["sub0"]["mixer"]["h"][1])   # layer 4
    np.testing.assert_allclose(tc[4]["h"].numpy(), h, **TOL)


# ---------------------------------------------------------------------------
# calibration and compression
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def calibrated(jb):
    jmodel, jparams, _, tmodel = jb
    batches = [_tokens(8, 32, seed=1)]
    jcal = j_calibrate(jmodel, jparams,
                       [{"tokens": jnp.asarray(b)} for b in batches])
    tcal = calibrate_model(tmodel, [torch.from_numpy(b) for b in batches])
    return jcal, tcal


def test_calibration_keys_and_r_factors_match_jax(calibrated):
    """The same streams in both: each Mamba layer's ``in_proj``, ``x_proj``
    and ``out_proj`` (never ``dt_proj``, which the prefill scan multiplies
    by its raw weight), the attention and MLP linears, and each MoE layer's
    per-expert inputs and hidden states. RᵀR at 1e-4."""
    jcal, tcal = calibrated
    jr, tr = jcal.r_factors(), tcal.r_factors()
    assert sorted(jr) == sorted(tr)
    roles = {p.rsplit("/", 1)[1] for p in tr}
    assert "dt_proj" not in roles
    assert {"in_proj", "x_proj", "out_proj", "wq", "up", "in", "hid"} <= roles
    assert sum(p.endswith("/in_proj") for p in tr) == 6
    for p in tr:
        a, b = np.asarray(jr[p]), tr[p].numpy()
        want = a.T @ a
        np.testing.assert_allclose(b.T @ b, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=p)


def test_thin_r_factors_square_to_r_factors_and_keep_their_moment(
        jb, calibrated):
    """``thin_r_factors()`` holds each stream's R as accumulated, whose
    ``square_r`` is ``r_factors()``'s, as of its moment (a later record
    does not change it); ``compress_model``, which squares each one where
    its projection is solved, gives bit for bit what it gives from square
    Rs (the recalibration snapshot's)."""
    from repro_torch.core.calibrate import Calibrator
    from repro_torch.core.tsqr import square_r
    from repro_torch.serve.recalibrate import _Snapshot
    cal = Calibrator()
    rng = np.random.RandomState(2)
    cal.record("a", torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32)))
    thin = cal.thin_r_factors()
    before = thin["a"]
    assert list(thin) == ["a"] and before.shape == (3, 8)
    assert torch.equal(square_r(before), cal.r_factors()["a"])
    cal.record("a", torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)))
    assert thin["a"] is before and cal.thin_r_factors()["a"].shape == (7, 8)
    tmodel, (_, tcal) = jb[3], calibrated
    ccfg = CompressConfig(method="coala", ratio=0.6, lam=4.0, mu=-1.0)
    lazy, lrep = compress_model(tmodel, tcal, ccfg)
    eager, erep = compress_model(tmodel, _Snapshot(tcal), ccfg)
    np.testing.assert_equal([dataclasses.astuple(r) for r in lrep],
                            [dataclasses.astuple(r) for r in erep])
    for (k, a), (k2, b) in zip(lazy.state_dict().items(),
                               eager.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k


def test_coala_reports_match_jax(jb, calibrated):
    """COALA (ratio 0.6, λ 4): per-linear reports (Mamba's ``in_proj`` /
    ``out_proj``, attention, MLP) and per-expert reports, equal in path and
    rank, errors at 1e-4; ``x_proj``/``dt_proj`` stay dense; the factors as
    A·B at 1e-4."""
    jmodel, jparams, _, tmodel = jb
    jcal, tcal = calibrated
    kw = dict(method="coala", ratio=0.6, lam=4.0, mu=-1.0)
    jc, jrep = j_compress(jmodel, jparams, jcal, JCompressConfig(**kw))
    tc, trep = compress_model(tmodel, tcal, CompressConfig(**kw))
    jd, td = {r.path: r for r in jrep}, {r.path: r for r in trep}
    assert sorted(td) == sorted(jd)
    n_moe = sum(CFG.layer_is_moe(i) for i in range(CFG.n_layers))
    assert sum(bool(re.search(r"/e\d+$", p)) for p in td) == \
        3 * CFG.moe.num_experts * n_moe
    assert {p.rsplit("/", 1)[1] for p in td if not re.search(r"/e\d+$", p)} \
        == {"in_proj", "out_proj", "wq", "wk", "wv", "wo", "up", "gate", "down"}
    for p, r in td.items():
        assert (r.rank, r.params_before, r.params_after) == (
            jd[p].rank, jd[p].params_before, jd[p].params_after), p
        assert r.mu == pytest.approx(jd[p].mu, rel=1e-5, abs=1e-12), p
        for f in ("rel_err_weighted", "rel_err_bound"):
            np.testing.assert_allclose(getattr(r, f), getattr(jd[p], f),
                                       rtol=0, atol=1e-4, equal_nan=True,
                                       err_msg=f"{p} {f}")
    mixer = tc.blocks[0]["sub0"].mixer
    assert mixer.in_proj.is_factored and not mixer.x_proj.is_factored
    assert not mixer.dt_proj.is_factored
    want, got = _leaves(jax.tree.map(np.asarray, jc)), _leaves(params_to_numpy(tc))
    assert sorted(want) == sorted(got)
    for k in want:
        if k.endswith("b_t"):
            a_k = k[:-3] + "a_t"
            w = np.einsum("...ir,...ro->...io", want[k], want[a_k])
            g = np.einsum("...ir,...ro->...io", got[k], got[a_k])
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(), err_msg=k)
        elif k.endswith("/0"):                       # a factored expert bank
            w = want[k] @ want[k[:-1] + "1"]
            g = got[k] @ got[k[:-1] + "1"]
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(), err_msg=k)


# ---------------------------------------------------------------------------
# training, pipeline, launcher
# ---------------------------------------------------------------------------

def test_adamw_step_matches_jax(jb):
    """One fp32 train step (weight decay 0.1): every leaf within 2e-6.
    Mamba's 1-D ``dt_bias`` and ``d_skip`` sit under ``blocks.``, so the
    reference's stacked (n_rep, d_inner) leaves decay, and the port's do."""
    jmodel, _, tree, _ = jb
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, schedule="cosine",
              compute_dtype="float32", eps=1e-3, weight_decay=0.1)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jparams, "opt": jopt.adamw_init(jparams)}
    jstep = jax.jit(j_make_train_step(jmodel, JTrainConfig(**kw), JParallelCtx()))
    model = params_from_numpy(tree, CFG, device="cpu")
    mixer = model.blocks[0]["sub0"].mixer
    assert topt.reference_ndim("blocks.0.sub0.mixer.dt_bias", mixer.dt_bias) == 2
    assert topt.reference_ndim("blocks.0.sub0.mixer.d_skip", mixer.d_skip) == 2
    state = make_train_state(model)
    step = make_train_step(model, TrainConfig(**kw), CPU_CTX)
    tok = _tokens(4, 16, seed=12)
    jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(tok)})
    state, met = step(state, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    want = _leaves(jax.tree.map(np.asarray, jstate["params"]))
    got = _leaves(params_to_numpy(state["model"]))
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=0, atol=2e-6, err_msg=k)
    moved = tree["blocks"]["sub0"]["mixer"]["d_skip"] - want[
        "blocks/sub0/mixer/d_skip"]
    assert np.abs(moved).max() > 0


def test_pipeline_admits_hybrid():
    pipe = TokenPipeline(DataConfig(vocab_size=256, seq_len=16,
                                    global_batch=2), CFG, device="cpu")
    batch = pipe.get_batch(0)
    assert set(batch) == {"tokens"} and batch["tokens"].shape == (2, 16)


def test_compress_launcher_on_jamba(capsys):
    """The compression launcher end to end on jamba SMOKE: pretraining
    through the Mamba scan under autograd (checkpointed per chunk) and the
    MoE, evaluation, calibration and COALA per linear and per expert."""
    out = launch_compress.main(["--arch", NAME, "--smoke", "--device", "cpu",
                                "--pretrain-steps", "2", "--calib-batches",
                                "1"])
    s = out["summary"]
    assert s["layers"] == len(out["reports"]) > 6 * 2
    assert np.isfinite(s["base_ce"]) and np.isfinite(s["compressed_ce"])
    assert abs(s["compressed_ce"] - s["base_ce"]) < 1.0
    assert '"method": "coala"' in capsys.readouterr().out
