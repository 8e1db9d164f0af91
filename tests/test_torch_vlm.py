"""qwen2-vl (family vlm) of the port against the JAX package, on the CPU at
SMOKE size: the config copy, M-RoPE, the ``vision_proj`` leaf through
``convert``, logits and loss with a vision prefix, the contiguous-cache
prefill and decode (also gemma2's window and softcaps and MLA's absorbed
decode), the pipeline's vision batches, calibration R factors and COALA
reports, and the compression launcher end to end.

Inputs come from numpy with a seed (the vision prefix too: the port's
pipeline cannot reproduce jax.random). Tolerances: M-RoPE tables 1e-6;
logits and loss 1e-5 (fp32, sums in another order); RᵀR relative to its
largest entry and the COALA reports' errors 1e-4 (SVDs of the same matrices
in two libraries).
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
from repro.models import build_model as j_build
from repro.models.attention import _dense_sdpa as j_dense_sdpa
from repro.models.common import CPU_CTX as J_CPU_CTX
from repro.models.common import mrope_cos_sin as j_mrope_cos_sin
from repro_torch.config import CompressConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.calibrate import calibrate_model
from repro_torch.core.compress import compress_model
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models.attention import dense_sdpa
from repro_torch.models.common import mrope_cos_sin, rope_cos_sin

torch.set_num_threads(1)

NAME = "qwen2_vl_2b"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def vlm():
    """(JAX model, JAX params, numpy tree, port model), qwen2-vl SMOKE."""
    jmodel = j_build(j_smoke(NAME))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, tree, params_from_numpy(
        tree, get_smoke_config(NAME), device="cpu")


def _inputs(cfg, b, t, seed=0):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab_size, (b, t)).astype(np.int32)
    vis = rng.standard_normal((b, cfg.n_vision_tokens, cfg.d_model)).astype(
        np.float32)
    return tok, vis


def test_config_is_a_copy_of_the_jax_one():
    for ours, theirs in ((get_config(NAME), j_config(NAME)),
                         (get_smoke_config(NAME), j_smoke(NAME))):
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if f.name in ("moe", "mamba", "xlstm"):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
    assert get_config(NAME).mrope_sections == (16, 24, 24)


@pytest.mark.parametrize("hd,sections,b,t", [(16, (4, 2, 2), 2, 9),
                                            (128, (16, 24, 24), 1, 33),
                                            (32, (0, 8, 8), 3, 5)])
def test_mrope_cos_sin_on_distinct_streams(hd, sections, b, t):
    """Distinct (t, h, w) position ids per stream tell the sections apart."""
    pids = np.random.RandomState(hd).randint(0, 4096, (3, b, t)).astype(np.int32)
    jc, js = j_mrope_cos_sin(jnp.asarray(pids), hd, 1e6, sections)
    tc, ts = mrope_cos_sin(torch.from_numpy(pids), hd, 1e6, sections)
    assert tc.shape == (b, t, hd // 2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)


def test_mrope_on_broadcast_positions_is_rope():
    pos = torch.arange(7)[None] + torch.tensor([[0], [5]])
    c, s = mrope_cos_sin(pos.expand(3, 2, 7), 16, 1e6, (4, 2, 2))
    rc, rs = rope_cos_sin(pos, 16, 1e6)
    assert torch.equal(c, rc) and torch.equal(s, rs)
    with pytest.raises(ValueError, match="sections"):
        mrope_cos_sin(pos.expand(3, 2, 7), 16, 1e6, (4, 2, 1))


def test_vision_proj_round_trip_bit_exact(vlm):
    _, _, tree, tmodel = vlm
    back = params_to_numpy(tmodel)
    la, ta = jax.tree.flatten(back)
    lb, tb = jax.tree.flatten(tree)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(back["vision_proj"]["w"],
                                  tree["vision_proj"]["w"])
    assert tmodel.vision_proj.has_dense and not tmodel.vision_proj.is_factored


def test_logits_and_loss_with_vision_prefix(vlm):
    jmodel, jparams, _, tmodel = vlm
    cfg = tmodel.cfg
    tok, vis = _inputs(cfg, 2, 24)
    x = jmodel._embed(jparams, jnp.asarray(tok), jnp.asarray(vis))
    h, _, _ = jmodel._backbone(jparams, x.astype(jnp.float32), ctx=J_CPU_CTX)
    want = np.asarray(jmodel._logits(jparams, h))
    got = tmodel.logits(torch.from_numpy(tok), torch.from_numpy(vis)).numpy()
    assert got.shape == (2, cfg.n_vision_tokens + 24, cfg.vocab_size)
    np.testing.assert_allclose(got, want, **TOL)
    jl, jm = jmodel.loss(jparams, {"tokens": jnp.asarray(tok),
                                   "vision_embeds": jnp.asarray(vis)},
                         compute_dtype=jnp.float32)
    with torch.no_grad():
        tl, tm = tmodel.loss(torch.from_numpy(tok),
                             vision_embeds=torch.from_numpy(vis),
                             compute_dtype=torch.float32)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), **TOL)


@pytest.mark.parametrize("q_offset", [0, 5, np.array([3, 11])])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (6, 30.0)])
def test_dense_sdpa_q_offset(q_offset, window, cap):
    rng = np.random.RandomState(1)
    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    want = j_dense_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_offset=jnp.asarray(q_offset), causal=True,
                        window=window, cap=cap, scale=0.25)
    off = (torch.from_numpy(q_offset) if isinstance(q_offset, np.ndarray)
           else q_offset)
    got = dense_sdpa(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), causal=True, window=window, cap=cap,
                     scale=0.25, q_offset=off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_contiguous_run(jmodel, jparams, tok, vis, steps, max_len):
    jcache = jmodel.init_cache(tok.shape[0], max_len, dtype=jnp.float32)
    kw = {} if vis is None else {"vision_embeds": jnp.asarray(vis)}
    jl, jcache = jmodel.prefill(jparams, jnp.asarray(tok), jcache,
                                compute_dtype=jnp.float32, **kw)
    out = [np.asarray(jl)[:, -1]]
    pos = (0 if vis is None else vis.shape[1]) + tok.shape[1]
    for i in range(steps):
        step_tok = np.argmax(out[-1], -1).astype(np.int32)[:, None]
        jl, jcache = jmodel.decode_step(jparams, jnp.asarray(step_tok), jcache,
                                        jnp.asarray(pos + i, jnp.int32),
                                        compute_dtype=jnp.float32)
        out.append(np.asarray(jl))
    return out


def _port_contiguous_run(tmodel, tok, vis, steps, max_len):
    cache = tmodel.init_contiguous_cache(tok.shape[0], max_len)
    kw = {} if vis is None else {"vision_embeds": torch.from_numpy(vis)}
    out = [tmodel.prefill(torch.from_numpy(tok), cache, **kw).numpy()]
    pos = (0 if vis is None else vis.shape[1]) + tok.shape[1]
    for i in range(steps):
        step_tok = np.argmax(out[-1], -1).astype(np.int32)[:, None]
        out.append(tmodel.decode_step(torch.from_numpy(step_tok), cache,
                                      pos + i).numpy())
    return out


@pytest.mark.parametrize("name", [NAME, "gemma2_27b", "deepseek_v2_lite_16b"])
def test_contiguous_prefill_and_decode_match_jax(name):
    """The JAX ``init_cache``/``prefill``/``decode_step`` at a scalar
    position: qwen2-vl with its vision prefix, gemma2 past its SMOKE window
    of 32 (window and softcaps) and MLA's latent cache (absorbed decode)."""
    jmodel = j_build(j_smoke(name))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               get_smoke_config(name), device="cpu")
    cfg = tmodel.cfg
    tok, vis = _inputs(cfg, 2, 40 if name == "gemma2_27b" else 12, seed=3)
    vis = vis if cfg.family == "vlm" else None
    want = _jax_contiguous_run(jmodel, jparams, tok, vis, 4, 64)
    got = _port_contiguous_run(tmodel, tok, vis, 4, 64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_pipeline_vision_batches():
    cfg = get_smoke_config(NAME)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=3), cfg, device="cpu")
    a, b = pipe.get_batch(4), pipe.get_batch(4)
    assert a["vision_embeds"].shape == (3, cfg.n_vision_tokens, cfg.d_model)
    assert a["vision_embeds"].dtype == torch.float32
    assert torch.equal(a["vision_embeds"], b["vision_embeds"])
    assert not torch.equal(a["vision_embeds"], pipe.get_batch(5)["vision_embeds"])
    assert abs(float(a["vision_embeds"].std()) - 1.0) < 0.1
    text = TokenPipeline(DataConfig(vocab_size=256, seq_len=16, global_batch=3),
                         get_smoke_config("llama3_1b"), device="cpu")
    assert set(text.get_batch(0)) == {"tokens"}


def test_calibration_and_coala_reports_match_jax(vlm):
    """Calibration sees the vision prefix: RᵀR and the COALA reports of
    every block linear against the JAX package's, ``vision_proj`` dense."""
    jmodel, jparams, _, tmodel = vlm
    cfg = tmodel.cfg
    batches = [_inputs(cfg, 2, 24, seed=s) for s in (5, 6)]
    jcal = j_calibrate(jmodel, jparams, [
        {"tokens": jnp.asarray(t), "vision_embeds": jnp.asarray(v)}
        for t, v in batches])
    tcal = calibrate_model(tmodel, [
        {"tokens": torch.from_numpy(t), "vision_embeds": torch.from_numpy(v)}
        for t, v in batches])
    jr, tr = jcal.r_factors(), tcal.r_factors()
    assert set(jr) == set(tr) and len(tr) == 7 * cfg.n_layers
    n_tok = 2 * 2 * (cfg.n_vision_tokens + 24)
    assert all(n == n_tok for n in tcal.tokens_seen().values())
    for p in tr:
        a = np.asarray(jr[p], np.float64)
        b = tr[p].double().numpy()
        ata, btb = a.T @ a, b.T @ b
        assert np.abs(btb - ata).max() <= 1e-4 * np.abs(ata).max(), p
    kw = dict(method="coala", ratio=0.6, lam=4.0, mu=-1.0)
    _, jrep = j_compress(jmodel, jparams, jcal, JCompressConfig(**kw))
    cmodel, trep = compress_model(tmodel, tcal, CompressConfig(**kw))
    want = {r.path: r for r in jrep}
    for r in trep:
        assert r.rank == want[r.path].rank, r.path
        assert math.isclose(r.rel_err_weighted, want[r.path].rel_err_weighted,
                            abs_tol=1e-4), r.path
    assert cmodel.vision_proj.has_dense


def test_compress_launcher_runs_qwen2_vl():
    from repro_torch.launch import compress as launcher
    out = launcher.main(["--arch", NAME, "--smoke", "--device", "cpu",
                         "--pretrain-steps", "3", "--calib-batches", "2"])
    cfg = get_smoke_config(NAME)
    assert len(out["reports"]) == 7 * cfg.n_layers
    for b in out["calib_batches"]:
        assert b["vision_embeds"].shape == (8, cfg.n_vision_tokens, cfg.d_model)
    s = out["summary"]
    assert math.isfinite(s["base_ce"]) and math.isfinite(s["compressed_ce"])
    assert out["compressed"].vision_proj.has_dense
