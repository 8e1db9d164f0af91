"""Port baselines, randomized COALA, Gram calibration, compress_model for
every method and the compression launcher vs the JAX package, on the CPU.

Same numpy inputs (and JAX-made parameters, through numpy) go to both
packages. Tolerances: baseline W' = A·B at 1e-4·max|W'| (fp32 SVDs and
solves of well-conditioned 24 x 32 problems; factors compared as W'
because signs are free); Grams at rtol 1e-5 with atol 1e-5·max|G|;
compress reports at rtol 1e-4 on the relative errors and equal non-finite
sets; compressed logits at 1e-4 (as tests/test_torch_core.py). rsvd is held
by its subspace error against the exact top-r subspace (1e-3), since its
Gaussian sketch cannot equal jax.random's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CompressConfig as JCompressConfig
from repro.configs import get_smoke_config as j_smoke
from repro.core import baselines as jbl
from repro.core import coala as jcoala
from repro.core.calibrate import Calibrator as JCalibrator
from repro.core.calibrate import calibrate_model as j_calibrate
from repro.core.compress import compress_model as j_compress
from repro.models import build_model as j_build
from repro_torch.config import CompressConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import baselines as bl
from repro_torch.core import coala
from repro_torch.core.calibrate import calibrate_model
from repro_torch.core.compress import compress_model, compression_summary
from repro_torch.launch import compress as launch_compress

torch.set_num_threads(1)

METHODS = ["coala", "svd", "svd_llm", "svd_llm_v2", "asvd"]


def _randn(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _close_w(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["svd_llm", "svd_llm_v2", "asvd", "plain_svd",
                                  "corda"])
def test_baseline_matches_jax(name):
    w, x = _randn(0, (24, 32)), _randn(1, (32, 64))
    args = {"svd_llm": (w, x @ x.T), "svd_llm_v2": (w, x @ x.T), "asvd": (w, x),
            "plain_svd": (w,), "corda": (w, x)}[name]
    ja, jb = getattr(jbl, name)(*map(jnp.asarray, args), 6)
    ta, tb = getattr(bl, name)(*map(torch.from_numpy, args), 6)
    assert tuple(ta.shape) == (24, 6) and tuple(tb.shape) == (6, 32)
    _close_w((ta @ tb).numpy(), np.asarray(ja @ jb))


def test_svd_llm_orientation_matches_the_reference():
    """The triangular solve has the reference's orientation: with
    XXᵀ = L Lᵀ, ``repro/core/baselines.py:svd_llm`` returns
    W' = U_r Σ_r V_rᵀ L^{-T} (its solve_triangular(Lᵀ, ·, lower=False,
    trans="T")), computed here in float64. That is not the weighted optimum
    U_r Σ_r V_rᵀ L^{-1} of Algorithm 3 (ROADMAP Queue 3 records this);
    the port keeps the reference's form, so the two forms must differ on
    this input and the port must match the first."""
    w, x = _randn(2, (24, 32)), _randn(3, (32, 64))
    a, b = bl.svd_llm(torch.from_numpy(w), torch.from_numpy(x @ x.T), 5)
    low = np.linalg.cholesky((x @ x.T).astype(np.float64))
    u, s, vt = np.linalg.svd(w.astype(np.float64) @ low)
    core = (u[:, :5] * s[:5]) @ vt[:5]
    ref_form = core @ np.linalg.inv(low).T
    paper_form = core @ np.linalg.inv(low)
    assert np.abs(ref_form - paper_form).max() > 0.1 * np.abs(ref_form).max()
    np.testing.assert_allclose((a @ b).numpy(), ref_form, rtol=0,
                               atol=1e-4 * np.abs(ref_form).max())


def test_svd_llm_nonfinite_on_rank_deficient_gram_like_jax():
    """Rank-deficient X (tests/test_coala.py:262-271): SVD-LLM's Cholesky
    fails and its factors are non-finite, at exactly the entries where the
    JAX package's are; COALA stays finite."""
    w, x_thin = _randn(16, (16, 24)), _randn(17, (24, 8))       # rank 8 < n=24
    gram = x_thin @ x_thin.T
    ja, jb = jbl.svd_llm(jnp.asarray(w), jnp.asarray(gram), 4)
    ta, tb = bl.svd_llm(torch.from_numpy(w), torch.from_numpy(gram), 4)
    want, got = np.asarray(ja @ jb), (ta @ tb).numpy()
    assert not np.all(np.isfinite(got))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    w_apx = coala.coala_factors(torch.from_numpy(w), torch.from_numpy(x_thin),
                                rank=4).w_approx
    assert torch.all(torch.isfinite(w_apx))


# ---------------------------------------------------------------------------
# randomized SVD
# ---------------------------------------------------------------------------

def _decaying(seed, m, n):
    u, _ = np.linalg.qr(_randn(seed, (m, m)))
    v, _ = np.linalg.qr(_randn(seed + 1, (n, n)))
    s = 0.5 ** np.arange(min(m, n))
    return (u[:, :len(s)] * s) @ v[:, :len(s)].T


@pytest.mark.parametrize("power_iters", [1, 2])
def test_rsvd_subspace_matches_exact_top_r(power_iters):
    m = _decaying(4, 64, 48).astype(np.float32)
    r = 6
    u = coala.rsvd_left_singvecs(torch.from_numpy(m), r,
                                 power_iters=power_iters).numpy()
    u_ex = np.linalg.svd(m.astype(np.float64))[0][:, :r]
    assert np.allclose(u.T @ u, np.eye(r), atol=1e-5)
    err = np.linalg.norm(u_ex @ u_ex.T - u @ u.T, 2)
    assert err < 1e-3, err


def test_coala_rsvd_matches_exact_and_jax():
    """use_rsvd=True reaches the full-SVD factors (and JAX's randomized ones)
    on a layer whose W Rᵀ spectrum decays fast."""
    w = _decaying(6, 24, 32).astype(np.float32)
    x = _randn(8, (32, 64))
    exact = coala.coala_factors(torch.from_numpy(w), torch.from_numpy(x), rank=5,
                                lam=4.0)
    got = coala.coala_factors(torch.from_numpy(w), torch.from_numpy(x), rank=5,
                              lam=4.0, use_rsvd=True)
    want = jcoala.coala_factors(jnp.asarray(w), jnp.asarray(x), rank=5, lam=4.0,
                                use_rsvd=True)
    np.testing.assert_allclose(got.mu, exact.mu, rtol=1e-3)
    np.testing.assert_allclose(got.mu, want.mu, rtol=1e-3)
    _close_w(got.w_approx.numpy(), exact.w_approx.numpy())
    _close_w(got.w_approx.numpy(), np.asarray(want.w_approx))


# ---------------------------------------------------------------------------
# Gram calibration and compress_model on llama3_1b SMOKE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def calibrated():
    """JAX and port models from the same JAX parameters, calibrated with
    Grams on the tokens of tests/test_torch_core.py's compressed_pair."""
    jmodel = j_build(j_smoke("llama3_1b"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    toks = [rng.randint(0, 256, (4, 32)).astype(np.int32) for _ in range(2)]
    jcal = j_calibrate(jmodel, jparams, [{"tokens": jnp.asarray(t)} for t in toks],
                       collect_gram=True)
    tmodel = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               get_smoke_config("llama3_1b"), device="cpu")
    tcal = calibrate_model(tmodel, [torch.from_numpy(t) for t in toks],
                           collect_gram=True)
    return (jmodel, jparams, jcal), (tmodel, tcal), toks


def test_calibrator_grams_match_jax(calibrated):
    (_, _, jcal), (_, tcal), _ = calibrated
    assert sorted(tcal.grams) == sorted(jcal.grams) and len(tcal.grams) == 14
    for p, jg in jcal.grams.items():
        want = np.asarray(jg)
        np.testing.assert_allclose(tcal.grams[p].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    # the Gram is XXᵀ = RᵀR of the same activations
    r = tcal.r_factors()["blocks/1/sub0/ffn/down"]
    g = tcal.grams["blocks/1/sub0/ffn/down"]
    torch.testing.assert_close(r.T @ r, g, rtol=1e-4, atol=1e-4 * float(g.abs().max()))


def test_calibrator_reset_keeps_the_instance(calibrated):
    _, (tmodel, _), toks = calibrated
    cal = calibrate_model(tmodel, [torch.from_numpy(toks[0])], collect_gram=True)
    assert cal.grams and cal.streams
    cal.reset()
    assert not cal.grams and not cal.streams and cal.collect_gram
    tmodel.capture_forward(torch.from_numpy(toks[0]), cal)
    assert len(cal.grams) == 14


@pytest.mark.parametrize("method", METHODS)
def test_compress_model_matches_jax(calibrated, method):
    """Every method: the same layers, ranks and parameter counts, relative
    errors at rtol 1e-4, non-finite exactly where JAX's are (svd_llm's
    Cholesky fails on some SMOKE Grams), and compressed logits at 1e-4."""
    (jmodel, jparams, jcal), (tmodel, tcal), toks = calibrated
    kw = dict(method=method, ratio=0.6, lam=4.0, mu=-1.0)
    jcc, jreports = j_compress(jmodel, jparams, jcal, JCompressConfig(**kw))
    tcc, treports = compress_model(tmodel, tcal, CompressConfig(**kw))
    jrep = {r.path: r for r in jreports}
    assert sorted(jrep) == sorted(r.path for r in treports) and len(treports) == 14
    for tr in treports:
        jr = jrep[tr.path]
        assert (tr.rank, tr.params_before, tr.params_after) == (
            jr.rank, jr.params_before, jr.params_after)
        assert np.isfinite(tr.rel_err_weighted) == np.isfinite(jr.rel_err_weighted)
        if np.isfinite(jr.rel_err_weighted):
            np.testing.assert_allclose(tr.rel_err_weighted, jr.rel_err_weighted,
                                       rtol=1e-4)
        np.testing.assert_allclose(tr.mu, jr.mu, rtol=1e-3)
        np.testing.assert_allclose(tr.rel_err_bound, jr.rel_err_bound, rtol=1e-4)
    h = jmodel.capture_forward(jcc, {"tokens": jnp.asarray(toks[0])}, JCalibrator())
    want = np.asarray(jmodel._logits(jcc, h))
    got = tcc.logits(torch.from_numpy(toks[0])).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-4)


def test_compress_rank_override(calibrated):
    _, (tmodel, tcal), _ = calibrated
    _, reports = compress_model(tmodel, tcal, CompressConfig(method="svd", rank=7))
    assert {r.rank for r in reports} == {7}
    assert compression_summary(reports)["layers"] == 14


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["coala", "svd_llm"])
def test_compress_launcher_end_to_end_on_cpu(method, capsys):
    """``python -m repro_torch.launch.compress --smoke --device cpu``:
    pretrain, evaluate, calibrate, compress, evaluate; prints the JSON
    summary and returns what chip_smoke.py reads."""
    out = launch_compress.main(["--smoke", "--device", "cpu", "--method", method,
                                "--pretrain-steps", "4", "--calib-batches", "2"])
    s = out["summary"]
    assert f'"method": "{method}"' in capsys.readouterr().out
    assert set(out) == {"summary", "reports", "model", "compressed", "calibrator",
                        "calib_batches", "seconds"}
    assert set(out["seconds"]) == {"pretrain", "eval", "calibrate", "compress"}
    assert s["layers"] == 14 and 0.5 < s["kept_ratio"] <= 0.6
    assert np.isfinite(s["base_ce"]) and s["base_ce"] < np.log(256) + 0.1
    assert out["compressed"].blocks[0]["sub0"].mixer.wq.is_factored
    assert not out["model"].blocks[0]["sub0"].mixer.wq.is_factored
    assert [tuple(b.shape) for b in out["calib_batches"]] == [(8, 64)] * 2
    assert out["calibrator"].tokens_seen()["blocks/0/sub0/mixer/wq"] == 2 * 8 * 64
    if method == "coala":
        assert np.isfinite(s["compressed_ce"])
        for r in out["reports"]:
            assert np.isfinite(r.rel_err_weighted)
            assert r.rel_err_weighted >= r.rel_err_bound * (1 - 1e-3)
    again = launch_compress.eval_ce(out["compressed"], launch_compress.make_pipeline(
        get_smoke_config("llama3_1b"), "cpu"))
    np.testing.assert_allclose(again, s["compressed_ce"], rtol=1e-6,
                               equal_nan=True)
