"""Port COALA core vs the JAX package, on the CPU, on the same numpy inputs.

Tolerances: TSQR R entrywise after the sign fix (and RᵀR where tokens < n
leave R rank-deficient) at 1e-4; COALA μ at rtol 1e-3 and W' = A·B (sign
free) at rtol 1e-4 / atol 1e-5; compress_model reports (ranks equal, μ and
relative errors at rtol 1e-3) and compressed logits at 1e-4 on llama3_1b
SMOKE with JAX-made parameters converted through numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CompressConfig as JCompressConfig
from repro.configs import get_smoke_config as j_smoke
from repro.core import coala as jcoala
from repro.core import tsqr as jtsqr
from repro.core.calibrate import Calibrator as JCalibrator
from repro.core.calibrate import calibrate_model as j_calibrate
from repro.core.compress import compress_model as j_compress
from repro.models import build_model as j_build
from repro_torch.config import CompressConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import coala, tsqr
from repro_torch.core.calibrate import calibrate_model
from repro_torch.core.compress import compress_model, compression_summary

torch.set_num_threads(1)


def _randn(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# TSQR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tokens,n,chunk", [(256, 32, 64), (200, 48, 50),
                                            (96, 96, 32)])
def test_tsqr_sequential_matches_jax(tokens, n, chunk):
    x = _randn(0, (tokens, n))
    chunks = [x[i:i + chunk] for i in range(0, tokens, chunk)]
    want = np.asarray(jtsqr.tsqr_sequential([jnp.asarray(c) for c in chunks]))
    got = tsqr.tsqr_sequential([torch.from_numpy(c) for c in chunks]).numpy()
    assert np.all(np.diagonal(got) >= 0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_rstreamer_rank_deficient_matches_jax_as_gram():
    """tokens < n: R is not unique, so compare RᵀR after squaring to (n, n)."""
    n = 64
    chunks = [_randn(1, (20, n)), _randn(2, (16, n))]
    js, ts = jtsqr.RStreamer(n), tsqr.RStreamer(n)
    for c in chunks:
        js.update(jnp.asarray(c))
        ts.update(torch.from_numpy(c))
    want = np.asarray(js.finish())
    got = ts.finish().numpy()
    assert got.shape == (n, n) and ts.tokens_seen == 36
    np.testing.assert_allclose(got.T @ got, want.T @ want, rtol=1e-4, atol=1e-4)


def test_augment_r_with_mu_matches_jax():
    r = np.triu(_randn(3, (24, 24)))
    want = np.asarray(jtsqr.augment_r_with_mu(jnp.asarray(r), 0.37))
    got = tsqr.augment_r_with_mu(torch.from_numpy(r), 0.37).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# COALA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d_out,n,k,rank", [(48, 32, 128, 8), (32, 64, 256, 12)])
def test_coala_factors_matches_jax(d_out, n, k, rank):
    w = _randn(4, (d_out, n))
    x = _randn(5, (n, k)) * np.linspace(0.1, 3.0, n, dtype=np.float32)[:, None]
    jres = jcoala.coala_factors(jnp.asarray(w), jnp.asarray(x), rank=rank,
                                lam=4.0)
    tres = coala.coala_factors(torch.from_numpy(w), torch.from_numpy(x),
                               rank=rank, lam=4.0)
    assert tres.mu > 0
    np.testing.assert_allclose(tres.mu, jres.mu, rtol=1e-3)
    np.testing.assert_allclose(tres.w_approx.numpy(), np.asarray(jres.w_approx),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# compress_model on llama3_1b SMOKE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def compressed_pair():
    jcfg = j_smoke("llama3_1b")
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    toks = [rng.randint(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
            for _ in range(2)]
    jcal = j_calibrate(jmodel, jparams, [{"tokens": jnp.asarray(t)} for t in toks])
    jcc, jreports = j_compress(jmodel, jparams, jcal,
                               JCompressConfig(method="coala", ratio=0.6,
                                               lam=4.0, mu=-1.0))
    tree = jax.tree.map(np.asarray, jparams)
    tmodel = params_from_numpy(tree, get_smoke_config("llama3_1b"), device="cpu")
    tcal = calibrate_model(tmodel, [torch.from_numpy(t) for t in toks])
    tcc, treports = compress_model(tmodel, tcal,
                                   CompressConfig(method="coala", ratio=0.6,
                                                  lam=4.0, mu=-1.0))
    return (jmodel, jcal, jcc, jreports), (tmodel, tcal, tcc, treports), toks


def test_calibration_r_factors_match_jax(compressed_pair):
    (_, jcal, _, _), (_, tcal, _, _), _ = compressed_pair
    jr, tr = jcal.r_factors(), tcal.r_factors()
    assert sorted(jr) == sorted(tr)
    for p in jr:
        a, b = tr[p].numpy(), np.asarray(jr[p])
        np.testing.assert_allclose(a.T @ a, b.T @ b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b.T @ b).max())
    assert tcal.tokens_seen() == jcal.tokens_seen()


def test_compress_reports_match_jax(compressed_pair):
    (_, _, _, jreports), (_, _, _, treports), _ = compressed_pair
    jrep = {r.path: r for r in jreports}
    trep = {r.path: r for r in treports}
    assert sorted(jrep) == sorted(trep) and len(trep) == 14
    for p, jr in jrep.items():
        tr = trep[p]
        assert tr.rank == jr.rank
        assert (tr.params_before, tr.params_after) == (jr.params_before,
                                                       jr.params_after)
        np.testing.assert_allclose(tr.mu, jr.mu, rtol=1e-3)
        np.testing.assert_allclose(tr.rel_err_weighted, jr.rel_err_weighted,
                                   rtol=1e-3)
        np.testing.assert_allclose(tr.rel_err_bound, jr.rel_err_bound, rtol=1e-3)
    s = compression_summary(treports)
    assert s["layers"] == 14 and 0.5 < s["kept_ratio"] <= 0.6


def test_compressed_logits_match_jax(compressed_pair):
    (jmodel, _, jcc, _), (tmodel, _, tcc, _), toks = compressed_pair
    tok = toks[0]
    h = jmodel.capture_forward(jcc, {"tokens": jnp.asarray(tok)}, JCalibrator())
    want = np.asarray(jmodel._logits(jcc, h))
    got = tcc.logits(torch.from_numpy(tok)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the compressed copy is factored; the source model stays dense
    assert tcc.blocks[0]["sub0"].mixer.wq.is_factored
    assert not tmodel.blocks[0]["sub0"].mixer.wq.is_factored


def test_compress_rejects_unported_method(compressed_pair):
    """Every method of the JAX package is ported; a method neither package
    knows raises ValueError, as ``repro/core/compress.py:_solve`` does."""
    _, (tmodel, tcal, _, _), _ = compressed_pair
    with pytest.raises(ValueError, match="unknown method"):
        compress_model(tmodel, tcal, CompressConfig(method="svd_llm_v3"))
