"""The port's theory, Prop. 4 α-family, EYM and TSQR-tree functions vs the
JAX package, on the CPU.

Same numpy inputs go to both packages, at fp32. W has a decayed spectrum
(σ_i = 0.7^i) so that its rank-r subspaces are unique, which is the math's
precondition for comparing them. Subspaces are compared by their invariants:
W' = A·B, S_α itself (V Σ^α Vᵀ), RᵀR. Tolerances: SVD-derived scalars
(gaps, bounds, norms) at rtol 1e-4; W' and S_α at 1e-4·max|ref| (fp32 SVDs
of <= 48-wide matrices, in another order of operations); balanced_split
and gram_chunked, which are plain products and norms, at rtol 1e-5; RᵀR at
1e-4·max|ref|; Theorem 1's distances ||W₀ − W_μ|| at rtol 1e-2 with
atol 5e-5 (the fp32 rounding of two projections, ~1e-5, is a tenth of the
distance at μ = 1e-4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coala as jcoala
from repro.core import theory as jtheory
from repro.core import tsqr as jtsqr
from repro_torch.core import coala, theory, tsqr

torch.set_num_threads(1)


def _randn(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _decayed(seed, m, n, rate=0.7):
    u, _ = np.linalg.qr(_randn(seed, (m, m)))
    v, _ = np.linalg.qr(_randn(seed + 1, (n, n)))
    k = min(m, n)
    return ((u[:, :k] * rate ** np.arange(k)) @ v[:, :k].T).astype(np.float32)


def _both(fn_t, fn_j, *arrays, **kw):
    got = fn_t(*map(torch.from_numpy, arrays), **kw)
    want = fn_j(*map(jnp.asarray, arrays), **kw)
    return got, want


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


W = _decayed(0, 24, 32)
X_FULL = _randn(2, (32, 64))      # full row rank (k > n)
X_THIN = _randn(3, (32, 12))      # rank-deficient (k < n): the limited-data case


# ---------------------------------------------------------------------------
# theory.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x", [X_FULL, X_THIN], ids=["full", "thin"])
@pytest.mark.parametrize("name", ["thm1_bound", "thm5_bound",
                                  "optimal_weighted_error"])
def test_bounds_match_jax(name, x):
    args = (W, x, 5) + ((0.01,) if name != "optimal_weighted_error" else ())
    got = getattr(theory, name)(*map(torch.from_numpy, args[:2]), *args[2:])
    want = getattr(jtheory, name)(*map(jnp.asarray, args[:2]), *args[2:])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


@pytest.mark.parametrize("rank", [1, 4, 9])
def test_singular_gap_matches_jax(rank):
    got, want = _both(theory.singular_gap, jtheory.singular_gap, W @ X_FULL,
                      rank=rank)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_projector_distance_matches_jax():
    u_a = np.linalg.qr(_randn(4, (20, 5)))[0].astype(np.float32)
    u_b = np.linalg.qr(u_a + 0.1 * _randn(5, (20, 5)))[0].astype(np.float32)
    got, want = _both(theory.projector_distance, jtheory.projector_distance,
                      u_a, u_b)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    assert 0.0 < float(got) < 1.0


def test_relative_weighted_error_matches_jax():
    w_apx = _decayed(0, 24, 32) + 0.01 * _randn(6, (24, 32))
    got, want = _both(theory.relative_weighted_error,
                      jtheory.relative_weighted_error, W, w_apx, X_FULL)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_thm1_bound_holds_on_rank_deficient_x():
    """Theorem 1 with X of 12 tokens < n = 32 (``benchmarks/run.py:259-271``,
    ``tests/test_coala.py:87``): ||W₀ − W_μ||_F ≤ thm1_bound at every μ,
    with the same distances as the JAX package's."""
    w, x = _randn(13, (48, 32)), _randn(14, (32, 12))
    w0 = coala.coala_project(torch.from_numpy(w), torch.from_numpy(x), rank=6)
    jw0 = jcoala.coala_project(jnp.asarray(w), jnp.asarray(x), rank=6)
    for mu in (1e-2, 1e-3, 1e-4):
        w_mu = coala.coala_project(torch.from_numpy(w), torch.from_numpy(x),
                                   rank=6, mu=mu)
        diff = float(torch.linalg.norm(w0 - w_mu))
        bound = float(theory.thm1_bound(torch.from_numpy(w), torch.from_numpy(x),
                                        6, mu))
        assert diff <= bound, (mu, diff, bound)
        jdiff = float(jnp.linalg.norm(jw0 - jcoala.coala_project(
            jnp.asarray(w), jnp.asarray(x), rank=6, mu=mu)))
        # both distances carry the fp32 rounding of two rank-6 projections
        # of a 48 x 32 W (||W||_F ~ 39): ~1e-5 absolute
        np.testing.assert_allclose(diff, jdiff, rtol=1e-2, atol=5e-5)
        np.testing.assert_allclose(
            bound, float(jtheory.thm1_bound(jnp.asarray(w), jnp.asarray(x), 6, mu)),
            rtol=1e-4)


# ---------------------------------------------------------------------------
# coala.py: coala_project, the α-family, balanced_split, eym_truncate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(mu=0.05), dict(lam=4.0)],
                         ids=["mu0", "mu", "lam"])
@pytest.mark.parametrize("x", [X_FULL, X_THIN], ids=["full", "thin"])
def test_coala_project_matches_jax(x, kw):
    got = coala.coala_project(torch.from_numpy(W), torch.from_numpy(x), rank=5,
                              **kw)
    want = jcoala.coala_project(jnp.asarray(W), jnp.asarray(x), rank=5, **kw)
    _close(got.numpy(), want)


@pytest.mark.parametrize("is_r", [False, True])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0, 2.0])
@pytest.mark.parametrize("x", [X_FULL, X_THIN], ids=["full", "thin"])
def test_alpha_weight_factor_matches_jax(x, alpha, is_r):
    src = (jtsqr.square_r(jtsqr.qr_r(jnp.asarray(x.T))) if is_r else x)
    src = np.array(src)
    got = coala.alpha_weight_factor(torch.from_numpy(src), alpha, is_r=is_r)
    want = jcoala.alpha_weight_factor(jnp.asarray(src), alpha, is_r=is_r)
    _close(got.numpy(), want)
    if alpha == 1.0:
        # S_1 S_1ᵀ = XXᵀ (on the rows the data spans)
        _close((got @ got.T).numpy(), x @ x.T, tol=1e-3)


@pytest.mark.parametrize("mu", [0.0, 0.05])
@pytest.mark.parametrize("alpha", [0.0, 1.0, 2.0])
@pytest.mark.parametrize("x", [X_FULL, X_THIN], ids=["full", "thin"])
def test_coala_alpha_factors_match_jax(x, alpha, mu):
    """W' = A·B with A = U_r orthonormal, for both inputs (X and R)."""
    r = np.asarray(jtsqr.square_r(jtsqr.qr_r(jnp.asarray(x.T))))
    for kw_t, kw_j in ((dict(x=torch.from_numpy(x)), dict(x=jnp.asarray(x))),
                       (dict(r_factor=torch.from_numpy(r)),
                        dict(r_factor=jnp.asarray(r)))):
        a, b = coala.coala_alpha_factors(torch.from_numpy(W), rank=5, alpha=alpha,
                                         mu=mu, **kw_t)
        ja, jb = jcoala.coala_alpha_factors(jnp.asarray(W), rank=5, alpha=alpha,
                                            mu=mu, **kw_j)
        _close((a @ b).numpy(), ja @ jb)
        np.testing.assert_allclose((a.T @ a).numpy(), np.eye(5), atol=1e-5)


def test_coala_alpha_one_is_algorithm_one():
    a, b = coala.coala_alpha_factors(torch.from_numpy(W), torch.from_numpy(X_FULL),
                                     rank=5, alpha=1.0)
    res = coala.coala_factors(torch.from_numpy(W), torch.from_numpy(X_FULL), rank=5)
    torch.testing.assert_close(a @ b, res.w_approx, rtol=0, atol=1e-6)


def test_coala_alpha_factors_refuse_bad_input():
    w, x = torch.from_numpy(W), torch.from_numpy(X_FULL)
    with pytest.raises(ValueError, match="non-negative"):
        coala.coala_alpha_factors(w, x, rank=5, mu=-0.1)
    with pytest.raises(ValueError, match="non-negative"):
        jcoala.coala_alpha_factors(jnp.asarray(W), jnp.asarray(X_FULL), rank=5,
                                   mu=-0.1)
    with pytest.raises(ValueError, match="exactly one"):
        coala.coala_alpha_factors(w, rank=5)


def test_balanced_split_matches_jax():
    a, b = _randn(7, (24, 5)) * 3.0, _randn(8, (5, 32)) * 0.1
    (ta, tb), (ja, jb) = _both(coala.balanced_split, jcoala.balanced_split, a, b)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-7)
    # the product is kept and both factors end at the same per-index norm
    _close((ta @ tb).numpy(), a @ b, tol=1e-5)
    np.testing.assert_allclose(torch.linalg.norm(ta, dim=0).numpy(),
                               torch.linalg.norm(tb, dim=1).numpy(), rtol=1e-5)


@pytest.mark.parametrize("rank", [1, 5, 20])
def test_eym_truncate_and_weighted_error_match_jax(rank):
    got, want = _both(coala.eym_truncate, jcoala.eym_truncate, W, rank=rank)
    _close(got.numpy(), want)
    e_t, e_j = _both(coala.weighted_error, jcoala.weighted_error, W,
                     np.asarray(want), X_FULL)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-4)
    # Theorem 3 on the unweighted problem: the tail of the spectrum
    tail = np.sqrt(np.sum(np.linalg.svd(W, compute_uv=False)[rank:] ** 2))
    np.testing.assert_allclose(float(torch.linalg.norm(torch.from_numpy(W) - got)),
                               tail, rtol=1e-3, atol=1e-6)


# ---------------------------------------------------------------------------
# tsqr.py: the binary tree, the Gram path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_chunks", [1, 2, 3, 5])
@pytest.mark.parametrize("tokens", [80, 20], ids=["full", "thin"])
def test_tsqr_tree_matches_jax(n_chunks, tokens):
    """RᵀR = XXᵀ, as the JAX tree computes it; with tokens >= n R itself is
    unique (non-negative diagonal) and is compared too."""
    xt = _randn(9, (tokens, 24))
    chunks = np.array_split(xt, n_chunks)
    got = tsqr.tsqr_tree([torch.from_numpy(c) for c in chunks])
    want = np.asarray(jtsqr.tsqr_tree([jnp.asarray(c) for c in chunks]))
    assert tuple(got.shape) == want.shape
    _close((got.T @ got).numpy(), want.T @ want)
    _close((got.T @ got).numpy(), xt.T @ xt)
    if tokens >= 24:
        _close(got.numpy(), want)
        seq = tsqr.tsqr_sequential([torch.from_numpy(c) for c in chunks])
        _close(got.numpy(), seq.numpy())


def test_gram_chunked_matches_jax():
    chunks = [_randn(10 + i, (k, 16)) for i, k in enumerate((7, 30, 1))]
    got = tsqr.gram_chunked([torch.from_numpy(c) for c in chunks])
    want = jtsqr.gram_chunked([jnp.asarray(c) for c in chunks])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    with pytest.raises(ValueError, match="no chunks"):
        tsqr.gram_chunked([])


def test_core_exports_match_jax():
    """``repro_torch.core`` exports the JAX package's names but
    ``distributed_tsqr_r`` (waits with ``dist``)."""
    import repro.core as jcore
    import repro_torch.core as tcore
    want = {n for n in vars(jcore) if not n.startswith("_")} - {"distributed_tsqr_r"}
    got = {n for n in vars(tcore) if not n.startswith("_")}
    missing = {n for n in want - got
               if not isinstance(getattr(jcore, n), type(jcore))}
    assert not missing, missing
