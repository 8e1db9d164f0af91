"""deepseek_v2_lite_16b's MLA attention in the port against the JAX package,
on the CPU (SMOKE: kv_lora_rank 32, nope 32 + rope 16 = head dim 48, v 32,
over deepseek's MoE).

Parameters come from the JAX model's init as numpy, through ``convert``.
The round trip of the tree is bit-exact, dense and COALA-factored
(``w_dkv`` as ``{"b_t", "a_t"}``; ``w_uk``/``w_uv`` bare leaves). The
expanded path (loss, full-forward logits) matches the JAX model at 1e-5,
also with the flash kernel's plain version at head dim 48; the absorbed
path over latent pages (``prefill_chunk`` + ``decode_step`` with block
tables, ragged rows, a padding row, suffixes at starts > 0) matches the JAX
model over a contiguous per-row cache, the JAX engine's gather path, at
1e-5. The plain flash at hd 48 matches the Pallas kernel in interpret mode.
Calibration records the JAX paths with RᵀR within 1e-4, and COALA gives the
JAX ranks and reports within 1e-4 on the same set of paths. The pool's
zeroing and copy-on-write cover the latent stores. The engine is held in
``tests/test_torch_mla_serve.py``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CompressConfig as JCompressConfig
from repro.configs import get_smoke_config as j_smoke
from repro.core.calibrate import calibrate_model as j_calibrate
from repro.core.compress import compress_model as j_compress
from repro.kernels import ops as jops
from repro.models import build_model as j_build
from repro.models.common import CPU_CTX as J_CPU_CTX
from repro_torch.config import CompressConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.calibrate import calibrate_model
from repro_torch.core.compress import compress_model
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models.attention import MLA
from repro_torch.models.common import ParallelCtx
from repro_torch.serve.paged_cache import BlockPool

torch.set_num_threads(1)

NAME = "deepseek_v2_lite_16b"
CFG = get_smoke_config(NAME)
HD = CFG.qk_nope_dim + CFG.qk_rope_dim          # 48
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_lm():
    jmodel = j_build(j_smoke(NAME))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, tree, params_from_numpy(tree, CFG, device="cpu")


def _tokens(shape, seed=1):
    return np.random.RandomState(seed).randint(0, CFG.vocab_size,
                                               shape).astype(np.int32)


def _assert_tree_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# parameters and the expanded path
# ---------------------------------------------------------------------------

def test_round_trip_bit_exact_dense(jax_lm):
    _, _, tree, tmodel = jax_lm
    _assert_tree_equal(params_to_numpy(tmodel), tree)
    mixers = [blk.mixer for blk in tmodel.layers()]
    assert len(mixers) == CFG.n_layers and all(isinstance(m, MLA) for m in mixers)
    keys = set(tmodel.state_dict())
    assert "prefix.0.mixer.w_uk" in keys and "blocks.0.sub0.mixer.w_uv" in keys
    assert tmodel.prefix[0].mixer.w_uk.shape == (CFG.kv_lora_rank,
                                                 CFG.n_heads * CFG.qk_nope_dim)


def test_full_forward_logits_and_loss(jax_lm):
    jmodel, jparams, _, tmodel = jax_lm
    tok = _tokens((2, 48))
    x = jmodel._embed(jparams, jnp.asarray(tok)).astype(jnp.float32)
    h, _, _ = jmodel._backbone(jparams, x, ctx=J_CPU_CTX)
    want = np.asarray(jmodel._logits(jparams, h))
    np.testing.assert_allclose(tmodel.logits(torch.from_numpy(tok)).numpy(),
                               want, **TOL)
    jl, jm = jmodel.loss(jparams, {"tokens": jnp.asarray(tok)},
                         compute_dtype=jnp.float32)
    with torch.no_grad():
        tl, tm = tmodel.loss(torch.from_numpy(tok), compute_dtype=torch.float32)
        # the calibration forward's path: sdpa through the flash kernel's
        # plain version at head dim nope + rope, V zero-padded to it
        fl, _ = tmodel.loss(torch.from_numpy(tok), compute_dtype=torch.float32,
                            ctx=ParallelCtx(use_pallas=True))
    for got, ref in ((tl, jl), (tm["ce"], jm["ce"]), (tm["aux"], jm["aux"]),
                     (fl, jl)):
        np.testing.assert_allclose(float(got), float(ref), **TOL)
    assert float(tm["aux"]) > 0


def test_flash_at_head_dim_48_matches_pallas_interpret():
    """MLA SMOKE's calibration attention shape: the port's flash (its plain
    version on the CPU, and the plain version of the kernel's tiling) against
    the Pallas kernel in interpret mode, fp32 at 1e-5."""
    rng = np.random.RandomState(4)
    b, t, h = 2, 64, CFG.n_heads
    q, k, v = (rng.standard_normal((b, t, h, HD)).astype(np.float32)
               for _ in range(3))
    v[..., CFG.v_head_dim:] = 0.0              # MLA's zero-padded V
    scale = HD ** -0.5
    want = np.asarray(jops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                           scale=scale, block_q=32, block_k=32))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for fn in (tops.flash_attention, tfa.flash_attention_tiled_ref):
        got = fn(tq, tk, tv, scale=scale)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert not got[..., CFG.v_head_dim:].any()
    assert tfa.plan(8, 256, 16, 16, 192, torch.float32).rows == tfa.THIN_ROWS
    assert tfa.plan(b, t, h, h, HD, torch.bfloat16).rows == tfa.THIN_ROWS


# ---------------------------------------------------------------------------
# the absorbed path over latent pages
# ---------------------------------------------------------------------------

def test_latent_cache_layout(jax_lm):
    cache = jax_lm[3].init_cache(10, 4)
    assert len(cache) == CFG.n_layers
    for layer in cache:
        assert {k: tuple(v.shape) for k, v in layer.items()} == {
            "c": (10, 4, CFG.kv_lora_rank), "k_rope": (10, 4, CFG.qk_rope_dim)}


def test_paged_prefill_and_decode_match_jax(jax_lm):
    """Ragged rows, a padding row, three decode steps, then suffixes of two
    rows at their nonzero starts. The JAX side is the model over one
    contiguous cache per row (the gather path's envelope)."""
    jmodel, jparams, _, tmodel = jax_lm
    bs, num_blocks, l_pad, nbt = 8, 40, 48, 10
    lens = [45, 12, 37]
    tok = np.zeros((4, l_pad), np.int32)
    for i, n in enumerate(lens):
        tok[i, :n] = _tokens((n,), seed=10 + i)
    tables = np.zeros((4, nbt), np.int32)          # row 3 all-trash
    nxt = 1
    for i, n in enumerate(lens):
        for j in range(-(-(n + 16) // bs)):
            tables[i, j] = nxt
            nxt += 1
    jcache = jmodel.init_cache(4, nbt * bs, dtype=jnp.float32)
    tcache = tmodel.init_cache(num_blocks, bs)

    def prefill(tok, starts, ln):
        nonlocal jcache
        jl, jcache = jmodel.prefill_chunk(
            jparams, jnp.asarray(tok), jcache, jnp.asarray(starts),
            jnp.asarray(ln), compute_dtype=jnp.float32)
        tl = tmodel.prefill_chunk(torch.from_numpy(tok), tcache,
                                  torch.from_numpy(starts),
                                  torch.from_numpy(ln), torch.from_numpy(tables))
        return np.asarray(jl), tl.numpy()

    def decode(tok, pos):
        nonlocal jcache
        jl, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache,
                                        jnp.asarray(pos), compute_dtype=jnp.float32)
        tl = tmodel.decode_step(torch.from_numpy(tok), tcache,
                                torch.from_numpy(pos), torch.from_numpy(tables))
        return np.asarray(jl), tl.numpy()

    jl, tl = prefill(tok, np.zeros(4, np.int32), np.array(lens + [1], np.int32))
    np.testing.assert_allclose(tl[:3], jl[:3], **TOL)
    pos = np.array(lens + [0], np.int32)
    for _ in range(3):
        step_tok = np.argmax(jl, -1).astype(np.int32)[:, None]
        step_tok[3] = 0
        jl, tl = decode(step_tok, pos)
        np.testing.assert_allclose(tl[:3], jl[:3], **TOL)
        pos[:3] += 1
    tok2 = np.zeros((4, 8), np.int32)
    tok2[1, :5] = _tokens((5,), seed=20)
    tok2[2, :7] = _tokens((7,), seed=21)
    jl, tl = prefill(tok2, np.array([0, pos[1], pos[2], 0], np.int32),
                     np.array([1, 5, 7, 1], np.int32))
    np.testing.assert_allclose(tl[1:3], jl[1:3], **TOL)
    # the latents each row wrote are the JAX cache's, page by page
    for layer, jlayer in ((tcache[0], jcache["prefix"][0]["mixer"]),):
        for key in ("c", "k_rope"):
            env = layer[key][torch.from_numpy(tables[:3]).long()].reshape(
                3, nbt * bs, -1).numpy()
            for i, n in enumerate((pos[0], pos[1] + 5, pos[2] + 7)):
                np.testing.assert_allclose(env[i, :n], np.asarray(jlayer[key])[i, :n],
                                           **TOL)


def test_pool_zeroes_and_copies_latent_pages(jax_lm):
    """The pool's page zeroing and copy-on-write treat the latent stores as
    any other: a forked request's first write copies its shared tail page in
    ``c`` and ``k_rope`` of every layer, and a reclaimed page reads zeros."""
    pool = BlockPool(jax_lm[3], num_blocks=8, block_size=4, max_requests=2)
    assert all(set(layer) == {"c", "k_rope"} for layer in pool.pages)
    pool.alloc(0, 6)
    gen = torch.Generator().manual_seed(0)
    for layer in pool.pages:
        for store in layer.values():
            store.normal_(generator=gen)
    src = pool.table(0)[1]
    pool.fork(0, 1)
    pool.extend(1, 7)                       # position 6 sits in shared block 1
    dst = pool.table(1)[1]
    assert dst != src and pool.stats["cow_copies"] == 1
    for layer in pool.pages:
        for store in layer.values():
            assert torch.equal(store[dst], store[src])
    pool.free(1)
    pool.free(0)
    pool.alloc(2, 16)                       # claims every usable page again
    for layer in pool.pages:
        for store in layer.values():
            assert not store[pool.table(2)].any()


# ---------------------------------------------------------------------------
# calibration and compression
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def calibrated(jax_lm):
    jmodel, jparams, _, tmodel = jax_lm
    toks = [_tokens((4, 24), seed=s) for s in (0, 1)]
    jcal = j_calibrate(jmodel, jparams, [{"tokens": jnp.asarray(t)} for t in toks])
    tcal = calibrate_model(tmodel, [torch.from_numpy(t) for t in toks])
    return jcal, tcal


def test_calibration_r_factors_match_jax(calibrated):
    jcal, tcal = calibrated
    jr, tr = jcal.r_factors(), tcal.r_factors()
    assert set(jr) == set(tr)
    for lin in ("wq", "w_dkv", "w_krope", "wo"):
        assert f"prefix/0/mixer/{lin}" in tr and f"blocks/0/sub0/mixer/{lin}" in tr
    assert not any("w_uk" in p or "w_uv" in p for p in tr)
    assert jcal.tokens_seen() == tcal.tokens_seen()
    for p in jr:
        a, b = np.asarray(jr[p]), tr[p].numpy()
        np.testing.assert_allclose(b.T @ b, a.T @ a, rtol=1e-4, atol=1e-4,
                                   err_msg=p)


def test_coala_matches_jax(jax_lm, calibrated):
    """The same compressed paths (wq, w_dkv, wo, the dense FFN and every
    expert; not w_krope, w_uk or w_uv), the JAX ranks and reports within
    1e-4, the factored tree's round trip bit-exact, and the compressed
    model's logits within 1e-4 of the JAX compressed model's."""
    jmodel, jparams, _, tmodel = jax_lm
    jcal, tcal = calibrated
    kw = dict(method="coala", ratio=0.6, lam=4.0, mu=-1.0)
    jcp, jrep = j_compress(jmodel, jparams, jcal, JCompressConfig(**kw))
    tcp, trep = compress_model(tmodel, tcal, CompressConfig(**kw))
    want = {r.path: r for r in jrep}
    got = {r.path: r for r in trep}
    assert set(got) == set(want)
    roles = {p.split("/")[-1] for p in got if "/mixer/" in p}
    assert roles == {"wq", "w_dkv", "wo"}
    for p, r in got.items():
        assert r.rank == want[p].rank and r.mu == pytest.approx(want[p].mu, rel=1e-5), p
        for f in ("rel_err_weighted", "rel_err_bound"):
            a, b = getattr(r, f), getattr(want[p], f)
            assert (math.isnan(a) and math.isnan(b)) or math.isclose(
                a, b, abs_tol=1e-4), (p, f, a, b)
    tree = jax.tree.map(np.asarray, jcp)
    mixer = tree["prefix"][0]["mixer"]
    assert set(mixer["w_dkv"]) == {"b_t", "a_t"} and set(mixer["w_krope"]) == {"w"}
    _assert_tree_equal(params_to_numpy(params_from_numpy(tree, CFG, device="cpu")),
                       tree)
    assert (jax.tree.structure(params_to_numpy(tcp))
            == jax.tree.structure(tree))
    tok = _tokens((2, 16), seed=5)
    x = jmodel._embed(jcp, jnp.asarray(tok)).astype(jnp.float32)
    h, _, _ = jmodel._backbone(jcp, x, ctx=J_CPU_CTX)
    np.testing.assert_allclose(tcp.logits(torch.from_numpy(tok)).numpy(),
                               np.asarray(jmodel._logits(jcp, h)),
                               rtol=1e-4, atol=1e-4)
