"""xLSTM (family ssm: mLSTM and sLSTM blocks) of the port against the JAX
package, on the CPU at SMOKE size: the config copy and layer pattern, the
parameter tree through ``convert`` (dense and factored, bit-exact), each
block from identical inputs, the LM's logits, loss and gradients, the
contiguous-cache prefill and decode with their state leaves, the
chunkwise-parallel mLSTM against the sequential one in both packages, the
pool's slot stores against the contiguous cache, calibration and the coala
and svd_llm compressions, the pipeline and the compression launcher.

Inputs come from numpy with a seed; weights are the JAX init through
``convert.params_from_numpy``. Tolerances: one block from identical inputs
1e-5 (fp32, sums in another order); decode logits 1e-5; state leaves 5e-5
of each leaf's largest entry (the last layer's state after 8 decode steps
carries the same growth as the logits below: 1.15e-5 measured); the loss
1e-5 relative. The whole LM's
logits are held at 1e-4 and its gradients at 5e-4 of each leaf's largest
entry: the mLSTM's normalizer max(|n·q|, exp(-m)) divides by small numbers
at some positions, so the blocks' fp32 rounding (1e-6 each, measured from
identical inputs) grows by 2-5x a layer through the eight layers (logits
6e-5 at worst over three inits and four lengths, gradients 1.3e-4 of the
largest entry; the decode steps' 1e-5 holds). The chunkwise form is held to the sequential
one at 1e-4 (a different summation of the same recurrence); RᵀR at 1e-4 of
its largest entry, the compression reports' errors at 1e-4 and the factors
as A·B at 1e-4 of their largest entry (SVDs of the same matrices in two
libraries).
"""
import dataclasses

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
from repro.models.common import CPU_CTX as J_CPU_CTX
from repro.models.common import ParallelCtx as JParallelCtx
from repro.models.transformer import block_apply as j_block_apply
from repro.models.transformer import period_specs as j_period_specs
from repro_torch.config import CompressConfig
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.calibrate import calibrate_model
from repro_torch.core.compress import compress_model
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch import compress as launch_compress
from repro_torch.models.common import ParallelCtx
from repro_torch.models.transformer import period_specs

torch.set_num_threads(1)

NAME = "xlstm_1_3b"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def xl():
    """(JAX model, JAX params, numpy tree, port model), xLSTM SMOKE."""
    jmodel = j_build(j_smoke(NAME))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, tree, params_from_numpy(
        tree, get_smoke_config(NAME), device="cpu")


def _tokens(b, t, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, t)).astype(np.int32)


def _jax_hidden(jmodel, jparams, tok, ctx=J_CPU_CTX):
    x = jmodel._embed(jparams, jnp.asarray(tok)).astype(jnp.float32)
    return jmodel._backbone(jparams, x, ctx=ctx)[0]


def _assert_state_close(got: torch.Tensor, want: np.ndarray, what: str):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5 * scale,
                               err_msg=what)


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------

def test_config_and_layer_pattern_are_the_jax_ones():
    assert NAME in ARCH_IDS
    for ours, theirs in ((get_config(NAME), j_config(NAME)),
                         (get_smoke_config(NAME), j_smoke(NAME))):
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if f.name in ("moe", "mamba", "xlstm"):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
        assert [ours.layer_kind(i) for i in range(ours.n_layers)] == [
            theirs.layer_kind(i) for i in range(theirs.n_layers)]
        pre, per, n_rep = period_specs(ours)
        jpre, jper, jn = j_period_specs(theirs)
        assert (len(pre), n_rep) == (len(jpre), jn)
        assert [s.kind for s in per] == [s.kind for s in jper]
    assert [s.kind for s in period_specs(get_config(NAME))[1]] == \
        ["slstm"] + ["mlstm"] * 7
    # the hybrid family's layer_kind is ported too: Mamba and attention
    for get, jget in ((get_config, j_config), (get_smoke_config, j_smoke)):
        hyb, jhyb = get("jamba_v0_1_52b"), jget("jamba_v0_1_52b")
        assert [hyb.layer_kind(i) for i in range(hyb.n_layers)] == [
            jhyb.layer_kind(i) for i in range(jhyb.n_layers)]
        assert {hyb.layer_kind(i) for i in range(hyb.n_layers)} == {"attn",
                                                                   "mamba"}


@pytest.mark.parametrize("factored", [False, True])
def test_convert_round_trip_bit_exact(xl, factored):
    """Every leaf of the JAX tree — mLSTM's ``w_i``/``w_f``/``f_bias``/
    ``o_norm_scale``, sLSTM's ``w_{i,f,z,o}`` linears and bare ``r_*``, the
    FFN pair — survives the round trip bit for bit, dense and with the
    compressible linears factored ({"b_t", "a_t"} of rank 7 from numpy)."""
    _, _, tree, tmodel = xl
    if factored:
        rng = np.random.RandomState(5)

        def factor(path, node):
            if isinstance(node, dict) and "w" in node and path[-1] in (
                    "up", "wq", "wk", "wv", "down", "ff_up", "ff_down"):
                n_rep, d_in, d_out = node["w"].shape
                return {"b_t": rng.standard_normal((n_rep, d_in, 7)).astype(
                            np.float32),
                        "a_t": rng.standard_normal((n_rep, 7, d_out)).astype(
                            np.float32)}
            if isinstance(node, dict):
                return {k: factor(path + (k,), v) for k, v in node.items()}
            return node
        tree = factor((), tree)
        tmodel = params_from_numpy(tree, get_smoke_config(NAME), device="cpu")
        assert tmodel.blocks[1]["sub1"].mixer.wq.is_factored
    back = params_to_numpy(tmodel)
    la, ta = jax.tree.flatten(back)
    lb, tb = jax.tree.flatten(tree)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    mixer = back["blocks"]["sub1"]["mixer"]
    assert set(mixer) == {"up", "wq", "wk", "wv", "w_i", "w_f", "f_bias",
                          "o_norm_scale", "down"}
    assert ("b_t" in mixer["wq"]) == factored
    assert ("w" in mixer["wq"]) == (not factored)
    slstm = back["blocks"]["sub0"]["mixer"]
    assert slstm["r_i"].shape == (2, 2, 32, 32)       # (n_rep, H, hd, hd)
    assert "w" in slstm["w_i"]                         # never a target
    assert set(back["blocks"]["sub0"]) == {"norm1", "mixer"}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def test_each_block_matches_jax_from_identical_inputs(xl):
    jmodel, jparams, _, tmodel = xl
    cfg = jmodel.cfg
    _, period, n_rep = j_period_specs(cfg)
    x = np.asarray(jmodel._embed(jparams, jnp.asarray(_tokens(2, 24)))
                   ).astype(np.float32)
    layers = list(tmodel.layers())
    i = 0
    for r in range(n_rep):
        blk = jax.tree.map(lambda a, r=r: a[r], jparams["blocks"])
        for j, spec in enumerate(period):
            want, _, _ = j_block_apply(cfg, spec, blk[f"sub{j}"],
                                       jnp.asarray(x), ctx=J_CPU_CTX,
                                       cos_sin=None)
            with torch.no_grad():
                got, aux = layers[i](torch.tensor(x), None)
            assert aux is None and layers[i].kind == spec.kind
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            x = np.asarray(want)
            i += 1


def test_logits_loss_and_grads_match_jax(xl):
    jmodel, jparams, _, tmodel = xl
    tok = _tokens(2, 24)
    want = np.asarray(jmodel._logits(jparams,
                                     _jax_hidden(jmodel, jparams, tok)))
    got = tmodel.logits(torch.from_numpy(tok)).numpy()
    assert got.shape == want.shape == (2, 24, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    def jloss(p):
        return jmodel.loss(p, {"tokens": jnp.asarray(tok)},
                           compute_dtype=jnp.float32)[0]
    jl, jg = jax.value_and_grad(jloss)(jparams)
    tmodel.zero_grad()
    tl, parts = tmodel.loss(torch.from_numpy(tok),
                            compute_dtype=torch.float32)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(parts["aux"]) == 0.0
    jflat = {jax.tree_util.keystr(k): np.asarray(v)
             for k, v in jax.tree_util.tree_leaves_with_path(jg)}
    named = dict(tmodel.named_parameters())
    for key, g in jflat.items():
        parts_ = [s.strip("[]'") for s in key.split("][")]
        if parts_[0] == "blocks":
            rest = ".".join(parts_[1:])
            for r in range(g.shape[0]):
                p = named[f"blocks.{r}.{rest}"]
                scale = max(float(np.abs(g[r]).max()), 1e-6)
                np.testing.assert_allclose(p.grad.numpy(), g[r], rtol=0,
                                           atol=5e-4 * scale, err_msg=key)
        else:
            p = named[".".join(parts_)]
            scale = max(float(np.abs(g).max()), 1e-6)
            np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                       atol=5e-4 * scale, err_msg=key)
    tmodel.zero_grad(set_to_none=True)


def test_prefill_and_decode_state_match_jax(xl):
    """``prefill`` then 8 greedy ``decode_step``s over a contiguous cache:
    every step's logits and, at the end, every layer's state leaves."""
    jmodel, jparams, _, tmodel = xl
    tok = _tokens(2, 12, seed=3)
    jprefill = jax.jit(lambda p, t, c: jmodel.prefill(
        p, t, c, compute_dtype=jnp.float32))
    jdecode = jax.jit(lambda p, t, c, pos: jmodel.decode_step(
        p, t, c, pos, compute_dtype=jnp.float32))
    jc = jmodel.init_cache(2, 32, dtype=jnp.float32)
    jl, jc = jprefill(jparams, jnp.asarray(tok), jc)
    tc = tmodel.init_contiguous_cache(2, 32)
    assert all(v.dtype == torch.float32 for layer in tc for v in layer.values())
    assert float(tc[1]["m"][0, 0]) == float(np.float32(-1e30))
    tl = tmodel.prefill(torch.from_numpy(tok), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, -1], **TOL)
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)
    for i in range(8):
        jl, jc = jdecode(jparams, jnp.asarray(nxt[:, None]), jc,
                         jnp.int32(12 + i))
        tl = tmodel.decode_step(torch.from_numpy(nxt[:, None]), tc, 12 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    _, period, n_rep = j_period_specs(jmodel.cfg)
    i = 0
    for r in range(n_rep):
        for j in range(len(period)):
            jleaf = jc["blocks"][f"sub{j}"]["mixer"]
            assert set(jleaf) == set(tc[i])
            for k, v in jleaf.items():
                _assert_state_close(tc[i][k], np.asarray(v[r]), f"{i}/{k}")
            i += 1


def test_chunkwise_mlstm_matches_sequential_in_both_packages(xl):
    """T 128 = two SMOKE chunks of 64: hidden states and the final state of
    a prefill, chunkwise against sequential, in each package and across."""
    jmodel, jparams, _, tmodel = xl
    tok = _tokens(2, 128, seed=4)
    jseq = np.asarray(_jax_hidden(jmodel, jparams, tok))
    jchk = np.asarray(_jax_hidden(jmodel, jparams, tok,
                                  JParallelCtx(mlstm_chunkwise=True)))
    x = tmodel._embed(torch.from_numpy(tok))
    with torch.no_grad():
        tseq = tmodel._backbone(x)[0].numpy()
        tchk = tmodel._backbone(x, ctx=ParallelCtx(mlstm_chunkwise=True)
                                )[0].numpy()
    for a, b in ((jchk, jseq), (tchk, tseq), (tchk, jchk)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    caches = []
    for ctx in (ParallelCtx(), ParallelCtx(mlstm_chunkwise=True)):
        c = tmodel.init_contiguous_cache(2, 128)
        tmodel.prefill(torch.from_numpy(tok), c, ctx=ctx)
        caches.append(c)
    for seq, chk in zip(*caches):
        for k in seq:
            scale = max(float(seq[k].abs().max()), 1.0)
            assert float((seq[k] - chk[k]).abs().max()) <= 1e-4 * scale, k


def test_slot_stores_match_the_contiguous_cache(xl):
    """Rows decoded through the pool's slot stores (``init_cache(slots=)``,
    gathered and scattered in place into the same tensors, a padding row on
    another slot) give the contiguous cache's logits and state (1e-6: the
    batch has one row more), and leave the other slot untouched."""
    _, _, _, tmodel = xl
    tok = torch.from_numpy(_tokens(2, 10, seed=6))
    cont = tmodel.init_contiguous_cache(2, 16)
    logits = tmodel.prefill(tok, cont)
    stores = tmodel.init_cache(4, 4, slots=4)
    assert stores[0]["c"].shape == (4, 64) and stores[1]["c"].shape == (
        4, 2, 64, 64)
    slots = torch.tensor([2, 0, 3], dtype=torch.int32)    # row 2: padding
    for layer_s, layer_c in zip(stores, cont):
        for k in layer_s:
            layer_s[k][slots[:2].long()] = layer_c[k]
    ptrs = [v.data_ptr() for layer in stores for v in layer.values()]
    untouched = [{k: v[1].clone() for k, v in layer.items()} for layer in stores]
    nxt = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for i in range(3):
        want = tmodel.decode_step(nxt, cont, 10 + i)
        got = tmodel.decode_step(torch.cat([nxt, nxt[:1]]), stores,
                                 torch.full((3,), 10 + i), torch.zeros(
                                     (3, 1), dtype=torch.int32), slots=slots)
        torch.testing.assert_close(got[:2], want, rtol=0, atol=1e-6)
        nxt = torch.argmax(want, -1)[:, None].to(torch.int32)
    assert ptrs == [v.data_ptr() for layer in stores for v in layer.values()]
    for layer_s, layer_c, before in zip(stores, cont, untouched):
        for k in layer_s:
            torch.testing.assert_close(layer_s[k][slots[:2].long()],
                                       layer_c[k], rtol=0, atol=1e-6)
            assert torch.equal(layer_s[k][1], before[k])    # untouched slot


# ---------------------------------------------------------------------------
# calibration, compression, pipeline, launcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def calibrated(xl):
    jmodel, jparams, _, tmodel = xl
    batches = [_tokens(8, 32, seed=1)]
    jcal = j_calibrate(jmodel, jparams,
                       [{"tokens": jnp.asarray(b)} for b in batches])
    tcal = calibrate_model(tmodel, [torch.from_numpy(b) for b in batches])
    return jcal, tcal


def test_calibration_r_factors_match_jax(calibrated):
    jcal, tcal = calibrated
    jr, tr = jcal.r_factors(), tcal.r_factors()
    # every linear holding "w": mLSTM's five, sLSTM's four gates and its FFN
    assert sorted(jr) == sorted(tr) and len(tr) == 6 * 5 + 2 * 6
    for p in tr:
        want = np.asarray(jr[p]).T @ np.asarray(jr[p])
        got = (tr[p].T @ tr[p]).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=p)


@pytest.mark.parametrize("method", ["coala", "svd_llm"])
def test_compression_matches_jax(xl, calibrated, method):
    """The targets are the reference's ``compressible`` ones: up, wq, wk,
    wv, down, ff_up, ff_down; sLSTM's gates, mLSTM's gate vectors and the
    ``r_*`` stay dense. Reports at 1e-4 and the factors as A·B."""
    jmodel, jparams, _, tmodel = xl
    jcal, tcal = calibrated
    jc, jrep = j_compress(jmodel, jparams, jcal,
                          JCompressConfig(method=method, ratio=0.6))
    tc, trep = compress_model(tmodel, tcal,
                              CompressConfig(method=method, ratio=0.6))
    jd, td = {r.path: r for r in jrep}, {r.path: r for r in trep}
    assert sorted(jd) == sorted(td) and len(td) == 6 * 5 + 2 * 2
    assert {p.rsplit("/", 1)[1] for p in td} == {
        "up", "wq", "wk", "wv", "down", "ff_up", "ff_down"}
    for p, r in td.items():
        assert (r.rank, r.params_before, r.params_after) == (
            jd[p].rank, jd[p].params_before, jd[p].params_after)
        # svd_llm's Cholesky of a singular Gram gives NaN in both packages
        np.testing.assert_allclose(r.rel_err_weighted, jd[p].rel_err_weighted,
                                   rtol=0, atol=1e-4, equal_nan=True,
                                   err_msg=p)
        assert abs(r.mu - jd[p].mu) <= 1e-4 * max(abs(jd[p].mu), 1.0), p
    jtree, ttree = jax.tree.map(np.asarray, jc), params_to_numpy(tc)
    for p in td:
        _, rep, *rest = p.split("/")
        jn, tn = jtree["blocks"], ttree["blocks"]
        for k in rest:
            jn, tn = jn[k], tn[k]
        r = int(rep)
        want = jn["b_t"][r] @ jn["a_t"][r]
        got = tn["b_t"][r] @ tn["a_t"][r]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.nanmax(np.abs(want)),
                                   equal_nan=True, err_msg=p)
    slstm = tc.blocks[0]["sub0"].mixer
    assert slstm.w_i.has_dense and not slstm.w_i.is_factored
    assert slstm.ff_down.is_factored


def test_pipeline_admits_ssm():
    pipe = TokenPipeline(DataConfig(vocab_size=256, seq_len=16,
                                    global_batch=2), get_smoke_config(NAME),
                         device="cpu")
    batch = pipe.get_batch(0)
    assert set(batch) == {"tokens"} and batch["tokens"].shape == (2, 16)


def test_compress_launcher_on_xlstm(capsys):
    """The compression launcher end to end: pretraining through the
    recurrences under autograd (checkpointed per chunk), evaluation,
    calibration and COALA."""
    out = launch_compress.main(["--arch", NAME, "--smoke", "--device", "cpu",
                                "--pretrain-steps", "2", "--calib-batches",
                                "1"])
    s = out["summary"]
    assert s["layers"] == 6 * 5 + 2 * 2
    assert np.isfinite(s["base_ce"]) and np.isfinite(s["compressed_ce"])
    assert abs(s["compressed_ce"] - s["base_ce"]) < 1.0
    assert '"method": "coala"' in capsys.readouterr().out


def test_svd_of_non_finite_input_is_nan_like_jax():
    """A diverged model's weights reach the compression's SVDs: the
    reference's ``jnp.linalg.svd`` returns all-NaN factors, so COALA's solve
    yields NaN factors; the port's ``svd`` must too, where
    ``torch.linalg.svd`` raises (and cuSOLVER first iterates for minutes)."""
    from repro.core.coala import coala_factors as j_coala_factors
    from repro_torch.core.coala import coala_factors, svd, svdvals
    rng = np.random.RandomState(0)
    w = rng.standard_normal((48, 40)).astype(np.float32)
    w[3, 5] = np.nan
    r = np.triu(rng.standard_normal((40, 40))).astype(np.float32)
    ju, js, jvt = jnp.linalg.svd(jnp.asarray(w), full_matrices=False)
    u, s, vt = svd(torch.from_numpy(w))
    for a, b in ((u, ju), (s, js), (vt, jvt)):
        assert a.shape == b.shape and torch.isnan(a).all()
        assert bool(jnp.isnan(b).all())
    assert torch.isnan(svdvals(torch.from_numpy(w))).all()
    jres = j_coala_factors(jnp.asarray(w), r_factor=jnp.asarray(r), rank=8, lam=4.0)
    res = coala_factors(torch.from_numpy(w), r_factor=torch.from_numpy(r), rank=8,
                        lam=4.0)
    assert not bool(jnp.isfinite(jres.a).any()) and not torch.isfinite(res.a).any()
    w[3, 5] = 0.0                       # finite input: the solver as before
    np.testing.assert_allclose(svdvals(torch.from_numpy(w)).numpy(),
                               np.asarray(jnp.linalg.svd(jnp.asarray(w),
                                                         compute_uv=False)),
                               rtol=1e-5, atol=1e-5)
