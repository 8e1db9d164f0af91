"""whisper (family encdec) of the port against the JAX package, on the CPU at
SMOKE size (2 + 2 layers, d_model 64, 4 heads, 32 audio frames): the config
copy, the parameter tree through ``convert`` (dense and factored,
bit-exact), the encoder, the loss, the calibration
forward's streams, the contiguous-cache prefill and decode, the decoder
positions, ``_chunked_sdpa`` and ``sdpa``'s dispatch, the coala and svd_llm
compressions, three AdamW steps with weight decay, the pipeline's frames
and the compression launcher.

Inputs come from numpy with a seed; weights are the JAX init through
``convert.params_from_numpy``, with the norm scales drawn from numpy where a
test says so (the init's zeros hide them). Tolerances: encoder outputs,
logits and ``_chunked_sdpa`` 1e-5 (fp32, sums in another order); the loss
1e-5 relative; RᵀR at
1e-4 of its largest entry, the compression reports at 1e-4 and the factors
as A·B at 1e-4 of their largest entry (SVDs of the same matrices in two
libraries); AdamW's parameters at 2e-6 (``tests/test_torch_train.py``'s
bound, with its eps of 1e-3).
"""
import dataclasses

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
from repro.models import attention as j_attn
from repro.models import build_model as j_build
from repro.models.common import ParallelCtx as JParallelCtx
from repro.train import optimizer as jopt
from repro.train.train_loop import make_train_step as j_make_train_step
from repro_torch.config import CompressConfig, TrainConfig
from repro_torch.configs import ARCH_IDS, NOT_PORTED, get_config, get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.calibrate import calibrate_model
from repro_torch.core.compress import compress_model
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.data.pipeline import fold_in
from repro_torch.launch import compress as launch_compress
from repro_torch.models import EncDecLM, build_model
from repro_torch.models import attention as attn
from repro_torch.models.common import CPU_CTX, ParallelCtx
from repro_torch.train import optimizer as topt
from repro_torch.train.train_loop import make_train_state, make_train_step

torch.set_num_threads(1)

NAME = "whisper_base"
CFG = get_smoke_config(NAME)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def wh():
    """(JAX model, JAX params, numpy tree, port model), whisper SMOKE."""
    jmodel = j_build(j_smoke(NAME))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, tree, params_from_numpy(tree, CFG, device="cpu")


def _tokens(b, t, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, t)).astype(np.int32)


def _frames(b, seed=1):
    return np.random.RandomState(seed).standard_normal(
        (b, CFG.n_audio_frames, CFG.d_model)).astype(np.float32)


def _with_norm_scales(tree, seed=5):
    """The tree with every norm scale drawn from numpy."""
    rng = np.random.RandomState(seed)

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if key == "scale":
            return (rng.standard_normal(node.shape) * 0.1).astype(np.float32)
        return node
    return walk(tree, "")


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------

def test_config_is_the_jax_one_and_builds_an_encdec():
    assert NAME in ARCH_IDS and NAME not in NOT_PORTED
    assert list(NOT_PORTED) == []
    for ours, theirs in ((get_config(NAME), j_config(NAME)),
                         (CFG, j_smoke(NAME))):
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if f.name in ("moe", "mamba", "xlstm"):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
        assert ours.is_encdec and ours.n_enc_layers == theirs.n_enc_layers
    full = get_config(NAME)
    assert (full.n_layers, full.n_enc_layers, full.d_model, full.n_audio_frames) \
        == (6, 6, 512, 1500)
    model = build_model(CFG, device="cpu")
    assert isinstance(model, EncDecLM)
    assert model.layer_kinds() == ["cross"] * CFG.n_layers
    assert [n for n, _ in model.named_children()] == [
        "enc_final_norm", "dec_final_norm", "enc", "dec"]


@pytest.mark.parametrize("factored", [False, True])
def test_convert_round_trip_bit_exact(wh, factored):
    """The JAX tree's ``enc``/``dec`` stacks unstack into ``enc.<i>`` /
    ``dec.<i>`` and back bit for bit, dense and with every projection
    factored ({"b_t", "a_t"} of rank 5 from numpy)."""
    _, _, tree, tmodel = wh
    if factored:
        rng = np.random.RandomState(5)

        def factor(path, node):
            if isinstance(node, dict) and "w" in node and node["w"].ndim == 3:
                n, d_in, d_out = node["w"].shape
                return {"b_t": rng.standard_normal((n, d_in, 5)).astype(np.float32),
                        "a_t": rng.standard_normal((n, 5, d_out)).astype(np.float32)}
            if isinstance(node, dict):
                return {k: factor(path + (k,), v) for k, v in node.items()}
            return node
        tree = factor((), tree)
        tmodel = params_from_numpy(tree, CFG, device="cpu")
        assert tmodel.dec[1].cross.wk.is_factored
        assert tmodel.enc[0].mlp.gate is None
    back = params_to_numpy(tmodel)
    la, ta = jax.tree.flatten(back)
    lb, tb = jax.tree.flatten(tree)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert set(back) == {"embed", "pos_dec", "enc_final_norm", "dec_final_norm",
                         "enc", "dec"}
    assert set(back["dec"]) == {"norm1", "self", "norm2", "cross", "norm3", "mlp"}
    assert set(back["enc"]["mlp"]) == {"up", "down"}
    assert back["enc"]["norm1"]["scale"].shape == (2, CFG.d_model)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def test_encoder_and_loss_match_jax(wh):
    """The encoder's outputs and the fp32 loss from non-zero norm scales (the
    gradients are held through ``test_adamw_decays_enc_dec_norm_scales_like_
    jax``'s three steps)."""
    jmodel, jparams, tree, _ = wh
    tree = _with_norm_scales(tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    tmodel = params_from_numpy(tree, CFG, device="cpu")
    fr, tok = _frames(2), _tokens(2, 20)
    want = np.asarray(jmodel.encode(jparams, jnp.asarray(fr)))
    with torch.no_grad():
        got = tmodel.encode(torch.from_numpy(fr)).numpy()
        tl, parts = tmodel.loss(torch.from_numpy(tok),
                                frames=torch.from_numpy(fr),
                                compute_dtype=torch.float32)
    np.testing.assert_allclose(got, want, **TOL)
    jl, jparts = jmodel.loss(jparams, {"tokens": jnp.asarray(tok),
                                       "frames": jnp.asarray(fr)},
                             compute_dtype=jnp.float32)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(parts["aux"]) == float(jparts["aux"]) == 0.0


def test_prefill_and_decode_match_jax(wh):
    """``prefill`` over a contiguous cache (self K/V at [0, T), the cross
    K/V of the encoder outputs) then 6 greedy ``decode_step``s at a scalar
    position: every step's logits, and the caches at the end."""
    jmodel, jparams, _, tmodel = wh
    tok, fr = _tokens(2, 11, seed=3), _frames(2, seed=4)
    jprefill = jax.jit(lambda p, t, c, f: jmodel.prefill(
        p, t, c, frames=f, compute_dtype=jnp.float32))
    jdecode = jax.jit(lambda p, t, c, pos: jmodel.decode_step(
        p, t, c, pos, compute_dtype=jnp.float32))
    jc = jmodel.init_cache(2, 24, dtype=jnp.float32)
    jl, jc = jprefill(jparams, jnp.asarray(tok), jc, jnp.asarray(fr))
    tc = tmodel.init_contiguous_cache(2, 24)
    assert tc[0]["ck"].shape == (2, CFG.n_audio_frames, 4, CFG.head_dim)
    tl = tmodel.prefill(torch.from_numpy(tok), tc, frames=fr)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, -1], **TOL)
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)
    for i in range(6):
        jl, jc = jdecode(jparams, jnp.asarray(nxt[:, None]), jc,
                         jnp.int32(11 + i))
        tl = tmodel.decode_step(torch.from_numpy(nxt[:, None]), tc, 11 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for i, layer in enumerate(tc):
        for part, names in (("self", ("k", "v")), ("cross", ("ck", "cv"))):
            for n in names:
                np.testing.assert_allclose(layer[n].numpy(),
                                           np.asarray(jc[part][n][i]), **TOL)


@pytest.mark.parametrize("pos", [0, 7, 250, 255, [0, 3, 254, 255]])
def test_decoder_positions_clamp_like_the_reference(wh, pos):
    """``_embed_dec`` at a scalar or per-row start, clamped at the end of
    ``pos_dec`` (256 rows at SMOKE) as ``dynamic_slice`` clamps."""
    jmodel, jparams, _, tmodel = wh
    tok = _tokens(4, 3, seed=2)
    p0 = jnp.asarray(pos, jnp.int32)
    want = np.asarray(jmodel._embed_dec(jparams, jnp.asarray(tok), p0))
    tp = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) else pos
    with torch.no_grad():
        got = tmodel._embed_dec(torch.from_numpy(tok), tp).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# attention: _chunked_sdpa and sdpa's dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,cap", [(True, 0, 0.0), (False, 0, 0.0),
                                               (True, 9, 20.0)])
@pytest.mark.parametrize("offset", ["zero", "scalar", "rows"])
def test_chunked_sdpa_matches_the_reference(causal, window, cap, offset):
    """Ragged chunks (q 5 over 23 queries, kv 7 over 30 keys; both pad),
    a GQA group of 2, scalar and per-row query offsets: the reference's
    ``_chunked_sdpa`` and the port's ``dense_sdpa`` within 1e-5."""
    rng = np.random.RandomState(11)
    q = rng.standard_normal((3, 23, 4, 16)).astype(np.float32)
    k = rng.standard_normal((3, 30, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 30, 2, 16)).astype(np.float32)
    off = {"zero": 0, "scalar": 7, "rows": np.array([0, 4, 7], np.int32)}[offset]
    kw = dict(causal=causal, window=window, cap=cap, scale=0.25)
    want = np.asarray(j_attn._chunked_sdpa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_offset=jnp.asarray(off), chunk_q=5, chunk_kv=7, **kw))
    toff = torch.from_numpy(off) if offset == "rows" else off
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = attn._chunked_sdpa(tq, tk, tv, q_offset=toff, chunk_q=5, chunk_kv=7,
                             **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    dense = attn.dense_sdpa(tq, tk, tv, q_offset=toff, **kw)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)


def test_sdpa_dispatch_follows_the_reference(monkeypatch):
    """The three branches in the reference's order
    (``repro/models/attention.py:196-210``): the flash kernel first
    (``use_pallas``, causal, Tq == Tk, scalar offset), else ``_chunked_sdpa``
    past ``dense_attn_max_seq``, else ``dense_sdpa``."""
    calls = []
    for name in ("_chunked_sdpa", "dense_sdpa"):
        orig = getattr(attn, name)
        monkeypatch.setattr(attn, name, lambda *a, _n=name, _o=orig, **kw: (
            calls.append(_n), _o(*a, **kw))[1])
    flash = attn.ops.flash_attention
    monkeypatch.setattr(attn.ops, "flash_attention", lambda *a, **kw: (
        calls.append("flash"), flash(*a, **kw))[1])
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.standard_normal((1, 40, 2, 16)).astype(np.float32))
    short = ParallelCtx(dense_attn_max_seq=32, attn_chunk_q=16, attn_chunk_kv=8)
    cases = [(ParallelCtx(use_pallas=True), x, True, 0, "flash"),
             (dataclasses.replace(short, use_pallas=True), x, True, 0, "flash"),
             (dataclasses.replace(short, use_pallas=True), x, False, 0,
              "_chunked_sdpa"),
             (short, x, True, 0, "_chunked_sdpa"),
             (short, x[:, :32], False, 0, "dense_sdpa"),
             (CPU_CTX, x, True, 0, "dense_sdpa"),
             (dataclasses.replace(short, use_pallas=True), x[:, :1], True, 5,
              "_chunked_sdpa")]
    for ctx, q, causal, off, branch in cases:
        calls.clear()
        kv = x if off else q
        attn.sdpa(q, kv, kv, ctx=ctx, causal=causal, q_offset=off)
        assert calls == [branch], (ctx, q.shape, causal, off)


# ---------------------------------------------------------------------------
# calibration, compression, training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def calibrated(wh):
    jmodel, jparams, _, tmodel = wh
    # 8 rows: 256 frames and 192 tokens a projection, more than the widest
    # input (d_ff 128), so no Gram is singular by its token count
    batches = [(_tokens(8, 24, seed=7), _frames(8, seed=8))]
    jcal = j_calibrate(jmodel, jparams, [{"tokens": jnp.asarray(t),
                                          "frames": jnp.asarray(f)}
                                         for t, f in batches])
    tcal = calibrate_model(tmodel, [{"tokens": torch.from_numpy(t),
                                     "frames": torch.from_numpy(f)}
                                    for t, f in batches])
    return jcal, tcal


def test_calibration_streams_match_jax(calibrated):
    """Every projection's stream under the reference's path — the cross
    ``wk``/``wv`` fed the encoder outputs (32 frames a row) — and RᵀR."""
    jcal, tcal = calibrated
    jr, tr = jcal.r_factors(), tcal.r_factors()
    assert sorted(jr) == sorted(tr) and len(tr) == 2 * 6 + 2 * 10
    assert "dec/1/cross/wk" in tr and "enc/0/attn/wq" in tr
    seen = tcal.tokens_seen()
    assert seen["dec/0/cross/wk"] == seen["enc/1/mlp/up"] == 8 * 32
    assert seen["dec/0/cross/wq"] == seen["dec/0/self/wq"] == 8 * 24
    assert seen == jcal.tokens_seen()
    for p in tr:
        want = np.asarray(jr[p]).T @ np.asarray(jr[p])
        got = (tr[p].T @ tr[p]).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=p)


@pytest.mark.parametrize("method", ["coala", "svd_llm"])
def test_whisper_encdec_compression(wh, calibrated, method):
    """The port's ``tests/test_compress.py::test_whisper_encdec_compression``
    held against the reference: the 32 projections' reports at 1e-4, the
    factors as A·B at 1e-4 of their largest entry, and the compressed
    model's loss. svd_llm at 1e-3 relative (reports and A·B): the MLPs'
    ``down`` input is a gelu of a 64-wide map into 128, so its Gram's
    condition number reaches 1.1e6 (fp32's Cholesky then bounds the solve's
    relative error by ~0.07), and svd_llm's weighted error there is 29-38 in
    both packages, 1.8e-4 apart at most; a Gram that is not positive
    definite gives all-NaN factors in both."""
    jmodel, jparams, _, tmodel = wh
    jcal, tcal = calibrated
    jc, jrep = j_compress(jmodel, jparams, jcal,
                          JCompressConfig(method=method, ratio=0.6, lam=4.0))
    tc, trep = compress_model(tmodel, tcal,
                              CompressConfig(method=method, ratio=0.6, lam=4.0))
    tol = 1e-3 if method == "svd_llm" else 1e-4
    jd, td = {r.path: r for r in jrep}, {r.path: r for r in trep}
    assert sorted(jd) == sorted(td) and len(td) == 2 * 6 + 2 * 10
    for p, r in td.items():
        assert (r.rank, r.params_before, r.params_after) == (
            jd[p].rank, jd[p].params_before, jd[p].params_after)
        np.testing.assert_allclose(r.rel_err_weighted, jd[p].rel_err_weighted,
                                   rtol=tol if method == "svd_llm" else 0,
                                   atol=1e-4, equal_nan=True, err_msg=p)
        assert abs(r.mu - jd[p].mu) <= 1e-4 * max(abs(jd[p].mu), 1.0), p
    jtree, ttree = jax.tree.map(np.asarray, jc), params_to_numpy(tc)
    for p in td:
        head, i, *rest = p.split("/")
        jn, tn = jtree[head], ttree[head]
        for k in rest:
            jn, tn = jn[k], tn[k]
        want = jn["b_t"][int(i)] @ jn["a_t"][int(i)]
        got = tn["b_t"][int(i)] @ tn["a_t"][int(i)]
        if np.isnan(want).all():       # a Gram no Cholesky takes, in both
            assert np.isnan(got).all(), p
            continue
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max(), err_msg=p)
    tok, fr = _tokens(2, 16, seed=9), _frames(2, seed=10)
    tl, _ = tc.loss(torch.from_numpy(tok), frames=torch.from_numpy(fr),
                    compute_dtype=torch.float32)
    jl, _ = jmodel.loss(jc, {"tokens": jnp.asarray(tok), "frames": jnp.asarray(fr)},
                        compute_dtype=jnp.float32)
    assert np.isfinite(float(tl.detach())) == (method == "coala")
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4,
                               equal_nan=True)


def test_adamw_decays_enc_dec_norm_scales_like_jax(wh):
    """Three fp32 train steps with weight decay 0.1 from norm scales drawn
    from numpy: the reference stacks the encoder's and decoder's layers, so
    their norm scales are (n_layers, d) leaves there and decay with the
    weights; the final norms' (d,) scales do not. Every leaf within 2e-6."""
    jmodel, _, tree, _ = wh
    tree = _with_norm_scales(tree)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, schedule="cosine",
              compute_dtype="float32", eps=1e-3, weight_decay=0.1)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jparams, "opt": jopt.adamw_init(jparams)}
    jstep = jax.jit(j_make_train_step(jmodel, JTrainConfig(**kw), JParallelCtx()))
    model = params_from_numpy(tree, CFG, device="cpu")
    state = make_train_state(model)
    step = make_train_step(model, TrainConfig(**kw), CPU_CTX)
    assert topt.reference_ndim("dec.1.norm3.scale",
                               model.dec[1].norm3.scale) == 2
    assert topt.reference_ndim("dec_final_norm.scale",
                               model.dec_final_norm.scale) == 1
    tok, fr = _tokens(4, 16, seed=12), _frames(4, seed=13)
    for i in range(3):
        t = np.roll(tok, i, axis=1)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(t),
                                      "frames": jnp.asarray(fr)})
        state, met = step(state, {"tokens": torch.from_numpy(t),
                                  "frames": torch.from_numpy(fr)})
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
    want = _leaves(jax.tree.map(np.asarray, jstate["params"]))
    got = _leaves(params_to_numpy(state["model"]))
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=0, atol=2e-6, err_msg=k)


# ---------------------------------------------------------------------------
# pipeline and launcher
# ---------------------------------------------------------------------------

def test_pipeline_gives_frames():
    """An encoder–decoder's batch carries N(0, 1) ``frames`` from the
    generator seeded ``fold_in(seed + 1, step)``, repeatably."""
    dcfg = DataConfig(vocab_size=256, seq_len=16, global_batch=2, seed=3)
    pipe = TokenPipeline(dcfg, CFG, device="cpu")
    batch = pipe.get_batch(5)
    assert set(batch) == {"tokens", "frames"}
    assert batch["frames"].shape == (2, CFG.n_audio_frames, CFG.d_model)
    want = torch.randn((2, CFG.n_audio_frames, CFG.d_model),
                       generator=torch.Generator().manual_seed(fold_in(4, 5)))
    assert torch.equal(batch["frames"], want)
    assert torch.equal(pipe.get_batch(5)["frames"], batch["frames"])


def test_compress_launcher_on_whisper(capsys):
    """The compression launcher end to end with the pipeline's frames:
    pretraining, evaluation, calibration (the cross ``wk``/``wv`` on the
    encoder outputs) and COALA of every projection."""
    out = launch_compress.main(["--arch", NAME, "--smoke", "--device", "cpu",
                                "--pretrain-steps", "2", "--calib-batches",
                                "1"])
    s = out["summary"]
    assert s["layers"] == 2 * 6 + 2 * 10
    assert np.isfinite(s["base_ce"]) and np.isfinite(s["compressed_ce"])
    assert abs(s["compressed_ce"] - s["base_ce"]) < 1.0
    assert set(out["calib_batches"][0]) == {"tokens", "frames"}
    assert out["compressed"].dec[0].cross.wk.is_factored
    assert '"method": "coala"' in capsys.readouterr().out
