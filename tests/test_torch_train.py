"""Port training, loss and data pipeline vs the JAX package, on the CPU.

Same numpy inputs and JAX-made parameters (through numpy) go to both
packages. Tolerances: chunked CE and fp32 LM.loss at rtol 1e-5 (fp32 sums
over <= 2 x 31 x 256 logits); bf16 LM.loss at rtol 1e-2 (bf16 activations
round at other places in the two frameworks); lr_at at rtol 1e-6 (both in
fp32); one AdamW step at atol 2e-6 on the parameters, with the optimizer's
eps raised to 1e-3 in the test so that the first step's update
g / (|g| + eps) is smooth in g and gradients that differ by fp32 rounding
cannot flip its sign; gradient norms at rtol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.models.common import ParallelCtx as JParallelCtx
from repro.models.transformer import chunked_ce as j_chunked_ce
from repro.models.common import softcap as j_softcap
from repro.train import optimizer as jopt
from repro.train.train_loop import make_train_step as j_make_train_step
from repro_torch.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data import DataConfig, TokenPipeline, calibration_stream
from repro_torch.models.common import CPU_CTX, ParallelCtx, softcap
from repro_torch.models.transformer import chunked_ce
from repro_torch.train import optimizer as topt
from repro_torch.train.train_loop import make_train_state, make_train_step

torch.set_num_threads(1)

CFG = get_smoke_config("llama3_1b")


def _randn(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_lm():
    jmodel = j_build(j_smoke("llama3_1b"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tokens = np.random.RandomState(3).randint(0, CFG.vocab_size, (4, 32)).astype(np.int32)
    return jmodel, jparams, jax.tree.map(np.asarray, jparams), tokens


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,chunk,cap", [(37, 8, 0.0), (37, 512, 0.0),
                                         (32, 16, 15.0)])
def test_chunked_ce_matches_jax(t, chunk, cap):
    h, w = _randn(0, (2, t, 16)), _randn(1, (16, 50))
    y = np.random.RandomState(2).randint(0, 50, (2, t)).astype(np.int32)
    want = float(j_chunked_ce(jnp.asarray(h), jnp.asarray(y), jnp.asarray(w),
                              transform=lambda lg: j_softcap(lg, cap), chunk=chunk))
    got = float(chunked_ce(torch.from_numpy(h), torch.from_numpy(y),
                           torch.from_numpy(w), transform=lambda lg: softcap(lg, cap),
                           chunk=chunk))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("use_pallas,dtype,rtol", [
    (False, "float32", 1e-5), (True, "float32", 1e-5), (False, "bfloat16", 1e-2)])
def test_lm_loss_matches_jax(jax_lm, use_pallas, dtype, rtol):
    """LM.loss with and without the kernel ctx (the plain flash version on
    the CPU) against the JAX model's loss with the same ctx (its Pallas
    flash kernel in interpret mode)."""
    jmodel, jparams, tree, tokens = jax_lm
    jl, jm = jmodel.loss(jparams, {"tokens": jnp.asarray(tokens)},
                         ctx=JParallelCtx(use_pallas=use_pallas),
                         compute_dtype=getattr(jnp, dtype))
    model = params_from_numpy(tree, CFG, device="cpu")
    with torch.no_grad():
        tl, tm = model.loss(torch.from_numpy(tokens),
                            ctx=ParallelCtx(use_pallas=use_pallas),
                            compute_dtype=getattr(torch, dtype))
    np.testing.assert_allclose(float(tl), float(jl), rtol=rtol)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=rtol)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0


def test_loss_with_kernel_ctx_refuses_autograd(jax_lm):
    """The flash kernel has no backward: a differentiable loss through it
    raises instead of returning a wrong gradient."""
    model = params_from_numpy(jax_lm[2], CFG, device="cpu")
    tokens = torch.from_numpy(jax_lm[3])
    with pytest.raises(RuntimeError, match="no backward"):
        model.loss(tokens, ctx=ParallelCtx(use_pallas=True))
    loss, _ = model.loss(tokens, ctx=CPU_CTX)
    loss.backward()
    assert model.embed.grad is not None and model.embed.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# optimizer and train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule,warm,total", [
    ("cosine", 5, 100), ("cosine", 0, 100), ("wsd", 10, 100), ("const", 7, 50)])
def test_lr_at_matches_jax(schedule, warm, total):
    kw = dict(lr=3e-3, warmup_steps=warm, total_steps=total, schedule=schedule)
    jt, tt = JTrainConfig(**kw), TrainConfig(**kw)
    for step in (0, 1, warm - 1, warm, warm + 1, total // 2, total - 11,
                 total - 1, total + 5):
        np.testing.assert_allclose(topt.lr_at(tt, step),
                                   float(jopt.lr_at(jt, step)), rtol=1e-6)
    with pytest.raises(ValueError):
        topt.lr_at(dataclasses.replace(tt, schedule="linear"), 0)


def test_clip_by_global_norm_matches_jax():
    grads = {"a": _randn(0, (8, 4)) * 3, "b": _randn(1, (5,))}
    jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 1.0)
    tg, tn = topt.clip_by_global_norm(
        {k: torch.from_numpy(v.copy()) for k, v in grads.items()}, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in grads:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=1e-6)
    assert float(topt.global_norm(tg.values())) == pytest.approx(1.0, rel=1e-5)


def _leaves(tree):
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            flat["/".join(path)] = np.asarray(node)
    walk(tree, ())
    return flat


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(jax_lm, microbatches):
    """One fp32 train step (CPU_CTX): loss, gradient norm, lr and every
    parameter after AdamW against the JAX step from the same parameters."""
    jmodel, jparams, tree, tokens = jax_lm
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, schedule="cosine",
              compute_dtype="float32", microbatches=microbatches, eps=1e-3)
    jstate = {"params": jparams, "opt": jopt.adamw_init(jparams)}
    jstep = jax.jit(j_make_train_step(jmodel, JTrainConfig(**kw), JParallelCtx()))
    jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(tokens)})

    model = params_from_numpy(tree, CFG, device="cpu")
    tcfg = TrainConfig(**kw)
    state = make_train_state(model)
    state, met = make_train_step(model, tcfg, CPU_CTX)(
        state, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                               rtol=1e-4)
    np.testing.assert_allclose(met["lr"], float(jmet["lr"]), rtol=1e-6)
    assert state["opt"]["step"] == int(jstate["opt"]["step"]) == 1
    want = _leaves(jax.tree.map(np.asarray, jstate["params"]))
    got = _leaves(params_to_numpy(state["model"]))
    got.pop("prefix", None)
    assert sorted(got) == sorted(k for k in want if not k.startswith("prefix"))
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=0, atol=2e-6, err_msg=k)
    assert all(p.grad is None for p in model.parameters())


def _with_norm_scales(jparams):
    """The JAX parameters with non-zero norm scales, drawn with numpy (the
    init's zeros would hide the decay of those leaves)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (x + jnp.asarray(_randn(len(x.shape) + x.size, x.shape)) * 0.1
                         if getattr(path[-1], "key", "") == "scale" else x), jparams)


def _steps_against_jax(jax_lm, kw, n_steps):
    """``n_steps`` train steps of both packages from the same non-zero norm
    scales: (losses, JAX leaves, port leaves)."""
    jmodel, jparams, _, tokens = jax_lm
    jparams = _with_norm_scales(jparams)
    jstate = {"params": jparams, "opt": jopt.adamw_init(jparams)}
    jstep = jax.jit(j_make_train_step(jmodel, JTrainConfig(**kw), JParallelCtx()))
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, device="cpu")
    state = make_train_state(model)
    step = make_train_step(model, TrainConfig(**kw), CPU_CTX)
    losses = []
    for i in range(n_steps):
        tok = np.roll(tokens, i, axis=1)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(tok)})
        state, met = step(state, {"tokens": torch.from_numpy(tok)})
        losses.append((float(met["loss"]), float(jmet["loss"])))
    want = _leaves(jax.tree.map(np.asarray, jstate["params"]))
    got = _leaves(params_to_numpy(state["model"]))
    got.pop("prefix", None)
    return losses, want, got


def test_train_steps_decay_block_norm_scales_like_jax(jax_lm):
    """Three fp32 steps with weight decay 0.1 from non-zero norm scales: the
    reference decays every leaf of ndim >= 2 in its tree, where the block
    norm scales are stacked to (n_rep, d), so the port decays its (d,)
    ``blocks.<rep>.….scale`` too (and not the top-level final norm's).
    Every leaf within the one-step test's atol 2e-6."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, schedule="cosine",
              compute_dtype="float32", eps=1e-3, weight_decay=0.1)
    losses, want, got = _steps_against_jax(jax_lm, kw, 3)
    for ours, theirs in losses:
        np.testing.assert_allclose(ours, theirs, rtol=1e-5)
    assert sorted(got) == sorted(k for k in want if not k.startswith("prefix"))
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=0, atol=2e-6, err_msg=k)


def test_bf16_train_step_with_norm_scales_matches_jax(jax_lm):
    """One bf16-compute step from non-zero norm scales against the JAX
    step. Both packages round the stacked (n_rep, d) block norm scales (and
    MoE routers) to bf16 before the forward (``cast_for_compute``; its
    leaves are held bit for bit in tests/test_torch_train_remat.py). The
    leaves still differ from JAX's by up to 2.2e-3 (the embedding), because
    bf16 activations round at other places in the two frameworks. Loss at
    rtol 1e-2; every updated leaf within 5e-3 of JAX's (the update is at
    most lr 1e-2 · g / (|g| + 1e-3), and bf16 gradients differ by a few per
    cent)."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, schedule="cosine",
              compute_dtype="bfloat16", eps=1e-3, weight_decay=0.1)
    losses, want, got = _steps_against_jax(jax_lm, kw, 1)
    np.testing.assert_allclose(*losses[0], rtol=1e-2)
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=0, atol=5e-3, err_msg=k)


def test_pretraining_lowers_the_loss():
    """100 steps on the synthetic stream (an effective vocab of 64, as
    tests/test_train.py:17-36) take the SMOKE model's CE well below the
    uniform log(vocab)."""
    from repro_torch.models import build_model
    model = build_model(CFG, device="cpu")
    tcfg = TrainConfig(lr=5e-3, warmup_steps=5, total_steps=100,
                       schedule="cosine", compute_dtype="float32")
    state = make_train_state(model, torch.Generator().manual_seed(0))
    pipe = TokenPipeline(DataConfig(vocab_size=64, seq_len=64, global_batch=8,
                                    seed=3), CFG, device="cpu")
    step = make_train_step(model, tcfg)
    losses = [float(step(state, pipe.get_batch(i))[1]["ce"]) for i in range(100)]
    uniform = np.log(CFG.vocab_size)
    assert losses[0] == pytest.approx(uniform, rel=0.25)
    assert losses[-1] < uniform - 0.8, (losses[0], losses[-1], uniform)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_token_pipeline_is_deterministic_per_step():
    dcfg = DataConfig(vocab_size=97, seq_len=40, global_batch=4, seed=5)
    a, b = (TokenPipeline(dcfg, device="cpu") for _ in range(2))
    t3 = a.get_batch(3)["tokens"]
    assert t3.dtype == torch.int32 and tuple(t3.shape) == (4, 40)
    assert torch.equal(t3, b.get_batch(3)["tokens"])
    assert not torch.equal(t3, a.get_batch(4)["tokens"])
    other = TokenPipeline(dataclasses.replace(dcfg, seed=6), device="cpu")
    assert not torch.equal(t3, other.get_batch(3)["tokens"])
    it = a.iter_from(2)
    assert torch.equal(next(it)["tokens"], a.get_batch(2)["tokens"])
    assert torch.equal(next(it)["tokens"], t3)
    assert int(t3.min()) >= 0 and int(t3.max()) < 97
    cal = list(calibration_stream(dcfg, 2, device="cpu"))
    assert torch.equal(cal[1]["tokens"], a.get_batch(10_000_001)["tokens"])


def test_token_pipeline_follows_the_recurrence():
    """Next token = (x·3 + 7 + offset) % v with a per-row offset in [0, 7),
    except for a ~15% noise share (as repro/data/pipeline.py)."""
    dcfg = DataConfig(vocab_size=256, seq_len=128, global_batch=8, seed=0)
    tok = TokenPipeline(dcfg, device="cpu").get_batch(0)["tokens"].long()
    x, nxt = tok[:, :-1], tok[:, 1:]
    shares = []
    for row in range(tok.shape[0]):
        hits = [(((x[row] * 3 + 7 + off) % 256) == nxt[row]).float().mean().item()
                for off in range(7)]
        shares.append(max(hits))
    share = float(np.mean(shares))
    assert 0.78 < share < 0.92, share
