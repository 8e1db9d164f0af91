"""Adapter initialization, merging and adapter-only fine-tuning (paper §6.2,
Table 4) vs the JAX package, on the CPU.

Both packages start from the same JAX parameters and the same R factors
(the JAX calibrator's, through numpy), so the inits are compared on equal
inputs. Factors are compared by their invariants: the residual ``w`` and
the adapter's product b_t·a_t at 1e-4·max|ref| (fp32 SVDs of <= 128-wide
matrices); corda's explicit Gram solve at 1e-3·max|ref| where its Gram is
well conditioned (condition numbers 20-940, which the solve multiplies into
the rounding); ``wo``'s Gram of 256 tokens at width 256 is singular, and
there both packages return noise (Remark 1), which is not compared. lora draws from jax.random in the reference and from a
torch.Generator in the port, so its invariants are checked instead. The
three-leaf forward and merging are plain products: 1e-5. Three adapter-only
AdamW steps with weight decay > 0 hold every leaf, frozen ones included, at
atol 2e-6 (tests/test_torch_train.py's step tolerance, with its eps 1e-3;
2e-5 for corda, whose noisy ``wo`` adapters scale its activations up).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as j_smoke
from repro.core import adapters as jad
from repro.core.calibrate import calibrate_model as j_calibrate
from repro.models import build_model as j_build
from repro.models.linear import linear_apply
from repro.train import optimizer as jopt
from repro_torch.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import adapters
from repro_torch.kernels import lowrank_linear as ll
from repro_torch.kernels.ref import lowrank_linear_ref
from repro_torch.models.linear import Linear, linear_weight_matrix
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_loop import make_adapter_step

torch.set_num_threads(1)

CFG = get_smoke_config("llama3_1b")
RANK = 4
METHODS = ["pissa", "corda", "coala", "coala_a1", "coala_a2", "coala_a0.5"]
TOL = {"corda": 1e-3}


def _randn(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    jmodel = j_build(j_smoke("llama3_1b"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    toks = [rng.randint(0, CFG.vocab_size, (4, 32)).astype(np.int32)
            for _ in range(2)]
    jcal = j_calibrate(jmodel, jparams, [{"tokens": jnp.asarray(t)} for t in toks])
    jrf = jcal.r_factors()
    trf = {p: torch.from_numpy(np.array(r)) for p, r in jrf.items()}
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, jrf, params_from_numpy(tree, CFG, device="cpu"), trf, toks


def _linears(tree, out=None, path=()):
    """{path: leaf dict} of every linear in a JAX-layout tree."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        if "w" in tree and not isinstance(tree["w"], dict):
            out["/".join(path)] = tree
        else:
            for k, v in tree.items():
                _linears(v, out, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _linears(v, out, path + (str(i),))
    return out


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("method", METHODS)
def test_init_adapters_matches_jax(setup, method):
    """Per target linear of every rep: w_res and b_t·a_t as JAX's; the mask
    marks exactly the adapter leaves; W_res + b_t·a_t = W."""
    jmodel, jparams, jrf, tmodel, trf, _ = setup
    jnew, jmask = jad.init_adapters(jparams, jrf, method=method, rank=RANK)
    tnew, tmask = adapters.init_adapters(tmodel, trf, method=method, rank=RANK)
    want = _linears(jax.tree.map(np.asarray, jnew))
    got = _linears(params_to_numpy(tnew))
    orig = _linears(jax.tree.map(np.asarray, jparams))
    tol = TOL.get(method, 1e-4)
    adapted = [p for p, leaf in want.items() if "b_t" in leaf]
    assert len(adapted) == 7
    assert sorted(p for p, leaf in got.items() if "b_t" in leaf) == sorted(adapted)
    for p in adapted:
        if method == "corda" and p.endswith("wo"):
            # 256 tokens at width 256: the Gram is singular (cond 1e10-1e16),
            # the explicit solve returns noise in both packages (Remark 1)
            continue
        j, t = want[p], got[p]
        assert t["b_t"].shape == j["b_t"].shape and t["b_t"].shape[-1] == RANK
        jprod = np.einsum("nir,nro->nio", j["b_t"], j["a_t"])
        tprod = np.einsum("nir,nro->nio", t["b_t"], t["a_t"])
        _close(tprod, jprod, tol)
        _close(t["w"], j["w"], tol)
        np.testing.assert_allclose(t["w"] + tprod, orig[p]["w"], rtol=0, atol=1e-5)
    mask_true = sorted(k for k, v in tmask.items() if v)
    assert mask_true == sorted(f"blocks.{r}.{p[len('blocks/'):].replace('/', '.')}.{leaf}"
                               for p in adapted for r in range(CFG.n_layers)
                               for leaf in ("b_t", "a_t"))
    assert sorted(tmask) == sorted(k for k, _ in tnew.named_parameters())
    jflags = jax.tree.leaves(jmask)
    assert sum(jflags) == 2 * len(adapted)


def test_lora_invariants(setup):
    """lora: a_t = 0, w untouched, b_t ~ N(0, 1/d_in) from the seeded
    torch.Generator (a seed repeats it, another seed does not), the same
    targets and mask as JAX's; so the adapted model's loss is the base's."""
    jmodel, jparams, jrf, tmodel, trf, toks = setup
    jnew, _ = jad.init_adapters(jparams, jrf, method="lora", rank=RANK)
    tnew, tmask = adapters.init_adapters(tmodel, trf, method="lora", rank=RANK)
    again, _ = adapters.init_adapters(tmodel, trf, method="lora", rank=RANK)
    other, _ = adapters.init_adapters(tmodel, trf, method="lora", rank=RANK, seed=1)
    want = _linears(jax.tree.map(np.asarray, jnew))
    got = _linears(params_to_numpy(tnew))
    orig = _linears(params_to_numpy(tmodel))
    assert sorted(p for p in got if "b_t" in got[p]) == sorted(
        p for p in want if "b_t" in want[p])
    draws = []
    for p, leaf in got.items():
        if "b_t" not in leaf:
            continue
        assert np.all(leaf["a_t"] == 0) and np.array_equal(leaf["w"], orig[p]["w"])
        d_in = leaf["b_t"].shape[1]
        draws.append(leaf["b_t"].ravel() * np.sqrt(d_in))
    z = np.concatenate(draws)
    assert abs(z.mean()) < 0.05 and abs(z.std() - 1.0) < 0.05, (z.mean(), z.std())
    a, b, c = (dict(m.named_parameters()) for m in (tnew, again, other))
    k = "blocks.0.sub0.mixer.wq.b_t"
    assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    tok = torch.from_numpy(toks[0])
    with torch.no_grad():
        np.testing.assert_allclose(float(tnew.loss(tok, compute_dtype=torch.float32)[0]),
                                   float(tmodel.loss(tok, compute_dtype=torch.float32)[0]),
                                   rtol=1e-6)


@pytest.mark.parametrize("method", ["pissa", "coala_a2"])
def test_merge_adapters_matches_jax(setup, method):
    """Merging a JAX-initialised, then perturbed, adapter tree: the same
    dense ``w`` as the JAX package's ``merge_adapters``, and the merged
    model's logits equal the adapter model's."""
    jmodel, jparams, jrf, _, _, toks = setup
    jnew, _ = jad.init_adapters(jparams, jrf, method=method, rank=RANK)
    jnew = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.05 if getattr(path[-1], "key", "") == "a_t" else x, jnew)
    tree = jax.tree.map(np.asarray, jnew)
    tmodel = params_from_numpy(tree, CFG, device="cpu")
    merged = adapters.merge_adapters(tmodel)
    assert not any(isinstance(m, Linear) and m.is_factored for m in merged.modules())
    want = _linears(jax.tree.map(np.asarray, jad.merge_adapters(jnew)))
    got = _linears(params_to_numpy(merged))
    assert sorted(got) == sorted(want)
    for p in want:
        np.testing.assert_allclose(got[p]["w"], want[p]["w"], rtol=1e-5, atol=1e-6)
    tok = torch.from_numpy(toks[0])
    with torch.no_grad():
        np.testing.assert_allclose(merged.logits(tok).numpy(), tmodel.logits(tok).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_three_leaf_linear_matches_linear_apply():
    """{"w", "b_t", "a_t"} sums the dense and the low-rank products, as
    ``linear_apply``; the weight matrix view is wᵀ alone, as the reference's."""
    w, b_t, a_t = _randn(0, (8, 6)), _randn(1, (8, 2)), _randn(2, (2, 6))
    x = _randn(3, (3, 4, 8))
    lin = Linear(8, 6, device="cpu")
    lin.set_adapter(*(torch.from_numpy(v) for v in (w, b_t, a_t)))
    assert lin.is_factored and lin.has_dense
    want = linear_apply({"w": jnp.asarray(w), "b_t": jnp.asarray(b_t),
                         "a_t": jnp.asarray(a_t)}, jnp.asarray(x))
    with torch.no_grad():
        got = lin(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(linear_weight_matrix(lin).numpy(), w.T)
    lin.set_factors(torch.from_numpy(b_t), torch.from_numpy(a_t))
    assert lin.is_factored and not lin.has_dense
    np.testing.assert_allclose(linear_weight_matrix(lin).numpy(), (b_t @ a_t).T,
                               rtol=1e-6)


def test_convert_round_trips_adapter_tree(setup):
    jmodel, jparams, jrf, *_ = setup
    jnew, _ = jad.init_adapters(jparams, jrf, method="coala_a1", rank=RANK)
    tree = jax.tree.map(np.asarray, jnew)
    back = params_to_numpy(params_from_numpy(tree, CFG, device="cpu"))
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert flat_b[path].dtype == leaf.dtype
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_mask_grads_matches_jax():
    grads = {"a.w": np.ones((3, 2), np.float32), "a.b_t": np.full((3, 1), 2.0, np.float32)}
    mask = {"a.w": False, "a.b_t": True}
    got = adapters.mask_grads({k: torch.from_numpy(v) for k, v in grads.items()}, mask)
    want = jad.mask_grads({k: jnp.asarray(v) for k, v in grads.items()}, mask)
    for k in grads:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


FT = dict(lr=1e-2, warmup_steps=1, total_steps=10, schedule="const",
          weight_decay=0.1, eps=1e-3)
# corda's wo adapters (from the singular Gram) hold entries up to ~46, so the
# adapted model's activations and gradients, and their fp32 rounding, are
# ~10x larger than the other methods'
FT_ATOL = {"corda": 2e-5}


@pytest.mark.parametrize("method", ["lora", "pissa", "corda", "coala_a1", "coala_a2"])
def test_adapter_finetune_steps_match_jax(setup, method):
    """Three adapter-only AdamW steps with weight decay 0.1 from the same
    JAX-initialised adapter tree (lora too): every leaf after the steps,
    the frozen ones included (they take lr·wd·w in both packages), and
    each step's loss; the frozen leaves did move (the decay)."""
    jmodel, jparams, jrf, _, _, toks = setup
    jnew, jmask = jad.init_adapters(jparams, jrf, method=method, rank=RANK)
    if method == "lora":      # a_t = 0 leaves the step's b_t gradient zero
        jnew = jax.tree_util.tree_map_with_path(
            lambda path, x: x + 0.01 if getattr(path[-1], "key", "") == "a_t" else x,
            jnew)
    # non-zero block norm scales: the reference decays them (stacked, ndim 2)
    jnew = jax.tree_util.tree_map_with_path(
        lambda path, x: (x + jnp.asarray(_randn(len(path), x.shape)) * 0.1
                         if getattr(path[-1], "key", "") == "scale" else x), jnew)
    tree = jax.tree.map(np.asarray, jnew)
    jcfg = JTrainConfig(**FT)

    @jax.jit
    def jstep(p, o, tokens):
        def lf(p):
            return jmodel.loss(p, {"tokens": tokens}, compute_dtype=jnp.float32)[0]
        loss, g = jax.value_and_grad(lf)(p)
        p, o, _ = jopt.adamw_update(jcfg, p, jad.mask_grads(g, jmask), o)
        return p, o, loss

    model = params_from_numpy(tree, CFG, device="cpu")
    tmask = {k: k.endswith((".b_t", ".a_t")) for k, _ in model.named_parameters()}
    opt = adamw_init(dict(model.named_parameters()))
    step = make_adapter_step(model, TrainConfig(**FT), tmask)
    jp, jo = jnew, jopt.adamw_init(jnew)
    for i in range(3):
        tok = toks[i % 2]
        jp, jo, jloss = jstep(jp, jo, jnp.asarray(tok))
        loss, grads = step(opt, torch.from_numpy(tok))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        assert sorted(grads) == sorted(k for k, v in tmask.items() if v)
    want = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jp))[0])
    got = dict(jax.tree_util.tree_flatten_with_path(params_to_numpy(model))[0])
    assert sorted(map(str, got)) == sorted(map(str, want))
    start = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    atol = FT_ATOL.get(method, 2e-6)
    for path, leaf in want.items():
        np.testing.assert_allclose(got[path], leaf, rtol=0, atol=atol, err_msg=str(path))
        # every leaf but the final norm's scale (ndim 1) took the decay
        top_norm = getattr(path[0], "key", "") == "final_norm"
        assert np.array_equal(leaf, start[path]) == top_norm, path


# ---------------------------------------------------------------------------
# the kernel's autograd Function, with its CUDA launch stood in on the CPU
# ---------------------------------------------------------------------------

def _stand_in_launch(x, b_t, a_t, *, keep_t=False):
    """What ``lowrank_linear._launch`` returns, computed in plain torch: y,
    and the intermediate t = x·b_t when asked; counted like a launch."""
    t = x.reshape(-1, b_t.shape[0]) @ b_t
    ll.launches += 1
    return (t @ a_t).view(*x.shape[:-1], a_t.shape[1]), t.clone() if keep_t else None


@pytest.mark.parametrize("need_x", [True, False])
def test_lowrank_backward_algebra(monkeypatch, need_x):
    """``LowRankLinear``'s gradients equal autograd's through the plain
    version at an odd rank; dx is one more launch (counted as a backward
    launch), and none is made when x needs no gradient."""
    monkeypatch.setattr(ll, "_launch", _stand_in_launch)
    monkeypatch.setattr(ll, "launches", 0)
    monkeypatch.setattr(ll, "backward_launches", 0)
    x0, b0, a0 = _randn(0, (2, 5, 12)), _randn(1, (12, 3)), _randn(2, (3, 7))
    dy = torch.from_numpy(_randn(3, (2, 5, 7)))
    grads = []
    for fn in (ll.LowRankLinear.apply, lowrank_linear_ref):
        x = torch.from_numpy(x0).requires_grad_(need_x)
        b, a = (torch.from_numpy(v).requires_grad_() for v in (b0, a0))
        fn(x, b, a).backward(dy)
        grads.append([x.grad, b.grad, a.grad])
    for got, want in zip(*grads):
        if want is None:
            assert got is None
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert ll.launches == 1 + need_x and ll.backward_launches == int(need_x)
