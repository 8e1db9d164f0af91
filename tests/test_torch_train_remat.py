"""The port's bf16 compute cast and layer rematerialization against the
JAX package's, on the CPU.

Tolerances:
- ``cast_for_compute``: bit for bit, the set of rounded leaves and their
  values, for every family's SMOKE config.
- remat: the port's ``none`` / ``dots`` / ``full`` losses and gradients are
  bit-identical to each other (recomputation repeats the same fp32 ops on
  the CPU); against the JAX model under the same remat at fp32, the loss at
  rtol 1e-6 and each gradient within 1e-4 of its largest entry (fp32 sums in
  another order through 2-4 layers and the Mamba scan).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten_with_paths
from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.train.train_loop import cast_for_compute as j_cast
from repro_torch import convert
from repro_torch.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models.common import RMSNorm
from repro_torch.models.ffn import MoE
from repro_torch.models.ssm import Mamba
from repro_torch.train.train_loop import (cast_for_compute,
                                          compute_parameters,
                                          make_train_state, make_train_step)

torch.set_num_threads(1)

FAMILIES = ["llama3_1b", "deepseek_moe_16b", "deepseek_v2_lite_16b",
            "qwen2_vl_2b", "xlstm_1_3b", "whisper_base", "jamba_v0_1_52b"]


def _jax_params(arch):
    return j_build(j_smoke(arch)).init(jax.random.PRNGKey(0))


def _flat(tree):
    paths, leaves, _ = _flatten_with_paths(tree)
    return dict(zip(paths, (np.asarray(x) for x in leaves)))


def _assert_flat_bits(got, want):
    assert list(got) == list(want)
    for p, w in want.items():
        g = got[p]
        if w.dtype.name == "bfloat16":
            assert g.dtype == convert.BF16_BITS, p
            np.testing.assert_array_equal(g.view(np.uint16), w.view(np.uint16),
                                          err_msg=p)
        else:
            assert g.dtype == w.dtype, p
            np.testing.assert_array_equal(g, w, err_msg=p)


# ---------------------------------------------------------------------------
# cast_for_compute
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_cast_for_compute_rounds_the_reference_leaves(arch):
    """The leaves that the reference rounds to bf16 (every floating leaf of
    ndim >= 2 in its stacked tree: the block norm scales, the routers,
    Mamba's vectors too) and their values, bit for bit; the rest stay
    fp32."""
    jp = _jax_params(arch)
    model = params_from_numpy(jax.tree.map(np.asarray, jp),
                              get_smoke_config(arch), device="cpu")
    with compute_parameters(model, torch.bfloat16):
        got = convert.state_to_flat({"params": model})
    want = _flat({"params": j_cast(jp, jnp.bfloat16)})
    _assert_flat_bits(got, want)
    assert any(w.dtype == np.float32 for w in want.values())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    params = dict(model.named_parameters())
    for k, t in cast_for_compute(model, torch.bfloat16).items():
        assert (t is params[k]) == (t.dtype == torch.float32), k


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "jamba_v0_1_52b"])
def test_bf16_train_step_reads_the_rounded_leaves(arch):
    """Inside a bf16 train step the block norms, the MoE routers and the
    Mamba vectors read their bf16 copies; the final norm and a prefix
    layer's norms read fp32; after the step the master is fp32 and moved."""
    cfg = get_smoke_config(arch)
    model = params_from_numpy(jax.tree.map(np.asarray, _jax_params(arch)),
                              cfg, device="cpu")
    seen = {}

    def hook(name, attr):
        def read(mod, args):
            seen.setdefault(name, getattr(mod, attr).dtype)
        return read

    for name, mod in model.named_modules():
        attr = {RMSNorm: "scale", MoE: "router", Mamba: "dt_bias"}.get(type(mod))
        if attr:
            mod.register_forward_pre_hook(hook(name, attr))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = make_train_state(model)
    step = make_train_step(model, TrainConfig(compute_dtype="bfloat16",
                                              remat="dots", lr=1e-3))
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 16))
    step(state, {"tokens": torch.from_numpy(tokens)})
    stacked = {k: v for k, v in seen.items() if k.startswith("blocks.")}
    assert stacked and all(v == torch.bfloat16 for v in stacked.values()), seen
    assert seen["final_norm"] == torch.float32
    assert all(v == torch.float32 for k, v in seen.items()
               if k.startswith("prefix."))
    assert any(isinstance(m, (MoE, Mamba)) for m in model.modules())
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32, k
    assert not torch.equal(before["blocks.0.sub0.norm1.scale"],
                           model.blocks[0]["sub0"].norm1.scale.detach())


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["llama3_1b", "jamba_v0_1_52b"])
def remat_runs(request):
    """Loss and gradients (in the port's parameter names) of both packages
    under each remat mode, fp32, on one (2, 32) batch."""
    arch = request.param
    cfg = get_smoke_config(arch)
    jm = j_build(j_smoke(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 32))
    runs = {}
    for remat in ("none", "dots", "full"):
        jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(
            p, {"tokens": jnp.asarray(tokens, jnp.int32)}, remat=remat,
            compute_dtype=jnp.float32)[0]))(jp)
        jgrads = dict(params_from_numpy(jax.tree.map(np.asarray, jg), cfg,
                                        device="cpu").named_parameters())
        model = params_from_numpy(tree, cfg, device="cpu")
        loss, _ = model.loss(torch.from_numpy(tokens), remat=remat,
                             compute_dtype=torch.float32)
        loss.backward()
        runs[remat] = (float(loss), {k: p.grad for k, p in
                                     model.named_parameters()},
                       float(jl), {k: g.detach() for k, g in jgrads.items()})
    return runs


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_remat_matches_jax_and_the_other_modes(remat_runs, remat):
    loss, grads, jloss, jgrads = remat_runs[remat]
    base_loss, base_grads = remat_runs["none"][:2]
    assert loss == base_loss
    for k, g in grads.items():
        assert torch.equal(g, base_grads[k]), k
    np.testing.assert_allclose(loss, jloss, rtol=1e-6)
    for k, g in grads.items():
        want = jgrads[k]
        torch.testing.assert_close(g, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()),
                                   msg=k)


def test_remat_mode_is_checked():
    model = params_from_numpy(jax.tree.map(np.asarray, _jax_params("llama3_1b")),
                              get_smoke_config("llama3_1b"), device="cpu")
    with pytest.raises(ValueError, match="remat"):
        model.loss(torch.zeros((1, 8), dtype=torch.long), remat="some")
