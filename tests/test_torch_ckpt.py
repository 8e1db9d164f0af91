"""Port checkpoints (``repro_torch.ckpt``) against the JAX package's, on the
CPU.

The reference's ``tests/test_ckpt.py`` cases run on port train states of
llama3_1b SMOKE; the async snapshot must survive an in-place AdamW step
taken while its files are written. Across the packages every comparison is
bit for bit (``np.array_equal`` of the leaves, equal dtypes): a checkpoint
holds the same bytes whichever package wrote it. The ``paths`` of each
family's SMOKE params and train state equal the reference's
``tree_flatten_with_path`` paths; a JAX-saved train state restores into the
port, and port-saved params (dense, factored, an MoE bank factored per
expert, the encoder-decoder's stacks) and train states restore in the JAX
manager; a bf16 leaf is written in the reference's bytes and read back by
the port, while the reference's own restore raises ``TypeError`` on it (a
reference quirk, ROADMAP Queue 3).
"""
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JManager
from repro.ckpt.checkpoint import _flatten_with_paths
from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.train.optimizer import adamw_init as j_adamw_init
from repro_torch import convert
from repro_torch.ckpt import CheckpointManager, checkpoint
from repro_torch.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import STACKED, build_model
from repro_torch.models.ffn import ExpertBank
from repro_torch.models.linear import Linear
from repro_torch.train.optimizer import adamw_update
from repro_torch.train.train_loop import make_train_state

torch.set_num_threads(1)

FAMILIES = ["llama3_1b", "deepseek_moe_16b", "deepseek_v2_lite_16b",
            "qwen2_vl_2b", "xlstm_1_3b", "whisper_base", "jamba_v0_1_52b",
            "olmo_1b"]


def _state(seed=0, arch="llama3_1b"):
    model = build_model(get_smoke_config(arch), device="cpu")
    return make_train_state(model, torch.Generator().manual_seed(seed))


def _params(state):
    return [p.detach().clone() for p in state["model"].parameters()]


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def jax_trees():
    """Each family's SMOKE params from the JAX init, as numpy, and its JAX
    train state ``{"params", "opt"}``."""
    out = {}
    for arch in FAMILIES:
        jp = j_build(j_smoke(arch)).init(jax.random.PRNGKey(0))
        out[arch] = (jax.tree.map(np.asarray, jp),
                     {"params": jp, "opt": j_adamw_init(jp)})
    return out


def _flat_numpy(tree):
    paths, leaves, _ = _flatten_with_paths(tree)
    return paths, [np.asarray(x) for x in leaves]


def _assert_bits(got: dict, paths, leaves):
    assert list(got) == list(paths)
    for p, want in zip(paths, leaves):
        g = got[p]
        assert g.shape == want.shape, p
        if want.dtype.name == "bfloat16":
            assert g.dtype == convert.BF16_BITS, p
            np.testing.assert_array_equal(g.view(np.uint16),
                                          want.view(np.uint16), err_msg=p)
        else:
            assert g.dtype == want.dtype, p
            np.testing.assert_array_equal(g, want, err_msg=p)


# ---------------------------------------------------------------------------
# the reference's tests/test_ckpt.py cases on port states
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = _state()
    state["opt"]["step"] = 7
    mgr.save(7, state)
    fresh = _state(1)
    restored, meta = mgr.restore(fresh)
    assert meta["step"] == 7 and restored is fresh
    assert _equal(_params(state), _params(fresh))
    assert fresh["opt"]["step"] == 7


def test_async_save_and_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, _state(1), blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_keep_k_prunes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s))
    assert mgr.all_steps() == [3, 4]


def test_restore_latest_and_specific(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    s1, s2 = _state(1), _state(2)
    mgr.save(1, s1)
    mgr.save(2, s2)
    target = _state(3)
    mgr.restore(target)                          # latest = step 2
    assert _equal(_params(target), _params(s2))
    mgr.restore(target, step=1)
    assert _equal(_params(target), _params(s1))


def test_no_partial_checkpoint_visible(tmp_path):
    """tmp dir naming means a crashed write is never listed as a step."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    os.makedirs(os.path.join(str(tmp_path), ".tmp_step_9"))
    assert mgr.all_steps() == []


def test_structure_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    with pytest.raises(AssertionError):
        mgr.restore({"params": build_model(get_smoke_config("olmo_1b"),
                                           device="cpu")})


def test_async_snapshot_survives_an_in_place_step(tmp_path, monkeypatch):
    """The port's AdamW updates the parameters and moments in place, and on
    the CPU ``t.cpu()`` is ``t``: an async save must write the state as it
    was when ``save`` returned, not as the next step leaves it. The writer
    is held before its first leaf until a step has run."""
    go, started = threading.Event(), threading.Event()
    save_leaf = checkpoint._save_leaf

    def held(path, a):
        started.set()
        assert go.wait(30)
        save_leaf(path, a)

    monkeypatch.setattr(checkpoint, "_save_leaf", held)
    mgr = CheckpointManager(str(tmp_path))
    state = _state()
    before = _params(state)
    m_before = [m.clone() for m in state["opt"]["m"].values()]
    mgr.save(5, state, blocking=False)
    assert started.wait(30)
    params = dict(state["model"].named_parameters())
    grads = {k: torch.ones_like(p) for k, p in params.items()}
    adamw_update(TrainConfig(lr=1e-2, warmup_steps=1), params, grads,
                 state["opt"])
    assert not _equal(before, _params(state))
    go.set()
    mgr.wait()
    fresh = _state(9)
    mgr.restore(fresh)
    assert _equal(before, _params(fresh))
    assert _equal(m_before, list(fresh["opt"]["m"].values()))
    assert fresh["opt"]["step"] == 0


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_paths_and_leaves_equal_the_reference(jax_trees, arch):
    """``paths`` of the params and the train state letter for letter and in
    the reference's order (olmo's empty norm dicts give no leaf; deepseek's
    prefix list gives index keys), and every leaf bit for bit."""
    tree, jstate = jax_trees[arch]
    model = params_from_numpy(tree, get_smoke_config(arch), device="cpu")
    state = make_train_state(model)
    for port_state, jax_tree in (({"params": model}, {"params": tree}),
                                 (state, jstate)):
        paths, leaves = _flat_numpy(jax_tree)
        assert convert.state_paths(port_state) == paths
        _assert_bits(convert.state_to_flat(port_state), paths, leaves)


@pytest.mark.parametrize("arch", ["llama3_1b", "deepseek_moe_16b"])
def test_jax_saved_train_state_restores_in_the_port(tmp_path, jax_trees, arch):
    tree, jstate = jax_trees[arch]
    rng = np.random.RandomState(4)
    jstate = jax.tree.map(lambda x: x + jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32)).astype(x.dtype)
        if x.ndim else x + 12, jstate)
    JManager(str(tmp_path)).save(12, jstate)
    state = make_train_state(build_model(get_smoke_config(arch), device="cpu"))
    m_refs = dict(state["opt"]["m"])
    _, meta = CheckpointManager(str(tmp_path)).restore(state)
    assert meta["step"] == 12 and state["opt"]["step"] == 12
    assert all(state["opt"]["m"][k] is t for k, t in m_refs.items())
    _assert_bits(convert.state_to_flat(state), *_flat_numpy(jstate))


def _factor(model, seed=0):
    """Factor every block, layer and prefix projection and every expert bank
    with random factors of rank min(d_in, d_out) // 3, as a compressor
    leaves them (the values do not matter here, only the tree)."""
    g = torch.Generator().manual_seed(seed)
    for name, mod in model.named_modules():
        head = name.split(".")[0]
        if head not in STACKED + ("prefix",):
            continue
        if isinstance(mod, Linear):
            d_in, d_out = ((mod.b_t.shape[0], mod.a_t.shape[1])
                           if mod.is_factored else mod.w.shape)
            r = max(1, min(d_in, d_out) // 3)
            mod.set_factors(torch.randn(d_in, r, generator=g),
                            torch.randn(r, d_out, generator=g))
        elif isinstance(mod, ExpertBank):
            e, d_in, d_out = ((*mod.b_t.shape[:2], mod.a_t.shape[2])
                              if mod.is_factored else mod.w.shape)
            r = max(1, min(d_in, d_out) // 3)
            mod.set_factors(torch.randn(e, d_in, r, generator=g),
                            torch.randn(e, r, d_out, generator=g))
    return model


@pytest.mark.parametrize("arch,factored", [
    ("llama3_1b", False), ("llama3_1b", True), ("deepseek_moe_16b", True),
    ("whisper_base", False), ("whisper_base", True), ("jamba_v0_1_52b", True)])
def test_port_saved_params_restore_in_jax_and_back(tmp_path, jax_trees, arch,
                                                   factored):
    """Port-saved ``{"params"}`` restored by the JAX manager (into a JAX
    tree of the same structure) equal the port's leaves, and the JAX manager's
    save of other values restores into the port's model."""
    cfg = get_smoke_config(arch)
    model = params_from_numpy(jax_trees[arch][0], cfg, device="cpu")
    if factored:
        _factor(model)
    CheckpointManager(str(tmp_path / "port")).save(3, {"params": model})
    like = {"params": jax.tree.map(jnp.zeros_like, params_to_numpy(model))}
    restored, meta = JManager(str(tmp_path / "port")).restore(like)
    assert meta["step"] == 3
    want = convert.state_to_flat({"params": model})
    _assert_bits(want, *_flat_numpy(restored))

    other = params_to_numpy(_factor(model, seed=1) if factored else model)
    other = jax.tree.map(lambda x: x * 2 + 1, other)
    JManager(str(tmp_path / "jax")).save(4, {"params": other})
    CheckpointManager(str(tmp_path / "jax")).restore({"params": model})
    _assert_bits(convert.state_to_flat({"params": model}),
                 *_flat_numpy({"params": other}))


def test_port_saved_train_state_restores_in_jax(tmp_path, jax_trees):
    tree, jstate = jax_trees["deepseek_moe_16b"]
    model = params_from_numpy(tree, get_smoke_config("deepseek_moe_16b"),
                              device="cpu")
    state = make_train_state(model)
    params = dict(model.named_parameters())
    adamw_update(TrainConfig(lr=1e-2, warmup_steps=1), params,
                 {k: torch.randn(p.shape, generator=torch.Generator()
                                 .manual_seed(i)) for i, (k, p) in
                  enumerate(params.items())}, state["opt"])
    CheckpointManager(str(tmp_path)).save(1, state)
    restored, _ = JManager(str(tmp_path)).restore(jstate)
    assert int(restored["opt"]["step"]) == 1
    _assert_bits(convert.state_to_flat(state), *_flat_numpy(restored))


def test_bf16_leaves_cross_both_ways(tmp_path, jax_trees):
    """A bf16 leaf: the reference's numpy writes the bits under ``<V2``,
    the manifest saying ``bfloat16``. The port reads such a checkpoint bit
    for bit and writes the same bytes; the reference's own restore raises
    ``TypeError`` on it (``jnp.asarray`` of a ``|V2`` array)."""
    cfg = get_smoke_config("llama3_1b")
    tree = {"params": jax.tree.map(lambda x: jnp.asarray(x).astype(
        jnp.bfloat16), jax_trees["llama3_1b"][0])}
    JManager(str(tmp_path / "jax")).save(2, tree)
    model = build_model(cfg, device="cpu", dtype=torch.bfloat16)
    CheckpointManager(str(tmp_path / "jax")).restore({"params": model})
    _assert_bits(convert.state_to_flat({"params": model}), *_flat_numpy(tree))

    CheckpointManager(str(tmp_path / "port")).save(2, {"params": model})
    a, b = tmp_path / "jax" / "step_2", tmp_path / "port" / "step_2"
    assert json.loads((a / "manifest.json").read_text()) == \
        json.loads((b / "manifest.json").read_text())
    assert "bfloat16" in json.loads((b / "manifest.json").read_text())["dtypes"]
    for leaf in sorted(os.listdir(a)):
        assert (a / leaf).read_bytes() == (b / leaf).read_bytes(), leaf
    with pytest.raises(TypeError, match="V2"):
        JManager(str(tmp_path / "port")).restore(tree)
