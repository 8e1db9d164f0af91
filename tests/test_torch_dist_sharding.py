"""The port's sharding plans (``repro_torch.dist.sharding``) against the JAX
package's ``repro.dist.sharding``, for all twelve configs at full width.

One JAX subprocess computes the reference's specs with
``jax.eval_shape`` over ``AbstractMesh`` (16, 16), (2, 16, 16) and (2, 2, 2)
— no devices — for params in both modes (dense, and a factored tree built
by shape: every col/row linear as b_t (d_in, 40) / a_t (40, d_out), every
expert bank as the reference's (b_t, a_t) tuple), train states under every
strategy (with the error-feedback state), batches and caches; the port
computes its own from models on the meta device. The port's specs must
equal the reference's leaf for leaf, with the reference's stacked layer
axis dropped. While the JAX run goes, one 4-rank gloo spawn places every
smollm_135m SMOKE tensor on a (2, 2) mesh by ``to_placements`` through
``distribute_tensor`` and gathers it back with ``full_tensor()``: bit for
bit.
"""
import functools
import json
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import _param_path
from repro_torch.dist import group
from repro_torch.dist.sharding import (AbstractMesh, batch_axes_of, batch_specs,
                                       cache_specs, param_specs, to_placements,
                                       train_state_specs)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import STACKED, build_model
from repro_torch.models.ffn import ExpertBank
from repro_torch.models.linear import Linear
from repro_torch.train.optimizer import adamw_init

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
RANK = 40                 # the factored trees' rank (16 does not divide it, 2 does)
BATCH, LEN = 32, 8        # batch and cache rows, sequence / cache length
STRATEGIES = ("fsdp", "zero1", "zero1h")
COL_ROW = frozenset({"wq", "wk", "wv", "gate", "up", "ff_up", "in_proj", "w_dkv",
                     "w_krope", "w_uk", "w_uv", "x_proj", "dt_proj", "wo", "down",
                     "ff_down", "out_proj"})
EXPERTS = frozenset({"w_gate", "w_up", "w_down"})
JOIN_S = 400.0                 # deadline of the spawn and of the JAX run (loaded runner)

JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp
    from jax.sharding import AbstractMesh, PartitionSpec as P
    from repro.configs import ARCH_IDS, get_config
    from repro.dist.sharding import (batch_specs, cache_specs, param_specs,
                                     train_state_specs)
    from repro.models import build_model

    MESHES = json.loads(sys.argv[2])
    RANK, BATCH, LEN = int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
    COL_ROW = set(json.loads(sys.argv[6]))
    EXPERTS = set(json.loads(sys.argv[7]))
    SDS = jax.ShapeDtypeStruct

    def key(path):
        return "/".join(str(k.key if hasattr(k, "key") else k.idx) for k in path)

    def flat(specs):
        leaves = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, P))[0]
        return {key(p): [list(e) if isinstance(e, tuple) else e for e in s]
                for p, s in leaves}

    def factored(node, name=None):
        if isinstance(node, dict):
            if name in COL_ROW and set(node) == {"w"}:
                *lead, d_in, d_out = node["w"].shape
                return {"b_t": SDS((*lead, d_in, RANK), jnp.float32),
                        "a_t": SDS((*lead, RANK, d_out), jnp.float32)}
            return {k: factored(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [factored(v) for v in node]
        if name in EXPERTS:
            *lead, d_in, d_out = node.shape
            return (SDS((*lead, d_in, RANK), jnp.float32),
                    SDS((*lead, RANK, d_out), jnp.float32))
        return node

    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        model = build_model(cfg)
        dense = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        trees = {"dense": dense, "factored": factored(dense)}
        batch = {"tokens": SDS((BATCH, LEN), jnp.int32)}
        if cfg.family == "vlm":
            batch["vision_embeds"] = SDS((BATCH, cfg.n_vision_tokens, cfg.d_model),
                                         jnp.float32)
        if cfg.family == "encdec":
            batch["frames"] = SDS((BATCH, cfg.n_audio_frames, cfg.d_model),
                                  jnp.float32)
        cache = jax.eval_shape(lambda: model.init_cache(BATCH, LEN))
        for mname, (shape, axes) in MESHES.items():
            mesh = AbstractMesh(tuple(shape), tuple(axes))
            res = {}
            for tname, tree in trees.items():
                for mode in ("train", "infer"):
                    res[f"params/{tname}/{mode}"] = flat(
                        param_specs(cfg, tree, mesh, mode=mode))
                state = {"params": tree, "opt": {"m": tree, "v": tree, "step": 0},
                         "err": tree}
                for strat in ("fsdp", "zero1", "zero1h"):
                    res[f"state/{tname}/{strat}"] = flat(
                        train_state_specs(cfg, state, mesh, strategy=strat))
            res["batch"] = flat(batch_specs(cfg, batch, mesh))
            res["cache"] = flat(cache_specs(cfg, cache, mesh))
            out[f"{arch}/{mname}"] = res
    json.dump(out, open(sys.argv[1], "w"))
    print("OK")
""")


def _norm(spec, ndim):
    """A reference spec (JSON) as a tuple of ``ndim`` entries."""
    entries = [tuple(e) if isinstance(e, list) else e for e in spec]
    return tuple(entries + [None] * (ndim - len(entries)))


@functools.lru_cache(maxsize=None)
def _meta_model(arch: str, factored: bool):
    """``arch`` at full width on the meta device; ``factored`` replaces every
    col/row linear and expert bank by factors of rank RANK, by shape (built
    once per module: the tests only read it)."""
    model = build_model(get_config(arch), device="meta")
    if factored:
        for name, mod in model.named_modules():
            last = name.rsplit(".", 1)[-1]
            if isinstance(mod, Linear) and last in COL_ROW and mod.has_dense:
                d_in, d_out = mod.w.shape
                mod.set_factors(torch.empty(d_in, RANK, device="meta"),
                                torch.empty(RANK, d_out, device="meta"))
            elif isinstance(mod, ExpertBank) and not mod.is_factored:
                e, d_in, d_out = mod.w.shape
                mod.set_factors(torch.empty(e, d_in, RANK, device="meta"),
                                torch.empty(e, RANK, d_out, device="meta"))
    return model


@functools.lru_cache(maxsize=None)
def _ref_keys(model) -> dict:
    """{parameter name: (the reference's flattened path of it, whether the
    reference stacks it)}."""
    banks = {n for n, m in model.named_modules() if isinstance(m, ExpertBank)}
    out = {}
    for name, _ in model.named_parameters():
        path, _ = _param_path(name, banks)
        out[name] = ("/".join(str(k) for k in path), path[0] in STACKED)
    return out


def _check_params(model, got: dict, want: dict, prefix: str = "") -> None:
    """Every parameter's spec against the reference's leaf (stacked axis
    dropped); the reference has no other leaf."""
    params = dict(model.named_parameters())
    ref_keys = _ref_keys(model)
    assert set(got) == set(params)
    keys = set()
    for name, spec in got.items():
        key, stacked = ref_keys[name]
        keys.add(prefix + key)
        ref = _norm(want[prefix + key], params[name].ndim + stacked)
        if stacked:
            assert ref[0] is None, (name, ref)
            ref = ref[1:]
        assert spec == ref, (name, spec, ref)
    assert keys == {k for k in want if k.startswith(prefix)} if prefix else keys == set(want)


@pytest.fixture(scope="module")
def runs():
    """(the reference's specs by config and mesh, the port spawn's per-rank
    results)."""
    with tempfile.TemporaryDirectory() as tmp:
        out_json = Path(tmp) / "specs.json"
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
        args = [str(out_json), json.dumps(MESHES), str(RANK), str(BATCH), str(LEN),
                json.dumps(sorted(COL_ROW)), json.dumps(sorted(EXPERTS))]
        jax_run = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, *args], env=env,
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                   text=True)
        try:
            port = group.run(4, place_on_mesh, device="cpu", timeout=JOIN_S)
            out, err = jax_run.communicate(timeout=JOIN_S)
        finally:
            if jax_run.poll() is None:
                jax_run.kill()
                jax_run.communicate()
        assert jax_run.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
        yield json.loads(out_json.read_text()), port


def place_on_mesh() -> dict:
    """Every rank's part: each smollm SMOKE parameter distributed on a
    ("data", "model") (2, 2) mesh by its train and infer specs and gathered
    back, and a batch on a ("pod", "data") (2, 2) mesh by ``batch_specs``
    (its rows over both axes). Returns the names whose gather differed, the
    local shapes, and this rank's rows of the batch."""
    from torch.distributed.tensor import distribute_tensor
    cfg = get_smoke_config("smollm_135m")
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"rank": dist.get_rank(), "differ": [], "local": {}}
    for mode in ("train", "infer"):
        for name, spec in param_specs(cfg, model, mesh, mode=mode).items():
            t = dict(model.named_parameters())[name].detach()
            d = distribute_tensor(t, mesh, to_placements(spec, mesh))
            if not torch.equal(d.full_tensor(), t):
                out["differ"].append((mode, name))
            out["local"][(mode, name)] = tuple(d.to_local().shape)
    bmesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
    tokens = torch.arange(8 * 3).reshape(8, 3)
    spec = batch_specs(cfg, {"tokens": tokens}, bmesh)["tokens"]
    d = distribute_tensor(tokens, bmesh, to_placements(spec, bmesh))
    out["batch_spec"] = spec
    out["batch_rows"] = d.to_local()[:, 0].tolist()
    out["batch_equal"] = torch.equal(d.full_tensor(), tokens)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(runs, arch):
    """Both modes, dense and factored, on the three meshes."""
    ref, _ = runs
    for mname, (shape, axes) in MESHES.items():
        mesh = AbstractMesh(shape, axes)
        for kind in ("dense", "factored"):
            model = _meta_model(arch, kind == "factored")
            for mode in ("train", "infer"):
                _check_params(model, param_specs(None, model, mesh, mode=mode),
                              ref[f"{arch}/{mname}"][f"params/{kind}/{mode}"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_state_specs_match_reference(runs, arch):
    """fsdp, zero1 and zero1h with the error-feedback state: params under
    ``model``, the moments and ``err`` keyed by parameter, ``step``
    replicated."""
    ref, _ = runs
    for mname, (shape, axes) in MESHES.items():
        mesh = AbstractMesh(shape, axes)
        for kind in ("dense", "factored"):
            model = _meta_model(arch, kind == "factored")
            params = dict(model.named_parameters())
            state = {"model": model, "opt": adamw_init(params), "err": True}
            for strat in STRATEGIES:
                want = ref[f"{arch}/{mname}"][f"state/{kind}/{strat}"]
                got = train_state_specs(None, state, mesh, strategy=strat)
                assert set(got) == {"model", "opt", "err"}
                assert got["opt"]["step"] == () and want["opt/step"] == []
                _check_params(model, got["model"], want, "params/")
                _check_params(model, got["opt"]["m"], want, "opt/m/")
                _check_params(model, got["opt"]["v"], want, "opt/v/")
                ref_keys = _ref_keys(model)
                for name, spec in got["err"].items():
                    key, stacked = ref_keys[name]
                    w = _norm(want["err/" + key], params[name].ndim + 1 + stacked)
                    assert spec == (w[:1] + w[2:] if stacked else w), (name, spec, w)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match_reference(runs, arch):
    """A (32, 8) batch with the family's vision prefix or frames, and
    ``init_contiguous_cache(32, 8)`` layer by layer against the reference's
    ``init_cache`` (its prefix layers, then the stacked reps' subs; an
    encoder–decoder's self and cross K/V per decoder layer)."""
    ref, _ = runs
    cfg = get_config(arch)
    model = build_model(cfg, device="meta")
    batch = {"tokens": torch.empty(BATCH, LEN, dtype=torch.int32, device="meta")}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.empty(BATCH, cfg.n_vision_tokens, cfg.d_model,
                                             device="meta")
    if cfg.family == "encdec":
        batch["frames"] = torch.empty(BATCH, cfg.n_audio_frames, cfg.d_model,
                                      device="meta")
    cache = model.init_contiguous_cache(BATCH, LEN)
    for mname, (shape, axes) in MESHES.items():
        mesh = AbstractMesh(shape, axes)
        want = ref[f"{arch}/{mname}"]
        got = batch_specs(cfg, batch, mesh)
        assert got == {k: _norm(v, batch[k].ndim) for k, v in want["batch"].items()}
        assert got["tokens"][0] == (("pod", "data") if "pod" in axes else "data")
        layers = _ref_cache_layers(cfg, want["cache"])
        got = cache_specs(cfg, cache, mesh)
        assert len(got) == len(layers) == len(cache)
        for g, w, c in zip(got, layers, cache):
            assert set(g) == set(w) == set(c)
            for name, spec in g.items():
                assert spec == _norm(w[name], c[name].ndim), (name, spec, w[name])


def _ref_cache_layers(cfg, flat: dict) -> list:
    """The reference's flattened cache specs as the port's per-layer dicts
    (keyed by leaf name, stacked axis dropped), in the port's layer order."""
    def strip(spec):
        return spec[1:] if spec else spec

    if cfg.family == "encdec":
        layer = {k.rsplit("/", 1)[1]: strip(v) for k, v in flat.items()}
        return [layer] * cfg.n_layers
    prefix, subs = {}, {}
    for k, v in flat.items():
        parts = k.split("/")
        if parts[0] == "prefix":
            prefix.setdefault(int(parts[1]), {})[parts[-1]] = v
        else:
            subs.setdefault(parts[1], {})[parts[-1]] = strip(v)
    n_leaves = sum(len(d) for d in list(prefix.values()) + list(subs.values()))
    assert n_leaves == len(flat), "leaf names repeat inside a layer"
    n_rep = (cfg.n_layers - len(prefix)) // len(subs)
    return [prefix[i] for i in sorted(prefix)] + [
        subs[f"sub{j}"] for _ in range(n_rep) for j in range(len(subs))]


def test_dtensor_round_trip_is_bit_exact(runs):
    """Every smollm SMOKE parameter through ``distribute_tensor`` by its
    train and infer placements on (2, 2) and back through ``full_tensor()``,
    bit for bit on every rank; the train plan shards over both mesh axes."""
    _, port = runs
    assert [p["rank"] for p in port] == [0, 1, 2, 3]
    for p in port:
        assert p["differ"] == []
    cfg = get_smoke_config("smollm_135m")
    model = build_model(cfg, device="meta")
    full = {n: tuple(t.shape) for n, t in model.named_parameters()}
    local = port[0]["local"]
    assert local[("train", "embed")] == (full["embed"][0] // 2, full["embed"][1] // 2)
    wq = "blocks.0.sub0.mixer.wq.w"
    assert local[("infer", wq)] == (full[wq][0], full[wq][1] // 2)
    assert local[("train", wq)] == (full[wq][0] // 2, full[wq][1] // 2)


def test_batch_rows_split_as_a_partition_spec(runs):
    """A batch dimension over ("pod", "data") gives mesh coordinate (i, j)
    row block 2i + j, the reference's major-to-minor order."""
    _, port = runs
    for p in port:
        assert p["batch_spec"] == (("pod", "data"), None) and p["batch_equal"]
        r = p["rank"]
        assert p["batch_rows"] == [3 * (2 * r), 3 * (2 * r + 1)]


def test_to_placements_and_refusals():
    from torch.distributed.tensor import Replicate, Shard
    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert to_placements((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert to_placements((None, None), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="not in the mesh's order"):
        to_placements((("data", "pod"),), mesh)
    assert batch_axes_of(AbstractMesh((4, 2), ("model", "data"))) == ("data",)
    model = build_model(get_smoke_config("smollm_135m"), device="meta")
    with pytest.raises(ValueError, match="unknown mode 'serve'"):
        param_specs(None, model, mesh, mode="serve")
    with pytest.raises(ValueError, match="unknown strategy 'zero2'"):
        train_state_specs(None, {"model": model}, mesh, strategy="zero2")


def test_make_mesh_needs_a_group_of_its_size():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group is initialised"):
        make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(RuntimeError,
                       match=r"(?s)2 of 2 ranks failed.*mesh \(2, 2\) needs 4 ranks, "
                             r"the group has 2"):
        group.run(2, make_mesh, ((2, 2), ("data", "model")), device="cpu", timeout=60)
