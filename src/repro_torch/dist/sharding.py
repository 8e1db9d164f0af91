"""Sharding specs for every architecture in ``repro_torch.configs`` (port of
``repro/dist/sharding.py``).

One vocabulary, three mesh axes:

  * ``pod``   — slow cross-pod links. Parameters are **replicated** across
                pods (the int8 + error-feedback gradient compression owns
                the cross-pod reduction and expects pod-replicated params);
                batches shard over it.
  * ``data``  — fast intra-pod data parallelism. Batches always shard over
                it; in ``mode="train"`` parameters and optimizer state also
                FSDP-shard over it (ZeRO-3 style).
  * ``model`` — tensor parallelism: column-parallel in-projections,
                row-parallel out-projections, vocab-sharded embedding/head,
                expert-parallel MoE banks (the expert axis over ``model``),
                and kv-head-sharded attention caches.

A spec is the reference's ``PartitionSpec`` as a tuple with one entry per
tensor dimension: None, an axis name, or a tuple of names. Specs are keyed
by the port's names (``state_dict`` names for parameters), and the
reference's leading scan axis of stacked layers is not there: the port
unstacks it into ``blocks.<rep>`` / ``enc.<i>`` / ``dec.<i>``. Every spec is
divisibility-guarded: an axis is only assigned to a tensor dimension the
mesh divides evenly, so one code serves small test meshes and the 512-rank
production meshes. Specs are computed from a mesh's axis names and sizes
alone (a ``DeviceMesh`` or an ``AbstractMesh``); ``to_placements`` turns a
spec into DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.convert import _param_path
from repro_torch.models.ffn import ExpertBank

MODEL_AXIS = "model"
# batch-like axes in mesh-major order; only those present in a mesh apply
BATCH_AXES = ("pod", "data")
# FSDP shards parameters over the intra-pod data axis only — never over
# ``pod`` (grad compression needs pod-replicated params, and the error-state
# spec ("pod", *param_spec) must not mention pod twice)
FSDP_AXES = ("data",)

# role of each named linear, keyed by the last meaningful path component.
# col: (d_in, d_out) with d_out model-sharded (in-projections / up-projections)
# row: (d_in, d_out) with d_in model-sharded (out-projections / down-projections)
_COL_KEYS = frozenset({
    "wq", "wk", "wv",                 # GQA / MLA / cross-attention queries
    "gate", "up", "ff_up",            # GLU MLP + sLSTM feed-forward
    "in_proj",                        # mamba input projection
    "w_dkv", "w_krope",               # MLA latent down-projections
    "w_uk", "w_uv",                   # MLA latent up-projections (raw arrays)
    "x_proj", "dt_proj",              # mamba SSM parameter projections
})
_ROW_KEYS = frozenset({
    "wo", "down", "ff_down",          # attention / MLP output projections
    "out_proj",                       # mamba / xlstm output projection
})
# MoE expert banks: (E, d_in, d_out) stacks, expert axis over ``model``
_EXPERT_KEYS = frozenset({"w_gate", "w_up", "w_down"})

Spec = Tuple[object, ...]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names and nothing else (the counterpart of
    ``jax.sharding.AbstractMesh``): enough to compute specs for a mesh no
    process group holds."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def _abstract(mesh) -> AbstractMesh:
    if isinstance(mesh, AbstractMesh):
        return mesh
    return AbstractMesh(tuple(mesh.shape), tuple(mesh.mesh_dim_names))


def batch_axes_of(mesh) -> Tuple[str, ...]:
    """The mesh's batch-parallel axes (``pod``/``data``), mesh order."""
    names = _abstract(mesh).axis_names
    return tuple(a for a in BATCH_AXES if a in names)


def to_placements(spec: Spec, device_mesh) -> list:
    """DTensor placements of ``spec`` on ``device_mesh`` (the counterpart of
    ``to_named``): per mesh dimension ``Shard(d)`` where tensor dimension d
    names it, else ``Replicate()``. A dimension over several axes needs
    them in mesh order (major first), as the reference's batch axes are:
    DTensor then splits it as a PartitionSpec does, the first axis
    outermost."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(_abstract(device_mesh).axis_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dimension {dim} are "
                             f"not in the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _axis_size(mesh: AbstractMesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _fit(dim: int, mesh: AbstractMesh, axes):
    """``axes`` if they evenly divide ``dim`` (and exist on the mesh), else
    None. ``axes`` may be a name or a tuple of names."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(a for a in axes if a in mesh.axis_names)
    if not axes:
        return None
    size = _axis_size(mesh, axes)
    if size <= 1 or dim % size:
        return None
    return axes[0] if len(axes) == 1 else axes


def _role(names: Tuple[str, ...]) -> str:
    """Last meaningful path component (skips the 'w' / factor leaf names)."""
    skip = {"w", "b_t", "a_t"}
    for name in reversed(names):
        if name not in skip:
            return name
    return names[-1] if names else ""


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _leaf_spec(names: Tuple[str, ...], shape: Tuple[int, ...],
               mesh: AbstractMesh, fsdp) -> Spec:
    """One parameter's spec from its reference path and (unstacked) shape."""
    role = _role(names)
    if role in _EXPERT_KEYS and len(shape) == 3:
        # (E, d_in, d_out): expert-parallel over model
        e, d_in, _ = shape
        return (_fit(e, mesh, MODEL_AXIS), _fit(d_in, mesh, fsdp), None)
    if role == "embed" and len(shape) == 2:
        # (vocab, d_model): vocab-sharded TP; FSDP over features
        v, d = shape
        return (_fit(v, mesh, MODEL_AXIS), _fit(d, mesh, fsdp))
    if role == "lm_head" and len(shape) == 2:
        d, v = shape
        return (_fit(d, mesh, fsdp), _fit(v, mesh, MODEL_AXIS))
    if role in _COL_KEYS and len(shape) == 2:
        d_in, d_out = shape
        # factored low-rank pairs: only the dense-facing dim is sharded
        model_dim = None if names[-1] == "b_t" else _fit(d_out, mesh, MODEL_AXIS)
        return (_fit(d_in, mesh, fsdp), model_dim)
    if role in _ROW_KEYS and len(shape) == 2:
        d_in, d_out = shape
        model_dim = None if names[-1] == "a_t" else _fit(d_in, mesh, MODEL_AXIS)
        return (model_dim, _fit(d_out, mesh, fsdp))
    # everything else (norm scales, routers, gates, conv/recurrence params,
    # positional tables, a factored expert bank — the reference's (b_t, a_t)
    # tuple, whose leaves' role is their position) is small: replicate
    return (None,) * len(shape)


def param_specs(cfg, model, mesh, *, mode: str = "train") -> Dict[str, Spec]:
    """Spec of every parameter of ``model`` (an ``LM`` or ``EncDecLM``, on
    any device, ``meta`` included), keyed by its name.

    ``mode="train"``  — FSDP over ``data`` *plus* tensor parallelism over
                        ``model`` (ZeRO-3-style fully sharded master).
    ``mode="infer"``  — tensor parallelism only; params replicated over the
                        batch axes (decode never pays FSDP all-gathers).
    """
    if mode not in ("train", "infer"):
        raise ValueError(f"param_specs: unknown mode {mode!r}")
    mesh = _abstract(mesh)
    fsdp = FSDP_AXES if mode == "train" else ()
    banks = {n for n, m in model.named_modules() if isinstance(m, ExpertBank)}
    out = {}
    for name, p in model.named_parameters():
        path, _ = _param_path(name, banks)
        out[name] = _leaf_spec(tuple(str(k) for k in path), tuple(p.shape),
                               mesh, fsdp)
    return out


def train_state_specs(cfg, state, mesh, *, strategy: str = "fsdp") -> dict:
    """Specs for a port train state ``{"model", "opt": {"m", "v", "step"},
    ["err"]}``, keyed as it is.

    ``fsdp``   — params and AdamW moments fully sharded (ZeRO-3).
    ``zero1``  — params TP-only (replicated over data), moments sharded
                 (ZeRO-1); the hoisted-cast variant (``zero1h``) uses the
                 same state specs plus an ``infer``-mode compute copy.
    """
    if strategy not in ("fsdp", "zero1", "zero1h"):
        raise ValueError(f"train_state_specs: unknown strategy {strategy!r}")
    model = state["model"]
    opt_specs = param_specs(cfg, model, mesh, mode="train")
    if strategy == "fsdp":
        p_specs = opt_specs
    else:
        p_specs = param_specs(cfg, model, mesh, mode="infer")
    out = {"model": p_specs,
           "opt": {"m": opt_specs, "v": opt_specs, "step": ()}}
    if state.get("err") is not None:
        # error-feedback residuals: an explicit leading pod axis over the
        # (pod-free) param specs
        out["err"] = {k: ("pod",) + s for k, s in p_specs.items()}
    return out


# ---------------------------------------------------------------------------
# batches and caches
# ---------------------------------------------------------------------------

def batch_specs(cfg, batch, mesh) -> Dict[str, Spec]:
    """Batch entries (tokens / frames / vision_embeds): row-sharded over the
    batch axes, features replicated."""
    mesh = _abstract(mesh)
    baxes = batch_axes_of(mesh)
    out = {}
    for k, leaf in batch.items():
        nd = getattr(leaf, "ndim", 0)
        out[k] = () if not nd else (_fit(leaf.shape[0], mesh, baxes),) + (None,) * (nd - 1)
    return out


def batch_shard(batch, mesh) -> dict:
    """This rank's rows of every entry of ``batch`` on ``mesh`` (a
    ``DeviceMesh``), as ``batch_specs`` shards them over the batch axes in
    mesh order: on a (P, D, 1) mesh rank r = pod·D + data takes rows
    r·B/(P·D) onward, the reference's pod-major split (``to_pod_major``).
    Rows that do not split evenly raise (the reference would replicate
    them)."""
    names = _abstract(mesh).axis_names
    coord = dict(zip(names, mesh.get_coordinate()))
    sizes = _abstract(mesh).shape
    idx, n = 0, 1
    for a in batch_axes_of(mesh):
        idx, n = idx * sizes[a] + coord[a], n * sizes[a]
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch entry {k!r}: {v.shape[0]} rows do not split "
                             f"over {n} ranks of {batch_axes_of(mesh)}")
        per = v.shape[0] // n
        out[k] = v[idx * per:(idx + 1) * per]
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh`` (the counterpart of
    ``jax.sharding.NamedSharding``) for a tensor whose every rank holds its
    local shard. One tensor dimension over one mesh axis is taken (the
    port's state shards only the error-feedback residuals, over ``pod``);
    more waits with FSDP's sharded storage (ROADMAP Queue 1, item 13b-2)."""

    mesh: object
    spec: Spec

    def _dim_axis(self) -> Tuple[int, str]:
        named = [(d, e) for d, e in enumerate(self.spec) if e is not None]
        if len(named) != 1 or not isinstance(named[0][1], str):
            raise ValueError(f"spec {self.spec}: only one dimension over one mesh "
                             "axis is taken (FSDP's sharded storage is ROADMAP "
                             "Queue 1, item 13b-2)")
        return named[0]

    def local(self, full):
        """This rank's shard of ``full`` (a tensor or numpy array holding
        every shard)."""
        dim, axis = self._dim_axis()
        size = _abstract(self.mesh).shape[axis]
        if full.shape[dim] % size:
            raise ValueError(f"dimension {dim} of {tuple(full.shape)} does not split "
                             f"over {axis}={size}")
        per = full.shape[dim] // size
        i = dict(zip(_abstract(self.mesh).axis_names,
                     self.mesh.get_coordinate()))[axis]
        index = (slice(None),) * dim + (slice(i * per, (i + 1) * per),)
        return full[index]

    def gather(self, local):
        """Every rank's shard concatenated on global rank 0 (a CPU tensor),
        None on the other ranks. Collective: every rank calls it; the ranks
        at coordinate 0 of every other axis send theirs over ``axis``'s
        group (gloo, host copies)."""
        dim, axis = self._dim_axis()
        names = _abstract(self.mesh).axis_names
        coord = dict(zip(names, self.mesh.get_coordinate()))
        if any(coord[a] for a in names if a != axis):
            return None
        group = self.mesh.get_group(axis)
        host = local.detach().cpu()
        n = dist.get_world_size(group)
        parts = ([torch.empty_like(host) for _ in range(n)]
                 if dist.get_rank() == 0 else None)
        dist.gather(host, parts, dst=0, group=group)
        return torch.cat(parts, dim=dim) if parts is not None else None


def to_named(specs, mesh):
    """``specs`` (nested dicts of specs) as ``NamedSharding``s on ``mesh``."""
    if isinstance(specs, dict):
        return {k: to_named(v, mesh) for k, v in specs.items()}
    return NamedSharding(mesh, tuple(specs))


def cache_specs(cfg, cache, mesh) -> List[Dict[str, Spec]]:
    """Per-layer specs of a contiguous cache (``init_contiguous_cache``, a
    list of per-layer dicts): batch-sharded rows; attention K/V
    ``(B, L, Hkv, hd)`` (and an encoder–decoder's cross ``ck``/``cv``)
    additionally shard the kv-head axis over ``model``; MLA latents
    ``(B, L, kv_lora_rank)`` keep the latent dim replicated — it is shared
    across heads by construction."""
    mesh = _abstract(mesh)
    baxes = batch_axes_of(mesh)
    out = []
    for layer in cache:
        specs = {}
        for name, leaf in layer.items():
            body = tuple(leaf.shape)
            entries = [_fit(body[0], mesh, baxes)] + [None] * (len(body) - 1)
            if name in ("k", "v", "ck", "cv") and len(body) == 4:
                entries[2] = _fit(body[2], mesh, MODEL_AXIS)   # kv-head axis
            specs[name] = tuple(entries)
        out.append(specs)
    return out
