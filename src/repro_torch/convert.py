"""Convert between the JAX package's parameter pytree and the port's ``LM``
or ``EncDecLM``.

The JAX tree is nested dicts (and the ``prefix`` list of unrolled layers)
of numpy arrays — the caller maps ``np.asarray`` over the JAX params — with
a leading ``n_rep`` axis stacked on every ``blocks`` leaf
(``models/transformer.py:240`` of the JAX package), and an encoder–decoder's
layers stacked over their layer axis in ``enc`` and ``dec``
(``models/encdec.py:69-70`` there). Linear leaves are dense
``{"w"}``, factored ``{"b_t", "a_t"}`` or, with an adapter, all three; an MoE expert bank is a bare
(E, d_in, d_out) array or, factored per expert, the tuple ``(b_t, a_t)``;
olmo's norms are empty dicts. The port's ``state_dict`` names are the same
paths with ``/`` replaced by ``.``, the ``n_rep`` axis unstacked into
``blocks.<rep>``, prefix layers at ``prefix.<i>``, and an expert bank's
leaves under ``….w_gate.w`` (dense) or ``….w_gate.b_t`` / ``….w_gate.a_t``
(factored), so the conversion is mechanical and bit-exact both ways. The
``enc`` and ``dec`` stacks unstack into ``enc.<i>.…`` / ``dec.<i>.…`` as
``blocks`` does.

A train state ``{"model", "opt"}`` converts to the reference's ``{"params",
"opt": {"m", "v", "step"}}`` flattened as ``jax.tree_util.
tree_flatten_with_path`` flattens it (``state_to_flat``): the ``/``-joined
paths in the reference's leaf order (dict keys sorted, list and tuple
positions in order), AdamW's moments stacked as the parameters are, and
``step`` an int32 0-d array. The checkpoints of both packages are written in
that form. A bf16 leaf is held as its 2-byte bits in numpy's void dtype
``V2``, which is what ``np.load`` gives for the reference's bf16 leaves.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import STACKED, build_model
from repro_torch.models.common import NonParametricLN
from repro_torch.models.ffn import ExpertBank
from repro_torch.models.linear import Linear


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    elif isinstance(tree, tuple):            # a factored expert bank
        b_t, a_t = tree
        out[prefix + "b_t"] = np.asarray(b_t)
        out[prefix + "a_t"] = np.asarray(a_t)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def _unstack_blocks(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in flat.items():
        head, _, rest = k.partition(".")
        if head in STACKED:
            for r in range(v.shape[0]):
                out[f"{head}.{r}.{rest}"] = v[r]
        else:
            out[k] = v
    return out


def params_from_numpy(tree, cfg: ModelConfig, *, device="cuda",
                      dtype=torch.float32):
    """Build the model of ``cfg`` (``build_model``) on ``device`` holding
    the JAX tree's parameters. The MoE routers stay fp32 whatever ``dtype``
    is, as in the reference."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    flat = _unstack_blocks(flat)
    model = build_model(cfg, device=device, dtype=dtype)

    def take(key, dt=dtype):
        if key not in flat:
            raise KeyError(f"parameter {key!r} missing from the tree")
        return torch.tensor(np.asarray(flat.pop(key)), dtype=dt,
                            device=model.device)

    owners = set()
    for name, mod in model.named_modules():
        if isinstance(mod, (Linear, ExpertBank)):
            owners.add(name)
            if f"{name}.b_t" in flat and f"{name}.w" in flat:   # adapter
                mod.set_adapter(take(f"{name}.w"), take(f"{name}.b_t"),
                                take(f"{name}.a_t"))
            elif f"{name}.b_t" in flat:
                mod.set_factors(take(f"{name}.b_t"), take(f"{name}.a_t"))
            else:
                mod.set_dense(take(f"{name}.w" if isinstance(mod, Linear)
                                   else name))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[0] in owners:
                continue
            src = take(name, p.dtype)
            if src.shape != p.shape:
                raise ValueError(f"{name}: tree has {tuple(src.shape)}, "
                                 f"model {tuple(p.shape)}")
            p.copy_(src)
    if flat:
        raise KeyError(f"tree leaves without a model parameter: {sorted(flat)}")
    return model


def params_to_numpy(model):
    """Inverse of ``params_from_numpy``: the JAX-layout tree of numpy arrays."""
    def arr(p):
        return p.detach().cpu().numpy()

    leaves: Dict[str, object] = {}
    banks = set()
    for name, mod in model.named_modules():
        if isinstance(mod, ExpertBank):
            banks.add(name)
            leaves[name] = ((arr(mod.b_t), arr(mod.a_t)) if mod.is_factored
                            else arr(mod.w))
        elif isinstance(mod, NonParametricLN):
            leaves[name] = {}
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[0] not in banks:
            leaves[name] = arr(p)
    tree: dict = ({"prefix": [{} for _ in model.prefix]}
                  if hasattr(model, "prefix") else {})
    stacked: Dict[Tuple[str, str], list] = {}
    for name, leaf in leaves.items():
        parts = name.split(".")
        if parts[0] in STACKED:
            stacked.setdefault((parts[0], ".".join(parts[2:])), []).append(
                (int(parts[1]), leaf))
        elif parts[0] == "prefix":
            _put(tree["prefix"][int(parts[1])], parts[2:], leaf)
        else:
            _put(tree, parts, leaf)
    for (head, rest), items in stacked.items():
        items.sort(key=lambda it: it[0])
        _put(tree, [head] + rest.split("."),
             _stack([leaf for _, leaf in items]))
    return tree


def _stack(leaves):
    first = leaves[0]
    if isinstance(first, tuple):
        return tuple(np.stack(xs) for xs in zip(*leaves))
    if isinstance(first, dict):
        return {}
    return np.stack(leaves)


def _put(tree: dict, parts, leaf) -> None:
    node = tree
    for k in parts[:-1]:
        node = node.setdefault(k, {})
    node[parts[-1]] = leaf


# ---------------------------------------------------------------------------
# flattened trees: checkpoints and train states
# ---------------------------------------------------------------------------

BF16_BITS = np.dtype("V2")      # numpy's form of a bf16 leaf: its raw bits


def to_numpy(t: torch.Tensor, *, copy: bool = False) -> np.ndarray:
    """``t`` on the host as numpy, a bf16 tensor as its ``V2`` bits;
    ``copy`` gives storage of its own even where ``t`` is on the CPU already
    (``.cpu()`` of a CPU tensor is the tensor itself)."""
    t = t.detach().to("cpu", copy=copy)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_BITS)
    return t.numpy()


def from_numpy(a: np.ndarray) -> torch.Tensor:
    """Inverse of ``to_numpy``, on the CPU: a ``V2`` array is bf16 bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == BF16_BITS:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _param_path(name: str, banks) -> Tuple[tuple, Optional[int]]:
    """The reference's path of parameter ``name`` (a tuple of dict keys and
    list / tuple positions) and its index on the stacked axis (None where
    the reference does not stack it)."""
    owner, _, leaf = name.rpartition(".")
    parts = name.split(".")
    if owner in banks:              # an expert bank: bare array or (b_t, a_t)
        parts = parts[:-1] + ([] if leaf == "w" else [("b_t", "a_t").index(leaf)])
    if parts[0] in STACKED:
        return (parts[0],) + tuple(parts[2:]), int(parts[1])
    if parts[0] == "prefix":
        return ("prefix", int(parts[1])) + tuple(parts[2:]), None
    return tuple(parts), None


def _slots(model, tensors: Dict[str, torch.Tensor], root: tuple
           ) -> Dict[tuple, List[Tuple[Optional[int], torch.Tensor]]]:
    """{reference path under ``root``: [(stack index, tensor)]} of
    ``tensors``, keyed as ``model``'s parameters."""
    banks = {n for n, m in model.named_modules() if isinstance(m, ExpertBank)}
    out: Dict[tuple, list] = {}
    for name, t in tensors.items():
        path, rep = _param_path(name, banks)
        out.setdefault(root + path, []).append((rep, t))
    return out


def param_paths(model, root: tuple = ()) -> Dict[str, str]:
    """{parameter name: the ``/``-joined path of its leaf in the reference's
    tree under ``root``} (stacked parameters share their leaf's path)."""
    banks = {n for n, m in model.named_modules() if isinstance(m, ExpertBank)}
    return {name: _path_str(root + _param_path(name, banks)[0])
            for name, _ in model.named_parameters()}


def reference_leaves(model) -> List[List[str]]:
    """The model's parameter names grouped by the reference's leaf they
    belong to, a stacked leaf's names in stack order."""
    banks = {n for n, m in model.named_modules() if isinstance(m, ExpertBank)}
    groups: Dict[tuple, list] = {}
    for name, _ in model.named_parameters():
        path, rep = _param_path(name, banks)
        groups.setdefault(path, []).append((-1 if rep is None else rep, name))
    return [[n for _, n in sorted(v)] for v in groups.values()]


def _state_slots(state) -> Dict[tuple, list]:
    """The leaves of a port state in the reference's tree: ``{"model",
    "opt"}`` (a train state) is ``{"params", "opt": {"m", "v", "step"}}``,
    and ``{"params": model}`` is ``{"params"}``. ``step`` is a slot of its
    own, ``[(None, opt)]``. A state's ``err`` (error-feedback residuals
    keyed as the parameters, each with a leading pod axis) is the
    reference's ``err`` tree; None, as the reference's single-device state
    holds it, has no leaves."""
    model = state["model"] if "model" in state else state["params"]
    slots = _slots(model, dict(model.named_parameters()), ("params",))
    if "opt" in state:
        opt = state["opt"]
        for k in ("m", "v"):
            slots.update(_slots(model, opt[k], ("opt", k)))
        slots[("opt", "step")] = [(None, opt)]
    if state.get("err") is not None:
        slots.update(_slots(model, state["err"], ("err",)))
    return dict(sorted(slots.items()))


def _stack_axis(path: tuple) -> int:
    """The axis a stacked leaf stacks its layers on: 1 under ``err`` (after
    the pod axis), else 0."""
    return 1 if path[0] == "err" else 0


def _path_str(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def state_paths(state) -> List[str]:
    """The reference's flattened paths of ``state`` (see ``_state_slots``),
    in its leaf order."""
    return [_path_str(p) for p in _state_slots(state)]


def state_to_flat(state, *, copy: bool = False) -> Dict[str, np.ndarray]:
    """{path: numpy leaf} of a port state in the reference's leaf order: a
    stacked leaf stacked on its device first, then brought to the host
    (``to_numpy``; ``copy`` as there); ``step`` an int32 0-d array."""
    out = {}
    for path, items in _state_slots(state).items():
        key = _path_str(path)
        if path == ("opt", "step"):
            out[key] = np.asarray(items[0][1]["step"], np.int32)
        elif items[0][0] is None:                 # one leaf, not stacked
            out[key] = to_numpy(items[0][1], copy=copy)
        else:
            items.sort(key=lambda it: it[0])
            out[key] = to_numpy(torch.stack([t.detach() for _, t in items],
                                            dim=_stack_axis(path)))
    return out


@torch.no_grad()
def load_flat(state, flat: Dict[str, np.ndarray]) -> None:
    """Copy ``flat`` ({path: numpy leaf}, as ``state_to_flat`` gives) into
    ``state``'s parameters and moments in place (``copy_``, so references
    held to them stay valid); ``step`` becomes an int."""
    for path, items in _state_slots(state).items():
        key = _path_str(path)
        if path == ("opt", "step"):
            items[0][1]["step"] = int(flat[key])
            continue
        src = from_numpy(flat[key])
        for rep, t in items:
            part = src if rep is None else src.select(_stack_axis(path), rep)
            if tuple(part.shape) != tuple(t.shape):
                raise ValueError(f"{key}: leaf has {tuple(part.shape)}, "
                                 f"the state {tuple(t.shape)}")
            t.copy_(part.to(device=t.device, dtype=t.dtype))
