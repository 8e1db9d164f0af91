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
"""
from __future__ import annotations

from typing import Dict, Tuple

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
