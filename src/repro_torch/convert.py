"""Convert between the JAX package's parameter pytree and the port's ``LM``.

The JAX tree is nested dicts (and the empty ``prefix`` list) of numpy
arrays — the caller maps ``np.asarray`` over the JAX params — with a leading
``n_rep`` axis stacked on every ``blocks`` leaf (``models/transformer.py:240``
of the JAX package). Linear leaves are dense ``{"w"}`` or factored
``{"b_t", "a_t"}``. The port's ``state_dict`` names are the same paths with
``/`` replaced by ``.`` and the ``n_rep`` axis unstacked into
``blocks.<rep>``, so the conversion is mechanical and bit-exact both ways.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import LM, build_model
from repro_torch.models.linear import Linear


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def _unstack_blocks(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in flat.items():
        if k.startswith("blocks."):
            rest = k[len("blocks."):]
            for r in range(v.shape[0]):
                out[f"blocks.{r}.{rest}"] = v[r]
        else:
            out[k] = v
    return out


def params_from_numpy(tree, cfg: ModelConfig, *, device="cuda",
                      dtype=torch.float32) -> LM:
    """Build an ``LM`` on ``device`` holding the JAX tree's parameters."""
    if tree.get("prefix"):
        raise NotImplementedError("unrolled prefix layers are not ported")
    flat = _unstack_blocks(_collect(tree))
    model = build_model(cfg, device=device, dtype=dtype)

    def take(key):
        if key not in flat:
            raise KeyError(f"parameter {key!r} missing from the tree")
        return torch.tensor(np.asarray(flat.pop(key)), dtype=dtype,
                            device=model.device)

    linears = set()
    for name, mod in model.named_modules():
        if not isinstance(mod, Linear):
            continue
        linears.add(name)
        if f"{name}.b_t" in flat:
            mod.set_factors(take(f"{name}.b_t"), take(f"{name}.a_t"))
        else:
            mod.set_dense(take(f"{name}.w"))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[0] in linears:
                continue
            src = take(name)
            if src.shape != p.shape:
                raise ValueError(f"{name}: tree has {tuple(src.shape)}, "
                                 f"model {tuple(p.shape)}")
            p.copy_(src)
    if flat:
        raise KeyError(f"tree leaves without a model parameter: {sorted(flat)}")
    return model


def _collect(tree) -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return flat


def params_to_numpy(model: LM):
    """Inverse of ``params_from_numpy``: the JAX-layout tree of numpy arrays."""
    tree: dict = {"prefix": []}
    stacked: Dict[str, list] = {}
    for name, p in model.state_dict().items():
        arr = p.detach().cpu().numpy()
        parts = name.split(".")
        if parts[0] == "blocks":
            stacked.setdefault(".".join(parts[2:]), []).append(
                (int(parts[1]), arr))
            continue
        _put(tree, parts, arr)
    for rest, items in stacked.items():
        items.sort(key=lambda it: it[0])
        _put(tree, ["blocks"] + rest.split("."),
             np.stack([a for _, a in items]))
    return tree


def _put(tree: dict, parts, arr) -> None:
    node = tree
    for k in parts[:-1]:
        node = node.setdefault(k, {})
    node[parts[-1]] = arr
