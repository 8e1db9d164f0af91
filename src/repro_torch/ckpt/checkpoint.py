"""Atomic, async, keep-k checkpoints (port of ``repro/ckpt/checkpoint.py``),
in the reference's on-disk format, so that either package restores what the
other saved.

Layout:    ``<dir>/step_<N>/manifest.json`` + ``leaf_<i>.npy``, the leaves in
the order of the reference's ``jax.tree_util.tree_flatten_with_path`` and the
manifest holding ``step``, their ``/``-joined ``paths``, ``shapes`` and
``dtypes`` (``convert.state_to_flat`` gives the port's state in that form).
Atomicity: each save is written to ``<dir>/.tmp_step_<N>`` and then
``os.rename``d, so a crash mid-write never leaves a step that ``all_steps``
lists.
Async:     ``save(..., blocking=False)`` takes a host copy of every leaf on
the caller's thread and writes the files on a background thread, one save in
flight at a time. The copy has to be taken there: the port's AdamW updates
the parameters and moments in place, and on the CPU ``t.cpu()`` is ``t``
itself, so a writer handed the live tensors would write a step that the next
one is changing (the reference's arrays are immutable).
bf16:      a bf16 leaf is written as the reference's numpy writes an
``ml_dtypes.bfloat16`` array: its 2-byte bits under the descriptor ``<V2``,
the manifest saying ``bfloat16``; ``restore`` reads it by that dtype.

Ranks:     in a process group of several ranks ``save`` and ``restore`` are
collective. The port's train state is replicated but for the error-feedback
residuals ``err``, which ``shardings`` (``dist/sharding.py::NamedSharding``
per residual, over ``pod``) marks: each rank holds its pod's row. ``save``
gathers those rows on rank 0, which alone writes, the residual whole as
``(n_pods, ...)`` in the reference's format; the other ranks wait at a
barrier (after rank 0's host copy for an async save, after its files for a
blocking one). ``restore(..., shardings=)`` is the reference's elastic
reshard: every rank reads the files and keeps its shard, so the data axis
may change between a save and a restore. The pod count may not: a
residual's rows belong to their pods.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch.distributed as dist

from repro_torch import convert
from repro_torch.obs import trace


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == convert.BF16_BITS else str(a.dtype)


def _save_leaf(path: str, a: np.ndarray) -> None:
    if a.dtype != convert.BF16_BITS:
        np.save(path, a)
        return
    # np.save of the bits would say "|V2"; the reference's file says "<V2"
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
        f.write(np.ascontiguousarray(a).tobytes())


def _load_leaf(path: str, dtype: str) -> np.ndarray:
    a = np.load(path)
    if dtype == "bfloat16":
        return a.view(convert.BF16_BITS)
    if str(a.dtype) != dtype:
        raise ValueError(f"{path}: {a.dtype}, the manifest says {dtype}")
    return a


def _ranks() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _reshard_err(flat: Dict[str, np.ndarray], state_like, shardings) -> None:
    """Each stored residual ``(n_pods, ...)`` in ``flat`` replaced by this
    rank's shard of it. The pod count of the store and of the mesh must be
    the same."""
    paths = {}
    for name, path in convert.param_paths(state_like["model"], ("err",)).items():
        paths.setdefault(path, []).append(name)
    for path, names in paths.items():
        sh = shardings[names[0]]
        n = dict(zip(sh.mesh.mesh_dim_names, sh.mesh.shape))["pod"]
        if flat[path].shape[0] != n:
            raise ValueError(
                f"{path}: the checkpoint holds the residuals of {flat[path].shape[0]} "
                f"pods, the mesh has {n}: a restore may change the data axis but "
                "not the pod count (each pod's error-feedback residual is its own)")
        flat[path] = sh.local(flat[path])


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        # seconds each save took to write its files, by step (the host copy
        # of an async save is the caller's, not counted here)
        self.write_seconds: Dict[int, float] = {}

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, *, blocking: bool = True,
             extra_meta: Optional[Dict[str, Any]] = None, shardings=None):
        """Save ``state``, a port train state ``{"model", "opt"[, "err"]}`` or
        ``{"params": model}`` (``convert.state_to_flat``), as step ``step``.
        Returns once the host copy is taken (``blocking=False``) or the files
        are in place. In a group of several ranks every rank calls it:
        ``shardings`` (``{"err": {name: NamedSharding}}``) names the leaves
        each rank holds a shard of, gathered on rank 0, which writes."""
        ranks = _ranks()
        if shardings is not None and state.get("err") is not None:
            full = {k: shardings["err"][k].gather(e) for k, e in state["err"].items()}
            state = dict(state, err=full)
        if ranks > 1 and dist.get_rank() != 0:
            dist.barrier()
            return
        self._save(step, state, blocking, extra_meta)
        if ranks > 1:
            dist.barrier()

    def _save(self, step, state, blocking, extra_meta):
        flat = convert.state_to_flat(state, copy=True)
        paths, host_leaves = list(flat), list(flat.values())
        meta = {"step": int(step), "paths": paths,
                "shapes": [list(x.shape) for x in host_leaves],
                "dtypes": [_dtype_name(x) for x in host_leaves]}
        if extra_meta:
            meta.update(extra_meta)

        def write():
            t0 = time.perf_counter()
            # the tracer is thread-safe: an async save records this span
            # from the background thread (its own tid lane in the trace)
            with trace.span("ckpt.save", step=int(step),
                            leaves=len(host_leaves),
                            blocking=bool(blocking)):
                tmp = os.path.join(self.dir, f".tmp_step_{step}")
                final = os.path.join(self.dir, f"step_{step}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                for i, arr in enumerate(host_leaves):
                    _save_leaf(os.path.join(tmp, f"leaf_{i}.npy"), arr)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(meta, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._prune()
            self.write_seconds[int(step)] = time.perf_counter() - t0

        self.wait()                      # one in-flight async save at a time
        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _prune(self):
        steps = sorted(self.all_steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                out.append(int(name.split("_", 1)[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: Optional[int] = None, shardings=None):
        """Restore step ``step`` (None: the latest) into ``state_like``, a
        port state as ``save`` takes it, in place: every parameter and moment
        is ``copy_``'d into, so references held to them (an optimizer's, a
        caller's) stay valid. ``shardings`` (``{"err": {name:
        NamedSharding}}``, as ``save`` takes it) gives each residual this
        rank's shard of the stored whole, on the mesh it names: the
        reference's elastic reshard. Returns ``(state_like, manifest)``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with trace.span("ckpt.restore", step=int(step)):
            d = os.path.join(self.dir, f"step_{step}")
            with open(os.path.join(d, "manifest.json")) as f:
                meta = json.load(f)
            paths = convert.state_paths(state_like)
            assert paths == meta["paths"], "checkpoint/tree structure mismatch"
            flat = {p: _load_leaf(os.path.join(d, f"leaf_{i}.npy"),
                                  meta["dtypes"][i])
                    for i, p in enumerate(paths)}
            if shardings is not None and state_like.get("err") is not None:
                _reshard_err(flat, state_like, shardings["err"])
            convert.load_flat(state_like, flat)
        return state_like, meta
