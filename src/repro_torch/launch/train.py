"""Training launcher of the port (counterpart of ``repro/launch/train.py``):
train a model of ``--arch`` on the synthetic token pipeline, with atomic
async checkpoints and resume, on one device or on a mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \\
      --smoke --steps 50 --ckpt-dir /tmp/ckpt --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --mesh 2,2,1 --grad-compress --steps 3 --ckpt-dir /tmp/ckpt_mesh

Fault tolerance, as in the reference: every ``--ckpt-every`` steps the state
``{"params", "opt"[, "err"]}`` is saved asynchronously (host copy on this
thread, files on a background one, written to a temporary directory and
renamed, so a crash mid-write never corrupts the restore target), the last 3
kept; after a crash a rerun with the same ``--ckpt-dir`` resumes from the
newest checkpoint at the step after it, and the step-indexed pipeline replays
the same tokens, so no state beyond the checkpoint is needed. The format is
the reference's (``ckpt/checkpoint.py``): either package resumes the other's
run.

``--mesh P,D,1`` runs P·D ranks of one gloo group, rank r = pod·D + data
taking rows r·B/(P·D) onward of every global batch (``train/train_loop.py``
on a mesh): ``dist/group.run`` starts them, the caller rank 0 and every rank
on the caller's device; with ``--coordinator host:port --num-processes N
--process-id i`` this process is rank i of a group that N processes join
over TCP instead (the counterpart of ``jax.distributed.initialize``), N =
P·D. ``--grad-compress`` reduces across pods in int8 with error feedback (on
any mesh of more than one rank, one pod included, as in the reference; on
one device it does what the reference's does there, nothing). A resume may
change the data axis but not the pod count. A model axis above 1 and a mesh
on a family with an MoE layer wait with ROADMAP Queue 1, item 13b-2.

Activations are in fp32 under ``--smoke`` and in bf16 otherwise, over the
fp32 master (``train/train_loop.py::cast_for_compute``); ``--remat``
rematerializes each layer period in the backward. Runs on the GPU by default
and raises without one unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import datetime
import hashlib
import math
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.ckpt import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.dist import group
from repro_torch.dist.sharding import to_named
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models.common import CPU_CTX
from repro_torch.train import grad_compress as gc
from repro_torch.train.train_loop import (check_mesh, make_train_state,
                                          make_train_step)

MESH_AXES = ("pod", "data", "model")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mesh", default="1,1,1",
                    help="pod,data,model sizes (1,1,1 = single device; the "
                         "model size must be 1)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd", "const"])
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8+EF cross-pod gradient reduction")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--coordinator", default="",
                    help="host:port of a TCP rendezvous that --num-processes "
                         "processes join, this one as rank --process-id")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def _digest(params) -> str:
    """sha256 of every ``(name, tensor)`` pair's name and bytes, in the
    order given."""
    h = hashlib.sha256()
    for name, p in params:
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _fingerprint(model) -> str:
    """A cheap per-step fingerprint of the parameters' bits, taken on their
    device: each leaf's 32-bit patterns summed in int64, hashed."""
    ints = {4: torch.int32, 2: torch.int16}
    sums = torch.stack([p.detach().view(ints[p.element_size()]).sum(dtype=torch.int64)
                        for p in model.parameters()])
    return hashlib.sha256(sums.cpu().numpy().tobytes()).hexdigest()[:16]


def _run(args, shape, device) -> dict:
    """One rank's run (the only one without a mesh): build, restore, train,
    save. Returns the launcher's result with this rank's numbers in
    ``rank``."""
    multi = math.prod(shape) > 1
    rank = dist.get_rank() if multi else 0
    main_rank = rank == 0
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=device)
    tcfg = TrainConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                       total_steps=args.steps, schedule=args.schedule,
                       microbatches=args.microbatches, remat=args.remat,
                       grad_compress_pods=args.grad_compress,
                       compute_dtype="float32" if args.smoke else "bfloat16")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                   global_batch=args.batch), cfg, device=device)
    mesh = make_mesh(shape, MESH_AXES, device=device) if multi else None
    state = make_train_state(
        model, torch.Generator(device=device).manual_seed(tcfg.seed), tcfg)
    shardings = None
    if "err" in state and multi:
        state["err"] = gc.init_error_state(dict(model.named_parameters()), 1)
        shardings = to_named({"err": gc.error_state_specs(model)}, mesh)
    step_fn = make_train_step(model, tcfg, CPU_CTX, mesh=mesh)

    mgr = None
    start = 0
    restored_err = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        if mgr.latest_step() is not None:
            state, meta = mgr.restore(state, shardings=shardings)
            start = meta["step"] + 1
            if shardings is not None:
                restored_err = _digest(state["err"].items())
            if main_rank:
                print(f"[resume] step {meta['step']}")

    saves, step_seconds, ces, sent, reduce_s, prints, ef = [], [], [], [], [], [], []

    def save(i, blocking):
        t0 = time.perf_counter()
        mgr.save(i, state, blocking=blocking, shardings=shardings)
        saves.append({"step": i, "blocking": blocking,
                      "seconds": time.perf_counter() - t0})

    metrics = {}
    t0 = time.time()
    for i in range(start, args.steps):
        _sync(device)
        t_step = time.perf_counter()
        state, metrics = step_fn(state, pipe.get_batch(i))
        _sync(device)
        step_seconds.append(time.perf_counter() - t_step)
        ces.append(float(metrics["ce"]))
        sent.append(int(metrics.get("bytes_sent", 0)))
        reduce_s.append(float(metrics.get("reduce_seconds", 0.0)))
        if "ef_own" in metrics:
            ef.append((metrics["ef_own"], metrics["ef_sum"], metrics["ef_scale"]))
        if multi:
            prints.append(_fingerprint(model))
        if main_rank and (i % 10 == 0 or i == args.steps - 1):
            print(f"step {i:5d} ce={float(metrics['ce']):.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"({(time.time() - t0) / max(1, i - start + 1):.2f}s/step)",
                  flush=True)
        if mgr and i > start and i % args.ckpt_every == 0:
            save(i, False)
    if mgr:
        mgr.wait()
        save(args.steps - 1, True)
        if main_rank:
            for s in saves:
                s["write_seconds"] = mgr.write_seconds.get(s["step"])
    coord = dict(zip(MESH_AXES, mesh.get_coordinate())) if multi else \
        dict.fromkeys(MESH_AXES, 0)
    stats = {"rank": rank, "pod": coord["pod"], "data": coord["data"], "ce": ces,
             "step_seconds": step_seconds, "bytes_sent": sent,
             "reduce_seconds": reduce_s, "fingerprints": prints,
             "error_feedback": ef, "restored_err": restored_err,
             "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                         if device.type == "cuda" else None),
             "digest": _digest(model.named_parameters()) if multi else None}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "start": start, "ce": ces, "step_seconds": step_seconds,
            "ckpt_steps": mgr.all_steps() if mgr else [],
            "saves": saves, "rank": stats, "model": model}


def _spawned_rank(args_dict: dict, shape, device: str, pipeline_cls) -> dict:
    """Entry point of ranks 1 .. P·D-1: ``_run``'s numbers for this rank,
    on the caller's pipeline class (a stand-in set on the caller's module
    reaches a spawned rank only so)."""
    global TokenPipeline
    TokenPipeline = pipeline_cls
    return _run(argparse.Namespace(**args_dict), shape, torch.device(device))["rank"]


def _report(ranks) -> None:
    for r in ranks:
        if not r["step_seconds"]:
            continue
        sec = sorted(r["step_seconds"])[len(r["step_seconds"]) // 2]
        red = sorted(r["reduce_seconds"])[len(r["reduce_seconds"]) // 2]
        peak = "n/a" if r["peak_gb"] is None else f"{r['peak_gb']:.2f} GB"
        print(f"[rank {r['rank']}] pod {r['pod']} data {r['data']}: {sec:.3f} s a "
              f"step (median; {red:.3f} s reducing), {max(r['bytes_sent']):,} bytes "
              f"sent a step, peak {peak}", flush=True)


def main(argv=None):
    """Command-line entry point. Returns a dict with the last step's
    ``metrics`` (floats), ``start`` (the first step run: 0, or the step
    after the checkpoint resumed from), ``ce`` and ``step_seconds`` (each
    step's CE and wall seconds, from ``start`` on), ``ckpt_steps`` (the
    steps kept in ``--ckpt-dir``), ``saves`` (per save: step, whether it
    blocked, the caller's seconds and, on rank 0, the seconds its files took
    to write), ``ranks`` (every rank's numbers in rank order, with
    ``--coordinator`` this process's alone: its ``rank``, ``pod``, ``data``,
    ``ce``, ``step_seconds``, each step's ``bytes_sent`` and
    ``reduce_seconds``, ``peak_gb`` (None on the CPU), under
    ``--grad-compress`` on a mesh each step's ``error_feedback`` (its local
    identities ``(ef_own, ef_sum, ef_scale)``, ``quantized_mean``'s) and,
    after a resume, the sha256 ``restored_err`` of the residual rows the
    rank restored, and on a mesh each step's parameter ``fingerprints`` and
    the final parameters' sha256 ``digest``) and the trained ``model``."""
    ap = _parser()
    args = ap.parse_args(argv)
    try:
        shape = tuple(int(x) for x in args.mesh.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 3 or min(shape) < 1:
        ap.error(f"--mesh {args.mesh!r}: expected pod,data,model sizes")
    n = math.prod(shape)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    try:
        check_mesh(dict(zip(MESH_AXES, shape)), cfg)
    except ValueError as e:
        ap.error(f"--mesh {args.mesh} on {args.arch}: {e}")
    if args.coordinator:
        if args.num_processes != n:
            ap.error(f"--num-processes {args.num_processes} must equal the mesh's "
                     f"{n} ranks")
        if not 0 <= args.process_id < n:
            ap.error(f"--process-id {args.process_id} not in 0..{n - 1}")
    elif args.num_processes != 1 or args.process_id != 0:
        ap.error("--num-processes and --process-id need --coordinator")
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    if args.coordinator:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            "gloo", init_method=f"tcp://{args.coordinator}", rank=args.process_id,
            world_size=n, timeout=datetime.timedelta(seconds=group.TIMEOUT_S))
        try:
            res = _run(args, shape, device)
        finally:
            dist.destroy_process_group()
        ranks = [res.pop("rank")]
    elif n > 1:
        out = {}

        def rank0():
            out["res"] = _run(args, shape, device)
            return out["res"].pop("rank")

        ranks = group.run(n, _spawned_rank,
                          (vars(args), shape, str(device), TokenPipeline),
                          device=str(device), rank0=rank0)
        res = out["res"]
    else:
        res = _run(args, shape, device)
        ranks = [res.pop("rank")]
    res["ranks"] = ranks
    if n > 1:
        _report(res["ranks"])
    print("done")
    return res


if __name__ == "__main__":
    main()
