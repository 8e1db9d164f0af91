"""Training launcher of the port (counterpart of ``repro/launch/train.py``):
train a model of ``--arch`` on the synthetic token pipeline, with atomic
async checkpoints and resume, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \\
      --smoke --steps 50 --ckpt-dir /tmp/ckpt --device cpu

Fault tolerance, as in the reference: every ``--ckpt-every`` steps the state
``{"params", "opt"}`` is saved asynchronously (host copy on this thread,
files on a background one, written to a temporary directory and renamed, so
a crash mid-write never corrupts the restore target), the last 3 kept; after
a crash a rerun with the same ``--ckpt-dir`` resumes from the newest
checkpoint at the step after it, and the step-indexed pipeline replays the
same tokens, so no state beyond the checkpoint is needed. The format is the
reference's (``ckpt/checkpoint.py``): either package resumes the other's
run.

Activations are in fp32 under ``--smoke`` and in bf16 otherwise, over the
fp32 master (``train/train_loop.py::cast_for_compute``); ``--remat``
rematerializes each layer period in the backward. Runs on the GPU by default
and raises without one unless ``--device cpu``. Only ``--mesh 1,1,1`` is
taken: a multi-device mesh and ``--coordinator`` are the distributed slice's
(ROADMAP Queue 1, item 13); on one device ``--grad-compress`` does what the
reference's does there, nothing (it adds error state only on a mesh of more
than one device).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.ckpt import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import build_model
from repro_torch.models.common import CPU_CTX
from repro_torch.train.train_loop import make_train_state, make_train_step


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Command-line entry point. Returns a dict with the last step's
    ``metrics`` (floats), ``start`` (the first step run: 0, or the step
    after the checkpoint resumed from), ``ce`` and ``step_seconds`` (each
    step's CE and wall seconds, from ``start`` on), ``ckpt_steps`` (the steps kept in ``--ckpt-dir``),
    ``saves`` (per save: step, whether it blocked, the caller's seconds and
    the seconds its files took to write) and the trained ``model``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mesh", default="1,1,1",
                    help="pod,data,model sizes (only 1,1,1, a single device)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd", "const"])
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8+EF cross-pod gradient reduction (a no-op on "
                         "one device, as in the reference)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--coordinator", default="",
                    help="host:port for multi-host initialization (not "
                         "ported: the distributed slice)")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    try:
        shape = tuple(int(x) for x in args.mesh.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 3:
        ap.error(f"--mesh {args.mesh!r}: expected pod,data,model sizes")
    if shape != (1, 1, 1) or args.coordinator or args.num_processes > 1:
        ap.error("only --mesh 1,1,1 on one process is ported; a multi-device "
                 "mesh and --coordinator are the distributed slice's "
                 "(ROADMAP Queue 1, item 13)")
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=device)
    tcfg = TrainConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                       total_steps=args.steps, schedule=args.schedule,
                       microbatches=args.microbatches, remat=args.remat,
                       grad_compress_pods=args.grad_compress,
                       compute_dtype="float32" if args.smoke else "bfloat16")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch), cfg,
                         device=device)
    state = make_train_state(
        model, torch.Generator(device=device).manual_seed(tcfg.seed))
    step_fn = make_train_step(model, tcfg, CPU_CTX)

    mgr = None
    start = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        if mgr.latest_step() is not None:
            state, meta = mgr.restore(state)
            start = meta["step"] + 1
            print(f"[resume] step {meta['step']}")

    saves, step_seconds, ces = [], [], []

    def save(i, blocking):
        t0 = time.perf_counter()
        mgr.save(i, state, blocking=blocking)
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
        if i % 10 == 0 or i == args.steps - 1:
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
        for s in saves:
            s["write_seconds"] = mgr.write_seconds.get(s["step"])
    print("done")
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "start": start, "ce": ces, "step_seconds": step_seconds,
            "ckpt_steps": mgr.all_steps() if mgr else [],
            "saves": saves, "model": model}


if __name__ == "__main__":
    main()
