#!/usr/bin/env python3
"""Pretraining xlstm_1_3b at full width (depth 8) on one card, as the
compression launcher does it, and what a diverged model costs the card's SVD.

Run from the repository root on a machine with one NVIDIA H100:

    python3 tools/torch_xlstm_train_probe.py

It prints (1) ten AdamW steps of the launcher's recipe (lr 3e-3, 5 warmup
steps, cosine, 8 x 64 tokens of its pipeline, fp32) through the sequential
mLSTM, each step's seconds, CE, gradient norm and peak memory, then which
parameters are non-finite; (2) on a fresh model, three such steps and then
three through the chunkwise-parallel mLSTM (``mlstm_chunkwise``); (3) the
seconds cuSOLVER's ``gesvd`` (``torch.linalg.svd(driver="gesvd")``) takes on
an all-NaN matrix of 256² and 512² before it raises. ``chip_smoke.py``
phase 12 pretrains fewer steps because of (1).
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (pins TF32 off)
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import compress as launcher
    from repro_torch.models import build_model
    from repro_torch.models.common import CPU_CTX, ParallelCtx
    from repro_torch.train.train_loop import make_train_state, make_train_step

    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = dataclasses.replace(get_config("xlstm_1_3b"), n_layers=8)
    pipe = launcher.make_pipeline(cfg, dev)
    tcfg = TrainConfig(lr=3e-3, warmup_steps=5, total_steps=10, schedule="cosine",
                       compute_dtype="float32")

    def train(model, plan):
        state = make_train_state(model, torch.Generator(device=dev).manual_seed(0))
        i = 0
        for label, ctx, n in plan:
            step = make_train_step(model, tcfg, ctx)
            for _ in range(n):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                state, m = step(state, pipe.get_batch(i))
                torch.cuda.synchronize()
                print(f"{label} step {i}: {time.perf_counter() - t0:.2f} s, ce "
                      f"{float(m['ce']):.4f}, grad_norm {float(m['grad_norm']):.6g}, "
                      f"lr {float(m['lr']):.6g}, peak "
                      f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB", flush=True)
                i += 1
        bad = [n for n, p in model.named_parameters() if not torch.isfinite(p).all()]
        print(f"non-finite parameters: {len(bad)} {bad[:4]}", flush=True)

    print("(1) sequential mLSTM, 10 steps", flush=True)
    train(build_model(cfg, device=dev), [("sequential", CPU_CTX, 10)])
    torch.cuda.empty_cache()
    print("(2) 3 sequential steps, then 3 chunkwise", flush=True)
    train(build_model(cfg, device=dev),
          [("sequential", CPU_CTX, 3),
           ("chunkwise", ParallelCtx(mlstm_chunkwise=True), 3)])
    torch.cuda.empty_cache()
    print("(3) gesvd on an all-NaN matrix", flush=True)
    for n in (256, 512):
        a = torch.full((n, n), float("nan"), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            torch.linalg.svd(a, full_matrices=False, driver="gesvd")
            outcome = "returned"
        except RuntimeError as e:
            outcome = f"raised {type(e).__name__}"
        torch.cuda.synchronize()
        print(f"gesvd of a NaN {n}x{n}: {time.perf_counter() - t0:.2f} s, {outcome}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
