"""Compression launcher of the port (counterpart of
``repro/launch/compress.py``): pretrain a base model → evaluate its CE →
calibrate → compress with COALA or a Gram-based baseline → evaluate again.

  PYTHONPATH=src python -m repro_torch.launch.compress --arch llama3_1b \\
      --smoke --method coala --ratio 0.6 --lam 4 [--device cpu]

``--arch`` is any of ``repro_torch.configs.ARCH_IDS``; an MoE model
(deepseek_moe_16b, deepseek_v2_lite_16b) is compressed per expert, each from
the tokens routed to it, and its training loss carries the load-balance aux
term. MLA's calibration forward runs the flash kernel at head dim
nope + rope (192). qwen2_vl_2b's batches carry the pipeline's vision
prefix through pretraining, evaluation and calibration (its loss skips the
vision positions; ``vision_proj`` stays dense).

Runs on the GPU by default and raises without one unless ``--device cpu``.
Pretraining runs the dense attention path (the flash kernel has no
backward); evaluation and calibration run with ``ParallelCtx(use_pallas=
True)``, so on the card they go through the CUDA flash kernel, and the
compressed model's projections through the lowrank_linear kernel. The mesh
(sharded calibration), checkpoints, the numerics report and the trace
export wait for later slices.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import CompressConfig, TrainConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.calibrate import calibrate_model
from repro_torch.core.compress import compress_model, compression_summary
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import build_model
from repro_torch.models.common import CPU_CTX, ParallelCtx
from repro_torch.train.train_loop import make_train_state, make_train_step

CALIB_BATCH = 8          # rows per calibration batch (the TokenPipeline below)
KERNEL_CTX = ParallelCtx(use_pallas=True)
METHODS = ["coala", "svd", "svd_llm", "svd_llm_v2", "asvd"]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_pipeline(cfg, device) -> TokenPipeline:
    """The launcher's token stream: 8 x 64 tokens per step, seed 11."""
    return TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                    global_batch=CALIB_BATCH, seed=11), cfg,
                         device=device)


def eval_ce(model, pipe: TokenPipeline, *, ctx: ParallelCtx = KERNEL_CTX,
            n_batches: int = 4) -> float:
    """Mean fp32 CE over the held-out batches 1000..1000+n_batches-1."""
    with torch.no_grad():
        return float(np.mean([
            float(model.loss(b["tokens"], vision_embeds=b.get("vision_embeds"),
                             ctx=ctx, compute_dtype=torch.float32)[0])
            for b in (pipe.get_batch(1000 + i) for i in range(n_batches))]))


def main(argv=None, cfg=None):
    """Command-line entry point. Prints the JSON summary and returns a dict
    with ``summary``, ``reports``, the trained ``model``, the ``compressed``
    model, the ``calibrator``, the ``calib_batches`` ((B, T) tokens, or a
    vlm's ``{"tokens", "vision_embeds"}`` batches) and the ``seconds`` of
    each phase (pretrain, eval, calibrate, compress). ``cfg``, a
    ModelConfig, replaces the one ``--arch``/``--smoke`` name (a
    full-width configuration cut in depth, say)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--method", default="coala", choices=METHODS)
    ap.add_argument("--ratio", type=float, default=0.6)
    ap.add_argument("--lam", type=float, default=4.0)
    ap.add_argument("--mu", type=float, default=-1.0)
    ap.add_argument("--rsvd", action="store_true")
    ap.add_argument("--calib-batches", type=int, default=4)
    ap.add_argument("--pretrain-steps", type=int, default=100,
                    help="train a base model first (no public weights offline)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if cfg is None:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    seconds = {}
    model = build_model(cfg, device=device)
    pipe = make_pipeline(cfg, device)

    tcfg = TrainConfig(lr=3e-3, warmup_steps=5, total_steps=args.pretrain_steps,
                       schedule="cosine", compute_dtype="float32")
    _sync(device)
    t0 = time.perf_counter()
    state = make_train_state(model, torch.Generator(device=device).manual_seed(0))
    step = make_train_step(model, tcfg, CPU_CTX)
    for i in range(args.pretrain_steps):
        state, _ = step(state, pipe.get_batch(i))
    del state, step                      # frees the AdamW moments (~10 GB)
    _sync(device)
    seconds["pretrain"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    base_ce = eval_ce(model, pipe)
    seconds["eval"] = time.perf_counter() - t0

    # token tensors, or whole batches where they carry a vision prefix
    calib_batches = [b if "vision_embeds" in b else b["tokens"]
                     for b in (pipe.get_batch(2000 + i)
                               for i in range(args.calib_batches))]
    _sync(device)
    t0 = time.perf_counter()
    cal = calibrate_model(model, calib_batches, ctx=KERNEL_CTX)
    _sync(device)
    seconds["calibrate"] = time.perf_counter() - t0

    ccfg = CompressConfig(method=args.method, ratio=args.ratio, lam=args.lam,
                          mu=args.mu, use_rsvd=args.rsvd)
    t0 = time.perf_counter()
    cmodel, reports = compress_model(model, cal, ccfg)
    _sync(device)
    seconds["compress"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    s = compression_summary(reports)
    s.update(method=args.method, base_ce=base_ce,
             compressed_ce=eval_ce(cmodel, pipe))
    seconds["eval"] += time.perf_counter() - t0
    print(json.dumps(s, indent=1))
    return {"summary": s, "reports": reports, "model": model,
            "compressed": cmodel, "calibrator": cal,
            "calib_batches": calib_batches, "seconds": seconds}


if __name__ == "__main__":
    main()
