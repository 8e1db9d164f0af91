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
vision positions; ``vision_proj`` stays dense). xlstm_1_3b pretrains through
its recurrences (checkpointed per chunk under autograd); its targets are
the reference's compressible projections (mLSTM's up, wq, wk, wv, down and
sLSTM's ff_up, ff_down), the gates and recurrences stay dense.
jamba_v0_1_52b pretrains through its Mamba scans (checkpointed per chunk)
and its MoE; its targets are Mamba's in_proj and out_proj (x_proj, dt_proj
and the SSM parameters stay dense), the attention and MLP projections, and
every expert.
whisper_base's batches carry the pipeline's ``frames`` through pretraining,
evaluation and calibration; its targets are the 16 projections of every
encoder and decoder layer (the cross ``wk``/``wv`` calibrated on the encoder
outputs).

Runs on the GPU by default and raises without one unless ``--device cpu``.
Pretraining runs the dense attention path (the flash kernel has no
backward); evaluation and calibration run with ``ParallelCtx(use_pallas=
True)``, so on the card they go through the CUDA flash kernel, and the
compressed model's projections through the lowrank_linear kernel.

``--ckpt-in DIR`` restores the newest train state ``{"params", "opt"}`` of
DIR (``launch/train.py``'s, or the reference's: the format is shared) in
place of pretraining; ``--ckpt-out DIR`` saves ``{"params"}`` of the
compressed model as step 0; ``--numerics-report`` prints the calibration's
and the compression's per-layer health (``obs/numerics.py``);
``--trace-out PATH`` writes the span trace of the run (calibration,
compression and the ``ckpt.*`` spans).

``--mesh data=N`` shards calibration rows over N ranks of a gloo group
(``dist/group.py``; N a power of two dividing the calibration batch of 8):
the caller is rank 0 and keeps pretraining (or ``--ckpt-in``), evaluation
and compression; ranks 1 .. N-1 are spawned processes on the same device
that receive the trained weights through host shared memory, capture their
shard of every batch through the flash kernel and reduce the per-rank R
factors with the butterfly TSQR (``dist/calibrate.py``). X is never formed
either way. The reference's ``_peek_mesh`` has no counterpart: JAX fixes its
fake-device count at import, a process group is made when it is needed.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ckpt import CheckpointManager
from repro_torch.config import CompressConfig, TrainConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.calibrate import calibrate_model
from repro_torch.core.compress import compress_model, compression_summary
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.dist import group
from repro_torch.dist.calibrate import calibrate_sharded
from repro_torch.kernels import _build, ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models.common import CPU_CTX, ParallelCtx
from repro_torch.obs import numerics, trace as obs_trace
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


def _extras(batch) -> dict:
    """A pipeline batch's model inputs beside the tokens (a vlm's
    ``vision_embeds``, an encoder–decoder's ``frames``)."""
    return {k: v for k, v in batch.items() if k != "tokens"}


def eval_ce(model, pipe: TokenPipeline, *, ctx: ParallelCtx = KERNEL_CTX,
            n_batches: int = 4) -> float:
    """Mean fp32 CE over the held-out batches 1000..1000+n_batches-1."""
    with torch.no_grad():
        return float(np.mean([
            float(model.loss(b["tokens"], ctx=ctx, compute_dtype=torch.float32,
                             **_extras(b))[0])
            for b in (pipe.get_batch(1000 + i) for i in range(n_batches))]))


def _parse_mesh(ap, value: str) -> int:
    """The shard count of ``--mesh data=N``; refuses anything else with the
    reference's messages (before any pretraining)."""
    out = {}
    for part in value.split(","):
        if "=" in part:
            name, _, size = part.partition("=")
            try:
                out[name.strip()] = int(size)
            except ValueError:
                pass
    if not out or set(out) != {"data"}:
        ap.error(f"--mesh {value!r} not understood; expected "
                 f"'data=N' (calibration shards over the data axis)")
    n_shards = out["data"]
    if n_shards < 1 or n_shards & (n_shards - 1):
        ap.error(f"--mesh data={n_shards}: shard count must be a power "
                 f"of two (butterfly TSQR pairing)")
    if CALIB_BATCH % n_shards:
        ap.error(f"--mesh data={n_shards}: must divide the calibration "
                 f"batch of {CALIB_BATCH} rows")
    return n_shards


def _to(batch, device):
    if isinstance(batch, dict):
        return {k: v.to(device) for k, v in batch.items()}
    return batch.to(device)


def _calibrate_rank(model, batches, n_shards: int):
    """One rank's part of ``--mesh data=N``: its shard of ``batches``
    through ``calibrate_sharded`` on a (N,) ``data`` mesh. Returns the
    calibration and this rank's numbers: calibration seconds (and the
    capture / reduce split), flash launches, peak device memory (GB, through
    the calibration; None on the CPU), bytes its butterfly sent, and a
    digest of its R factors (every rank must hold the same bits)."""
    device = model.device
    flash0 = ops.launch_counts()["flash_attention"]
    _sync(device)
    t0 = time.perf_counter()
    mesh = make_mesh((n_shards,), ("data",), device=device)
    cal = calibrate_sharded(model, [_to(b, device) for b in batches], mesh,
                            axis="data", ctx=KERNEL_CTX)
    _sync(device)
    digest = hashlib.sha256()
    for path, r in cal.factors.items():
        digest.update(path.encode())
        digest.update(r.detach().cpu().contiguous().numpy().tobytes())
    stats = {"rank": torch.distributed.get_rank(),
             "seconds": time.perf_counter() - t0, **cal.seconds,
             "bytes_sent": cal.bytes_sent,
             "flash_launches": ops.launch_counts()["flash_attention"] - flash0,
             "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                         if device.type == "cuda" else None),
             "r_digest": digest.hexdigest()}
    return cal, stats


def _calibrate_spawned(cfg, weights, batches, n_shards: int, device: str,
                       t_spawn: float):
    """Entry point of ranks 1 .. N-1: the caller's model rebuilt on
    ``device`` from its weights, then ``_calibrate_rank``; returns the
    rank's numbers, with ``start_s`` (from the caller's spawn, ``t_spawn``
    on the wall clock, to here: the process's start, its imports and its
    arguments) and ``load_s`` (the model built and loaded)."""
    t0 = time.time()
    model = build_model(cfg, device=device)
    model.load_state_dict(weights)
    del weights
    t1 = time.time()
    stats = _calibrate_rank(model, batches, n_shards)[1]
    return dict(stats, start_s=t0 - t_spawn, load_s=t1 - t0)


def calibrate_on_mesh(model, cfg, batches, n_shards: int):
    """``--mesh data=N``: ``calibrate_sharded`` on N ranks, the caller rank
    0 with ``model`` and the others spawned on the model's device. Returns
    rank 0's ``ShardedCalibration`` and every rank's numbers, rank order."""
    device = model.device
    if device.type == "cuda":
        _build.build()             # built once here, found by every rank
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    host_batches = [_to(b, "cpu") for b in batches]
    cal = {}

    def rank0():
        cal["out"], stats = _calibrate_rank(model, batches, n_shards)
        return dict(stats, start_s=0.0, load_s=0.0)

    stats = group.run(n_shards, _calibrate_spawned,
                      (cfg, weights, host_batches, n_shards, str(device), time.time()),
                      device=str(device), rank0=rank0)
    return cal["out"], stats


def main(argv=None, cfg=None):
    """Command-line entry point. Prints the JSON summary and returns a dict
    with ``summary``, ``reports``, the trained ``model``, the ``compressed``
    model, the ``calibrator``, the ``calib_batches`` ((B, T) tokens, or a
    vlm's ``{"tokens", "vision_embeds"}`` and an encoder–decoder's
    ``{"tokens", "frames"}`` batches) and the ``seconds`` of
    each phase (pretrain, eval, calibrate, compress, and ``ckpt_out`` with
    ``--ckpt-out``); with ``--ckpt-in`` also ``ckpt_step``, the step it
    restored. ``cfg``, a
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
    ap.add_argument("--ckpt-in", default="", help="restore base model instead")
    ap.add_argument("--ckpt-out", default="")
    ap.add_argument("--numerics-report", action="store_true",
                    help="print per-layer numerical health after "
                         "calibration: cond(R) with warn/fail grading, "
                         "insufficient-data flags, and achieved residual "
                         "vs. the attainable bound (obs/numerics.py)")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome/Perfetto trace_event JSON of the "
                         "calibration/compression spans to this path")
    ap.add_argument("--mesh", default="",
                    help="shard calibration rows, e.g. 'data=4': N ranks of "
                         "a gloo group on the same device, N a power of two "
                         "dividing the calibration batch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    n_shards = _parse_mesh(ap, args.mesh) if args.mesh else 1
    device = resolve_device(args.device)
    if args.trace_out:
        obs_trace.enable()

    if cfg is None:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    seconds = {}
    model = build_model(cfg, device=device)
    pipe = make_pipeline(cfg, device)

    # remat none where the reference keeps TrainConfig's dots: the modes
    # give the same bits, the batch's activations are small, and on the card
    # a dots step costs 3-5x (its selective checkpoint dispatches in Python)
    tcfg = TrainConfig(lr=3e-3, warmup_steps=5, total_steps=args.pretrain_steps,
                       schedule="cosine", compute_dtype="float32", remat="none")
    _sync(device)
    t0 = time.perf_counter()
    state = make_train_state(model, torch.Generator(device=device).manual_seed(0))
    if args.ckpt_in:
        _, meta = CheckpointManager(args.ckpt_in).restore(state)
        ckpt_step = meta["step"]
        print(f"restored step {ckpt_step} from {args.ckpt_in}")
    else:
        step = make_train_step(model, tcfg, CPU_CTX)
        for i in range(args.pretrain_steps):
            state, _ = step(state, pipe.get_batch(i))
        del step
    del state                            # frees the AdamW moments (~10 GB)
    _sync(device)
    seconds["pretrain"] = 0.0 if args.ckpt_in else time.perf_counter() - t0

    t0 = time.perf_counter()
    base_ce = eval_ce(model, pipe)
    seconds["eval"] = time.perf_counter() - t0

    # token tensors, or whole batches where they carry other model inputs
    calib_batches = [b if _extras(b) else b["tokens"]
                     for b in (pipe.get_batch(2000 + i)
                               for i in range(args.calib_batches))]
    _sync(device)
    t0 = time.perf_counter()
    ranks = None
    if n_shards > 1:
        cal, ranks = calibrate_on_mesh(model, cfg, calib_batches, n_shards)
        print(f"# sharded calibration: data={n_shards} (butterfly TSQR reduce)")
    else:
        cal = calibrate_model(model, calib_batches, ctx=KERNEL_CTX)
    _sync(device)
    seconds["calibrate"] = time.perf_counter() - t0
    if args.numerics_report:
        print("# calibration numerics")
        print(numerics.format_report(numerics.check_calibration(cal)))

    ccfg = CompressConfig(method=args.method, ratio=args.ratio, lam=args.lam,
                          mu=args.mu, use_rsvd=args.rsvd)
    t0 = time.perf_counter()
    cmodel, reports = compress_model(model, cal, ccfg)
    _sync(device)
    seconds["compress"] = time.perf_counter() - t0
    if args.numerics_report:
        print("# projection residual vs attainable bound")
        print(numerics.format_report(numerics.check_compression(reports)))

    t0 = time.perf_counter()
    s = compression_summary(reports)
    s.update(method=args.method, base_ce=base_ce,
             compressed_ce=eval_ce(cmodel, pipe))
    seconds["eval"] += time.perf_counter() - t0
    print(json.dumps(s, indent=1))
    if args.ckpt_out:
        t0 = time.perf_counter()
        CheckpointManager(args.ckpt_out).save(0, {"params": cmodel})
        seconds["ckpt_out"] = time.perf_counter() - t0
        print("saved to", args.ckpt_out)
    if args.trace_out:
        n = obs_trace.save(args.trace_out)
        obs_trace.disable()
        print(f"wrote {n} trace events to {args.trace_out}")
    out = {"summary": s, "reports": reports, "model": model,
           "compressed": cmodel, "calibrator": cal,
           "calib_batches": calib_batches, "seconds": seconds}
    if args.ckpt_in:
        out["ckpt_step"] = ckpt_step
    if ranks is not None:
        out["ranks"] = ranks
    return out


if __name__ == "__main__":
    main()
