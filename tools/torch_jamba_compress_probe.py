#!/usr/bin/env python3
"""What a full COALA compression of jamba_v0_1_52b would cost on one CUDA
card, measured on the part of it that ``chip_smoke.py`` phase 14 leaves out.

jamba_v0_1_52b at full width, depth 8 (its smallest), bf16 weights from a
seeded ``torch.Generator`` (13.30 G parameters), calibrated on 2 x 8 x 256
seeded tokens as phase 14 calibrates it (fp32 activations, the flash kernel
for layer 4). Then ``compress_model`` (coala, ratio 0.6, λ 4, μ from Eq. 5)
on a calibrator holding only two layers' FFN streams:

1. layer 1's MoE: 16 experts x (w_gate, w_up, w_down), 48 per-expert solves
   of 4096 x 14336 weights, each from its routed tokens' R;
2. layer 0's dense gated MLP: gate, up, down (4096 x 14336, 14336 x 4096).

Every solve (``core.compress._solve``: COALA's SVDs) and every attainable-
error bound (``theory.optimal_weighted_error``: one ``svdvals``) is timed
with the card synchronised around it. Then layer 1's first routed ``down``
expert is solved again with ``use_rsvd=True`` (oversampling 8, two power
iterations) beside the full solve: seconds and weighted error of each.

From the two layers' seconds it prints the computed time of the FFN part of
a whole depth-8 compression (4 MoE layers x 48 expert projections, 4 dense
MLPs x 3), beside which the 18 mixer projections take phase 14's own
seconds.

Run from the repository root on a machine with one CUDA card:

    python3 tools/torch_jamba_compress_probe.py

Prints one line per reading and, last, a JSON object of all of them.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SEED = 0
MOE_LAYER, MLP_LAYER = "blocks/0/sub1/ffn", "blocks/0/sub0/ffn"
N_MOE_LAYERS, N_MLP_LAYERS = 4, 4          # at depth 8: the odd / even layers


def log(*a):
    print(*a, flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_jamba_compress_probe: no CUDA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (pins TF32 off)
    from repro_torch.config import CompressConfig
    from repro_torch.configs import get_config
    from repro_torch.core import compress as cm
    from repro_torch.core.calibrate import Calibrator, calibrate_model
    from repro_torch.launch.serve import calibration_batches
    from repro_torch.models import build_model
    from repro_torch.models.common import ParallelCtx

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}")
    res = {"card": smi}
    cfg = dataclasses.replace(get_config("jamba_v0_1_52b"), n_layers=8)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16).init(
        torch.Generator(device="cuda").manual_seed(SEED))
    batches = calibration_batches(cfg, n_batches=2, batch=8, seq_len=256, seed=SEED,
                                  device=model.device)
    cal = calibrate_model(model, batches, ctx=ParallelCtx(use_pallas=True))
    torch.cuda.synchronize()
    res["setup_s"] = time.perf_counter() - t0
    keep = [p for p in cal.streams if p.startswith((MOE_LAYER + "/", MLP_LAYER + "/"))
            and "/mixer/" not in p]
    for p in [p for p in cal.streams if p not in keep]:
        del cal.streams[p]
    res["streams"] = len(keep)
    res["tokens_per_expert"] = {p.split("/")[-2]: n for p, n in cal.tokens_seen().items()
                                if p.endswith("/in") and p.startswith(MOE_LAYER)}
    log(f"init + calibration {res['setup_s']:.2f} s; kept {len(keep)} streams of "
        f"{MOE_LAYER} and {MLP_LAYER}; routed tokens per expert {res['tokens_per_expert']}")

    times = collections.defaultdict(list)     # (what, W's shape) -> seconds

    def timed(what, fn):
        def call(w_mat, *a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(w_mat, *a, **kw)
            torch.cuda.synchronize()
            times[(what, f"{w_mat.shape[0]}x{w_mat.shape[1]}")].append(
                time.perf_counter() - t)
            return out
        return call

    ccfg = CompressConfig(method="coala", ratio=0.6, lam=4.0, mu=-1.0)
    t0 = time.perf_counter()
    copy.deepcopy(model)                    # compress_model's copy, timed alone
    torch.cuda.synchronize()
    res["model_copy_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    solve, bound = cm._solve, cm.optimal_weighted_error
    for label, prefix in (("moe", MOE_LAYER), ("mlp", MLP_LAYER)):
        sub = Calibrator()
        sub.streams = {p: st for p, st in cal.streams.items() if p.startswith(prefix + "/")}
        times.clear()
        cm._solve, cm.optimal_weighted_error = timed("solve", solve), timed("bound", bound)
        try:
            t0 = time.perf_counter()
            compressed, reports = cm.compress_model(model, sub, ccfg)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            cm._solve, cm.optimal_weighted_error = solve, bound
        bad = sum(not (r.rel_err_weighted == r.rel_err_weighted) for r in reports)
        del compressed
        torch.cuda.empty_cache()
        res[label] = {"seconds": secs, "projections": len(reports), "nonfinite": bad,
                      "per_projection_s": (secs - res["model_copy_s"]) / len(reports),
                      "timed": {f"{w} {sh}": dict(n=len(v), mean_s=sum(v) / len(v),
                                                   max_s=max(v))
                                for (w, sh), v in times.items()}}
        log(f"{label} ({prefix}): compress_model on {len(reports)} projections in "
            f"{secs:.2f} s (the model's copy {res['model_copy_s']:.2f} s of it): "
            f"{res[label]['per_projection_s']:.3f} s a projection, {bad} non-finite")
        for k, v in res[label]["timed"].items():
            log(f"  {k}: {v['n']} calls, mean {v['mean_s']:.3f} s, max {v['max_s']:.3f} s")

    # one down expert: the randomized solve beside the full one
    rf_path = next(p for p in cal.streams if p.startswith(MOE_LAYER) and p.endswith("/hid"))
    e = int(rf_path.split("/")[-2][len("expert"):])
    w_mat = model.blocks[0]["sub1"].ffn.w_down.w[e].T.float().detach()
    rf = cal.r_factors()[rf_path].float()
    rank = cm._rank(w_mat.shape[1], w_mat.shape[0], ccfg)
    den = torch.linalg.norm(w_mat @ rf.T)
    rs = {}
    for label, cc in (("full", ccfg), ("rsvd", dataclasses.replace(ccfg, use_rsvd=True))):
        best = None
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            a, b, mu = cm._solve(w_mat, rf, rank, cc)
            torch.cuda.synchronize()
            best = min(best or float("inf"), time.perf_counter() - t)
        err = float(torch.linalg.norm((w_mat - a @ b) @ rf.T) / den)
        rs[label] = {"seconds": best, "rel_err_weighted": err, "mu": float(mu)}
    res["down_expert"] = dict(rs, path=rf_path, shape=list(w_mat.shape), rank=rank,
                              tokens=cal.tokens_seen()[rf_path])
    log(f"{rf_path} (W {w_mat.shape[0]}x{w_mat.shape[1]}, rank {rank}, "
        f"{res['down_expert']['tokens']} tokens), best of two: full solve "
        f"{rs['full']['seconds']:.3f} s, weighted error {rs['full']['rel_err_weighted']:.6f}; "
        f"rsvd {rs['rsvd']['seconds']:.3f} s, weighted error "
        f"{rs['rsvd']['rel_err_weighted']:.6f}")
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # computed: the FFN part of a whole depth-8 compression from these times
    ffn = (N_MOE_LAYERS * (res["moe"]["seconds"] - res["model_copy_s"])
           + N_MLP_LAYERS * (res["mlp"]["seconds"] - res["model_copy_s"]))
    res["computed_ffn_s"] = ffn
    log(f"computed: the FFN projections of a depth-8 compression ({N_MOE_LAYERS} MoE "
        f"layers x 48 expert projections, {N_MLP_LAYERS} MLPs x 3) would take {ffn:.1f} s "
        f"({ffn / 60:.1f} min) beside the 18 mixer projections; peak {res['peak_gb']:.2f} GB")
    log(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
