#!/usr/bin/env python3
"""cuSOLVER's two SVD drivers on the port's compression solves, on a CUDA
card: what each costs inside ``compress_model`` and how close each comes to
COALA's attainable weighted error. ``repro_torch.core.coala.svd``/``svdvals``
pass ``driver="gesvd"`` for a CUDA tensor; PyTorch's default there is the
Jacobi ``gesvdj``.

1. llama3_1b at full width, depth 4, trained and calibrated by the compress
   launcher as ``chip_smoke.py`` phase 5 runs it: for each of block 0's
   seven linears, ||(W − U_r U_rᵀ W) Rᵀ||_F with U_r from each driver,
   beside the optimum from W Rᵀ's fp64 singular values and fp32's floor
   eps₃₂ · σ_max · √min(m, n); then ``compress_model`` (coala, ratio 0.6,
   λ 4) on that model and calibrator once under each driver, every
   ``torch.linalg.svd``/``svdvals`` call timed with the card synchronised
   around it and summed by function, shape and whether its input has full
   rank at fp32's resolution (σ_min > σ_max · eps₃₂ · max(m, n)).
2. deepseek_moe_16b at full width, depth 2, trained and calibrated by the
   compress launcher as phase 9 runs it; ``compress_model`` as in 1.
3. The routed expert with the median token count: its W Rᵀ (rank at most
   its routed tokens, R being padded to d_in rows) beside a random matrix
   of the same shape, full rank and of the same rank: svd and svdvals under
   each driver, best of three.

Run from the repository root on a machine with one CUDA card:

    python3 tools/torch_svd_probe.py

Prints one line per reading and, last, a JSON object of all of them.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

DRIVERS = ("gesvd", None)          # None: PyTorch's default (gesvdj on CUDA)
ARGS = ["--ratio", "0.6", "--lam", "4", "--calib-batches", "4", "--device", "cuda",
        "--method", "coala"]


def name(driver) -> str:
    return driver or "default"


class SvdTimes:
    """Seconds of every torch.linalg.svd/svdvals call inside the block, by
    (function, input shape, full rank or not); the card is synchronised
    around each call."""

    def __init__(self, torch):
        self.torch = torch
        self.rows = collections.defaultdict(lambda: [0, 0.0])

    def __enter__(self):
        linalg = self.torch.linalg
        self.orig = linalg.svd, linalg.svdvals

        def wrap(label, fn):
            def call(a, *args, **kw):
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(a, *args, **kw)
                self.torch.cuda.synchronize()
                s = out if label == "svdvals" else out[1]
                full = bool(s[-1] > s[0] * 2.0 ** -23 * max(a.shape))
                row = self.rows[(label, f"{a.shape[0]}x{a.shape[1]}", full)]
                row[0] += 1
                row[1] += time.perf_counter() - t0
                return out
            return call
        linalg.svd, linalg.svdvals = wrap("svd", self.orig[0]), wrap("svdvals", self.orig[1])
        return self

    def __exit__(self, *exc):
        self.torch.linalg.svd, self.torch.linalg.svdvals = self.orig

    def summary(self) -> dict:
        return {f"{f} {shape} {'full rank' if full else 'rank-deficient'}":
                {"calls": n, "s": s} for (f, shape, full), (n, s) in sorted(self.rows.items())}


def use_driver(driver):
    from repro_torch.core import coala
    coala._solver = lambda m: driver if m.is_cuda else None


def accuracy(torch, res) -> dict:
    from repro_torch.core.calibrate import block_modules
    from repro_torch.models.linear import Linear, rank_for_ratio
    rf = res["calibrator"].r_factors()
    out = {}
    for path, lin in block_modules(res["model"], Linear):
        if not path.startswith("blocks/0/"):
            continue
        w, r_f = lin.w.detach().T.float(), rf[path].float()
        rank = rank_for_ratio(w.shape[1], w.shape[0], 0.6)
        s64 = torch.linalg.svdvals(w.double() @ r_f.double().T, driver="gesvd")
        row = {"optimum": torch.sqrt(torch.sum(s64[rank:] ** 2)).item(),
               "fp32_floor": 2.0 ** -23 * s64[0].item() * min(w.shape) ** 0.5}
        for driver in DRIVERS:
            u = torch.linalg.svd(w @ r_f.T, full_matrices=False, driver=driver)[0][:, :rank]
            row[name(driver)] = torch.linalg.norm((w - u @ (u.T @ w)) @ r_f.T).item()
        out[path] = row
        print(f"  {path} ({w.shape[0]}x{w.shape[1]}, rank {rank}): weighted error "
              f"gesvd {row['gesvd']:.4f}, default {row['default']:.4f}; optimum (fp64) "
              f"{row['optimum']:.4f}, fp32 floor {row['fp32_floor']:.4f}", flush=True)
    return out


def compress_by_driver(torch, res) -> dict:
    """``compress_model`` (coala, ratio 0.6, λ 4) on the launcher's trained
    model and calibrator under each driver, its SVD calls timed."""
    from repro_torch.config import CompressConfig
    from repro_torch.core.compress import compress_model
    ccfg = CompressConfig(method="coala", ratio=0.6, lam=4.0)
    out = {}
    for driver in DRIVERS:
        use_driver(driver)
        with SvdTimes(torch) as svds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            compress_model(res["model"], res["calibrator"], ccfg)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        summ = svds.summary()
        in_svd = sum(r["s"] for r in summ.values())
        out[name(driver)] = {"total_s": total, "svd_s": in_svd, "calls": summ}
        print(f"  {name(driver)}: compress_model {total:.2f} s, of it in svd/svdvals "
              f"{in_svd:.2f} s", flush=True)
        for key, r in summ.items():
            print(f"    {key}: {r['calls']} calls, {r['s']:.3f} s "
                  f"({r['s'] / r['calls']:.4f} s each)", flush=True)
    use_driver("gesvd")
    return out


def best_of(torch, fn, n=3) -> float:
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times)


def expert_probe(torch, res) -> dict:
    from repro_torch.core.calibrate import moe_paths
    path, moe = next(iter(moe_paths(res["model"])))
    seen = res["calibrator"].tokens_seen()
    counts = sorted((seen.get(f"{path}/expert{e}/in", 0), e)
                    for e in range(moe.w_gate.w.shape[0]))
    k, e = counts[len(counts) // 2]
    w = moe.w_gate.w[e].detach().T.float()
    m = w @ res["calibrator"].r_factors()[f"{path}/expert{e}/in"].float().T
    gen = torch.Generator(device=m.device).manual_seed(0)
    mats = {f"expert {e} W Rᵀ ({k} tokens)": m,
            "random, full rank": torch.randn(m.shape, generator=gen, device=m.device),
            f"random, rank {k}": (torch.randn((m.shape[0], k), generator=gen, device=m.device)
                                  @ torch.randn((k, m.shape[1]), generator=gen,
                                                device=m.device))}
    out = {}
    for label, a in mats.items():
        row = {}
        for driver in DRIVERS:
            row[f"svd {name(driver)}"] = best_of(torch, lambda: torch.linalg.svd(
                a, full_matrices=False, driver=driver))
            row[f"svdvals {name(driver)}"] = best_of(torch, lambda: torch.linalg.svdvals(
                a, driver=driver))
        out[label] = row
        print(f"  {label} {a.shape[0]}x{a.shape[1]}: "
              + ", ".join(f"{k2} {v:.4f} s" for k2, v in row.items()), flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_svd_probe: no CUDA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (pins TF32 off)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import compress as launcher

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    _build.build()
    _build.lib()
    out = {"card": smi}

    print("[1] llama3_1b, depth 4: block 0's weighted errors and compress_model by "
          "driver", flush=True)
    cfg = dataclasses.replace(get_config("llama3_1b"), n_layers=4)
    res = launcher.main(["--arch", "llama3_1b", "--pretrain-steps", "100"] + ARGS, cfg=cfg)
    out["llama3_1b_block0"] = accuracy(torch, res)

    out["llama3_1b_compress"] = compress_by_driver(torch, res)
    del res
    torch.cuda.empty_cache()

    print("[2] deepseek_moe_16b, depth 2: compress_model by driver", flush=True)
    cfg = dataclasses.replace(get_config("deepseek_moe_16b"), n_layers=2)
    res = launcher.main(["--arch", "deepseek_moe_16b", "--pretrain-steps", "10"] + ARGS,
                        cfg=cfg)
    out["deepseek_compress"] = compress_by_driver(torch, res)

    print("[3] one routed expert's W Rᵀ beside random matrices of its shape", flush=True)
    out["expert_matrices"] = expert_probe(torch, res)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
