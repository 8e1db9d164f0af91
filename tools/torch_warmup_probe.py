#!/usr/bin/env python3
"""The continuous engine's warmup cost and long-prompt TTFT on one CUDA
card, for comparing two checkouts of the port on the same card.

1. gemma2_27b at full width, depth 2 (one local, one global layer), fp32
   weights from a seeded ``torch.Generator``, with ``chip_smoke.py`` phase
   8's engine knobs and trace (phase 4's eight requests plus one of 4400
   prompt tokens): a CUDA-graph engine, then an eager one. For each: the
   warmup's seconds and peak device memory, then the trace's seconds, peak,
   mean TTFT, the long request's TTFT and a digest of every greedy token.
2. llama3_1b at depth 4 (phase 4's model), an eager engine over phase 4's
   pool: the warmup's seconds and peak, and the trace's seconds.

It measures the checkout it is started from: the current directory's
``src`` and ``chip_smoke.py`` (for the knobs and the trace), so one copy of
this file measures two trees in turn. Run from a checkout's root on a
machine with one CUDA card:

    python3 tools/torch_warmup_probe.py

Prints the card's name and power limit, then one JSON object.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path.cwd()
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_warmup_probe: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import repro_torch  # noqa: F401  (pins TF32 off)
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import synthetic_trace
    from repro_torch.models import build_model
    from repro_torch.serve import ContinuousEngine

    def fresh_peak():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def peak_gb():
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() / 1e9

    def drive(eng, trace):
        pending, step, done = list(trace), 0, []
        t0 = time.perf_counter()
        while pending or eng.has_work():
            while pending and pending[0][0] <= step:
                _, prompt, n = pending.pop(0)
                eng.submit(prompt, n)
            done += eng.step()
            step += 1
        torch.cuda.synchronize()
        return done, time.perf_counter() - t0

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    res = {"checkout": str(ROOT), "card": smi}
    gen = torch.Generator(device="cuda")
    cfg = dataclasses.replace(get_config("gemma2_27b"), n_layers=cs.GEMMA_LAYERS)
    trace = synthetic_trace(cs.REQUESTS, cfg.vocab_size, seed=cs.SEED,
                            min_prompt=cs.MIN_PROMPT, max_prompt=cs.MAX_PROMPT,
                            min_new=cs.NEW_TOKENS, max_new=cs.NEW_TOKENS)
    long_prompt = np.random.RandomState(cs.SEED + 7).randint(
        0, cfg.vocab_size, cs.LONG_PROMPT).astype(np.int32)
    trace.append((trace[-1][0] + 2, long_prompt, cs.NEW_TOKENS))
    model = build_model(cfg, device="cuda").init(gen.manual_seed(cs.SEED))
    for graphs in (True, False):
        fresh_peak()
        eng = ContinuousEngine(model, cuda_graphs=graphs, **cs.GEMMA_KNOBS)
        warm = eng.warmup(max_len=cs.LONG_PROMPT + cs.NEW_TOKENS + 16)
        warm_peak = peak_gb()
        fresh_peak()
        done, secs = drive(eng, trace)
        toks = json.dumps({r.req_id: r.out_tokens for r in done}, sort_keys=True)
        res["gemma2_" + ("graphs" if graphs else "eager")] = {
            "warmup_s": warm["warmup_seconds"], "warmup_peak_gb": warm_peak,
            "serve_s": secs, "serve_peak_gb": peak_gb(),
            "mean_ttft_s": eng.metrics()["mean_ttft_s"],
            "long_ttft_s": next(r.ttft for r in done
                                if len(r.prompt) == cs.LONG_PROMPT),
            "tokens_md5": hashlib.md5(toks.encode()).hexdigest()}
        eng.release_graphs()
        del eng
    del model
    cfg = dataclasses.replace(get_config("llama3_1b"), n_layers=4)
    trace = synthetic_trace(cs.REQUESTS, cfg.vocab_size, seed=cs.SEED,
                            min_prompt=cs.MIN_PROMPT, max_prompt=cs.MAX_PROMPT,
                            min_new=cs.NEW_TOKENS, max_new=cs.NEW_TOKENS)
    model = build_model(cfg, device="cuda").init(gen.manual_seed(cs.SEED))
    fresh_peak()
    eng = ContinuousEngine(model, cuda_graphs=False, block_size=16,
                           num_blocks=72, max_running=8)
    warm = eng.warmup(max_len=220)
    res["llama3_1b_eager"] = {"warmup_s": warm["warmup_seconds"],
                              "warmup_peak_gb": peak_gb(),
                              "serve_s": drive(eng, trace)[1]}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
