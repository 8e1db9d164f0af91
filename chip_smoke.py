#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py              # full run, ~18 min on one H100
    python3 chip_smoke.py --profile 8  # also profile 8 decode steps per model

Phases, each printing its own lines:

1. device  — the card as nvidia-smi and torch name it;
2. build   — compiles the CUDA kernels of ``src/repro_torch/csrc`` with nvcc
             for sm_90a (one nvcc per source, started together);
3. reference — llama3_1b SMOKE through the kernels on the card vs through the
             plain versions on the CPU: served logits (within 1e-3 in fp32;
             with a bf16 cache under fp32 activations within 2e-2, under
             bf16 activations within 4e-2), LM.loss with the flash kernel
             (1e-4), the calibration Grams (1e-4), and a speculative engine's
             greedy tokens (a ratio-0.3 draft, k 4; graphs on the card,
             eager on the CPU): identical, and identical to the CPU's
             non-speculative tokens; one adapter-only AdamW step (coala_a1
             adapters at rank 8, forward and backward through lowrank_linear
             on the card) against the CPU's: loss, the adapters' gradients
             and every updated leaf within 1e-4; then each attention-only family's SMOKE
             config (mistral_7b, smollm_135m, olmo_1b, minicpm_2b,
             gemma2_27b, deepseek_moe_16b, deepseek_v2_lite_16b's MLA),
             dense and COALA: prefill and decode logits card vs CPU (1e-3)
             over rows past gemma2's SMOKE window, and a staggered
             shared-prefix trace through the card's graphs against the CPU's
             eager engine (identical tokens); qwen2_vl_2b SMOKE too, and with
             vision prefixes on every second request of a trace that preempts
             a vision request (card graphs vs CPU eager, identical tokens; the
             fixed-batch ServeEngine card vs CPU); and the kernels at
             qwen2-vl's 12 / 2 heads (G 6) and hd 128 against their plain
             versions: flash at B 1, T 271 and 456, paged_attention over 8
             rows and chunked_prefill over 3, fp32, bf16 and fp32 over bf16
             pages;
4. serve path — the serving launcher's entry point
             (``repro_torch.launch.serve.main``, i.e. ``python -m
             repro_torch.launch.serve --continuous --warmup on``) on
             llama3_1b at full width and depth: random init from a seeded
             torch.Generator, calibration on seeded numpy tokens (through the
             flash kernel), COALA compression (ratio 0.6, λ = 4, μ from
             Eq. 5), then the dense and the compressed model each capture
             their CUDA graphs (warmup) and serve the same trace of staggered
             requests through the continuous engine (batched paged prefill,
             paged decode, the prefix cache on, at least one preemption, 0
             post-warmup captures); then, on those two models, the same trace
             through the eager engine (identical greedy tokens), a 128-token
             shared-prefix variant with the prefix cache on and off
             (identical tokens, hit rate > 0) and a sampled run at
             temperature 0.8, twice (identical tokens);
4b. serve-spec — the same launcher with ``--draft-ratio 0.3 --spec-k 4``
             on the same trace and pool, handed phase 4's models and
             calibrator so that only the draft is compressed: both targets
             serve speculatively through CUDA graphs (every spec round one
             replay), greedy tokens identical to phase 4's, 0 post-warmup
             captures; then the speculative engine eagerly (identical
             tokens) and sampled at temperature 0.8 twice (identical);
4c. serve dtypes — phase 4's models through graphs on the same trace with a
             bf16 KV cache (COALA) and with bf16 activations and cache
             (dense and COALA): rates, 0 post-warmup captures, and the share
             of greedy tokens equal to the fp32 run's with the first
             divergent position (bf16 may part from fp32; it is reported,
             not failed);
4d. serve-recalib — the same launcher with ``--calibrate-from-traffic`` on
             20 requests of phase 4's ranges, handed phase 4's models and
             calibrator: the COALA engine streams its traffic through the
             dense model (flash kernel) into traffic calibration and, once
             the bound clears, swaps the solved factors into its captured
             graphs mid-trace (one full solve; requests in flight; 0
             post-warmup captures); then the swapped graphs against an eager
             engine on the solved model (logits within 1e-3, greedy tokens
             on 2 fresh requests), phase 4's trace on a fresh graph engine
             (prefix cache off) before a swap, with identity swaps every 4
             steps (tokens equal phase 4's) and after swapping the solved
             model in (the rates), capture tokens/s, and the caller's COALA
             model bit-equal;
5. compress path — the compression launcher's entry point
             (``repro_torch.launch.compress.main``) on llama3_1b at full
             width, its depth cut to 4 of 16 layers (handed as ``cfg``), with
             its defaults: pretrain 100 steps, evaluate, calibrate (4 x 8 x 64
             tokens), compress, evaluate, once with COALA and once with
             SVD-LLM (whose Cholesky fails on the rank-deficient Grams; its
             non-finite layers are printed, not failed); then svd, svd_llm_v2
             and asvd on the COALA run's trained model and calibrator (block
             0's seven linears only, to stay within the time budget);
6. gram path — ``calibrate_model(collect_gram=True)`` on that trained model
             and its calibration batches, each Gram held against RᵀR;
7. kernels — each kernel against its plain PyTorch version on the card, in
             fp32 and bf16, at the paths' shapes (plus window / softcap /
             zero-length / starts > 0 / ragged cases), with its time, the
             plain version's time, one PyTorch library call's time and the
             least time the card could take (the bound); lowrank_linear is
             summed per layer at decode and at the largest prefill,
             chunked_prefill is also timed at B 4 with cached prefixes,
             paged_attention at 8 rows of 2048 keys, gram_accum per record
             shape and flash_attention per case and dtype; paged_attention
             and chunked_prefill also with fp32 q over bf16 pages (the
             serving dtypes' mixed call) and chunked_prefill at the
             speculative verifier's shape (L 5, every row past its prefix,
             as phase 4b called it); paged_attention, gram_accum and
             flash_attention must give the same bits on a second identical
             call;
8. gemma2 path — the serving launcher on gemma2_27b at full width, its
             depth cut to 2 of 46 layers (one local layer with the 4096
             window, one global; softcaps 50 / 30, sandwich norms, query
             scale 144^-0.5, hd 128, G 2), handed as ``cfg``: calibration
             2 x 8 x 256 tokens, COALA ratio 0.6, λ 4, dense and COALA
             through CUDA graphs after warmup on phase 4's trace plus one
             4400-token prompt (the window bites in chunked_prefill and
             paged_attention), 0 post-warmup captures, then both through the
             eager engine: identical greedy tokens;
9. deepseek path — the compression launcher on deepseek_moe_16b at full
             width, its depth cut to 2 of 28 layers (the dense-FFN layer and
             one MoE layer of 64 routed experts top-6 and 2 shared), handed
             as ``cfg``, 10 pretrain steps, 4 x 8 x 64 calibration tokens,
             coala and svd_llm compressing every routed expert from its own
             tokens: non-finite factors (coala must have none), CE before
             and after, routed tokens per expert, plain-SVD fallbacks; then
             the COALA model serves phase 4's trace through graphs and
             eagerly, identical greedy tokens, 0 post-warmup captures;
9b. MLA path — the serving launcher on deepseek_v2_lite_16b at full width,
             its depth cut to 2 of 27 layers (the dense-FFN layer and one MoE
             layer of 64 routed experts top-6 and 2 shared, both MLA:
             latent KV of 512 + 64 floats a token and layer), handed as
             ``cfg``: calibration 2 x 8 x 256 tokens through the flash kernel
             at head dim 192, COALA ratio 0.6, λ 4, dense and COALA through
             CUDA graphs after warmup on phase 4's trace plus one 2000-token
             prompt (its latent envelope spans 128 pages), prefix cache on,
             one preemption, 0 post-warmup captures, then both through the
             eager engine: identical greedy tokens; no non-finite COALA
             factor; flash_attention and lowrank_linear launch, and the paged
             kernels (``{k, v}`` pages) launch 0 times.
             Phase 7 also holds lowrank_linear on gemma2's seven projections
             (M 8, M 256; `down` at d_in 36864 takes 72 split-K chunks),
             paged_attention and chunked_prefill at phase 8's shapes with its
             window, softcap and scale (local and global), flash at
             gemma2's calibration shape with softcap 50 and at MLA's (B 8,
             T 256, H 16, hd 192; ragged T 200; SMOKE's hd 48), and
             lowrank_linear on deepseek_v2_lite_16b's nine compressed dense
             projections at M 8;
10. compression core — on phase 5's trained model and calibrator: [10a]
             ``compress_model`` with adaptive ranks (coala, ratio 0.6, μ 0:
             the reference's coala_adaptive row of Table 2): kept ratio <= 0.6,
             more than one distinct rank, one rank per layer position, every
             report at or above its optimum, a finite CE beside phase 5's
             uniform COALA CE; the model serves phase 4's trace through CUDA
             graphs (0 post-warmup captures) and eagerly, identical greedy
             tokens; [10b] Table 4 on block 0 alone (depth 1), calibrated and
             fine-tuned on a second stream (seed 99, noise 0.05): lora,
             pissa, corda, coala_a1, coala_a2 adapters at rank 8, 20
             adapter-only AdamW steps each (forward and backward through
             lowrank_linear), merge, CE; frozen leaves bit-identical,
             backward launches and, on each adapted linear, the adapter
             sum and the merged product within fp32's rounding bound of
             their fp64 sum, for all; merged logits equal the adapter
             model's (1e-3) and a finite CE but for corda, whose CE and
             logits error are recorded (its Gram is rank-deficient: Remark
             1); [10c] Theorem 1 on block 0's down at three
             μ, and the randomized SVD timed beside the full one on block 0's
             seven linears (μ 0), each weighted error against the fp64
             optimum (the full solve within 1.1x it plus fp32's floor). Phase 7 then also holds lowrank_linear at the
             adaptive ranks and, under autograd, at M 512, rank 8 on the seven
             projections and one odd adaptive rank (gradients vs the plain
             version's autograd; forward + backward timed on the card,
             by torch.profiler's kernel times, and on the wall clock);
11. qwen2-vl path — qwen2_vl_2b at full width (d_model 1536, 12 / 2 heads,
             hd 128, d_ff 8960, vocab 151936, M-RoPE (16, 24, 24), 256 vision
             tokens), its depth cut to 4 of 28 layers, handed as ``cfg``: (a)
             the serving launcher without ``--continuous`` (``run_fixed``: 4
             rows of 64 tokens after their vision prefixes, 16 new tokens,
             fp32), tokens equal to a ``ContinuousEngine.generate`` of the
             same inputs; (b) the launcher with ``--continuous --compress-ratio
             0.6 --warmup on --detok-async on --telemetry-port 0``, dense and
             COALA on phase 4's trace (0 post-warmup captures), then on its
             models phase 4's trace with a (1, 256, 1536) vision prefix on
             every second request over a pool that preempts a vision request:
             through graphs (warmup; 0 post-warmup captures; every request
             finished with its budget; the per-request prefills counted; a
             detokenizer and a stream callback: each request's text is its
             tokens, the events in emission order; a TelemetryServer on
             127.0.0.1 port 0 answers /metrics, /healthz, /requests and
             /snapshot with 200 every 8 steps, /snapshot strict JSON), then
             eagerly (identical tokens); (c) ``run_offline`` of the trace's
             text half on a fresh graph engine: the mixed run's tokens, input
             order, fewer batched prefills than requests. Phase 7 then also
             holds lowrank_linear on qwen2-vl's seven projections (M 8 and
             the per-request prefill's M), both paged kernels at phase 11's
             decode batch and largest prefill (G 6, hd 128) and flash at B 1
             T 456 / 271;
12. profile — only with ``--profile N``: wall and per-kernel device time of
             N decode steps per model (torch.profiler), through CUDA graphs
             and eagerly, through graphs in bf16 (activations and cache),
             of the speculative draft served alone and of speculative
             rounds, and the host cost of one wrapper call and of two eager
             model ops.

Phase 4b's launcher run also writes its span trace (``--trace-out``, under
``build/``) and keeps a flight recorder: the trace must be strict JSON with
the serving spans nesting per thread, each engine's ``metrics()`` keys the
JAX golden set, and every request's lifecycle in the recorder. Phase 4d
runs after 4c, so that no earlier phase sees a swapped model.

Phases run in the order 1-6, 10, 8, 9, 9b, 11, 7, 12. Launch counts are zeroed
just before each of the paths 4-6, 10, 8, 9, 9b and 11 (4b, 4c and 4d
included) and
read just after: eager launches plus the kernels of every
CUDA-graph replay; each kernel must have launched on the paths that run it,
and lowrank_linear's backward on phase 10's (its launches counted apart too).
The shapes of the kernel calls are noted on the way for phase 7 (on the
serve paths in their eager-engine runs: a graph's wrapper calls see only the
static capture inputs).

It then prints one JSON line of per-kernel results, the nvidia-smi line, and
as its last line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero without that line. Without CUDA, or when ``src/repro_torch`` is not
beside this file, it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
MLA_PROJECTIONS = {         # deepseek_v2_lite_16b's compressed dense projections
    "wq": (2048, 3072), "w_dkv": (2048, 512), "wo": (2048, 2048),
    "gate": (2048, 10944), "up": (2048, 10944), "down": (10944, 2048),
    "shared gate": (2048, 2816), "shared up": (2048, 2816), "shared down": (2816, 2048)}
GEMMA2_PROJECTIONS = {      # gemma2_27b's projections: (d_in, d_out)
    "wq": (4608, 4096), "wk": (4608, 2048), "wv": (4608, 2048), "wo": (4096, 4608),
    "gate": (4608, 36864), "up": (4608, 36864), "down": (36864, 4608)}
LOWRANK_SHAPES = {          # llama3_1b projections at ratio 0.6: (d_in, r, d_out)
    "wq": (2048, 614, 2048), "wk": (2048, 245, 512), "wv": (2048, 245, 512),
    "wo": (2048, 614, 2048), "gate": (2048, 983, 8192), "up": (2048, 983, 8192),
    "down": (8192, 983, 2048)}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}     # max|err| <= tol * max(1, max|ref|)
TOL_ATTN = {"float32": 2e-5, "bfloat16": 2e-2}  # bf16 also: any bf16 operand
# SMOKE served logits card vs CPU per (compute, cache) dtype: fp32 sums in
# another order; a bf16 cache rounds K and V once as they are written; bf16
# activations round every projection, norm output and the LM head (a few bf16
# ulps of a logit of magnitude ~1)
TOL_SERVE = {("float32", "float32"): 1e-3, ("float32", "bfloat16"): 2e-2,
             ("bfloat16", "bfloat16"): 4e-2}
TOL_GRAM = 1e-5             # both dtypes: bf16 converts to fp32 exactly
SEED = 0
ITERS = 20                  # timed launches per kernel and variant

# The serve path's traffic: 8 requests, one every 2 engine steps, prompts of
# 16-200 tokens, 32 new tokens each. The launcher calibrates on 2 batches of
# --requests x --prompt-len seeded tokens (2 x 8 x 256). The trace needs 81
# pages of 16 tokens at its peak; a pool of 72 (one reserved for trash)
# makes the engine preempt once.
REQUESTS, MIN_PROMPT, MAX_PROMPT, NEW_TOKENS = 8, 16, 200, 32
ENGINE_KNOBS = dict(block_size=16, num_blocks=72, max_running=8)
LAUNCHER_ARGS = ["--continuous", "--arch", "llama3_1b", "--compress-ratio", "0.6",
                 "--requests", str(REQUESTS), "--prompt-len", "256",
                 "--new-tokens", str(NEW_TOKENS),
                 "--block-size", str(ENGINE_KNOBS["block_size"]),
                 "--num-blocks", str(ENGINE_KNOBS["num_blocks"]),
                 "--max-running", str(ENGINE_KNOBS["max_running"]), "--warmup", "on",
                 "--seed", str(SEED), "--device", "cuda"]
# The serve path's variants on the launcher's models: every prompt behind
# one common 128-token prefix (8 pages), and sampling at temperature 0.8.
SHARED_PREFIX, TEMPERATURE = 128, 0.8
# Speculative serving: a draft at ratio 0.3 proposing 4 tokens a round.
DRAFT_RATIO, SPEC_K = 0.3, 4
SPEC_ARGS = ["--draft-ratio", str(DRAFT_RATIO), "--spec-k", str(SPEC_K)]
# Phase 4b's launcher run also writes its span trace and keeps a flight
# recorder; the trace goes under build/ (ignored by git)
TRACE_OUT = ROOT / "build" / "chip_smoke_trace.json"
TELEMETRY_ARGS = ["--trace-out", str(TRACE_OUT), "--flight-recorder", "65536"]
# engine.metrics() keys (the JAX engine's golden set, tests/test_obs.py), the
# speculative and the recalibration ones
METRICS_KEYS = {
    "requests", "requests_per_sec", "new_tokens", "tokens_per_sec",
    "mean_ttft_s", "max_ttft_s", "preemptions",
    "decode_compiles", "decode_shapes", "decode_steps", "decode_tok_per_s",
    "prefill_compiles", "prefill_shapes", "prefill_batches",
    "prefill_tok_per_s", "prefill_kernel",
    "prefix_hit_rate", "prefix_hit_tokens", "cached_blocks",
    "cow_copies", "prefix_evictions", "queue_depth",
    "warmup_seconds", "post_warmup_compiles", "slo_goodput"}
SPEC_METRICS_KEYS = {"spec_k", "spec_rounds", "spec_proposed_tokens",
                     "spec_accepted_tokens", "spec_accept_rate"}
RECALIB_METRICS_KEYS = {"recalib_swaps", "recalib_sampled_requests",
                        "recalib_captured_tokens", "recalib_clearance",
                        "recalib_residual_excess"}
# Live recompression (phase 4d): phase 4's prompt and new-token ranges over
# 20 requests, one every 2 steps, so the data gate (0.25 x 8192 = 2048 tokens
# for `down`) clears mid-trace (after step 57 of 102: token counts do not
# depend on the weights); the gates are polled every 60 steps, so one full
# solve runs, at step 60 with 8 requests running and 4 waiting.
RECALIB_REQUESTS, RECALIB_CHECK_EVERY = 20, 60
CAPTURE_PROMPTS = 8         # prompts of phase 4d's trace timed through capture
RECALIB_ARGS = ["--calibrate-from-traffic", "--recalib-check-every",
                str(RECALIB_CHECK_EVERY), "--flight-recorder", "65536"]
IDENTITY_SWAP_EVERY = 4     # phase 4d's identity swaps: every 4th step
# the serving dtypes held at full width: (model, compute dtype, cache dtype)
DTYPE_RUNS = [("coala", "float32", "bfloat16"), ("dense", "bfloat16", "bfloat16"),
              ("coala", "bfloat16", "bfloat16")]
# The compression launcher with its own defaults (ratio 0.6, λ 4, 100
# pretrain steps, 4 calibration batches of 8 x 64 tokens) on llama3_1b at full
# width, its depth cut from 16 layers to 4 (the path's time is per layer).
COMPRESS_LAYERS = 4
COMPRESS_ARGS = ["--arch", "llama3_1b", "--ratio", "0.6", "--lam", "4",
                 "--pretrain-steps", "100", "--calib-batches", "4", "--device", "cuda"]
EXTRA_METHODS = ("svd", "svd_llm_v2", "asvd")
EXTRA_PREFIX = "blocks/0/"   # the extra methods compress block 0's linears only
# flash_attention cases (name, B, T, Hq, Hkv, hd, cap, scale, timed): the
# compress path's evaluation/calibration and the serving calibration first;
# scale None is hd^-0.5
FLASH_CASES = [("path B8 T64", 8, 64, 32, 8, 64, 0.0, None, True),
               ("path B8 T256", 8, 256, 32, 8, 64, 0.0, None, True),
               ("B1 T4096", 1, 4096, 32, 8, 64, 0.0, None, True),
               ("ragged T100", 2, 100, 32, 8, 64, 0.0, None, False),
               ("softcap 20", 2, 256, 32, 8, 64, 20.0, None, False),
               ("G1", 2, 128, 8, 8, 64, 0.0, None, False),
               ("G4 hd128 ragged", 1, 77, 16, 4, 128, 0.0, None, False),
               ("T1", 4, 1, 32, 8, 64, 0.0, None, False),
               ("G8 T1000", 1, 1000, 64, 8, 64, 0.0, None, False),
               # gemma2's calibration forward on its global layer (phase 8), at
               # its query scale (d_model / n_heads)^-0.5
               ("gemma2 B8 T256 hd128 cap50", 8, 256, 32, 16, 128, 50.0,
                (4608 / 32) ** -0.5, True),
               # MLA's calibration forward (phase 9b): q/k of nope + rope = 192
               # dims, V zero-padded to them, scale 192^-0.5; ragged; SMOKE's 48
               ("mla B8 T256 hd192", 8, 256, 16, 16, 192, 0.0, None, True),
               ("mla ragged T200 hd192", 8, 200, 16, 16, 192, 0.0, None, False),
               ("mla SMOKE hd48", 2, 64, 4, 4, 48, 0.0, None, False),
               # qwen2-vl's per-request prefill (phase 11): one row of 256
               # vision + 200 / 15 text positions, 12 / 2 heads (G 6), hd 128
               ("qwen2-vl B1 T456 G6 hd128", 1, 456, 12, 2, 128, 0.0, None, True),
               ("qwen2-vl B1 T271 G6 hd128", 1, 271, 12, 2, 128, 0.0, None, False)]
# gram_accum cases (k tokens, n): the calibration records, then ragged
GRAM_CASES = [(512, 2048, True), (512, 8192, True), (300, 1000, False)]
GRAM_LAYER = {(512, 2048): 6, (512, 8192): 1}   # one layer's Grams per record
# Phase 10, the compression core, on phase 5's trained llama3_1b (depth 4) and
# its 2048-token calibrator: adaptive ranks at phase 5's ratio with μ 0 (the
# reference's coala_adaptive row of Table 2, benchmarks/run.py:200-206);
# Table 4's adapters at rank 8 on block 0 alone (depth 1: the α 0 and α 2
# factors of the 8192-wide down each take an 8192² SVD), calibrated and
# fine-tuned on a second stream (seed 99, noise 0.05) as
# examples/finetune_adapters.py does, 20 adapter-only steps of 8 x 64 tokens
# (its ft_cfg: lr 1e-3, const, weight decay 0); Theorem 1 on block 0's down.
ADAPTIVE_RATIO = 0.6
ADAPTER_METHODS = ("lora", "pissa", "corda", "coala_a1", "coala_a2")
ADAPTER_RANK, ADAPTER_STEPS, ADAPTER_CAL_BATCHES, ADAPTER_EVAL_BATCHES = 8, 20, 4, 3
ADAPTER_FT = dict(lr=1e-3, warmup_steps=2, total_steps=ADAPTER_STEPS, schedule="const",
                  weight_decay=0.0)
ADAPTER_FINITE = ("lora", "pissa", "coala_a1", "coala_a2")   # corda is recorded only
TOL_MERGE = 1e-3            # merged vs adapter logits: x·w + (x·b_t)·a_t vs x·(w + b_t·a_t)
THM1_LAYER, THM1_MUS = "blocks/0/sub0/ffn/down", (1e-3, 1e-2, 1e-1)
SVD_SLACK = 1.1             # 10c: the full fp32 solve against the fp64 optimum
GRAD_ROWS = 512             # phase 7's backward rows: one fine-tuning step's 8 x 64


class Failure(Exception):
    pass


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed(torch, fn, flush) -> float:
    """Device milliseconds of one call of ``fn`` with a cold L2 (as a layer's
    weights are at each decode step): CUDA events around ``ITERS`` calls
    launched back to back, each after a rewrite of the 256 MB ``flush``
    buffer, minus the same loop of rewrites alone. The ~0.1 ms rewrite
    keeps the host ahead of the card, so the host's launch overhead is not
    counted."""
    def loop(with_fn: bool) -> float:
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(ITERS):
            flush.zero_()
            if with_fn:
                fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e)
    for _ in range(2):
        fn()
    loop(False)
    return max(loop(True) - loop(False), 0.0) / ITERS


def _cuda_events(prof):
    """The device-side entries of ``prof.key_averages()`` (kernels, copies,
    sets) and the name of their self device time in microseconds, which
    differs across torch versions."""
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    attr = ("self_device_time_total"
            if events and hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    return events, attr


def device_ms(torch, fn, flush) -> float:
    """Milliseconds on the card of one call of ``fn`` with a cold L2: the
    durations of the kernels and copies torch.profiler records over
    ``ITERS`` calls, each after a rewrite of ``flush``, summed, minus the
    same sum for the rewrites alone. Unlike ``timed`` it leaves out the
    gaps in which the card waits for the host, so it is the card's time
    for a call whose host work outruns the card (autograd's forward and
    backward of one projection)."""
    from torch.profiler import ProfilerActivity, profile

    def busy(with_fn: bool) -> float:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                flush.zero_()
                if with_fn:
                    fn()
            torch.cuda.synchronize()
        events, attr = _cuda_events(prof)
        return sum(getattr(e, attr) for e in events) / 1e3
    for _ in range(2):
        fn()
    return max(busy(True) - busy(False), 0.0) / ITERS


def bound(nbytes: float, ops: float, dtype: str):
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def compare(name, got, want, tol) -> float:
    err = (got.float() - want.float()).abs().max().item()
    lim = tol * max(1.0, want.float().abs().max().item())
    ok = math.isfinite(err) and err <= lim
    log(f"  {name}: max_abs_err={err:.3e} tol={lim:.3e} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise Failure(f"{name}: kernel disagrees with its plain version")
    return err


# ---------------------------------------------------------------------------
# phase 3: small reference — kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------------

def reference_check(torch, dev):
    import copy
    import numpy as np
    from repro_torch.config import CompressConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.calibrate import calibrate_model
    from repro_torch.core.compress import compress_model
    from repro_torch.models import build_model
    from repro_torch.serve.engine import compute_copy

    cfg = get_smoke_config("llama3_1b")
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED)
    batches = [torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 32)))
               for _ in range(2)]
    cal = calibrate_model(cpu, batches)
    ccpu, _ = compress_model(cpu, cal, CompressConfig(ratio=0.6, lam=4.0, mu=-1.0))
    bs, nbk = 16, 16
    lens = [23, 9, 1]
    tok = np.zeros((4, 32), np.int32)
    for i, n in enumerate(lens):
        tok[i, :n] = rng.randint(0, cfg.vocab_size, n)
    tables = np.zeros((4, 4), np.int32)
    tables[0, :2], tables[1, :1], tables[2, :1] = [1, 2], [3], [4]
    ln = np.array(lens + [1], np.int32)
    for name, m_cpu in (("dense", cpu), ("coala", ccpu)):
        m_gpu = copy.deepcopy(m_cpu).to(dev)
        for (cdt, kdt), tol in TOL_SERVE.items():
            compute, cache_dt = getattr(torch, cdt), getattr(torch, kdt)
            outs = []
            for m, d in ((m_cpu, torch.device("cpu")), (m_gpu, dev)):
                m = compute_copy(m, compute)
                cache = m.init_cache(nbk, bs, dtype=cache_dt)
                t = lambda a: torch.as_tensor(a, device=d)   # noqa: E731
                lg = [m.prefill_chunk(t(tok), cache, t(np.zeros(4, np.int32)), t(ln),
                                      t(tables), compute_dtype=compute)]
                pos = np.array(lens + [0], np.int32)
                nxt = np.array([[5], [7], [11], [0]], np.int32)
                for _ in range(2):
                    lg.append(m.decode_step(t(nxt), cache, t(pos), t(tables),
                                            compute_dtype=compute))
                    pos[:3] += 1
                outs.append([x[:3].cpu() for x in lg])
            for i, (a, b) in enumerate(zip(*outs)):
                compare(f"reference {name} {cdt}/{kdt} cache step {i} (card kernels vs "
                        "CPU plain)", b, a, tol)


# the attention-only families of this slice, held card vs CPU at SMOKE size
FAMILIES = ("mistral_7b", "smollm_135m", "olmo_1b", "minicpm_2b", "gemma2_27b",
            "deepseek_moe_16b", "deepseek_v2_lite_16b", "qwen2_vl_2b")
FAMILY_KNOBS = dict(block_size=4, num_blocks=48, max_running=3, bucket_sizes=(1, 2, 3),
                    prefill_bucket_sizes=(16, 64))
FAMILY_TRACE = dict(seed=2, min_prompt=20, max_prompt=60, max_new=8, arrival_every=1,
                    shared_prefix=8)


def reference_families(torch, dev):
    """Each family's SMOKE config, dense and COALA-compressed on the CPU (per
    expert for the MoE): the logits of a prefill of rows past gemma2's SMOKE
    window (32) and of two decode steps through the kernels on the card
    against the plain versions on the CPU (fp32, ``TOL_SERVE``'s fp32
    tolerance), then a staggered trace with a shared prefix through the
    engine's CUDA graphs on the card: greedy tokens identical to the eager
    engine's on the CPU, 0 post-warmup captures."""
    import copy
    import numpy as np
    from repro_torch.config import CompressConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.calibrate import calibrate_model
    from repro_torch.core.compress import compress_model
    from repro_torch.launch.serve import serve_trace, synthetic_trace
    from repro_torch.models import build_model
    from repro_torch.serve import ContinuousEngine

    tol = TOL_SERVE[("float32", "float32")]
    lens, l_pad, bs = [45, 12, 37], 48, 8
    tables = np.zeros((4, 8), np.int32)
    nxt = 1
    for i, n in enumerate(lens):
        for j in range(-(-(n + 2) // bs)):
            tables[i, j] = nxt
            nxt += 1
    for arch in FAMILIES:
        cfg = get_smoke_config(arch)
        cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(SEED))
        rng = np.random.RandomState(SEED)
        batches = [torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 40)))
                   for _ in range(2)]
        ccpu, _ = compress_model(cpu, calibrate_model(cpu, batches),
                                 CompressConfig(ratio=0.6, lam=4.0, mu=-1.0))
        tok = np.zeros((4, l_pad), np.int32)
        for i, n in enumerate(lens):
            tok[i, :n] = rng.randint(0, cfg.vocab_size, n)
        ln = np.array(lens + [1], np.int32)
        trace = synthetic_trace(5, cfg.vocab_size, **FAMILY_TRACE)
        for name, m_cpu in (("dense", cpu), ("coala", ccpu)):
            m_gpu = copy.deepcopy(m_cpu).to(dev)
            outs = []
            for m, d in ((m_cpu, torch.device("cpu")), (m_gpu, dev)):
                cache = m.init_cache(nxt + 1, bs)
                t = lambda a: torch.as_tensor(a, device=d)   # noqa: E731
                lg = [m.prefill_chunk(t(tok), cache, t(np.zeros(4, np.int32)), t(ln),
                                      t(tables))]
                pos = np.array(lens + [0], np.int32)
                step = np.array([[5], [7], [11], [0]], np.int32)
                for _ in range(2):
                    lg.append(m.decode_step(t(step), cache, t(pos), t(tables)))
                    pos[:3] += 1
                outs.append([x[:3].cpu() for x in lg])
            for i, (a, b) in enumerate(zip(*outs)):
                compare(f"reference {arch} {name} fp32 step {i} (card kernels vs CPU "
                        "plain)", b, a, tol)
            toks = []
            for m, graphs in ((m_gpu, True), (m_cpu, False)):
                eng = ContinuousEngine(m, **FAMILY_KNOBS)
                if graphs:
                    eng.warmup(max_len=max(len(p) + nn for _, p, nn in trace))
                serve_trace(eng, trace)
                toks.append({r.req_id: list(r.out_tokens) for r in eng.finished})
                met = eng.metrics()
                eng.release_graphs()
                if graphs and met["post_warmup_compiles"] != 0:
                    raise Failure(f"{arch} {name}: {met['post_warmup_compiles']} "
                                  "post-warmup captures")
            same = toks[0] == toks[1] and len(toks[0]) == len(trace)
            log(f"  reference {arch} {name} engine (card graphs vs CPU eager): greedy "
                f"tokens {'identical' if same else 'DIFFER'}, prefix hit rate "
                f"{met['prefix_hit_rate']:.3f}")
            if not same:
                raise Failure(f"{arch} {name}: card engine tokens differ from the CPU's")
            del m_gpu


def reference_vlm(torch, dev):
    """qwen2-vl SMOKE (projections x3, random norm scales), dense and
    COALA-compressed on the CPU (calibrated with a vision prefix): a staggered
    trace in which every second request carries a vision prefix, over a pool
    that preempts a vision request, through the card's CUDA graphs (each
    vision request prefilled alone, eagerly, through the flash kernel)
    against the CPU's eager engine: identical greedy tokens, 0 post-warmup
    captures; and the fixed-batch ServeEngine card vs CPU (identical)."""
    import copy
    import numpy as np
    from repro_torch.config import CompressConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.calibrate import calibrate_model
    from repro_torch.core.compress import compress_model
    from repro_torch.models import build_model
    from repro_torch.models.linear import Linear
    from repro_torch.serve import ContinuousEngine, ServeEngine

    cfg = get_smoke_config("qwen2_vl_2b")
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for mod in cpu.modules():
            if isinstance(mod, Linear):
                mod.w.mul_(3.0)
        for pname, p in cpu.named_parameters():
            if pname.endswith("scale"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    rng = np.random.RandomState(SEED)
    vis = lambda b: torch.as_tensor(rng.standard_normal(   # noqa: E731
        (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32))
    batches = [{"tokens": torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 24))),
                "vision_embeds": vis(4)} for _ in range(2)]
    ccpu, _ = compress_model(cpu, calibrate_model(cpu, batches),
                             CompressConfig(ratio=0.6, lam=4.0, mu=-1.0))
    trace = []
    for i in range(6):
        prompt = rng.randint(0, cfg.vocab_size, (rng.randint(4, 17),)).astype(np.int32)
        trace.append((i, prompt, int(rng.randint(8, 13)),
                      {"vision_embeds": vis(1).numpy()} if i % 2 == 0 else None))
    knobs = dict(block_size=4, num_blocks=14, max_running=3, bucket_sizes=(1, 2, 3))
    warm_len = max(len(p) + n + (cfg.n_vision_tokens if ex else 0)
                   for _, p, n, ex in trace)
    prompts = np.stack([p[:4] for _, p, _, _ in trace[:2]])
    fixed_vis = vis(2)
    for name, m_cpu in (("dense", cpu), ("coala", ccpu)):
        m_gpu = copy.deepcopy(m_cpu).to(dev)
        toks, mets = [], []
        for m, graphs in ((m_gpu, True), (m_cpu, False)):
            eng = ContinuousEngine(m, **knobs)
            if graphs:
                eng.warmup(max_len=warm_len)
            mets.append(_serve_mixed(eng, trace))
            toks.append({r.req_id: list(r.out_tokens) for r in eng.finished})
            eng.release_graphs()
        fixed = [ServeEngine(m).generate(prompts, 6, extras={"vision_embeds": fixed_vis})
                 for m in (m_gpu, m_cpu)]
        same = toks[0] == toks[1] and len(toks[0]) == len(trace)
        fsame = np.array_equal(*fixed)
        log(f"  reference qwen2_vl_2b {name} vision trace (card graphs vs CPU eager): "
            f"greedy tokens {'identical' if same else 'DIFFER'}, {mets[0]['preemptions']} "
            f"preemptions, {mets[0]['post_warmup_compiles']} post-warmup captures; "
            f"ServeEngine card vs CPU {'identical' if fsame else 'DIFFER'}")
        if not (same and fsame) or mets[0]["post_warmup_compiles"] != 0 or \
                mets[0]["preemptions"] < 1:
            raise Failure(f"qwen2_vl_2b {name}: card vision serving differs from the CPU's")
        del m_gpu


def reference_group6(torch, ops, dev):
    """The kernels at qwen2-vl's heads (12 query heads over 2 KV heads, a
    GQA group of 6, which no other path runs; hd 128) against their plain
    versions: flash at one row of T 271 and 456 (the per-request prefill of
    256 vision + 15 / 200 text positions), paged_attention over 8 rows and
    chunked_prefill over 3 rows at nonzero starts, in fp32, bf16 and (paged
    kernels) fp32 q over bf16 pages; each repeats its bits."""
    from repro_torch.kernels.chunked_prefill import chunked_prefill_ref
    from repro_torch.kernels.paged_attention import paged_attention_ref
    from repro_torch.kernels.ref import flash_attention_ref
    hq, hkv, hd = VLM_HEADS
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for t in (271, 456):
            q = torch.randn((1, t, hq, hd), generator=gen, device=dev).to(dt)
            k = torch.randn((1, t, hkv, hd), generator=gen, device=dev).to(dt)
            v = torch.randn((1, t, hkv, hd), generator=gen, device=dev).to(dt)
            got = ops.flash_attention(q, k, v)
            compare(f"reference flash_attention G6 {dtype} B1 T{t} hd{hd}", got,
                    flash_attention_ref(q, k, v), TOL_ATTN[dtype])
            if not torch.equal(ops.flash_attention(q, k, v), got):
                raise Failure("flash_attention G6: two identical calls differ")
    lengths = [456, 300, 17, 1, 0, 200, 33, 272]
    starts, lens, lq = [0, 272, 16], [256, 33, 1], 256
    for label, qdtype, kvdtype in ATTN_DTYPES:
        qdt, kvdt = getattr(torch, qdtype), getattr(torch, kvdtype)
        tol = TOL_ATTN[kvdtype if qdtype == "float32" else qdtype]
        kp, vp, tables = _pages(torch, dev, gen, lengths, 16, hkv, hd, kvdt)
        q = torch.randn((len(lengths), hq, hd), generator=gen, device=dev).to(qdt)
        args = (q, kp, vp, tables, torch.tensor(lengths, dtype=torch.int32, device=dev))
        got = ops.paged_attention(*args)
        compare(f"reference paged_attention G6 {label} B8 hd{hd}", got,
                paged_attention_ref(*args), tol)
        if not torch.equal(ops.paged_attention(*args), got):
            raise Failure("paged_attention G6: two identical calls differ")
        kp, vp, tables = _pages(torch, dev, gen, [s + lq for s in starts], 16, hkv, hd,
                                kvdt)
        q = torch.randn((len(lens), lq, hq, hd), generator=gen, device=dev).to(qdt)
        args = (q, kp, vp, tables, torch.tensor(starts, dtype=torch.int32, device=dev),
                torch.tensor(lens, dtype=torch.int32, device=dev))
        got = ops.chunked_prefill(*args)
        compare(f"reference chunked_prefill G6 {label} B3 L{lq} starts {starts} "
                f"lens {lens}", got, chunked_prefill_ref(*args), tol)
        if not torch.equal(ops.chunked_prefill(*args), got):
            raise Failure("chunked_prefill G6: two identical calls differ")


def reference_spec(torch, dev):
    """A speculative SMOKE engine (draft at ``DRAFT_RATIO`` from the same
    calibration, k ``SPEC_K``) on a staggered trace that preempts: greedy
    tokens through CUDA graphs on the card equal the eager engine's on the
    CPU and the CPU's non-speculative tokens. Projections x3 and random
    norm scales make the tokens vary from step to step."""
    import copy
    import numpy as np
    from repro_torch.config import CompressConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.calibrate import calibrate_model
    from repro_torch.core.compress import compress_model_pair
    from repro_torch.launch.serve import serve_trace, synthetic_trace
    from repro_torch.models import build_model
    from repro_torch.models.linear import Linear
    from repro_torch.serve import ContinuousEngine

    cfg = get_smoke_config("llama3_1b")
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Linear):
                mod.w.mul_(3.0)
        for pname, p in model.named_parameters():
            if pname.endswith("scale"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    rng = np.random.RandomState(SEED)
    batches = [torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 32))) for _ in range(2)]
    target, draft, _, _ = compress_model_pair(
        model, calibrate_model(model, batches), CompressConfig(ratio=0.6, lam=4.0, mu=-1.0),
        draft_ratio=DRAFT_RATIO)
    knobs = dict(block_size=4, num_blocks=16, max_running=3)
    trace = synthetic_trace(6, cfg.vocab_size, seed=1, min_prompt=4, max_prompt=20,
                            max_new=16, arrival_every=1)
    runs = {}
    for label, t, d, kw in (("card spec", copy.deepcopy(target).to(dev),
                             copy.deepcopy(draft).to(dev), dict(spec_k=SPEC_K)),
                            ("CPU spec", target, draft, dict(spec_k=SPEC_K)),
                            ("CPU non-spec", target, None, {})):
        eng = ContinuousEngine(t, draft_model=d, **knobs, **kw)
        serve_trace(eng, trace)
        runs[label] = eng, {r.req_id: list(r.out_tokens) for r in eng.finished}
        eng.release_graphs()
    m = runs["card spec"][0].metrics()
    same = runs["card spec"][1] == runs["CPU spec"][1] == runs["CPU non-spec"][1]
    log(f"  reference spec engine (card graphs vs CPU eager vs CPU non-spec): "
        f"{m['spec_rounds']} rounds, accept rate {m['spec_accept_rate']:.3f}, "
        f"{m['preemptions']} preemptions; greedy tokens "
        f"{'identical' if same else 'DIFFER'}")
    if not same or m["spec_rounds"] < 1 or len(runs["card spec"][1]) != 6:
        raise Failure("spec engine: card tokens differ from the CPU's")


def reference_loss_grams(torch, dev):
    """SMOKE LM.loss and calibration Grams with the kernel ctx: flash and
    gram_accum on the card against their plain versions on the CPU (T 40 is
    ragged for the kernel's 64-query tile)."""
    import copy
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.calibrate import calibrate_model
    from repro_torch.models import build_model
    from repro_torch.models.common import ParallelCtx

    cfg = get_smoke_config("llama3_1b")
    kctx = ParallelCtx(use_pallas=True)
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(SEED))
    gpu = copy.deepcopy(cpu).to(dev)
    rng = np.random.RandomState(SEED + 1)
    toks = [rng.randint(0, cfg.vocab_size, (4, 40)) for _ in range(2)]
    with torch.no_grad():
        for i, t in enumerate(toks):
            want = cpu.loss(torch.as_tensor(t), ctx=kctx, compute_dtype=torch.float32)[0]
            got = gpu.loss(torch.as_tensor(t, device=dev), ctx=kctx,
                           compute_dtype=torch.float32)[0]
            compare(f"reference LM.loss batch {i} (card kernels vs CPU plain)",
                    got.cpu().reshape(1), want.reshape(1), 1e-4)
    cals = [calibrate_model(m, [torch.as_tensor(t, device=d) for t in toks],
                            collect_gram=True, ctx=kctx)
            for m, d in ((cpu, "cpu"), (gpu, dev))]
    worst = max(((cals[1].grams[p].cpu() - g).abs().max() / g.abs().max()).item()
                for p, g in cals[0].grams.items())
    ok = len(cals[1].grams) == len(cals[0].grams) == 14 and worst <= 1e-4
    log(f"  reference Grams ({len(cals[1].grams)} paths, card kernel vs CPU plain): "
        f"max |G - G_ref| / max|G_ref| = {worst:.3e} tol=1.000e-04 "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise Failure("gram_accum: SMOKE Grams on the card disagree with the CPU")


def reference_adapter_step(torch, dev):
    """One adapter-only AdamW step (coala_a1 adapters at ``ADAPTER_RANK``,
    weight decay 0.1, eps 1e-3 so that rounding cannot flip a first update)
    of llama3_1b SMOKE on the card — forward and backward through the
    lowrank_linear kernel — against the same step on the CPU: loss, the
    adapters' gradients and every updated leaf within 1e-4 (the kernel's
    sums run in another order)."""
    import copy
    import numpy as np
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.adapters import init_adapters
    from repro_torch.core.calibrate import calibrate_model
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_loop import make_adapter_step

    cfg = get_smoke_config("llama3_1b")
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED + 2)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 32)))
    adapted, mask = init_adapters(model, calibrate_model(model, [toks]).r_factors(),
                                  method="coala_a1", rank=ADAPTER_RANK)
    tcfg = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10, schedule="const",
                       weight_decay=0.1, eps=1e-3)
    runs = {}
    for d in ("cpu", dev):
        m = copy.deepcopy(adapted).to(d)
        before = ops.backward_launch_counts()["lowrank_linear"]
        loss, grads = make_adapter_step(m, tcfg, mask)(
            adamw_init(dict(m.named_parameters())), toks.to(d))
        torch.cuda.synchronize()
        runs[str(d)] = (loss.reshape(1).cpu(), {k: g.cpu() for k, g in grads.items()},
                        {k: p.detach().cpu() for k, p in m.named_parameters()},
                        ops.backward_launch_counts()["lowrank_linear"] - before)
    (l0, g0, p0, _), (l1, g1, p1, bwd) = runs["cpu"], runs[str(dev)]
    compare("reference adapter step loss (card kernel fwd + bwd vs CPU plain)", l1, l0, 1e-4)
    worst_g = max(compare_quiet(g1[k], g0[k]) for k in g0)
    worst_p = max(compare_quiet(p1[k], p0[k]) for k in p0)
    ok = sorted(g1) == sorted(g0) and worst_g <= 1e-4 and worst_p <= 1e-4 and bwd > 0
    log(f"  reference adapter step: {len(g0)} adapter gradients max rel err "
        f"{worst_g:.3e}, {len(p0)} updated leaves max rel err {worst_p:.3e} "
        f"(tol 1e-4), {bwd} backward launches on the card {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise Failure("adapter step: the card's step disagrees with the CPU's")


def compare_quiet(got, want) -> float:
    """max|got - want| / max(1, max|want|), non-finite as inf."""
    err = (got.float() - want.float()).abs().max().item()
    err /= max(1.0, want.float().abs().max().item())
    return err if math.isfinite(err) else math.inf


# ---------------------------------------------------------------------------
# phase 4: the serving path at full width, through its launcher
# ---------------------------------------------------------------------------

class KernelCalls:
    """Notes the shapes of the kernel calls made inside the ``with`` block
    by wrapping the ``ops`` entry points the models call through. Holds
    references only: nothing is read back from the card while the path
    runs. Phase 7 checks and times each kernel at these shapes."""

    NAMES = ("lowrank_linear", "paged_attention", "chunked_prefill",
             "flash_attention", "gram_accum")

    def __init__(self, ops):
        self.ops = ops
        self.lowrank_m = collections.Counter()   # rows M -> calls
        self.paged = None      # (B, tables, lengths) of the last largest-batch call
        self.chunked = None    # (B, L, tables, starts, lens) of the largest call
        self.verify = None     # the same of the largest-batch call at L = SPEC_K + 1
        self.flash = collections.Counter()       # (B, T, Hq, Hkv, hd) -> calls
        self.gram = collections.Counter()        # (k, n) -> calls

    def __enter__(self):
        self._orig = {k: getattr(self.ops, k) for k in self.NAMES}
        ll, pa, cp, fa, ga = (self._orig[k] for k in self.NAMES)

        def lowrank(x, b_t, a_t):
            self.lowrank_m[x.numel() // x.shape[-1]] += 1
            return ll(x, b_t, a_t)

        def paged(q, kp, vp, tables, lengths, **kw):
            if self.paged is None or q.shape[0] >= self.paged[0]:
                self.paged = (q.shape[0], tables, lengths)
            return pa(q, kp, vp, tables, lengths, **kw)

        def chunked(q, kp, vp, tables, starts, lens, **kw):
            if self.chunked is None or q.shape[0] * q.shape[1] > math.prod(self.chunked[:2]):
                self.chunked = (q.shape[0], q.shape[1], tables, starts, lens)
            if q.shape[1] == SPEC_K + 1 and (self.verify is None
                                             or q.shape[0] >= self.verify[0]):
                self.verify = (q.shape[0], q.shape[1], tables, starts, lens)
            return cp(q, kp, vp, tables, starts, lens, **kw)

        def flash(q, k, v, **kw):
            self.flash[(*q.shape[:3], k.shape[2], q.shape[3])] += 1
            return fa(q, k, v, **kw)

        def gram(a):
            self.gram[tuple(a.shape)] += 1
            return ga(a)

        self.ops.lowrank_linear = lowrank
        self.ops.paged_attention = paged
        self.ops.chunked_prefill = chunked
        self.ops.flash_attention = flash
        self.ops.gram_accum = gram
        return self

    def __exit__(self, *exc):
        for k, fn in self._orig.items():
            setattr(self.ops, k, fn)

    def shapes(self) -> dict:
        """Plain-int description of the noted calls (padding rows are the
        rows whose block table is all trash page 0)."""
        out = {"flash": {str(k): n for k, n in self.flash.items()},
               "gram": {str(k): n for k, n in self.gram.items()}}
        if self.lowrank_m:
            out.update(lowrank_m_decode=self.lowrank_m.most_common(1)[0][0],
                       lowrank_m_max=max(self.lowrank_m))
        if self.paged is not None:
            _, pt, pl = self.paged
            out.update(paged_lengths=pl.tolist(),
                       paged_pad_rows=(pt == 0).all(dim=1).tolist())
        if self.chunked is not None:
            _, l_pad, ct, cs, cl = self.chunked
            out.update(chunked_l=l_pad, chunked_starts=cs.tolist(),
                       chunked_lens=cl.tolist(),
                       chunked_pad_rows=(ct == 0).all(dim=1).tolist())
        if self.verify is not None:
            _, _, vt, vs, vl = self.verify
            out.update(verify_starts=vs.tolist(), verify_lens=vl.tolist(),
                       verify_pad_rows=(vt == 0).all(dim=1).tolist())
        return out


def _with_seconds(eng, met) -> dict:
    """``met`` plus the steady-state decode and prefill seconds, which the
    engine keeps in its registry (``serve_*_seconds_total``)."""
    snap = eng.registry.snapshot()
    return dict(met, decode_seconds=snap["serve_decode_seconds_total"],
                prefill_seconds=snap["serve_prefill_seconds_total"])


def _serve_run(torch, model, trace, *, warmup=False, temperature=0.0, **kw):
    """One fresh engine of the serve path's knobs over ``trace`` (captured
    ahead of it with ``warmup``): (engine, metrics, tokens by request id,
    wall seconds of the trace). The engine's graphs are released after the
    run."""
    from repro_torch.launch.serve import serve_trace
    from repro_torch.serve import ContinuousEngine
    eng = ContinuousEngine(model, **ENGINE_KNOBS, **kw)
    if warmup:
        eng.warmup(max_len=max(len(p) + nn for _, p, nn in trace))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    met = _with_seconds(eng, serve_trace(eng, trace, temperature=temperature))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    eng.release_graphs()
    return eng, met, {r.req_id: list(r.out_tokens) for r in eng.finished}, secs


def _check_finished(name, eng, trace, vocab):
    fin = sorted(eng.finished, key=lambda r: r.req_id)
    if len(fin) != len(trace) or any(
            len(r.out_tokens) != nn or not all(0 <= t < vocab for t in r.out_tokens)
            for r, (_, _, nn) in zip(fin, trace)):
        raise Failure(f"serve {name}: requests did not all finish with valid tokens")
    for pool in (eng.pool, eng.draft_pool):
        if pool is not None and pool.available_blocks != pool.usable_blocks:
            raise Failure(f"serve {name}: pages leaked")


def _serve_line(met) -> str:
    return (f"{met['tokens_per_sec']:.1f} new tok/s, {met['decode_tok_per_s']:.1f} decode "
            f"tok/s, mean TTFT {met['mean_ttft_s']:.4f} s, {met['decode_steps']} decode "
            f"steps, {met['preemptions']} preemptions, prefix hit rate "
            f"{met['prefix_hit_rate']:.3f}, {met['decode_compiles']} + "
            f"{met['prefill_compiles']} captures")


def serve_path(torch, ops):
    """``repro_torch.launch.serve.main`` with ``LAUNCHER_ARGS`` (CUDA graphs,
    warmup on, prefix cache at its default) on the serve path's trace, then,
    on the launcher's two models: the same trace through the eager engine
    (the graphs' oracle: identical greedy tokens; its kernel shapes are
    noted for phase 7), a ``SHARED_PREFIX``-token shared-prefix variant with
    the prefix cache on (graphs) and off (eager), identical tokens and a hit
    rate above 0, and a sampled run (``TEMPERATURE``, seed 0 per request as
    the launcher submits) twice on fresh graph engines, identical both
    times. Returns (summary, launcher result, noted kernel shapes)."""
    from repro_torch.configs import get_config
    from repro_torch.core.compress import compression_summary
    from repro_torch.launch import serve as launcher

    vocab = get_config("llama3_1b").vocab_size
    trace = launcher.synthetic_trace(REQUESTS, vocab, seed=SEED,
                                     min_prompt=MIN_PROMPT, max_prompt=MAX_PROMPT,
                                     min_new=NEW_TOKENS, max_new=NEW_TOKENS)
    sp_trace = launcher.synthetic_trace(REQUESTS, vocab, seed=SEED,
                                        min_prompt=MIN_PROMPT, max_prompt=MAX_PROMPT,
                                        min_new=NEW_TOKENS, max_new=NEW_TOKENS,
                                        shared_prefix=SHARED_PREFIX)
    counts = {}
    mark = ops.eager_launch_counts(), ops.replayed_launch_counts()

    def note(what):
        """Launches since the last note, eager and replayed."""
        nonlocal mark
        now = ops.eager_launch_counts(), ops.replayed_launch_counts()
        counts[what] = {kind: {k: now[i][k] - mark[i][k] for k in now[i]}
                        for i, kind in enumerate(("eager", "replayed"))}
        mark = now

    res = launcher.main(LAUNCHER_ARGS, trace=trace)
    torch.cuda.synchronize()
    res["engines"]["coala"].release_graphs()
    note("launcher")

    reports = res["reports"]
    summary = compression_summary(reports)
    for r in reports:
        vals = (r.mu, r.rel_err_weighted, r.rel_err_bound)
        if not all(math.isfinite(v) for v in vals):
            raise Failure(f"compression report not finite: {r}")
        if r.rel_err_weighted < r.rel_err_bound * (1 - 1e-3):
            raise Failure(f"{r.path}: error {r.rel_err_weighted} below the optimum "
                          f"{r.rel_err_bound}")
    if not summary["kept_ratio"] <= 0.6:
        raise Failure(f"kept ratio {summary['kept_ratio']} above 0.6")

    out = {"layers": res["models"]["dense"].cfg.n_layers, "seconds": res["seconds"],
           "compression": summary, "warmup": res["warmup"], "launches": counts}
    tokens = {}
    keys = ("requests", "new_tokens", "tokens_per_sec", "decode_tok_per_s",
            "prefill_tok_per_s", "mean_ttft_s", "max_ttft_s", "decode_steps",
            "prefill_batches", "preemptions", "decode_seconds", "prefill_seconds",
            "decode_compiles", "prefill_compiles", "post_warmup_compiles",
            "warmup_seconds", "prefix_hit_rate", "prefix_hit_tokens", "cached_blocks",
            "cow_copies", "prefix_evictions")
    for name, eng in res["engines"].items():
        met = _with_seconds(eng, res["metrics"][name])
        out[f"serve_{name}"] = {k: met[k] for k in keys}
        _check_finished(name, eng, trace, vocab)
        if met["preemptions"] < 1:
            raise Failure(f"serve {name}: the trace was meant to preempt")
        if not eng.cuda_graphs or met["post_warmup_compiles"] != 0:
            raise Failure(f"serve {name}: expected CUDA graphs and 0 post-warmup "
                          f"compiles, got {met['post_warmup_compiles']}")
        tokens[name] = {r.req_id: list(r.out_tokens) for r in eng.finished}
        log(f"  [{name}] graphs: {_serve_line(met)}; warmup {met['warmup_seconds']:.2f} s "
            f"for {int(res['warmup'][name]['decode_signatures'])} decode + "
            f"{int(res['warmup'][name]['prefill_signatures'])} prefill signatures, "
            f"{met['post_warmup_compiles']} post-warmup compiles")
    same = sum(tokens["dense"][i][0] == tokens["coala"][i][0] for i in tokens["dense"])
    log(f"  first tokens equal between dense and COALA: {same}/{REQUESTS}")
    # later phases need the tokens, not the engines and their weight copies
    res["tokens"] = tokens
    del res["engines"], eng

    with KernelCalls(ops) as calls:
        for name, m in res["models"].items():
            eng, met, toks, secs = _serve_run(torch, m, trace, cuda_graphs=False)
            _check_finished(f"{name} eager", eng, trace, vocab)
            out[f"serve_{name}_eager"] = dict({k: met[k] for k in keys}, seconds=secs)
            ok = toks == tokens[name]
            log(f"  [{name}] eager oracle: {_serve_line(met)}; {secs:.3f} s; greedy tokens "
                f"{'identical to' if ok else 'DIFFER from'} the graphs'")
            if not ok:
                raise Failure(f"serve {name}: CUDA graphs and the eager engine disagree")
            del eng
    note("eager oracle")

    for name, m in res["models"].items():
        on_eng, on, on_toks, on_s = _serve_run(torch, m, sp_trace)
        off_eng, off, off_toks, off_s = _serve_run(torch, m, sp_trace, prefix_cache=False,
                                                   cuda_graphs=False)
        for what, eng in (("cache on", on_eng), ("cache off", off_eng)):
            _check_finished(f"{name} shared prefix {what}", eng, sp_trace, vocab)
        out[f"shared_prefix_{name}"] = {
            "on": dict({k: on[k] for k in keys}, seconds=on_s),
            "off": dict({k: off[k] for k in keys}, seconds=off_s)}
        ok = on_toks == off_toks and on["prefix_hit_rate"] > 0
        log(f"  [{name}] shared prefix {SHARED_PREFIX}, cache on (graphs): {_serve_line(on)}, "
            f"{on['cow_copies']} COW copies, {on['prefix_evictions']} evictions")
        log(f"  [{name}] shared prefix {SHARED_PREFIX}, cache off (eager): {_serve_line(off)}; "
            f"tokens {'identical' if on_toks == off_toks else 'DIFFERENT'}")
        if not ok:
            raise Failure(f"serve {name}: shared-prefix run: hit rate "
                          f"{on['prefix_hit_rate']}, tokens equal {on_toks == off_toks}")
        del on_eng, off_eng
    note("shared prefix")

    for name, m in res["models"].items():
        runs = [_serve_run(torch, m, trace, temperature=TEMPERATURE) for _ in range(2)]
        for i, (eng, _, _, _) in enumerate(runs):
            _check_finished(f"{name} sampled {i}", eng, trace, vocab)
        met = runs[0][1]
        out[f"sampled_{name}"] = {k: met[k] for k in keys}
        ok = runs[0][2] == runs[1][2]
        diff = sum(a != b for i in tokens[name] for a, b in zip(tokens[name][i], runs[0][2][i]))
        log(f"  [{name}] sampled at T {TEMPERATURE}: {_serve_line(met)}; second run "
            f"{'identical' if ok else 'DIFFERENT'}; {diff} of "
            f"{sum(map(len, tokens[name].values()))} tokens differ from greedy")
        if not ok:
            raise Failure(f"serve {name}: two sampled runs with the same seeds differ")
        del runs
    note("sampled")
    torch.cuda.empty_cache()
    log(f"  launches by run (eager / replayed): {json.dumps(counts)}")
    return out, res, calls.shapes()


def _phase4_tokens(res):
    return res["tokens"]


SPEC_KEYS = ("spec_rounds", "spec_proposed_tokens", "spec_accepted_tokens",
             "spec_accept_rate")


def _spec_line(met) -> str:
    rounds = max(met["spec_rounds"], 1)
    return (f"{met['spec_rounds']} rounds, accept rate {met['spec_accept_rate']:.3f} "
            f"({met['spec_accepted_tokens']}/{met['spec_proposed_tokens']}), "
            f"{met['decode_seconds'] / rounds * 1e3:.3f} ms per steady round")


def serve_spec_path(torch, ops, res):
    """``repro_torch.launch.serve.main`` with ``LAUNCHER_ARGS + SPEC_ARGS``
    on phase 4's trace, handed phase 4's result (``reuse``: its models and
    calibrator, so only the draft is compressed): both targets serve
    speculatively through CUDA graphs, greedy tokens identical to phase 4's
    non-speculative ones, 0 post-warmup captures; then, on the same models
    and draft, the eager speculative engine (identical tokens; its kernel
    shapes are noted for phase 7) and a sampled run at ``TEMPERATURE``
    twice on fresh graph engines (identical). Returns (summary, noted
    kernel shapes)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher

    vocab = get_config("llama3_1b").vocab_size
    trace, base = res["trace"], _phase4_tokens(res)
    keys = ("requests", "new_tokens", "tokens_per_sec", "decode_tok_per_s",
            "mean_ttft_s", "decode_steps", "decode_seconds", "preemptions",
            "decode_compiles", "prefill_compiles", "post_warmup_compiles",
            "warmup_seconds") + SPEC_KEYS
    TRACE_OUT.parent.mkdir(parents=True, exist_ok=True)
    spec = launcher.main(LAUNCHER_ARGS + SPEC_ARGS + TELEMETRY_ARGS, trace=trace,
                         reuse=res)
    torch.cuda.synchronize()
    spec["engines"]["coala"].release_graphs()
    draft = spec["draft"]
    out = {"seconds": spec["seconds"], "warmup": spec["warmup"],
           "telemetry": check_telemetry(spec, len(trace))}
    for name, eng in spec["engines"].items():
        met = _with_seconds(eng, spec["metrics"][name])
        _check_finished(f"{name} spec", eng, trace, vocab)
        toks = {r.req_id: list(r.out_tokens) for r in eng.finished}
        w = spec["warmup"][name]
        out[f"spec_{name}"] = {k: met[k] for k in keys}
        log(f"  [{name}] spec graphs: {_serve_line(met)}; {_spec_line(met)}; warmup "
            f"{w['warmup_seconds']:.2f} s for {int(w['decode_signatures'])} spec-round + "
            f"{int(w['prefill_signatures'])} x 2 prefill signatures; greedy tokens "
            f"{'identical to' if toks == base[name] else 'DIFFER from'} phase 4's")
        if toks != base[name]:
            raise Failure(f"serve-spec {name}: tokens differ from the non-speculative run")
        if (not eng.cuda_graphs or met["post_warmup_compiles"] != 0
                or met["spec_rounds"] < 1):
            raise Failure(f"serve-spec {name}: expected graphs, spec rounds and 0 "
                          f"post-warmup compiles, got {met['post_warmup_compiles']}")
    spec["engines"].clear()                 # their weight copies
    del eng
    with KernelCalls(ops) as calls:
        for name, m in res["models"].items():
            eng, met, toks, secs = _serve_run(torch, m, trace, cuda_graphs=False,
                                              draft_model=draft, spec_k=SPEC_K)
            _check_finished(f"{name} spec eager", eng, trace, vocab)
            out[f"spec_{name}_eager"] = dict({k: met[k] for k in keys}, seconds=secs)
            ok = toks == base[name]
            log(f"  [{name}] spec eager: {_serve_line(met)}; {_spec_line(met)}; greedy "
                f"tokens {'identical' if ok else 'DIFFERENT'}")
            if not ok:
                raise Failure(f"serve-spec {name}: the eager spec engine disagrees")
            del eng
    for name, m in res["models"].items():
        runs = [_serve_run(torch, m, trace, temperature=TEMPERATURE, draft_model=draft,
                           spec_k=SPEC_K) for _ in range(2)]
        for i, (eng, _, _, _) in enumerate(runs):
            _check_finished(f"{name} spec sampled {i}", eng, trace, vocab)
        met = runs[0][1]
        out[f"spec_sampled_{name}"] = {k: met[k] for k in keys}
        ok = runs[0][2] == runs[1][2]
        log(f"  [{name}] spec sampled at T {TEMPERATURE}: {_serve_line(met)}; "
            f"{_spec_line(met)}; second run {'identical' if ok else 'DIFFERENT'}")
        if not ok:
            raise Failure(f"serve-spec {name}: two sampled runs with the same seeds differ")
        del runs
    res["spec_draft"] = draft              # profiled alone with --profile
    del spec, draft
    torch.cuda.empty_cache()
    return out, calls.shapes()


def _nesting_ok(events) -> bool:
    """Per thread, complete spans nest like a call stack."""
    by_tid = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X":
            by_tid[e["tid"]].append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in evs:
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]:
                stack.pop()
            if stack and e["ts"] + e["dur"] > stack[-1]["ts"] + stack[-1]["dur"] + 1e-3:
                return False
            stack.append(e)
    return True


def check_telemetry(spec, n_requests) -> dict:
    """The telemetry of phase 4b's launcher run (``TELEMETRY_ARGS``): the
    written trace is strict JSON with the serving span taxonomy and spans
    nesting per thread; each engine's ``metrics()`` keys are the JAX golden
    set plus the speculative keys; the flight recorder holds each request's
    lifecycle in both engines."""
    from repro_torch.obs import EVENT_TYPES

    def strict(c):
        raise Failure(f"trace {TRACE_OUT}: non-strict JSON constant {c}")

    doc = json.loads(TRACE_OUT.read_text(), parse_constant=strict)
    evs = doc["traceEvents"]
    names = collections.Counter(e["name"] for e in evs)
    want = {"serve.warmup", "serve.admit", "serve.prefill_batch",
            "serve.spec_draft_prefill", "serve.spec_step"}
    if not want <= set(names) or not _nesting_ok(evs):
        raise Failure(f"trace: spans {sorted(want - set(names))} missing or "
                      f"not nested (nested: {_nesting_ok(evs)})")
    for name, eng in spec["engines"].items():
        keys = set(eng.metrics())
        if keys != METRICS_KEYS | SPEC_METRICS_KEYS:
            raise Failure(f"metrics() keys of {name}: "
                          f"{sorted(keys ^ (METRICS_KEYS | SPEC_METRICS_KEYS))} "
                          "differ from the golden set")
    fl = spec["flight"]
    kinds = collections.Counter(e["event"] for e in fl.events())
    if (fl.dropped or not set(kinds) <= EVENT_TYPES
            or not kinds["submit"] == kinds["finish"] == 2 * n_requests
            or kinds["spec_round"] < 1):
        raise Failure(f"flight recorder: {dict(kinds)}, {fl.dropped} dropped")
    log(f"  telemetry: {len(evs)} trace events in {TRACE_OUT.name} (strict JSON, spans "
        f"nested per thread; {names['serve.spec_step']} spec steps, "
        f"{names['serve.prefill_batch']} prefill batches); metrics() keys = golden + "
        f"spec; flight recorder {len(fl)} events: {dict(kinds)}")
    return {"trace_events": len(evs), "spans": dict(names), "flight": dict(kinds)}


def _logits_at(eng, tok: int):
    """Logits of one decode step of ``tok`` at position 0 over the trash page:
    a replay of the engine's captured (1, 1) decode graph, or the eager
    forward of a ``cuda_graphs=False`` engine."""
    from repro_torch.serve.engine import _pack
    sig = ("decode", 1, 1)
    logits, _ = eng._run(sig, _pack(sig, tok=[[tok]], pos=[0], tables=[[0]]))
    return logits.clone()


def serve_recalib_path(torch, ops, res, smi):
    """Live recompression at full width. ``repro_torch.launch.serve.main``
    with ``LAUNCHER_ARGS + RECALIB_ARGS`` on ``RECALIB_REQUESTS`` requests of
    phase 4's ranges, handed phase 4's result: the COALA engine streams its
    sampled traffic through the dense model (the flash kernel) into traffic
    calibration, and once the bound clears swaps the solved factors into its
    captured graphs mid-trace (at least one swap, requests in flight, every
    request completes, 0 post-warmup captures, residual within the policy).
    Then: (b) the same engine's graphs, captured before the swap, give the
    logits (1e-3) of an eager engine on the solved model, and its greedy
    tokens on a short fresh trace; (c) a fresh graph engine on phase 4's
    COALA model (prefix cache off) serves phase 4's trace (tokens equal
    phase 4's), then again with identity swaps every
    ``IDENTITY_SWAP_EVERY`` steps (equal), then with the solved model
    swapped in: the rates before and after the swap; (d) capture throughput
    of the traffic calibrator alone on ``CAPTURE_PROMPTS`` prompts; the caller's
    COALA model is bit-equal to what it was before the phase."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import ContinuousEngine, TrafficCalibrator, recalibrate
    from repro_torch.models.common import ParallelCtx

    vocab = get_config("llama3_1b").vocab_size
    coala = res["models"]["coala"]
    before = {k: v.clone() for k, v in coala.state_dict().items()}
    trace = launcher.synthetic_trace(RECALIB_REQUESTS, vocab, seed=SEED,
                                     min_prompt=MIN_PROMPT, max_prompt=MAX_PROMPT,
                                     min_new=NEW_TOKENS, max_new=NEW_TOKENS)
    solved = []
    solve = recalibrate.RecalibWorker._solve

    def noting_solve(self, snap):
        out = solve(self, snap)
        solved.append(out)
        return out

    recalibrate.RecalibWorker._solve = noting_solve
    try:
        rec = launcher.main(LAUNCHER_ARGS + RECALIB_ARGS, trace=trace, reuse=res)
    finally:
        recalibrate.RecalibWorker._solve = solve
    torch.cuda.synchronize()
    eng, worker = rec["engines"]["coala"], rec["workers"]["coala"]
    met = _with_seconds(eng, rec["metrics"]["coala"])
    sm = worker.summary()
    swaps = [e for e in rec["flight"].events() if e["event"] == "recalib_swap"]
    _check_finished("recalib coala", eng, trace, vocab)
    _check_finished("recalib dense", rec["engines"].pop("dense"), trace, vocab)
    ok = (sm["swaps"] >= 1 and met["post_warmup_compiles"] == 0 and eng.cuda_graphs
          and sm["residual_excess"] <= worker.policy.max_residual_excess
          and swaps and swaps[0]["in_flight"] > 0
          and set(eng.metrics()) == METRICS_KEYS | RECALIB_METRICS_KEYS)
    log(f"  [coala recalib] {smi}: {sm['swaps']} hot-swaps over {sm['solve_attempts']} "
        f"solve attempts, {sm['sampled_requests']} sampled requests / "
        f"{sm['captured_tokens']} captured tokens, data clearance {sm['clearance']:.2f}, "
        f"residual excess {sm['residual_excess']:.4f}, status {sm['status']}; "
        f"{met['post_warmup_compiles']} post-warmup compiles; first swap at step "
        f"{swaps[0]['step'] if swaps else None} with "
        f"{swaps[0]['in_flight'] if swaps else 0} requests in flight; solve "
        f"{worker.last_solve_seconds:.2f} s, swap {worker.last_swap_seconds * 1e3:.3f} ms")
    log(f"  [coala recalib] graphs: {_serve_line(met)}")
    if not ok:
        raise Failure(f"recalib: expected a bound-cleared swap with requests in flight "
                      f"and 0 post-warmup compiles; got {sm}, swaps {swaps}, "
                      f"{met['post_warmup_compiles']} post-warmup compiles")
    new = [r for r in solved if r is not None][-1][0]
    out = {"summary": sm, "metrics": {k: met[k] for k in (
               "tokens_per_sec", "decode_tok_per_s", "mean_ttft_s", "decode_steps",
               "preemptions", "post_warmup_compiles", "decode_seconds")},
           "solve_seconds": worker.last_solve_seconds,
           "swap_ms": worker.last_swap_seconds * 1e3,
           "first_swap": swaps[0], "seconds": rec["seconds"]}

    # (b) the launcher's engine: graphs captured before the swap read the
    # solved factors; its worker cannot solve again on this short trace
    oracle = ContinuousEngine(new, cuda_graphs=False, **ENGINE_KNOBS)
    err = compare("swapped graphs vs eager on the solved model, logits",
                  _logits_at(eng, 7), _logits_at(oracle, 7), TOL_SERVE[("float32",
                                                                        "float32")])
    short = launcher.synthetic_trace(2, vocab, seed=SEED + 1, min_prompt=8, max_prompt=8,
                                     min_new=4, max_new=4)
    attempts, done = worker.solve_attempts, len(eng.finished)
    launcher.serve_trace(eng, short)
    toks = [list(r.out_tokens)
            for r in sorted(eng.finished[done:], key=lambda r: r.req_id)]
    _, _, ref, _ = _serve_run(torch, new, short, cuda_graphs=False)
    same = toks == [ref[i] for i in sorted(ref)]
    log(f"  [coala recalib] the swapped engine's graphs on {len(short)} fresh requests: "
        f"greedy tokens {'identical to' if same else 'DIFFER from'} the eager engine on "
        f"the solved model; {eng.post_warmup_compiles()} post-warmup compiles")
    if not same or eng.post_warmup_compiles() or worker.solve_attempts != attempts:
        raise Failure("recalib: the swapped graphs disagree with the solved model")
    eng.release_graphs()
    out["swapped_logits_err"] = err

    # (c) rates before and after a swap on one warmed engine, and identity
    # swaps mid-trace
    p4 = res["trace"]
    base = _phase4_tokens(res)["coala"]
    # no prefix cache: each run recomputes its prompts, so the three runs'
    # rates compare (and no page computed by the old weights is reused)
    e2 = ContinuousEngine(coala, prefix_cache=False, **ENGINE_KNOBS)
    e2.warmup(max_len=max(len(p) + nn for _, p, nn in p4))
    rates = {}

    def run(label, swap_every=0):
        e2.reset_metrics()
        n0, pending, step = e2._next_id, list(p4), 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while pending or e2.has_work():
            while pending and pending[0][0] <= step:
                _, prompt, nn = pending.pop(0)
                e2.submit(prompt, nn)
            e2.step()
            step += 1
            if swap_every and step % swap_every == 0 and e2.scheduler.running:
                e2.hot_swap(copy.deepcopy(coala))
        torch.cuda.synchronize()
        m = _with_seconds(e2, e2.metrics())
        rates[label] = dict(tokens_per_sec=m["tokens_per_sec"],
                            decode_tok_per_s=m["decode_tok_per_s"],
                            mean_ttft_s=m["mean_ttft_s"],
                            seconds=time.perf_counter() - t0)
        return {r.req_id - n0: list(r.out_tokens) for r in e2.finished}

    t_before = run("before swap")
    t_identity = run("identity swaps", IDENTITY_SWAP_EVERY)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e2.hot_swap(new)
    swap_ms = (time.perf_counter() - t0) * 1e3
    run("after swap")
    ok = (t_before == base and t_identity == base and e2.post_warmup_compiles() == 0)
    e2.release_graphs()
    log(f"  [coala swap] {smi}: phase 4's trace through graphs before the swap "
        f"{rates['before swap']['tokens_per_sec']:.1f} new tok/s "
        f"({rates['before swap']['decode_tok_per_s']:.1f} decode), with identity swaps "
        f"every {IDENTITY_SWAP_EVERY} steps {rates['identity swaps']['tokens_per_sec']:.1f} "
        f"({rates['identity swaps']['decode_tok_per_s']:.1f}), after swapping the solved "
        f"model in ({swap_ms:.3f} ms) {rates['after swap']['tokens_per_sec']:.1f} "
        f"({rates['after swap']['decode_tok_per_s']:.1f}); phase 4: "
        f"{res['metrics']['coala']['tokens_per_sec']:.1f} "
        f"({res['metrics']['coala']['decode_tok_per_s']:.1f}); greedy tokens before and "
        f"with identity swaps {'identical to' if ok else 'DIFFERENT from'} phase 4's, "
        f"{e2.post_warmup_compiles()} post-warmup compiles")
    if not ok:
        raise Failure("recalib: an identity swap changed tokens or a swap captured")
    out.update(rates=rates, swap_ms_warm=swap_ms)

    # (d) capture throughput of traffic calibration alone (the dense model,
    # flash attention), on the trace's prompts
    tcal = TrafficCalibrator(res["models"]["dense"], ctx=ParallelCtx(use_pallas=True))
    prompts = [p for _, p, _ in trace[:CAPTURE_PROMPTS]]
    n_tok = sum(map(len, prompts))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts:
        tcal.capture_tokens(p)
    torch.cuda.synchronize()
    cap_s = time.perf_counter() - t0
    log(f"  [capture] {smi}: {len(prompts)} prompts, {n_tok} tokens through the "
        f"dense model into {len(tcal.streams)} R factors in {cap_s:.3f} s: "
        f"{n_tok / cap_s:.1f} tokens/s")
    out.update(capture_tokens=n_tok, capture_seconds=cap_s,
               capture_tokens_per_s=n_tok / cap_s)
    changed = [k for k, v in coala.state_dict().items() if not torch.equal(v, before[k])]
    if changed:
        raise Failure(f"recalib: the caller's COALA model changed: {changed[:3]}")
    log("  the caller's COALA model is bit-equal to what it was before the phase")
    del rec, eng, e2, oracle, new, solved, before, tcal
    torch.cuda.empty_cache()
    return out


def serve_dtypes_path(torch, res):
    """Phase 4's models through graphs (warmup first) on its trace at each
    ``DTYPE_RUNS`` (compute, cache) pair: the rates, 0 post-warmup captures,
    and the share of greedy tokens equal, position by position, to phase 4's
    fp32 run's, with the first divergent (request, position). bf16 may
    legitimately part from the fp32 trajectory: that is reported, not
    failed."""
    from repro_torch.configs import get_config

    vocab = get_config("llama3_1b").vocab_size
    trace, base = res["trace"], _phase4_tokens(res)
    out = {}
    for name, cdt, kdt in DTYPE_RUNS:
        eng, met, toks, secs = _serve_run(
            torch, res["models"][name], trace, warmup=True,
            compute_dtype=getattr(torch, cdt), cache_dtype=getattr(torch, kdt))
        label = f"{name} {cdt}/{kdt} cache"
        _check_finished(label, eng, trace, vocab)
        if met["post_warmup_compiles"] != 0:
            raise Failure(f"serve {label}: {met['post_warmup_compiles']} post-warmup "
                          "compiles")
        pairs = [(i, j) for i in sorted(toks) for j in range(len(toks[i]))]
        same = sum(toks[i][j] == base[name][i][j] for i, j in pairs)
        first = next(((i, j) for i, j in pairs if toks[i][j] != base[name][i][j]), None)
        out[f"{name}_{cdt}_{kdt}"] = dict(
            tokens_per_sec=met["tokens_per_sec"], decode_tok_per_s=met["decode_tok_per_s"],
            mean_ttft_s=met["mean_ttft_s"], warmup_seconds=met["warmup_seconds"],
            post_warmup_compiles=met["post_warmup_compiles"], seconds=secs,
            equal_share=same / len(pairs), first_divergence=first)
        log(f"  [{label}] graphs: {_serve_line(met)}; warmup {met['warmup_seconds']:.2f} s; "
            f"{same}/{len(pairs)} greedy tokens equal to the fp32 run's, first divergent "
            f"(request, position): {first}")
        del eng
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 5: the compression path at full width, through its launcher
# ---------------------------------------------------------------------------

def _nonfinite(reports):
    return [r.path for r in reports
            if not all(math.isfinite(v) for v in (r.rel_err_weighted, r.mu))]


def compress_path(torch, ops):
    """``repro_torch.launch.compress.main`` with ``COMPRESS_ARGS``, once with
    COALA and once with SVD-LLM, inside one launch-count window. Checks
    COALA's result; records SVD-LLM's non-finite layers (the paper's claim:
    its Cholesky breaks down on the rank-deficient Grams of 2048 tokens).
    Returns (summary, the COALA run's result, noted kernel shapes)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import compress as launcher

    cfg = dataclasses.replace(get_config("llama3_1b"), n_layers=COMPRESS_LAYERS)
    out = {"layers": COMPRESS_LAYERS, "seconds": {}, "summaries": {}, "nonfinite": {}}
    with KernelCalls(ops) as calls:
        runs = {}
        for method in ("coala", "svd_llm"):
            t0 = time.perf_counter()
            res = launcher.main(COMPRESS_ARGS + ["--method", method], cfg=cfg)
            torch.cuda.synchronize()
            out["seconds"][method] = dict(res["seconds"],
                                          total=time.perf_counter() - t0)
            runs[method] = res
            if method != "coala":
                # keep the reports, free the models of this run
                runs[method] = {k: res[k] for k in ("summary", "reports")}
            del res
    coala, svd_llm = runs["coala"], runs["svd_llm"]
    s = coala["summary"]
    for r in coala["reports"]:
        vals = (r.mu, r.rel_err_weighted, r.rel_err_bound)
        if not all(math.isfinite(v) for v in vals):
            raise Failure(f"coala report not finite: {r}")
        if r.rel_err_weighted < r.rel_err_bound * (1 - 1e-3):
            raise Failure(f"{r.path}: error {r.rel_err_weighted} below the optimum "
                          f"{r.rel_err_bound}")
    if not s["kept_ratio"] <= 0.6:
        raise Failure(f"kept ratio {s['kept_ratio']} above 0.6")
    if not (math.isfinite(s["base_ce"]) and math.isfinite(s["compressed_ce"])):
        raise Failure(f"coala CE not finite: {s}")
    for method, res in runs.items():
        bad = _nonfinite(res["reports"])
        out["summaries"][method], out["nonfinite"][method] = res["summary"], len(bad)
        log(f"  {method}: {json.dumps(res['summary'])}")
        log(f"  {method}: {len(bad)} of {len(res['reports'])} layers non-finite"
            + (f": {bad}" if bad else ""))
    log(f"  svd_llm compressed CE finite: {math.isfinite(svd_llm['summary']['compressed_ce'])}")
    return out, coala, calls.shapes()


def extra_methods(torch, coala):
    """svd, svd_llm_v2 and asvd through ``core.compress.compress_model`` on
    the COALA run's trained model and calibrator, each evaluated as the
    launcher evaluates. Only block 0's seven linears are compressed: at
    full depth svd_llm_v2 alone takes ~265 s (16 SVDs of the 8192² Gram),
    which would take the script past its time budget."""
    from repro_torch.config import CompressConfig
    from repro_torch.core.calibrate import Calibrator
    from repro_torch.core.compress import compress_model, compression_summary
    from repro_torch.launch import compress as launcher

    model = coala["model"]
    cal = Calibrator()
    cal.streams = {p: st for p, st in coala["calibrator"].streams.items()
                   if p.startswith(EXTRA_PREFIX)}
    pipe = launcher.make_pipeline(model.cfg, model.device)
    out = {"seconds": {}, "summaries": {}, "nonfinite": {}}
    for method in EXTRA_METHODS:
        t0 = time.perf_counter()
        cm, reports = compress_model(model, cal, CompressConfig(
            method=method, ratio=0.6, lam=4.0, mu=-1.0))
        torch.cuda.synchronize()
        out["seconds"][method] = time.perf_counter() - t0
        s = compression_summary(reports)
        s.update(method=method, base_ce=coala["summary"]["base_ce"],
                 compressed_ce=launcher.eval_ce(cm, pipe))
        del cm
        bad = _nonfinite(reports)
        out["summaries"][method], out["nonfinite"][method] = s, len(bad)
        log(f"  {method} ({out['seconds'][method]:.1f} s): {json.dumps(s)}")
        log(f"  {method}: {len(bad)} of {len(reports)} layers non-finite")
    return out


# ---------------------------------------------------------------------------
# phase 6: Gram calibration at full width
# ---------------------------------------------------------------------------

def gram_path(torch, ops, coala):
    """``calibrate_model(collect_gram=True)`` with the kernel ctx on the COALA
    run's trained model and calibration batches; each Gram against RᵀR of
    the same run. Returns (summary, noted kernel shapes)."""
    from repro_torch.core.calibrate import calibrate_model
    from repro_torch.launch.compress import KERNEL_CTX

    with KernelCalls(ops) as calls:
        t0 = time.perf_counter()
        cal = calibrate_model(coala["model"], coala["calib_batches"],
                              collect_gram=True, ctx=KERNEL_CTX)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    rf = cal.r_factors()
    worst, worst_path = 0.0, ""
    for p, g in cal.grams.items():
        rel = (torch.linalg.norm(g - rf[p].T @ rf[p]) / torch.linalg.norm(g)).item()
        if not rel <= worst:
            worst, worst_path = rel, p
    n_paths = len(cal.grams)
    log(f"  {n_paths} Grams in {secs:.2f} s; max ||G - RᵀR||_F / ||G||_F = "
        f"{worst:.3e} ({worst_path})")
    if n_paths != 7 * COMPRESS_LAYERS or not worst <= 1e-4:
        raise Failure(f"gram path: {n_paths} Grams, max relative gap {worst}")
    return {"seconds": secs, "paths": n_paths, "max_rel_gap_to_rtr": worst}, calls.shapes()


# ---------------------------------------------------------------------------
# phase 8: gemma2_27b at full width through the serve launcher
# ---------------------------------------------------------------------------

# gemma2_27b (src/repro_torch/configs/gemma2_27b.py) at full width, its depth
# cut from 46 layers to 2: layer 0 local (window 4096), layer 1 global. The
# launcher calibrates on 2 x 8 x 256 seeded tokens (the global layer through
# the flash kernel, the local one through the masked einsum) and compresses
# with COALA at ratio 0.6, λ 4. Traffic: phase 4's 8 staggered requests plus
# one of 4400 prompt tokens arriving after them, whose prefill and decode
# attend past the local layer's window. Length buckets up to 4608 (the long
# suffix), the prefix cache off (phase 4 holds it), a 512-page pool (no
# preemption).
GEMMA_LAYERS, LONG_PROMPT = 2, 4400
GEMMA_KNOBS = dict(block_size=16, num_blocks=512, max_running=8,
                   prefill_bucket_sizes=(16, 32, 64, 128, 256, 4608), prefix_cache=False)
GEMMA_ARGS = ["--continuous", "--arch", "gemma2_27b", "--compress-ratio", "0.6",
              "--requests", str(REQUESTS), "--prompt-len", "256",
              "--new-tokens", str(NEW_TOKENS),
              "--block-size", str(GEMMA_KNOBS["block_size"]),
              "--num-blocks", str(GEMMA_KNOBS["num_blocks"]),
              "--max-running", str(GEMMA_KNOBS["max_running"]),
              "--prefill-bucket-sizes",
              ",".join(map(str, GEMMA_KNOBS["prefill_bucket_sizes"])),
              "--prefix-cache", "off", "--warmup", "on", "--seed", str(SEED),
              "--device", "cuda"]
SERVE_KEYS = ("requests", "new_tokens", "tokens_per_sec", "decode_tok_per_s",
              "prefill_tok_per_s", "mean_ttft_s", "max_ttft_s", "decode_steps",
              "prefill_batches", "preemptions", "decode_compiles", "prefill_compiles",
              "post_warmup_compiles", "warmup_seconds")


STEP_PEAKS = []             # per-step peaks (GB) of the path running now


class SolveTimes:
    """Seconds of each compression solve (``core.compress._solve``: one
    projection, or one expert's slice of a bank) made inside the ``with``
    block, by the shape (d_out, d_in) of W; the card is synchronised around
    each solve, so a solve's time is its own."""

    def __init__(self, torch):
        self.torch = torch
        self.by_shape = collections.defaultdict(list)

    def __enter__(self):
        from repro_torch.core import compress as cm
        self._cm, orig = cm, cm._solve

        def solve(w_mat, r_factor, rank, ccfg):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(w_mat, r_factor, rank, ccfg)
            self.torch.cuda.synchronize()
            self.by_shape[tuple(w_mat.shape)].append(time.perf_counter() - t0)
            return out
        self._orig, cm._solve = orig, solve
        return self

    def __exit__(self, *exc):
        self._cm._solve = self._orig

    def summary(self) -> dict:
        return {f"{o}x{i}": dict(solves=len(s), mean_s=sum(s) / len(s), max_s=max(s))
                for (o, i), s in self.by_shape.items()}


def _peak_step(torch, peaks: dict, key: str) -> None:
    """Peak memory (GB) since the last reset under ``key`` (also noted for
    the path's own peak, ``path_window``); then reset for the next step."""
    peaks[key] = torch.cuda.max_memory_allocated() / 1e9
    STEP_PEAKS.append(peaks[key])
    torch.cuda.reset_peak_memory_stats()


def family_serve(torch, ops, label, cfg, args, knobs, trace, *, on_launch, on_graphs=None):
    """``repro_torch.launch.serve.main`` with ``args`` on the depth-cut ``cfg``
    (handed as ``cfg``): dense and COALA through CUDA graphs (warmup, 0
    post-warmup captures), then both through the eager engine with ``knobs``,
    greedy tokens identical. The kernel shapes of the eager runs are noted
    for phase 7. ``on_launch(res, out)`` checks the launcher's result (its
    models and reports) and adds to the summary ``out``; ``on_graphs(name,
    eng, met)`` checks each graph engine. Returns (summary, noted kernel
    shapes)."""
    from repro_torch.core.compress import compression_summary
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import ContinuousEngine

    t0 = time.perf_counter()
    with SolveTimes(torch) as solves:
        res = launcher.main(args, trace=trace, cfg=cfg)
    torch.cuda.synchronize()
    res["engines"]["coala"].release_graphs()
    out = {"layers": cfg.n_layers, "seconds": dict(res["seconds"]),
           "compression": compression_summary(res["reports"]),
           "warmup": res["warmup"], "peak_gb": {}, "solve_s": solves.summary()}
    out["seconds"]["launcher"] = time.perf_counter() - t0
    log(f"  COALA solves by W shape (d_out x d_in): {json.dumps(out['solve_s'])}")
    _peak_step(torch, out["peak_gb"], "launcher")
    on_launch(res, out)
    tokens = {}
    for name, eng in res["engines"].items():
        met = res["metrics"][name]
        out[f"serve_{name}"] = {k: met[k] for k in SERVE_KEYS}
        _check_finished(f"{label} {name}", eng, trace, cfg.vocab_size)
        if not eng.cuda_graphs or met["post_warmup_compiles"] != 0:
            raise Failure(f"{label} {name}: expected CUDA graphs and 0 post-warmup "
                          f"captures, got {met['post_warmup_compiles']}")
        if on_graphs is not None:
            on_graphs(name, eng, met)
        tokens[name] = {r.req_id: list(r.out_tokens) for r in eng.finished}
        log(f"  [{label} {name}] graphs: {_serve_line(met)}; warmup "
            f"{met['warmup_seconds']:.2f} s for "
            f"{int(res['warmup'][name]['decode_signatures'])} decode + "
            f"{int(res['warmup'][name]['prefill_signatures'])} prefill signatures")
    models = res["models"]
    del res, eng
    torch.cuda.empty_cache()
    with KernelCalls(ops) as calls:
        for name, m in models.items():
            eng = ContinuousEngine(m, cuda_graphs=False, **knobs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            met = launcher.serve_trace(eng, trace)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            _check_finished(f"{label} {name} eager", eng, trace, cfg.vocab_size)
            toks = {r.req_id: list(r.out_tokens) for r in eng.finished}
            out[f"serve_{name}_eager"] = dict({k: met[k] for k in SERVE_KEYS},
                                              seconds=secs)
            _peak_step(torch, out["peak_gb"], f"eager_{name}")
            ok = toks == tokens[name]
            log(f"  [{label} {name}] eager: {_serve_line(met)}; {secs:.3f} s; greedy "
                f"tokens {'identical to' if ok else 'DIFFER from'} the graphs'")
            if not ok:
                raise Failure(f"{label} {name}: CUDA graphs and the eager engine disagree")
            del eng
    log(f"  seconds: {json.dumps(out['seconds'])}; peak memory (GB): "
        f"{json.dumps(out['peak_gb'])}")
    del models
    torch.cuda.empty_cache()
    return out, calls.shapes()


def gemma2_path(torch, ops):
    """``family_serve`` on gemma2_27b cut to ``GEMMA_LAYERS`` with
    ``GEMMA_ARGS``, on phase 4's trace plus the long prompt; some noted call
    must attend past the local window. Returns (summary, noted kernel
    shapes)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import synthetic_trace

    cfg = dataclasses.replace(get_config("gemma2_27b"), n_layers=GEMMA_LAYERS)
    if [cfg.layer_is_local_attn(i) for i in range(GEMMA_LAYERS)] != [True, False]:
        raise Failure("gemma2 depth cut: expected one local and one global layer")
    trace = synthetic_trace(REQUESTS, cfg.vocab_size, seed=SEED,
                            min_prompt=MIN_PROMPT, max_prompt=MAX_PROMPT,
                            min_new=NEW_TOKENS, max_new=NEW_TOKENS)
    long_prompt = np.random.RandomState(SEED + 7).randint(
        0, cfg.vocab_size, LONG_PROMPT).astype(np.int32)
    trace.append((trace[-1][0] + 2, long_prompt, NEW_TOKENS))

    def on_launch(res, out):
        for r in res["reports"]:
            if not all(math.isfinite(v) for v in (r.mu, r.rel_err_weighted,
                                                  r.rel_err_bound)):
                raise Failure(f"gemma2 compression report not finite: {r}")

    out, shapes = family_serve(torch, ops, "gemma2", cfg, GEMMA_ARGS, GEMMA_KNOBS, trace,
                               on_launch=on_launch)
    long_rows = [n for n in shapes.get("paged_lengths", []) if n > cfg.local_window]
    if shapes.get("chunked_l", 0) < LONG_PROMPT or not long_rows:
        raise Failure(f"gemma2: no noted call attended past the window: {shapes}")
    return out, shapes


# ---------------------------------------------------------------------------
# phase 9: deepseek_moe_16b at full width through the compress launcher
# ---------------------------------------------------------------------------

# deepseek_moe_16b (src/repro_torch/configs/deepseek_moe_16b.py) at full
# width, its depth cut from 28 layers to 2: the dense-FFN prefix layer and one
# MoE layer (64 routed experts top-6, 2 shared); 4 until the port's SVDs took
# cuSOLVER's accurate gesvd, which made the per-expert solves slower (coala's
# compress 139.6 -> 221.1 s at depth 4) and the script too long for its
# limit. The compress launcher's
# path with 10 pretrain steps and 4 x 8 x 64 calibration tokens, so a routed
# expert sees ~190 tokens against d_model 2048: per-expert COALA on
# rank-deficient R factors. Then the COALA model serves phase 4's trace.
DEEPSEEK_LAYERS = 2
DEEPSEEK_ARGS = ["--arch", "deepseek_moe_16b", "--ratio", "0.6", "--lam", "4",
                 "--pretrain-steps", "10", "--calib-batches", "4", "--device", "cuda"]


def _nonfinite_factors(torch, model):
    """Compressed projections holding a non-finite factor: each factored
    Linear, and each expert of a factored bank."""
    from repro_torch.core.calibrate import block_modules
    from repro_torch.models.ffn import ExpertBank
    from repro_torch.models.linear import Linear
    bad = []
    for path, mod in block_modules(model, (Linear, ExpertBank)):
        if not mod.is_factored:
            continue
        lead = mod.b_t.shape[0] if mod.b_t.ndim == 3 else 1
        ok = (torch.isfinite(mod.b_t.reshape(lead, -1)).all(dim=1)
              & torch.isfinite(mod.a_t.reshape(lead, -1)).all(dim=1)).tolist()
        bad += [path if lead == 1 else f"{path}/e{e}" for e in range(lead) if not ok[e]]
    return bad


def deepseek_path(torch, ops):
    """``repro_torch.launch.compress.main`` with ``DEEPSEEK_ARGS`` on the
    depth-cut deepseek_moe_16b (handed as ``cfg``), with coala and with
    svd_llm: non-finite compressed projections (factors), CE before and
    after, routed calibration tokens per expert and the plain-SVD
    fallbacks; coala must leave no non-finite factor and no non-finite
    report but the fallbacks'. Then the COALA model serves phase 4's trace
    through CUDA graphs and eagerly: identical greedy tokens, 0 post-warmup
    captures. Returns the summary."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.calibrate import moe_paths
    from repro_torch.launch import compress as launcher
    from repro_torch.launch.serve import synthetic_trace

    cfg = dataclasses.replace(get_config("deepseek_moe_16b"), n_layers=DEEPSEEK_LAYERS)
    if cfg.first_k_dense != 1 or not all(cfg.layer_is_moe(i)
                                         for i in range(1, DEEPSEEK_LAYERS)):
        raise Failure("deepseek depth cut: expected 1 dense-FFN layer, then MoE layers")
    out = {"layers": DEEPSEEK_LAYERS, "seconds": {}, "summaries": {}, "nonfinite": {},
           "nan_reports": {}, "peak_gb": {}, "solve_s": {}}
    keep = None
    for method in ("coala", "svd_llm"):
        t0 = time.perf_counter()
        with SolveTimes(torch) as solves:
            res = launcher.main(DEEPSEEK_ARGS + ["--method", method], cfg=cfg)
        torch.cuda.synchronize()
        out["seconds"][method] = dict(res["seconds"], total=time.perf_counter() - t0)
        out["solve_s"][method] = solves.summary()
        log(f"  {method} solves by W shape (d_out x d_in; experts and linears): "
            f"{json.dumps(out['solve_s'][method])}")
        _peak_step(torch, out["peak_gb"], method)
        tokens = res["calibrator"].tokens_seen()

        def routed(path):        # 'blocks/0/sub0/ffn/w_up/e7' -> its expert's tokens
            head, mat, e = path.rsplit("/", 2)
            return tokens.get(f"{head}/expert{e[1:]}/in", 0)
        experts = [r for r in res["reports"] if "/w_" in r.path]
        fallback = [r.path for r in experts if routed(r.path) == 0]
        nan_rep = [r.path for r in res["reports"] if r.path not in fallback
                   and not all(math.isfinite(v) for v in (r.rel_err_weighted, r.mu))]
        bad = _nonfinite_factors(torch, res["compressed"])
        out["summaries"][method] = res["summary"]
        out["nonfinite"][method] = len(bad)
        out["nan_reports"][method] = len(nan_rep)
        log(f"  {method}: {json.dumps(res['summary'])}")
        log(f"  {method}: {len(bad)} of {len(res['reports'])} compressed projections "
            f"(linears and experts) with non-finite factors"
            + (f", e.g. {bad[:4]}" if bad else "")
            + f"; {len(nan_rep)} non-finite reports besides the {len(fallback)} of the "
            f"plain-SVD fallbacks (CE {res['summary']['base_ce']:.4f} -> "
            f"{res['summary']['compressed_ce']:.4f}); {out['seconds'][method]}")
        if method == "coala":
            per_layer = {}
            for path, _ in moe_paths(res["model"]):
                n = [tokens.get(f"{path}/expert{e}/in", 0)
                     for e in range(cfg.moe.num_experts)]
                per_layer[path] = dict(min=int(min(n)), median=float(np.median(n)),
                                       max=int(max(n)), unrouted=sum(x == 0 for x in n))
                log(f"  {path}: routed calibration tokens per expert min {min(n)}, "
                    f"median {np.median(n):.1f}, max {max(n)} against d_model "
                    f"{cfg.d_model}; {per_layer[path]['unrouted']} experts unrouted")
            out["expert_tokens"] = per_layer
            out["fallback_experts"] = len(fallback) // 3
            if bad or nan_rep or not math.isfinite(res["summary"]["compressed_ce"]):
                raise Failure(f"deepseek coala: {len(bad)} non-finite factors, "
                              f"{len(nan_rep)} non-finite reports")
            keep = res["compressed"]
        del res
        torch.cuda.empty_cache()

    trace = synthetic_trace(REQUESTS, cfg.vocab_size, seed=SEED, min_prompt=MIN_PROMPT,
                            max_prompt=MAX_PROMPT, min_new=NEW_TOKENS,
                            max_new=NEW_TOKENS)
    eng, met, toks, secs = _serve_run(torch, keep, trace, warmup=True)
    _check_finished("deepseek coala", eng, trace, cfg.vocab_size)
    ref, rmet, ref_toks, ref_secs = _serve_run(torch, keep, trace, cuda_graphs=False)
    ok = toks == ref_toks and met["post_warmup_compiles"] == 0 and eng.cuda_graphs
    _peak_step(torch, out["peak_gb"], "serve")
    log(f"  peak memory (GB): {json.dumps(out['peak_gb'])}")
    for label, m, sec in (("graphs", met, secs), ("eager", rmet, ref_secs)):
        out[f"serve_coala_{label}"] = dict({k: m[k] for k in SERVE_KEYS}, seconds=sec)
        log(f"  [deepseek coala] {label}: {_serve_line(m)}; {sec:.3f} s")
    log(f"  [deepseek coala] greedy tokens through graphs "
        f"{'identical to' if toks == ref_toks else 'DIFFER from'} the eager engine's; "
        f"{met['post_warmup_compiles']} post-warmup captures")
    if not ok:
        raise Failure("deepseek coala: graphs and eager disagree, or captures after warmup")
    del eng, ref, keep
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9b: deepseek_v2_lite_16b (MLA) at full width through the serve launcher
# ---------------------------------------------------------------------------

# deepseek_v2_lite_16b (src/repro_torch/configs/deepseek_v2_lite_16b.py) at
# full width, its depth cut from 27 layers to 2: the dense-FFN layer 0 and one
# MoE layer (64 routed experts top-6, 2 shared), both MLA (kv_lora_rank 512,
# nope 128 + rope 64, v 128): 1.09 G parameters. The launcher calibrates on
# 2 x 8 x 256 seeded tokens through the flash kernel at head dim 192 and
# compresses with COALA at ratio 0.6, λ 4 (wq, w_dkv, wo, the dense FFN, the
# shared experts and each routed expert). Traffic: phase 4's 8 staggered
# requests plus one of 2000 prompt tokens arriving at step 5, so a row's
# latent envelope spans 128 pages; 160 pages of 16 tokens make the engine
# preempt once (the schedule does not depend on the weights: it was sized at
# SMOKE width on the CPU with this trace), the prefix cache on. MLA reads its
# latent pages in plain torch: the paged kernels must not launch.
MLA_LAYERS, MLA_LONG_PROMPT, MLA_LONG_ARRIVAL = 2, 2000, 5
MLA_KNOBS = dict(block_size=16, num_blocks=160, max_running=8,
                 prefill_bucket_sizes=(32, 256, 2048), prefix_cache=True)
MLA_ARGS = ["--continuous", "--arch", "deepseek_v2_lite_16b", "--compress-ratio", "0.6",
            "--requests", str(REQUESTS), "--prompt-len", "256",
            "--new-tokens", str(NEW_TOKENS),
            "--block-size", str(MLA_KNOBS["block_size"]),
            "--num-blocks", str(MLA_KNOBS["num_blocks"]),
            "--max-running", str(MLA_KNOBS["max_running"]),
            "--prefill-bucket-sizes", ",".join(map(str, MLA_KNOBS["prefill_bucket_sizes"])),
            "--prefix-cache", "on", "--warmup", "on", "--seed", str(SEED),
            "--device", "cuda"]
MLA_NO_LAUNCH = ("paged_attention", "chunked_prefill")   # {k, v} pages only


def mla_trace(vocab):
    """Phase 4's trace plus the long prompt at ``MLA_LONG_ARRIVAL``."""
    import numpy as np
    from repro_torch.launch.serve import synthetic_trace
    trace = synthetic_trace(REQUESTS, vocab, seed=SEED, min_prompt=MIN_PROMPT,
                            max_prompt=MAX_PROMPT, min_new=NEW_TOKENS, max_new=NEW_TOKENS)
    long_prompt = np.random.RandomState(SEED + 7).randint(
        0, vocab, MLA_LONG_PROMPT).astype(np.int32)
    return sorted(trace + [(MLA_LONG_ARRIVAL, long_prompt, NEW_TOKENS)],
                  key=lambda r: r[0])


def mla_path(torch, ops):
    """``family_serve`` on deepseek_v2_lite_16b cut to ``MLA_LAYERS`` with
    ``MLA_ARGS``, on ``mla_trace``: each graph engine must preempt at least
    once and report no paged kernel, and COALA must leave no non-finite
    factor. Returns (summary, noted kernel shapes)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("deepseek_v2_lite_16b"), n_layers=MLA_LAYERS)
    if cfg.first_k_dense != 1 or not cfg.layer_is_moe(1) or not cfg.kv_lora_rank:
        raise Failure("deepseek-v2 depth cut: expected the dense-FFN layer and one MoE "
                      "layer, both MLA")

    def on_launch(res, out):
        models = res["models"]
        bad = _nonfinite_factors(torch, models["coala"])
        nan_rep = [r.path for r in res["reports"]
                   if not all(math.isfinite(v) for v in (r.rel_err_weighted, r.mu))]
        out.update(params=sum(p.numel() for p in models["dense"].parameters()),
                   nonfinite_factors=len(bad), nan_reports=len(nan_rep),
                   latent_floats_per_token_layer=cfg.kv_lora_rank + cfg.qk_rope_dim)
        log(f"  {out['params'] / 1e9:.3f} G parameters; compression: "
            f"{json.dumps(out['compression'])}; {len(bad)} non-finite factors, "
            f"{len(nan_rep)} non-finite reports (experts no token reached)")
        if bad:
            raise Failure(f"deepseek-v2 coala: non-finite factors {bad[:4]}")

    def on_graphs(name, eng, met):
        if met["preemptions"] < 1 or met["prefill_kernel"] != 0.0 or eng.paged_kernel:
            raise Failure(f"deepseek-v2 {name}: expected a preemption and no paged "
                          f"kernel: {met['preemptions']}, {met['prefill_kernel']}")

    return family_serve(torch, ops, "deepseek-v2", cfg, MLA_ARGS, MLA_KNOBS,
                        mla_trace(cfg.vocab_size), on_launch=on_launch,
                        on_graphs=on_graphs)


# ---------------------------------------------------------------------------
# phase 11: qwen2-vl at full width, the per-request serving path
# ---------------------------------------------------------------------------

# qwen2_vl_2b (src/repro_torch/configs/qwen2_vl_2b.py) at full width: d_model
# 1536, 12 / 2 heads (G 6), hd 128, d_ff 8960, vocab 151936, M-RoPE (16, 24,
# 24), 256 vision tokens; its depth cut from 28 layers to 4 (0.42 G
# parameters, 1.7 GB in fp32): each layer's seven COALA solves take seconds,
# and the path is the same at any depth. (a) The fixed-batch launcher on the
# pipeline's first batch: 4 rows of 64 tokens after 256 vision tokens, 16 new
# tokens, fp32. (b) The continuous launcher, dense and COALA (λ 4), on phase
# 4's text trace; then on its models a mixed trace: phase 4's 8 requests (one
# every 2 steps, prompts 16-200, 32 new tokens), every second one (0, 2, 4, 6)
# with a (1, 256, 1536) N(0, 1) vision prefix from a seeded numpy generator,
# over 104 pages of 16 tokens (the trace needs 159 at once): the pool runs
# dry once with request 4, a vision request, the youngest (sized on the CPU
# with a narrow model of the same vocabulary: the pages a request takes do
# not depend on the weights), through graphs with the detokenize worker, a
# stream callback and the telemetry server attached, then eagerly; (c) the
# offline lane on the trace's text half.
VLM_LAYERS = 4
VLM_KNOBS = dict(block_size=16, num_blocks=104, max_running=8)
VLM_ARGS = ["--continuous", "--arch", "qwen2_vl_2b", "--compress-ratio", "0.6",
            "--requests", str(REQUESTS), "--prompt-len", "256",
            "--new-tokens", str(NEW_TOKENS),
            "--block-size", str(VLM_KNOBS["block_size"]),
            "--num-blocks", str(VLM_KNOBS["num_blocks"]),
            "--max-running", str(VLM_KNOBS["max_running"]), "--warmup", "on",
            "--detok-async", "on", "--telemetry-port", "0", "--seed", str(SEED),
            "--device", "cuda"]
VLM_FIXED_ROWS, VLM_FIXED_PROMPT, VLM_FIXED_NEW = 4, 64, 16
VLM_FIXED_ARGS = ["--arch", "qwen2_vl_2b", "--requests", str(VLM_FIXED_ROWS),
                  "--prompt-len", str(VLM_FIXED_PROMPT), "--new-tokens", str(VLM_FIXED_NEW),
                  "--seed", str(SEED), "--device", "cuda"]
VLM_POLL_EVERY = 8          # the telemetry endpoints are read every 8 steps
VLM_ENDPOINTS = ("/metrics", "/healthz", "/requests", "/snapshot")
# qwen2_vl_2b's projections: (d_in, d_out)
VLM_PROJECTIONS = {
    "wq": (1536, 1536), "wk": (1536, 256), "wv": (1536, 256), "wo": (1536, 1536),
    "gate": (1536, 8960), "up": (1536, 8960), "down": (8960, 1536)}
VLM_HEADS = (12, 2, 128)


def vlm_trace(cfg):
    """Phase 4's trace with a vision prefix on every second request:
    (arrival step, prompt, new tokens, extras or None)."""
    import numpy as np
    from repro_torch.launch.serve import synthetic_trace
    trace = synthetic_trace(REQUESTS, cfg.vocab_size, seed=SEED, min_prompt=MIN_PROMPT,
                            max_prompt=MAX_PROMPT, min_new=NEW_TOKENS, max_new=NEW_TOKENS)
    rng = np.random.RandomState(SEED + 11)
    out = []
    for i, (arrival, prompt, new) in enumerate(trace):
        extras = None
        if i % 2 == 0:
            extras = {"vision_embeds": rng.standard_normal(
                (1, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)}
        out.append((arrival, prompt, new, extras))
    return out


def _serve_mixed(eng, trace, *, on_step=None, **submit_kw):
    """Replay a trace with extras, submissions keyed to engine steps;
    ``on_step(step)`` runs after each step."""
    pending = list(trace)
    step = 0
    while pending or eng.has_work():
        while pending and pending[0][0] <= step:
            _, prompt, new, extras = pending.pop(0)
            eng.submit(prompt, new, extras=extras, **submit_kw)
        eng.step()
        step += 1
        if on_step is not None:
            on_step(step)
    eng.flush_stream()
    return eng.metrics()


def _http_get(url: str):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.getcode(), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _check_mixed(label, eng, trace, vocab):
    """Every request finished with its full budget and valid tokens, no page
    leaked, and the per-request prefills are the vision requests' submits
    and the preempted vision requests' recomputes."""
    fin = sorted(eng.finished, key=lambda r: r.req_id)
    if len(fin) != len(trace) or any(
            len(r.out_tokens) != new or not all(0 <= t < vocab for t in r.out_tokens)
            for r, (_, _, new, _) in zip(fin, trace)):
        raise Failure(f"{label}: requests did not all finish with valid tokens")
    if eng.pool.available_blocks != eng.pool.usable_blocks:
        raise Failure(f"{label}: pages leaked")
    want = sum(1 + r.preemptions for r in fin if r.vis_offset)
    if eng.request_prefills != want:
        raise Failure(f"{label}: {eng.request_prefills} per-request prefills, "
                      f"expected {want}")
    return fin


def _ttft_by_kind(fin) -> dict:
    vis = [r.ttft for r in fin if r.vis_offset]
    text = [r.ttft for r in fin if not r.vis_offset]
    return {"vision_mean_ttft_s": sum(vis) / len(vis),
            "text_mean_ttft_s": sum(text) / len(text)}


def vlm_path(torch, ops):
    """Phase 11 (see ``VLM_LAYERS``): (a) ``run_fixed`` through the launcher,
    tokens equal to a ``ContinuousEngine.generate`` of the same inputs; (b)
    the continuous launcher (warmup, async detokenize, telemetry on port 0)
    with 0 post-warmup captures, then per model the mixed vision trace
    through graphs (detokenizer and callback: each request's text is its
    tokens, events in emission order; the telemetry server answers its four
    endpoints with 200 while the trace runs, /snapshot strict JSON; one
    preemption of a vision request; 0 post-warmup captures) and eagerly
    (identical tokens; kernel shapes noted for phase 7); (c) ``run_offline``
    of the text half on a fresh graph engine: the mixed run's tokens, input
    order, fewer batched prefills than requests. Returns (summary, noted
    kernel shapes)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.compress import compression_summary
    from repro_torch.launch import serve as launcher
    from repro_torch.obs import TelemetryServer
    from repro_torch.serve import ContinuousEngine

    cfg = dataclasses.replace(get_config("qwen2_vl_2b"), n_layers=VLM_LAYERS)
    if cfg.family != "vlm" or cfg.n_heads // cfg.n_kv_heads != 6 or cfg.head_dim != 128:
        raise Failure("qwen2-vl depth cut: expected family vlm at G 6, hd 128")
    vocab, n_vis = cfg.vocab_size, cfg.n_vision_tokens
    out = {"layers": VLM_LAYERS, "seconds": {}, "peak_gb": {}}

    # (a) the fixed-batch launcher, then the continuous engine on its inputs
    t0 = time.perf_counter()
    fixed = launcher.main(VLM_FIXED_ARGS, cfg=cfg)
    torch.cuda.synchronize()
    out["seconds"]["fixed_launcher"] = time.perf_counter() - t0
    model, batch, ftoks = fixed["model"], fixed["batch"], fixed["tokens"]
    out.update(params=sum(p.numel() for p in model.parameters()))
    if (tuple(batch["vision_embeds"].shape) != (VLM_FIXED_ROWS, n_vis, cfg.d_model)
            or ftoks.shape != (VLM_FIXED_ROWS, VLM_FIXED_PROMPT + VLM_FIXED_NEW)):
        raise Failure(f"qwen2-vl fixed: shapes {tuple(batch['vision_embeds'].shape)}, "
                      f"{ftoks.shape}")
    cont = ContinuousEngine(model, **VLM_KNOBS)
    t0 = time.perf_counter()
    ctoks = cont.generate(batch["tokens"], VLM_FIXED_NEW,
                          extras={"vision_embeds": batch["vision_embeds"]})
    torch.cuda.synchronize()
    out["seconds"]["fixed_continuous"] = time.perf_counter() - t0
    same = np.array_equal(ctoks, ftoks)
    eq = float(np.mean(ctoks[:, VLM_FIXED_PROMPT:] == ftoks[:, VLM_FIXED_PROMPT:]))
    out["fixed"] = {"seconds": fixed["seconds"], "tokens_equal_share": eq}
    log(f"  [a fixed] {out['params'] / 1e9:.3f} G parameters; ServeEngine "
        f"{VLM_FIXED_ROWS} x ({n_vis} vision + {VLM_FIXED_PROMPT}) -> {VLM_FIXED_NEW} new in "
        f"{fixed['seconds']['serve_fixed']:.3f} s; ContinuousEngine.generate of the same "
        f"inputs {out['seconds']['fixed_continuous']:.3f} s: tokens "
        f"{'identical' if same else 'DIFFER'} ({eq:.3f} of new tokens equal)")
    if not same:
        raise Failure("qwen2-vl: run_fixed and ContinuousEngine.generate disagree")
    cont.release_graphs()
    del fixed, model, cont
    torch.cuda.empty_cache()
    _peak_step(torch, out["peak_gb"], "fixed")

    # (b) the continuous launcher on the text trace
    text_trace = launcher.synthetic_trace(REQUESTS, vocab, seed=SEED,
                                          min_prompt=MIN_PROMPT, max_prompt=MAX_PROMPT,
                                          min_new=NEW_TOKENS, max_new=NEW_TOKENS)
    t0 = time.perf_counter()
    with SolveTimes(torch) as solves:
        res = launcher.main(VLM_ARGS, trace=text_trace, cfg=cfg)
    torch.cuda.synchronize()
    res["engines"]["coala"].release_graphs()
    out["seconds"].update(res["seconds"], launcher=time.perf_counter() - t0)
    out.update(compression=compression_summary(res["reports"]), warmup=res["warmup"],
               solve_s=solves.summary(), telemetry_port=res["telemetry_port"])
    _peak_step(torch, out["peak_gb"], "launcher")
    for r in res["reports"]:
        if not all(math.isfinite(v) for v in (r.mu, r.rel_err_weighted, r.rel_err_bound)):
            raise Failure(f"qwen2-vl compression report not finite: {r}")
    if res["models"]["coala"].vision_proj.is_factored:
        raise Failure("qwen2-vl: vision_proj was compressed")
    for name, eng in res["engines"].items():
        met = res["metrics"][name]
        out[f"launcher_{name}"] = {k: met[k] for k in SERVE_KEYS}
        _check_finished(f"qwen2-vl launcher {name}", eng, text_trace, vocab)
        if not eng.cuda_graphs or met["post_warmup_compiles"] != 0 or not eng.async_detok:
            raise Failure(f"qwen2-vl launcher {name}: expected CUDA graphs, async "
                          f"detokenize and 0 post-warmup captures, got "
                          f"{met['post_warmup_compiles']}")
        log(f"  [b launcher {name}] text trace through graphs: {_serve_line(met)}; "
            f"telemetry on port {res['telemetry_port']}")
    models = res["models"]
    del res, eng
    torch.cuda.empty_cache()

    # (b) the mixed vision trace on the launcher's models, graphs then eager;
    # (c) the offline lane on its text half
    trace = vlm_trace(cfg)
    warm_len = max(len(p) + new + (n_vis if ex else 0) for _, p, new, ex in trace)
    text_half = [(i, p, new) for i, (_, p, new, ex) in enumerate(trace) if ex is None]
    calls = KernelCalls(ops)        # noted on the eager runs only
    for name, m in models.items():
        events = []
        eng = ContinuousEngine(m, detokenizer=lambda t: f"<{t}>", **VLM_KNOBS)
        w = eng.warmup(max_len=warm_len)
        server = TelemetryServer(eng, port=0)
        polls = collections.Counter()

        def poll(step):
            if step % VLM_POLL_EVERY:
                return
            for path in VLM_ENDPOINTS:
                code, body = _http_get(server.url(path))
                polls[(path, code)] += 1
                if path == "/snapshot":
                    json.loads(body, parse_constant=lambda c: (_ for _ in ()).throw(
                        Failure(f"/snapshot is not strict JSON: {c}")))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            met = _serve_mixed(eng, trace, on_step=poll, stream_callback=events.append)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            server.close()
        fin = _check_mixed(f"qwen2-vl {name} graphs", eng, trace, vocab)
        bad_codes = {k: n for k, n in polls.items() if k[1] != 200}
        if bad_codes or not polls:
            raise Failure(f"qwen2-vl {name}: telemetry answers {dict(polls)}")
        victims = [(r.req_id, r.vis_offset) for r in fin if r.preemptions]
        if (met["post_warmup_compiles"] != 0 or met["preemptions"] < 1
                or not any(v for _, v in victims)):
            raise Failure(f"qwen2-vl {name}: expected 0 post-warmup captures and a "
                          f"preempted vision request, got "
                          f"{met['post_warmup_compiles']}, {victims}")
        for r in fin:
            evs = [e for e in events if e.req_id == r.req_id]
            if (r.text != "".join(f"<{t}>" for t in r.out_tokens)
                    or [e.token for e in evs] != r.out_tokens
                    or [e.index for e in evs] != list(range(len(evs)))
                    or [e.done for e in evs] != [False] * (len(evs) - 1) + [True]):
                raise Failure(f"qwen2-vl {name}: request {r.req_id}'s stream is not "
                              "its tokens in emission order")
        toks = {r.req_id: list(r.out_tokens) for r in fin}
        out[f"mixed_{name}"] = dict({k: met[k] for k in SERVE_KEYS}, seconds=secs,
                                    request_prefills=eng.request_prefills,
                                    preempted=victims, polls=sum(polls.values()),
                                    warmup=w, **_ttft_by_kind(fin))
        _peak_step(torch, out["peak_gb"], f"mixed_{name}")
        eng.release_graphs()
        del eng
        log(f"  [b mixed {name}] graphs: {_serve_line(met)}; {secs:.3f} s; "
            f"{out[f'mixed_{name}']['request_prefills']} per-request prefills, "
            f"preempted {victims}; mean TTFT vision "
            f"{out[f'mixed_{name}']['vision_mean_ttft_s']:.4f} s, text "
            f"{out[f'mixed_{name}']['text_mean_ttft_s']:.4f} s; telemetry "
            f"{dict((f'{p} {c}', n) for (p, c), n in polls.items())}; stream text "
            "and events equal the tokens")

        eng = ContinuousEngine(m, cuda_graphs=False, **VLM_KNOBS)
        t0 = time.perf_counter()
        with calls:
            emet = _serve_mixed(eng, trace)
        torch.cuda.synchronize()
        esecs = time.perf_counter() - t0
        _check_mixed(f"qwen2-vl {name} eager", eng, trace, vocab)
        same = {r.req_id: list(r.out_tokens) for r in eng.finished} == toks
        out[f"mixed_{name}_eager"] = dict({k: emet[k] for k in SERVE_KEYS},
                                          seconds=esecs)
        log(f"  [b mixed {name}] eager: {_serve_line(emet)}; {esecs:.3f} s; greedy "
            f"tokens {'identical to' if same else 'DIFFER from'} the graphs'")
        if not same:
            raise Failure(f"qwen2-vl {name}: CUDA graphs and the eager engine disagree")
        del eng

        eng = ContinuousEngine(m, **VLM_KNOBS)
        eng.warmup(max_len=warm_len)
        t0 = time.perf_counter()
        results = eng.run_offline([dict(prompt_tokens=p, max_new_tokens=new)
                                   for _, p, new in text_half])
        torch.cuda.synchronize()
        osecs = time.perf_counter() - t0
        omet = eng.metrics()
        in_order = all(np.array_equal(r.prompt, p)
                       for r, (_, p, _) in zip(results, text_half))
        same = [r.out_tokens for r in results] == [toks[i] for i, _, _ in text_half]
        out[f"offline_{name}"] = dict({k: omet[k] for k in SERVE_KEYS}, seconds=osecs)
        log(f"  [c offline {name}] run_offline of the {len(text_half)} text requests: "
            f"{_serve_line(omet)}; {osecs:.3f} s; {omet['prefill_batches']} batched "
            f"prefills; input order {'kept' if in_order else 'LOST'}; tokens "
            f"{'identical to' if same else 'DIFFER from'} the mixed run's")
        if (not same or not in_order or omet["prefill_batches"] >= len(text_half)
                or omet["post_warmup_compiles"] != 0):
            raise Failure(f"qwen2-vl {name}: offline lane: tokens equal {same}, "
                          f"order {in_order}, {omet['prefill_batches']} prefills, "
                          f"{omet['post_warmup_compiles']} post-warmup captures")
        eng.release_graphs()
        del eng
    shapes = calls.shapes()
    per_request = [k for k in calls.flash if k[0] == 1 and k[1] > n_vis]
    shapes["vlm_prefill_t"] = max(k[1] for k in per_request) if per_request else 0
    if not per_request:
        raise Failure(f"qwen2-vl: no per-request flash prefill noted: {dict(calls.flash)}")
    log(f"  seconds: {json.dumps(out['seconds'])}; peak memory (GB): "
        f"{json.dumps(out['peak_gb'])}")
    del models
    torch.cuda.empty_cache()
    return out, shapes


# ---------------------------------------------------------------------------
# phase 10: the compression core on phase 5's trained model
# ---------------------------------------------------------------------------

def adaptive_path(torch, ops, coala):
    """10a: ``compress_model(adaptive_rank=True)`` on phase 5's trained model
    and calibrator (coala, ratio ``ADAPTIVE_RATIO``, μ 0): kept ratio, more
    than one distinct rank, one rank per layer position, every report at or
    above its optimum, a finite CE beside phase 5's uniform COALA CE; then the
    model serves phase 4's trace through CUDA graphs after warmup (0
    post-warmup captures) and eagerly: identical greedy tokens. Returns
    (summary, noted kernel shapes of the eager run, rank by path)."""
    from repro_torch.config import CompressConfig
    from repro_torch.core.compress import compress_model, compression_summary
    from repro_torch.core.rank_alloc import default_group
    from repro_torch.launch import compress as clauncher
    from repro_torch.launch import serve as slauncher

    model, cal = coala["model"], coala["calibrator"]
    t0 = time.perf_counter()
    am, reports = compress_model(model, cal, CompressConfig(
        method="coala", ratio=ADAPTIVE_RATIO, mu=0.0, adaptive_rank=True))
    torch.cuda.synchronize()
    out = {"compress_s": time.perf_counter() - t0, "compression": compression_summary(reports)}
    ranks = {r.path: r.rank for r in reports}
    groups = {}
    for path, r in ranks.items():
        groups.setdefault(default_group(path), set()).add(r)
    for r in reports:
        if not (math.isfinite(r.rel_err_weighted) and math.isfinite(r.rel_err_bound)):
            raise Failure(f"adaptive: report not finite: {r}")
        if r.rel_err_weighted < r.rel_err_bound * (1 - 1e-3):
            raise Failure(f"adaptive {r.path}: error {r.rel_err_weighted} below the "
                          f"optimum {r.rel_err_bound}")
    if not out["compression"]["kept_ratio"] <= ADAPTIVE_RATIO:
        raise Failure(f"adaptive: kept ratio {out['compression']['kept_ratio']}")
    if len(set(ranks.values())) < 2 or any(len(v) != 1 for v in groups.values()):
        raise Failure(f"adaptive: ranks by layer position {groups}")
    pipe = clauncher.make_pipeline(model.cfg, model.device)
    out["ce"] = clauncher.eval_ce(am, pipe)
    if not math.isfinite(out["ce"]):
        raise Failure(f"adaptive: CE {out['ce']}")
    out["ranks"] = {g: min(v) for g, v in sorted(groups.items())}
    log(f"  adaptive ranks by layer position: {json.dumps(out['ranks'])}")
    log(f"  compress {out['compress_s']:.2f} s, kept ratio "
        f"{out['compression']['kept_ratio']:.4f}, CE {out['ce']:.4f} against phase 5's "
        f"uniform COALA {coala['summary']['compressed_ce']:.4f} (base "
        f"{coala['summary']['base_ce']:.4f})")

    vocab = model.cfg.vocab_size
    trace = slauncher.synthetic_trace(REQUESTS, vocab, seed=SEED, min_prompt=MIN_PROMPT,
                                      max_prompt=MAX_PROMPT, min_new=NEW_TOKENS,
                                      max_new=NEW_TOKENS)
    eng, met, toks, secs = _serve_run(torch, am, trace, warmup=True)
    _check_finished("adaptive", eng, trace, vocab)
    if not eng.cuda_graphs or met["post_warmup_compiles"] != 0:
        raise Failure(f"adaptive: expected CUDA graphs and 0 post-warmup captures, "
                      f"got {met['post_warmup_compiles']}")
    out["serve"] = dict({k: met[k] for k in SERVE_KEYS}, seconds=secs)
    log(f"  [adaptive] graphs: {_serve_line(met)}; warmup {met['warmup_seconds']:.2f} s")
    del eng
    with KernelCalls(ops) as calls:
        eng, emet, etoks, esecs = _serve_run(torch, am, trace, cuda_graphs=False)
    _check_finished("adaptive eager", eng, trace, vocab)
    out["serve_eager"] = dict({k: emet[k] for k in SERVE_KEYS}, seconds=esecs)
    log(f"  [adaptive] eager: {_serve_line(emet)}; greedy tokens "
        f"{'identical to' if etoks == toks else 'DIFFER from'} the graphs'")
    if etoks != toks:
        raise Failure("adaptive: CUDA graphs and the eager engine disagree")
    del eng, am
    torch.cuda.empty_cache()
    return out, calls.shapes(), ranks


def merge_witness(torch, am, merged, probe, method) -> dict:
    """Each adapted linear of ``am`` on the input it sees in the forward of
    ``probe``: the adapter sum x·w + (x·b_t)·a_t (lowrank_linear) and the
    merged product x·(w + b_t·a_t) of ``merged``, both fp32 on the card,
    against the sum in fp64. Every element's error must stay within
    fp32's worst-case rounding of these sums, γ·(|x|·(|w| + |b_t|·|a_t|))
    with γ = (d_in + r + 2)·eps₃₂, a bound that scales with the adapters'
    size. Returns the largest error over its bound for each sum."""
    from repro_torch.core.calibrate import block_modules
    from repro_torch.models.linear import Linear

    lins = {p: lin for p, lin in block_modules(am, Linear)
            if lin.has_dense and lin.is_factored}
    dense = dict(block_modules(merged, Linear))
    inputs, hooks = {}, []
    for path, lin in lins.items():
        hooks.append(lin.register_forward_pre_hook(
            lambda mod, args, path=path: inputs.__setitem__(path, args[0])))
    worst = {"adapter": 0.0, "merged": 0.0}
    with torch.no_grad():
        try:
            am.logits(probe)
        finally:
            for h in hooks:
                h.remove()
        for path, lin in lins.items():
            x = inputs[path].reshape(-1, lin.w.shape[0]).float().contiguous()
            x64, w, b_t, a_t = (t.double() for t in (x, lin.w, lin.b_t, lin.a_t))
            want = x64 @ w + (x64 @ b_t) @ a_t
            gamma = (w.shape[0] + b_t.shape[1] + 2) * 2.0 ** -23
            lim = gamma * (x64.abs() @ (w.abs() + b_t.abs() @ a_t.abs()))
            for label, got in (("adapter", lin(x)), ("merged", dense[path](x))):
                ratio = ((got.double() - want).abs() / lim.clamp_min(1e-300)).max().item()
                worst[label] = max(worst[label], ratio)
    ok = all(math.isfinite(v) and v <= 1.0 for v in worst.values())
    log(f"  {method} merge witness on {len(lins)} linears against fp64: largest error "
        f"over its fp32 rounding bound, adapter sum {worst['adapter']:.3e}, merged "
        f"{worst['merged']:.3e} (<= 1) {'ok' if ok else 'VIOLATED'}")
    if not ok:
        raise Failure(f"adapters {method}: merged or adapter sums outside fp32's "
                      f"rounding of the fp64 sum: {worst}")
    return worst


def adapters_path(torch, ops, coala):
    """10b: Table 4 on the card. Block 0 of phase 5's trained model (depth
    1), calibrated on the second stream; per method of ``ADAPTER_METHODS``:
    ``init_adapters`` at ``ADAPTER_RANK``, ``ADAPTER_STEPS`` adapter-only
    AdamW steps (``make_adapter_step``: the adapters' products forward and
    backward through the lowrank_linear kernel), ``merge_adapters``, CE on
    the stream's held-out batches. Checks: every frozen leaf bit-identical
    after the steps (weight decay 0) and backward launches in every method's
    steps; every method's merge held by ``merge_witness``; for
    ``ADAPTER_FINITE`` a finite CE and the merged model's logits equal to
    the adapter model's within ``TOL_MERGE``. corda's CE, non-finite leaves
    and logits error are recorded whatever they are: its 2048-token Gram at
    width 8192 is rank-deficient (the paper's Remark 1). On the card its
    fp32 LU solve has met no zero pivot, so its adapters come out finite but
    large, and the rounding of the two sums, which scales with them, is
    held by the witness and not by ``TOL_MERGE``."""
    from repro_torch.config import TrainConfig
    from repro_torch.core.adapters import init_adapters, merge_adapters
    from repro_torch.core.calibrate import calibrate_model
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.compress import KERNEL_CTX, eval_ce
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_loop import make_adapter_step

    src = coala["model"]
    cfg = dataclasses.replace(src.cfg, n_layers=1)
    base = build_model(cfg, device=src.device)
    base.load_state_dict({k: v for k, v in src.state_dict().items()
                          if not k.startswith("blocks.") or k.startswith("blocks.0.")})
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8,
                                    seed=99, noise=0.05), cfg, device=base.device)
    t0 = time.perf_counter()
    cal = calibrate_model(base, [pipe.get_batch(2000 + i)["tokens"]
                                 for i in range(ADAPTER_CAL_BATCHES)], ctx=KERNEL_CTX)
    rf = cal.r_factors()
    torch.cuda.synchronize()
    out = {"calibrate_s": time.perf_counter() - t0,
           "base_ce": eval_ce(base, pipe, n_batches=ADAPTER_EVAL_BATCHES), "methods": {}}
    log(f"  block 0 of phase 5's model: calibrate {out['calibrate_s']:.2f} s on "
        f"{ADAPTER_CAL_BATCHES} x 8 x 64 tokens; CE on the second stream "
        f"{out['base_ce']:.4f}")
    tcfg = TrainConfig(**ADAPTER_FT)
    probe = pipe.get_batch(1000)["tokens"][:2]
    for method in ADAPTER_METHODS:
        t0 = time.perf_counter()
        am, mask = init_adapters(base, rf, method=method, rank=ADAPTER_RANK)
        torch.cuda.synchronize()
        res = {"init_s": time.perf_counter() - t0,
               "ce_init": eval_ce(am, pipe, n_batches=ADAPTER_EVAL_BATCHES)}
        frozen = {k: p.detach().clone() for k, p in am.named_parameters() if not mask[k]}
        opt = adamw_init(dict(am.named_parameters()))
        step = make_adapter_step(am, tcfg, mask)
        bwd0 = ops.backward_launch_counts()["lowrank_linear"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [step(opt, pipe.get_batch(i)["tokens"])[0] for i in range(ADAPTER_STEPS)]
        torch.cuda.synchronize()
        res["step_ms"] = (time.perf_counter() - t0) / ADAPTER_STEPS * 1e3
        res["backward_launches"] = ops.backward_launch_counts()["lowrank_linear"] - bwd0
        res["losses"] = [float(x) for x in (losses[0], losses[-1])]
        res["frozen_identical"] = all(torch.equal(p, frozen[k])
                                      for k, p in am.named_parameters() if not mask[k])
        res["nonfinite_adapter_leaves"] = [k for k, p in am.named_parameters()
                                           if mask[k] and not bool(torch.isfinite(p).all())]
        del frozen, opt, step
        merged = merge_adapters(am)
        res["ce_after"] = eval_ce(merged, pipe, n_batches=ADAPTER_EVAL_BATCHES)
        want, got = am.logits(probe), merged.logits(probe)
        res["merge_finite"] = bool(torch.isfinite(want).all())
        log(f"  [{method}] init {res['init_s']:.2f} s, {res['step_ms']:.1f} ms a step "
            f"({res['backward_launches']} backward launches in {ADAPTER_STEPS} steps), "
            f"CE {res['ce_init']:.4f} at init -> {res['ce_after']:.4f} merged after "
            f"{ADAPTER_STEPS} steps (loss {res['losses'][0]:.4f} -> "
            f"{res['losses'][1]:.4f}); frozen leaves "
            f"{'bit-identical' if res['frozen_identical'] else 'CHANGED'}; "
            f"{len(res['nonfinite_adapter_leaves'])} non-finite adapter leaves")
        if method in ADAPTER_FINITE:
            res["merge_max_abs_err"] = compare(f"{method} merged vs adapter logits", got,
                                               want, TOL_MERGE)
        else:
            res["merge_rel_err"] = compare_quiet(got, want)
            log(f"  {method} merged vs adapter logits: max |err| / max(1, max|ref|) = "
                f"{res['merge_rel_err']:.3e} (recorded; tolerance {TOL_MERGE} for the "
                "others; its merge is held by the witness)")
        if res["nonfinite_adapter_leaves"]:
            log(f"  {method}: merge witness not run, the adapters are not finite")
        else:
            res["merge_witness"] = merge_witness(torch, am, merged, probe, method)
        if not res["frozen_identical"] or res["backward_launches"] <= 0:
            raise Failure(f"adapters {method}: frozen leaves changed or no backward launch")
        if method in ADAPTER_FINITE and not math.isfinite(res["ce_after"]):
            raise Failure(f"adapters {method}: CE {res['ce_after']}")
        out["methods"][method] = res
        del am, merged, want, got
        torch.cuda.empty_cache()
    return out


def theory_rsvd_path(torch, coala):
    """10c: Theorem 1 on phase 5's block-0 ``down`` (2048 tokens < 8192: X is
    rank-deficient): ||W₀ − W_μ||_F <= thm1_bound at each of ``THM1_MUS``,
    with Rᵀ in place of X (W·X and W·Rᵀ have the same singular values); then
    ``coala_factors`` with the randomized SVD beside the full SVD on block
    0's seven linears at ratio 0.6, μ 0: seconds and weighted errors
    ||(W − W')Rᵀ||_F, each against the attainable optimum computed in fp64
    (the tail of σ(W Rᵀ)). The full solve (cuSOLVER's ``gesvd``) must reach
    ``SVD_SLACK`` × the optimum plus fp32's floor, eps₃₂ · σ_max · √min(m, n)
    (the rounding of W Rᵀ itself). (With λ 4 each
    path would pick its own μ from its first solve, and the errors would
    belong to two regularised problems.)"""
    from repro_torch.core import coala as coala_lib
    from repro_torch.core import theory
    from repro_torch.core.calibrate import block_modules
    from repro_torch.models.linear import Linear, rank_for_ratio

    lins = dict(block_modules(coala["model"], Linear))
    rf = coala["calibrator"].r_factors()
    w = lins[THM1_LAYER].w.detach().T.float()
    r_f = rf[THM1_LAYER].float()
    rank = rank_for_ratio(w.shape[1], w.shape[0], 0.6)
    out = {"thm1": []}
    w0 = coala_lib.coala_project(w, r_factor=r_f, rank=rank)
    for mu in THM1_MUS:
        diff = torch.linalg.norm(w0 - coala_lib.coala_project(w, r_factor=r_f, rank=rank,
                                                              mu=mu)).item()
        bnd = theory.thm1_bound(w, r_f.T, rank, mu).item()
        out["thm1"].append({"mu": mu, "diff": diff, "bound": bnd})
        log(f"  Theorem 1 on {THM1_LAYER} (rank {rank}): mu {mu:g}: ||W0 - W_mu||_F = "
            f"{diff:.4e} <= bound {bnd:.4e} {'ok' if diff <= bnd else 'VIOLATED'}")
        if not diff <= bnd:
            raise Failure(f"Theorem 1 violated at mu {mu}: {diff} > {bnd}")
    out["rsvd"] = {}
    for path, lin in lins.items():
        if not path.startswith("blocks/0/"):
            continue
        w = lin.w.detach().T.float()
        r_f = rf[path].float()
        rank = rank_for_ratio(w.shape[1], w.shape[0], 0.6)
        wr64 = w.double() @ r_f.double().T
        s64 = coala_lib.svdvals(wr64)
        row = {"optimum": torch.sqrt(torch.sum(s64[rank:] ** 2)).item(),
               "fp32_floor": 2.0 ** -23 * s64[0].item() * min(w.shape) ** 0.5}
        for label, use_rsvd in (("full", False), ("rsvd", True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = coala_lib.coala_factors(w, r_factor=r_f, rank=rank,
                                          use_rsvd=use_rsvd)
            torch.cuda.synchronize()
            row[f"{label}_s"] = time.perf_counter() - t0
            row[f"{label}_err"] = torch.linalg.norm((w - res.w_approx) @ r_f.T).item()
        out["rsvd"][path] = row
        log(f"  {path} ({w.shape[0]}x{w.shape[1]}, rank {rank}): full SVD "
            f"{row['full_s']:.3f} s, rsvd {row['rsvd_s']:.3f} s; weighted error: optimum "
            f"(fp64) {row['optimum']:.4f}, full {row['full_err']:.4f}, rsvd "
            f"{row['rsvd_err']:.4f} (fp32 floor {row['fp32_floor']:.4f})")
        if not row["full_err"] <= SVD_SLACK * row["optimum"] + row["fp32_floor"]:
            raise Failure(f"{path}: the full SVD's weighted error {row['full_err']} misses "
                          f"the optimum {row['optimum']}")
    tot = {k: sum(r[k] for r in out["rsvd"].values()) for k in ("full_s", "rsvd_s")}
    log(f"  block 0's seven linears: full SVD {tot['full_s']:.2f} s, rsvd "
        f"{tot['rsvd_s']:.2f} s")
    return out


def compression_core_path(torch, ops, coala):
    """Phase 10: 10a, 10b and 10c in one launch-count window."""
    log("  [10a adaptive ranks] compress_model(CompressConfig(method='coala', ratio="
        f"{ADAPTIVE_RATIO}, mu=0.0, adaptive_rank=True)) on phase 5's model and "
        "calibrator, then phase 4's trace through graphs and eagerly")
    adaptive, shapes, ranks = adaptive_path(torch, ops, coala)
    log(f"  [10b adapters] {', '.join(ADAPTER_METHODS)} at rank {ADAPTER_RANK} on block "
        f"0, {ADAPTER_STEPS} adapter-only steps each")
    adapters = adapters_path(torch, ops, coala)
    log("  [10c Theorem 1 and rsvd]")
    thm = theory_rsvd_path(torch, coala)
    return {"adaptive": adaptive, "adapters": adapters, "theory_rsvd": thm}, shapes, ranks


# ---------------------------------------------------------------------------
# phase 7: each kernel against its plain version, at the paths' shapes
# ---------------------------------------------------------------------------

def check_lowrank(torch, ops, ref, dev, gen, shapes, flush, proj=None,
                  model="llama3_1b", extra_rows=()):
    """lowrank_linear in fp32 and bf16 on one ``model`` layer's compressed
    projections ``proj`` (name -> (d_in, r, d_out); llama3_1b's seven by default)
    at the path's decode and largest prefill rows, and at ``extra_rows``;
    the line's numbers are one layer at decode, fp32."""
    proj = LOWRANK_SHAPES if proj is None else proj
    res = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_ms": 0.0, "bound_by": "bytes"}
    m_dec, m_max = shapes["lowrank_m_decode"], shapes["lowrank_m_max"]
    rows = list(dict.fromkeys((m_dec, *extra_rows, m_max)))
    layer = {m: {"m": m, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
             for m in rows}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for m in rows:
            for name, (d_in, r, d_out) in proj.items():
                x = torch.randn((m, d_in), generator=gen, device=dev).to(dt)
                bt = (torch.randn((d_in, r), generator=gen, device=dev) / d_in ** 0.5).to(dt)
                at = (torch.randn((r, d_out), generator=gen, device=dev) / r ** 0.5).to(dt)
                got = ops.lowrank_linear(x, bt, at)
                err = compare(f"lowrank_linear {dtype} M={m} {model} {name} "
                              f"({d_in}x{r}x{d_out})", got, ref(x, bt, at), TOL[dtype])
                if dtype != "float32":
                    continue
                res["max_abs_err"] = max(res["max_abs_err"], err)
                ms = timed(torch, lambda: ops.lowrank_linear(x, bt, at), flush)
                plain = timed(torch, lambda: ref(x, bt, at), flush)
                lib = timed(torch, lambda: torch.linalg.multi_dot([x, bt, at]), flush)
                nbytes = 4 * (m * d_in + d_in * r + r * d_out + m * d_out)
                b_ms, b_by = bound(nbytes, 2 * m * r * (d_in + d_out), dtype)
                log(f"    M={m} {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                    f"multi_dot {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
                fig = layer[m]
                fig["ms"] += ms
                fig["plain_ms"] += plain
                fig["library_ms"] += lib
                fig["bound_ms"] += b_ms
                fig["bound_by"] = b_by
    for m, fig in layer.items():
        what = "decode" if m == m_dec else "prefill"
        log(f"  lowrank_linear, one {model} layer at {what} (M={m}, {len(proj)} projections): "
            f"kernel {fig['ms']:.4f} ms, plain {fig['plain_ms']:.4f} ms, multi_dot "
            f"{fig['library_ms']:.4f} ms, bound {fig['bound_ms']:.4f} ms ({fig['bound_by']})")
    res.update({k: layer[m_dec][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                              "bound_by")})
    res["prefill"] = [layer[m] for m in rows if m != m_dec]
    return res


def check_lowrank_grad(torch, ops, ref, dev, gen, flush, proj):
    """lowrank_linear under autograd at ``GRAD_ROWS`` rows on ``proj`` (name ->
    (d_in, r, d_out)): x, b_t and a_t gradients of the kernel's Function (dx
    one more launch of the kernel) against autograd through the plain
    version, fp32 and bf16; in fp32 the forward + backward time on the card
    (``device_ms``) beside the plain version's, ``multi_dot``'s under
    autograd, and the bound: inputs x, b_t, a_t, dy read once, y, dx, db_t,
    da_t written once; 6·M·r·(d_in + d_out) operations (the forward's two
    products, dx's two, da_t's and db_t's). The wall time of each (``timed``:
    autograd's host work, which the card waits for at these sizes) is kept
    apart as ``*wall_ms``."""
    m = GRAD_ROWS
    rows = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for name, (d_in, r, d_out) in proj.items():
            x = torch.randn((m, d_in), generator=gen, device=dev).to(dt)
            bt = (torch.randn((d_in, r), generator=gen, device=dev) / d_in ** 0.5).to(dt)
            at = (torch.randn((r, d_out), generator=gen, device=dev) / r ** 0.5).to(dt)
            dy = torch.randn((m, d_out), generator=gen, device=dev).to(dt)
            leaves = [t.requires_grad_() for t in (x, bt, at)]

            def fwd_bwd(fn):
                return torch.autograd.grad(fn(*leaves), leaves, dy)

            got, want = fwd_bwd(ops.lowrank_linear), fwd_bwd(ref)
            err = max(compare(f"lowrank_linear backward {dtype} M={m} {name} "
                              f"({d_in}x{r}x{d_out}) d{what}", g, w, TOL[dtype])
                      for what, g, w in zip(("x", "b_t", "a_t"), got, want))
            if dtype != "float32":
                continue
            nbytes = 4 * (2 * m * d_in + 2 * d_in * r + 2 * r * d_out + 2 * m * d_out)
            b_ms, b_by = bound(nbytes, 6 * m * r * (d_in + d_out), dtype)
            row = {"shape": [m, d_in, r, d_out], "max_abs_err": err, "bound_ms": b_ms,
                   "bound_by": b_by}
            for key, fn in (("", ops.lowrank_linear), ("plain_", ref),
                            ("library_", lambda *a: torch.linalg.multi_dot(list(a)))):
                row[f"{key}ms"] = device_ms(torch, lambda: fwd_bwd(fn), flush)
                row[f"{key}wall_ms"] = timed(torch, lambda: fwd_bwd(fn), flush)
            rows[name] = row
            log(f"    M={m} {name} forward + backward, on the card: kernel "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, multi_dot "
                f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); wall: kernel "
                f"{row['wall_ms']:.4f} ms, plain {row['plain_wall_ms']:.4f} ms, "
                f"multi_dot {row['library_wall_ms']:.4f} ms")
    return rows


def _pages(torch, dev, gen, rows_tokens, bs, hkv, hd, dt, pad_rows=(), extra=4):
    """Random page stores + per-row tables covering ``rows_tokens`` tokens;
    rows flagged in ``pad_rows`` get all-trash tables, as the engine's
    padding rows do."""
    import numpy as np
    nb = max(max(-(-t // bs) for t in rows_tokens), 1)
    tables = np.zeros((len(rows_tokens), nb), np.int32)
    nxt = 1
    for i, t in enumerate(rows_tokens):
        if i < len(pad_rows) and pad_rows[i]:
            continue
        for j in range(-(-t // bs)):
            tables[i, j] = nxt
            nxt += 1
    shape = (nxt + extra, bs, hkv, hd)
    kp = torch.randn(shape, generator=gen, device=dev).to(dt)
    vp = torch.randn(shape, generator=gen, device=dev).to(dt)
    return kp, vp, torch.as_tensor(tables, device=dev)


def _sdpa_inputs(torch, q, kp, vp, tables, g):
    """Contiguous per-row K/V gathered from the pages, heads repeated for
    GQA, in SDPA's (B, H, T, hd) layout (built outside the timed call)."""
    b, nb = tables.shape
    bs, hkv, hd = kp.shape[1], kp.shape[2], kp.shape[3]
    k = kp[tables.long()].reshape(b, nb * bs, hkv, hd).repeat_interleave(g, dim=2)
    v = vp[tables.long()].reshape(b, nb * bs, hkv, hd).repeat_interleave(g, dim=2)
    return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()


# (label, q dtype, page dtype): both in one dtype, and the serving dtypes'
# mixed call, fp32 activations over a bf16 KV cache
ATTN_DTYPES = [("float32", "float32", "float32"), ("bfloat16", "bfloat16", "bfloat16"),
               ("q fp32 / pages bf16", "float32", "bfloat16")]
MIXED = ATTN_DTYPES[2][0]


def check_paged(torch, ops, pa_ref, dev, gen, shapes, flush):
    """paged_attention in fp32, bf16 and fp32 q over bf16 pages at the serve
    path's decode batch and its edge cases; the line's numbers are the
    path's fp32 call, ``mixed`` the same call over bf16 pages. The long-row
    case (8 rows of 2048 keys, 67 MB of K/V) is the same code path at a
    context where the plan cuts each row into many page splits."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    hq, hkv, hd, bs = 32, 8, 64, 16
    res = {}
    lengths, pad_rows = shapes["paged_lengths"], shapes["paged_pad_rows"]
    cases = [("main", lengths, pad_rows, 0.0, 0),
             ("long rows", [2048] * 8, (), 0.0, 0),
             ("ragged+zero", [0, 37, 1, 200, 16, 0, 90, 5], (), 0.0, 0),
             ("window", [0, 37, 1, 200, 16, 0, 90, 5], (), 0.0, 24),
             ("softcap", [0, 37, 1, 200, 16, 0, 90, 5], (), 50.0, 0),
             ("window+softcap", lengths, pad_rows, 30.0, 40)]
    for label, qdtype, kvdtype in ATTN_DTYPES:
        qdt, kvdt = getattr(torch, qdtype), getattr(torch, kvdtype)
        tol = TOL_ATTN[kvdtype if qdtype == "float32" else qdtype]
        for name, lens, pads, cap, window in cases:
            if label == MIXED and name in ("long rows", "softcap"):
                continue
            kp, vp, tables = _pages(torch, dev, gen, lens, bs, hkv, hd, kvdt, pads)
            q = torch.randn((len(lens), hq, hd), generator=gen, device=dev).to(qdt)
            ln = torch.tensor(lens, dtype=torch.int32, device=dev)
            args = (q, kp, vp, tables, ln)
            got = ops.paged_attention(*args, cap=cap, window=window)
            err = compare(f"paged_attention {label} {name} B={len(lens)}", got,
                          pa_ref(*args, cap=cap, window=window), tol)
            if 0 in lens and not torch.all(got[ln == 0] == 0):
                raise Failure("paged_attention: zero-length rows are not zero")
            if not torch.equal(ops.paged_attention(*args, cap=cap, window=window), got):
                raise Failure("paged_attention: two identical calls differ")
            if label == "float32":
                res["max_abs_err"] = max(res.get("max_abs_err", 0.0), err)
            if label == "bfloat16" or name not in ("main", "long rows"):
                continue
            ms = timed(torch, lambda: ops.paged_attention(*args), flush)
            plain = timed(torch, lambda: pa_ref(*args), flush)
            # the library yardstick is fp32 SDPA (K and V converted outside)
            k, v = _sdpa_inputs(torch, q, kp.float(), vp.float(), tables, hq // hkv)
            mask = (torch.arange(k.shape[2], device=dev)[None, :]
                    < ln[:, None])[:, None, None, :]
            q4 = q[:, :, None, :]
            lib = timed(
                torch, lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask),
                flush)
            del k, v
            # bytes the function needs: q of rows with keys, the whole output,
            # the K/V of every attended token, the tables and lengths
            toks = sum(lens)
            q_rows = sum(1 for n in lens if n > 0)
            nbytes = (q.element_size() * (q_rows + len(lens)) * hq * hd
                      + kp.element_size() * 2 * toks * hkv * hd
                      + 4 * (tables.numel() + len(lens)))
            b_ms, b_by = bound(nbytes, 4 * toks * hq * hd, "float32")
            p = pa.plan(len(lens), hq, hkv, hd, tables.shape[1])
            log(f"    {label} {name} B={len(lens)} "
                f"lengths={lens if name == 'main' else lens[0]}"
                f"{'' if name == 'main' else ' each'} ({p.splits} splits of {p.per} pages): "
                f"kernel {ms:.4f} ms, plain {plain:.4f} ms, fp32 SDPA {lib:.4f} ms, bound "
                f"{b_ms:.5f} ms ({b_by}, {100 * b_ms / ms:.1f}% reached)")
            fig = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                       splits=p.splits)
            if label == MIXED:
                res["mixed"] = dict(fig, max_abs_err=err)
            elif name == "main":      # the line's numbers: the serve path's call
                res.update(fig)
            else:
                res["long_rows"] = fig
    return res


def _prefill_pairs(starts, lens, window):
    """(query, key) pairs the causal/window masks keep."""
    n = 0
    for s, ln in zip(starts, lens):
        for j in range(ln):
            keys = s + j + 1
            n += min(keys, window) if window > 0 else keys
    return n


def check_chunked(torch, ops, cp_ref, dev, gen, shapes, flush):
    """chunked_prefill in fp32, bf16 and fp32 q over bf16 pages at the serve
    path's largest prefill, the speculative verifier's call (phase 4b: L =
    SPEC_K + 1, every row past its prefix) and edge cases; the line's numbers
    are the path's fp32 prefill, ``verify`` the verifier's fp32 call and
    ``mixed`` both over bf16 pages."""
    import torch.nn.functional as F
    hq, hkv, hd, bs = 32, 8, 64, 16
    res = {"mixed": {}}
    odd = ([32, 0, 5, 64, 0, 16, 3, 0], [20, 64, 0, 7, 33, 1, 64, 0])
    cases = [("main", shapes["chunked_starts"], shapes["chunked_lens"],
              shapes["chunked_pad_rows"], shapes["chunked_l"], 0.0, 0),
             ("verify", shapes["verify_starts"], shapes["verify_lens"],
              shapes["verify_pad_rows"], SPEC_K + 1, 0.0, 0),
             # B 4 with cached prefixes: the split balance across rows
             ("B4", [0, 48, 0, 96], [128, 90, 33, 128], (), 128, 0.0, 0),
             ("starts>0+zero", *odd, (), 64, 0.0, 0),
             ("window", *odd, (), 64, 0.0, 24),
             ("softcap+window", *odd, (), 64, 30.0, 40)]
    timed_cases = {"float32": ("main", "verify", "B4"), MIXED: ("main", "verify")}
    for label, qdtype, kvdtype in ATTN_DTYPES:
        qdt, kvdt = getattr(torch, qdtype), getattr(torch, kvdtype)
        tol = TOL_ATTN[kvdtype if qdtype == "float32" else qdtype]
        for name, starts, lens, pads, lq, cap, window in cases:
            if label == MIXED and name in ("B4", "window"):
                continue
            totals = [s + lq for s in starts]
            kp, vp, tables = _pages(torch, dev, gen, totals, bs, hkv, hd, kvdt, pads)
            q = torch.randn((len(lens), lq, hq, hd), generator=gen, device=dev).to(qdt)
            st = torch.tensor(starts, dtype=torch.int32, device=dev)
            ln = torch.tensor(lens, dtype=torch.int32, device=dev)
            args = (q, kp, vp, tables, st, ln)
            got = ops.chunked_prefill(*args, cap=cap, window=window)
            want = cp_ref(*args, cap=cap, window=window)
            err = compare(f"chunked_prefill {label} {name} B={len(lens)} L={lq}",
                          got, want, tol)
            for i, n in enumerate(lens):
                if not torch.all(got[i, n:] == 0):
                    raise Failure("chunked_prefill: padded queries are not zero")
            if label == "float32":
                res["max_abs_err"] = max(res.get("max_abs_err", 0.0), err)
            if name not in timed_cases.get(label, ()):
                continue
            ms = timed(torch, lambda: ops.chunked_prefill(*args), flush)
            plain = timed(torch, lambda: cp_ref(*args), flush)
            # the library yardstick is fp32 SDPA (K and V converted outside)
            k, v = _sdpa_inputs(torch, q, kp.float(), vp.float(), tables, hq // hkv)
            iq = st[:, None] + torch.arange(lq, device=dev)
            ik = torch.arange(k.shape[2], device=dev)
            mask = ((ik[None, None, :] <= iq[..., None])
                    & (iq[..., None] < (st + ln)[:, None, None]))[:, None]
            q4 = q.transpose(1, 2).contiguous()
            lib = timed(
                torch, lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask),
                flush)
            # bytes the function needs: q of the real queries only (padded
            # queries give 0 whatever q holds), the whole output, the K/V of
            # every written token, the tables, starts and lens
            real_q = sum(lens)
            toks = sum(s + n for s, n in zip(starts, lens))
            nbytes = (q.element_size() * (real_q + q.shape[0] * lq) * hq * hd
                      + kp.element_size() * 2 * toks * hkv * hd
                      + 4 * (tables.numel() + 2 * len(lens)))
            ops_n = 4 * hq * hd * _prefill_pairs(starts, lens, window)
            b_ms, b_by = bound(nbytes, ops_n, "float32")
            log(f"    {label} {name} B={len(lens)} L={lq} starts={starts} lens={lens}: "
                f"kernel {ms:.4f} ms, plain {plain:.4f} ms, fp32 SDPA {lib:.4f} ms, bound "
                f"{b_ms:.5f} ms ({b_by}, {100 * b_ms / ms:.1f}% reached)")
            fig = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)
            if label == MIXED:
                res["mixed"][name] = dict(fig, max_abs_err=err)
            elif name == "main":      # the line's numbers: the serve path's call
                res.update(fig)
            else:
                res[name] = fig
    return res


# gemma2_27b's attention (phase 8): Hq 32, Hkv 16 (G 2), hd 128, query scale
# (4608/32)^-0.5, logit softcap 50, the local layers' window 4096
GEMMA_HEADS = (32, 16, 128)
GEMMA_SCALE, GEMMA_CAP, GEMMA_WINDOW = (4608 / 32) ** -0.5, 50.0, 4096


def _window_keys(start: int, n: int, window: int) -> int:
    """Keys the queries at positions start..start+n-1 attend (row total)."""
    if n <= 0:
        return 0
    return start + n - (max(0, start - window + 1) if window > 0 else 0)


def check_family_attention(torch, ops, pa_ref, cp_ref, dev, gen, shapes, flush, *,
                           label, heads, scale, cap, windows):
    """paged_attention and chunked_prefill at a family's ``heads`` (Hq, Hkv,
    hd), query ``scale`` and softcap ``cap``, with each of ``windows`` (0: no
    window), at its path's largest decode batch and largest prefill noted in
    ``shapes``, in fp32 and bf16; timed in fp32 against the plain version,
    SDPA (the same masks and scale; no softcap: no library call has one) and
    the bound. gemma2 (phase 8): its local layer's window 4096 and its global
    layer, a row past the window among the decode rows and the 4400-token
    row at L 4608; qwen2-vl (phase 11): G 6 at hd 128."""
    import torch.nn.functional as F
    hq, hkv, hd = heads
    bs, g = 16, hq // hkv
    kw = dict(scale=scale, cap=cap)
    sdpa_name = "SDPA (no softcap)" if cap else "SDPA"
    res = {"paged": {}, "chunked": {}}
    lengths, pads = shapes["paged_lengths"], shapes["paged_pad_rows"]
    starts, lens, cpads, lq = (shapes["chunked_starts"], shapes["chunked_lens"],
                               shapes["chunked_pad_rows"], shapes["chunked_l"])
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for window in windows:
            layer = "local" if window else "global"
            kp, vp, tables = _pages(torch, dev, gen, lengths, bs, hkv, hd, dt, pads)
            q = torch.randn((len(lengths), hq, hd), generator=gen, device=dev).to(dt)
            ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
            args = (q, kp, vp, tables, ln)
            got = ops.paged_attention(*args, window=window, **kw)
            err = compare(f"paged_attention {label} {dtype} {layer} B={len(lengths)} "
                          f"max length {max(lengths)}", got,
                          pa_ref(*args, window=window, **kw), TOL_ATTN[dtype])
            if not torch.equal(ops.paged_attention(*args, window=window, **kw), got):
                raise Failure(f"paged_attention {label}: two identical calls differ")
            if dtype == "float32":
                ms = timed(torch, lambda: ops.paged_attention(*args, window=window, **kw),
                           flush)
                plain = timed(torch, lambda: pa_ref(*args, window=window, **kw), flush)
                k, v = _sdpa_inputs(torch, q, kp, vp, tables, g)
                ik = torch.arange(k.shape[2], device=dev)[None, :]
                keep = ik < ln[:, None]
                if window:
                    keep &= ik >= ln[:, None] - window
                mask = keep[:, None, None, :]
                q4 = q[:, :, None, :]
                lib = timed(torch, lambda: F.scaled_dot_product_attention(
                    q4, k, v, attn_mask=mask, scale=scale), flush)
                del k, v
                toks = sum(_window_keys(n - 1, 1, window) for n in lengths)
                nbytes = (4 * (sum(1 for n in lengths if n > 0) + len(lengths)) * hq * hd
                          + 4 * 2 * toks * hkv * hd + 4 * (tables.numel() + len(lengths)))
                b_ms, b_by = bound(nbytes, 4 * toks * hq * hd, "float32")
                log(f"    {label} paged {layer} B={len(lengths)} lengths={lengths}: kernel "
                    f"{ms:.4f} ms, plain {plain:.4f} ms, {sdpa_name} {lib:.4f} ms, "
                    f"bound {b_ms:.5f} ms ({b_by}, {100 * b_ms / ms:.1f}% reached)")
                res["paged"][layer] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                           bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                                           lengths=lengths)
            totals = [s + lq for s in starts]
            kp, vp, tables = _pages(torch, dev, gen, totals, bs, hkv, hd, dt, cpads)
            q = torch.randn((len(lens), lq, hq, hd), generator=gen, device=dev).to(dt)
            st = torch.tensor(starts, dtype=torch.int32, device=dev)
            cl = torch.tensor(lens, dtype=torch.int32, device=dev)
            args = (q, kp, vp, tables, st, cl)
            got = ops.chunked_prefill(*args, window=window, **kw)
            want = cp_ref(*args, window=window, **kw)
            err = compare(f"chunked_prefill {label} {dtype} {layer} B={len(lens)} L={lq} "
                          f"lens={lens}", got, want, TOL_ATTN[dtype])
            del want
            if dtype == "float32":
                ms = timed(torch, lambda: ops.chunked_prefill(*args, window=window, **kw),
                           flush)
                plain = timed(torch, lambda: cp_ref(*args, window=window, **kw), flush)
                k, v = _sdpa_inputs(torch, q, kp, vp, tables, g)
                iq = st[:, None] + torch.arange(lq, device=dev)
                ik = torch.arange(k.shape[2], device=dev)
                keep = ((ik[None, None, :] <= iq[..., None])
                        & (iq[..., None] < (st + cl)[:, None, None]))
                if window:
                    keep &= ik[None, None, :] > iq[..., None] - window
                mask = keep[:, None]
                q4 = q.transpose(1, 2).contiguous()
                lib = timed(torch, lambda: F.scaled_dot_product_attention(
                    q4, k, v, attn_mask=mask, scale=scale), flush)
                del k, v, q4, mask
                real_q = sum(lens)
                toks = sum(_window_keys(s, n, window) for s, n in zip(starts, lens))
                nbytes = (4 * (real_q + q.shape[0] * lq) * hq * hd + 4 * 2 * toks * hkv * hd
                          + 4 * (tables.numel() + 2 * len(lens)))
                ops_n = 4 * hq * hd * _prefill_pairs(starts, lens, window)
                b_ms, b_by = bound(nbytes, ops_n, "float32")
                log(f"    {label} chunked {layer} B={len(lens)} L={lq} lens={lens}: kernel "
                    f"{ms:.4f} ms, plain {plain:.4f} ms, {sdpa_name} {lib:.4f} ms, "
                    f"bound {b_ms:.5f} ms ({b_by}, {100 * b_ms / ms:.1f}% reached)")
                res["chunked"][layer] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                             bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                                             lens=lens, L=lq)
            del kp, vp, q, args
            torch.cuda.empty_cache()
    return res


def check_flash(torch, ops, ref, dev, gen, flush):
    """flash_attention in fp32 and bf16; each case must repeat its bits on a
    second identical call. The line's numbers are the compress path's fp32
    call (B8 T64, Hq 32 / Hkv 8, hd 64); ``per_shape`` keeps every timed case
    in both dtypes."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    res = {"max_abs_err": 0.0, "per_shape": []}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for name, b, t, hq, hkv, hd, cap, scale, timed_case in FLASH_CASES:
            q = torch.randn((b, t, hq, hd), generator=gen, device=dev).to(dt)
            k = torch.randn((b, t, hkv, hd), generator=gen, device=dev).to(dt)
            v = torch.randn((b, t, hkv, hd), generator=gen, device=dev).to(dt)
            got = ops.flash_attention(q, k, v, scale=scale, cap=cap)
            err = compare(f"flash_attention {dtype} {name} (B{b} T{t} Hq{hq} Hkv{hkv} "
                          f"hd{hd} cap{cap:g} scale{scale or hd ** -0.5:.5f})", got,
                          ref(q, k, v, scale=scale, cap=cap), TOL_ATTN[dtype])
            if not torch.equal(ops.flash_attention(q, k, v, scale=scale, cap=cap), got):
                raise Failure(f"flash_attention {dtype} {name}: two identical calls differ")
            if dtype == "float32":
                res["max_abs_err"] = max(res["max_abs_err"], err)
            if not timed_case:
                continue
            ms = timed(torch, lambda: ops.flash_attention(q, k, v, scale=scale, cap=cap),
                       flush)
            plain = timed(torch, lambda: ref(q, k, v, scale=scale, cap=cap), flush)
            q4, k4, v4 = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib = timed(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True, scale=scale, enable_gqa=True), flush)
            del q4, k4, v4
            # q, k, v read and o written once; 4*hd FLOPs per causal pair
            nbytes = q.element_size() * 2 * b * t * hd * (hq + hkv)
            b_ms, b_by = bound(nbytes, 2 * b * hq * hd * t * (t + 1), dtype)
            p = fa.plan(b, t, hq, hkv, hd, dt)
            log(f"    {dtype} {name} ({p.blocks} blocks of {p.rows} rows): kernel "
                f"{ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}, {100 * b_ms / ms:.1f}% reached)")
            res["per_shape"].append(dict(
                dtype=dtype, case=name, B=b, T=t, rows=p.rows, blocks=p.blocks, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                reached_pct=100 * b_ms / ms))
            if dtype == "float32" and name == "path B8 T64":
                res.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                           bound_by=b_by)
    return res


def check_gram(torch, ops, ref, dev, gen, flush):
    """gram_accum in fp32 and bf16; the line's numbers are one llama3_1b
    layer's seven fp32 Grams of one calibration record (6 x (512, 2048) and
    1 x (512, 8192)); ``per_shape`` keeps each record shape's fp32 figures."""
    from repro_torch.kernels import gram_accum as ga
    res = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_ms": 0.0, "bound_by": "operations", "per_shape": []}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for k, n, timed_case in GRAM_CASES:
            a = torch.randn((k, n), generator=gen, device=dev).to(dt)
            got = ops.gram_accum(a)
            want = ref([a])
            err = compare(f"gram_accum {dtype} ({k}, {n})", got, want, TOL_GRAM)
            if not torch.equal(got, got.T):
                raise Failure("gram_accum: G is not exactly symmetric")
            if not torch.equal(ops.gram_accum(a), got):
                raise Failure("gram_accum: two identical calls differ")
            if dtype == "float32":
                res["max_abs_err"] = max(res["max_abs_err"], err)
            if not timed_case:
                continue
            ms = timed(torch, lambda: ops.gram_accum(a), flush)
            plain = timed(torch, lambda: ref([a]), flush)
            lib = timed(torch, lambda: a.T @ a, flush) if dtype == "float32" else None
            b_ms, b_by = bound(a.element_size() * k * n + 4 * n * n, k * n * (n + 1),
                               dtype)
            tile = ga.plan(n)
            log(f"    {dtype} ({k}, {n}) ({ga.tiles(n, tile)} tiles of {tile}): kernel "
                f"{ms:.4f} ms, plain "
                f"{plain:.4f} ms, a.T @ a {'n/a' if lib is None else f'{lib:.4f} ms'}, "
                f"bound {b_ms:.4f} ms ({b_by}, {100 * b_ms / ms:.1f}% reached)")
            if dtype == "float32":
                w = GRAM_LAYER[(k, n)]
                res["ms"] += w * ms
                res["plain_ms"] += w * plain
                res["library_ms"] += w * lib
                res["bound_ms"] += w * b_ms
                res["per_shape"].append(dict(k=k, n=n, tile=tile, ms=ms,
                                             plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                                             bound_by=b_by))
    log(f"  gram_accum, one llama3_1b layer's 7 Grams of a 512-token record: "
        f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, a.T @ a "
        f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms")
    return res


# ---------------------------------------------------------------------------
# phase 8 (optional): where a decode step's time goes
# ---------------------------------------------------------------------------

def host_us(torch, fn, n: int = 200) -> float:
    """Host microseconds per call of ``fn`` (enqueue only: the card runs
    behind and is synchronised after the timed loop)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def profile_host(torch, dev) -> None:
    """Host cost of one call at decode shapes: each wrapper against its
    plain version, and two eager model ops (the decode step is host-bound)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import lowrank_linear_ref
    from repro_torch.models.common import apply_rope, rmsnorm, rope_cos_sin
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((8, 2048), generator=gen, device=dev)
    bt = torch.randn((2048, 983), generator=gen, device=dev) / 2048 ** 0.5
    at = torch.randn((983, 8192), generator=gen, device=dev) / 983 ** 0.5
    h = torch.randn((8, 1, 2048), generator=gen, device=dev)
    scale = torch.zeros(2048, device=dev)
    q = torch.randn((8, 1, 32, 64), generator=gen, device=dev)
    cos, sin = rope_cos_sin(torch.arange(8, device=dev)[:, None], 64, 5e5)
    log(f"  host us per call at decode: lowrank_linear gate "
        f"{host_us(torch, lambda: ops.lowrank_linear(x, bt, at)):.1f} (plain "
        f"{host_us(torch, lambda: lowrank_linear_ref(x, bt, at)):.1f}), rmsnorm "
        f"{host_us(torch, lambda: rmsnorm(scale, h, 1e-5)):.1f}, apply_rope "
        f"{host_us(torch, lambda: apply_rope(q, cos, sin)):.1f}")


def profile_decode(torch, res, steps: int) -> None:
    """Wall time of ``steps`` steady decode steps of each model (every
    request of the trace admitted at once, after their prefill), through
    CUDA graphs (warmed up first) and through the eager engine, through
    graphs in bf16 (activations and cache), of the speculative draft served
    alone (its decode step is a draft step of a spec round) and of each
    model's speculative rounds, then
    device time by kernel over ``steps`` more from torch.profiler: the
    card's busy and idle share of a decode step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import ContinuousEngine
    trace = res["trace"]
    pages = 1 + sum(-(-(len(p) + nn) // 16) for _, p, nn in trace)
    max_len = max(len(p) + nn for _, p, nn in trace)
    bf16 = dict(compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16)
    variants = [(name, m, graphs, {}) for name, m in res["models"].items()
                for graphs in (True, False)]
    variants += [(f"{name} bf16", m, True, bf16) for name, m in res["models"].items()]
    variants.append((f"draft {DRAFT_RATIO}", res["spec_draft"], True, {}))
    variants += [(f"{name} spec k {SPEC_K} (a step is a round)", m, True,
                  dict(draft_model=res["spec_draft"], spec_k=SPEC_K))
                 for name, m in res["models"].items()]
    for name, m, graphs, kw in variants:
        eng = ContinuousEngine(m, block_size=16, num_blocks=pages, max_running=8,
                               cuda_graphs=graphs, **kw)
        if graphs:
            eng.warmup(max_len=max_len)
        for _, p, nn in trace:
            eng.submit(p, nn)
        eng.step()                              # prefill + first decode step
        torch.cuda.synchronize()
        t0 = time.perf_counter()                # wall clock, profiler off
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            wall_prof = (time.perf_counter() - t0) / steps * 1e3
        if eng.post_warmup_compiles():
            raise Failure(f"profile {name}: a decode step captured a graph")
        eng.release_graphs()
        events, attr = _cuda_events(prof)
        busy = sum(getattr(e, attr) for e in events) / 1e3 / steps
        how = "graphs" if graphs else "eager"
        log(f"  profile {name} ({how}): {wall:.3f} ms per decode step (wall, profiler "
            f"off), device busy {busy:.3f} ms per step under the profiler: "
            f"{100 * busy / wall:.1f}% of the step's wall time, the card idle "
            f"{100 - 100 * busy / wall:.1f}% ({wall_prof:.3f} ms per step with the "
            f"profiler on)")
        for e in sorted(events, key=lambda e: -getattr(e, attr))[:8]:
            log(f"    {getattr(e, attr) / 1e3 / steps:8.4f} ms/step  "
                f"x{e.count // steps:<4d} {e.key[:90]}")


def run(args) -> int:
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (pins TF32 off)
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.chunked_prefill import chunked_prefill_ref
    from repro_torch.kernels.paged_attention import paged_attention_ref
    from repro_torch.kernels.ref import (flash_attention_ref, gram_accum_ref,
                                         lowrank_linear_ref)

    dev = torch.device("cuda:0")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1 device] nvidia-smi: {smi}; torch: {kind}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.lib()
    build_s = time.perf_counter() - t0
    log(f"[2 build] nvcc sm_90a of {len(_build.SOURCES)} sources: {build_s:.2f} s "
        f"({_build.library_path().name}, named by a digest of the sources)")

    log("[3 reference] llama3_1b SMOKE: kernels on the card vs plain versions on the CPU")
    reference_check(torch, dev)
    reference_loss_grams(torch, dev)
    reference_spec(torch, dev)
    reference_adapter_step(torch, dev)
    log(f"[3 reference] {', '.join(FAMILIES)} SMOKE: kernels on the card vs plain "
        "versions on the CPU, graphs on the card vs the eager engine on the CPU")
    reference_families(torch, dev)
    log("[3 reference] qwen2_vl_2b SMOKE with vision prefixes: card graphs vs the CPU's "
        "eager engine; the kernels at qwen2-vl's heads (G 6, hd 128) vs plain versions")
    reference_vlm(torch, dev)
    reference_group6(torch, ops, dev)

    backward = {}           # lowrank_linear's backward launches by path window

    def path_window(name, kernels, fn):
        """Run one path with the launch counts zeroed just before and read
        just after; every kernel in ``kernels`` must have launched."""
        torch.cuda.reset_peak_memory_stats()
        STEP_PEAKS.clear()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        counts = ops.launch_counts()
        backward[name] = ops.backward_launch_counts()["lowrank_linear"]
        peak = max([torch.cuda.max_memory_allocated() / 1e9] + STEP_PEAKS)
        log(f"  launches on the {name} path: {counts} (of lowrank_linear's, "
            f"{backward[name]} by its backward); peak memory {peak:.2f} GB; "
            f"{time.perf_counter() - t0:.1f} s")
        missing = [k for k in kernels if counts[k] <= 0]
        if missing:
            raise Failure(f"kernels never launched on the {name} path: {missing}")
        return out, counts, peak

    log("[4 serve path] python -m repro_torch.launch.serve " + " ".join(LAUNCHER_ARGS)
        + f" on a trace of {REQUESTS} requests (prompts {MIN_PROMPT}-{MAX_PROMPT}, "
        f"{NEW_TOKENS} new tokens, one every 2 steps); then the eager oracle, a "
        f"{SHARED_PREFIX}-token shared-prefix variant and a sampled run (T {TEMPERATURE}, "
        "twice) on its models")
    (serve, res, shapes), serve_counts, peak = path_window(
        "serve", ("lowrank_linear", "paged_attention", "chunked_prefill",
                  "flash_attention"), lambda: serve_path(torch, ops))
    serve["peak_memory_gb"] = peak
    log(f"  phases (s): {serve['seconds']}")
    log(f"  kernel shapes noted on the serve path: {shapes}")

    log("[4b serve-spec] python -m repro_torch.launch.serve " + " ".join(
        LAUNCHER_ARGS + SPEC_ARGS) + " on the same trace, handed phase 4's models and "
        "calibrator; then the eager spec engine and a sampled run (T "
        f"{TEMPERATURE}, twice)")
    (spec, spec_shapes), spec_counts, peak = path_window(
        "serve-spec", ("lowrank_linear", "paged_attention", "chunked_prefill"),
        lambda: serve_spec_path(torch, ops, res))
    spec["peak_memory_gb"] = peak
    log(f"  phases (s): {spec['seconds']}")
    log(f"  kernel shapes noted on the serve-spec path: {spec_shapes}")
    shapes.update({k: v for k, v in spec_shapes.items() if k.startswith("verify")})

    log("[4c serve dtypes] phase 4's models through graphs at (compute, cache) "
        f"{[(n, c, k) for n, c, k in DTYPE_RUNS]}")
    dtypes, dtype_counts, peak = path_window(
        "serve-dtypes", ("lowrank_linear", "paged_attention", "chunked_prefill"),
        lambda: serve_dtypes_path(torch, res))
    dtypes["peak_memory_gb"] = peak

    log("[4d serve-recalib] python -m repro_torch.launch.serve " + " ".join(
        LAUNCHER_ARGS + RECALIB_ARGS) + f" on {RECALIB_REQUESTS} requests of phase 4's "
        "ranges, handed phase 4's models and calibrator; then the swapped graphs "
        "against the solved model, swaps on a fresh engine, capture throughput")
    recalib, recalib_counts, peak = path_window(
        "serve-recalib", ("lowrank_linear", "paged_attention", "chunked_prefill",
                          "flash_attention"), lambda: serve_recalib_path(torch, ops, res, smi))
    recalib["peak_memory_gb"] = peak
    log(f"  phases (s): {recalib['seconds']}")
    if not args.profile:
        del res
        torch.cuda.empty_cache()

    log("[5 compress path] python -m repro_torch.launch.compress "
        + " ".join(COMPRESS_ARGS) + " --method coala, then --method svd_llm")
    (comp, coala, comp_shapes), comp_counts, peak = path_window(
        "compress", ("lowrank_linear", "flash_attention"),
        lambda: compress_path(torch, ops))
    comp["peak_memory_gb"] = peak
    log(f"  phases (s): {comp['seconds']}")
    log(f"  kernel shapes noted on the compress path: {comp_shapes}")
    log(f"  {', '.join(EXTRA_METHODS)} on the coala run's trained model and calibrator "
        f"({EXTRA_PREFIX} linears only)")
    comp["extra"] = extra_methods(torch, coala)

    log("[6 gram path] calibrate_model(collect_gram=True) on the trained model, "
        "4 x 8 x 64 tokens")
    (gram, gram_shapes), gram_counts, peak = path_window(
        "gram", ("gram_accum", "flash_attention"), lambda: gram_path(torch, ops, coala))
    gram["peak_memory_gb"] = peak
    log(f"  kernel shapes noted on the gram path: {gram_shapes}")

    log("[10 compression core] adaptive ranks, Table 4's adapters and Theorem 1 on "
        "phase 5's trained model and calibrator")
    (core, adaptive_shapes, adaptive_ranks), core_counts, peak = path_window(
        "compression-core", ("lowrank_linear", "paged_attention", "chunked_prefill",
                             "flash_attention"),
        lambda: compression_core_path(torch, ops, coala))
    core["peak_memory_gb"] = peak
    if backward["compression-core"] <= 0:
        raise Failure("no backward launch of lowrank_linear on the compression-core path")
    log(f"  kernel shapes noted on the adaptive serve run: {adaptive_shapes}")
    del coala
    torch.cuda.empty_cache()

    log(f"[8 gemma2 path] python -m repro_torch.launch.serve " + " ".join(GEMMA_ARGS)
        + f" on gemma2_27b at full width, depth cut to {GEMMA_LAYERS} of 46 layers (one "
        f"local, one global), on phase 4's trace plus one {LONG_PROMPT}-token prompt; "
        "then the eager engine")
    (gemma, gemma_shapes), gemma_counts, peak = path_window(
        "gemma2", ("lowrank_linear", "paged_attention", "chunked_prefill",
                   "flash_attention"), lambda: gemma2_path(torch, ops))
    gemma["peak_memory_gb"] = peak
    log(f"  kernel shapes noted on the gemma2 path: {json.dumps(gemma_shapes)}")

    log("[9 deepseek path] python -m repro_torch.launch.compress " + " ".join(DEEPSEEK_ARGS)
        + f" --method coala, then --method svd_llm, on deepseek_moe_16b at full width, "
        f"depth cut to {DEEPSEEK_LAYERS} of 28 layers (the dense-FFN layer and "
        f"{DEEPSEEK_LAYERS - 1} MoE "
        "layers); then the COALA model serves phase 4's trace")
    moe, moe_counts, peak = path_window(
        "deepseek", ("lowrank_linear", "paged_attention", "chunked_prefill",
                     "flash_attention"), lambda: deepseek_path(torch, ops))
    moe["peak_memory_gb"] = peak

    log("[9b deepseek-v2 MLA path] python -m repro_torch.launch.serve " + " ".join(MLA_ARGS)
        + f" on deepseek_v2_lite_16b at full width, depth cut to {MLA_LAYERS} of 27 layers "
        f"(the dense-FFN layer and one MoE layer, both MLA), on phase 4's trace plus one "
        f"{MLA_LONG_PROMPT}-token prompt; then the eager engine")
    (mla, mla_shapes), mla_counts, peak = path_window(
        "deepseek-v2", ("lowrank_linear", "flash_attention"), lambda: mla_path(torch, ops))
    mla["peak_memory_gb"] = peak
    launched = {k: mla_counts[k] for k in MLA_NO_LAUNCH if mla_counts[k] != 0}
    log(f"  paged kernels on the MLA path (latent pages): "
        f"{ {k: mla_counts[k] for k in MLA_NO_LAUNCH} } (must be 0)")
    if launched:
        raise Failure(f"paged kernels launched on the MLA path: {launched}")
    log(f"  kernel shapes noted on the MLA path: {json.dumps(mla_shapes)}")

    log("[11 qwen2-vl path] python -m repro_torch.launch.serve " + " ".join(VLM_FIXED_ARGS)
        + " (fixed batch), then " + " ".join(VLM_ARGS) + f" on qwen2_vl_2b at full width, "
        f"depth cut to {VLM_LAYERS} of 28 layers; then a mixed trace (every second request "
        "with a 256-token vision prefix) through graphs and eagerly, and the offline lane")
    (vlm, vlm_shapes), vlm_counts, peak = path_window(
        "qwen2-vl", ("lowrank_linear", "paged_attention", "chunked_prefill",
                     "flash_attention"), lambda: vlm_path(torch, ops))
    vlm["peak_memory_gb"] = peak
    log(f"  kernel shapes noted on the qwen2-vl path: {json.dumps(vlm_shapes)}")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 << 18, dtype=torch.float32, device=dev)   # 256 MB
    log("[7 kernels] against plain versions on the card, at the paths' shapes")
    results = {
        "lowrank_linear": check_lowrank(torch, ops, lowrank_linear_ref, dev, gen,
                                        shapes, flush),
        "paged_attention": check_paged(torch, ops, paged_attention_ref, dev, gen,
                                       shapes, flush),
        "chunked_prefill": check_chunked(torch, ops, chunked_prefill_ref, dev, gen,
                                         shapes, flush),
        "flash_attention": check_flash(torch, ops, flash_attention_ref, dev, gen, flush),
        "gram_accum": check_gram(torch, ops, gram_accum_ref, dev, gen, flush),
    }
    log("[7 kernels] at gemma2_27b's shapes (phase 8)")
    from repro_torch.models.linear import rank_for_ratio
    gemma_proj = {name: (d_in, rank_for_ratio(d_in, d_out, 0.6), d_out)
                  for name, (d_in, d_out) in GEMMA2_PROJECTIONS.items()}
    gemma_kernels = {
        "lowrank_linear": check_lowrank(torch, ops, lowrank_linear_ref, dev, gen,
                                        gemma_shapes, flush, proj=gemma_proj,
                                        model="gemma2_27b", extra_rows=(256,)),
        "attention": check_family_attention(
            torch, ops, paged_attention_ref, chunked_prefill_ref, dev, gen, gemma_shapes,
            flush, label="gemma2", heads=GEMMA_HEADS, scale=GEMMA_SCALE, cap=GEMMA_CAP,
            windows=(GEMMA_WINDOW, 0))}
    log("[7 kernels] at deepseek_v2_lite_16b's shapes (phase 9b)")
    mla_proj = {name: (d_in, rank_for_ratio(d_in, d_out, 0.6), d_out)
                for name, (d_in, d_out) in MLA_PROJECTIONS.items()}
    mla_kernels = {"lowrank_linear": check_lowrank(
        torch, ops, lowrank_linear_ref, dev, gen, mla_shapes, flush,
        proj=mla_proj, model="deepseek_v2_lite_16b", extra_rows=(8,))}
    log("[7 kernels] at qwen2_vl_2b's shapes (phase 11): G 6, hd 128")
    vlm_proj = {name: (d_in, rank_for_ratio(d_in, d_out, 0.6), d_out)
                for name, (d_in, d_out) in VLM_PROJECTIONS.items()}
    vlm_kernels = {
        "lowrank_linear": check_lowrank(
            torch, ops, lowrank_linear_ref, dev, gen, vlm_shapes, flush, proj=vlm_proj,
            model="qwen2_vl_2b", extra_rows=(8, vlm_shapes["vlm_prefill_t"])),
        "attention": check_family_attention(
            torch, ops, paged_attention_ref, chunked_prefill_ref, dev, gen, vlm_shapes,
            flush, label="qwen2-vl", heads=VLM_HEADS, scale=None, cap=0.0,
            windows=(0,))}
    log("[7 kernels] lowrank_linear at phase 10's adaptive ranks (block 0) and under "
        f"autograd at M {GRAD_ROWS}: rank {ADAPTER_RANK} on the seven projections, and "
        "one odd adaptive rank")
    adaptive_proj = {}
    for path, r in adaptive_ranks.items():
        if path.startswith("blocks/0/"):
            name = path.rsplit("/", 1)[1]
            d_in, _, d_out = LOWRANK_SHAPES[name]
            adaptive_proj[name] = (d_in, r, d_out)
    adaptive_kernels = check_lowrank(torch, ops, lowrank_linear_ref, dev, gen,
                                     adaptive_shapes, flush, proj=adaptive_proj,
                                     model="llama3_1b adaptive")
    grad_proj = {name: (d_in, ADAPTER_RANK, d_out)
                 for name, (d_in, _, d_out) in LOWRANK_SHAPES.items()}
    odd = sorted(adaptive_proj.items(), key=lambda kv: (kv[1][1] % 2 == 0, kv[0]))[0]
    grad_proj[f"{odd[0]} adaptive"] = odd[1]
    grads = check_lowrank_grad(torch, ops, lowrank_linear_ref, dev, gen, flush, grad_proj)
    layer_bwd = {k: sum(row[k] for n, row in grads.items() if n in LOWRANK_SHAPES)
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms", "wall_ms",
                           "plain_wall_ms", "library_wall_ms")}
    layer_bwd.update(max_abs_err=max(row["max_abs_err"] for row in grads.values()),
                     bound_by=grads["down"]["bound_by"], m=GRAD_ROWS, r=ADAPTER_RANK)
    log(f"  lowrank_linear forward + backward, one llama3_1b layer's adapters (M "
        f"{GRAD_ROWS}, r {ADAPTER_RANK}), on the card: kernel {layer_bwd['ms']:.4f} ms, "
        f"plain {layer_bwd['plain_ms']:.4f} ms, multi_dot {layer_bwd['library_ms']:.4f} "
        f"ms, bound {layer_bwd['bound_ms']:.4f} ms; wall: kernel "
        f"{layer_bwd['wall_ms']:.4f} ms, plain {layer_bwd['plain_wall_ms']:.4f} ms, "
        f"multi_dot {layer_bwd['library_wall_ms']:.4f} ms")
    del flush
    torch.cuda.synchronize()
    if args.profile:
        log(f"[12 profile] {args.profile} decode steps per model")
        profile_decode(torch, res, args.profile)
        profile_host(torch, dev)
        del res

    replaces = {"lowrank_linear": "src/repro/kernels/lowrank_linear.py:35",
                "paged_attention": "src/repro/kernels/paged_attention.py:96",
                "chunked_prefill": "src/repro/kernels/chunked_prefill.py:121",
                "flash_attention": "src/repro/kernels/flash_attention.py:69",
                "gram_accum": "src/repro/kernels/gram_accum.py:37"}
    by_phase = {"serve": serve_counts, "serve_spec": spec_counts,
                "serve_dtypes": dtype_counts, "serve_recalib": recalib_counts,
                "compress": comp_counts, "gram": gram_counts,
                "compression_core": core_counts, "gemma2": gemma_counts,
                "deepseek": moe_counts, "deepseek_v2_mla": mla_counts,
                "qwen2_vl": vlm_counts}
    launches = {k: sum(c[k] for c in by_phase.values()) for k in replaces}
    kernels = [{"name": k, "route": "cuda", "source": f"src/repro_torch/csrc/{k}.cu",
                "replaces": replaces[k], "launches": launches[k],
                "max_abs_err": results[k]["max_abs_err"], "ms": results[k]["ms"],
                "plain_ms": results[k]["plain_ms"], "bound_ms": results[k]["bound_ms"],
                "bound_by": results[k]["bound_by"],
                "library_ms": results[k]["library_ms"],
                "launches_by_phase": {p: c[k] for p, c in by_phase.items()}}
               for k in replaces]
    # lowrank_linear's backward (dx): its launches, of those above, and its
    # forward + backward time on one layer's adapters (phase 7)
    lowrank = next(k for k in kernels if k["name"] == "lowrank_linear")
    lowrank.update(launches_backward=sum(backward.values()),
                   launches_backward_by_phase=dict(backward), backward=layer_bwd)
    log(json.dumps({"main_path": {"serve": serve, "serve_spec": spec,
                                  "serve_dtypes": dtypes, "serve_recalib": recalib,
                                  "compress": comp, "gram": gram, "gemma2": gemma,
                                  "deepseek": moe, "deepseek_v2_mla": mla,
                                  "compression_core": core, "qwen2_vl": vlm},
                    "launches": by_phase,
                    "lowrank_backward_launches": backward,
                    "lowrank_adaptive": adaptive_kernels,
                    "lowrank_backward": grads,
                    "gemma2_kernels": gemma_kernels,
                    "mla_kernels": mla_kernels,
                    "vlm_kernels": vlm_kernels,
                    "paged_mixed": results["paged_attention"]["mixed"],
                    "chunked_mixed": results["chunked_prefill"]["mixed"],
                    "chunked_verify": results["chunked_prefill"]["verify"],
                    "lowrank_prefill": results["lowrank_linear"]["prefill"],
                    "chunked_b4": results["chunked_prefill"]["B4"],
                    "paged_long_rows": results["paged_attention"]["long_rows"],
                    "gram_per_shape": results["gram_accum"]["per_shape"],
                    "flash_per_shape": results["flash_attention"]["per_shape"],
                    "build_s": build_s}, default=float))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", type=int, default=0,
                    help="after the kernel checks, profile this many decode "
                         "steps per model of the serve path with torch.profiler "
                         "(0 = off)")
    args = ap.parse_args()
    try:
        return run(args)
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
