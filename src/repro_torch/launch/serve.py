"""Serving launcher of the port (counterpart of ``repro/launch/serve.py``):
calibrate on seeded tokens, COALA-compress, then serve a mixed-length
synthetic request trace with continuous batching over the paged KV pool,
for both the dense and the compressed model, reporting per-request TTFT and
aggregate throughput.

  PYTHONPATH=src python -m repro_torch.launch.serve --continuous \\
      --arch llama3_1b --smoke --requests 4 --new-tokens 8 [--device cpu]

Runs on the GPU by default and raises without one unless ``--device cpu``.
On the GPU each engine replays one CUDA graph per step signature;
``--warmup on`` captures the whole set the trace can reach before serving.
``--prefix-cache`` (auto = on) reuses cached block-aligned prompt prefixes,
``--shared-prefix N`` prepends one common N-token prefix to every prompt,
and ``--temperature`` samples instead of taking the argmax.
``--draft-ratio R --spec-k K`` serves both models speculatively: a draft
COALA-compressed at ratio R from the same calibration pass proposes K
tokens a round and the served model verifies them (greedy tokens are those
of the non-speculative run). Like the JAX launcher it serves in fp32:
the serving dtypes are the engine's ``compute_dtype``/``cache_dtype``. The
fixed-batch engine, recalibration and telemetry wait for later slices.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import CompressConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.calibrate import calibrate_model
from repro_torch.core.compress import (compress_model, compress_model_pair,
                                       compression_summary)
from repro_torch.models import build_model
from repro_torch.models.common import ParallelCtx
from repro_torch.serve import ContinuousEngine


def synthetic_trace(n_requests: int, vocab_size: int, *, seed: int = 0,
                    min_prompt: int = 4, max_prompt: int = 24,
                    min_new: int = 4, max_new: int = 16,
                    arrival_every: int = 2, shared_prefix: int = 0):
    """Mixed-length request trace with staggered arrivals (same numpy
    stream as the JAX launcher). ``shared_prefix`` prepends one common
    random prefix of that length to every prompt, the system-prompt traffic
    the prefix cache serves. Returns (arrival_step, prompt, max_new)."""
    rng = np.random.RandomState(seed)
    common = rng.randint(0, vocab_size, (shared_prefix,)).astype(np.int32)
    trace = []
    for i in range(n_requests):
        t0 = int(rng.randint(min_prompt, max_prompt + 1))
        nn = int(rng.randint(min_new, max_new + 1))
        prompt = rng.randint(0, vocab_size, (t0,)).astype(np.int32)
        if shared_prefix:
            prompt = np.concatenate([common, prompt])
        trace.append((i * arrival_every, prompt, nn))
    return trace


def serve_trace(engine: ContinuousEngine, trace, *, temperature: float = 0.0):
    """Replay a trace: submissions are keyed to engine steps, so requests
    join the running decode batch mid-flight."""
    pending = list(trace)
    step = 0
    while pending or engine.has_work():
        while pending and pending[0][0] <= step:
            _, prompt, nn = pending.pop(0)
            engine.submit(prompt, nn, temperature=temperature)
        engine.step()
        step += 1
    return engine.metrics()


def calibration_batches(vocab_size: int, *, n_batches: int, batch: int,
                        seq_len: int, seed: int, device):
    """Seeded numpy calibration tokens, (batch, seq_len) per batch."""
    rng = np.random.RandomState(seed)
    return [torch.as_tensor(rng.randint(0, vocab_size, (batch, seq_len)),
                            device=device) for _ in range(n_batches)]


def _seconds(device, fn):
    """(fn(), wall seconds), with the device drained before and after."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def _ccfg(ratio: float) -> CompressConfig:
    """The launcher's COALA settings: λ = 4, μ per layer from Eq. 5."""
    return CompressConfig(method="coala", ratio=ratio, lam=4.0, mu=-1.0)


def _compressed_params(model, batches, ratio: float, draft_ratio: float = 0.0):
    """COALA-compress at ``ratio``; with ``draft_ratio`` also build the
    harder-compressed speculative draft from the same calibration pass
    (``compress_model_pair``). The calibration forward takes the flash
    kernel (``use_pallas``). Returns (compressed model, draft or None,
    reports, calibrator, seconds of calibration and of compression)."""
    cal, cal_s = _seconds(model.device, lambda: calibrate_model(
        model, batches, ctx=ParallelCtx(use_pallas=True)))
    dmodel = None
    if draft_ratio > 0:
        (cmodel, dmodel, reports, dreports), comp_s = _seconds(
            model.device, lambda: compress_model_pair(
                model, cal, _ccfg(ratio), draft_ratio=draft_ratio))
        print("draft compression:", compression_summary(dreports))
    else:
        (cmodel, reports), comp_s = _seconds(
            model.device, lambda: compress_model(model, cal, _ccfg(ratio)))
    print("compression:", compression_summary(reports))
    print(f"calibration {cal_s:.2f}s, compression of "
          f"{len(reports) * (2 if dmodel is not None else 1)} linears "
          f"{comp_s:.2f}s")
    return cmodel, dmodel, reports, cal, {"calibrate": cal_s, "compress": comp_s}


def _parse_buckets(spec: str):
    """'1,2,4,8' -> (1, 2, 4, 8); empty -> None (engine default)."""
    return tuple(int(s) for s in spec.split(",") if s.strip()) or None


def run_continuous(args, cfg, model, trace=None, reuse=None):
    """Calibrate, compress, then serve ``trace`` (default: the launcher's
    synthetic trace) with the dense and the compressed model, speculatively
    with ``--draft-ratio``. Returns a dict with the compression ``reports``,
    the ``calibrator``, the ``draft`` (or None) and, per model name
    ("dense", "coala"), its ``models``, ``engines`` and ``metrics``, plus
    the ``seconds`` of each phase. ``reuse``, an earlier result of the same
    arguments, supplies the calibrator and the compressed model, so that
    only the draft is compressed."""
    if args.requests <= 0:
        print("no requests to serve")
        return None
    ratio = args.compress_ratio if args.compress_ratio > 0 else 0.6
    if reuse is None:
        batches = calibration_batches(cfg.vocab_size, n_batches=2,
                                      batch=args.requests,
                                      seq_len=args.prompt_len, seed=args.seed,
                                      device=model.device)
        cmodel, dmodel, reports, cal, seconds = _compressed_params(
            model, batches, ratio, args.draft_ratio)
    else:
        cal, cmodel, reports = (reuse["calibrator"], reuse["models"]["coala"],
                                reuse["reports"])
        dmodel, seconds = None, {}
        if args.draft_ratio > 0:
            dcfg = dataclasses.replace(_ccfg(ratio), ratio=args.draft_ratio)
            (dmodel, dreports), seconds["compress_draft"] = _seconds(
                model.device, lambda: compress_model(model, cal, dcfg))
            print("draft compression:", compression_summary(dreports))
    if trace is None:
        trace = synthetic_trace(args.requests, cfg.vocab_size, seed=args.seed,
                                max_new=args.new_tokens,
                                shared_prefix=args.shared_prefix)
    prefix = {"auto": None, "on": True, "off": False}[args.prefix_cache]
    # warm for exactly the worst per-request cache need this trace can hit
    warm_len = max(len(p) + nn for _, p, nn in trace)
    out = {"reports": reports, "calibrator": cal, "draft": dmodel,
           "trace": trace, "seconds": seconds,
           "models": {"dense": model, "coala": cmodel},
           "engines": {}, "metrics": {}, "warmup": {}}
    for name, m in out["models"].items():
        # the dense and the compressed target serve with the same draft
        eng = ContinuousEngine(m, block_size=args.block_size,
                               num_blocks=args.num_blocks,
                               max_running=args.max_running,
                               bucket_sizes=_parse_buckets(args.bucket_sizes),
                               prefix_cache=prefix,
                               prefill_bucket_sizes=_parse_buckets(
                                   args.prefill_bucket_sizes),
                               draft_model=dmodel, spec_k=args.spec_k)
        if args.warmup == "on":
            w = out["warmup"][name] = eng.warmup(max_len=warm_len)
            print(f"[{name}] warmup: {w['warmup_seconds']:.2f}s for "
                  f"{int(w['decode_signatures'])} decode + "
                  f"{int(w['prefill_signatures'])} prefill signatures "
                  f"(max_len {int(w['max_len'])})")
        met, seconds[f"serve_{name}"] = _seconds(
            m.device, lambda: serve_trace(eng, trace,
                                          temperature=args.temperature))
        # free this engine's graphs before the next model captures its own
        eng.release_graphs()
        out["engines"][name], out["metrics"][name] = eng, met
        print(f"[{name}] per-request TTFT (s):")
        for r in sorted(eng.finished, key=lambda r: r.req_id):
            print(f"  req {r.req_id:3d}: prompt={len(r.prompt):3d} "
                  f"new={len(r.out_tokens):3d} ttft={r.ttft:.3f}s"
                  + (f" (preempted x{r.preemptions})" if r.preemptions else ""))
        path = "cuda graphs" if eng.cuda_graphs else "eager"
        print(f"[{name}] aggregate (paged, {m.device.type}, {path}): "
              f"{met['requests']} requests in {seconds[f'serve_{name}']:.2f}s, "
              f"{met['requests_per_sec']:.2f} req/s, "
              f"{met['tokens_per_sec']:.1f} new tok/s "
              f"({met['decode_tok_per_s']:.1f} decode tok/s steady-state), "
              f"mean TTFT {met['mean_ttft_s']:.3f}s, "
              f"{met['decode_compiles']} decode captures over "
              f"{met['decode_steps']} steps, "
              f"{met['preemptions']} preemptions"
              + (f"; {met['post_warmup_compiles']} post-warmup compiles"
                 if args.warmup == "on" else ""))
        if dmodel is not None:
            print(f"[{name}] speculative (draft ratio {args.draft_ratio}, "
                  f"k={int(met['spec_k'])}): {met['spec_rounds']} rounds, "
                  f"accept rate {met['spec_accept_rate']:.2f} "
                  f"({met['spec_accepted_tokens']}/"
                  f"{met['spec_proposed_tokens']} draft tokens)")
        print(f"[{name}] prefill: {met['prefill_tok_per_s']:.1f} suffix "
              f"tok/s steady-state, {met['prefill_compiles']} captures / "
              f"{met['prefill_batches']} batched calls; prefix cache "
              f"{'on' if eng.prefix_cache else 'off'}: "
              f"hit rate {met['prefix_hit_rate']:.2f} "
              f"({met['prefix_hit_tokens']} tokens), "
              f"{met['cached_blocks']} cached blocks, "
              f"{met['cow_copies']} COW copies, "
              f"{met['prefix_evictions']} evictions")
    return out


def main(argv=None, trace=None, reuse=None):
    """Command-line entry point; ``trace`` replaces the synthetic trace and
    ``reuse`` an earlier result supplies the models, the calibrator and the
    compressed model (see ``run_continuous``, whose result it returns)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over the paged KV cache (the "
                         "only serving mode ported so far)")
    ap.add_argument("--compress-ratio", type=float, default=0.0)
    ap.add_argument("--draft-ratio", type=float, default=0.0,
                    help="self-speculative decoding: also build a harder-"
                         "compressed COALA draft at this kept-parameter "
                         "ratio from the same calibration pass, and serve "
                         "with draft-proposed tokens verified by the target "
                         "(0 = off)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per speculative round "
                         "(used with --draft-ratio)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="calibration sequence length")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--block-size", type=int, default=8,
                    help="paged-cache tokens per block")
    ap.add_argument("--num-blocks", type=int, default=256)
    ap.add_argument("--max-running", type=int, default=8)
    ap.add_argument("--bucket-sizes", default="",
                    help="comma-separated decode batch buckets, e.g. "
                         "'1,2,4,8' (default: powers of two up to "
                         "--max-running)")
    ap.add_argument("--prefill-bucket-sizes", default="",
                    help="comma-separated prompt-suffix length buckets for "
                         "batched prefill (default: powers of two, floor 8)")
    ap.add_argument("--prefix-cache", choices=("auto", "on", "off"),
                    default="auto",
                    help="reuse cached block-aligned prompt prefixes "
                         "(auto = on: the port serves pure-attention LMs)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend one common prefix of this many tokens to "
                         "every trace prompt")
    ap.add_argument("--warmup", choices=("on", "off"), default="off",
                    help="capture every step signature the trace can reach "
                         "before serving (CUDA graphs; nothing on the CPU)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature of every request (0 = greedy)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if not args.continuous:
        ap.error("only --continuous serving is ported so far")
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if reuse is not None:
        model, init_s = reuse["models"]["dense"], 0.0
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        model, init_s = _seconds(
            device, lambda: build_model(cfg, device=device).init(gen))
    out = run_continuous(args, cfg, model, trace=trace, reuse=reuse)
    if out is not None:
        out["seconds"]["init"] = init_s
    return out


if __name__ == "__main__":
    main()
