"""Serving launcher of the port (counterpart of ``repro/launch/serve.py``).

Fixed batch (the default): generate from the token pipeline's first batch
(``--requests`` rows of ``--prompt-len`` tokens, with a vlm's vision prefix)
through ``ServeEngine``, the model COALA-compressed first with
``--compress-ratio`` > 0:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_vl_2b \\
      --smoke --requests 4 --new-tokens 8 [--device cpu]

Continuous batching (``--continuous``): calibrate on seeded tokens,
COALA-compress, then serve a mixed-length synthetic request trace over the
paged KV pool, for both the dense and the compressed model, reporting
per-request TTFT and aggregate throughput:

  PYTHONPATH=src python -m repro_torch.launch.serve --continuous \\
      --arch llama3_1b --smoke --requests 4 --new-tokens 8 [--device cpu]

``--arch`` is any of ``repro_torch.configs.ARCH_IDS``: the dense GQA
families (llama3_1b, mistral_7b, smollm_135m, olmo_1b, minicpm_2b,
gemma2_27b), deepseek_moe_16b's MoE, deepseek_v2_lite_16b's MLA over MoE
(its latent KV pages read in plain torch; no paged kernel runs for it) and
qwen2_vl_2b (calibrated with a seeded vision prefix; the synthetic trace is
text-only, as the reference's).

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
the serving dtypes are the engine's ``compute_dtype``/``cache_dtype``.

``--calibrate-from-traffic`` streams the COALA engine's sampled traffic
(``--recalib-sample-rate``) through the dense model into calibration and
hot-swaps recompressed factors, at the initial compression's ranks, into
the live engine once the error bound clears (``--recalib-min-token-factor``,
``--recalib-max-residual-excess``, polled every ``--recalib-check-every``
steps, solved on a background thread with ``--recalib-async on``); with
``--draft-ratio`` the draft is recompressed and swapped with it. Telemetry:
``--trace-out`` writes the span trace (``--trace-max-events`` caps it as a
ring), ``--metrics-out`` the last engine's registry as Prometheus text,
``--flight-recorder N`` keeps N lifecycle events for postmortems, and
``--slo-ttft-ms``/``--slo-tpot-ms`` grade requests into the goodput gauge,
and ``--telemetry-port`` serves ``/metrics``, ``/healthz``, ``/requests`` and
``/snapshot`` from the running engines (one server, re-attached to each).
``--offline`` serves the trace through the offline lane (``run_offline``)
and ``--detok-async`` picks the detokenize worker (on) or inline delivery.
The reference's ``--paged-kernel`` and ``--prefill-kernel`` have no
counterpart: the kernels dispatch on the device.
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
                                       compression_summary,
                                       rank_map_from_reports)
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import build_model
from repro_torch.models.common import ParallelCtx
from repro_torch.obs import FlightRecorder, TelemetryServer
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import (ContinuousEngine, RecalibPolicy, RecalibWorker,
                               ServeEngine, TrafficCalibrator)


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


def calibration_batches(cfg, *, n_batches: int, batch: int, seq_len: int,
                        seed: int, device):
    """Seeded numpy calibration tokens, (batch, seq_len) per batch; for a
    vlm each batch is ``{"tokens", "vision_embeds"}`` with an N(0, 1)
    vision prefix (batch, n_vision_tokens, d_model) from the same stream, so
    calibration sees the prefix, as the reference's pipeline batches do."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        tok = torch.as_tensor(rng.randint(0, cfg.vocab_size, (batch, seq_len)),
                              device=device)
        if cfg.family == "vlm" and cfg.n_vision_tokens:
            vis = rng.standard_normal((batch, cfg.n_vision_tokens, cfg.d_model))
            out.append({"tokens": tok, "vision_embeds": torch.as_tensor(
                vis, dtype=torch.float32, device=device)})
        else:
            out.append(tok)
    return out


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
    dmodel = dreports = None
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
    return (cmodel, dmodel, reports, dreports, cal,
            {"calibrate": cal_s, "compress": comp_s})


def _parse_buckets(spec: str):
    """'1,2,4,8' -> (1, 2, 4, 8); empty -> None (engine default)."""
    return tuple(int(s) for s in spec.split(",") if s.strip()) or None


def run_continuous(args, cfg, model, trace=None, reuse=None):
    """``_run_continuous`` with the live telemetry server of
    ``--telemetry-port`` (>= 0; 0 picks an ephemeral port) up for the whole
    run, re-attached to each engine, and closed at the end."""
    server = None
    if args.telemetry_port >= 0 and args.requests > 0:
        server = TelemetryServer(port=args.telemetry_port)
        print(f"telemetry: listening on http://{server.host}:{server.port} "
              "(/metrics /healthz /requests /snapshot)")
    try:
        out = _run_continuous(args, cfg, model, trace=trace, reuse=reuse,
                              server=server)
    finally:
        if server is not None:
            server.close()
    if out is not None and server is not None:
        out["telemetry_port"] = server.port
    return out


def _run_continuous(args, cfg, model, trace=None, reuse=None, server=None):
    """Calibrate, compress, then serve ``trace`` (default: the launcher's
    synthetic trace) with the dense and the compressed model, speculatively
    with ``--draft-ratio``; with ``--calibrate-from-traffic`` the compressed
    model's engine recalibrates from its own traffic. Returns a dict with
    the compression ``reports``, the ``calibrator``,
    the ``draft`` (or None), the ``flight`` recorder (or None) and, per model
    name ("dense", "coala"), its ``models``, ``engines``, ``metrics`` and
    recalibration ``workers`` (None without one), plus the ``seconds`` of
    each phase. The last engine keeps its CUDA graphs (``release_graphs``
    frees them); the others release theirs before the next one captures.
    ``reuse``, an earlier result of the same arguments, supplies the
    calibrator and the compressed model, so that only the draft is
    compressed."""
    if args.requests <= 0:
        print("no requests to serve")
        return None
    ratio = args.compress_ratio if args.compress_ratio > 0 else 0.6
    if reuse is None:
        batches = calibration_batches(cfg, n_batches=2, batch=args.requests,
                                      seq_len=args.prompt_len, seed=args.seed,
                                      device=model.device)
        cmodel, dmodel, reports, dreports, cal, seconds = _compressed_params(
            model, batches, ratio, args.draft_ratio)
    else:
        cal, cmodel, reports = (reuse["calibrator"], reuse["models"]["coala"],
                                reuse["reports"])
        dmodel = dreports = None
        seconds = {}
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
    # one flight recorder accumulates lifecycle events across both engines
    flight = (FlightRecorder(capacity=args.flight_recorder)
              if args.flight_recorder > 0 else None)
    slo_ttft = args.slo_ttft_ms / 1e3 if args.slo_ttft_ms > 0 else None
    slo_tpot = args.slo_tpot_ms / 1e3 if args.slo_tpot_ms > 0 else None
    # warm for exactly the worst per-request cache need this trace can hit
    warm_len = max(len(p) + nn for _, p, nn in trace)
    out = {"reports": reports, "calibrator": cal,
           "draft": dmodel, "trace": trace, "seconds": seconds,
           "models": {"dense": model, "coala": cmodel}, "flight": flight,
           "engines": {}, "metrics": {}, "warmup": {}, "workers": {}}
    for name, m in out["models"].items():
        if out["engines"]:
            # free the last engine's graphs before this one captures its own
            out["engines"][next(reversed(out["engines"]))].release_graphs()
        # the dense and the compressed target serve with the same draft
        eng = ContinuousEngine(m, block_size=args.block_size,
                               num_blocks=args.num_blocks,
                               max_running=args.max_running,
                               bucket_sizes=_parse_buckets(args.bucket_sizes),
                               prefix_cache=prefix,
                               prefill_bucket_sizes=_parse_buckets(
                                   args.prefill_bucket_sizes),
                               draft_model=dmodel, spec_k=args.spec_k,
                               slo_ttft_s=slo_ttft, slo_tpot_s=slo_tpot,
                               flight_recorder=flight,
                               async_detok=args.detok_async == "on")
        if server is not None:
            server.attach(eng)
        worker = None
        if args.calibrate_from_traffic and name == "coala":
            # stream this engine's own traffic through the dense model into
            # calibration and swap refreshed factors in once the bound
            # clears; the dense engine serves unmodified, as the reference
            policy = RecalibPolicy(
                sample_rate=args.recalib_sample_rate,
                min_token_factor=args.recalib_min_token_factor,
                max_residual_excess=args.recalib_max_residual_excess,
                check_every=args.recalib_check_every)
            tcal = TrafficCalibrator(model, ctx=ParallelCtx(use_pallas=True),
                                     policy=policy, seed=args.seed)
            worker = RecalibWorker(
                model, tcal, _ccfg(ratio),
                rank_map=rank_map_from_reports(reports),
                draft_ratio=args.draft_ratio,
                draft_rank_map=rank_map_from_reports(dreports)
                if dreports else None,
                async_solve=args.recalib_async == "on")
            eng.attach_recalibrator(worker)
        out["workers"][name] = worker
        if args.warmup == "on":
            w = out["warmup"][name] = eng.warmup(max_len=warm_len)
            print(f"[{name}] warmup: {w['warmup_seconds']:.2f}s for "
                  f"{int(w['decode_signatures'])} decode + "
                  f"{int(w['prefill_signatures'])} prefill signatures "
                  f"(max_len {int(w['max_len'])})")
        if args.offline:
            reqs = [dict(prompt_tokens=prompt, max_new_tokens=nn,
                         temperature=args.temperature)
                    for _, prompt, nn in trace]
            met, seconds[f"serve_{name}"] = _seconds(
                m.device, lambda: (eng.run_offline(reqs), eng.metrics())[1])
        else:
            met, seconds[f"serve_{name}"] = _seconds(
                m.device, lambda: serve_trace(eng, trace,
                                              temperature=args.temperature))
        if worker is not None and not worker.join(timeout=3600):
            raise RuntimeError("recalibration: the async solve did not end")
        out["engines"][name], out["metrics"][name] = eng, met
        print(f"[{name}] per-request TTFT (s):")
        for r in sorted(eng.finished, key=lambda r: r.req_id):
            print(f"  req {r.req_id:3d}: prompt={len(r.prompt):3d} "
                  f"new={len(r.out_tokens):3d} ttft={r.ttft:.3f}s"
                  + (f" (preempted x{r.preemptions})" if r.preemptions else ""))
        path = "cuda graphs" if eng.cuda_graphs else "eager"
        mode = "offline" if args.offline else "online"
        print(f"[{name}] aggregate (paged, {m.device.type}, {path}, {mode}): "
              f"{met['requests']} requests in {seconds[f'serve_{name}']:.2f}s, "
              f"{met['requests_per_sec']:.2f} req/s, "
              f"{met['tokens_per_sec']:.1f} new tok/s "
              f"({met['decode_tok_per_s']:.1f} decode tok/s steady-state), "
              f"mean TTFT {met['mean_ttft_s']:.3f}s, "
              f"{met['decode_compiles']} decode captures over "
              f"{met['decode_steps']} steps ({met['decode_shapes']} shape "
              f"buckets), {met['preemptions']} preemptions"
              + (f"; {met['post_warmup_compiles']} post-warmup compiles"
                 if args.warmup == "on" else ""))
        if slo_ttft is not None or slo_tpot is not None:
            print(f"[{name}] SLO goodput {met['slo_goodput']:.2f} "
                  f"(ttft <= {slo_ttft if slo_ttft is not None else '-'}s, "
                  f"tpot <= {slo_tpot if slo_tpot is not None else '-'}s)")
        if dmodel is not None:
            print(f"[{name}] speculative (draft ratio {args.draft_ratio}, "
                  f"k={int(met['spec_k'])}): {met['spec_rounds']} rounds, "
                  f"accept rate {met['spec_accept_rate']:.2f} "
                  f"({met['spec_accepted_tokens']}/"
                  f"{met['spec_proposed_tokens']} draft tokens)")
        if worker is not None:
            sm = worker.summary()
            print(f"[{name}] recalibration: {sm['swaps']} hot-swaps over "
                  f"{sm['solve_attempts']} solve attempts, "
                  f"{sm['sampled_requests']} sampled requests / "
                  f"{sm['captured_tokens']} captured tokens, "
                  f"data clearance {sm['clearance']:.2f}, "
                  f"residual excess {sm['residual_excess']:.2f}, "
                  f"status {sm['status']}; "
                  f"{met['post_warmup_compiles']} post-warmup compiles")
        print(f"[{name}] prefill: {met['prefill_tok_per_s']:.1f} suffix "
              f"tok/s steady-state, {met['prefill_compiles']} captures / "
              f"{met['prefill_batches']} batched calls "
              f"({met['prefill_shapes']} length buckets); prefix cache "
              f"{'on' if eng.prefix_cache else 'off'}: "
              f"hit rate {met['prefix_hit_rate']:.2f} "
              f"({met['prefix_hit_tokens']} tokens), "
              f"{met['cached_blocks']} cached blocks, "
              f"{met['cow_copies']} COW copies, "
              f"{met['prefix_evictions']} evictions")
    return out


def run_fixed(args, cfg, model):
    """Fixed-batch serving (``repro/launch/serve.py:243-254``): COALA-
    compress first with ``--compress-ratio`` > 0, then generate
    ``--new-tokens`` from the pipeline's first batch (``--requests`` rows of
    ``--prompt-len`` tokens, its vision prefix as extras for a vlm) through
    ``ServeEngine`` in fp32. Returns the ``tokens`` (B, T0 + new), the
    ``batch``, the served ``model``, the ``engine`` and the ``seconds``."""
    seconds = {}
    if args.compress_ratio > 0:
        batches = calibration_batches(cfg, n_batches=2, batch=args.requests,
                                      seq_len=args.prompt_len, seed=args.seed,
                                      device=model.device)
        model, _, _, _, _, secs = _compressed_params(model, batches,
                                                     args.compress_ratio)
        seconds.update(secs)
    eng = ServeEngine(model)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.prompt_len,
                                    global_batch=args.requests), cfg,
                         device=model.device)
    batch = pipe.get_batch(0)
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    out, seconds["serve_fixed"] = _seconds(model.device, lambda: eng.generate(
        batch["tokens"], max_new_tokens=args.new_tokens, extras=extras or None,
        temperature=args.temperature))
    print(f"served {args.requests} requests x {args.new_tokens} tokens "
          f"({seconds['serve_fixed']:.2f}s)")
    print(out[:, -args.new_tokens:])
    return {"tokens": out, "batch": batch, "model": model, "engine": eng,
            "seconds": seconds}


def main(argv=None, trace=None, reuse=None, cfg=None):
    """Command-line entry point; ``trace`` replaces the synthetic trace,
    ``reuse`` an earlier result supplies the models, the calibrator and the
    compressed model (see ``run_continuous``, whose result it returns;
    without ``--continuous``, ``run_fixed``'s), and ``cfg`` a ModelConfig
    replaces the one ``--arch``/``--smoke`` name (a full-width configuration
    cut in depth, say)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over the paged KV cache")
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
    ap.add_argument("--offline", action="store_true",
                    help="serve the trace through the offline batch lane "
                         "(run_offline: length-sorted admission, packed "
                         "bucketed prefills) instead of staggered arrivals")
    ap.add_argument("--detok-async", choices=("on", "off"), default="on",
                    help="run detokenize + stream callbacks on the "
                         "background worker thread (off: inline on the "
                         "dispatch thread, the ordering oracle)")
    ap.add_argument("--calibrate-from-traffic", action="store_true",
                    help="stream a sampled fraction of served activations "
                         "into COALA calibration and hot-swap recompressed "
                         "factors into the live engine (no drain, no "
                         "capture) once the error bound clears; applies to "
                         "the coala engine, and to the draft too when "
                         "--draft-ratio is set")
    ap.add_argument("--recalib-sample-rate", type=float, default=1.0,
                    help="fraction of requests whose token streams feed "
                         "traffic calibration (sticky per request)")
    ap.add_argument("--recalib-min-token-factor", type=float, default=0.25,
                    help="data gate: recompress only once every target "
                         "layer has streamed at least this factor times "
                         "its feature count in calibration tokens")
    ap.add_argument("--recalib-max-residual-excess", type=float, default=2.0,
                    help="bound gate: ship recompressed factors only if "
                         "every layer's achieved residual is within this "
                         "factor of the attainable error bound")
    ap.add_argument("--recalib-check-every", type=int, default=2,
                    help="poll the recalibration gates every N engine steps")
    ap.add_argument("--recalib-async", choices=("on", "off"), default="off",
                    help="solve on a background thread (its own CUDA stream "
                         "on the GPU) that stages the swap for the next "
                         "step boundary (off: inline between steps)")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome/Perfetto trace_event JSON of the "
                         "serving spans to this path")
    ap.add_argument("--metrics-out", default="",
                    help="write the last engine's metrics registry in "
                         "Prometheus text exposition format to this path")
    ap.add_argument("--trace-max-events", type=int, default=0,
                    help="cap the tracer's in-memory events as a ring of "
                         "the most recent N (0 = unbounded)")
    ap.add_argument("--telemetry-port", type=int, default=-1,
                    help="serve live telemetry HTTP endpoints (/metrics, "
                         "/healthz, /requests, /snapshot) from the running "
                         "continuous engines on this port (0 picks an "
                         "ephemeral port; -1 = off)")
    ap.add_argument("--flight-recorder", type=int, default=0,
                    help="record per-request lifecycle events into a ring "
                         "of this capacity and dump a postmortem bundle "
                         "(POSTMORTEM_serve.json) on engine failure paths "
                         "(0 = off)")
    ap.add_argument("--slo-ttft-ms", type=float, default=0.0,
                    help="time-to-first-token SLO in milliseconds; feeds "
                         "the serve_slo_goodput gauge (0 = unset)")
    ap.add_argument("--slo-tpot-ms", type=float, default=0.0,
                    help="per-output-token latency SLO in milliseconds; "
                         "feeds the serve_slo_goodput gauge (0 = unset)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.trace_out:
        obs_trace.enable(max_events=args.trace_max_events or None)
    if cfg is None:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if reuse is not None:
        model, init_s = reuse["models"]["dense"], 0.0
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        model, init_s = _seconds(
            device, lambda: build_model(cfg, device=device).init(gen))
    if args.continuous:
        out = run_continuous(args, cfg, model, trace=trace, reuse=reuse)
    else:
        out = run_fixed(args, cfg, model)
    if out is not None:
        out["seconds"]["init"] = init_s
    if args.trace_out:
        n = obs_trace.save(args.trace_out)
        obs_trace.disable()
        print(f"wrote {n} trace events to {args.trace_out}")
    if args.metrics_out and not args.continuous:
        print("--metrics-out needs --continuous (registry lives on the "
              "continuous engine); skipped")
    elif args.metrics_out and out is not None:
        with open(args.metrics_out, "w") as f:
            f.write(out["engines"]["coala"].registry.prometheus())
        print(f"wrote metrics exposition to {args.metrics_out}")
    return out


if __name__ == "__main__":
    main()
