"""Continuous-batching serving engine over the paged KV pool (port of
``repro/serve/engine.py:118-131``, ``:209-643``, ``:765-1118`` and
``:1223-1444``).

``submit()`` enqueues a request; each ``step()`` admits whatever fits
(scheduler + block pool), looks up each joiner's longest cached block-aligned
prefix in the pool's prefix registry (``prefix_cache``, on by default: the
port serves only pure-attention GQA LMs) and prefills only the suffix —
suffixes in the same length bucket go together through one
``LM.prefill_chunk`` call over the pool's page stores (the chunked-prefill
kernel on the GPU) — and then runs ONE decode step over the whole running
set at per-request positions (``LM.decode_step``, the paged-attention kernel
on the GPU). The batch is padded to the next of ``bucket_sizes`` and the
block envelope to a power of two, exactly as the JAX engine pads them:
padding rows carry position 0, length 1 and all-trash block tables. When the
pool runs dry during decode the youngest request is preempted and later
re-prefilled. Each row samples with its own temperature (greedy at 0) from
a generator seeded by (request seed, output index), so a preempted request
resumes on the same trajectory; a request stops at ``max_new_tokens`` or
``eos_id``. ``fork()`` clones a running request copy-on-write (best-of-n).

CUDA graphs take the place of the JAX engine's jit cache. Every step runs
one of a closed set of signatures — decode ``(b_pad, nb_pad)``, prefill
``(b_pad, l_pad, nb_pad)`` — and a CUDA engine captures one
``torch.cuda.CUDAGraph`` per signature, at first use or ahead of traffic
with ``warmup(max_len)`` (the set ``warmup_signatures`` enumerates, captured
against the trash page). Each graph has static int32 inputs (tokens,
positions, lengths, block tables, packed in one buffer that a step fills
with one host-to-device copy) and a static logits output; all of an
engine's graphs share one memory pool, so a step consumes its logits
(sampling, then ``.cpu()``) before the next replay. Sampling, the pool's
page zeroing and copy-on-write copies stay outside the graphs. A capture
counts as a compile: ``post_warmup_compiles`` counts captures after
``warmup``, and steps that capture are left out of the steady-state timers.
A CPU engine runs eagerly; ``cuda_graphs=False`` runs a CUDA engine eagerly
too, as the oracle the graphs are checked against. Nothing falls back: a
failed capture or replay raises.

Serving dtypes: ``compute_dtype`` is the activations' dtype and
``cache_dtype`` the KV pool's (``None``: the model's dtype for both; the
JAX engine defaults both to bf16). The engine serves a copy of the model
whose projection weights and embedding are cast to ``compute_dtype`` once
(``compute_copy``), where the JAX engine casts them on every call.

Self-speculative decoding (``draft_model``, ``spec_k``): a harder-compressed
draft of the served model keeps its own pool of the same geometry in
lockstep with the target's (the same allocs, commits, forks, frees and
rollbacks) and proposes ``spec_k`` tokens a round; the target verifies all
``spec_k + 1`` positions in one ``LM.verify_chunk`` over its pool, greedy
rows keep the longest prefix matching the verifier's argmax and sampled rows
go through rejection sampling; both pools then roll back to the accepted
length (``truncate``). A round is one signature ``("spec", b_pad, nb_pad)``
whose graph holds the draft's ``spec_k + 1`` decode steps (each choosing the
next proposal on the device), the verify and its argmax: one replay and one
copy to the host per round.

Waiting for later slices: recalibration (``hot_swap``), async detokenize,
SLOs and telemetry, the fixed-batch engine.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import lowrank_linear as _ll
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as _pa
from repro_torch.models.linear import Linear
from repro_torch.serve.paged_cache import BlockPool
from repro_torch.serve.scheduler import Request, Scheduler


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def bucket_batch(n: int, sizes: Sequence[int]) -> int:
    """Smallest batch bucket holding ``n`` rows (``n`` past the largest)."""
    return next((b for b in sizes if b >= n), n)


def bucket_prefill(n: int, sizes: Sequence[int] = ()) -> int:
    """Suffix-length bucket: explicit sizes if given, else powers of two
    with a floor of 8."""
    for b in sizes:
        if b >= n:
            return b
    return max(_pow2_at_least(n), 8)


def default_bucket_sizes(max_running: int) -> tuple:
    """Power-of-two batch buckets covering [1, max_running]."""
    sizes = []
    b = 1
    while b < max_running:
        sizes.append(b)
        b *= 2
    return tuple(sizes) + (max_running,)


# key-derivation fold tags decorrelating the speculative streams from the
# per-(seed, output index) decode streams and from each other (the JAX
# engine's tags)
_DRAFT_FOLD = 0x0D1A           # draft proposal sampling
_ACCEPT_FOLD = 0xACC           # host-side accept/residual draws
_BONUS_FOLD = 0xB0E5           # host-side bonus draw after a full accept


def _softmax_np(x: np.ndarray) -> np.ndarray:
    x = x - np.max(x)
    e = np.exp(x)
    return e / e.sum()


def row_seed(seed: int, *keys: int) -> int:
    """The 64-bit generator seed of a request seeded ``seed`` at ``keys``:
    an output index (the counterpart of ``fold_in(PRNGKey(seed), index)``),
    or a fold tag and an output index."""
    state = np.random.SeedSequence([seed % (1 << 64), *keys])
    return int(state.generate_state(1, np.uint64)[0])


def sample_rows(logits: torch.Tensor, temps, seeds, indices) -> torch.Tensor:
    """Row-wise sampling on the logits' device: the argmax where the
    temperature is <= 0, else a draw from softmax(logits / temperature) by
    the exponential race (argmax of p / E, E ~ Exp(1)) with a generator
    seeded from (seed, output index). Returns (B,) int64."""
    nxt = torch.argmax(logits, dim=-1)
    for i, (temp, seed, idx) in enumerate(zip(temps, seeds, indices)):
        if temp <= 0.0:
            continue
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(row_seed(seed, idx))
        p = torch.softmax(logits[i].float() / temp, dim=-1)
        race = torch.empty_like(p).exponential_(generator=gen)
        nxt[i] = torch.argmax(p / race)
    return nxt


def compute_copy(model, dtype):
    """``model`` with the weights its forward casts on every call — each
    projection's ``w`` or ``b_t``/``a_t`` and the embedding (also the tied
    LM head) — stored in ``dtype`` once: the same rounding the per-call cast
    applies, so the outputs do not change. Norm scales stay as they are (the
    norms compute in fp32 from them). ``model`` itself when it is already in
    ``dtype``."""
    if dtype == model.dtype:
        return model
    cast = [model.embed] + [p for mod in model.modules()
                            if isinstance(mod, Linear)
                            for p in mod._parameters.values()]
    memo = {id(p): torch.nn.Parameter(p.detach().to(dtype), requires_grad=False)
            for p in cast}
    return copy.deepcopy(model, memo)


def _layout(sig) -> Tuple[Tuple[str, tuple], ...]:
    """Named int32 inputs of a step signature, in packed order (a spec
    round's temperatures travel as their fp32 bits)."""
    if sig[0] == "decode":
        _, b, nb = sig
        return (("tok", (b, 1)), ("pos", (b,)), ("tables", (b, nb)))
    if sig[0] == "spec":
        _, b, nb = sig
        return (("tok", (b, 1)), ("pos", (b,)), ("temps", (b,)),
                ("tables", (b, nb)), ("dtables", (b, nb)))
    _, b, l, nb = sig
    return (("tok", (b, l)), ("pos", (b,)), ("lens", (b,)),
            ("tables", (b, nb)))


def _seg(shape) -> int:
    """Packed length of one input: 16-byte aligned segments."""
    return -(-math.prod(shape) // 4) * 4


def _pack(sig, **arrays) -> np.ndarray:
    """One flat int32 host array holding a step's inputs."""
    parts = []
    for name, shape in _layout(sig):
        a = np.zeros(_seg(shape), np.int32)
        a[:math.prod(shape)] = np.asarray(arrays[name], np.int32).reshape(-1)
        parts.append(a)
    return np.concatenate(parts)


def _views(sig, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The step's inputs as contiguous views of the packed buffer."""
    out, off = {}, 0
    for name, shape in _layout(sig):
        out[name] = buf[off:off + math.prod(shape)].view(shape)
        off += _seg(shape)
    return out


def _trash_inputs(sig) -> np.ndarray:
    """All-padding inputs: token 0, position 0, length 1, all-trash tables."""
    shapes = dict(_layout(sig))
    return _pack(sig, **{n: (np.ones if n == "lens" else np.zeros)(s)
                         for n, s in shapes.items()})


@dataclasses.dataclass
class StepGraph:
    """One captured step signature."""
    graph: "torch.cuda.CUDAGraph"
    ints: torch.Tensor            # static packed int32 inputs
    out: object                   # static output(s), in the engine's graph pool
    launches: Dict[str, int]      # kernel launches per replay


class ContinuousEngine:
    """Request-level serving: ``submit()`` / ``step()`` / ``run()``."""

    def __init__(self, model, *, compute_dtype=None, cache_dtype=None,
                 block_size: int = 16, num_blocks: int = 512,
                 max_running: int = 8,
                 bucket_sizes: Optional[Sequence[int]] = None,
                 prefix_cache: Optional[bool] = None,
                 prefill_bucket_sizes: Optional[Sequence[int]] = None,
                 cuda_graphs: Optional[bool] = None,
                 draft_model=None, spec_k: int = 4):
        """``compute_dtype``/``cache_dtype``: activations and KV pool (None:
        the model's dtype; the JAX engine's defaults are bf16 for both).
        ``draft_model``: an ``LM`` of the target's config, served as the
        speculative draft proposing ``spec_k`` tokens a round."""
        self.model = model
        self.device = model.device
        self.compute_dtype = compute_dtype or model.dtype
        self.cache_dtype = cache_dtype or model.dtype
        self._target = compute_copy(model, self.compute_dtype)
        self._spec = draft_model is not None
        self.spec_k = int(spec_k)
        if self._spec:
            if self.spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            if draft_model.cfg != model.cfg or draft_model.device != self.device:
                raise ValueError("the draft must be an LM of the target's "
                                 "config on the target's device")
            self._draft = compute_copy(draft_model, self.compute_dtype)
        self.block_size = block_size
        # every model the port serves is a pure-attention GQA LM, so the
        # chunked suffix prefill a cached prefix needs is always there
        self.prefix_cache = True if prefix_cache is None else prefix_cache
        is_cuda = self.device.type == "cuda"
        self.cuda_graphs = is_cuda if cuda_graphs is None else cuda_graphs
        if self.cuda_graphs and not is_cuda:
            raise ValueError("cuda_graphs needs a model on a CUDA device")
        pool_kw = dict(num_blocks=num_blocks, block_size=block_size,
                       max_requests=max_running, dtype=self.cache_dtype,
                       prefix_cache=self.prefix_cache)
        self.pool = BlockPool(model, **pool_kw)
        self.scheduler = Scheduler(self.pool, max_running=max_running,
                                   headroom_tokens=self.spec_k
                                   if self._spec else 0)
        # the draft decodes against its own pool, kept in lockstep with the
        # target's, so cached-prefix hits and table shapes mirror exactly
        self.draft_pool = (BlockPool(draft_model, **pool_kw) if self._spec
                           else None)
        buckets = set(bucket_sizes or default_bucket_sizes(max_running))
        buckets.add(max_running)        # largest bucket must cover the batch
        self.bucket_sizes = tuple(sorted(buckets))
        self.prefill_bucket_sizes = (tuple(sorted(prefill_bucket_sizes))
                                     if prefill_bucket_sizes else ())
        self.finished: List[Request] = []
        self._next_id = 0
        self._start_time: Optional[float] = None
        self.counters = {"decode_steps": 0, "decode_tokens": 0,
                         "decode_seconds": 0.0, "prefill_batches": 0,
                         "prefill_tokens": 0, "prefill_seconds": 0.0,
                         "prompt_tokens": 0, "prefix_hit_tokens": 0}
        if self._spec:
            self.counters.update(spec_rounds=0, spec_proposed=0,
                                 spec_accepted=0)
            # Exp(1) noise of the draft's sampled proposals, drawn on the
            # host's side before a round (a capture cannot hold per-row
            # generators); greedy rows never read it
            self._noise = torch.ones(
                (self.bucket_sizes[-1], self.spec_k + 1, model.cfg.vocab_size),
                dtype=torch.float32, device=self.device)
            self._noise_gen = torch.Generator(device=self.device)
        # captured graphs by signature, their shared pool and capture stream
        self._graphs: Dict[tuple, StepGraph] = {}
        self._graph_pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        self._captures = {"decode": 0, "prefill": 0, "spec": 0, "dprefill": 0}
        self._warmed = 0
        self._warmup_seconds = 0.0

    # ------------------------------------------------------------------ API
    def submit(self, prompt_tokens, max_new_tokens: int, *,
               temperature: float = 0.0, seed: int = 0,
               eos_id: Optional[int] = None) -> int:
        """Enqueue one request; returns its id. ``temperature`` <= 0 is
        greedy; ``seed`` keys the request's samples; generation stops after
        ``max_new_tokens`` or at ``eos_id``."""
        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
        req = Request(req_id=self._next_id, prompt=prompt,
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      seed=seed, eos_id=eos_id, cacheable=True)
        # a verify round transiently writes up to spec_k positions past the
        # budget before rollback: the headroom admission reserves
        need = self.pool.blocks_for(req.cache_budget()
                                    + (self.spec_k if self._spec else 0))
        if need > self.pool.usable_blocks:
            raise ValueError(
                f"request needs {need} blocks ({req.cache_budget()} cache "
                f"positions) but the pool only has {self.pool.usable_blocks} "
                f"({self.pool.num_blocks} x {self.block_size}-token blocks, "
                "one reserved); raise --num-blocks/--block-size")
        self._next_id += 1
        if self._start_time is None:
            self._start_time = req.arrival_time
        self.scheduler.submit(req)
        return req.req_id

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def step(self) -> List[Request]:
        """Admit + prefill joiners (each looks up its cached prefix once, at
        allocation; same-length-bucket suffixes are batched into one call),
        then one decode step over the running batch; returns the requests
        that finished during this step."""
        done: List[Request] = []
        admitted = self.scheduler.admit()
        groups: Dict[int, list] = {}
        for req in admitted:
            toks = req.prefill_tokens()
            cached = self.pool.alloc(req.req_id, len(toks), tokens=toks)
            if self._spec and self.draft_pool.alloc(
                    req.req_id, len(toks), tokens=toks) != cached:
                raise RuntimeError("the draft pool diverged from the target's")
            self.counters["prompt_tokens"] += len(toks)
            self.counters["prefix_hit_tokens"] += cached
            groups.setdefault(self._bucket_prefill(len(toks) - cached),
                              []).append((req, toks, cached))
        for _, group in sorted(groups.items()):
            self._prefill_batch(group)
        for req in admitted:
            if req.done:
                self._finish(req)
                done.append(req)
        running = list(self.scheduler.running)
        if running:
            done.extend(self._spec_decode_step(running) if self._spec
                        else self._decode_step(running))
        return done

    def run(self) -> List[Request]:
        out: List[Request] = []
        while self.has_work():
            out.extend(self.step())
        return out

    def fork(self, req_id: int, *, temperature: Optional[float] = None,
             seed: Optional[int] = None) -> int:
        """Clone a running request mid-generation (best-of-n sampling): the
        child shares the parent's cache blocks copy-on-write — the first
        divergent token write into the shared tail block copies just that
        block. Returns the child's request id."""
        parent = next((r for r in self.scheduler.running
                       if r.req_id == req_id), None)
        if parent is None:
            raise ValueError(f"request {req_id} is not running")
        if len(self.scheduler.running) >= self.scheduler.max_running:
            raise ValueError("running set full; cannot fork")
        if seed is None:
            # a distinct, deterministic child seed: the parent's would
            # replay its exact trajectory at temperature > 0
            seed = parent.seed ^ ((0x9E3779B9 * (self._next_id + 1))
                                  & 0x7FFFFFFF)
        child = Request(
            req_id=self._next_id, prompt=parent.prompt.copy(),
            max_new_tokens=parent.max_new_tokens,
            temperature=parent.temperature if temperature is None
            else temperature,
            seed=seed, eos_id=parent.eos_id, cacheable=parent.cacheable)
        self._next_id += 1
        child.out_tokens = list(parent.out_tokens)
        child.cache_len = parent.cache_len
        # the child continues the parent's lifecycle: its TTFT is the parent's
        child.arrival_time = parent.arrival_time
        child.first_token_time = parent.first_token_time
        self.pool.fork(parent.req_id, child.req_id)
        if self._spec:
            self.draft_pool.fork(parent.req_id, child.req_id)
        self.scheduler.adopt(child)
        return child.req_id

    # -------------------------------------------------------------- warm start
    def warmup_signatures(self, max_len: int):
        """Every step signature a trace whose per-request cache need stays
        within ``max_len`` positions can hit (``repro/serve/engine.py:765``).

        Decode ``(b_pad, nb_pad)``: every batch bucket crossed with every
        power-of-two block envelope up to the largest a ``max_len``-position
        table can produce (capped by the pool). Prefill ``(b_pad, l_pad,
        nb_pad)``: for each suffix-length bucket, the shortest suffix that
        maps to it bounds how high a block-aligned cached-prefix offset can
        sit underneath it, and each reachable offset yields one block
        envelope; without the prefix cache the offset is always 0. Returns
        ``(decode_sigs, prefill_sigs)``. In speculative mode the decode sigs
        are the spec rounds', whose block envelope covers the ``spec_k``
        positions a verify round writes past the budget; every prefill sig
        runs for the draft too."""
        span = max_len + (self.spec_k if self._spec else 0)
        nb_cap = _pow2_at_least(min(self.pool.blocks_for(span),
                                    self.pool.usable_blocks))
        decode = []
        for b in self.bucket_sizes:
            nb = 1
            while nb <= nb_cap:
                decode.append((b, nb))
                nb *= 2
        prefill = []
        l_buckets = sorted({self._bucket_prefill(n)
                            for n in range(1, max_len + 1)})
        prev = 0
        for l_pad in l_buckets:
            len_min = prev + 1              # shortest suffix in this bucket
            prev = l_pad
            if self.prefix_cache:
                start_max = ((max_len - len_min) // self.block_size
                             ) * self.block_size
                starts = range(0, start_max + 1, self.block_size)
            else:
                starts = (0,)
            nbs = sorted({_pow2_at_least(self.pool.blocks_for(s + l_pad))
                          for s in starts})
            for b in self.bucket_sizes:
                for nb in nbs:
                    prefill.append((b, l_pad, nb))
        return decode, prefill

    def warmup(self, *, max_len: Optional[int] = None) -> Dict[str, float]:
        """Capture every signature of ``warmup_signatures(max_len)`` against
        the trash page, so no admissible request waits on a capture.
        ``max_len`` bounds the worst-case per-request cache positions
        (prompt + generated); it defaults to, and is capped at, the pool's
        capacity. Re-running only captures what is missing. An eager engine
        has nothing to capture. Returns a summary; the wall time adds up in
        ``metrics()["warmup_seconds"]``."""
        cap = self.pool.usable_blocks * self.block_size
        max_len = cap if max_len is None else min(max_len, cap)
        t0 = time.perf_counter()
        decode_sigs, prefill_sigs = self.warmup_signatures(max_len)
        if self.cuda_graphs:
            for b, nb in decode_sigs:
                if self._spec and nb * self.block_size < self.spec_k + 1:
                    # a round writes spec_k + 1 positions, so no real table
                    # is this small (and the trash writes would overrun it)
                    continue
                self._graph(("spec" if self._spec else "decode", b, nb))
            for b, l, nb in prefill_sigs:
                self._graph(("prefill", b, l, nb))
                if self._spec:
                    self._graph(("dprefill", b, l, nb))
            torch.cuda.synchronize(self.device)
        self._warmed = sum(self._captures.values())
        dt = time.perf_counter() - t0
        self._warmup_seconds += dt
        return {"warmup_seconds": dt, "max_len": float(max_len),
                "decode_signatures": float(len(decode_sigs)),
                "prefill_signatures": float(len(prefill_sigs))}

    def post_warmup_compiles(self) -> int:
        """Graph captures beyond what ``warmup()`` covered: 0 after warmup
        under admissible traffic (before any warmup it counts them all)."""
        return sum(self._captures.values()) - self._warmed

    def release_graphs(self) -> None:
        """Drop the captured graphs, their memory pool and the capture
        stream's scratch; later steps capture again as needed."""
        self._graphs.clear()
        self._graph_pool = None
        if self._stream is not None:
            _ll.release_scratch(self.device, self._stream.cuda_stream)
            self._stream = None

    # -------------------------------------------------------------- metrics
    def reset_metrics(self) -> None:
        """Zero everything request-level — finished requests, timers,
        preemptions, hit-rate and pool counters — keeping the graphs and the
        prefix registry warm."""
        self.finished = []
        self._start_time = None
        for k, v in self.counters.items():
            self.counters[k] = type(v)(0)
        self.scheduler.preemptions = 0
        for k in self.pool.stats:
            self.pool.stats[k] = 0

    def metrics(self) -> Dict[str, float]:
        """Aggregate serving metrics over finished requests (the JAX keys
        of what is ported). The steady-state rates leave out steps that
        captured a graph."""
        c, caps = self.counters, self._captures
        m = {
            "decode_compiles": caps["decode"] + caps["spec"],
            "decode_steps": c["decode_steps"],
            "decode_tok_per_s": (c["decode_tokens"] / c["decode_seconds"]
                                 if c["decode_seconds"] > 0 else 0.0),
            "prefill_compiles": caps["prefill"] + caps["dprefill"],
            "prefill_batches": c["prefill_batches"],
            "prefill_tok_per_s": (c["prefill_tokens"] / c["prefill_seconds"]
                                  if c["prefill_seconds"] > 0 else 0.0),
            "decode_seconds": c["decode_seconds"],
            "prefill_seconds": c["prefill_seconds"],
            "prefix_hit_rate": (c["prefix_hit_tokens"]
                                / max(c["prompt_tokens"], 1)),
            "prefix_hit_tokens": c["prefix_hit_tokens"],
            "cached_blocks": self.pool.cached_blocks,
            "cow_copies": self.pool.stats["cow_copies"],
            "prefix_evictions": self.pool.stats["evictions"],
            "preemptions": self.scheduler.preemptions,
            "warmup_seconds": self._warmup_seconds,
            "post_warmup_compiles": self.post_warmup_compiles(),
        }
        if self._spec:
            proposed = c["spec_proposed"]
            m.update({
                "spec_k": float(self.spec_k),
                "spec_rounds": c["spec_rounds"],
                "spec_proposed_tokens": proposed,
                "spec_accepted_tokens": c["spec_accepted"],
                "spec_accept_rate": (c["spec_accepted"] / proposed
                                     if proposed > 0 else 0.0),
            })
        fin = self.finished
        if not fin:
            return {"requests": 0, "requests_per_sec": 0.0, "new_tokens": 0,
                    "tokens_per_sec": 0.0, "mean_ttft_s": None,
                    "max_ttft_s": None, **m}
        ttfts = [r.ttft for r in fin if r.ttft is not None]
        new_tokens = sum(len(r.out_tokens) for r in fin)
        elapsed = max(max(r.finish_time for r in fin) - self._start_time, 1e-9)
        return {"requests": len(fin), "requests_per_sec": len(fin) / elapsed,
                "new_tokens": new_tokens, "tokens_per_sec": new_tokens / elapsed,
                "mean_ttft_s": float(np.mean(ttfts)) if ttfts else None,
                "max_ttft_s": float(np.max(ttfts)) if ttfts else None, **m}

    # ------------------------------------------------------------ internals
    def _finish(self, req: Request) -> None:
        self.scheduler.evict(req)
        if self._spec:
            self.draft_pool.free(req.req_id)
        self.finished.append(req)

    def _bucket_batch(self, n: int) -> int:
        return bucket_batch(n, self.bucket_sizes)

    def _bucket_prefill(self, n: int) -> int:
        return bucket_prefill(n, self.prefill_bucket_sizes)

    def _sample_tokens(self, logits, reqs) -> np.ndarray:
        """Row-wise sampling of the real rows (bucket padding rows past
        ``len(reqs)`` are dropped), keyed by each request's seed and output
        index; the one device-to-host copy of the step."""
        rows = logits[:len(reqs)]
        if all(r.temperature <= 0.0 for r in reqs):
            nxt = torch.argmax(rows, dim=-1)
        else:
            nxt = sample_rows(rows, [r.temperature for r in reqs],
                              [r.seed for r in reqs],
                              [len(r.out_tokens) for r in reqs])
        return nxt.cpu().numpy()

    def _forward(self, sig, inputs: Dict[str, torch.Tensor]):
        kind, cd = sig[0], self.compute_dtype
        if kind == "decode":
            return self._target.decode_step(
                inputs["tok"], self.pool.pages, inputs["pos"],
                inputs["tables"], compute_dtype=cd)
        if kind == "spec":
            return self._spec_round(inputs)
        model, pool = ((self._draft, self.draft_pool) if kind == "dprefill"
                       else (self._target, self.pool))
        return model.prefill_chunk(inputs["tok"], pool.pages, inputs["pos"],
                                   inputs["lens"], inputs["tables"],
                                   compute_dtype=cd)

    def _spec_round(self, x: Dict[str, torch.Tensor]):
        """One speculative round on the device (the JAX engine's draft
        ``lax.scan`` and ``_verify`` in one): ``spec_k + 1`` draft decode
        steps over the draft pool, each choosing the next proposal in place
        — the argmax, or for a row with a temperature T > 0 the exponential
        race argmax(softmax(logits / T) / E) on the pre-drawn noise E; the
        last step only writes the k-th proposal's K/V — then the target
        verifies ``[last, d_1 .. d_k]`` in one ``verify_chunk`` and takes
        its argmax. Returns (ints (B, 2k + 1): the proposals d_1 .. d_k, then
        the verifier's argmax at each of the k + 1 positions; the verifier's
        logits (B, k + 1, V); the draft's logits (k + 1, B, V))."""
        k, cd = self.spec_k, self.compute_dtype
        tok, pos = x["tok"], x["pos"]
        temps = x["temps"].view(torch.float32)
        hot = temps > 0.0
        t = torch.where(hot, temps, torch.ones_like(temps))[:, None]
        noise = self._noise[:tok.shape[0]]
        cur, props, dlogits = tok, [], []
        for i in range(k + 1):
            lg = self._draft.decode_step(cur, self.draft_pool.pages, pos + i,
                                         x["dtables"], compute_dtype=cd)
            race = torch.softmax(lg / t, dim=-1) / noise[:, i]
            nxt = torch.where(hot, torch.argmax(race, dim=-1),
                              torch.argmax(lg, dim=-1))
            props.append(nxt)
            dlogits.append(lg)
            cur = nxt[:, None].to(torch.int32)
        d = torch.stack(props[:k], dim=1).to(torch.int32)
        vlogits = self._target.verify_chunk(
            torch.cat([tok, d], dim=1), self.pool.pages, pos,
            torch.full_like(pos, k + 1), x["tables"], compute_dtype=cd)
        ints = torch.cat([d.long(), torch.argmax(vlogits, dim=-1)], dim=1)
        return ints, vlogits, torch.stack(dlogits)

    def _run(self, sig, host: np.ndarray):
        """Run one step signature on the packed host inputs: replay its
        graph (capturing it first if new) or run eagerly. Returns (the
        step's output, whether a graph was captured)."""
        if not self.cuda_graphs:
            buf = torch.as_tensor(host, device=self.device)
            return self._forward(sig, _views(sig, buf)), False
        fresh = sig not in self._graphs
        g = self._graph(sig)
        g.ints.copy_(torch.from_numpy(host))
        g.graph.replay()
        ops.add_replayed(g.launches)
        return g.out, fresh

    def _graph(self, sig) -> StepGraph:
        """The captured graph of ``sig``, captured now if missing: one eager
        pass on the capture stream against all-trash inputs (it loads the
        kernels and sets their plans up, writing only the trash page), then
        the capture into the engine's graph pool."""
        g = self._graphs.get(sig)
        if g is not None:
            return g
        dev = self.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._reserve_scratch()
        ints = torch.as_tensor(_trash_inputs(sig), device=dev)
        inputs = _views(sig, ints)
        s = self._stream
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            self._forward(sig, inputs)
        graph = torch.cuda.CUDAGraph()
        with ops.captured_launches() as launches:
            with torch.cuda.graph(graph, pool=self._graph_pool, stream=s):
                out = self._forward(sig, inputs)
        torch.cuda.current_stream(dev).wait_stream(s)
        g = StepGraph(graph, ints, out, launches)
        self._graphs[sig] = g
        self._captures[sig[0]] += 1
        return g

    def _reserve_scratch(self) -> None:
        """Size the capture stream's kernel scratch for the largest
        signature the pool admits, before the first capture (a captured
        graph holds the buffer's address, so it is never replaced)."""
        decode, prefill = self.warmup_signatures(
            self.pool.usable_blocks * self.block_size)
        steps = self.spec_k + 1 if self._spec else 1   # a verify's rows
        rows = ({b for b, _ in decode} | {b * steps for b, _ in decode}
                | {b * l for b, l, _ in prefill})
        models = (self._target, self._draft) if self._spec else (self._target,)
        shapes = {(lin.b_t.shape[0], lin.b_t.shape[1], lin.a_t.shape[1])
                  for m in models for lin in m.modules()
                  if isinstance(lin, Linear) and lin.is_factored}
        work = counters = 0
        for m in rows:
            for d_in, r, d_out in shapes:
                w, t, c = _ll.scratch_layout(m, d_in, r, d_out,
                                             self.compute_dtype)
                work, counters = max(work, w + t), max(counters, c)
        cfg = self.model.cfg
        for b, nb in decode:
            work = max(work, _pa.plan(b, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.head_dim, nb).workspace)
        _ll.reserve_scratch(self.device, self._stream.cuda_stream, work,
                            counters)

    def _prefill_batch(self, group) -> None:
        """One ``prefill_chunk`` over a same-bucket group of (request,
        tokens, cached-prefix-len) joiners, already allocated by ``step()``:
        each row prefills only the suffix its cached prefix does not cover,
        at its own cache offset, padded to the (batch, suffix-len, blocks)
        bucket. The rows' full blocks are then committed to the prefix
        registry. In speculative mode the draft prefills the same suffixes at
        the same offsets into its own pool (its logits unused: the first
        proposal chains off the target's sampled token)."""
        reqs = [r for r, _, _ in group]
        ids = [r.req_id for r in reqs]
        starts = [cached for _, _, cached in group]
        suffixes = [np.asarray(toks[cached:], np.int32)
                    for _, toks, cached in group]
        lens = [len(s) for s in suffixes]
        l_pad = self._bucket_prefill(max(lens))
        b_pad = self._bucket_batch(len(group))
        nb_pad = _pow2_at_least(max(self.pool.blocks_for(s + l_pad)
                                    for s in starts))
        sig = ("prefill", b_pad, l_pad, nb_pad)
        tok = np.zeros((b_pad, l_pad), np.int32)
        for i, s in enumerate(suffixes):
            tok[i, :len(s)] = s
        pad = b_pad - len(group)
        host = _pack(sig, tok=tok, pos=starts + [0] * pad,
                     lens=lens + [1] * pad,
                     tables=self.pool.padded_tables(ids, rows=b_pad,
                                                  blocks=nb_pad))
        t0 = time.perf_counter()
        logits, fresh = self._run(sig, host)
        nxt = self._sample_tokens(logits, reqs)
        if self._spec:
            dsig = ("dprefill",) + sig[1:]
            _, dfresh = self._run(dsig, _pack(
                dsig, tok=tok, pos=starts + [0] * pad, lens=lens + [1] * pad,
                tables=self.draft_pool.padded_tables(ids, rows=b_pad,
                                                     blocks=nb_pad)))
            fresh = fresh or dfresh
        if not fresh:                       # steady-state timer: skip captures
            self.counters["prefill_seconds"] += time.perf_counter() - t0
            self.counters["prefill_tokens"] += sum(lens)
        self.counters["prefill_batches"] += 1
        now = time.perf_counter()
        for r, start, ln_i, t in zip(reqs, starts, lens, nxt):
            r.cache_len = start + ln_i
            r.out_tokens.append(int(t))
            if r.first_token_time is None:
                r.first_token_time = now
            self.pool.commit(r.req_id, r.prefill_tokens()[:r.cache_len])
            if self._spec:
                self.draft_pool.commit(r.req_id,
                                       r.prefill_tokens()[:r.cache_len])

    def _decode_step(self, running: List[Request]) -> List[Request]:
        # reserve the next position for everyone (copy-on-write where a
        # fork shares it), preempting the youngest when the pool runs dry
        while True:
            try:
                for r in running:
                    self.pool.extend(r.req_id, r.cache_len + 1)
                break
            except MemoryError:
                victim = self.scheduler.preempt_youngest()
                running = [r for r in running if r is not victim]
                if not running:
                    raise MemoryError(
                        "block pool too small for a single request")
        ids = [r.req_id for r in running]
        b_real = len(ids)
        b_pad = self._bucket_batch(b_real)
        nb_pad = _pow2_at_least(self.pool.max_table_blocks(ids))
        sig = ("decode", b_pad, nb_pad)
        pad = b_pad - b_real
        host = _pack(sig, tok=[r.out_tokens[-1] for r in running] + [0] * pad,
                     pos=[r.cache_len for r in running] + [0] * pad,
                     tables=self.pool.padded_tables(ids, rows=b_pad,
                                                  blocks=nb_pad))
        t0 = time.perf_counter()
        logits, fresh = self._run(sig, host)
        nxt = self._sample_tokens(logits, running)
        if not fresh:                       # steady-state timer: skip captures
            self.counters["decode_seconds"] += time.perf_counter() - t0
            self.counters["decode_tokens"] += b_real
        self.counters["decode_steps"] += 1
        done = []
        for r, t in zip(running, nxt):
            r.cache_len += 1
            r.out_tokens.append(int(t))
            if (self.prefix_cache and r.cacheable
                    and r.cache_len % self.block_size == 0):
                # a generated block just filled: register it so identical
                # traffic (and this request, if preempted) can reuse it
                self.pool.commit(r.req_id, r.prefill_tokens()[:r.cache_len])
            if r.done:
                self._finish(r)
                done.append(r)
        return done

    def _spec_decode_step(self, running: List[Request]) -> List[Request]:
        """One speculative round over the running set (JAX
        ``_spec_decode_step``): the draft proposes ``spec_k`` tokens per
        request, the target verifies all ``spec_k + 1`` positions, accepted
        tokens (plus the target's bonus or resampled token) are emitted, and
        both pools roll back to the accepted length (``truncate``).

        A round starts at ``c = cache_len`` with the last emitted token
        ``t`` not yet written. The draft writes positions ``c .. c+k``
        (feeding ``t, d_1 .. d_k``), the verifier the same span with the
        same tokens, and its logits at ``c + i`` score the token after it.
        Appending ``m`` accepted tokens advances ``cache_len`` by ``m``;
        stale K/V past the accepted length sits at positions the next round
        rewrites before any causal mask reads them."""
        k = self.spec_k
        # reserve the verify span [c, c+k] in both pools, copy-on-write
        # securing every block it covers; preempt the youngest when dry
        while True:
            try:
                for r in running:
                    for pool in (self.pool, self.draft_pool):
                        pool.extend(r.req_id, r.cache_len + k + 1,
                                    write_start=r.cache_len)
                break
            except MemoryError:
                victim = self.scheduler.preempt_youngest()
                if victim is not None:
                    self.draft_pool.free(victim.req_id)
                running = [r for r in running if r is not victim]
                if not running:
                    raise MemoryError(
                        "block pool too small for a single request")
        ids = [r.req_id for r in running]
        b_real = len(ids)
        b_pad = self._bucket_batch(b_real)
        nb_pad = _pow2_at_least(self.pool.max_table_blocks(ids))
        sig = ("spec", b_pad, nb_pad)
        pad = b_pad - b_real
        temps = np.asarray([r.temperature for r in running] + [0.0] * pad,
                           np.float32)
        host = _pack(sig, tok=[r.out_tokens[-1] for r in running] + [0] * pad,
                     pos=[r.cache_len for r in running] + [0] * pad,
                     temps=temps.view(np.int32),
                     tables=self.pool.padded_tables(ids, rows=b_pad,
                                                    blocks=nb_pad),
                     dtables=self.draft_pool.padded_tables(ids, rows=b_pad,
                                                           blocks=nb_pad))
        hot = [i for i, r in enumerate(running) if r.temperature > 0.0]
        t0 = time.perf_counter()
        for i in hot:
            # the noise of output index n is the same whatever round it
            # falls in, so a preempted request resumes on its trajectory
            for step in range(k + 1):
                self._noise_gen.manual_seed(row_seed(
                    running[i].seed, _DRAFT_FOLD,
                    len(running[i].out_tokens) + step))
                self._noise[i, step].exponential_(generator=self._noise_gen)
        (ints, vlogits, dlogits), fresh = self._run(sig, host)
        ints = ints[:b_real].cpu().numpy()
        if hot:
            # full distributions cross to the host only for sampled rows
            rows = torch.as_tensor(hot, device=self.device)
            vlog = vlogits[rows].cpu().numpy()          # (n, k+1, V)
            dlog = dlogits[:, rows].cpu().numpy()       # (k+1, n, V)
        emitted = 0
        done: List[Request] = []
        for i, r in enumerate(running):
            d = [int(t) for t in ints[i, :k]]
            g = ints[i, k:]
            if r.temperature <= 0.0:
                n_acc = 0
                while n_acc < k and d[n_acc] == int(g[n_acc]):
                    n_acc += 1
                toks = d[:n_acc] + [int(g[n_acc])]
            else:
                j = hot.index(i)
                toks, n_acc = self._spec_accept_sampled(r, d, vlog[j],
                                                        dlog[:, j])
            r.spec_proposed += k
            r.spec_accepted += n_acc
            self.counters["spec_proposed"] += k
            self.counters["spec_accepted"] += n_acc
            keep: List[int] = []
            for t in toks:
                if len(r.out_tokens) + len(keep) >= r.max_new_tokens:
                    break
                keep.append(t)
                if r.eos_id is not None and t == r.eos_id:
                    break
            r.cache_len += len(keep)
            # rollback: both pools drop the uncommitted tail blocks the
            # rejected proposals wrote
            self.pool.truncate(r.req_id, r.cache_len)
            self.draft_pool.truncate(r.req_id, r.cache_len)
            r.out_tokens.extend(keep)
            emitted += len(keep)
            if self.prefix_cache and r.cacheable:
                committed = r.prefill_tokens()[:r.cache_len]
                self.pool.commit(r.req_id, committed)
                self.draft_pool.commit(r.req_id, committed)
            if r.done:
                self._finish(r)
                done.append(r)
        self.counters["decode_steps"] += 1
        self.counters["spec_rounds"] += 1
        if not fresh:                       # steady-state timer: skip captures
            self.counters["decode_seconds"] += time.perf_counter() - t0
            self.counters["decode_tokens"] += emitted
        return done

    def _spec_accept_sampled(self, r: Request, d: List[int],
                             vlog_row: np.ndarray, dlog_row: np.ndarray):
        """Speculative rejection sampling for one temperature > 0 row, the
        JAX engine's draw for draw: accept ``d_i`` w.p. ``min(1, p_i(d_i) /
        q_i(d_i))``; on the first rejection draw from the residual
        ``norm(max(p_i - q_i, 0))``; after a full accept draw the bonus
        token from ``p_{k+1}``. Draws are seeded per (request seed, fold
        tag, output index). ``vlog_row``/``dlog_row``: (k+1, V) target /
        draft logits. Returns (tokens to append, number accepted)."""
        k = self.spec_k
        base = len(r.out_tokens)
        invt = 1.0 / r.temperature
        toks: List[int] = []
        for i in range(k):
            p = _softmax_np(vlog_row[i] * invt)
            q = _softmax_np(dlog_row[i] * invt)
            rng = np.random.default_rng(
                [r.seed & 0x7FFFFFFF, _ACCEPT_FOLD, base + i])
            di = d[i]
            if rng.random() * max(float(q[di]), 1e-30) < float(p[di]):
                toks.append(di)
                continue
            res = np.maximum(p - q, 0.0)
            s = float(res.sum())
            probs = res / s if s > 0.0 else p
            toks.append(int(rng.choice(probs.shape[0], p=probs)))
            return toks, i
        p = _softmax_np(vlog_row[k] * invt)
        rng = np.random.default_rng(
            [r.seed & 0x7FFFFFFF, _BONUS_FOLD, base + k])
        toks.append(int(rng.choice(p.shape[0], p=p)))
        return toks, k
