"""Continuous-batching serving engine over the paged KV pool (port of
``repro/serve/engine.py:118-131``, ``:209-597``, ``:1223-1247`` and
``:1275-1444``).

``submit()`` enqueues a request; each ``step()`` admits whatever fits
(scheduler + block pool), prefills the joiners — suffixes in the same length
bucket go together through one ``LM.prefill_chunk`` call over the pool's
page stores (the chunked-prefill kernel on the GPU) — and then runs ONE
decode step over the whole running set at per-request positions
(``LM.decode_step``, the paged-attention kernel on the GPU). The batch is
padded to the next of ``bucket_sizes`` and the block envelope to a power of
two, exactly as the JAX engine pads them: padding rows carry position 0,
length 1 and all-trash block tables. When the pool runs dry during decode
the youngest request is preempted and later re-prefilled. Sampling is
greedy.

Waiting for later slices: temperature sampling, warmup (CUDA graphs),
speculative decoding, the prefix cache and ``fork``, recalibration, async
detokenize, SLOs and telemetry.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

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


class ContinuousEngine:
    """Request-level serving: ``submit()`` / ``step()`` / ``run()``."""

    def __init__(self, model, *, block_size: int = 16, num_blocks: int = 512,
                 max_running: int = 8,
                 bucket_sizes: Optional[Sequence[int]] = None,
                 prefill_bucket_sizes: Optional[Sequence[int]] = None):
        self.model = model
        self.device = model.device
        self.block_size = block_size
        self.pool = BlockPool(model, num_blocks=num_blocks,
                              block_size=block_size, max_requests=max_running,
                              dtype=model.dtype)
        self.scheduler = Scheduler(self.pool, max_running=max_running)
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
                         "prefill_tokens": 0, "prefill_seconds": 0.0}

    # ------------------------------------------------------------------ API
    def submit(self, prompt_tokens, max_new_tokens: int, *,
               temperature: float = 0.0) -> int:
        """Enqueue one request; returns its id."""
        if temperature > 0.0:
            raise NotImplementedError(
                "temperature sampling is not ported yet (greedy only)")
        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
        req = Request(req_id=self._next_id, prompt=prompt,
                      max_new_tokens=max_new_tokens)
        need = self.pool.blocks_for(req.cache_budget())
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
        """Admit + prefill joiners (same-length-bucket suffixes batched into
        one call), then one decode step over the running batch; returns the
        requests that finished during this step."""
        done: List[Request] = []
        admitted = self.scheduler.admit()
        groups: Dict[int, list] = {}
        for req in admitted:
            toks = req.prefill_tokens()
            cached = self.pool.alloc(req.req_id, len(toks))
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
            done.extend(self._decode_step(running))
        return done

    def run(self) -> List[Request]:
        out: List[Request] = []
        while self.has_work():
            out.extend(self.step())
        return out

    def metrics(self) -> Dict[str, float]:
        """Aggregate serving metrics over finished requests. Every step is
        timed (there is no compile step to exclude, unlike the JAX engine)."""
        c = self.counters
        m = {
            "decode_steps": c["decode_steps"],
            "decode_tok_per_s": (c["decode_tokens"] / c["decode_seconds"]
                                 if c["decode_seconds"] > 0 else 0.0),
            "prefill_batches": c["prefill_batches"],
            "prefill_tok_per_s": (c["prefill_tokens"] / c["prefill_seconds"]
                                  if c["prefill_seconds"] > 0 else 0.0),
            "decode_seconds": c["decode_seconds"],
            "prefill_seconds": c["prefill_seconds"],
            "preemptions": self.scheduler.preemptions,
        }
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
        self.finished.append(req)

    def _bucket_batch(self, n: int) -> int:
        return bucket_batch(n, self.bucket_sizes)

    def _bucket_prefill(self, n: int) -> int:
        return bucket_prefill(n, self.prefill_bucket_sizes)

    def _ints(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int32), device=self.device)

    def _prefill_batch(self, group) -> None:
        """One ``prefill_chunk`` over a same-bucket group of (request,
        tokens, cached-prefix-len) joiners, already allocated by ``step()``,
        padded to the (batch, suffix-len, blocks) bucket."""
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
        tok = np.zeros((b_pad, l_pad), np.int32)
        for i, s in enumerate(suffixes):
            tok[i, :len(s)] = s
        pad = b_pad - len(group)
        t0 = time.perf_counter()
        tables = self.pool.padded_tables(ids, rows=b_pad, blocks=nb_pad)
        logits = self.model.prefill_chunk(
            self._ints(tok), self.pool.pages, self._ints(starts + [0] * pad),
            self._ints(lens + [1] * pad), tables)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()[:len(reqs)]
        self.counters["prefill_seconds"] += time.perf_counter() - t0
        self.counters["prefill_tokens"] += sum(lens)
        self.counters["prefill_batches"] += 1
        now = time.perf_counter()
        for r, start, ln_i, t in zip(reqs, starts, lens, nxt):
            r.cache_len = start + ln_i
            r.out_tokens.append(int(t))
            if r.first_token_time is None:
                r.first_token_time = now

    def _decode_step(self, running: List[Request]) -> List[Request]:
        # reserve the next position for everyone, preempting the youngest
        # request when the pool runs dry
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
        pad = b_pad - b_real
        t0 = time.perf_counter()
        tables = self.pool.padded_tables(ids, rows=b_pad, blocks=nb_pad)
        tok = self._ints([[r.out_tokens[-1]] for r in running] + [[0]] * pad)
        pos = self._ints([r.cache_len for r in running] + [0] * pad)
        logits = self.model.decode_step(tok, self.pool.pages, pos, tables)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()[:b_real]
        self.counters["decode_seconds"] += time.perf_counter() - t0
        self.counters["decode_tokens"] += b_real
        self.counters["decode_steps"] += 1
        done = []
        for r, t in zip(running, nxt):
            r.cache_len += 1
            r.out_tokens.append(int(t))
            if r.done:
                self._finish(r)
                done.append(r)
        return done
