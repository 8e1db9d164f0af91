"""Serving engines (port of ``repro/serve/engine.py``): the fixed-batch
``ServeEngine`` (``:130-185``) and the continuous-batching
``ContinuousEngine`` over the paged KV pool (``:209-1632``).

``ServeEngine`` is the reference's original loop: one synchronized batch, a
contiguous cache (``LM.init_contiguous_cache``), one prefill (the flash
kernel on the GPU) and plain decode steps at one shared position, eagerly.
It is the oracle the continuous engine's greedy tokens are held against.

``submit()`` enqueues a request; each ``step()`` admits whatever fits
(scheduler + block pool), looks up each joiner's longest cached block-aligned
prefix in the pool's prefix registry (``prefix_cache``, on by default for a
pure-attention LM) and prefills only the suffix —
suffixes in the same length bucket go together through one
``LM.prefill_chunk`` call over the pool's page stores (the chunked-prefill
kernel on the GPU) — and then runs ONE decode step over the whole running
set at per-request positions (``LM.decode_step``, the paged-attention kernel
on the GPU). An MLA model's pages hold latents, which its attention reads in
plain torch through the same signatures and graphs: no paged kernel runs
(``paged_kernel`` and ``prefill_kernel`` False, as in the JAX engine, which
serves MLA through its gather path). The batch is padded to the next of
``bucket_sizes`` and the block envelope to a power of two, exactly as the
JAX engine pads them:
padding rows carry position 0, length 1 and all-trash block tables. When the
pool runs dry during decode the youngest request is preempted and later
re-prefilled. Each row samples with its own temperature (greedy at 0) from
a generator seeded by (request seed, output index), so a preempted request
resumes on the same trajectory; a request stops at ``max_new_tokens`` or
``eos_id``. ``fork()`` clones a running request copy-on-write (best-of-n).

Per-request prefill: a request with ``extras`` (a vlm's ``vision_embeds``
prefix) is not cacheable and does not take the batched chunked prefill.
``step()`` prefills it alone over a contiguous cache (``LM.prefill``: the
flash kernel on the GPU, launched or raising) and writes its first
``vis_offset + len(tokens)`` positions into its pages
(``BlockPool.scatter_prefill``); its decode steps then go through the
same signatures and graphs as every other request, at ``cache_len =
vis_offset + len(tokens)``. That prefill runs eagerly, not as a captured
graph, since its length varies by request: it is no capture, so
``post_warmup_compiles`` stays 0 with vision requests in the trace
(``request_prefills`` counts these calls). A preempted vision request is
prefilled again over prompt + output with its extras. Speculation serves
only cacheable requests.

Recurrent and hybrid models (xLSTM's mLSTM/sLSTM, jamba's Mamba layers
beside attention; the reference's non-chunked route,
``repro/serve/engine.py:247-313``): a chunked suffix prefill would need the
state at every block boundary, so every request is non-cacheable and
prefilled alone through the per-request prefill, whose final state
``scatter_prefill`` writes into the request's state slot. The prefix cache
is off (``prefix_cache=None``; True raises ``ValueError``), and so are
speculation (a draft raises) and the chunked-prefill kernel
(``prefill_kernel`` False; True raises). Decode goes through the same
signatures and graphs as an attention model's, with the rows' state slots
in the packed int32 inputs (padding rows, and warmup's captures, on the
pool's trash slot); the recurrence gathers and scatters its slot rows in
place, so a replay reads and writes the same state stores every time. A
preempted request gives up its slot and is prefilled again over prompt +
output; ``fork`` copies the parent's state slot into the child's. A hybrid
model's attention layers prefill through the flash kernel on the card and
decode through the paged kernel over their pages, beside the Mamba state in
its slots.

Encoder–decoders (whisper's ``EncDecLM``) take the same non-chunked route:
every request carries its encoder input ``extras={"frames": (1,
n_audio_frames, d_model)}`` (``submit`` raises ``ValueError`` without it,
where the JAX engine fails on ``None``) and is prefilled alone — encoder,
then decoder over the prompt, the flash kernel for its causal
self-attention on the card — writing its self-attention K/V into its pages
and its cross K/V into its state slot. Decode runs the decoder's
self-attention through the paged-attention kernel over the pages
(``paged_kernel`` True, where the JAX engine reads them through its gather
path) and its cross-attention in plain torch over the slot rows it gathers
(``slots`` in the packed inputs), never written back.

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

Telemetry (the JAX engine's, ``repro/obs``'s port in ``repro_torch.obs``):
one ``Registry`` per engine holds the engine's, the scheduler's and the
pool's series under the JAX names, and ``metrics()`` is the JAX
compatibility view over it; the serving spans and instants go to the
process tracer (a capture emits the compile instant, since a capture is the
port's compile); an optional ``FlightRecorder`` gets the JAX lifecycle
events and ``dump_postmortem`` writes its bundle (a raising ``step()`` does
so before propagating); ``slo_ttft_s``/``slo_tpot_s`` grade finished
requests into ``serve_slo_goodput``.

Live recompression (``attach_recalibrator``, ``hot_swap``): a
``serve/recalibrate.py`` worker streams sampled traffic into calibration on
the dense base model and recompresses with pinned ranks once the bound
clears; ``hot_swap`` then writes the new values into the served copy's
tensors in place (``copy_``, cast to ``compute_dtype``), on the stream the
graphs replay on, between steps. The captured graphs read those very
tensors, so a swap needs no capture and in-flight requests keep their pages.
The caller's model is never written: an engine serving it as it is (the
compute dtype is the model's) makes its own copy before its first capture
or swap (``_own_weights``), so the graphs read the engine's tensors.

Model families: every decoder of ``repro_torch.configs`` (dense GQA,
gemma2's local window and softcaps, deepseek's MoE, deepseek-v2's MLA,
qwen2-vl, xLSTM and jamba through the recurrent route above, and whisper's
encoder–decoder through the same route). An MoE
layer's capacity comes from the step's padded token count, so a signature
fixes it and its graph is static; its combine adds without atomics, so a
replay gives the eager engine's bits.

Host pipeline (``serve/detokenize.py``): every emitted token goes through
``_emit_stream`` — from the per-request prefill, the batched prefill, decode
and the speculative round, at the JAX engine's places — to a background
worker that detokenizes it (``detokenizer``) and runs the request's
``stream_callback`` in emission order (``async_detok``, on by default; off:
inline, the ordering oracle). The worker gets Python ints, never a tensor a
graph owns. ``run()`` and ``run_offline()`` (the MLPerf-style offline lane:
prompts sorted longest first so same-bucket prompts prefill together,
results in input order) flush it before returning; ``stream()`` yields
finished requests as they finish. ``last_step_time`` and ``warmed`` are what
``obs.TelemetryServer``'s ``/healthz`` reads.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import math
import time
import weakref
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import lowrank_linear as _ll
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as _pa
from repro_torch.models.attention import MLA
from repro_torch.models.common import ParallelCtx
from repro_torch.models.ffn import ExpertBank, MoE
from repro_torch.models.linear import Linear
from repro_torch.obs import trace
from repro_torch.obs.metrics import LATENCY_BUCKETS, Registry
from repro_torch.serve.detokenize import DetokenizeWorker, deliver
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
    projection's ``w`` or ``b_t``/``a_t``, each MoE expert bank, MLA's
    ``w_uk``/``w_uv`` and the embedding (also the tied LM head) — stored in
    ``dtype`` once: the same rounding the per-call cast applies, so the
    outputs do not change. Norm scales stay as they are (the
    norms compute in fp32 from them). ``model`` itself when it is already in
    ``dtype``."""
    if dtype == model.dtype:
        return model
    cast = [model.embed] + [p for mod in model.modules()
                            if isinstance(mod, (Linear, ExpertBank))
                            for p in mod._parameters.values()]
    cast += [p for mod in model.modules() if isinstance(mod, MLA)
             for p in (mod.w_uk, mod.w_uv)]
    memo = {id(p): torch.nn.Parameter(p.detach().to(dtype), requires_grad=False)
            for p in cast}
    return copy.deepcopy(model, memo)


def _vis_offset(model, extras) -> int:
    """Cache positions a request's vision prefix takes (a vlm's
    ``vision_embeds`` (1, n_vis, d_model)), 0 otherwise."""
    if (extras and "vision_embeds" in extras
            and model.cfg.family == "vlm"):
        return int(extras["vision_embeds"].shape[1])
    return 0


class ServeEngine:
    """Fixed-batch generation (``repro/serve/engine.py:130-185``): every
    row prefills together over one contiguous cache (``LM.prefill``; on the
    GPU its attention is the flash kernel, ``ParallelCtx(use_pallas=True)``)
    and decodes in lockstep at one shared position (``LM.decode_step``
    without block tables: plain attention over the whole cache), eagerly.
    ``compute_dtype``/``cache_dtype`` as in ``ContinuousEngine``."""

    def __init__(self, model, *, compute_dtype=None, cache_dtype=None):
        self.model = model
        self.device = model.device
        self.compute_dtype = compute_dtype or model.dtype
        self.cache_dtype = cache_dtype or model.dtype
        self._target = compute_copy(model, self.compute_dtype)
        self.ctx = ParallelCtx(use_pallas=self.device.type == "cuda")

    @torch.no_grad()
    def generate(self, prompt_tokens, max_new_tokens: int, *,
                 extras: Optional[Dict] = None, temperature: float = 0.0,
                 seed: int = 0) -> np.ndarray:
        """prompt_tokens (B, T0) ints -> (B, T0 + max_new_tokens) int32 on
        the host. ``extras``: model inputs (B, ...) — a vlm's
        ``vision_embeds``, whose prefix takes the first cache positions, so
        the decode positions are offset by its length. Greedy at
        ``temperature`` <= 0, else row i samples from generators seeded by
        (``seed`` + i, output index)."""
        prompts = torch.as_tensor(prompt_tokens).to(self.device, torch.int32)
        b, t0 = prompts.shape
        extras = dict(extras or {})
        vis = _vis_offset(self.model, extras)
        model, cd = self._target, self.compute_dtype
        cache = model.init_contiguous_cache(b, vis + t0 + max_new_tokens,
                                            dtype=self.cache_dtype)
        logits = model.prefill(prompts, cache, ctx=self.ctx, compute_dtype=cd,
                               **extras)
        out = [prompts.cpu().numpy()]
        tok = self._sample(logits, temperature, seed, 0)
        for i in range(max_new_tokens):
            out.append(tok)
            if i == max_new_tokens - 1:
                break
            logits = model.decode_step(torch.as_tensor(tok, device=self.device),
                                       cache, vis + t0 + i, compute_dtype=cd)
            tok = self._sample(logits, temperature, seed, i + 1)
        return np.concatenate(out, axis=1).astype(np.int32)

    @staticmethod
    def _sample(logits, temperature: float, seed: int, index: int):
        b = logits.shape[0]
        if temperature <= 0.0:
            nxt = torch.argmax(logits, dim=-1)
        else:
            nxt = sample_rows(logits, [temperature] * b,
                              [seed + i for i in range(b)], [index] * b)
        return nxt.cpu().numpy().astype(np.int32)[:, None]


def _weak_gauge(obj, read):
    """A gauge callback returning ``read(obj)`` that does not keep ``obj``
    alive (nan once it is gone). The registry belongs to ``obj``: a strong
    reference would make a cycle, leaving the engine's pages, weight copies
    and graphs to the cyclic collector, which may run anywhere — inside a
    CUDA-graph capture too."""
    ref = weakref.ref(obj)

    def value():
        o = ref()
        return float("nan") if o is None else read(o)
    return value


def _layout(sig, state: bool = False) -> Tuple[Tuple[str, tuple], ...]:
    """Named int32 inputs of a step signature, in packed order (a spec
    round's temperatures travel as their fp32 bits); with ``state`` a
    decode step also takes the rows' state slots."""
    if sig[0] == "decode":
        _, b, nb = sig
        slots = (("slots", (b,)),) if state else ()
        return (("tok", (b, 1)), ("pos", (b,)), ("tables", (b, nb))) + slots
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


def _pack(sig, state: bool = False, **arrays) -> np.ndarray:
    """One flat int32 host array holding a step's inputs."""
    parts = []
    for name, shape in _layout(sig, state):
        a = np.zeros(_seg(shape), np.int32)
        a[:math.prod(shape)] = np.asarray(arrays[name], np.int32).reshape(-1)
        parts.append(a)
    return np.concatenate(parts)


def _views(sig, buf: torch.Tensor, state: bool = False
           ) -> Dict[str, torch.Tensor]:
    """The step's inputs as contiguous views of the packed buffer."""
    out, off = {}, 0
    for name, shape in _layout(sig, state):
        out[name] = buf[off:off + math.prod(shape)].view(shape)
        off += _seg(shape)
    return out


def _trash_inputs(sig, trash_slot: Optional[int] = None) -> np.ndarray:
    """All-padding inputs: token 0, position 0, length 1, all-trash tables
    and, with ``trash_slot``, every row's state on that slot."""
    state = trash_slot is not None
    shapes = dict(_layout(sig, state))
    fill = {"lens": 1, "slots": trash_slot}
    return _pack(sig, state, **{n: np.full(s, fill.get(n, 0))
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
                 prefill_kernel: Optional[bool] = None,
                 cuda_graphs: Optional[bool] = None,
                 draft_model=None, spec_k: int = 4,
                 slo_ttft_s: Optional[float] = None,
                 slo_tpot_s: Optional[float] = None,
                 flight_recorder=None,
                 detokenizer: Optional[Callable[[int], str]] = None,
                 async_detok: Optional[bool] = None):
        """``compute_dtype``/``cache_dtype``: activations and KV pool (None:
        the model's dtype; the JAX engine's defaults are bf16 for both).
        ``prefix_cache`` (None: on for a pure-attention LM, off for a
        recurrent one, where True raises ``ValueError``) and
        ``prefill_kernel`` (None: what the model allows — the chunked-prefill
        kernel for a GQA LM; any other value raises ``ValueError``, since
        the port has no gather prefill path to run instead) are the JAX
        engine's switches. ``draft_model``: an ``LM`` of the target's config,
        served as the speculative draft proposing ``spec_k`` tokens a round
        (``ValueError`` for a recurrent model).
        ``slo_ttft_s``/``slo_tpot_s``: latency SLOs feeding the goodput
        gauge (None: met by every request). ``flight_recorder``: an
        ``obs.FlightRecorder`` receiving the lifecycle events.
        ``detokenizer``: token id -> text piece, accumulated into each
        request's ``text``; ``async_detok`` (None = on) runs it and the
        stream callbacks on a background worker, off inline."""
        self.model = model
        self.draft_model = draft_model
        self.device = model.device
        self.compute_dtype = compute_dtype or model.dtype
        self.cache_dtype = cache_dtype or model.dtype
        self._target = compute_copy(model, self.compute_dtype)
        kinds = model.layer_kinds()
        # the chunked (position-offset) prefill that a cached prefix and the
        # speculative verifier need rides attention alone: a recurrent layer
        # would need its state at every block boundary
        self._chunk_ok = all(k == "attn" for k in kinds)
        self._spec = draft_model is not None
        self.spec_k = int(spec_k)
        if self._spec and not self._chunk_ok:
            raise ValueError(
                "speculative decoding needs the chunked (position-offset) "
                "prefill path as its verifier (pure-attention LM)")
        if self._spec:
            if self.spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            if draft_model.cfg != model.cfg or draft_model.device != self.device:
                raise ValueError("the draft must be an LM of the target's "
                                 "config on the target's device")
            self._draft = compute_copy(draft_model, self.compute_dtype)
        self.flight = flight_recorder
        self.slo_ttft_s = slo_ttft_s
        self.slo_tpot_s = slo_tpot_s
        self._step_idx = 0
        self._swap_epoch = 0
        # /healthz: readiness (warmup done, or a step taken) and liveness
        self.last_step_time: Optional[float] = None
        self.warmed = False
        self.block_size = block_size
        self.prefix_cache = (self._chunk_ok if prefix_cache is None
                             else prefix_cache)
        if self.prefix_cache and not self._chunk_ok:
            raise ValueError(
                "prefix caching needs chunked suffix prefill, which this "
                "model does not support (recurrent/hybrid/enc-dec layers)")
        # the paged kernels read {"k", "v"} pages (an encoder-decoder's
        # decoder self-attention's too): MLA's latent pages are read by its
        # own attention and a recurrent model has none, so neither kernel
        # runs for them
        self.paged_kernel = (bool({"attn", "cross"} & set(kinds))
                             and not model.cfg.kv_lora_rank)
        supported = self._chunk_ok and self.paged_kernel
        self.prefill_kernel = (supported if prefill_kernel is None
                               else prefill_kernel)
        if self.prefill_kernel and not supported:
            raise ValueError(
                "chunked-prefill kernel unsupported for this model "
                "(recurrent/hybrid/MLA/enc-dec layers)")
        if supported and not self.prefill_kernel:
            raise ValueError(
                "the port has no gather prefill path: the chunked-prefill "
                "kernel runs wherever the model allows it")
        is_cuda = self.device.type == "cuda"
        self.cuda_graphs = is_cuda if cuda_graphs is None else cuda_graphs
        if self.cuda_graphs and not is_cuda:
            raise ValueError("cuda_graphs needs a model on a CUDA device")
        # the per-request prefill's attention: the flash kernel on the card
        self._prefill_ctx = ParallelCtx(use_pallas=is_cuda)
        self.request_prefills = 0       # per-request (contiguous) prefills
        # async host pipeline: detokenize + stream callbacks on the worker's
        # thread (started at the first emission); off = inline delivery
        self.detokenizer = detokenizer
        self.async_detok = True if async_detok is None else async_detok
        self._detok = (DetokenizeWorker(detokenizer) if self.async_detok
                       else None)
        # one registry per engine: the pool and the scheduler register
        # their own series into it, and metrics() is a view over it
        self.registry = Registry()
        pool_kw = dict(num_blocks=num_blocks, block_size=block_size,
                       max_requests=max_running, dtype=self.cache_dtype,
                       prefix_cache=self.prefix_cache)
        self.pool = BlockPool(model, registry=self.registry, **pool_kw)
        # a recurrent model's decode steps carry the rows' state slots
        self._state = self.pool.has_state
        self.scheduler = Scheduler(self.pool, max_running=max_running,
                                   registry=self.registry,
                                   headroom_tokens=self.spec_k
                                   if self._spec else 0,
                                   flight=flight_recorder)
        # the draft decodes against its own pool (a private registry: the
        # pool_* series describe the target's), kept in lockstep with the
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
        self._recalib = None            # attach_recalibrator() installs one
        # step signatures seen (warmed or served): decode, prefill, spec
        self._decode_shapes: set = set()
        self._prefill_shapes: set = set()
        self._spec_shapes: set = set()
        if self._spec:
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
        self._scratch = None                # the capture stream's kernel scratch
        self._captures = {"decode": 0, "prefill": 0, "spec": 0, "dprefill": 0}
        self._trash_runs: set = set()   # signatures an eager warmup has run
        # rows of one call meet only in an MoE layer's shared capacity
        self._rows_meet = any(isinstance(m, MoE) for m in model.modules())
        self._warmed = 0
        self._warmup_seconds = 0.0
        self._register_series()

    def _register_series(self) -> None:
        """The engine's registry series, under the JAX engine's names
        (``repro/serve/engine.py:338-396``); the steady-state pairs (tokens
        + seconds) leave out steps that captured a graph."""
        reg = self.registry
        self._c_decode_steps = reg.counter(
            "serve_decode_steps_total", "decode steps run")
        self._c_decode_tokens = reg.counter(
            "serve_decode_tokens_total",
            "steady-state decoded tokens (capture steps excluded)")
        self._c_decode_seconds = reg.counter(
            "serve_decode_seconds_total",
            "steady-state decode wall time (capture steps excluded)")
        self._c_prefill_batches = reg.counter(
            "serve_prefill_batches_total", "batched suffix prefill calls")
        self._c_prefill_tokens = reg.counter(
            "serve_prefill_tokens_total",
            "steady-state prefilled suffix tokens (captures excluded)")
        self._c_prefill_seconds = reg.counter(
            "serve_prefill_seconds_total",
            "steady-state batched-prefill wall time (captures excluded)")
        self._c_prompt_tokens = reg.counter(
            "serve_prompt_tokens_total", "prompt tokens submitted to prefill")
        self._c_prefix_hit_tokens = reg.counter(
            "serve_prefix_hit_tokens_total",
            "prompt tokens satisfied from the prefix cache")
        self._c_finished = reg.counter(
            "serve_requests_finished_total", "requests run to completion")
        self._c_new_tokens = reg.counter(
            "serve_new_tokens_total", "tokens generated by finished requests")
        if self._spec:
            # registered only in speculative mode, as in the JAX engine
            self._c_spec_rounds = reg.counter(
                "serve_spec_rounds_total", "speculative draft+verify rounds")
            self._c_spec_proposed = reg.counter(
                "serve_spec_proposed_tokens_total",
                "draft tokens proposed to the verifier")
            self._c_spec_accepted = reg.counter(
                "serve_spec_accepted_tokens_total",
                "draft tokens accepted by the target")
        self._h_ttft = reg.histogram(
            "serve_ttft_seconds", LATENCY_BUCKETS,
            "arrival -> first generated token")
        self._h_step = reg.histogram(
            "serve_decode_step_seconds", LATENCY_BUCKETS,
            "steady-state decode step wall time (inter-token latency)")
        self._h_tpot = reg.histogram(
            "serve_tpot_seconds", LATENCY_BUCKETS,
            "per-request mean time per output token after the first")
        self._h_e2e = reg.histogram(
            "serve_request_e2e_seconds", LATENCY_BUCKETS,
            "arrival -> request completion")
        eng = ContinuousEngine
        reg.gauge("serve_slo_goodput",
                  "fraction of finished requests meeting the TTFT/TPOT "
                  "SLOs (1.0 with no SLO set or nothing finished)",
                  fn=_weak_gauge(self, eng._slo_goodput))
        reg.gauge("serve_running_requests", "requests in the decode batch",
                  fn=_weak_gauge(self, lambda e: len(e.scheduler.running)))
        reg.gauge("serve_decode_compiles", "decode graph captures",
                  fn=_weak_gauge(self, eng.decode_compile_count))
        reg.gauge("serve_prefill_compiles", "prefill graph captures",
                  fn=_weak_gauge(self, eng.prefill_compile_count))
        reg.gauge("serve_warmup_seconds", "wall time spent in warmup()",
                  fn=_weak_gauge(self, lambda e: e._warmup_seconds))
        reg.gauge("serve_post_warmup_compiles",
                  "graph captures not covered by warmup()",
                  fn=_weak_gauge(self, eng.post_warmup_compiles))

    # ------------------------------------------------------------------ API
    def submit(self, prompt_tokens, max_new_tokens: int, *,
               temperature: float = 0.0, seed: int = 0,
               eos_id: Optional[int] = None,
               extras: Optional[Dict] = None,
               stream_callback: Optional[Callable] = None) -> int:
        """Enqueue one request; returns its id. ``temperature`` <= 0 is
        greedy; ``seed`` keys the request's samples; generation stops after
        ``max_new_tokens`` or at ``eos_id``. ``extras``: per-request model
        inputs shaped (1, ...) — a vlm's ``vision_embeds``, an
        encoder–decoder's ``frames`` (required there) — which make the
        request non-cacheable (prefilled alone, see the module docstring).
        ``stream_callback`` receives a ``StreamEvent`` per emitted token (on
        the detokenize worker's thread unless ``async_detok=False``)."""
        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
        if self.model.cfg.family == "encdec" and not (extras and
                                                      "frames" in extras):
            raise ValueError(
                "an encoder-decoder request needs its encoder input: "
                "extras={'frames': (1, n_audio_frames, d_model)}")
        vis = _vis_offset(self.model, extras)
        req = Request(req_id=self._next_id, prompt=prompt,
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      seed=seed, eos_id=eos_id, extras=extras, vis_offset=vis,
                      cacheable=self._chunk_ok and not extras and vis == 0,
                      stream_callback=stream_callback)
        if self._spec and not req.cacheable:
            raise ValueError(
                "speculative decoding serves text-only chunked-prefill "
                "requests (no extras / vision prefixes)")
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
        if self.flight is not None:
            self.flight.record("submit", req_id=req.req_id,
                               prompt_tokens=int(prompt.size),
                               max_new_tokens=int(max_new_tokens))
        return req.req_id

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def step(self) -> List[Request]:
        """Admit + prefill joiners (each looks up its cached prefix once, at
        allocation; same-length-bucket suffixes are batched into one call),
        then one decode step over the running batch; returns the requests
        that finished during this step. A raising step dumps the postmortem
        bundle (with a flight recorder attached) before propagating."""
        self._step_idx += 1
        if self.flight is not None:
            self.flight.begin_step(self._step_idx)
        try:
            done = self._step_inner()
        except Exception as e:
            if self.flight is not None:
                self.flight.record("step_exception", error=repr(e))
                self.dump_postmortem("step_exception")
            raise
        self.last_step_time = time.perf_counter()
        return done

    def _step_inner(self) -> List[Request]:
        if self._recalib is not None:
            # between-steps hook: staged swaps land first, so a swap always
            # falls on a step boundary
            self._recalib.on_step(self)
        done: List[Request] = []
        admitted = self.scheduler.admit()
        groups: Dict[int, list] = {}
        for req in admitted:
            if not req.cacheable:
                self._prefill_request(req)    # extras / recurrent models
                continue
            toks = req.prefill_tokens()
            cached = self.pool.alloc(req.req_id, len(toks), tokens=toks)
            if self._spec and self.draft_pool.alloc(
                    req.req_id, len(toks), tokens=toks) != cached:
                raise RuntimeError("the draft pool diverged from the target's")
            self._c_prompt_tokens.inc(len(toks))
            self._c_prefix_hit_tokens.inc(cached)
            if self.flight is not None and cached:
                self.flight.record("prefix_hit", req_id=req.req_id,
                                   cached_tokens=int(cached))
            if self._recalib is not None:
                # capture rides admission: the recalibrator replays exactly
                # the tokens this prefill is about to compute over
                self._recalib.on_prefill(self, req)
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

    def stream(self) -> Iterator[Request]:
        """Drive steps until the queue drains, yielding finished requests.
        With the async pipeline on, a yielded request's ``text`` and
        callbacks may still be in flight: ``flush_stream()`` (which
        ``run()`` calls) waits for them."""
        while self.has_work():
            yield from self.step()

    def flush_stream(self) -> None:
        """Block until every emitted token's detokenize/callback work has
        been delivered by the worker (no-op when synchronous)."""
        if self._detok is not None:
            self._detok.flush()

    def run(self) -> List[Request]:
        out = list(self.stream())
        self.flush_stream()
        return out

    def run_offline(self, requests, *, sort_by_length: bool = True
                    ) -> List[Request]:
        """MLPerf-style offline batch lane (``repro/serve/engine.py:
        714-763``): ``requests`` are ``(prompt_tokens, max_new_tokens)``
        pairs or dicts of ``submit()`` kwargs, all enqueued up front, longest
        prompt first, so prompts landing in the same suffix-length bucket
        are admitted together and share batched prefill calls; the engine
        then drives itself to drain and flushes the stream pipeline.
        Returns the finished requests in *input* order."""
        norm = []
        for r in requests:
            if isinstance(r, dict):
                norm.append(dict(r))
            else:
                prompt, n = r
                norm.append({"prompt_tokens": prompt, "max_new_tokens": n})
        order = list(range(len(norm)))
        if sort_by_length:
            order.sort(key=lambda i: -len(
                np.asarray(norm[i]["prompt_tokens"]).reshape(-1)))
        with trace.span("serve.run_offline", requests=len(norm)):
            ids = {i: self.submit(**norm[i]) for i in order}
            while self.has_work():
                self.step()
            self.flush_stream()
        by_id = {r.req_id: r for r in self.finished}
        return [by_id[ids[i]] for i in range(len(norm))]

    def generate(self, prompt_tokens, max_new_tokens: int, *,
                 extras: Optional[Dict] = None, temperature: float = 0.0,
                 seed: int = 0) -> np.ndarray:
        """Fixed-batch convenience wrapper matching ``ServeEngine.generate``
        (``repro/serve/engine.py:969-990``): submits every row (row i's
        extras sliced to (1, ...), seed ``seed`` + i), runs to completion and
        returns (B, T0 + new) int32, rows stopped early padded with 0."""
        prompts = (prompt_tokens.cpu().numpy() if torch.is_tensor(prompt_tokens)
                   else np.asarray(prompt_tokens)).astype(np.int32)
        ids = []
        for i in range(prompts.shape[0]):
            ex = ({k: v[i:i + 1] for k, v in extras.items()} if extras
                  else None)
            ids.append(self.submit(prompts[i], max_new_tokens,
                                   temperature=temperature, seed=seed + i,
                                   extras=ex))
        by_id = {r.req_id: r for r in self.run() if r.req_id in set(ids)}
        rows = []
        for i, rid in enumerate(ids):
            out = np.asarray(by_id[rid].out_tokens, np.int32)
            out = np.pad(out, (0, max_new_tokens - len(out)))   # early EOS
            rows.append(np.concatenate([prompts[i], out]))
        return np.stack(rows).astype(np.int32)

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
            seed=seed, eos_id=parent.eos_id, extras=parent.extras,
            vis_offset=parent.vis_offset, cacheable=parent.cacheable)
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
        if self.flight is not None:
            self.flight.record("fork", req_id=child.req_id,
                               parent=parent.req_id,
                               at_tokens=len(child.out_tokens))
        return child.req_id

    # ------------------------------------------------------- recalibration
    def attach_recalibrator(self, worker) -> None:
        """Install a live-traffic recalibrator (``serve/recalibrate.py``'s
        ``RecalibWorker``): every ``step()`` calls its ``on_step`` (which
        applies staged swaps and polls the bound gates), admission and
        completion route sampled streams into its calibrator, and the
        ``serve_recalib_*`` series join the registry — only once attached,
        as in the JAX engine."""
        self._recalib = worker
        # reject-path flight/postmortem wiring; weak, as the gauges below
        # hold the worker
        worker._engine = weakref.ref(self)
        reg = self.registry
        worker.bind_metrics(
            swaps=reg.counter("serve_recalib_swaps_total",
                              "factor hot-swaps applied to the live engine"),
            sampled=reg.counter("serve_recalib_sampled_requests_total",
                                "requests sampled into traffic calibration"),
            tokens=reg.counter("serve_recalib_captured_tokens_total",
                               "served token positions streamed into "
                               "calibration"))
        reg.gauge("serve_recalib_tokens_seen_min",
                  "min calibration tokens streamed over target layers",
                  fn=worker.min_tokens_seen)
        reg.gauge("serve_recalib_bound_clearance",
                  "min tokens_seen / (min_token_factor x n) over target "
                  "layers; the data gate clears at >= 1",
                  fn=worker.clearance)
        reg.gauge("serve_recalib_residual_excess",
                  "worst residual/bound ratio of the last recompression",
                  fn=lambda: worker.last_excess)

    @torch.no_grad()
    def hot_swap(self, model, draft_model=None) -> None:
        """Swap refreshed weights into the live engine between steps — no
        drain, no capture. ``model`` (and ``draft_model`` in speculative
        mode) must match the engine's model exactly: the same ``state_dict``
        keys and per-tensor shapes and dtypes. Its values are written in
        place (``copy_``, cast to ``compute_dtype``) into the served copy's
        tensors, which the captured graphs read, on the stream the graphs
        replay on; on the card the host then waits for the copies, so the
        sources may go once this returns. In-flight requests keep their KV
        pages; their next step runs the new weights. Neither ``model`` nor
        the engine's own model is written."""
        if draft_model is not None and not self._spec:
            raise ValueError("hot_swap: draft_params given but the engine "
                             "is not in speculative mode")
        pairs = [("params", self.model, model)]
        if draft_model is not None:
            pairs.append(("draft_params", self.draft_model, draft_model))
        for name, ref, new in pairs:
            old_sd, new_sd = ref.state_dict(), new.state_dict()
            if list(old_sd) != list(new_sd):
                raise ValueError(f"hot_swap: {name} treedef mismatch "
                                 "(state_dict keys differ: rank-unstable "
                                 "recompression?)")
            for key, lo in old_sd.items():
                ln = new_sd[key]
                if lo.shape != ln.shape or lo.dtype != ln.dtype:
                    raise ValueError(
                        f"hot_swap: {name} leaf {key} changed "
                        f"{tuple(lo.shape)}/{lo.dtype} -> "
                        f"{tuple(ln.shape)}/{ln.dtype}; swaps must be "
                        "shape/dtype-stable")
        self._own_weights()
        with trace.span("serve.recalib_swap",
                        draft=draft_model is not None):
            for name, _, new in pairs:
                served = self._draft if name == "draft_params" else self._target
                live = served.state_dict()
                for key, t in new.state_dict().items():
                    live[key].copy_(t)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        self._swap_epoch += 1
        if self.flight is not None:
            self.flight.record("recalib_swap", epoch=self._swap_epoch,
                               draft=draft_model is not None,
                               in_flight=len(self.scheduler.running))

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
        runs for the draft too. A recurrent model has no prefill sigs: its
        requests are prefilled alone, eagerly."""
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
        if not self._chunk_ok:
            return decode, prefill
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
        """Run every signature of ``warmup_signatures(max_len)`` once against
        the trash page and the trash slot (a CUDA-graph engine captures it
        after that pass), so no admissible request waits on a capture.
        ``max_len`` bounds the worst-case per-request cache positions
        (prompt + generated); it defaults to, and is capped at, the pool's
        capacity. Re-running only warms what is missing. The reference runs
        each signature too (``repro/serve/engine.py:860-880``): its padding
        rows' writes leave the trash page and slot behind, which later
        padding rows read. Where the model has an MoE layer, the padding
        rows' routing takes expert capacity from the real rows of the same
        call, so an eager engine runs the same passes and holds the same
        trash state as a graph engine; elsewhere no padding row reaches a
        real row, and an eager engine has nothing to warm.
        Returns a summary; the wall time adds up in
        ``metrics()["warmup_seconds"]``."""
        cap = self.pool.usable_blocks * self.block_size
        max_len = cap if max_len is None else min(max_len, cap)
        t0 = time.perf_counter()
        decode_sigs, prefill_sigs = self.warmup_signatures(max_len)
        with trace.span("serve.warmup", max_len=max_len,
                        decode_sigs=len(decode_sigs),
                        prefill_sigs=len(prefill_sigs)):
            kind = "spec" if self._spec else "decode"
            (self._spec_shapes if self._spec else self._decode_shapes).update(
                (kind, b, nb) for b, nb in decode_sigs)
            self._prefill_shapes.update(("prefill",) + sig
                                        for sig in prefill_sigs)
            # a round writes spec_k + 1 positions, so no real table is
            # smaller (and the trash writes would overrun it)
            sigs = [(kind, b, nb) for b, nb in decode_sigs
                    if not (self._spec and nb * self.block_size < self.spec_k + 1)]
            for b, l, nb in prefill_sigs:
                sigs.append(("prefill", b, l, nb))
                if self._spec:
                    sigs.append(("dprefill", b, l, nb))
            for sig in sigs:
                if self.cuda_graphs:
                    self._graph(sig)
                elif self._rows_meet and sig not in self._trash_runs:
                    self._trash_runs.add(sig)
                    self._forward(sig, self._trash_views(sig)[1])
            if self.cuda_graphs:
                torch.cuda.synchronize(self.device)
        self._warmed = sum(self._captures.values())
        self.warmed = True                  # /healthz readiness flips here
        dt = time.perf_counter() - t0
        self._warmup_seconds += dt
        return {"warmup_seconds": dt, "max_len": float(max_len),
                "decode_signatures": float(len(decode_sigs)),
                "prefill_signatures": float(len(prefill_sigs))}

    def post_warmup_compiles(self) -> int:
        """Graph captures beyond what ``warmup()`` covered: 0 after warmup
        under admissible traffic (before any warmup it counts them all)."""
        return sum(self._captures.values()) - self._warmed

    def decode_compile_count(self) -> int:
        """Decode and speculative-round graphs captured."""
        return self._captures["decode"] + self._captures["spec"]

    def prefill_compile_count(self) -> int:
        """Prefill graphs captured (the draft's included)."""
        return self._captures["prefill"] + self._captures["dprefill"]

    def release_graphs(self) -> None:
        """Drop the captured graphs, their memory pool and the capture
        stream's scratch; later steps capture again as needed."""
        self._graphs.clear()
        self._graph_pool = None
        if self._stream is not None:
            self._release_scratch()
            self._stream = None
            self._scratch = None

    # -------------------------------------------------------------- metrics
    def reset_metrics(self) -> None:
        """Zero everything request-level — the finished list (and with it
        the TTFT samples), timers, queue and preemption series, hit-rate and
        pool counters: the whole registry, whose callback gauges keep
        reading live state — keeping the graphs and the prefix registry
        warm."""
        self.finished = []
        self._start_time = None
        self.registry.reset()

    def metrics(self) -> Dict[str, float]:
        """Aggregate serving metrics over finished requests: the JAX
        engine's compatibility view over ``self.registry``
        (``registry.snapshot()`` is the superset), with its keys. The
        steady-state rates leave out steps that captured a graph; a capture
        is the port's compile. ``prefill_kernel`` is 1.0 where the
        chunked-prefill kernel runs the prefill, 0.0 for MLA."""
        decode_s = self._c_decode_seconds.value
        prefill_s = self._c_prefill_seconds.value
        m = {
            "decode_compiles": self.decode_compile_count(),
            "decode_shapes": len(self._decode_shapes),
            "decode_steps": int(self._c_decode_steps.value),
            "decode_tok_per_s": (self._c_decode_tokens.value / decode_s
                                 if decode_s > 0.0 else 0.0),
            "prefill_compiles": self.prefill_compile_count(),
            "prefill_shapes": len(self._prefill_shapes),
            "prefill_batches": int(self._c_prefill_batches.value),
            "prefill_tok_per_s": (self._c_prefill_tokens.value / prefill_s
                                  if prefill_s > 0.0 else 0.0),
            "prefill_kernel": float(self.prefill_kernel),
            "prefix_hit_rate": (self._c_prefix_hit_tokens.value
                                / max(self._c_prompt_tokens.value, 1)),
            "prefix_hit_tokens": int(self._c_prefix_hit_tokens.value),
            "cached_blocks": self.pool.cached_blocks,
            "cow_copies": self.pool.stats["cow_copies"],
            "prefix_evictions": self.pool.stats["evictions"],
            "queue_depth": len(self.scheduler.waiting),
            "preemptions": self.scheduler.preemptions,
            "warmup_seconds": self._warmup_seconds,
            "post_warmup_compiles": self.post_warmup_compiles(),
            "slo_goodput": self._slo_goodput(),
        }
        if self._spec:
            proposed = self._c_spec_proposed.value
            m.update({
                "spec_k": float(self.spec_k),
                "spec_rounds": int(self._c_spec_rounds.value),
                "spec_proposed_tokens": int(proposed),
                "spec_accepted_tokens": int(self._c_spec_accepted.value),
                "spec_accept_rate": (self._c_spec_accepted.value / proposed
                                     if proposed > 0 else 0.0),
            })
        if self._recalib is not None:
            w = self._recalib
            m.update({
                "recalib_swaps": int(w.swaps),
                "recalib_sampled_requests": int(w.cal.sampled_requests),
                "recalib_captured_tokens": int(w.cal.captured_tokens),
                "recalib_clearance": float(w.clearance()),
                "recalib_residual_excess": float(w.last_excess),
            })
        fin = self.finished
        if not fin:
            # TTFT is undefined with nothing finished: None, never NaN, so
            # the dict stays strict JSON
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

    @staticmethod
    def _req_tpot(req: Request) -> Optional[float]:
        """Per-request mean time per output token after the first; None
        until finished or with fewer than two tokens."""
        if req.first_token_time is None or req.finish_time is None:
            return None
        n = len(req.out_tokens)
        if n < 2:
            return None
        return (req.finish_time - req.first_token_time) / (n - 1)

    def _meets_slo(self, req: Request) -> bool:
        """Did a finished request meet the SLOs? An unset SLO is met; so is
        a TPOT SLO by a request too short to have a TPOT."""
        if self.slo_ttft_s is not None:
            t = req.ttft
            if t is None or t > self.slo_ttft_s:
                return False
        if self.slo_tpot_s is not None:
            tp = self._req_tpot(req)
            if tp is not None and tp > self.slo_tpot_s:
                return False
        return True

    def _slo_goodput(self) -> float:
        """Fraction of finished requests meeting the SLOs (1.0 with nothing
        finished)."""
        fin = self.finished
        if not fin:
            return 1.0
        return sum(1 for r in fin if self._meets_slo(r)) / len(fin)

    def dump_postmortem(self, reason: str,
                        path: Optional[str] = None) -> Optional[str]:
        """Write the flight recorder's postmortem bundle (ring tail, metrics,
        engine config, trace tail); returns its path, or None without a
        recorder. Wired to step exceptions and recalibration rejections."""
        if self.flight is None:
            return None
        try:
            metrics = self.metrics()
        except Exception:            # never let a broken metric eat the dump
            metrics = {}
        config = {
            "block_size": self.block_size,
            "num_blocks": self.pool.num_blocks,
            "max_running": self.scheduler.max_running,
            "bucket_sizes": list(self.bucket_sizes),
            "prefill_bucket_sizes": list(self.prefill_bucket_sizes),
            "cuda_graphs": self.cuda_graphs,
            "paged_kernel": self.paged_kernel,
            "prefill_kernel": self.prefill_kernel,
            "prefix_cache": self.prefix_cache,
            "spec": self._spec,
            "spec_k": self.spec_k,
            "slo_ttft_s": self.slo_ttft_s,
            "slo_tpot_s": self.slo_tpot_s,
            "compute_dtype": str(self.compute_dtype),
            "cache_dtype": str(self.cache_dtype),
            "device": str(self.device),
            "step": self._step_idx,
            "swap_epoch": self._swap_epoch,
        }
        return self.flight.dump(reason=reason, metrics=metrics,
                                config=config, path=path)

    # ------------------------------------------------------------ internals
    def _emit_stream(self, req: Request, token: int, done: bool) -> None:
        """Hand one emitted token (a Python int) to the host pipeline:
        queued for the worker, or delivered inline with ``async_detok``
        off. Nothing to do without a detokenizer and a callback."""
        if self.detokenizer is None and req.stream_callback is None:
            return
        index = len(req.out_tokens) - 1
        if self._detok is not None:
            self._detok.submit(req, token, index, done)
        else:
            deliver(req, token, index, done, self.detokenizer)

    def _prefill_request(self, req: Request) -> None:
        """Prefill one non-cacheable request alone (``repro/serve/
        engine.py:1249-1273``): its vision prefix and tokens (prompt, plus
        the output after a preemption) over a contiguous cache of its
        table's length, eagerly through ``LM.prefill`` (no graph: the length
        varies by request), then the first ``vis_offset + len(tokens)``
        positions into its pages and, for a recurrent model, its final state
        into its state slot."""
        with trace.span("serve.prefill_request", req_id=req.req_id,
                        tokens=len(req.prompt)):
            tokens = req.prefill_tokens()
            l0 = req.vis_offset + len(tokens)
            self.pool.alloc(req.req_id, l0)
            nb = len(self.pool.table(req.req_id))
            model = self._target
            cache = model.init_contiguous_cache(1, nb * self.block_size,
                                                dtype=self.cache_dtype)
            logits = model.prefill(
                torch.as_tensor(tokens, device=self.device)[None], cache,
                ctx=self._prefill_ctx, compute_dtype=self.compute_dtype,
                **(req.extras or {}))
            self.pool.scatter_prefill([req.req_id], cache, l0)
            self.request_prefills += 1
            req.cache_len = l0
            tok = int(self._sample_tokens(logits, [req])[0])
            req.out_tokens.append(tok)
            self._emit_stream(req, tok, req.done)
            if req.first_token_time is None:
                req.first_token_time = time.perf_counter()
                self._h_ttft.observe(req.ttft)
                if self.flight is not None:
                    self.flight.record("first_token", req_id=req.req_id,
                                       ttft_s=req.ttft)

    def _finish(self, req: Request) -> None:
        self.scheduler.evict(req)
        if self._spec:
            self.draft_pool.free(req.req_id)
        self.finished.append(req)
        self._c_finished.inc()
        self._c_new_tokens.inc(len(req.out_tokens))
        self._h_e2e.observe(req.finish_time - req.arrival_time)
        tpot = self._req_tpot(req)
        if tpot is not None:
            self._h_tpot.observe(tpot)
        if self.flight is not None:
            self.flight.record("finish", req_id=req.req_id,
                               new_tokens=len(req.out_tokens),
                               preemptions=req.preemptions,
                               ttft_s=req.ttft, tpot_s=tpot,
                               slo_ok=self._meets_slo(req))
        if self._recalib is not None:
            # completion capture: the generated inputs (out_tokens[:-1])
            # stream into calibration once the request's tail is known
            self._recalib.on_finish(self, req)

    @staticmethod
    def _seen(shapes: set, sig) -> bool:
        """Add ``sig`` to a signature set; True when it is new there."""
        new = sig not in shapes
        shapes.add(sig)
        return new

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
                inputs["tables"], slots=inputs.get("slots"), compute_dtype=cd)
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
            return self._forward(sig, _views(sig, buf, self._state)), False
        fresh = sig not in self._graphs
        g = self._graph(sig)
        g.ints.copy_(torch.from_numpy(host))
        g.graph.replay()
        ops.add_replayed(g.launches)
        return g.out, fresh

    def _graph(self, sig) -> StepGraph:
        """The captured graph of ``sig``, captured now if missing: one eager
        pass on the capture stream against all-trash inputs (it loads the
        kernels and sets their plans up, writing only the trash page and the
        trash slot), then the capture into the engine's graph pool."""
        g = self._graphs.get(sig)
        if g is not None:
            return g
        dev = self.device
        if self._stream is None:
            self._own_weights()
            self._stream = torch.cuda.Stream(dev)
            # the capture stream's pinned kernel scratch goes with the
            # engine's graphs, also when the engine is dropped unreleased:
            # a later stream with the same handle would find it taken
            self._release_scratch = weakref.finalize(
                self, _ll.release_scratch, dev, self._stream.cuda_stream)
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._reserve_scratch()
        ints, inputs = self._trash_views(sig)
        s = self._stream
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            self._forward(sig, inputs)
        graph = torch.cuda.CUDAGraph()
        # no cyclic collection inside the capture: freeing another object's
        # graphs or memory there invalidates it
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with ops.captured_launches() as launches:
                with torch.cuda.graph(graph, pool=self._graph_pool, stream=s):
                    out = self._forward(sig, inputs)
        finally:
            if gc_was_on:
                gc.enable()
        torch.cuda.current_stream(dev).wait_stream(s)
        g = StepGraph(graph, ints, out, launches)
        self._graphs[sig] = g
        self._captures[sig[0]] += 1
        return g

    def _trash_views(self, sig):
        """``sig``'s all-trash packed inputs on the device (every row a
        padding row: trash tables, the trash slot) and their views."""
        trash = self.pool.trash_slot if self._state else None
        ints = torch.as_tensor(_trash_inputs(sig, trash), device=self.device)
        return ints, _views(sig, ints, self._state)

    def _own_weights(self) -> None:
        """Serve the engine's own copies of the target and the draft: a
        captured graph holds the addresses of the tensors it reads and
        ``hot_swap`` writes into them, so neither may be the caller's.
        (A copy in another compute dtype is the engine's already.)"""
        if self._target is self.model:
            self._target = copy.deepcopy(self.model)
        if self._spec and self._draft is self.draft_model:
            self._draft = copy.deepcopy(self.draft_model)

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
        for b, nb in decode if self.paged_kernel else ():
            work = max(work, _pa.plan(b, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.head_dim, nb).workspace)
        # held here too: the graphs hold its address, so it lives as long
        # as they do, whatever later happens to the stream's entry
        self._scratch = _ll.reserve_scratch(self.device,
                                            self._stream.cuda_stream, work,
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
        if self.flight is not None:
            for r, ln_i in zip(reqs, lens):
                self.flight.record("prefill", req_id=r.req_id,
                                   suffix_tokens=int(ln_i), bucket=l_pad,
                                   batch=len(group))
        new_sig = self._seen(self._prefill_shapes, sig)
        tok = np.zeros((b_pad, l_pad), np.int32)
        for i, s in enumerate(suffixes):
            tok[i, :len(s)] = s
        pad = b_pad - len(group)
        host = _pack(sig, tok=tok, pos=starts + [0] * pad,
                     lens=lens + [1] * pad,
                     tables=self.pool.padded_tables(ids, rows=b_pad,
                                                  blocks=nb_pad))
        t0 = time.perf_counter()
        with trace.span("serve.prefill_batch", batch=len(group),
                        tokens=sum(lens), sig=str(sig[1:])):
            logits, fresh = self._run(sig, host)
            nxt = self._sample_tokens(logits, reqs)
            if self._spec:
                dsig = ("dprefill",) + sig[1:]
                with trace.span("serve.spec_draft_prefill", batch=len(group)):
                    _, dfresh = self._run(dsig, _pack(
                        dsig, tok=tok, pos=starts + [0] * pad,
                        lens=lens + [1] * pad,
                        tables=self.draft_pool.padded_tables(
                            ids, rows=b_pad, blocks=nb_pad)))
                fresh = fresh or dfresh
        if new_sig or fresh:
            trace.instant("serve.prefill_compile", sig=str(sig[1:]))
        if not fresh:                       # steady-state timer: skip captures
            self._c_prefill_seconds.inc(time.perf_counter() - t0)
            self._c_prefill_tokens.inc(sum(lens))
        self._c_prefill_batches.inc()
        now = time.perf_counter()
        for r, start, ln_i, t in zip(reqs, starts, lens, nxt):
            r.cache_len = start + ln_i
            r.out_tokens.append(int(t))
            self._emit_stream(r, int(t), r.done)
            if r.first_token_time is None:
                r.first_token_time = now
                self._h_ttft.observe(r.ttft)
                if self.flight is not None:
                    self.flight.record("first_token", req_id=r.req_id,
                                       ttft_s=r.ttft)
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
        new_sig = self._seen(self._decode_shapes, sig)
        pad = b_pad - b_real
        host = _pack(sig, self._state,
                     tok=[r.out_tokens[-1] for r in running] + [0] * pad,
                     pos=[r.cache_len for r in running] + [0] * pad,
                     tables=self.pool.padded_tables(ids, rows=b_pad,
                                                  blocks=nb_pad),
                     slots=self.pool.slots(ids, rows=b_pad))
        t0 = time.perf_counter()
        with trace.span("serve.decode_step", batch=b_real, sig=str(sig[1:])):
            logits, fresh = self._run(sig, host)
            nxt = self._sample_tokens(logits, running)
        if new_sig or fresh:
            trace.instant("serve.decode_compile", sig=str(sig[1:]))
        self._c_decode_steps.inc()
        if not fresh:                       # steady-state timer: skip captures
            dt = time.perf_counter() - t0
            self._c_decode_seconds.inc(dt)
            self._c_decode_tokens.inc(b_real)
            self._h_step.observe(dt)
        done = []
        for r, t in zip(running, nxt):
            r.cache_len += 1
            r.out_tokens.append(int(t))
            self._emit_stream(r, int(t), r.done)
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
        new_sig = self._seen(self._spec_shapes, sig)
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
        with trace.span("serve.spec_step", batch=b_real, sig=str(sig[1:])):
            (ints, vlogits, dlogits), fresh = self._run(sig, host)
            ints = ints[:b_real].cpu().numpy()
            if hot:
                # full distributions cross to the host only for sampled rows
                rows = torch.as_tensor(hot, device=self.device)
                vlog = vlogits[rows].cpu().numpy()          # (n, k+1, V)
                dlog = dlogits[:, rows].cpu().numpy()       # (k+1, n, V)
        if new_sig or fresh:
            trace.instant("serve.spec_compile", sig=str(sig[1:]))
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
            self._c_spec_proposed.inc(k)
            self._c_spec_accepted.inc(n_acc)
            if self.flight is not None:
                self.flight.record("spec_round", req_id=r.req_id,
                                   proposed=k, accepted=n_acc)
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
            for t in keep:
                r.out_tokens.append(t)
                self._emit_stream(r, t, r.done)
            emitted += len(keep)
            if self.prefix_cache and r.cacheable:
                committed = r.prefill_tokens()[:r.cache_len]
                self.pool.commit(r.req_id, committed)
                self.draft_pool.commit(r.req_id, committed)
            if r.done:
                self._finish(r)
                done.append(r)
        self._c_decode_steps.inc()
        self._c_spec_rounds.inc()
        if not fresh:                       # steady-state timer: skip captures
            dt = time.perf_counter() - t0
            self._c_decode_seconds.inc(dt)
            self._c_decode_tokens.inc(emitted)
            self._h_step.observe(dt)
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
