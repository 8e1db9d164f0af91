"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need a CUDA card (the kernels are built with nvcc for sm_90a at
first use) and skip without one. The paged kernels are also held at every
pair of q and page dtypes (fp32 / bf16), the chunked kernel at the
speculative verifier's shape. The last ones serve a staggered trace on
llama3_1b SMOKE through the engine's CUDA graphs and hold it against the
eager engine (the same kernels, launched call by call), also speculatively
and in bf16, and swap recompressed factors into the captured graphs
(``hot_swap``, inline and from an async recalibration solve). JAX-free, so
they run on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 attention 2e-5 (softmax over <= 2048 keys); fp32 low-rank
linear 1e-4 relative to max|ref| (sums of up to 2048 products, another
order than cuBLAS); bf16 2e-2 relative (one bf16 rounding of the
intermediate or the output may differ); gram_accum 1e-5 relative to max|G|
in both dtypes (bf16 inputs convert to fp32 exactly, then fp32 sums of
<= 512 products in another order).
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.config import CompressConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core.calibrate import calibrate_model, linear_paths
from repro_torch.core.compress import compress_model, compress_model_pair
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gram_accum as ga
from repro_torch.kernels import lowrank_linear as ll
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.chunked_prefill import chunked_prefill_ref
from repro_torch.kernels.paged_attention import paged_attention_ref
from repro_torch.kernels.ref import (flash_attention_ref, gram_accum_ref,
                                     lowrank_linear_ref)
from repro_torch.launch.serve import serve_trace, synthetic_trace
from repro_torch.models import build_model
from repro_torch.models.linear import Linear
from repro_torch.serve import ContinuousEngine
from repro_torch.serve.engine import _pack

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _randn(seed, shape, dev, dtype=torch.float32):
    a = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(dev, dtype)


def _close(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    assert err <= tol * scale, (err, tol * scale)


# the kernels' edges: M across the decode (<= 16) / prefill switch and the
# prefill tiles (64 rows fp32, 128 bf16); ranks whose rows are not 16-byte aligned (245, 614, 983);
# d_in = 1000, a multiple of neither K step (16 / 8 / 32); d_out not a
# multiple of the 128-column tile (2050 not even of 4)
LOWRANK_EDGES = [(m, 1000, r, {245: 512, 614: 2050, 983: 1000}[r])
                 for m in (1, 8, 16, 17, 128, 256, 300) for r in (245, 614, 983)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,d_in,r,d_out", [(8, 2048, 614, 2048), (3, 512, 245, 96),
                                            (300, 256, 83, 130),
                                            (1100, 1000, 245, 8202)]   # many tiles
                         + LOWRANK_EDGES)
def test_lowrank_linear_cuda(cuda, dtype, tol, m, d_in, r, d_out):
    x = _randn(0, (m, d_in), cuda, dtype)
    bt = _randn(1, (d_in, r), cuda, dtype) / d_in ** 0.5
    at = _randn(2, (r, d_out), cuda, dtype) / r ** 0.5
    before = ops.launch_counts()["lowrank_linear"]
    got = ops.lowrank_linear(x, bt.contiguous(), at.contiguous())
    torch.cuda.synchronize()
    assert ops.launch_counts()["lowrank_linear"] == before + 1
    _close(got, lowrank_linear_ref(x, bt, at), tol)
    # split-K sums in a fixed order: a second call gives the same bits
    assert torch.equal(ops.lowrank_linear(x, bt.contiguous(), at.contiguous()), got)


def _tables(lengths, bs):
    nb = max(-(-max(lengths) // bs), 1)
    t = np.zeros((len(lengths), nb), np.int32)
    nxt = 1
    for i, ln in enumerate(lengths):
        for j in range(-(-ln // bs)):
            t[i, j] = nxt
            nxt += 1
    return t, nxt


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,lengths,bs,cap,window", [
    (4, 2, [5, 12, 1], 4, 0.0, 0), (3, 1, [8, 3], 4, 0.0, 0),
    (4, 2, [20, 11], 4, 50.0, 0), (4, 2, [20, 6, 13], 4, 0.0, 8),
    (8, 2, [40, 0, 0, 17], 16, 30.0, 6),
])
def test_paged_attention_cuda(cuda, hq, hkv, lengths, bs, cap, window):
    tables, nxt = _tables(lengths, bs)
    q = _randn(0, (len(lengths), hq, 64), cuda)
    kp = _randn(1, (nxt + 2, bs, hkv, 64), cuda)
    vp = _randn(2, (nxt + 2, bs, hkv, 64), cuda)
    args = (q, kp, vp, torch.from_numpy(tables).to(cuda),
            torch.tensor(lengths, dtype=torch.int32, device=cuda))
    got = ops.paged_attention(*args, cap=cap, window=window)
    want = paged_attention_ref(*args, cap=cap, window=window)
    _close(got, want, 2e-5)
    assert torch.all(got[torch.tensor(lengths, device=cuda) == 0] == 0)


def _paged_args(cuda, dtype, hq, hkv, lengths, bs, hd=64, seed=0, nb=1):
    tables, nxt = _tables(lengths, bs)
    tables = np.pad(tables, ((0, 0), (0, max(0, nb - tables.shape[1]))))  # trash page 0
    q = _randn(seed, (len(lengths), hq, hd), cuda, dtype)
    kp = _randn(seed + 1, (nxt + 2, bs, hkv, hd), cuda, dtype)
    vp = _randn(seed + 2, (nxt + 2, bs, hkv, hd), cuda, dtype)
    return (q, kp, vp, torch.from_numpy(tables).to(cuda),
            torch.tensor(lengths, dtype=torch.int32, device=cuda))


@pytest.fixture
def fresh_paged_plan():
    pa.plan.cache_clear()
    yield
    pa.plan.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hq,hkv,hd,lengths,bs,cap,window,splits", [
    (32, 8, 64, [1200, 37, 0, 300], 16, 0.0, 0, None),   # a row of >= 1000 keys
    (32, 8, 64, [1200, 37, 0, 300], 16, 0.0, 0, 75),     # one page per split
    (8, 2, 64, [1000, 517, 3], 16, 30.0, 0, 7),          # softcap
    (32, 8, 64, [200, 90, 1, 0], 16, 0.0, 40, 13),       # window across split boundaries
    (32, 8, 64, [333, 17], 16, 0.0, 100, 3),             # window starting mid-page
    (4, 1, 64, [0, 0, 0], 16, 0.0, 0, 4),                # all padding rows, 8 trash pages
    (24, 8, 128, [700, 5], 12, 0.0, 0, None),            # G 3, hd 128, bs 12
    (8, 1, 32, [64, 1, 130], 4, 0.0, 0, 9),              # G 8, hd 32, bs 4
    (4, 4, 16, [50, 0], 4, 0.0, 24, 2),                  # G 1, hd 16
    (12, 2, 128, [456, 300, 17, 1], 16, 0.0, 0, None),   # qwen2-vl: G 6, hd 128
    (12, 2, 128, [456, 300, 17, 1], 16, 0.0, 0, 5),
])
def test_paged_attention_cuda_splits(cuda, monkeypatch, fresh_paged_plan, dtype, tol, hq,
                                     hkv, hd, lengths, bs, cap, window, splits):
    """The page-split kernel and its combine against the plain version, with
    the plan's own splits or a forced count; zero-length rows are exactly
    zero and a second call gives the same bits."""
    if splits is not None:
        monkeypatch.setattr(pa, "TARGET_BLOCKS", splits * len(lengths) * hkv)
    args = _paged_args(cuda, dtype, hq, hkv, lengths, bs, hd, nb=8)
    p = pa.plan(len(lengths), hq, hkv, hd, args[3].shape[1])
    if splits is not None:
        assert p.splits > 1
    before = ops.launch_counts()["paged_attention"]
    got = ops.paged_attention(*args, cap=cap, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_attention"] == before + 1
    _close(got, paged_attention_ref(*args, cap=cap, window=window), tol)
    for i, n in enumerate(lengths):
        if n == 0:
            assert torch.all(got[i] == 0)
    assert torch.equal(ops.paged_attention(*args, cap=cap, window=window), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [None, 1, 5])
def test_paged_attention_cuda_trash_page_poison(cuda, monkeypatch, fresh_paged_plan, dtype,
                                                splits):
    """Page 0 (the trash page of padded table entries) never reaches a
    result: filling it with 1e4 changes no output, bit for bit."""
    if splits is not None:
        monkeypatch.setattr(pa, "TARGET_BLOCKS", splits * 4 * 2)
    args = _paged_args(cuda, dtype, 8, 2, [70, 0, 33, 1], 16, seed=5)
    q, kp, vp, tables, ln = args
    clean = ops.paged_attention(*args)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[0], vp2[0] = 1e4, 1e4
    poisoned = ops.paged_attention(q, kp2, vp2, tables, ln)
    torch.cuda.synchronize()
    assert torch.equal(poisoned, clean)
    assert torch.all(poisoned[1] == 0)
    _close(clean, paged_attention_ref(*args), 2e-5 if dtype == torch.float32 else 2e-2)


def _chunked_args(cuda, dtype, hq, hkv, hd, starts, lens, bs, seed=0):
    tables, nxt = _tables([s + n for s, n in zip(starts, lens)], bs)
    lq = max(max(lens), 1)
    q = _randn(seed, (len(lens), lq, hq, hd), cuda, dtype)
    kp = _randn(seed + 1, (nxt + 2, bs, hkv, hd), cuda, dtype)
    vp = _randn(seed + 2, (nxt + 2, bs, hkv, hd), cuda, dtype)
    return (q, kp, vp, torch.from_numpy(tables).to(cuda),
            torch.tensor(starts, dtype=torch.int32, device=cuda),
            torch.tensor(lens, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hq,hkv,hd,starts,lens,bs,cap,window", [
    (4, 2, 64, [0, 8, 4], [5, 7, 1], 4, 0.0, 0), (4, 2, 64, [8, 4], [6, 9], 4, 50.0, 0),
    (4, 2, 64, [16, 0, 8], [5, 11, 3], 4, 0.0, 6),
    (8, 2, 64, [0, 32, 0], [40, 9, 0], 16, 0.0, 0),      # B 3 with a zero-length row
    (32, 8, 64, [70, 5], [90, 33], 16, 0.0, 0),          # rows longer than a key tile
    (32, 8, 64, [70, 0, 130], [90, 0, 20], 4, 30.0, 40),  # window + softcap, bs 4
    (8, 8, 128, [3, 100], [61, 70], 12, 0.0, 0),         # bs 12 divides no key tile
    (4, 1, 16, [0, 17], [200, 3], 16, 20.0, 0),          # G 4 hd 16, many row tiles
    (3, 1, 32, [5, 0], [30, 64], 4, 0.0, 9),             # G 3
    (12, 2, 128, [0, 272, 16], [200, 33, 1], 16, 0.0, 0),  # qwen2-vl: G 6, hd 128
])
def test_chunked_prefill_cuda(cuda, dtype, tol, hq, hkv, hd, starts, lens, bs, cap, window):
    args = _chunked_args(cuda, dtype, hq, hkv, hd, starts, lens, bs)
    before = ops.launch_counts()["chunked_prefill"]
    got = ops.chunked_prefill(*args, cap=cap, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["chunked_prefill"] == before + 1
    want = chunked_prefill_ref(*args, cap=cap, window=window)
    _close(got, want, tol)
    for i, n in enumerate(lens):
        assert torch.all(got[i, n:] == 0)
    # the combine sums the splits in a fixed order: the same bits again
    assert torch.equal(ops.chunked_prefill(*args, cap=cap, window=window), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_prefill_cuda_trash_page_poison(cuda, dtype):
    """Page 0 (the trash page of padded table entries) never reaches a real
    query: filling it with 1e4 changes no valid output, bit for bit."""
    args = _chunked_args(cuda, dtype, 8, 2, 64, [0, 40, 3], [70, 30, 0], 16, seed=5)
    q, kp, vp, tables, st, ln = args
    clean = ops.chunked_prefill(*args)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[0], vp2[0] = 1e4, 1e4
    poisoned = ops.chunked_prefill(q, kp2, vp2, tables, st, ln)
    torch.cuda.synchronize()
    for i, n in enumerate(ln.tolist()):
        assert torch.equal(poisoned[i, :n], clean[i, :n])
        assert torch.all(poisoned[i, n:] == 0)
    _close(clean, chunked_prefill_ref(*args), 2e-5 if dtype == torch.float32 else 2e-2)


DTYPE_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]


def _tol(*dtypes):
    return 2e-5 if all(d == torch.float32 for d in dtypes) else 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", DTYPE_PAIRS)
@pytest.mark.parametrize("lengths,splits", [([183, 98, 163, 146, 172, 1, 1, 1], None),
                                            ([1200, 37, 0, 300], 75)])
def test_paged_attention_cuda_dtype_pairs(cuda, monkeypatch, fresh_paged_plan, qdt, kvdt,
                                          lengths, splits):
    """q in the compute dtype, pages in the cache dtype: every pair launches
    the kernel once per call, within tolerance of the plain version (which
    rounds P to the pages' dtype as the kernel does), the same bits twice."""
    if splits is not None:
        monkeypatch.setattr(pa, "TARGET_BLOCKS", splits * len(lengths) * 8)
    q, kp, vp, tables, ln = _paged_args(cuda, torch.float32, 32, 8, lengths, 16)
    args = (q.to(qdt), kp.to(kvdt), vp.to(kvdt), tables, ln)
    before = ops.launch_counts()["paged_attention"]
    got = ops.paged_attention(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_attention"] == before + 1
    assert got.dtype == qdt
    _close(got, paged_attention_ref(*args), _tol(qdt, kvdt))
    assert torch.equal(ops.paged_attention(*args), got)


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", DTYPE_PAIRS)
@pytest.mark.parametrize("starts,lens", [
    ([0, 48, 0, 96], [128, 90, 33, 128]),
    # the speculative verifier: B 8, L = spec_k + 1 = 5, every row past its
    # prefix (one row tile of 5 x 4 query rows per (row, KV head))
    ([183, 98, 163, 146, 172, 55, 17, 140], [5] * 8),
])
def test_chunked_prefill_cuda_dtype_pairs(cuda, qdt, kvdt, starts, lens):
    q, kp, vp, tables, st, ln = _chunked_args(cuda, torch.float32, 32, 8, 64, starts,
                                              lens, 16)
    args = (q.to(qdt), kp.to(kvdt), vp.to(kvdt), tables, st, ln)
    before = ops.launch_counts()["chunked_prefill"]
    got = ops.chunked_prefill(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["chunked_prefill"] == before + 1
    assert got.dtype == qdt
    _close(got, chunked_prefill_ref(*args), _tol(qdt, kvdt))
    for i, n in enumerate(lens):
        assert torch.all(got[i, n:] == 0)
    assert torch.equal(ops.chunked_prefill(*args), got)


@pytest.mark.cuda
def test_paged_kernels_cuda_refuse_other_dtypes(cuda):
    """fp16, or K and V pages in two dtypes, raise before any launch."""
    q, kp, vp, tables, ln = _paged_args(cuda, torch.float32, 8, 2, [20, 3], 4)
    st = torch.zeros_like(ln)
    before = ops.launch_counts()
    bad = [(q.half(), kp, vp), (q, kp.half(), vp.half()), (q, kp, vp.bfloat16())]
    for qq, kk, vv in bad:
        with pytest.raises(ValueError):
            ops.paged_attention(qq, kk, vv, tables, ln)
        with pytest.raises(ValueError):
            ops.chunked_prefill(qq[:, None].contiguous(), kk, vv, tables, st, ln)
    assert ops.launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,t,hq,hkv,hd,cap", [
    (2, 64, 4, 2, 64, 0.0), (1, 100, 8, 2, 64, 0.0), (2, 37, 4, 1, 16, 20.0),
    (1, 200, 4, 4, 128, 30.0), (1, 130, 4, 2, 32, 0.0),
    (2, 64, 16, 2, 64, 0.0),        # G 8
    (3, 1, 8, 2, 64, 0.0),          # T 1
    (1, 1000, 8, 2, 64, 0.0),       # ragged T over 16 key tiles
    (1, 2048, 32, 8, 64, 0.0),      # 32 key tiles, 2048 row tiles
    (1, 300, 8, 2, 128, 0.0),       # hd 128, ragged
    (2, 256, 32, 8, 64, 50.0),      # softcap at the serve calibration's shape
    (8, 256, 16, 16, 192, 0.0),     # MLA's calibration shape (nope + rope)
    (8, 200, 16, 16, 192, 0.0),     # ... at a ragged T
    (2, 64, 4, 4, 48, 0.0),         # MLA SMOKE's
    (1, 271, 12, 2, 128, 0.0),      # qwen2-vl's per-request prefill: 256
    (1, 456, 12, 2, 128, 0.0)])     # vision + 15 / 200 text positions, G 6
def test_flash_attention_cuda(cuda, dtype, tol, b, t, hq, hkv, hd, cap):
    """Within tol of the plain version, one launch per call, and the same
    bits on a second identical call."""
    q = _randn(0, (b, t, hq, hd), cuda, dtype)
    k = _randn(1, (b, t, hkv, hd), cuda, dtype)
    v = _randn(2, (b, t, hkv, hd), cuda, dtype)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, cap=cap)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, flash_attention_ref(q, k, v, cap=cap), tol)
    assert torch.equal(ops.flash_attention(q, k, v, cap=cap), got)
    assert ops.launch_counts()["flash_attention"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("fill", [0, 10 ** 9])
@pytest.mark.parametrize("b,t,hq,hkv,hd,cap", [
    (2, 37, 4, 1, 16, 20.0), (1, 130, 4, 2, 32, 0.0), (2, 300, 16, 2, 64, 0.0),
    (1, 200, 4, 4, 128, 30.0), (2, 100, 4, 4, 48, 0.0), (1, 150, 4, 4, 192, 0.0)])
def test_flash_attention_cuda_row_tiles(cuda, monkeypatch, dtype, tol, fill, b, t, hq, hkv,
                                        hd, cap):
    """Both row tiles of the plan on the same inputs: FILL_BLOCKS 0 puts
    every hd <= 64 shape on 128-row tiles, 10**9 every shape on 64-row
    tiles (hd 48, 128 and 192 always take them). Within tol of the plain
    version, the same bits on a second call."""
    monkeypatch.setattr(fa, "FILL_BLOCKS", fill)
    fa.plan.cache_clear()
    try:
        assert fa.plan(b, t, hq, hkv, hd, dtype).rows == (
            fa.ROWS if fill == 0 and hd in fa.WIDE_HEAD_DIMS else fa.THIN_ROWS)
        q = _randn(3, (b, t, hq, hd), cuda, dtype)
        k = _randn(4, (b, t, hkv, hd), cuda, dtype)
        v = _randn(5, (b, t, hkv, hd), cuda, dtype)
        got = ops.flash_attention(q, k, v, cap=cap)
        torch.cuda.synchronize()
        _close(got, flash_attention_ref(q, k, v, cap=cap), tol)
        assert torch.equal(ops.flash_attention(q, k, v, cap=cap), got)
    finally:
        fa.plan.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", [(torch.float16, 64), (torch.float32, 40),
                                      (torch.bfloat16, 8)])
def test_flash_attention_cuda_refuses_unplanned(cuda, dtype, hd):
    """A dtype or head size the plan has no tile for raises ValueError and
    launches nothing; so does a query-head count that is not a multiple of
    the KV heads."""
    q = _randn(0, (1, 16, 4, hd), cuda, dtype)
    before = ops.launch_counts()["flash_attention"]
    with pytest.raises(ValueError):
        ops.flash_attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    with pytest.raises(ValueError):
        fa.plan(1, 16, 4, 2, hd, dtype)
    k = _randn(1, (1, 16, 3, 64), cuda)
    with pytest.raises(ValueError):
        ops.flash_attention(_randn(0, (1, 16, 4, 64), cuda), k, k)
    assert ops.launch_counts()["flash_attention"] == before


@pytest.mark.cuda
def test_flash_attention_cuda_refuses_foreign_plan(cuda, monkeypatch):
    """The kernel refuses a row tile it is not compiled for."""
    monkeypatch.setattr(fa, "plan", lambda *a: fa.FlashPlan(32, 1, 2))
    q = _randn(0, (1, 8, 4, 64), cuda)
    k = _randn(1, (1, 8, 2, 64), cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ops.flash_attention(q, k, k)


@pytest.mark.cuda
def test_flash_attention_cuda_refuses_autograd(cuda):
    q = _randn(0, (1, 8, 2, 16), cuda).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, q.detach(), q.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(512, 256), (300, 1000), (7, 130), (64, 2048)])
def test_gram_accum_cuda(cuda, dtype, k, n):
    a = _randn(3, (k, n), cuda, dtype)
    before = ops.launch_counts()["gram_accum"]
    got = ops.gram_accum(a)
    torch.cuda.synchronize()
    assert ops.launch_counts()["gram_accum"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (n, n)
    want = gram_accum_ref([a])
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err
    assert torch.equal(got, got.T)


# both tile edges at a ragged N (1000) and a ragged K (300) or a whole one;
# the plan's own choice at the calibration shapes
GRAM_TILES = ([(k, 1000, t) for k in (300, 512) for t in (64, 128)]
              + [(300, 130, 128), (512, 2048, None), (512, 8192, None)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,tile", GRAM_TILES)
def test_gram_accum_cuda_tiles(cuda, monkeypatch, dtype, k, n, tile):
    """Each tile edge: G within 1e-5 of the plain version, exactly
    symmetric, and the same bits on a second call."""
    if tile is not None:
        monkeypatch.setattr(ga, "plan", lambda n: tile)
    a = _randn(4, (k, n), cuda, dtype)
    got = ops.gram_accum(a)
    torch.cuda.synchronize()
    want = gram_accum_ref([a])
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err
    assert torch.equal(got, got.T)
    assert torch.equal(ops.gram_accum(a), got)


# ---------------------------------------------------------------------------
# the serving engine's CUDA graphs against its eager oracle
# ---------------------------------------------------------------------------

# a pool of 14 pages of 4 tokens against requests of up to 37 positions:
# the trace preempts once; its prompts share a 4-token prefix, so the prefix
# cache hits at starts > 0
ENGINE_KNOBS = dict(block_size=4, num_blocks=14, max_running=3)
ENGINE_TRACE = dict(seed=1, min_prompt=4, max_prompt=20, max_new=16,
                    arrival_every=1, shared_prefix=4)


@pytest.fixture(scope="module")
def smoke_models():
    """llama3_1b SMOKE (projections x3, random norm scales, so its tokens
    vary), dense and COALA-compressed on the CPU, then moved to the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    cfg = get_smoke_config("llama3_1b")
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Linear):
                mod.w.mul_(3.0)
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    rng = np.random.RandomState(0)
    batches = [torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 32)))
               for _ in range(2)]
    cmodel, draft, _, _ = compress_model_pair(
        model, calibrate_model(model, batches),
        CompressConfig(ratio=0.6, lam=4.0, mu=-1.0), draft_ratio=0.3)
    dev = torch.device("cuda")
    return {name: copy.deepcopy(m).to(dev)
            for name, m in (("dense", model), ("coala", cmodel), ("draft", draft))}


def _engine_trace():
    return synthetic_trace(6, get_smoke_config("llama3_1b").vocab_size,
                           **ENGINE_TRACE)


def _serve(model, *, warmup=False, temperature=0.0, **kw):
    """(engine, tokens by request id, launch counts eager / replayed) of
    one run of the trace; counts are zeroed after warmup."""
    eng = ContinuousEngine(model, **ENGINE_KNOBS, **kw)
    trace = _engine_trace()
    if warmup:
        eng.warmup(max_len=max(len(p) + nn for _, p, nn in trace))
    ops.reset_launch_counts()
    serve_trace(eng, trace, temperature=temperature)
    torch.cuda.synchronize()
    counts = (ops.eager_launch_counts(), ops.replayed_launch_counts())
    return eng, {r.req_id: list(r.out_tokens) for r in eng.finished}, counts


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dense", "coala"])
def test_engine_cuda_graphs_match_eager(smoke_models, name):
    """Graph replays give the eager engine's greedy tokens on a trace that
    preempts and hits the prefix cache; warmup leaves nothing to capture."""
    eng, toks, _ = _serve(smoke_models[name], warmup=True)
    ref, ref_toks, _ = _serve(smoke_models[name], cuda_graphs=False)
    assert eng.cuda_graphs and not ref.cuda_graphs
    m, rm = eng.metrics(), ref.metrics()
    assert toks == ref_toks and len(toks) == 6
    assert m["post_warmup_compiles"] == 0 and m["decode_compiles"] > 0
    assert m["preemptions"] == rm["preemptions"] >= 1
    assert m["prefix_hit_tokens"] == rm["prefix_hit_tokens"] > 0
    assert rm["decode_compiles"] == rm["prefill_compiles"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dense", "coala"])
def test_engine_cuda_graph_launches_equal_eager(smoke_models, name):
    """After warmup every kernel launch of the trace is a graph replay, and
    the replays launch each kernel as often as the eager engine does."""
    _, _, (eager, replayed) = _serve(smoke_models[name], warmup=True)
    _, _, (ref_eager, ref_replayed) = _serve(smoke_models[name],
                                             cuda_graphs=False)
    assert all(n == 0 for n in eager.values())
    assert all(n == 0 for n in ref_replayed.values())
    assert replayed == ref_eager
    assert replayed["paged_attention"] > 0 and replayed["chunked_prefill"] > 0
    assert (replayed["lowrank_linear"] > 0) == (name == "coala")


@pytest.mark.cuda
def test_engine_cuda_scratch_never_replaced(smoke_models):
    """The capture stream's scratch is reserved before the first capture and
    stays the same buffer through warmup and a later capture at first use."""
    eng = ContinuousEngine(smoke_models["coala"], **ENGINE_KNOBS)
    eng._graph(("decode", 1, 1))
    key = (eng.device, eng._stream.cuda_stream)
    first = [t.data_ptr() for t in ll._scratch[key]]
    eng.warmup(max_len=16)
    eng._graph(("prefill", 3, 32, 16))          # past warmup's max_len
    assert eng.post_warmup_compiles() == 1
    assert [t.data_ptr() for t in ll._scratch[key]] == first
    with pytest.raises(RuntimeError, match="reserv"):
        ll.call_scratch(eng.device, eng._stream.cuda_stream,
                        ll._scratch[key][0].numel() + 1, 0)
    eng.release_graphs()
    assert key not in ll._scratch


@pytest.mark.cuda
def test_engine_cuda_sampled_run_repeats(smoke_models):
    """A sampled trace (temperature 0.8, seed 0 per request as the launcher
    submits) repeats on a second graph engine and equals the eager engine."""
    runs = [_serve(smoke_models["coala"], temperature=0.8, **kw)[1]
            for kw in ({}, {}, dict(cuda_graphs=False))]
    assert runs[0] == runs[1] == runs[2]


SPEC = dict(spec_k=4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dense", "coala"])
def test_engine_cuda_spec_graphs_match_eager(smoke_models, name):
    """Speculative rounds through CUDA graphs give the eager speculative
    engine's greedy tokens and launch counts, which are the non-speculative
    engine's tokens; warmup covers every round and draft prefill."""
    draft = smoke_models["draft"]
    eng, toks, (eager, replayed) = _serve(smoke_models[name], warmup=True,
                                          draft_model=draft, **SPEC)
    ref, ref_toks, (ref_eager, ref_replayed) = _serve(
        smoke_models[name], cuda_graphs=False, draft_model=draft, **SPEC)
    _, plain_toks, _ = _serve(smoke_models[name], cuda_graphs=False)
    m = eng.metrics()
    assert toks == ref_toks == plain_toks and len(toks) == 6
    assert m["post_warmup_compiles"] == 0 and m["spec_rounds"] > 0
    assert m["spec_accepted_tokens"] == ref.metrics()["spec_accepted_tokens"]
    assert all(n == 0 for n in eager.values())
    assert all(n == 0 for n in ref_replayed.values())
    assert replayed == ref_eager
    assert min(replayed[k] for k in ("paged_attention", "chunked_prefill",
                                     "lowrank_linear")) > 0
    for pool in (eng.pool, eng.draft_pool):
        assert pool.available_blocks == pool.usable_blocks


@pytest.mark.cuda
def test_engine_cuda_spec_scratch_never_replaced(smoke_models):
    """The reservation covers the draft's factored shapes and the verify's
    b_pad * (spec_k + 1) rows: warmup and a spec round past it keep the
    first capture's scratch."""
    eng = ContinuousEngine(smoke_models["dense"], **ENGINE_KNOBS,
                           draft_model=smoke_models["draft"], **SPEC)
    eng._graph(("spec", 1, 2))                  # 2 pages hold a round's 5 positions
    key = (eng.device, eng._stream.cuda_stream)
    first = [t.data_ptr() for t in ll._scratch[key]]
    eng.warmup(max_len=16)
    eng._graph(("spec", 3, 16))                 # past warmup's max_len
    assert eng.post_warmup_compiles() == 1
    assert [t.data_ptr() for t in ll._scratch[key]] == first
    eng.release_graphs()


@pytest.mark.cuda
def test_engine_cuda_spec_sampled_run_repeats(smoke_models):
    """A sampled speculative trace (T 0.8) repeats on a second graph engine
    and equals the eager engine: the draft's noise is drawn outside the
    graph from per-(seed, output index) generators."""
    runs = [_serve(smoke_models["coala"], temperature=0.8,
                   draft_model=smoke_models["draft"], **SPEC, **kw)[1]
            for kw in ({}, {}, dict(cuda_graphs=False))]
    assert runs[0] == runs[1] == runs[2]


@pytest.mark.cuda
@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
def test_engine_cuda_bf16_cache_graphs_match_eager(smoke_models, compute):
    """A bf16 cache under fp32 or bf16 activations: graphs after warmup give
    the eager engine's tokens (the same kernels at the same dtype pair)."""
    kw = dict(compute_dtype=compute, cache_dtype=torch.bfloat16)
    eng, toks, _ = _serve(smoke_models["coala"], warmup=True, **kw)
    _, ref_toks, _ = _serve(smoke_models["coala"], cuda_graphs=False, **kw)
    assert toks == ref_toks and eng.metrics()["post_warmup_compiles"] == 0
    assert eng.pool.pages[0]["k"].dtype == torch.bfloat16


def _rank_map(model):
    """The factored projections' ranks by calibrator path."""
    return {p: lin.b_t.shape[1] for p, lin in linear_paths(model)
            if lin.is_factored}


def _replay_logits(eng, tok):
    """Logits of one decode step of ``tok`` at position 0 over the trash
    page (a graph replay, or the eager forward of a ``cuda_graphs=False``
    engine)."""
    sig = ("decode", 1, 1)
    logits, _ = eng._run(sig, _pack(sig, tok=[[tok]], pos=[0], tables=[[0]]))
    return logits.clone()


@pytest.mark.cuda
def test_engine_cuda_hot_swap_reaches_graphs(smoke_models):
    """A swap writes into the tensors the captured graphs read: the next
    replay's logits are the eager engine's on the new model (within the
    fp32 serve tolerance, 1e-3) and differ from the old ones; no capture,
    no scratch reallocated, the caller's models untouched; a trace served
    after the swap gives the new model's eager tokens."""
    coala = smoke_models["coala"]
    cal = calibrate_model(smoke_models["dense"], [torch.as_tensor(
        np.random.RandomState(5).randint(0, 256, (4, 32)), device="cuda")])
    new, _ = compress_model(smoke_models["dense"], cal,
                            CompressConfig(ratio=0.6, lam=4.0, mu=-1.0),
                            rank_map=_rank_map(coala))
    before = {k: v.clone() for k, v in coala.state_dict().items()}
    trace = _engine_trace()
    eng = ContinuousEngine(coala, **ENGINE_KNOBS)
    eng.warmup(max_len=max(len(p) + nn for _, p, nn in trace))
    key = (eng.device, eng._stream.cuda_stream)
    scratch = [t.data_ptr() for t in ll._scratch[key]]
    old_logits = _replay_logits(eng, 7)
    _close(old_logits, _replay_logits(
        ContinuousEngine(coala, cuda_graphs=False, **ENGINE_KNOBS), 7), 1e-3)
    eng.hot_swap(new)
    new_logits = _replay_logits(eng, 7)
    _close(new_logits, _replay_logits(
        ContinuousEngine(new, cuda_graphs=False, **ENGINE_KNOBS), 7), 1e-3)
    assert (new_logits - old_logits).abs().max().item() > 1e-2
    assert eng.post_warmup_compiles() == 0
    assert [t.data_ptr() for t in ll._scratch[key]] == scratch
    serve_trace(eng, trace)
    _, ref_toks, _ = _serve(new, cuda_graphs=False)
    assert {r.req_id: list(r.out_tokens) for r in eng.finished} == ref_toks
    assert eng.post_warmup_compiles() == 0
    assert all(torch.equal(v, before[k]) for k, v in coala.state_dict().items())
    eng.release_graphs()


@pytest.mark.cuda
def test_engine_cuda_async_recalibration_swap_matches(smoke_models):
    """Live recalibration with the solve on a background thread and its own
    CUDA stream: the staged swap lands between steps, captures nothing and
    leaves the graphs computing the solved model's logits."""
    from repro_torch.serve import RecalibPolicy, RecalibWorker, TrafficCalibrator
    coala = smoke_models["coala"]
    trace = _engine_trace()
    eng = ContinuousEngine(coala, **ENGINE_KNOBS)
    eng.warmup(max_len=max(len(p) + nn for _, p, nn in trace))
    key = (eng.device, eng._stream.cuda_stream)
    scratch = [t.data_ptr() for t in ll._scratch[key]]
    tcal = TrafficCalibrator(smoke_models["dense"],
                             policy=RecalibPolicy(check_every=1,
                                                  min_new_tokens=8))
    worker = RecalibWorker(smoke_models["dense"], tcal,
                           CompressConfig(ratio=0.6, lam=4.0, mu=-1.0),
                           rank_map=_rank_map(coala), async_solve=True)
    eng.attach_recalibrator(worker)
    solved = []
    solve = worker._solve
    worker._solve = lambda snap: solved.append(solve(snap)) or solved[-1]
    pending, step = list(trace), 0
    while pending or eng.has_work():
        while pending and pending[0][0] <= step:
            _, prompt, nn = pending.pop(0)
            eng.submit(prompt, nn)
        eng.step()
        assert worker.join(timeout=120)
        step += 1
    assert worker.swaps >= 1, worker.summary()
    assert len(eng.finished) == len(trace)
    assert eng.post_warmup_compiles() == 0
    assert [t.data_ptr() for t in ll._scratch[key]] == scratch
    if worker._staged is not None:           # solved after the last step
        eng.step()
    last = [r for r in solved if r is not None][-1][0]
    _close(_replay_logits(eng, 11), _replay_logits(
        ContinuousEngine(last, cuda_graphs=False, **ENGINE_KNOBS), 11), 1e-3)
    eng.release_graphs()


# ---------------------------------------------------------------------------
# the attention-only families: gemma2 (window, softcaps, sandwich norms),
# deepseek's MoE and deepseek-v2's MLA through the engine's graphs
# ---------------------------------------------------------------------------

FAMILY_KNOBS = dict(block_size=4, num_blocks=48, max_running=3,
                    bucket_sizes=(1, 2, 3), prefill_bucket_sizes=(16, 64))
FAMILY_TRACE = dict(seed=2, min_prompt=20, max_prompt=60, max_new=8,
                    arrival_every=1, shared_prefix=8)
FAMILY_ARCHS = ("gemma2_27b", "deepseek_moe_16b", "deepseek_v2_lite_16b")


@pytest.fixture(scope="module")
def family_models():
    """gemma2_27b, deepseek_moe_16b and deepseek_v2_lite_16b SMOKE, dense and
    COALA-compressed (per expert for the MoE) on the CPU, then moved to the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = get_smoke_config(arch)
        model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        rng = np.random.RandomState(0)
        batches = [torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 40)))
                   for _ in range(2)]
        cmodel, _ = compress_model(model, calibrate_model(model, batches),
                                   CompressConfig(ratio=0.6, lam=4.0, mu=-1.0))
        for name, m in (("dense", model), ("coala", cmodel)):
            out[(arch, name)] = copy.deepcopy(m).to(dev)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("name", ["dense", "coala"])
def test_family_engine_cuda_graphs_match_eager(family_models, arch, name):
    """Prompts past gemma2's SMOKE window and a shared prefix: graph replays
    give the eager engine's greedy tokens, with nothing captured after
    warmup. MLA's latent pages are read by its own attention: the paged
    kernels launch 0 times, and lowrank_linear runs only the COALA model's
    factored projections."""
    model = family_models[(arch, name)]
    trace = synthetic_trace(5, model.cfg.vocab_size, **FAMILY_TRACE)
    ops.reset_launch_counts()
    runs = []
    for graphs in (True, False):
        eng = ContinuousEngine(model, cuda_graphs=graphs, **FAMILY_KNOBS)
        if graphs:
            eng.warmup(max_len=max(len(p) + nn for _, p, nn in trace))
        serve_trace(eng, trace)
        runs.append((eng, {r.req_id: list(r.out_tokens) for r in eng.finished}))
        eng.release_graphs()
    counts = ops.launch_counts()
    (eng, toks), (ref, ref_toks) = runs
    assert toks == ref_toks and len(toks) == 5
    assert eng.metrics()["post_warmup_compiles"] == 0
    assert eng.metrics()["prefix_hit_tokens"] == ref.metrics()["prefix_hit_tokens"] > 0
    if model.cfg.kv_lora_rank:
        for e in (eng, ref):
            assert e.metrics()["prefill_kernel"] == 0.0 and not e.paged_kernel
        assert counts["paged_attention"] == counts["chunked_prefill"] == 0
        assert (counts["lowrank_linear"] > 0) == (name == "coala")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_combine_cuda_repeats(cuda, dtype):
    """The MoE layer at the full width's expert count and top-k, at a
    prefill's token count, gives the same bits twice, and its combine the
    plain scatter-add's sum (fp32, 1e-5 relative to max|ref|)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import ffn
    cfg = get_config("deepseek_moe_16b")
    cfg = dataclasses.replace(cfg, d_model=256, moe=dataclasses.replace(
        cfg.moe, d_ff_expert=64))
    layer = ffn.MoE(cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, 1.0, generator=gen).mul_(p.shape[-2] ** -0.5)
        x = torch.randn((4, 300, cfg.d_model), generator=gen, device=cuda).to(dtype)
        layer = layer.to(dtype)
        layer.router.data = layer.router.data.float()
        y1, aux1 = layer(x)
        y2, aux2 = layer(x)
        assert torch.equal(y1, y2) and torch.equal(aux1, aux2)
        xf = x.reshape(-1, cfg.d_model)
        gw, _ = ffn.route(xf, layer.router, cfg)
        w_sel, idx = ffn.top_k(gw.T, ffn.capacity(xf.shape[0], cfg))
        y_e = torch.randn((*idx.shape, cfg.d_model), generator=gen, device=cuda)
        got = ffn.combine(y_e, idx, w_sel, xf.shape[0], cfg.moe.top_k)
        want = torch.zeros_like(got).index_add_(
            0, idx.reshape(-1), (y_e * (w_sel > 0)[..., None]).reshape(-1, cfg.d_model))
        _close(got, want, 1e-5)
        assert torch.equal(got, ffn.combine(y_e, idx, w_sel, xf.shape[0], cfg.moe.top_k))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_lowrank_linear_cuda_gemma2_down(cuda, dtype, tol):
    """gemma2's down projection (d_in 36864) at decode M 8: 72 split-K
    chunks of 512 at fp32, past the count the planner aims under."""
    r = 2457                                   # rank at ratio 0.6
    x = _randn(0, (8, 36864), cuda, dtype)
    bt = _randn(1, (36864, r), cuda, dtype) / 36864 ** 0.5
    at = _randn(2, (r, 4608), cuda, dtype) / r ** 0.5
    p1, _ = ll.plan(8, 36864, r, 4608, dtype)
    if dtype == torch.float32:
        assert p1.splits == 72
    _close(ll.lowrank_linear(x, bt, at), lowrank_linear_ref(x, bt, at), tol)


# ---------------------------------------------------------------------------
# lowrank_linear under autograd (adapter fine-tuning): dx is one more launch
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,d_in,r,d_out", [(512, 2048, 8, 2048), (512, 8192, 8, 2048),
                                            (512, 2048, 8, 8192), (17, 2048, 37, 512),
                                            (300, 1000, 245, 130)])
def test_lowrank_linear_cuda_grads(cuda, dtype, tol, m, d_in, r, d_out):
    """Gradients of x, b_t and a_t through the kernel's autograd Function
    against autograd through the plain version on the card, at llama3_1b's
    adapter rank 8 (rows of 8 floats: the kernels' scalar load paths) and
    odd ranks; one forward and one backward launch."""
    x0 = _randn(0, (m, d_in), cuda, dtype)
    b0 = _randn(1, (d_in, r), cuda, dtype) / d_in ** 0.5
    a0 = _randn(2, (r, d_out), cuda, dtype) / r ** 0.5
    dy = _randn(3, (m, d_out), cuda, dtype)
    grads = []
    for fn in (ops.lowrank_linear, lowrank_linear_ref):
        x, b, a = (t.clone().requires_grad_() for t in (x0, b0, a0))
        ops.reset_launch_counts()
        fn(x, b, a).backward(dy)
        torch.cuda.synchronize()
        grads.append((x.grad, b.grad, a.grad))
        if fn is ops.lowrank_linear:
            assert ops.launch_counts()["lowrank_linear"] == 2
            assert ops.backward_launch_counts()["lowrank_linear"] == 1
    for got, want in zip(*grads):
        _close(got, want, tol)


@pytest.mark.cuda
def test_adapter_step_cuda_matches_cpu(cuda):
    """One adapter-only AdamW step (coala_a1, rank 8, weight decay 0.1) of
    llama3_1b SMOKE on the card — forward and backward through the kernel —
    against the same step on the CPU: loss, the adapters' gradients and
    every updated leaf (1e-4 relative: the kernel's sums in another order)."""
    from repro_torch.config import TrainConfig
    from repro_torch.core.adapters import init_adapters
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_loop import make_adapter_step

    cfg = get_smoke_config("llama3_1b")
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 32)))
    cal = calibrate_model(model, [toks])
    adapted, mask = init_adapters(model, cal.r_factors(), method="coala_a1", rank=8)
    # eps 1e-3 (tests/test_torch_train.py): the first update g / (|g| + eps)
    # is smooth in g, so gradients that differ by rounding cannot flip it
    tcfg = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10, schedule="const",
                       weight_decay=0.1, eps=1e-3)
    out = {}
    for dev in ("cpu", cuda):
        m = copy.deepcopy(adapted).to(dev)
        opt = adamw_init(dict(m.named_parameters()))
        ops.reset_launch_counts()
        loss, g = make_adapter_step(m, tcfg, mask)(opt, toks.to(dev))
        out[str(dev)] = (float(loss), {k: v.cpu() for k, v in g.items()},
                         {k: p.detach().cpu() for k, p in m.named_parameters()},
                         ops.launch_counts()["lowrank_linear"],
                         ops.backward_launch_counts()["lowrank_linear"])
    (l0, g0, p0, *_), (l1, g1, p1, fwd, bwd) = out["cpu"], out[str(cuda)]
    assert fwd == 14 + bwd and 0 < bwd <= 14
    assert abs(l1 - l0) <= 1e-4 * abs(l0)
    assert sorted(g1) == sorted(g0) == sorted(k for k, v in mask.items() if v)
    for k in g0:
        _close(g1[k], g0[k], 1e-4)
    for k in p0:
        _close(p1[k], p0[k], 1e-4)


# ---------------------------------------------------------------------------
# qwen2-vl: the per-request prefill of vision requests under CUDA graphs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vlm_model():
    """qwen2-vl SMOKE (projections x3, random norm scales) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    model = build_model(get_smoke_config("qwen2_vl_2b"), device="cpu").init(
        torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Linear):
                mod.w.mul_(3.0)
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    return model.to(torch.device("cuda"))


def _vlm_trace(cfg, n=6, seed=4):
    """Staggered prompts of 4-16 tokens, 8-12 new, every second request
    with an N(0, 1) vision prefix (1, n_vision_tokens, d_model)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        prompt = rng.randint(0, cfg.vocab_size, (rng.randint(4, 17),))
        new = int(rng.randint(8, 13))
        vis = None
        if i % 2 == 0:
            vis = {"vision_embeds": rng.standard_normal(
                (1, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)}
        out.append((prompt, new, vis))
    return out


@pytest.mark.cuda
def test_engine_cuda_vision_requests_graphs_match_eager(vlm_model):
    """Vision requests (per-request prefill, eager, through the flash
    kernel) among text requests over a pool that preempts a vision request:
    graphs give the eager engine's greedy tokens, 0 post-warmup captures,
    and the fixed-batch engine the continuous engine's tokens."""
    cfg = vlm_model.cfg
    trace = _vlm_trace(cfg)
    knobs = dict(block_size=4, num_blocks=14, max_running=3, bucket_sizes=(1, 2, 3))
    runs = []
    for graphs in (True, False):
        eng = ContinuousEngine(vlm_model, cuda_graphs=graphs, **knobs)
        if graphs:
            eng.warmup(max_len=max(len(p) + n + (cfg.n_vision_tokens if v else 0)
                                   for p, n, v in trace))
        ops.reset_launch_counts()
        for prompt, new, vis in trace:
            eng.submit(prompt, new, extras=vis)
            eng.step()
        eng.run()
        torch.cuda.synchronize()
        runs.append(({r.req_id: list(r.out_tokens) for r in eng.finished},
                     eng.metrics(), eng.request_prefills,
                     ops.eager_launch_counts()["flash_attention"]))
        eng.release_graphs()
    (toks, m, prefills, flash), (ref_toks, rm, _, _) = runs
    assert toks == ref_toks and len(toks) == len(trace)
    assert m["post_warmup_compiles"] == 0 and m["preemptions"] == rm["preemptions"]
    assert prefills >= 3 and flash == prefills * cfg.n_layers
    prompts = np.stack([p[:4] for p, _, _ in trace[:2]])
    vis = np.concatenate([trace[0][2]["vision_embeds"]] * 2)
    from repro_torch.serve import ServeEngine
    fixed = ServeEngine(vlm_model).generate(prompts, 6, extras={"vision_embeds": vis})
    cont = ContinuousEngine(vlm_model, **knobs)
    np.testing.assert_array_equal(
        cont.generate(prompts, 6, extras={"vision_embeds": vis}), fixed)
