"""Port kernels vs the JAX package's kernels, on the CPU.

The port's plain PyTorch versions (what its wrappers run on CPU tensors) are
held against the JAX Pallas kernels in interpret mode and against the JAX
plain references, on the same numpy inputs, over the sweeps of
tests/test_kernels.py, tests/test_paged_attention.py and
tests/test_chunked_prefill.py. The CUDA kernels themselves run only on a
GPU: tests/test_torch_cuda.py compares each with its plain version there.

Tolerances: lowrank_linear rtol/atol 1e-4 (fp32, as tests/test_kernels.py);
paged/chunked attention rtol/atol 2e-5 (fp32 softmax over <= 32 keys, as the
JAX package's own oracle tests), also for the split/combine plain version of
chunked prefill (the same softmax, rescaled per split); flash attention
rtol/atol 2e-5 (fp32 softmax over <= 100 keys); gram_accum rtol 1e-5 with
atol 1e-5·max|G| (fp32 sums of <= 300 products, taken in another order).

The launch plans of the kernels (lowrank_linear's kernel choice and
split-K chunks, chunked_prefill's key-range splits, paged_attention's page
splits and their workspace sizes, gram_accum's tile edge, flash_attention's
row tiles and their key ranges) are Python, and are checked here too, with
the plain versions of the split kernels (``*_split_ref``) held against the
JAX kernels for every split count, and the plain version of the flash
kernel's tiling (``flash_attention_tiled_ref``: online softmax, P rounded to
bf16 for bf16) against the JAX kernel in both dtypes (bf16 within 2e-2 of
max(1, max|ref|)).
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.chunked_prefill import chunked_prefill_ref as j_cp_ref
from repro.kernels.paged_attention import paged_attention_ref as j_pa_ref
from repro_torch.kernels import chunked_prefill as tcp
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gram_accum as tga
from repro_torch.kernels import lowrank_linear as tll
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ops as tops
from repro_torch.kernels.chunked_prefill import (chunked_prefill_ref,
                                                 chunked_prefill_split_ref)
from repro_torch.kernels.paged_attention import (paged_attention_ref,
                                                 paged_attention_split_ref)
from repro_torch.kernels.ref import (flash_attention_ref, gram_accum_ref,
                                     lowrank_linear_ref)

torch.set_num_threads(1)


def _randn(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# lowrank_linear
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_shape,d_in,r,d_out,bm,bn", [
    ((2, 32, 256), 256, 128, 256, 64, 128),      # tests/test_kernels.py:32-39
    ((64, 128), 128, 32, 128, 32, 64),
    ((16, 96), 96, 48, 64, 16, 64),
])
def test_lowrank_linear_matches_jax(x_shape, d_in, r, d_out, bm, bn):
    x, bt, at = (_randn(0, x_shape), _randn(1, (d_in, r)), _randn(2, (r, d_out)))
    want = np.asarray(jops.lowrank_linear(jnp.asarray(x), jnp.asarray(bt),
                                          jnp.asarray(at), block_m=bm,
                                          block_n=bn))
    want_ref = np.asarray(jref.lowrank_linear_ref(jnp.asarray(x), jnp.asarray(bt),
                                                  jnp.asarray(at)))
    got = tops.lowrank_linear(torch.from_numpy(x), torch.from_numpy(bt),
                              torch.from_numpy(at))
    assert tuple(got.shape) == x_shape[:-1] + (d_out,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-4, atol=1e-4)


def test_cpu_dispatch_is_plain_version():
    x, bt, at = _randn(3, (8, 64)), _randn(4, (64, 16)), _randn(5, (16, 32))
    tx, tb, ta = map(torch.from_numpy, (x, bt, at))
    assert torch.equal(tops.lowrank_linear(tx, tb, ta),
                       lowrank_linear_ref(tx, tb, ta))


LLAMA_LOWRANK = [(2048, 614, 2048), (2048, 245, 512), (2048, 983, 8192),
                 (8192, 983, 2048)]       # llama3_1b projections at ratio 0.6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 128, 256, 300, 4096])
@pytest.mark.parametrize("d_in,r,d_out", LLAMA_LOWRANK + [(1000, 83, 130), (7, 3, 5)])
def test_lowrank_plan_covers_every_k_once(dtype, m, d_in, r, d_out):
    """Each product's split-K chunks are non-empty, cover [0, k) exactly once,
    fit the kernel's K step and bounds, and size the workspace and counters;
    M <= 16 takes the decode kernel."""
    for p, (n, k) in zip(tll.plan(m, d_in, r, d_out, dtype), ((r, d_in), (d_out, r))):
        assert (p.m, p.n, p.k) == (m, n, k)
        assert p.kind == ("decode" if m <= tll.SMALL_M else "prefill")
        bm, bn, bk, _, k_max, s_max, _ = tll.TILES[(p.kind, dtype)]
        assert p.kchunk % bk == 0 and p.kchunk <= k_max
        assert p.splits <= max(s_max, -(-k // k_max))
        assert p.tile == bm
        ranges = p.k_ranges()
        assert len(ranges) == p.splits >= 1
        assert all(lo < hi for lo, hi in ranges)
        covered = np.zeros(k, np.int64)
        for lo, hi in ranges:
            covered[lo:hi] += 1
        assert np.all(covered == 1)
        assert (p.tiles_m, p.tiles_n) == (-(-m // bm), -(-n // bn))
        assert p.workspace == (p.splits * m * n if p.splits > 1 else 0)
        assert p.counters == (p.tiles_m * p.tiles_n if p.splits > 1 else 0)


def test_lowrank_plan_fills_the_card_at_decode():
    """At decode every llama3_1b product of at least 4 MB of fp32 weights
    puts a block on each of the 132 SMs, and the fp32 decode kernel's x
    slice stays within 512 k."""
    for d_in, r, d_out in LLAMA_LOWRANK:
        for p in tll.plan(8, d_in, r, d_out, torch.float32):
            assert p.kchunk <= 512
            if 4 * p.k * p.n >= 4 << 20:
                assert p.tiles_m * p.tiles_n * p.splits >= 132, p


@pytest.mark.parametrize("fn", ["lowrank_linear", "paged_attention",
                                "chunked_prefill", "flash_attention",
                                "gram_accum"])
def test_unsupported_device_raises(fn):
    """Dispatch goes by device: anything but cpu/cuda raises, never falls back."""
    m = torch.empty((4, 2, 8), device="meta")
    m4 = torch.empty((1, 4, 2, 16), device="meta")
    args = {"lowrank_linear": (m, torch.empty((8, 4), device="meta"),
                               torch.empty((4, 8), device="meta")),
            "paged_attention": (m, m, m, m, m),
            "chunked_prefill": (m, m, m, m, m, m),
            "flash_attention": (m4, m4, m4),
            "gram_accum": (torch.empty((16, 8), device="meta"),)}[fn]
    with pytest.raises(ValueError):
        getattr(tops, fn)(*args)


# ---------------------------------------------------------------------------
# paged_attention
# ---------------------------------------------------------------------------

def _paged_case(seed, *, b, hq, hkv, hd, bs, num_blocks, lengths):
    q = _randn(seed, (b, hq, hd))
    kp = _randn(seed + 1, (num_blocks, bs, hkv, hd))
    vp = _randn(seed + 2, (num_blocks, bs, hkv, hd))
    nb = max(-(-max(lengths, default=1) // bs), 1)
    tables = np.zeros((b, nb), np.int32)
    nxt = 1
    for i, ln in enumerate(lengths):
        for j in range(-(-ln // bs)):
            tables[i, j] = nxt
            nxt += 1
    assert nxt <= num_blocks
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


PAGED_CASES = [
    # (hq, hkv, lengths, bs, cap, window) — tests/test_paged_attention.py:68-76
    (4, 2, [5, 12, 1], 4, 0.0, 0),
    (3, 1, [8, 3], 4, 0.0, 0),
    (2, 2, [7, 16, 9, 2], 8, 0.0, 0),
    (4, 2, [20, 11], 4, 50.0, 0),
    (4, 2, [20, 6, 13], 4, 0.0, 8),
    (4, 2, [19, 5], 4, 30.0, 6),
    (4, 2, [6, 0, 0], 4, 0.0, 0),          # zero-length (padding) rows
]


def _paged_both(case, cap, window):
    q, kp, vp, tables, lens = case
    jargs = tuple(map(jnp.asarray, case))
    want = np.asarray(jops.paged_attention(*jargs, cap=cap, window=window,
                                           impl="pallas"))
    want_ref = np.asarray(j_pa_ref(*jargs, cap=cap, window=window))
    got = tops.paged_attention(*map(torch.from_numpy, case), cap=cap,
                               window=window).numpy()
    return got, want, want_ref


@pytest.mark.parametrize("hq,hkv,lengths,bs,cap,window", PAGED_CASES)
def test_paged_attention_matches_jax(hq, hkv, lengths, bs, cap, window):
    case = _paged_case(0, b=len(lengths), hq=hq, hkv=hkv, hd=16, bs=bs,
                       num_blocks=16, lengths=lengths)
    got, want, want_ref = _paged_both(case, cap, window)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want_ref, rtol=2e-5, atol=2e-5)
    for i, ln in enumerate(lengths):
        if ln == 0:
            np.testing.assert_array_equal(got[i], 0.0)
    assert np.all(np.isfinite(got))


def test_paged_attention_trash_page_poison():
    """Rows whose tables are padded with page 0 must not read it."""
    q, kp, vp, tables, lens = _paged_case(2, b=2, hq=2, hkv=1, hd=8, bs=4,
                                          num_blocks=8, lengths=[3, 11])
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0], vp2[0] = 1e4, 1e4
    a = paged_attention_ref(*map(torch.from_numpy, (q, kp, vp, tables, lens)))
    b = paged_attention_ref(*map(torch.from_numpy, (q, kp2, vp2, tables, lens)))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
    want = np.asarray(jops.paged_attention(
        *map(jnp.asarray, (q, kp2, vp2, tables, lens)), impl="pallas"))
    np.testing.assert_allclose(b.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.fixture
def fresh_paged_plan():
    """Plans are cached: clear the cache around a test that moves the
    module's split target."""
    tpa.plan.cache_clear()
    yield
    tpa.plan.cache_clear()


PAGED_SPLIT_CASES = PAGED_CASES + [
    # (hq, hkv, lengths, bs, cap, window)
    (8, 1, [30, 7, 0, 16], 4, 0.0, 0),       # GQA 8, a row ending mid-page
    (8, 8, [13, 29], 4, 0.0, 0),             # GQA 1
    (8, 2, [29, 17, 1, 0], 4, 20.0, 9),      # GQA 4, window + softcap
    (4, 2, [31, 3], 4, 0.0, 13),             # window across split boundaries
    (4, 2, [0, 0], 4, 0.0, 0),               # every row zero-length
    (2, 1, [22, 11], 3, 0.0, 5),             # bs 3
]
# splits: the plan's own (None), then 1, 2, 3 and one page per split, set
# through TARGET_BLOCKS
PAGED_SPLIT_COUNTS = (None, 1, 2, 3, 64)


@pytest.mark.parametrize("hq,hkv,lengths,bs,cap,window", PAGED_SPLIT_CASES)
def test_paged_attention_split_matches_jax(monkeypatch, fresh_paged_plan, hq, hkv,
                                           lengths, bs, cap, window):
    """The split/combine plain version (the CUDA kernel's algorithm) against
    the unsplit plain version and the JAX kernel (interpret mode) and plain
    reference, for every split count; zero-length rows stay exactly zero."""
    case = _paged_case(0, b=len(lengths), hq=hq, hkv=hkv, hd=16, bs=bs,
                       num_blocks=32, lengths=lengths)
    got0, want, want_ref = _paged_both(case, cap, window)
    targs = tuple(map(torch.from_numpy, case))
    nb = case[3].shape[1]
    for splits in PAGED_SPLIT_COUNTS:
        target = tpa.TARGET_BLOCKS if splits is None else splits * len(lengths) * hkv
        monkeypatch.setattr(tpa, "TARGET_BLOCKS", target)
        tpa.plan.cache_clear()
        p = tpa.plan(len(lengths), hq, hkv, 16, nb)
        if splits is not None:
            assert p.splits == -(-nb // -(-nb // min(splits, nb)))
        got = paged_attention_split_ref(*targs, cap=cap, window=window).numpy()
        np.testing.assert_allclose(got, got0, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, want_ref, rtol=2e-5, atol=2e-5)
        for i, ln in enumerate(lengths):
            if ln == 0:
                np.testing.assert_array_equal(got[i], 0.0)
        assert np.all(np.isfinite(got))


@pytest.mark.parametrize("splits", PAGED_SPLIT_COUNTS)
def test_paged_attention_split_trash_page_poison(monkeypatch, fresh_paged_plan, splits):
    """Filling the trash page 0 with 1e4 changes no row of the split plain
    version, and it still matches the JAX kernel on the clean pages."""
    case = _paged_case(4, b=3, hq=4, hkv=2, hd=16, bs=4, num_blocks=16,
                       lengths=[13, 0, 6])
    q, kp, vp, tables, lens = case
    if splits is not None:
        monkeypatch.setattr(tpa, "TARGET_BLOCKS", splits * 3 * 2)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0], vp2[0] = 1e4, 1e4
    clean = paged_attention_split_ref(*map(torch.from_numpy, case)).numpy()
    poisoned = paged_attention_split_ref(
        *map(torch.from_numpy, (q, kp2, vp2, tables, lens))).numpy()
    np.testing.assert_allclose(poisoned, clean, rtol=1e-6)
    want = np.asarray(jops.paged_attention(*map(jnp.asarray, case), impl="pallas"))
    np.testing.assert_allclose(poisoned, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(poisoned[1], 0.0)


@pytest.mark.parametrize("b,hq,hkv,hd,nb", [
    (8, 32, 8, 64, 12),       # the serve path's decode (tables of 12 pages)
    (8, 32, 8, 64, 16),       # the same, tables padded to a power of two
    (8, 32, 8, 64, 128),      # rows of 2048 keys
    (1, 32, 8, 64, 1), (3, 4, 2, 16, 7), (64, 32, 8, 64, 256), (2, 8, 1, 128, 1000),
])
def test_paged_plan_covers_every_page_once(b, hq, hkv, hd, nb):
    """The page splits cover every page of the table exactly once and none is
    empty; the workspace holds (m, l, acc) of every (split, row, query head)
    exactly when the pages are split."""
    p = tpa.plan(b, hq, hkv, hd, nb)
    ranges = p.page_ranges()
    assert len(ranges) == p.splits >= 1
    assert all(lo < hi for lo, hi in ranges)
    covered = np.zeros(nb, np.int64)
    for lo, hi in ranges:
        covered[lo:hi] += 1
    assert np.all(covered == 1)
    assert p.workspace == (p.splits * b * hq * (hd + 2) if p.splits > 1 else 0)
    blocks = b * hkv * p.splits
    if b * hkv >= tpa.TARGET_BLOCKS or nb == 1:
        assert p.splits == 1 and p.workspace == 0
    elif nb >= 8:
        # 2-4 blocks per SM of 132 where the table has pages to split
        assert 2 * 132 <= blocks <= 4 * 132, blocks


# ---------------------------------------------------------------------------
# chunked_prefill
# ---------------------------------------------------------------------------

def _chunked_case(seed, *, b, hq, hkv, hd, bs, num_blocks, starts, lens):
    lq = max(max(lens), 1)
    q = _randn(seed, (b, lq, hq, hd))
    kp = _randn(seed + 1, (num_blocks, bs, hkv, hd))
    vp = _randn(seed + 2, (num_blocks, bs, hkv, hd))
    totals = [s + l for s, l in zip(starts, lens)]
    nb = max(max(-(-t // bs) for t in totals), 1)
    tables = np.zeros((b, nb), np.int32)
    nxt = 1
    for i, t in enumerate(totals):
        for j in range(-(-t // bs)):
            tables[i, j] = nxt
            nxt += 1
    assert nxt <= num_blocks
    return (q, kp, vp, tables, np.asarray(starts, np.int32),
            np.asarray(lens, np.int32))


CHUNKED_CASES = [
    # (hq, hkv, starts, lens, bs, cap, window) — tests/test_chunked_prefill.py:78-86
    (4, 2, [0, 8, 4], [5, 7, 1], 4, 0.0, 0),
    (3, 1, [12, 0], [3, 9], 4, 0.0, 0),
    (2, 2, [8, 0, 16], [8, 2, 5], 8, 0.0, 0),
    (4, 2, [8, 4], [6, 9], 4, 50.0, 0),
    (4, 2, [16, 0, 8], [5, 11, 3], 4, 0.0, 6),
    (4, 2, [12, 4], [7, 2], 4, 30.0, 5),
    (4, 2, [4, 0, 8], [6, 0, 0], 4, 0.0, 0),     # zero-length rows, start > 0
]


@pytest.mark.parametrize("hq,hkv,starts,lens,bs,cap,window", CHUNKED_CASES)
def test_chunked_prefill_matches_jax(hq, hkv, starts, lens, bs, cap, window):
    case = _chunked_case(0, b=len(starts), hq=hq, hkv=hkv, hd=16, bs=bs,
                         num_blocks=24, starts=starts, lens=lens)
    jargs = tuple(map(jnp.asarray, case))
    want = np.asarray(jops.chunked_prefill(*jargs, cap=cap, window=window,
                                           block_q=4, impl="pallas"))
    want_ref = np.asarray(j_cp_ref(*jargs, cap=cap, window=window))
    got = tops.chunked_prefill(*map(torch.from_numpy, case), cap=cap,
                               window=window).numpy()
    for i, ln in enumerate(lens):
        np.testing.assert_allclose(got[i, :ln], want[i, :ln], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got[i, :ln], want_ref[i, :ln], rtol=2e-5,
                                   atol=2e-5)
        # padded query rows (bucket padding past lens) are exactly zero
        np.testing.assert_array_equal(got[i, ln:], 0.0)
    assert np.all(np.isfinite(got))


def test_chunked_prefill_trash_page_poison():
    case = _chunked_case(2, b=2, hq=2, hkv=1, hd=8, bs=4, num_blocks=12,
                         starts=[0, 8], lens=[3, 6])
    q, kp, vp, tables, st, ln = case
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0], vp2[0] = 1e4, 1e4
    a = chunked_prefill_ref(*map(torch.from_numpy, case)).numpy()
    b = chunked_prefill_ref(*map(torch.from_numpy,
                                 (q, kp2, vp2, tables, st, ln))).numpy()
    for i, n in enumerate(ln):
        np.testing.assert_allclose(a[i, :n], b[i, :n], rtol=1e-6)


SPLIT_CASES = CHUNKED_CASES + [
    # (hq, hkv, starts, lens, bs, cap, window)
    (4, 2, [20, 0, 30], [9, 0, 6], 4, 0.0, 3),   # window empties whole splits
    (4, 2, [0, 0], [0, 0], 4, 0.0, 0),           # every row zero-length
    (2, 1, [13, 2], [11, 5], 3, 20.0, 0),        # bs 3 divides no key tile
]
# (rows, keys) tile sizes: the kernel's, then small ones that give many
# row tiles and splits at these sizes
SPLIT_TILES = [(tcp.ROWS, tcp.KEYS), (8, 4), (4, 8), (6, 5)]
# splits per row tile: the plan's own (None), then 1, 2, 3 and as many as
# there are key tiles, set through TARGET_BLOCKS
SPLIT_COUNTS = (None, 1, 2, 3, 64)


@pytest.mark.parametrize("hq,hkv,starts,lens,bs,cap,window", SPLIT_CASES)
def test_chunked_prefill_split_matches_jax(monkeypatch, hq, hkv, starts, lens,
                                           bs, cap, window):
    """The split/combine plain version (the CUDA kernel's algorithm) against
    the unsplit plain version and the JAX kernel (interpret mode) and plain
    reference, for every split count and tile size; padded queries and
    zero-length rows stay exactly zero."""
    case = _chunked_case(0, b=len(starts), hq=hq, hkv=hkv, hd=16, bs=bs,
                         num_blocks=32, starts=starts, lens=lens)
    jargs = tuple(map(jnp.asarray, case))
    want = np.asarray(jops.chunked_prefill(*jargs, cap=cap, window=window,
                                           block_q=4, impl="pallas"))
    want_ref = np.asarray(j_cp_ref(*jargs, cap=cap, window=window))
    targs = tuple(map(torch.from_numpy, case))
    unsplit = chunked_prefill_ref(*targs, cap=cap, window=window).numpy()
    lq = case[0].shape[1]
    target = tcp.TARGET_BLOCKS
    for rows, keys in SPLIT_TILES:
        monkeypatch.setattr(tcp, "ROWS", rows)
        monkeypatch.setattr(tcp, "KEYS", keys)
        base = len(starts) * hkv * -(-lq * (hq // hkv) // rows)
        for splits in SPLIT_COUNTS:
            monkeypatch.setattr(tcp, "TARGET_BLOCKS",
                                target if splits is None else splits * base)
            p = tcp.plan(len(starts), lq, hq, hkv, 16, bs, case[3].shape[1])
            if splits is not None:
                assert p.splits == -(-p.key_tiles // -(-p.key_tiles // splits))
            got = chunked_prefill_split_ref(*targs, cap=cap,
                                            window=window).numpy()
            np.testing.assert_allclose(got, unsplit, rtol=2e-5, atol=2e-5)
            for i, ln in enumerate(lens):
                np.testing.assert_allclose(got[i, :ln], want[i, :ln], rtol=2e-5,
                                           atol=2e-5)
                np.testing.assert_allclose(got[i, :ln], want_ref[i, :ln],
                                           rtol=2e-5, atol=2e-5)
                np.testing.assert_array_equal(got[i, ln:], 0.0)
            assert np.all(np.isfinite(got))


@pytest.mark.parametrize("b,lq,hq,hkv,hd,bs,nb", [
    (1, 256, 32, 8, 64, 16, 16),      # the serve path's largest prefill
    (8, 64, 32, 8, 64, 16, 20), (3, 40, 4, 2, 16, 4, 30), (2, 7, 3, 1, 16, 12, 5),
    (16, 256, 32, 8, 128, 16, 64), (1, 1, 8, 8, 32, 16, 1),
])
def test_chunked_plan_splits_cover_every_key_tile(b, lq, hq, hkv, hd, bs, nb):
    """The key-range splits cover every key tile exactly once and none is
    empty; the workspace holds (m, l, acc) of every (split, row, KV head,
    query row) exactly when the keys are split."""
    p = tcp.plan(b, lq, hq, hkv, hd, bs, nb)
    assert p.row_tiles == -(-lq * (hq // hkv) // tcp.ROWS)
    assert p.key_tiles == -(-nb * bs // tcp.KEYS)
    ranges = p.key_tile_ranges()
    assert len(ranges) == p.splits >= 1
    assert all(lo < hi for lo, hi in ranges)
    covered = np.zeros(p.key_tiles, np.int64)
    for lo, hi in ranges:
        covered[lo:hi] += 1
    assert np.all(covered == 1)
    want_ws = p.splits * b * hkv * p.row_tiles * tcp.ROWS * (hd + 2)
    assert p.workspace == (want_ws if p.splits > 1 else 0)
    if b * hkv * p.row_tiles < tcp.TARGET_BLOCKS:   # too few blocks: split
        assert p.splits == min(p.key_tiles, -(-tcp.TARGET_BLOCKS //
                                              (b * hkv * p.row_tiles))) or p.per > 1


@pytest.mark.parametrize("window", [0, 1, 3, 9])
@pytest.mark.parametrize("g", [1, 3, 4])
def test_chunked_live_key_tiles_are_exactly_the_attended_ones(monkeypatch, window, g):
    """[lo, hi] of each row tile is exactly the set of key tiles holding a
    (valid query, key) pair the masks keep, and lo > hi for tiles with none."""
    rows, keys, lq, n_keys = 8, 4, 13, 40
    monkeypatch.setattr(tcp, "ROWS", rows)
    monkeypatch.setattr(tcp, "KEYS", keys)
    starts = torch.tensor([0, 5, 20, 3, 0])
    lens = torch.tensor([13, 7, 2, 0, 20])        # the last exceeds lq
    for rt in range(-(-lq * g // rows)):
        lo, hi = tcp.live_key_tiles(rt, starts, lens, lq, g, window, n_keys)
        for i in range(len(starts)):
            attended = set()
            for r in range(rt * rows, min(lq * g, (rt + 1) * rows)):
                j = r // g
                if j >= min(lq, int(lens[i])):
                    continue
                iq = int(starts[i]) + j
                for ik in range(min(iq + 1, n_keys)):
                    if window == 0 or iq - ik < window:
                        attended.add(ik // keys)
            want = set(range(int(lo[i]), int(hi[i]) + 1))
            assert attended == want, (rt, i, attended, want)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (b, t, hq, hkv, hd, cap, block) — tests/test_kernels.py:63-98 at small T
    (1, 64, 4, 4, 16, 0.0, 32),          # MHA, 2 x 2 blocks
    (2, 64, 4, 2, 16, 0.0, 16),          # GQA 2:1, 4 x 4 blocks
    (1, 64, 4, 1, 32, 0.0, 32),          # MQA
    (1, 48, 4, 2, 16, 20.0, 16),         # softcap
    (2, 100, 4, 2, 16, 0.0, 32),         # ragged T: JAX falls back to its oracle
    (1, 37, 8, 2, 16, 30.0, 16),         # ragged T, G 4, softcap
]


@pytest.mark.parametrize("b,t,hq,hkv,hd,cap,block", FLASH_CASES)
def test_flash_attention_matches_jax(b, t, hq, hkv, hd, cap, block):
    q, k, v = (_randn(8, (b, t, hq, hd)), _randn(9, (b, t, hkv, hd)),
               _randn(10, (b, t, hkv, hd)))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = np.asarray(jops.flash_attention(jq, jk, jv, cap=cap, block_q=block,
                                           block_k=block))
    want_ref = np.asarray(jref.flash_attention_ref(jq, jk, jv, cap=cap))
    got = tops.flash_attention(*map(torch.from_numpy, (q, k, v)), cap=cap)
    assert tuple(got.shape) == (b, t, hq, hd)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=2e-5, atol=2e-5)


# the tiled version's cases: FLASH_CASES in both dtypes, plus G 8 and hd 128
# (T a multiple of the JAX blocks, so the Pallas kernel runs, not its oracle)
FLASH_TILED_CASES = FLASH_CASES + [
    (1, 96, 16, 2, 16, 0.0, 32),         # G 8, two row tiles
    (1, 128, 4, 2, 128, 10.0, 64),       # hd 128, softcap, two key tiles
    (2, 200, 8, 2, 16, 0.0, 40),         # G 4, 13 row tiles over 4 key tiles
    (1, 96, 4, 4, 48, 0.0, 32),          # MLA SMOKE's head dim (nope + rope)
    (1, 64, 2, 2, 192, 0.0, 32),         # MLA's full head dim
]


@pytest.fixture(params=["planned", "wide"])
def flash_rows(request, monkeypatch):
    """The plan as it is (the tests' small grids take THIN_ROWS), or with
    FILL_BLOCKS 0, so every head size of WIDE_HEAD_DIMS takes ROWS."""
    if request.param == "wide":
        monkeypatch.setattr(tfa, "FILL_BLOCKS", 0)
    tfa.plan.cache_clear()
    yield request.param
    tfa.plan.cache_clear()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,hq,hkv,hd,cap,block", FLASH_TILED_CASES)
def test_flash_attention_tiled_matches_jax(flash_rows, b, t, hq, hkv, hd, cap, block, dtype):
    """The plain version of the kernel's tiling (the plan's row tiles, their
    live key tiles, the online softmax, P rounded to bf16 for bf16) against
    the Pallas kernel in interpret mode (its oracle where T is ragged) and
    against flash_attention_ref: fp32 within 2e-5, bf16 within 2e-2 of
    max(1, max|ref|) (bf16 output and P roundings)."""
    q, k, v = (_randn(8, (b, t, hq, hd)), _randn(9, (b, t, hkv, hd)),
               _randn(10, (b, t, hkv, hd)))
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    got = tfa.flash_attention_tiled_ref(tq, tk, tv, cap=cap)
    assert got.dtype == dtype and tuple(got.shape) == (b, t, hq, hd)
    want = np.asarray(jops.flash_attention(jq, jk, jv, cap=cap, block_q=block,
                                           block_k=block).astype(jnp.float32))
    want_ref = flash_attention_ref(tq, tk, tv, cap=cap).float().numpy()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for w in (want, want_ref):
        err = np.abs(got.float().numpy() - w).max()
        assert err <= tol * max(1.0, np.abs(w).max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,hq,hkv,hd", [
    (2, 64, 32, 8, 64), (1, 1, 4, 4, 16), (3, 37, 8, 1, 32), (2, 100, 16, 2, 128),
    (1, 257, 4, 4, 64), (2, 17, 24, 3, 16)])
def test_flash_plan_covers_every_row_once(flash_rows, b, t, hq, hkv, hd, dtype):
    """Walking the grid in launch order, the blocks' row tiles cover every
    (batch, query, head) exactly once, the longest diagonal first."""
    p = tfa.plan(b, t, hq, hkv, hd, dtype)
    g = hq // hkv
    assert p.rows in (tfa.ROWS, tfa.THIN_ROWS) and p.blocks == b * hkv * p.row_tiles
    seen = collections.Counter()
    tiles = []
    for x in range(p.blocks):
        rt, bi, hk = tfa.block_tile(p, x, hkv)
        assert 0 <= rt < p.row_tiles and 0 <= bi < b and 0 <= hk < hkv
        tiles.append(rt)
        for r in range(rt * p.rows, min(t * g, (rt + 1) * p.rows)):
            seen[(bi, r // g, hk * g + r % g)] += 1
    assert tiles == sorted(tiles, reverse=True)
    assert set(seen) == {(bi, j, h) for bi in range(b) for j in range(t)
                         for h in range(hq)}
    assert set(seen.values()) == {1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 48, 64, 128, 192])
@pytest.mark.parametrize("g", [1, 4, 8])
def test_flash_live_keys_reach_the_diagonal(flash_rows, dtype, hd, g):
    """Each row tile's key tiles are exactly those holding a key that one of
    its rows attends, and the last is computed up to its last such key and
    no further: ragged T, T 1 and T across many key tiles."""
    for t in (1, 2, 37, 64, 65, 100, 128, 300):
        p = tfa.plan(1, t, 8 * g, 8, hd, dtype)
        for rt in range(p.row_tiles):
            rows = range(rt * p.rows, min(t * g, (rt + 1) * p.rows))
            attended = {ik for r in rows for ik in range(r // g + 1)}
            n_kt, kc = tfa.live_keys(rt, t, g, p.rows)
            assert set(range(n_kt)) == {ik // tfa.KEYS for ik in attended}
            assert 1 <= kc <= tfa.KEYS
            assert (n_kt - 1) * tfa.KEYS + kc - 1 == max(attended)


@pytest.mark.parametrize("b,t,hq,hkv,hd,rows", [
    (8, 64, 32, 8, 64, 64),        # compress path: 128-row tiles would make 128 blocks
    (8, 256, 32, 8, 64, 128),      # serve calibration: 512 blocks of 128 rows
    (1, 4096, 32, 8, 64, 128),
    (2, 100, 16, 4, 16, 64),       # thin grid
    (8, 4096, 32, 8, 128, 64),     # hd 128: 64 rows at any size
    (8, 4096, 16, 16, 192, 64),    # MLA's hd 192 and SMOKE's hd 48: the same
    (8, 4096, 4, 4, 48, 64),
])
def test_flash_plan_rows(b, t, hq, hkv, hd, rows):
    """128-row tiles at hd 16, 32 and 64 where they fill the card with two
    blocks per SM, else 64-row tiles; the same choice in both dtypes. A head
    size or dtype without a tile raises."""
    for dtype in (torch.float32, torch.bfloat16):
        p = tfa.plan(b, t, hq, hkv, hd, dtype)
        assert p.rows == rows
        assert p.row_tiles == -(-t * (hq // hkv) // rows)
    with pytest.raises(ValueError):
        tfa.plan(b, t, hq, hkv, 40, torch.float32)
    with pytest.raises(ValueError):
        tfa.plan(b, t, hq, hkv, hd, torch.float16)


def test_flash_attention_is_causal_and_scaled():
    """Row i ignores keys after i; an explicit scale is honoured."""
    q, k, v = (torch.from_numpy(_randn(s, (1, 12, 2, 16))) for s in (1, 2, 3))
    a = flash_attention_ref(q, k, v, scale=0.3)
    k2, v2 = k.clone(), v.clone()
    k2[:, 6:], v2[:, 6:] = 100.0, -100.0
    b = flash_attention_ref(q, k2, v2, scale=0.3)
    torch.testing.assert_close(a[:, :6], b[:, :6], rtol=0, atol=0)
    want = np.asarray(jref.flash_attention_ref(*map(jnp.asarray, (q.numpy(),
                                                                   k.numpy(),
                                                                   v.numpy())),
                                               scale=0.3))
    np.testing.assert_allclose(a.numpy(), want, rtol=2e-5, atol=2e-5)


def test_flash_attention_refuses_autograd():
    """The kernel has no backward: inputs that need a gradient raise, on
    every device, instead of taking a silent wrong gradient."""
    q = torch.from_numpy(_randn(1, (1, 8, 2, 16))).requires_grad_()
    k = torch.from_numpy(_randn(2, (1, 8, 2, 16)))
    with pytest.raises(RuntimeError, match="no backward"):
        tops.flash_attention(q, k, k)
    with torch.no_grad():
        out = tops.flash_attention(q, k, k)
    assert not out.requires_grad


# ---------------------------------------------------------------------------
# gram_accum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,bi,bk", [
    (256, 64, 32, 64),        # tiled: 2 x 2 x 4 grid
    (128, 96, 32, 128),
    (100, 96, 32, 64),        # ragged k: JAX falls back to a.T @ a
    (300, 40, 32, 128),       # ragged k and n
])
def test_gram_accum_matches_jax(k, n, bi, bk, dtype):
    """bf16 inputs are held against the JAX kernel on the same values in
    fp32 (bf16 converts to fp32 exactly, and both accumulate in fp32)."""
    a = torch.from_numpy(_randn(6, (k, n))).to(dtype)
    want = np.asarray(jops.gram_accum(jnp.asarray(a.float().numpy()), block_i=bi,
                                      block_j=bi, block_k=bk))
    got = tops.gram_accum(a)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, n)
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=tol)
    np.testing.assert_allclose(got.numpy(), got.numpy().T, rtol=0, atol=tol)


def test_gram_accum_chunked_sum_matches_jax():
    """Summing per-chunk Grams (what Calibrator.record does across records)
    equals the Gram of the whole matrix, as in tests/test_kernels.py:54-59."""
    a = _randn(7, (1024, 64))
    got = sum(tops.gram_accum(torch.from_numpy(a[i:i + 256]))
              for i in range(0, 1024, 256))
    want = np.asarray(sum(jops.gram_accum(jnp.asarray(a[i:i + 256]), block_k=128)
                          for i in range(0, 1024, 256)))
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=tol)
    whole = gram_accum_ref([torch.from_numpy(a)]).numpy()
    np.testing.assert_allclose(got.numpy(), whole, rtol=1e-5, atol=tol)
    want_ref = np.asarray(jref.gram_accum_ref([jnp.asarray(a)]))
    np.testing.assert_allclose(whole, want_ref, rtol=1e-5, atol=tol)


@pytest.mark.parametrize("n,tile", [
    (2048, 64), (8192, 128),      # the calibration records
    (1000, 64), (64, 64), (130, 64), (1, 64),
    (2047, 64), (2049, 128), (4096, 128), (10000, 128),
])
def test_gram_plan_tile(n, tile):
    """The 64-tile where its tiles fit the card's resident slots in one
    round, else the 128-tile: at n = 2048 the 528 tiles of 64 fill every
    slot exactly; at n = 8192 the 2080 tiles of 128 are taken."""
    assert tga.plan(n) == tile
    if n == 2048:
        assert tga.tiles(n, 64) == tga.SMS * tga.SMALL_PER_SM
    if n == 8192:
        assert tga.tiles(n, 128) == 2080
