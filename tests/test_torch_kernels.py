"""Port kernels vs the JAX package's kernels, on the CPU.

The port's plain PyTorch versions (what its wrappers run on CPU tensors) are
held against the JAX Pallas kernels in interpret mode and against the JAX
plain references, on the same numpy inputs, over the sweeps of
tests/test_kernels.py, tests/test_paged_attention.py and
tests/test_chunked_prefill.py. The CUDA kernels themselves run only on a
GPU: tests/test_torch_cuda.py compares each with its plain version there.

Tolerances: lowrank_linear rtol/atol 1e-4 (fp32, as tests/test_kernels.py);
paged/chunked attention rtol/atol 2e-5 (fp32 softmax over <= 32 keys, as the
JAX package's own oracle tests); flash attention rtol/atol 2e-5 (fp32
softmax over <= 100 keys); gram_accum rtol 1e-5 with atol 1e-5·max|G| (fp32
sums of <= 300 products, taken in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.chunked_prefill import chunked_prefill_ref as j_cp_ref
from repro.kernels.paged_attention import paged_attention_ref as j_pa_ref
from repro_torch.kernels import ops as tops
from repro_torch.kernels.chunked_prefill import chunked_prefill_ref
from repro_torch.kernels.paged_attention import paged_attention_ref
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

@pytest.mark.parametrize("k,n,bi,bk", [
    (256, 64, 32, 64),        # tiled: 2 x 2 x 4 grid
    (128, 96, 32, 128),
    (100, 96, 32, 64),        # ragged k: JAX falls back to a.T @ a
    (300, 40, 32, 128),       # ragged k and n
])
def test_gram_accum_matches_jax(k, n, bi, bk):
    a = _randn(6, (k, n))
    want = np.asarray(jops.gram_accum(jnp.asarray(a), block_i=bi, block_j=bi,
                                      block_k=bk))
    got = tops.gram_accum(torch.from_numpy(a))
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
