"""Port kernels vs the JAX package's kernels, on the CPU.

The port's plain PyTorch versions (what its wrappers run on CPU tensors) are
held against the JAX Pallas kernels in interpret mode and against the JAX
plain references, on the same numpy inputs, over the sweeps of
tests/test_kernels.py, tests/test_paged_attention.py and
tests/test_chunked_prefill.py. The CUDA kernels themselves run only on a
GPU: tests/test_torch_cuda.py compares each with its plain version there.

Tolerances: lowrank_linear rtol/atol 1e-4 (fp32, as tests/test_kernels.py);
paged/chunked attention rtol/atol 2e-5 (fp32 softmax over <= 32 keys, as the
JAX package's own oracle tests).
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
from repro_torch.kernels.ref import lowrank_linear_ref

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
                                "chunked_prefill"])
def test_unsupported_device_raises(fn):
    """Dispatch goes by device: anything but cpu/cuda raises, never falls back."""
    m = torch.empty((4, 2, 8), device="meta")
    args = {"lowrank_linear": (m, torch.empty((8, 4), device="meta"),
                               torch.empty((4, 8), device="meta")),
            "paged_attention": (m, m, m, m, m),
            "chunked_prefill": (m, m, m, m, m, m)}[fn]
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
