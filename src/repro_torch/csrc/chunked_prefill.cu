// Chunked prefill: batched suffix prefill attention over the paged KV pool.
//
// Replaces the Pallas kernel src/repro/kernels/chunked_prefill.py:58-188
// (`_kernel` / `chunked_prefill`): grid (B, Hkv, q_chunks, pages) with the
// page axis sequential and (m, l, acc) for block_q x G queries in VMEM.
//
// What bounds it on the H100: per (row, KV head, query chunk) the live K/V
// pages are read once and 4*hd FLOPs are spent per (query, key) pair; at the
// main path's prompt lengths (16-256 tokens) the work is small and the
// kernel is bound by its fp32 FLOPs on CUDA cores and by latency, not by
// device memory.
//
// Design: one block per (row, KV head, chunk of 16 queries x G heads), with
// the page loop inside the block. Query j of row b sits at global position
// starts[b] + j. The live-page test is the one of chunked_prefill.py:72-79
// (chunk holds a valid query, page below the written length, not wholly
// above the chunk's causal diagonal, not wholly below its window). The
// chunk's queries, one staged K/V page, the scores and the fp32 (m, l, acc)
// live in shared memory. Fully masked query rows take the maximum(m,
// NEG_INF/2) exponent shift (chunked_prefill.py:103) so they contribute
// p = 0; padded queries (j >= lens[b]) and rows with lens == 0 give exact
// zeros. Not yet used: tensor cores for the two small products, TMA.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 16;   // queries per block (times G heads)

size_t smem_floats(int G, int hd, int bs) {
  const size_t R = (size_t)BQ * G;
  // q rows (padded), K page (padded), V page, scores, acc, m, l, corr
  return R * (hd + 1) + (size_t)bs * (hd + 1) + (size_t)bs * hd + R * bs + R * hd + 3 * R;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
chunked_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const int* __restrict__ tables,
                       const int* __restrict__ starts, const int* __restrict__ lens,
                       T* __restrict__ out, int L, int Hq, int Hkv, int hd, int bs, int nb,
                       float scale, float cap, int window) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  const int R = BQ * G;                 // query rows of this block: r = qi * G + g
  const int nch = (L + BQ - 1) / BQ;
  const int c = blockIdx.x % nch;
  const int bh = blockIdx.x / nch;
  const int h = bh % Hkv;
  const int b = bh / Hkv;
  const int hdp = hd + 1;
  float* qs = smem;                     // (R, hd + 1)
  float* ks = qs + R * hdp;             // (bs, hd + 1)
  float* vs = ks + bs * hdp;            // (bs, hd)
  float* sc = vs + bs * hd;             // (R, bs)
  float* acc = sc + R * bs;             // (R, hd)
  float* m_s = acc + R * hd;            // (R,)
  float* l_s = m_s + R;
  float* corr = l_s + R;
  const int tid = threadIdx.x;

  for (int e = tid; e < R * hd; e += THREADS) {
    const int r = e / hd, d = e % hd;
    const int j = c * BQ + r / G, g = r % G;
    qs[r * hdp + d] =
        j < L ? to_f(q[(((size_t)b * L + j) * Hq + (size_t)h * G + g) * hd + d]) : 0.f;
    acc[e] = 0.f;
  }
  for (int r = tid; r < R; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int start = starts[b];
  const int total = start + lens[b];    // row's written length (prefix + suffix)
  const int q_lo = start + c * BQ;      // global position of the chunk's first query
  const int* trow = tables + (size_t)b * nb;
  for (int i = 0; i < nb; ++i) {
    bool live = q_lo < total;           // chunk holds at least one valid query
    live = live && i * bs < total;      // page not past the written length
    live = live && i * bs <= q_lo + BQ - 1;   // page not wholly above the diagonal
    if (window > 0) live = live && (i + 1) * bs > q_lo + 1 - window;
    if (!live) continue;                // uniform across the block
    const size_t blk = (size_t)trow[i];
    for (int e = tid; e < bs * hd; e += THREADS) {
      const int j = e / hd, d = e % hd;
      const size_t src = ((blk * bs + j) * Hkv + h) * hd + d;
      ks[j * hdp + d] = to_f(kp[src]);
      vs[j * hd + d] = to_f(vp[src]);
    }
    __syncthreads();
    for (int e = tid; e < R * bs; e += THREADS) {
      const int r = e / bs, jj = e % bs;
      const int qi = r / G;
      const float* qr = qs + r * hdp;
      const float* kr = ks + jj * hdp;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      float s = dot * scale;
      if (cap > 0.f) s = cap * tanhf(s / cap);
      const int iq = q_lo + qi;
      const int ik = i * bs + jj;
      bool ok = iq < total && c * BQ + qi < L;   // padded queries -> 0 rows
      ok = ok && ik <= iq;                       // causal, offset by the prefix
      if (window > 0) ok = ok && (iq - ik) < window;
      sc[e] = ok ? s : NEG_INF;
    }
    __syncthreads();
    for (int r = tid; r < R; r += THREADS) {
      float* sr = sc + r * bs;
      const float m_prev = m_s[r];
      float mx = m_prev;
      for (int jj = 0; jj < bs; ++jj) mx = fmaxf(mx, sr[jj]);
      // fully masked rows keep m == NEG_INF; the shift makes them add p = 0
      const float shift = fmaxf(mx, NEG_INF / 2);
      float sum = 0.f;
      for (int jj = 0; jj < bs; ++jj) {
        const float p = expf(sr[jj] - shift);
        sr[jj] = p;
        sum += p;
      }
      const float cr = expf(m_prev - mx);
      l_s[r] = l_s[r] * cr + sum;
      corr[r] = cr;
      m_s[r] = mx;
    }
    __syncthreads();
    for (int e = tid; e < R * hd; e += THREADS) {
      const int r = e / hd, d = e % hd;
      const float* pr = sc + r * bs;
      float a = acc[e] * corr[r];
      for (int jj = 0; jj < bs; ++jj) a = fmaf(pr[jj], vs[jj * hd + d], a);
      acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < R * hd; e += THREADS) {
    const int r = e / hd, d = e % hd;
    const int j = c * BQ + r / G, g = r % G;
    if (j >= L) continue;
    out[(((size_t)b * L + j) * Hq + (size_t)h * G + g) * hd + d] =
        from_f<T>(acc[e] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* tables,
                   const int* starts, const int* lens, void* out, int B, int L, int Hq,
                   int Hkv, int hd, int bs, int nb, float scale, float cap, int window,
                   cudaStream_t stream) {
  const size_t bytes = smem_floats(Hq / Hkv, hd, bs) * sizeof(float);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(chunked_prefill_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const int nch = (L + BQ - 1) / BQ;
  chunked_prefill_kernel<T><<<B * Hkv * nch, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      tables, starts, lens, static_cast<T*>(out), L, Hq, Hkv, hd, bs, nb, scale, cap,
      window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, L, Hq, hd); k/v pages (num_blocks, bs, Hkv, hd); tables (B, nb),
// starts (B,), lens (B,) int32; out (B, L, Hq, hd). dtype: 0 = f32, 1 = bf16.
int repro_chunked_prefill(const void* q, const void* kp, const void* vp, const void* tables,
                          const void* starts, const void* lens, void* out, int B, int L,
                          int Hq, int Hkv, int hd, int bs, int nb, float scale, float cap,
                          int window, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || Hkv <= 0 || Hq % Hkv != 0 || hd <= 0 || bs <= 0 || nb <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* st = static_cast<const int*>(starts);
  const int* ln = static_cast<const int*>(lens);
  if (dtype == 0)
    return (int)launch<float>(q, kp, vp, t, st, ln, out, B, L, Hq, Hkv, hd, bs, nb, scale,
                              cap, window, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, kp, vp, t, st, ln, out, B, L, Hq, Hkv, hd, bs, nb,
                                      scale, cap, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
