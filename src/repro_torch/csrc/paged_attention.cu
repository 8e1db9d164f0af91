// Paged-attention decode: one query token per request against its KV pages.
//
// Replaces the Pallas kernel src/repro/kernels/paged_attention.py:48-147
// (`_kernel` / `paged_attention`): grid (B, Hkv, pages) with the page axis
// sequential and the online-softmax state carried in VMEM scratch.
//
// What bounds it on the H100: the bytes of the live K/V pages (each read
// once per (row, KV head)) plus q and the output; the FLOPs are 4*G*hd per
// attended key, far below the card's ratio of FLOPs to bytes. At the main
// path's shapes (B = 8, Hkv = 8, ~100-250 keys per row) that is well under a
// megabyte, so the kernel is bound by latency and launch overhead first.
//
// Design: one block per (row, KV head), which loads its own table row and
// length (the Pallas scalar prefetch). The G = Hq/Hkv query heads sharing the
// KV head sit in shared memory; a loop over the row's pages skips dead pages
// exactly as paged_attention.py:61-63 does (past the length, or wholly below
// the sliding window), stages each live page of K and V in shared memory
// (K rows padded by one float against bank conflicts), and keeps the online
// softmax (m, l, acc) in fp32. NEG_INF = -1e30 with the window test
// (len-1-ik) < window; a length-0 row finalizes with max(l, 1e-30) and gives
// exact zeros. B*Hkv = 64 blocks at batch 8 leave half of the 132 SMs idle;
// splitting the page axis (flash-decoding) with a combine pass is later work.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;

size_t smem_floats(int G, int hd, int bs) {
  // q, K page (padded), V page, scores, acc, m, l, corr
  return (size_t)G * hd + (size_t)bs * (hd + 1) + (size_t)bs * hd + (size_t)G * bs +
         (size_t)G * hd + 3 * (size_t)G;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const int* __restrict__ tables,
                       const int* __restrict__ lengths, T* __restrict__ out, int Hq,
                       int Hkv, int hd, int bs, int nb, float scale, float cap,
                       int window) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int hdp = hd + 1;
  float* qs = smem;              // (G, hd)
  float* ks = qs + G * hd;       // (bs, hd + 1)
  float* vs = ks + bs * hdp;     // (bs, hd)
  float* sc = vs + bs * hd;      // (G, bs)
  float* acc = sc + G * bs;      // (G, hd)
  float* m_s = acc + G * hd;     // (G,)
  float* l_s = m_s + G;
  float* corr = l_s + G;
  const int tid = threadIdx.x;

  const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * hd;   // G heads, contiguous
  for (int e = tid; e < G * hd; e += THREADS) {
    qs[e] = to_f(qb[e]);
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int length = lengths[b];
  const int* trow = tables + (size_t)b * nb;
  for (int i = 0; i < nb; ++i) {
    bool live = i * bs < length;                  // page holds valid positions
    if (window > 0) live = live && (i + 1) * bs > length - window;
    if (!live) continue;                          // uniform across the block
    const size_t blk = (size_t)trow[i];
    for (int e = tid; e < bs * hd; e += THREADS) {
      const int j = e / hd, d = e % hd;
      const size_t src = ((blk * bs + j) * Hkv + h) * hd + d;
      ks[j * hdp + d] = to_f(kp[src]);
      vs[j * hd + d] = to_f(vp[src]);
    }
    __syncthreads();
    for (int e = tid; e < G * bs; e += THREADS) {
      const int g = e / bs, j = e % bs;
      const float* qr = qs + g * hd;
      const float* kr = ks + j * hdp;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      float s = dot * scale;
      if (cap > 0.f) s = cap * tanhf(s / cap);
      const int ik = i * bs + j;
      bool ok = ik < length;                      // causal: q sits at length-1
      if (window > 0) ok = ok && (length - 1 - ik) < window;
      sc[e] = ok ? s : NEG_INF;
    }
    __syncthreads();
    for (int g = tid; g < G; g += THREADS) {
      float* sr = sc + g * bs;
      const float m_prev = m_s[g];
      float mx = m_prev;
      for (int j = 0; j < bs; ++j) mx = fmaxf(mx, sr[j]);
      const float shift = fmaxf(mx, NEG_INF / 2);
      float sum = 0.f;
      for (int j = 0; j < bs; ++j) {
        const float p = expf(sr[j] - shift);
        sr[j] = p;
        sum += p;
      }
      const float c = expf(m_prev - mx);
      l_s[g] = l_s[g] * c + sum;
      corr[g] = c;
      m_s[g] = mx;
    }
    __syncthreads();
    for (int e = tid; e < G * hd; e += THREADS) {
      const int g = e / hd, d = e % hd;
      const float* pr = sc + g * bs;
      float a = acc[e] * corr[g];
      for (int j = 0; j < bs; ++j) a = fmaf(pr[j], vs[j * hd + d], a);
      acc[e] = a;
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * Hq + (size_t)h * G) * hd;
  for (int e = tid; e < G * hd; e += THREADS) {
    const int g = e / hd;
    ob[e] = from_f<T>(acc[e] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* tables,
                   const int* lengths, void* out, int B, int Hq, int Hkv, int hd, int bs,
                   int nb, float scale, float cap, int window, cudaStream_t stream) {
  const size_t bytes = smem_floats(Hq / Hkv, hd, bs) * sizeof(float);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(paged_attention_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
  }
  paged_attention_kernel<T><<<B * Hkv, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      tables, lengths, static_cast<T*>(out), Hq, Hkv, hd, bs, nb, scale, cap, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Hq, hd); k/v pages (num_blocks, bs, Hkv, hd); tables (B, nb) int32;
// lengths (B,) int32; out (B, Hq, hd). dtype: 0 = float32, 1 = bfloat16.
int repro_paged_attention(const void* q, const void* kp, const void* vp, const void* tables,
                          const void* lengths, void* out, int B, int Hq, int Hkv, int hd,
                          int bs, int nb, float scale, float cap, int window, int dtype,
                          void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || hd <= 0 || bs <= 0 || nb <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lengths);
  if (dtype == 0)
    return (int)launch<float>(q, kp, vp, t, l, out, B, Hq, Hkv, hd, bs, nb, scale, cap,
                              window, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, kp, vp, t, l, out, B, Hq, Hkv, hd, bs, nb, scale,
                                      cap, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
