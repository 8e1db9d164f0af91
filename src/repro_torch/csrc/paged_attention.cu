// Paged-attention decode: one query token per request against its KV pages.
//
// Replaces the Pallas kernel src/repro/kernels/paged_attention.py:48-147
// (`_kernel` / `paged_attention`): grid (B, Hkv, pages) with the page axis
// sequential and the online-softmax state carried in VMEM scratch.
//
// What bounds it on the H100: the bytes of the attended K/V rows (each read
// once per (row, KV head)) plus q and the output; the FLOPs are 4*G*hd per
// attended key, far below the card's ratio of FLOPs to bytes. At the serve
// path's decode (B 8, Hkv 8, ~100-200 keys per row) that is under a
// megabyte, so what bounds it is latency: the dependent trips to device
// memory on a block's path and the launches. The first cut ran one block per
// (row, KV head), 64 blocks for 132 SMs, each walking its row's pages one
// after another with scalar loads, four __syncthreads and a softmax on G
// threads per page.
//
// Design (flash-decoding):
// - The page axis is split: the plan (kernels/paged_attention.py::plan)
//   cuts the table's nb pages into `splits` ranges of `per` whole pages, and
//   the grid is (B * Hkv, splits). A block loads its row's length and its
//   split's slice of the block table together, keeps the attended keys of
//   its pages (below the length and inside the window; none past the length
//   is ever read, so the trash page cannot reach a result) and returns at
//   once when there are none.
// - Inside a block, 4 warps each walk their own groups of 16 consecutive
//   keys (key p in page tables[b][p / bs] at slot p % bs, so any bs works),
//   each group's K and V rows copied as 16-byte cp.async chunks into the
//   warp's own ring of two groups: the next group is in flight while the
//   current one is computed, and the warp synchronises only itself
//   (__syncwarp), never the block, per group. q for the G heads sits in
//   shared memory, read as broadcast float4s.
// - Scores: lane (key j, half) takes hd/2 dimensions of key j for every head
//   and one shuffle adds the halves; the row max and sum of each head go
//   through 16-lane shuffles, so no thread loops over a group's keys. The
//   probabilities go through the warp's shared-memory row to P.V, where each
//   lane owns hd/32 output dimensions of every head (fp32 accumulators in
//   registers). The four warps' (m, l, acc) are merged in warp order.
// - With splits > 1 each live block writes its merged (m, l, acc) to the
//   per-stream scratch and a second launch combines, per output element,
//   exactly the live splits in split order (common.cuh: combine_splits), so
//   the result is the same bits on every run; with one split the block
//   writes the output itself.
// - Semantics of paged_attention.py: NEG_INF = -1e30, the window test
//   (len-1-ik) < window, softcap cap*tanh(s/cap) before the mask, the
//   maximum(m, NEG_INF/2) exponent shift and the finalization
//   acc / max(l, 1e-30), so a length-0 row gives exact zeros.
// Scores and P.V are fp32 FMAs in every dtype pair (q and the output in
// the compute dtype TQ, the pages in the cache dtype TKV, each fp32 or bf16;
// bf16 values are converted as they are read). As in the Pallas kernel, the
// probabilities are rounded to the pages' dtype before P.V (p.astype(v.dtype))
// while the row sum l adds them unrounded.

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int KG = 16;          // keys per group: lane = (key lane % 16, half lane / 16)
constexpr int NSTAGE = 2;       // groups per warp ring
constexpr int MAXG = 8;         // query heads per KV head the kernel takes
constexpr int SMEM_MAX = 227 * 1024;
constexpr unsigned FULL = 0xffffffffu;

template <typename T, int HD>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);          // elements per 16-byte chunk
  static constexpr int CPR = HD / VEC;                 // chunks per K/V row
  static constexpr int LDK = HD + VEC;                 // padded K row (elements)
  static constexpr int GROUP = KG * (LDK + HD);        // one group's K then V (elements)
  static constexpr int DPL = (HD + 31) / 32;           // P.V output dims per lane
  static constexpr size_t ring = (size_t)WARPS * NSTAGE * GROUP * sizeof(T);
  // shared memory: the rings (reused for the warp merge), then q, the
  // probability rows and the split's block-table slice
  static __host__ __device__ size_t front(int G) {
    const size_t merge = (size_t)WARPS * G * (2 + HD) * sizeof(float);
    return ring > merge ? ring : merge;
  }
  static size_t bytes(int G, int per) {
    return front(G) + (size_t)G * HD * sizeof(float) + (size_t)WARPS * G * KG * sizeof(float) +
           (size_t)per * sizeof(int);
  }
};

// Keys [klo, khi) that row `length` attends: below the length and the
// table's width, and inside the window.
__device__ __forceinline__ void attended_keys(int length, int window, int keys, int& klo,
                                              int& khi) {
  khi = min(max(length, 0), keys);
  klo = window > 0 ? max(0, length - window) : 0;
}

// grid (B * Hkv, splits); block (b * Hkv + h, s) attends pages
// [s * per, min(nb, (s + 1) * per)). work (splits > 1): ml [splits][B][Hq][2]
// then acc [splits][B][Hq][HD].
template <typename TQ, typename T, int HD>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const TQ* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const int* __restrict__ tables,
                       const int* __restrict__ lengths, TQ* __restrict__ out,
                       float* __restrict__ work, int Hq, int Hkv, int bs, int nb, float scale,
                       float cap, int window, int per, int vec) {
  using LY = Layout<T, HD>;
  constexpr int VEC = LY::VEC, CPR = LY::CPR, LDK = LY::LDK, DPL = LY::DPL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = Hq / Hkv;
  const int B = gridDim.x / Hkv;
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int s = blockIdx.y, splits = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* qs = reinterpret_cast<float*>(smem_raw + LY::front(G));   // [G][HD]
  float* ps = qs + G * HD;                                       // [WARPS][G][KG]
  int* tbl = reinterpret_cast<int*>(ps + WARPS * G * KG);        // [per]

  // the length, the split's table slice and q, all in flight together
  const int pg0 = s * per, np = min(per, nb - pg0);
  const int length = lengths[b];
  const int* trow = tables + (size_t)b * nb + pg0;
  for (int i = tid; i < np; i += THREADS) tbl[i] = trow[i];
  const TQ* qb = q + ((size_t)b * Hq + (size_t)h * G) * HD;   // G heads, contiguous
  for (int e = tid; e < G * HD; e += THREADS) qs[e] = to_f(qb[e]);
  int klo, khi;
  attended_keys(length, window, nb * bs, klo, khi);
  const int k0 = max(pg0 * bs, klo), k1 = min((pg0 + np) * bs, khi);
  if (k0 >= k1 && splits > 1) return;     // no live page: the combine skips it
  __syncthreads();                        // table slice and q in shared memory

  const int ngroups = k1 > k0 ? (k1 - k0 + KG - 1) / KG : 0;
  const int mine = ngroups > warp ? (ngroups - 1 - warp) / WARPS + 1 : 0;
  T* wring = ring + (size_t)warp * NSTAGE * LY::GROUP;
  float* wps = ps + warp * G * KG;
  // group `grp` of this block's keys into ring stage `stage`; rows past the
  // group's last key are zeros
  auto issue = [&](int grp, int stage) {
    const int kg0 = k0 + grp * KG;
    const int n = min(KG, k1 - kg0);
    const int page0 = kg0 / bs - pg0, slot0 = kg0 % bs;
    T* ks = wring + stage * LY::GROUP;
    T* vs = ks + KG * LDK;
    for (int c = lane; c < KG * CPR; c += 32) {
      const int j = c / CPR, part = c % CPR;
      const bool ok = j < n;
      size_t off = 0;
      if (ok) {                           // key kg0 + j: page and slot without a division
        int pg = page0, sl = slot0 + j;
        while (sl >= bs) {
          sl -= bs;
          ++pg;
        }
        off = (((size_t)tbl[pg] * bs + sl) * Hkv + h) * HD + part * VEC;
      }
      copy16<T>(ks + j * LDK + part * VEC, kp + off, ok, vec);
      copy16<T>(vs + j * HD + part * VEC, vp + off, ok, vec);
    }
  };

  float m[MAXG], l[MAXG], acc[MAXG][DPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int u = 0; u < DPL; ++u) acc[g][u] = 0.f;
  }
  const int j = lane & 15, hh = lane >> 4;
  if (mine > 0) issue(warp, 0);
  cp_async_commit();
  for (int t = 0; t < mine; ++t) {
    if (t + 1 < mine) issue(warp + (t + 1) * WARPS, (t + 1) % NSTAGE);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();                         // group t is in the warp's ring
    const int kg0 = k0 + (warp + t * WARPS) * KG;
    const int n = min(KG, k1 - kg0);      // keys of this group; all attended
    const T* ks = wring + (t % NSTAGE) * LY::GROUP;
    const T* vs = ks + KG * LDK;

    float sc[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) sc[g] = 0.f;
    const T* kr = ks + j * LDK + hh * (HD / 2);
    const float* qh = qs + hh * (HD / 2);
#pragma unroll
    for (int d = 0; d < HD / 2; d += 4) {
      const float4 kv = load4<T>(kr + d);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) continue;
        const float4 qv = *reinterpret_cast<const float4*>(qh + g * HD + d);
        float a = sc[g];
        a = fmaf(qv.x, kv.x, a);
        a = fmaf(qv.y, kv.y, a);
        a = fmaf(qv.z, kv.z, a);
        a = fmaf(qv.w, kv.w, a);
        sc[g] = a;
      }
    }
    float corr[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) continue;
      float x = (sc[g] + __shfl_xor_sync(FULL, sc[g], 16)) * scale;
      if (cap > 0.f) x = cap * tanhf(x / cap);
      x = j < n ? x : NEG_INF;            // key kg0 + j < length, inside the window
      float mx = x;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float p = expf(x - fmaxf(m_new, NEG_INF / 2));
      float sum = p;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
      corr[g] = expf(m[g] - m_new);
      l[g] = l[g] * corr[g] + sum;
      m[g] = m_new;
      if (hh == 0) wps[g * KG + j] = round_to<T>(p);   // P in the pages' dtype
    }
    __syncwarp();                         // probabilities visible to the warp
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) continue;
#pragma unroll
      for (int u = 0; u < DPL; ++u) acc[g][u] *= corr[g];
    }
    for (int j4 = 0; j4 < n; j4 += 4) {   // rows past n are zeros, with p = 0
      float4 p4[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) p4[g] = *reinterpret_cast<const float4*>(wps + g * KG + j4);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int u = 0; u < DPL; ++u) {
          const int d = lane + 32 * u;
          if (d >= HD) continue;
          const float v = to_f(vs[(j4 + jj) * HD + d]);
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            if (g >= G) continue;
            const float pj = jj == 0 ? p4[g].x : jj == 1 ? p4[g].y : jj == 2 ? p4[g].z : p4[g].w;
            acc[g][u] = fmaf(pj, v, acc[g][u]);
          }
        }
      }
    }
    __syncwarp();                         // stage and probability row free again
  }
  cp_async_wait<0>();

  // merge the four warps' (m, l, acc) in warp order
  __syncthreads();                        // every warp is done with its ring
  float* mb = reinterpret_cast<float*>(smem_raw);   // [WARPS][G][2]
  float* ab = mb + WARPS * G * 2;                   // [WARPS][G][HD]
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) continue;
    if (lane == 0) {
      mb[(warp * G + g) * 2] = m[g];
      mb[(warp * G + g) * 2 + 1] = l[g];
    }
#pragma unroll
    for (int u = 0; u < DPL; ++u) {
      const int d = lane + 32 * u;
      if (d < HD) ab[(warp * G + g) * HD + d] = acc[g][u];
    }
  }
  __syncthreads();
  const size_t rows = (size_t)B * Hq;
  for (int e = tid; e < G * HD; e += THREADS) {
    const int g = e / HD, d = e % HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, mb[(w * G + g) * 2]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = expf(mb[(w * G + g) * 2] - mx);
      lsum = fmaf(wt, mb[(w * G + g) * 2 + 1], lsum);
      a = fmaf(wt, ab[(w * G + g) * HD + d], a);
    }
    const size_t row = (size_t)b * Hq + (size_t)h * G + g;
    if (splits == 1) {
      out[row * HD + d] = from_f<TQ>(a / fmaxf(lsum, 1e-30f));
    } else {
      const size_t slot = (size_t)s * rows + row;
      if (d == 0) {
        work[2 * slot] = mx;
        work[2 * slot + 1] = lsum;
      }
      work[2 * (size_t)splits * rows + slot * HD + d] = a;
    }
  }
}

// One thread per output element: the live splits of its row, in split order.
template <typename T>
__global__ void paged_combine_kernel(const float* __restrict__ work,
                                     const int* __restrict__ lengths, T* __restrict__ out,
                                     int B, int Hq, int hd, int bs, int nb, int window,
                                     int splits, int per) {
  const size_t rows = (size_t)B * Hq;
  const size_t n = rows * hd;
  const float* pacc = work + 2 * (size_t)splits * rows;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int d = (int)(e % hd);
    const size_t row = e / hd;
    int klo, khi;
    attended_keys(lengths[row / Hq], window, nb * bs, klo, khi);
    float o = 0.f;
    if (klo < khi) {
      const int s0 = klo / (per * bs), s1 = (khi - 1) / (per * bs);
      const size_t slot = (size_t)s0 * rows + row;
      o = combine_splits(work + 2 * slot, 2 * rows, pacc + slot * hd + d, rows * hd,
                         s1 - s0 + 1);
    }
    out[e] = from_f<T>(o);
  }
}

template <typename TQ, typename T, int HD>
cudaError_t launch_hd(const TQ* q, const T* kp, const T* vp, const int* tables,
                      const int* lengths, TQ* out, float* work, int B, int Hq, int Hkv, int bs,
                      int nb, float scale, float cap, int window, int splits, int per,
                      cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (G > MAXG) return cudaErrorInvalidValue;
  const size_t bytes = Layout<T, HD>::bytes(G, per);
  if (bytes > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  static bool configured[MAX_DEVICES] = {};
  cudaError_t err = smem_limit_once(
      reinterpret_cast<const void*>(paged_attention_kernel<TQ, T, HD>), SMEM_MAX, configured);
  if (err != cudaSuccess) return err;
  const int vec = aligned16(kp) && aligned16(vp);
  paged_attention_kernel<TQ, T, HD><<<dim3((unsigned)(B * Hkv), (unsigned)splits), THREADS,
                                      bytes, stream>>>(q, kp, vp, tables, lengths, out, work, Hq, Hkv, bs,
                                            nb, scale, cap, window, per, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = (long long)B * Hq * HD;
  long long grid = (n + 255) / 256;
  if (grid > 8192) grid = 8192;
  paged_combine_kernel<TQ><<<(unsigned)grid, 256, 0, stream>>>(work, lengths, out, B, Hq, HD, bs,
                                                              nb, window, splits, per);
  return cudaGetLastError();
}

template <typename TQ, typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* tables,
                   const int* lengths, void* out, float* work, int B, int Hq, int Hkv, int hd,
                   int bs, int nb, float scale, float cap, int window, int splits, int per,
                   cudaStream_t stream) {
  const TQ* qq = static_cast<const TQ*>(q);
  const T* kk = static_cast<const T*>(kp);
  const T* vv = static_cast<const T*>(vp);
  TQ* o = static_cast<TQ*>(out);
#define REPRO_PA_HD(H)                                                                       \
  case H:                                                                                    \
    return launch_hd<TQ, T, H>(qq, kk, vv, tables, lengths, o, work, B, Hq, Hkv, bs, nb,     \
                               scale, cap, window, splits, per, stream);
  switch (hd) {
    REPRO_PA_HD(16)
    REPRO_PA_HD(32)
    REPRO_PA_HD(64)
    REPRO_PA_HD(128)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_PA_HD
}

}  // namespace

extern "C" {

// q (B, Hq, hd); k/v pages (num_blocks, bs, Hkv, hd); tables (B, nb) int32;
// lengths (B,) int32; out (B, Hq, hd); work: the plan's fp32 partials
// (splits x B x Hq x (hd + 2); unused when splits == 1). The plan
// (kernels/paged_attention.py) cuts the nb pages into `splits` ranges of
// `per` pages. hd in {16, 32, 64, 128}, Hq / Hkv <= 8. dtype_q (q and out)
// and dtype_kv (both page stores): 0 = float32, 1 = bfloat16.
int repro_paged_attention(const void* q, const void* kp, const void* vp, const void* tables,
                          const void* lengths, void* out, void* work, int B, int Hq, int Hkv,
                          int hd, int bs, int nb, float scale, float cap, int window,
                          int splits, int per, int dtype_q, int dtype_kv, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || hd <= 0 || bs <= 0 || nb <= 0)
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || per < 1 || (long long)(splits - 1) * per >= nb ||
      (long long)splits * per < nb || (splits > 1 && work == nullptr) ||
      (long long)B * Hkv > 0x7fffffffLL || splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lengths);
  float* w = static_cast<float*>(work);
#define REPRO_PA_CALL(TQ, TKV)                                                              \
  return (int)launch<TQ, TKV>(q, kp, vp, t, l, out, w, B, Hq, Hkv, hd, bs, nb, scale, cap, \
                              window, splits, per, s)
  using bf16 = __nv_bfloat16;
  if (dtype_q == 0 && dtype_kv == 0) REPRO_PA_CALL(float, float);
  if (dtype_q == 1 && dtype_kv == 1) REPRO_PA_CALL(bf16, bf16);
  if (dtype_q == 0 && dtype_kv == 1) REPRO_PA_CALL(float, bf16);
  if (dtype_q == 1 && dtype_kv == 0) REPRO_PA_CALL(bf16, float);
#undef REPRO_PA_CALL
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
