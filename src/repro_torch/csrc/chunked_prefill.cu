// Chunked prefill: batched suffix prefill attention over the paged KV pool.
//
// Replaces the Pallas kernel src/repro/kernels/chunked_prefill.py:58-188
// (`_kernel` / `chunked_prefill`): grid (B, Hkv, q_chunks, pages) with the
// page axis sequential and (m, l, acc) for block_q x G queries in VMEM.
//
// What bounds it on the H100: 4*hd fp32 FLOPs per live (query, key) pair and
// one read of the live K/V rows. At the serve path's prefills (B 1-8, 16-256
// tokens, hd 64) that is a few MFLOP to a few hundred, microseconds of work
// for the whole card, so what bounds it in practice is latency and how many
// of the 132 SMs the work reaches: the first cut ran one serial page walk
// per (row, KV head, 16 queries) and filled under one block per SM at B = 1.
//
// Design (the tile of flash_attention.cu plus paging):
// - A block owns 64 query rows of one (row b, KV head h): rows are the flat
//   (query j, head g) pairs r = j*G + g of that KV head, so any G works.
//   256 threads as 16 x 16; each thread holds a 4 x 4 block of scores (rows
//   ty*4+i, keys tx+16c) and a 4 x hd/16 block of the fp32 accumulator in
//   registers; row max and row sum go through warp shuffles.
// - Key tiles of 64 keys are gathered through the block table (key p sits in
//   page tables[b][p / bs] at slot p % bs, so any bs works), each K/V row of
//   one head copied as 16-byte cp.async chunks into shared memory, two tiles
//   in flight: the next tile loads while the current one is computed. Keys
//   at or past the row's written length are zero-filled, never read, so the
//   trash page 0 cannot reach a real query.
// - Key-range splits (flash-decoding): the plan (kernels/chunked_prefill.py)
//   cuts the key tiles into `splits` ranges of `per` tiles. Each (row tile,
//   split) block walks only the key tiles of its range that the row tile's
//   live range (causal diagonal, window, valid queries) reaches; a block with
//   none returns at once. With splits > 1 each live block writes its fp32
//   (m, l, acc) partial and a second launch combines, per output element,
//   exactly the live splits in split order (deterministic). Row tiles are
//   walked from the last (the longest diagonal) down.
// - Masks and shifts as in chunked_prefill.py: softcap before the mask,
//   offset causal (query j of row b at global position starts[b] + j), the
//   window, masked scores NEG_INF = -1e30, the maximum(m, NEG_INF/2) exponent
//   shift for fully masked rows, output acc / max(l, 1e-30); padded queries
//   (j >= lens[b]), rows with lens == 0 and dead row tiles give exact zeros.
// Scores and P.V are fp32 FMAs on the CUDA cores in every dtype pair (q and
// the output in the compute dtype TQ, the pages in the cache dtype TKV, each
// fp32 or bf16; bf16 values are converted as they are read from shared
// memory). As in the Pallas kernel, the probabilities are rounded to the
// pages' dtype before P.V (p.astype(v.dtype)) while l adds them unrounded.
// The speculative verifier is this kernel at L = spec_k + 1 with every row at
// starts > 0: one row tile per (row, KV head) when L * G <= 64.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;   // 16 x 16
constexpr int BR = 64;         // query rows (query, head) per block
constexpr int BKEYS = 64;      // keys per key tile
constexpr int PP = BKEYS + 1;  // padded probability row

// Row layout of one operand type in shared memory.
template <typename T, int HD>
struct Rows {
  static constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte chunk
  static constexpr int CPR = HD / VEC;          // chunks per row
  static constexpr int LD = HD + VEC;           // shared row stride (elements)
};

// Shared memory: the q tile (TQ), two K and two V tiles (T), the
// probability rows (fp32).
template <typename TQ, typename T, int HD>
struct Tile {
  static constexpr size_t bytes() {
    return (size_t)BR * Rows<TQ, HD>::LD * sizeof(TQ) +
           (size_t)4 * BKEYS * Rows<T, HD>::LD * sizeof(T) + (size_t)BR * PP * sizeof(float);
  }
};

// Key tiles [lo, hi] that row tile rt of a row (start, len) can attend:
// lo > hi when the tile holds no valid query or no key is in reach.
__device__ __forceinline__ void live_key_tiles(int rt, int start, int len, int L, int G,
                                               int window, int keys, int& lo, int& hi) {
  const int r0 = rt * BR;
  const int j0 = r0 / G;
  const int j1 = min(min(L, len) - 1, (r0 + BR - 1) / G);
  const int kmax = min(start + j1, keys - 1);
  const int kmin = window > 0 ? max(0, start + j0 - window + 1) : 0;
  if (j1 < j0 || kmax < kmin) {
    lo = 1;
    hi = 0;
    return;
  }
  lo = kmin / BKEYS;
  hi = kmax / BKEYS;
}

// grid: row tiles x B x Hkv x splits (row tile slowest, last tile first).
// work (splits > 1): ml [splits][B][Hkv][nrt*BR][2] then acc [..][HD].
template <typename TQ, typename T, int HD>
__global__ void __launch_bounds__(THREADS)
chunked_prefill_kernel(const TQ* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const int* __restrict__ tables,
                       const int* __restrict__ starts, const int* __restrict__ lens,
                       TQ* __restrict__ out, float* __restrict__ work, int B, int L, int Hq,
                       int Hkv, int bs, int nb, float scale, float cap, int window,
                       int splits, int per, int vec) {
  constexpr int LDQ = Rows<TQ, HD>::LD, CPRQ = Rows<TQ, HD>::CPR, VECQ = Rows<TQ, HD>::VEC;
  constexpr int LD = Rows<T, HD>::LD, CPR = Rows<T, HD>::CPR, VEC = Rows<T, HD>::VEC;
  constexpr int CO = HD / 16;            // accumulator columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TQ* qs = reinterpret_cast<TQ*>(smem_raw);           // [BR][LDQ]
  T* ks = reinterpret_cast<T*>(qs + BR * LDQ);        // [2][BKEYS][LD]
  T* vs = ks + 2 * BKEYS * LD;                        // [2][BKEYS][LD]
  float* ps = reinterpret_cast<float*>(vs + 2 * BKEYS * LD);   // [BR][PP]

  const int G = Hq / Hkv;
  const int rows = L * G;                // query rows of one (b, h)
  const int nrt = (rows + BR - 1) / BR;
  int idx = blockIdx.x;
  const int s = idx % splits;
  idx /= splits;
  const int h = idx % Hkv;
  idx /= Hkv;
  const int b = idx % B;
  const int rt = nrt - 1 - idx / B;
  const int r0 = rt * BR;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int start = starts[b], len = lens[b];
  const int keys = nb * bs;
  const int total = min(start + len, keys);  // keys that can be loaded

  int lo, hi;
  live_key_tiles(rt, start, len, L, G, window, keys, lo, hi);
  const int kt_a = max(lo, s * per), kt_b = min(hi, (s + 1) * per - 1);
  const size_t q_tok = (size_t)Hq * HD;
  if (kt_a > kt_b) {
    if (splits > 1) return;              // the combine skips this split
    for (int e = tid; e < BR * HD; e += THREADS) {   // dead row tile: zeros
      const int gr = r0 + e / HD;
      if (gr < rows)
        out[((size_t)b * L + gr / G) * q_tok + (size_t)(h * G + gr % G) * HD + e % HD] =
            from_f<TQ>(0.f);
    }
    return;
  }

  // the query tile and the first key tile: commit group 0
  for (int e = tid; e < BR * CPRQ; e += THREADS) {
    const int r = e / CPRQ, c = e % CPRQ;
    const int gr = r0 + r;
    const TQ* src =
        q + ((size_t)b * L + gr / G) * q_tok + (size_t)(h * G + gr % G) * HD + c * VECQ;
    copy16<TQ>(qs + r * LDQ + c * VECQ, gr < rows ? src : q, gr < rows, vec);
  }
  const int* trow = tables + (size_t)b * nb;
  auto issue = [&](int kt, int buf) {
    for (int e = tid; e < BKEYS * CPR; e += THREADS) {
      const int r = e / CPR, c = e % CPR;
      const int p = kt * BKEYS + r;
      const bool ok = p < total;
      size_t off = 0;
      if (ok) off = (((size_t)trow[p / bs] * bs + p % bs) * Hkv + h) * HD + c * VEC;
      copy16<T>(ks + (buf * BKEYS + r) * LD + c * VEC, kp + off, ok, vec);
      copy16<T>(vs + (buf * BKEYS + r) * LD + c * VEC, vp + off, ok, vec);
    }
  };
  issue(kt_a, 0);
  cp_async_commit();

  float m[4], l[4], acc[4][CO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;
  }
  // per-row constants of this thread's four rows
  int iq[4];
  bool rv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = r0 + ty * 4 + i;
    const int j = gr / G;
    rv[i] = gr < rows && j < len;        // valid (not padded) query
    iq[i] = start + j;
  }

  for (int kt = kt_a; kt <= kt_b; ++kt) {
    const int cur = (kt - kt_a) & 1;
    if (kt < kt_b) issue(kt + 1, cur ^ 1);   // next tile in flight during compute
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                     // q and tile kt are in shared memory

    const T* kb = ks + cur * BKEYS * LD;
    const T* vb = vs + cur * BKEYS * LD;
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4<TQ>(qs + (ty * 4 + i) * LDQ + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = load4<T>(kb + (tx + 16 * c) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float a = sc[i][c];
          a = fmaf(qv[i].x, kv[c].x, a);
          a = fmaf(qv[i].y, kv[c].y, a);
          a = fmaf(qv[i].z, kv[c].z, a);
          a = fmaf(qv[i].w, kv[c].w, a);
          sc[i][c] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ik = kt * BKEYS + tx + 16 * c;
        float x = sc[i][c] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        bool ok = rv[i] && ik <= iq[i] && ik < keys;   // causal, offset by the prefix
        if (window > 0) ok = ok && iq[i] - ik < window;
        x = ok ? x : NEG_INF;
        sc[i][c] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 threads of a row are lanes 16*(ty%2) + tx of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // fully masked rows keep m == NEG_INF; the shift makes them add p = 0
      const float shift = fmaxf(m_new, NEG_INF / 2);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(sc[i][c] - shift);
        ps[(ty * 4 + i) * PP + tx + 16 * c] = round_to<T>(p);   // P in the pages' dtype
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[i][c] *= corr;
    }
    __syncthreads();                     // probabilities visible

#pragma unroll 4
    for (int kk = 0; kk < BKEYS; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        const float vv = to_f(vb[kk * LD + tx + 16 * c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
    __syncthreads();                     // tile buffers free for the next issue
  }

  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = r0 + ty * 4 + i;
      if (gr >= rows) continue;
      TQ* orow = out + ((size_t)b * L + gr / G) * q_tok + (size_t)(h * G + gr % G) * HD;
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < CO; ++c) orow[tx + 16 * c] = from_f<TQ>(acc[i][c] / den);
    }
    return;
  }
  const size_t rp = (size_t)nrt * BR;
  const size_t slot = (((size_t)s * B + b) * Hkv + h) * rp + r0;   // row r0 of this split
  float* ml = work + 2 * slot;
  float* pacc = work + (size_t)splits * B * Hkv * rp * 2 + slot * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (tx == 0) {
      ml[2 * r] = m[i];
      ml[2 * r + 1] = l[i];
    }
#pragma unroll
    for (int c = 0; c < CO; ++c) pacc[(size_t)r * HD + tx + 16 * c] = acc[i][c];
  }
}

// Each output element combines (common.cuh: combine_splits) exactly the
// splits that its row's tile reaches, in split order.
template <typename T, int HD>
__global__ void combine_kernel(const float* __restrict__ work, const int* __restrict__ starts,
                               const int* __restrict__ lens, T* __restrict__ out, int B, int L,
                               int Hq, int Hkv, int bs, int nb, int window, int splits,
                               int per) {
  const int G = Hq / Hkv;
  const int rows = L * G;
  const size_t rp = (size_t)((rows + BR - 1) / BR) * BR;
  const float* pacc = work + (size_t)splits * B * Hkv * rp * 2;
  const size_t n = (size_t)B * Hkv * rows * HD;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int d = (int)(e % HD);
    size_t rest = e / HD;
    const int gr = (int)(rest % rows);
    rest /= rows;
    const int h = (int)(rest % Hkv);
    const int b = (int)(rest / Hkv);
    int lo, hi;
    live_key_tiles(gr / BR, starts[b], lens[b], L, G, window, nb * bs, lo, hi);
    float o = 0.f;
    if (lo <= hi) {
      const int s0 = lo / per, s1 = hi / per;
      const size_t step = (size_t)B * Hkv * rp;          // slots between splits
      const size_t slot = (((size_t)s0 * B + b) * Hkv + h) * rp + gr;
      o = combine_splits(work + 2 * slot, 2 * step, pacc + slot * HD + d, step * HD,
                         s1 - s0 + 1);
    }
    out[((size_t)b * L + gr / G) * ((size_t)Hq * HD) + (size_t)(h * G + gr % G) * HD + d] =
        from_f<T>(o);
  }
}

template <typename TQ, typename T, int HD>
cudaError_t launch_hd(const TQ* q, const T* kp, const T* vp, const int* tables,
                      const int* starts, const int* lens, TQ* out, float* work, int B, int L,
                      int Hq, int Hkv, int bs, int nb, float scale, float cap, int window,
                      int splits, int per, cudaStream_t stream) {
  const size_t bytes = Tile<TQ, T, HD>::bytes();
  static bool configured[MAX_DEVICES] = {};
  cudaError_t err = smem_limit_once(
      reinterpret_cast<const void*>(chunked_prefill_kernel<TQ, T, HD>), (int)bytes, configured);
  if (err != cudaSuccess) return err;
  const int G = Hq / Hkv;
  const long long nrt = ((long long)L * G + BR - 1) / BR;
  const long long blocks = nrt * B * Hkv * splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int vec = aligned16(q) && aligned16(kp) && aligned16(vp);
  chunked_prefill_kernel<TQ, T, HD><<<(unsigned)blocks, THREADS, bytes, stream>>>(
      q, kp, vp, tables, starts, lens, out, work, B, L, Hq, Hkv, bs, nb, scale, cap, window,
      splits, per, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = (long long)B * Hkv * L * G * HD;
  long long grid = (n + 255) / 256;
  if (grid > 8192) grid = 8192;
  combine_kernel<TQ, HD><<<(unsigned)grid, 256, 0, stream>>>(work, starts, lens, out, B, L, Hq,
                                                            Hkv, bs, nb, window, splits, per);
  return cudaGetLastError();
}

template <typename TQ, typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* tables,
                   const int* starts, const int* lens, void* out, float* work, int B, int L,
                   int Hq, int Hkv, int hd, int bs, int nb, float scale, float cap, int window,
                   int splits, int per, cudaStream_t stream) {
  const TQ* qq = static_cast<const TQ*>(q);
  const T* kk = static_cast<const T*>(kp);
  const T* vv = static_cast<const T*>(vp);
  TQ* o = static_cast<TQ*>(out);
#define REPRO_CP_HD(H)                                                                       \
  case H:                                                                                    \
    return launch_hd<TQ, T, H>(qq, kk, vv, tables, starts, lens, o, work, B, L, Hq, Hkv, bs, \
                               nb, scale, cap, window, splits, per, stream);
  switch (hd) {
    REPRO_CP_HD(16)
    REPRO_CP_HD(32)
    REPRO_CP_HD(64)
    REPRO_CP_HD(128)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_CP_HD
}

}  // namespace

extern "C" {

// q (B, L, Hq, hd); k/v pages (num_blocks, bs, Hkv, hd); tables (B, nb),
// starts (B,), lens (B,) int32; out (B, L, Hq, hd); work: the plan's fp32
// partials (unused when splits == 1). The plan (kernels/chunked_prefill.py)
// cuts the ceil(nb*bs/64) key tiles into `splits` ranges of `per` tiles.
// hd in {16, 32, 64, 128}. dtype_q (q and out) and dtype_kv (both page
// stores): 0 = f32, 1 = bf16.
int repro_chunked_prefill(const void* q, const void* kp, const void* vp, const void* tables,
                          const void* starts, const void* lens, void* out, void* work, int B,
                          int L, int Hq, int Hkv, int hd, int bs, int nb, float scale,
                          float cap, int window, int splits, int per, int dtype_q,
                          int dtype_kv, void* stream) {
  if (B <= 0 || L <= 0 || Hkv <= 0 || Hq % Hkv != 0 || hd <= 0 || bs <= 0 || nb <= 0)
    return (int)cudaErrorInvalidValue;
  const long long nkt = ((long long)nb * bs + BKEYS - 1) / BKEYS;
  if (splits < 1 || per < 1 || (long long)(splits - 1) * per >= nkt ||
      (long long)splits * per < nkt || (splits > 1 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* st = static_cast<const int*>(starts);
  const int* ln = static_cast<const int*>(lens);
  float* w = static_cast<float*>(work);
#define REPRO_CP_CALL(TQ, TKV)                                                             \
  return (int)launch<TQ, TKV>(q, kp, vp, t, st, ln, out, w, B, L, Hq, Hkv, hd, bs, nb, scale, \
                              cap, window, splits, per, s)
  using bf16 = __nv_bfloat16;
  if (dtype_q == 0 && dtype_kv == 0) REPRO_CP_CALL(float, float);
  if (dtype_q == 1 && dtype_kv == 1) REPRO_CP_CALL(bf16, bf16);
  if (dtype_q == 0 && dtype_kv == 1) REPRO_CP_CALL(float, bf16);
  if (dtype_q == 1 && dtype_kv == 0) REPRO_CP_CALL(bf16, float);
#undef REPRO_CP_CALL
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
