// Low-rank (COALA-factored) linear layer: y = cast(x @ b_t) @ a_t.
//
// Replaces the Pallas kernel src/repro/kernels/lowrank_linear.py:27-61
// (`_kernel` / `lowrank_linear`), which fuses both products per (bm, bn)
// output tile and recomputes the (bm, r) intermediate for every column block.
//
// What bounds it on the H100: at decode (M <= 16 rows) reading b_t and a_t
// once, e.g. one llama3_1b layer's seven projections at ratio 0.6 are 146 MB
// of fp32 weights, 44 us at 3.35 TB/s; at prefill (M = 256) the fp32 FMAs,
// 2*M*r*(d_in + d_out) = 18.7 GFLOP per layer, 0.28 ms at 67 TFLOP/s.
//
// Design: two products, t = x @ b_t (stored in x's dtype: the cast of
// lowrank_linear.py:30) then y = t @ a_t, one launch each. Not fused: fusing
// per row tile re-reads b_t once per output column block, which multiplies
// the bytes that bound decode. The launch plan (kernel, split-K chunks) is
// made by the Python wrapper, kernels/lowrank_linear.py, and checked here.
// - fp32 decode (M <= 16): a streaming skinny GEMM. A block owns 128 output
//   columns and one K chunk; x's K slice sits in shared memory (transposed,
//   so each k's M values are float4 broadcasts) and the weight rows stream
//   through a 4-stage ring of 16-row cp.async stages (16-byte copies, 32 KB
//   in flight per block). Weight rows of r = 245, 614, 983 floats are not
//   16-byte aligned, so each row segment is copied as its 16-byte aligned
//   envelope and read back at the row's own offset; copies that would run
//   past the matrix (or any copy, for an unaligned base pointer) are scalar.
//   8 warps take interleaved rows and are summed in shared memory at the end.
// - fp32 prefill (M > 16): register-blocked tiles, each thread 8 x 8 fp32
//   accumulators (rows ty*4 + {0..3, BM/2 + 0..3}, columns tx*4 + {0..3,
//   BN/2 + 0..3}: float4 shared reads without bank conflicts, as
//   gram_accum.cu), BK = 8, double-buffered shared memory fed through
//   registers with 16-byte loads where a row allows them (4-byte otherwise):
//   the next K step's loads are in flight while the current one is computed.
//   64 x 64 tiles of 64 threads, eight blocks to an SM: the paths' prefills
//   (M <= 512 rows) give grids too thin for larger tiles to fill 132 SMs.
// - bf16: tensor cores (mma.sync.m16n8k16, fp32 accumulation, fragments by
//   ldmatrix from padded shared tiles, double-buffered through registers),
//   a 16 x 128 tile at decode (M padded to 16 with zero rows) and 128 x 128
//   (8 warps of 64 x 32) at prefill.
// - split-K stays inside the launch: each block of a split tile writes its
//   fp32 partial, bumps the tile's arrival counter after a __threadfence, and
//   the last block to arrive sums the partials in split order (deterministic)
//   and writes the output; it then resets the counter to 0 for the next call.
// Every ragged edge is masked with zero fill; no shape falls back.

#include "common.cuh"

namespace {

// Called by every thread of a block after it stored its fp32 partial of the
// BM x BN tile at (m0, n0) into work[z]. The last block of the tile to
// arrive sums all splits' partials in split order and writes C. Each thread
// takes G of its elements at a time and loads them for U splits before it
// adds, so G*U loads (64 for the prefill tiles' 64 elements per thread, 32
// otherwise, to spare registers) are in flight per thread: the sum is bound
// by the L2 bandwidth of one SM (the plan caps splits x tile bytes), not by
// one load's latency per split.
template <typename T, int BM, int BN, int THREADS>
__device__ void splitk_finish(const float* work, T* C, int* counters, int tile, int splits,
                              int M, int N, int m0, int n0) {
  constexpr int EPT = (BM * BN + THREADS - 1) / THREADS;   // elements per thread
  constexpr int G = EPT < 16 ? EPT : 16;
  constexpr int IN_FLIGHT = EPT >= 64 ? 64 : 32;
  constexpr int U = IN_FLIGHT / G < 16 ? IN_FLIGHT / G : 16;
  static_assert(EPT % G == 0, "element groups must tile the thread's elements");
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&counters[tile], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t mn = (size_t)M * N;
  const int rows = min(BM, M - m0), cols = min(BN, N - n0);
#pragma unroll 1
  for (int g0 = 0; g0 < EPT; g0 += G) {
    size_t off[G];
    bool ok[G];
    float acc[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int e = threadIdx.x + (g0 + i) * THREADS;
      const int r = e / BN, c = e % BN;
      ok[i] = r < rows && c < cols;
      off[i] = ok[i] ? (size_t)(m0 + r) * N + n0 + c : 0;
      acc[i] = 0.f;
    }
    int z = 0;
    for (; z + U <= splits; z += U) {
      float v[U][G];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < G; ++i) v[u][i] = ok[i] ? __ldcg(work + (z + u) * mn + off[i]) : 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < G; ++i) acc[i] += v[u][i];
    }
    for (; z < splits; ++z) {
      float v[G];
#pragma unroll
      for (int i = 0; i < G; ++i) v[i] = ok[i] ? __ldcg(work + z * mn + off[i]) : 0.f;
#pragma unroll
      for (int i = 0; i < G; ++i) acc[i] += v[i];
    }
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (ok[i]) C[off[i]] = from_f<T>(acc[i]);
  }
  if (threadIdx.x == 0) counters[tile] = 0;
}

// Stores one result of split z: straight to C when K is not split.
template <typename T>
__device__ __forceinline__ void put(T* C, float* work, int z, int splits, size_t mn,
                                    size_t off, float v) {
  if (splits == 1)
    C[off] = from_f<T>(v);
  else
    work[z * mn + off] = v;
}

// ---------------------------------------------------------------------------
// fp32 decode: streaming skinny GEMM
// ---------------------------------------------------------------------------

constexpr int D_THREADS = 256;             // 8 warps
constexpr int D_BN = 128;                  // output columns per block
constexpr int D_KS = 16;                   // weight rows per ring stage
constexpr int D_NS = 4;                    // ring stages
constexpr int D_ROW = D_BN + 4;            // a row's 16-byte envelope, in floats
constexpr int D_RING = D_NS * D_KS * D_ROW;
constexpr int D_KMAX = 512;                // most k per split (x's slice in smem)

template <int MT>
constexpr size_t decode_smem_bytes() {
  return (size_t)(D_RING + D_KMAX * MT) * sizeof(float);
}

// C (M, N) = A (M, K) @ B (K, N), M <= MT. Block (x, z): columns
// [128x, 128x + 128), k in [z*kchunk, min(K, (z+1)*kchunk)).
template <int MT>
__global__ void __launch_bounds__(D_THREADS)
decode_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
              float* __restrict__ work, int* __restrict__ counters, int M, int N, int K,
              int kchunk, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                        // [D_NS][D_KS][D_ROW]
  float* xs = smem + D_RING;                 // [kchunk][MT], x's K slice transposed
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * D_BN;
  const int z = blockIdx.y, splits = gridDim.y;
  const int kb = z * kchunk, ke = min(K, kb + kchunk);
  const int ncols = min(D_BN, N - n0);
  const size_t total = (size_t)K * N;
  const int nstages = (ke - kb + D_KS - 1) / D_KS;
  const int chunks = (ncols + 3) / 4 + 1;    // 16-byte chunks of a row's envelope

  // Stage s holds rows kb + s*D_KS + kk; row kk's envelope starts at the
  // 4-float boundary at or below B[k][n0], so B[k][n0 + j] lands at
  // ring[kk][shift + j] with shift = (k*N + n0) % 4.
  auto issue = [&](int s) {
    if (s < nstages) {
      float* dst = ring + (s % D_NS) * D_KS * D_ROW;
      for (int e = tid; e < D_KS * chunks; e += D_THREADS) {
        const int kk = e / chunks, c = e % chunks;
        const int k = kb + s * D_KS + kk;
        if (k >= ke) continue;
        const size_t first = (size_t)k * N + n0;
        const size_t g = (first & ~(size_t)3) + 4 * (size_t)c;
        if (g >= first + ncols) continue;
        float* d = dst + kk * D_ROW + 4 * c;
        if (vec && g + 4 <= total) {
          cp_async16(d, B + g);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) d[i] = g + i < total ? B[g + i] : 0.f;
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < D_NS - 1; ++s) issue(s);
  const int kc = ke - kb;
  for (int e = tid; e < MT * kc; e += D_THREADS) {
    const int m = e / kc, kk = e % kc;
    xs[kk * MT + m] = m < M ? A[(size_t)m * K + kb + kk] : 0.f;
  }

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<D_NS - 2>();
    __syncthreads();                         // stage s landed; stage s-1 consumed
    issue(s + D_NS - 1);
    const float* buf = ring + (s % D_NS) * D_KS * D_ROW;
#pragma unroll
    for (int kk = warp; kk < D_KS; kk += D_THREADS / 32) {
      const int k = kb + s * D_KS + kk;
      if (k >= ke) break;
      const int shift = (int)(((size_t)k * N + n0) & 3);
      const float* row = buf + kk * D_ROW + shift + lane;
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = row[32 * j];
      const float* xr = xs + (k - kb) * MT;
#pragma unroll
      for (int m4 = 0; m4 < MT; m4 += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + m4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[m4 + 0][j] = fmaf(xv.x, b[j], acc[m4 + 0][j]);
          acc[m4 + 1][j] = fmaf(xv.y, b[j], acc[m4 + 1][j]);
          acc[m4 + 2][j] = fmaf(xv.z, b[j], acc[m4 + 2][j]);
          acc[m4 + 3][j] = fmaf(xv.w, b[j], acc[m4 + 3][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // sum the 8 warps' partial sums in warp order, RG rows at a time, through
  // the (now idle) ring
  constexpr int RG = MT < 8 ? MT : 8;
  constexpr int NW = D_THREADS / 32;
  static_assert(NW * RG * D_BN <= D_RING, "reduction buffer exceeds the ring");
  float* red = smem;                         // [NW][RG][D_BN]
  const size_t mn = (size_t)M * N;
#pragma unroll
  for (int g0 = 0; g0 < MT; g0 += RG) {
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[(warp * RG + i) * D_BN + lane + 32 * j] = acc[g0 + i][j];
    __syncthreads();
    for (int e = tid; e < RG * D_BN; e += D_THREADS) {
      const int i = e / D_BN, n = e % D_BN;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += red[(w * RG + i) * D_BN + n];
      const int m = g0 + i;
      if (m < M && n < ncols) put<float>(C, work, z, splits, mn, (size_t)m * N + n0 + n, s);
    }
    __syncthreads();
  }
  if (splits > 1)
    splitk_finish<float, MT, D_BN, D_THREADS>(work, C, counters, blockIdx.x, splits, M, N, 0, n0);
}

// ---------------------------------------------------------------------------
// fp32 prefill: 64 x 64 register-blocked tile
// ---------------------------------------------------------------------------

constexpr int P_BK = 8;
constexpr int P_BM = 64, P_BN = 64;
constexpr int P_THREADS = P_BM * P_BN / 64;

// Block (x, y, z): output tile rows [BM*y, +BM), columns [BN*x, +BN), k in
// [z*kchunk, min(K, (z+1)*kchunk)); (BM/8) x (BN/8) threads, each owning
// 8 x 8 outputs. vecA / vecB: 16-byte loads of A / B rows are aligned (base
// aligned, row stride a multiple of 4 floats).
__global__ void __launch_bounds__(P_THREADS, 8)
prefill_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
               float* __restrict__ work, int* __restrict__ counters, int M, int N, int K,
               int kchunk, int vecA, int vecB) {
  constexpr int BM = P_BM, BN = P_BN, THREADS = P_THREADS;
  constexpr int TX = BN / 8;                 // threads along a row of the tile
  constexpr int NA = 2 * BM / THREADS;       // float4 groups of A per thread and stage
  constexpr int NB = 2 * BN / THREADS;       // float4 groups of B per thread and stage
  static_assert(NA >= 1 && NB >= 1, "tile too small for its threads");
  __shared__ __align__(16) float As[2][P_BK][BM];   // A tile, transposed: As[k][m]
  __shared__ __align__(16) float Bs[2][P_BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int z = blockIdx.z, splits = gridDim.z;
  const int kb = z * kchunk, ke = min(K, kb + kchunk);
  float ra[NA][4], rb[NB][4];

  // A group g: 4 consecutive k of row g / 2; B group g: 4 consecutive
  // columns of row g / (BN / 4)
  auto load = [&](int k0) {
#pragma unroll
    for (int p = 0; p < NA; ++p) {
      const int g = tid + p * THREADS;
      const int gm = m0 + g / 2, gk = k0 + (g % 2) * 4;
      if (vecA && gm < M && gk + 3 < ke) {
        const float4 v = *reinterpret_cast<const float4*>(A + (size_t)gm * K + gk);
        ra[p][0] = v.x; ra[p][1] = v.y; ra[p][2] = v.z; ra[p][3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ra[p][i] = gm < M && gk + i < ke ? A[(size_t)gm * K + gk + i] : 0.f;
      }
    }
#pragma unroll
    for (int p = 0; p < NB; ++p) {
      const int g = tid + p * THREADS;
      const int hk = k0 + g / (BN / 4), gn = n0 + (g % (BN / 4)) * 4;
      if (vecB && hk < ke && gn + 3 < N) {
        const float4 v = *reinterpret_cast<const float4*>(B + (size_t)hk * N + gn);
        rb[p][0] = v.x; rb[p][1] = v.y; rb[p][2] = v.z; rb[p][3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rb[p][i] = hk < ke && gn + i < N ? B[(size_t)hk * N + gn + i] : 0.f;
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int p = 0; p < NA; ++p) {
      const int g = tid + p * THREADS;
#pragma unroll
      for (int i = 0; i < 4; ++i) As[buf][(g % 2) * 4 + i][g / 2] = ra[p][i];
    }
#pragma unroll
    for (int p = 0; p < NB; ++p) {
      const int g = tid + p * THREADS;
      *reinterpret_cast<float4*>(&Bs[buf][g / (BN / 4)][(g % (BN / 4)) * 4]) =
          make_float4(rb[p][0], rb[p][1], rb[p][2], rb[p][3]);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int x = 0; x < 8; ++x)
#pragma unroll
    for (int y = 0; y < 8; ++y) acc[x][y] = 0.f;

  const int nk = (ke - kb + P_BK - 1) / P_BK;
  load(kb);
  store(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    if (t + 1 < nk) load(kb + (t + 1) * P_BK);   // next stage in flight during compute
#pragma unroll
    for (int kk = 0; kk < P_BK; ++kk) {
      const float4 x0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 x1 = *reinterpret_cast<const float4*>(&As[cur][kk][BM / 2 + ty * 4]);
      const float4 y0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 y1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][BN / 2 + tx * 4]);
      const float xi[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float yj[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[x][y] = fmaf(xi[x], yj[y], acc[x][y]);
    }
    if (t + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

  const size_t mn = (size_t)M * N;
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const int i = m0 + (x < 4 ? ty * 4 + x : BM / 2 + ty * 4 + x - 4);
    if (i >= M) continue;
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      const int j = n0 + (y < 4 ? tx * 4 + y : BN / 2 + tx * 4 + y - 4);
      if (j < N) put<float>(C, work, z, splits, mn, (size_t)i * N + j, acc[x][y]);
    }
  }
  if (splits > 1)
    splitk_finish<float, BM, BN, THREADS>(work, C, counters, blockIdx.y * gridDim.x + blockIdx.x,
                                          splits, M, N, m0, n0);
}

// ---------------------------------------------------------------------------
// bf16: tensor-core tile (mma.sync.m16n8k16, fp32 accumulation)
// ---------------------------------------------------------------------------

constexpr int T_BN = 128, T_BK = 32;
constexpr int T_ALD = T_BK + 8;            // padded shared rows (bf16 elements):
constexpr int T_BLD = T_BN + 8;            // 16-byte aligned, ldmatrix conflict-free

// 8 consecutive bf16 of one row, as raw bits: elements at col + i >= limit
// (or the whole chunk when !ok) are zero. vec: the chunk is 16-byte aligned.
__device__ __forceinline__ uint4 load8(const uint16_t* row, int col, int limit, bool ok,
                                       bool vec) {
  if (!ok) return make_uint4(0, 0, 0, 0);
  if (vec && col + 8 <= limit) return *reinterpret_cast<const uint4*>(row + col);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = col + 2 * i < limit ? row[col + 2 * i] : 0u;
    const uint32_t hi = col + 2 * i + 1 < limit ? row[col + 2 * i + 1] : 0u;
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Block (x, y, z): output tile rows [BM*y, +BM), columns [128x, +128), k in
// [z*kchunk, min(K, (z+1)*kchunk)); WM x WN warps, each 16*MI rows x 32.
template <int BM, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
mma_kernel(const __nv_bfloat16* __restrict__ Ab, const __nv_bfloat16* __restrict__ Bb,
           __nv_bfloat16* __restrict__ C, float* __restrict__ work, int* __restrict__ counters,
           int M, int N, int K, int kchunk, int vecA, int vecB) {
  constexpr int THREADS = WM * WN * 32;
  constexpr int MI = BM / WM / 16;           // m16 tiles per warp
  constexpr int NI = T_BN / WN / 8;          // n8 tiles per warp
  static_assert(NI % 2 == 0, "B fragments are loaded two n8 tiles at a time");
  constexpr int A_CH = BM * (T_BK / 8);      // 16-byte chunks per A tile
  constexpr int B_CH = T_BK * (T_BN / 8);
  constexpr int A_PER = (A_CH + THREADS - 1) / THREADS;
  constexpr int B_PER = B_CH / THREADS;
  static_assert(B_CH % THREADS == 0, "B tile chunks must spread evenly");
  __shared__ __align__(16) uint16_t As[2][BM][T_ALD];
  __shared__ __align__(16) uint16_t Bs[2][T_BK][T_BLD];
  const uint16_t* A = reinterpret_cast<const uint16_t*>(Ab);
  const uint16_t* B = reinterpret_cast<const uint16_t*>(Bb);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * T_BN;
  const int z = blockIdx.z, splits = gridDim.z;
  const int kb = z * kchunk, ke = min(K, kb + kchunk);
  uint4 ra[A_PER], rb[B_PER];

  auto load = [&](int k0) {
#pragma unroll
    for (int p = 0; p < A_PER; ++p) {
      const int c = tid + p * THREADS;
      const int r = c / (T_BK / 8), col = k0 + (c % (T_BK / 8)) * 8;
      const int gm = m0 + r;
      ra[p] = load8(A + (size_t)min(gm, M - 1) * K, col, ke, c < A_CH && gm < M, vecA);
    }
#pragma unroll
    for (int p = 0; p < B_PER; ++p) {
      const int c = tid + p * THREADS;
      const int r = c / (T_BN / 8), col = n0 + (c % (T_BN / 8)) * 8;
      const int gk = k0 + r;
      rb[p] = load8(B + (size_t)min(gk, K - 1) * N, col, N, gk < ke, vecB);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int p = 0; p < A_PER; ++p) {
      const int c = tid + p * THREADS;
      if (c < A_CH)
        *reinterpret_cast<uint4*>(&As[buf][c / (T_BK / 8)][(c % (T_BK / 8)) * 8]) = ra[p];
    }
#pragma unroll
    for (int p = 0; p < B_PER; ++p) {
      const int c = tid + p * THREADS;
      *reinterpret_cast<uint4*>(&Bs[buf][c / (T_BN / 8)][(c % (T_BN / 8)) * 8]) = rb[p];
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int nk = (ke - kb + T_BK - 1) / T_BK;
  load(kb);
  store(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    if (t + 1 < nk) load(kb + (t + 1) * T_BK);
#pragma unroll
    for (int kk = 0; kk < T_BK; kk += 16) {
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(a[i], &As[cur][wm * (BM / WM) + i * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &Bs[cur][kk + (lane & 15)][wn * (T_BN / WN) + j * 8 + (lane >> 4) * 8]);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    if (t + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

  // C fragment: acc[i][j][0..1] at row lane/4, columns (lane%4)*2 + {0, 1};
  // acc[i][j][2..3] eight rows below
  const size_t mn = (size_t)M * N;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m0 + wm * (BM / WM) + i * 16 + lane / 4 + (q >= 2 ? 8 : 0);
        const int col = n0 + wn * (T_BN / WN) + j * 8 + (lane % 4) * 2 + (q & 1);
        if (row < M && col < N)
          put<__nv_bfloat16>(C, work, z, splits, mn, (size_t)row * N + col, acc[i][j][q]);
      }
  if (splits > 1)
    splitk_finish<__nv_bfloat16, BM, T_BN, THREADS>(
        work, C, counters, blockIdx.y * gridDim.x + blockIdx.x, splits, M, N, m0, n0);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

constexpr int SMALL_M = 16;

// A plan is (splits, kchunk): every split non-empty, together covering K,
// kchunk a multiple of the kernel's K step (and within the fp32 decode
// kernel's shared x slice).
bool plan_ok(int K, int splits, int kchunk, int step, int kmax) {
  return splits >= 1 && kchunk > 0 && kchunk % step == 0 && kchunk <= kmax &&
         (long long)(splits - 1) * kchunk < K && (long long)splits * kchunk >= K;
}

template <int MT>
cudaError_t launch_decode(const float* A, const float* B, float* C, float* work, int* counters,
                          int M, int N, int K, int splits, int kchunk, cudaStream_t stream) {
  static bool configured[MAX_DEVICES] = {};
  cudaError_t err = smem_limit_once(reinterpret_cast<const void*>(decode_kernel<MT>),
                                    (int)decode_smem_bytes<MT>(), configured);
  if (err != cudaSuccess) return err;
  const size_t bytes = (size_t)(D_RING + kchunk * MT) * sizeof(float);
  dim3 grid((N + D_BN - 1) / D_BN, splits);
  decode_kernel<MT><<<grid, D_THREADS, bytes, stream>>>(A, B, C, work, counters, M, N, K,
                                                        kchunk, aligned16(B) ? 1 : 0);
  return cudaGetLastError();
}

cudaError_t launch_prefill(const float* A, const float* B, float* C, float* work, int* counters,
                           int M, int N, int K, int splits, int kchunk, cudaStream_t stream) {
  dim3 grid((N + P_BN - 1) / P_BN, (M + P_BM - 1) / P_BM, splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  prefill_kernel<<<grid, P_THREADS, 0, stream>>>(
      A, B, C, work, counters, M, N, K, kchunk, aligned16(A) && K % 4 == 0,
      aligned16(B) && N % 4 == 0);
  return cudaGetLastError();
}

// tile: 16 = the decode kernel (M <= 16), 64 = the prefill tile.
cudaError_t gemm_f32(const float* A, const float* B, float* C, float* work, int* counters, int M,
                     int N, int K, int splits, int kchunk, int tile, cudaStream_t stream) {
  if (tile == SMALL_M && M <= SMALL_M) {
    if (!plan_ok(K, splits, kchunk, D_KS, D_KMAX)) return cudaErrorInvalidValue;
    if (M <= 4) return launch_decode<4>(A, B, C, work, counters, M, N, K, splits, kchunk, stream);
    if (M <= 8) return launch_decode<8>(A, B, C, work, counters, M, N, K, splits, kchunk, stream);
    return launch_decode<16>(A, B, C, work, counters, M, N, K, splits, kchunk, stream);
  }
  if (tile != P_BM || !plan_ok(K, splits, kchunk, P_BK, 1 << 30)) return cudaErrorInvalidValue;
  return launch_prefill(A, B, C, work, counters, M, N, K, splits, kchunk, stream);
}

// tile: 16 (decode, M <= 16, padded to 16 rows) or 128.
cudaError_t gemm_bf16(const __nv_bfloat16* A, const __nv_bfloat16* B, __nv_bfloat16* C,
                      float* work, int* counters, int M, int N, int K, int splits, int kchunk,
                      int tile, cudaStream_t stream) {
  if (!plan_ok(K, splits, kchunk, T_BK, 1 << 30)) return cudaErrorInvalidValue;
  const int va = aligned16(A) && K % 8 == 0, vb = aligned16(B) && N % 8 == 0;
  if (tile == SMALL_M && M <= SMALL_M) {
    dim3 grid((N + T_BN - 1) / T_BN, 1, splits);
    mma_kernel<16, 1, 4><<<grid, 128, 0, stream>>>(A, B, C, work, counters, M, N, K, kchunk,
                                                   va, vb);
  } else if (tile == 128) {
    dim3 grid((N + T_BN - 1) / T_BN, (M + 127) / 128, splits);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    mma_kernel<128, 2, 4><<<grid, 256, 0, stream>>>(A, B, C, work, counters, M, N, K, kchunk,
                                                    va, vb);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y (M, d_out) = cast(x (M, d_in) @ bt (d_in, r)) @ at (r, d_out); t is an
// (M, r) scratch of the same dtype; work (fp32) and counters (int32, zero at
// rest) are the split-K scratch the plan needs. (splits, kchunk, tile) of
// each product is its plan (kernels/lowrank_linear.py). dtype: 0 = float32,
// 1 = bfloat16.
int repro_lowrank_linear(const void* x, const void* bt, const void* at, void* y, void* t,
                         void* work, void* counters, int M, int d_in, int r, int d_out,
                         int splits1, int kchunk1, int tile1, int splits2, int kchunk2,
                         int tile2, int dtype, void* stream) {
  if (M <= 0 || d_in <= 0 || r <= 0 || d_out <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  int* cnt = static_cast<int*>(counters);
  cudaError_t err;
  if (dtype == 0) {
    err = gemm_f32(static_cast<const float*>(x), static_cast<const float*>(bt),
                   static_cast<float*>(t), w, cnt, M, r, d_in, splits1, kchunk1, tile1, s);
    if (err != cudaSuccess) return (int)err;
    return (int)gemm_f32(static_cast<const float*>(t), static_cast<const float*>(at),
                         static_cast<float*>(y), w, cnt, M, d_out, r, splits2, kchunk2, tile2,
                         s);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    err = gemm_bf16(static_cast<const bf*>(x), static_cast<const bf*>(bt), static_cast<bf*>(t),
                    w, cnt, M, r, d_in, splits1, kchunk1, tile1, s);
    if (err != cudaSuccess) return (int)err;
    return (int)gemm_bf16(static_cast<const bf*>(t), static_cast<const bf*>(at),
                          static_cast<bf*>(y), w, cnt, M, d_out, r, splits2, kchunk2, tile2, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
