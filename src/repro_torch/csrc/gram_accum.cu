// Gram matrix of one token chunk: G = a^T a, a (K tokens, N features) fp32 or
// bf16, G (N, N) fp32, full and symmetric.
//
// Replaces the Pallas kernel src/repro/kernels/gram_accum.py:24-49
// (`_kernel` / `gram_accum`): grid (N/bi, N/bj, K/bk) with the output block
// revisited across the sequential K axis.
//
// What bounds it on the H100: K*N*(N+1) FLOPs for the distinct half of G
// against reading a once and writing N^2 fp32. At the calibration shapes
// (K 512, N 2048 and 8192) that is 2.1 and 34 GFLOP against 8 and 285 MB,
// so it is bound by operations: exact fp32 FMAs on the CUDA cores (the Grams
// feed Cholesky and SVDs, so no TF32). The first cut reached a third of that
// peak: 4-byte synchronous loads with nothing in flight during the FMAs, 136
// blocks for 132 SMs at N = 2048 (one block each, four SMs a second round),
// and the mirror written as 4-byte stores at a stride of N floats.
//
// Design: a tiled K-reduction of a^T a over the upper triangle of BT x BT
// tiles (ti <= tj), each thread holding an 8 x 8 fp32 accumulator in
// registers (rows ty*4 + {0..3} and BT/2 + ty*4 + {0..3}, columns likewise
// with tx, so the shared-memory reads are 16-byte and conflict-free). Two
// tile shapes: 128 x 128 with 256 threads, two blocks to an SM, and 64 x 64
// with 64 threads, four to an SM.
// - Load path: row k of `a` holds a tile's columns as one contiguous
//   segment, copied with 16-byte cp.async into a ring of 4 shared-memory
//   stages of 16 tokens (the stages after the current one are in flight
//   while its FMAs run, one __syncthreads per stage). A diagonal tile stages
//   its one panel once. Element loads with zero fill only at N's edge or
//   where a row is not 16-byte aligned; tokens past K are zeros.
// - Filling the card (kernels/gram_accum.py::plan): at N = 2048 the 136
//   tiles of 128 leave most of the 264 resident blocks empty, so the plan
//   takes the 64-tile wherever its grid fits the card's resident slots in
//   one round: 528 tiles of 64 fill the card's 528 slots at N = 2048, and
//   2080 tiles of 128 fill it at N = 8192. No block splits K, so each tile
//   is one block's in-order sum: no atomics on G, the same bits on every
//   run.
// - Epilogue: the tile G[i-tile][j-tile] leaves straight from the registers
//   as 16-byte stores (a row of the thread grid writes BT * 2 contiguous
//   bytes); an off-diagonal tile is then staged transposed in shared memory
//   (16-byte slots XOR-swizzled by row, conflict-free both ways) and its
//   mirror G[j-tile][i-tile] leaves as whole rows (BT * 4 bytes) of 16-byte
//   stores. A diagonal tile is symmetric as computed, since
//   fmaf(x, y, z) == fmaf(y, x, z) and both halves sum the same tokens in
//   the same order.
// The sum across calibration records stays a tensor add outside the kernel,
// as in core/calibrate.py.

#include "common.cuh"

namespace {

constexpr int BK = 16;         // tokens per shared-memory stage
constexpr int STAGES = 4;      // ring depth

// One tile shape: a BT x BT tile of G per block, (BT/8)^2 threads each with
// an 8 x 8 block of it; MIN_BLOCKS resident per SM.
template <typename T, int BT>
struct Tile {
  static constexpr int THREADS = (BT / 8) * (BT / 8);
  static constexpr int TX = BT / 8;                    // threads per row of the grid
  static constexpr int MIN_BLOCKS = BT == 128 ? 2 : 4;
  static constexpr int VEC = 16 / sizeof(T);           // elements per 16-byte chunk
  static constexpr int CPR = BT / VEC;                 // chunks per panel row
  static constexpr int CPT = BK * CPR / THREADS;       // chunks per thread and panel
  static constexpr int SPR = BT / 4;                   // 16-byte slots per tile row
  static constexpr size_t ring = (size_t)STAGES * 2 * BK * BT * sizeof(T);
  static constexpr size_t tile = (size_t)BT * BT * sizeof(float);   // epilogue
  static constexpr size_t bytes = ring > tile ? ring : tile;
  static_assert(BK * CPR % THREADS == 0, "a stage's panel is whole chunks per thread");
  static_assert(SPR >= 8 && THREADS % SPR == 0, "the mirror's rows are whole warp phases");
};

// Issues the stage of tokens [kb, kb + BK) of the two column panels
// a[k, i0:i0+BT] and a[k, j0:j0+BT] (one panel on a diagonal tile) into ring
// slot `slot`. Thread t copies chunks t + THREADS * c: the fast path (whole
// stage inside K, both panels inside N, rows 16-byte aligned) is CPT
// unconditional cp.async per panel.
template <typename T, int BT>
__device__ __forceinline__ void issue_stage(const T* __restrict__ a, T* ring, int slot,
                                            int kb, int k_end, int i0, int j0, int N,
                                            int npanels, bool fast, bool vec) {
  using TL = Tile<T, BT>;
  constexpr int VEC = TL::VEC, CPR = TL::CPR, THREADS = TL::THREADS;
  if (fast && kb + BK <= k_end) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (p >= npanels) continue;
      const int col = p == 0 ? i0 : j0;
#pragma unroll
      for (int c = 0; c < TL::CPT; ++c) {
        const int e = threadIdx.x + THREADS * c;
        const int kk = e / CPR, part = e % CPR;
        cp_async16(ring + (((size_t)slot * 2 + p) * BK + kk) * BT + part * VEC,
                   a + (size_t)(kb + kk) * N + col + part * VEC);
      }
    }
    return;
  }
  for (int c = threadIdx.x; c < npanels * BK * CPR; c += THREADS) {
    const int p = c / (BK * CPR), rem = c % (BK * CPR);
    const int kk = rem / CPR, part = rem % CPR;
    const int col = (p == 0 ? i0 : j0) + part * VEC;
    const int k = kb + kk;
    T* dst = ring + (((size_t)slot * 2 + p) * BK + kk) * BT + part * VEC;
    const T* src = a + (size_t)k * N + col;
    if (k < k_end && col + VEC <= N) {
      copy16<T>(dst, src, true, vec);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        dst[e] = k < k_end && col + e < N ? src[e] : from_f<T>(0.f);
    }
  }
}

// grid: the upper-triangle tiles; each block sums all K tokens of its tile.
template <typename T, int BT>
__global__ void __launch_bounds__(Tile<T, BT>::THREADS, Tile<T, BT>::MIN_BLOCKS)
gram_accum_kernel(const T* __restrict__ a, float* __restrict__ g, int K, int N, int nt,
                  int vec) {
  using TL = Tile<T, BT>;
  constexpr int THREADS = TL::THREADS, TX = TL::TX, H = BT / 2, SPR = TL::SPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);          // [STAGES][2][BK][BT]
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  // linear tile index -> upper-triangle tile (ti, tj), ti <= tj
  const int tile = blockIdx.x;
  int idx = tile, ti = 0;
  while (idx >= nt - ti) {
    idx -= nt - ti;
    ++ti;
  }
  const int tj = ti + idx;
  const int i0 = ti * BT, j0 = tj * BT;
  const bool diag = ti == tj;
  const int npanels = diag ? 1 : 2;
  const int nk = (K + BK - 1) / BK;
  const bool fast = vec && j0 + BT <= N;   // j0 >= i0: both panels inside N

  // rows ty*4 + {0..3} and H + ty*4 + {0..3}, columns likewise with tx
  float acc[8][8];
#pragma unroll
  for (int x = 0; x < 8; ++x)
#pragma unroll
    for (int y = 0; y < 8; ++y) acc[x][y] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      issue_stage<T, BT>(a, ring, s, s * BK, K, i0, j0, N, npanels, fast, vec);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();            // stage kt landed; slot (kt - 1) % STAGES is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk)
      issue_stage<T, BT>(a, ring, nxt % STAGES, nxt * BK, K, i0, j0, N, npanels, fast,
                         vec);
    cp_async_commit();
    const T* xi = ring + (size_t)(kt % STAGES) * 2 * BK * BT;
    const T* yj = diag ? xi : xi + BK * BT;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 x0 = load4<T>(xi + kk * BT + ty * 4);
      const float4 x1 = load4<T>(xi + kk * BT + H + ty * 4);
      const float4 y0 = load4<T>(yj + kk * BT + tx * 4);
      const float4 y1 = load4<T>(yj + kk * BT + H + tx * 4);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[x][y] = fmaf(xv[x], yv[y], acc[x][y]);
    }
  }
  cp_async_wait<0>();

  // G[i-tile][j-tile] from the registers
  const bool row_vec = N % 4 == 0;
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const int i = i0 + (x < 4 ? ty * 4 + x : H + ty * 4 + x - 4);
    if (i >= N) continue;
#pragma unroll
    for (int yh = 0; yh < 2; ++yh) {
      const int j = j0 + yh * H + tx * 4;
      float* dst = g + (size_t)i * N + j;
      if (row_vec && j + 4 <= N) {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[x][4 * yh], acc[x][4 * yh + 1],
                                                      acc[x][4 * yh + 2], acc[x][4 * yh + 3]);
      } else {
#pragma unroll
        for (int y = 0; y < 4; ++y)
          if (j + y < N) dst[y] = acc[x][4 * yh + y];
      }
    }
  }
  if (diag) return;

  // the mirror G[j-tile][i-tile]: stage the tile transposed, ts[c][r] for
  // tile row r and column c, as SPR 16-byte slots per row with slot r / 4
  // stored at (r / 4) ^ ((c / 4) % 8): conflict-free both ways
  __syncthreads();              // every warp is done with the ring
  float4* ts = reinterpret_cast<float4*>(smem_raw);   // [BT][SPR]
#pragma unroll
  for (int xh = 0; xh < 2; ++xh)
#pragma unroll
    for (int yh = 0; yh < 2; ++yh)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int c = yh * H + tx * 4 + y;
        const int q = xh * TX + ty;
        ts[c * SPR + (q ^ ((c >> 2) & 7))] =
            make_float4(acc[xh * 4][4 * yh + y], acc[xh * 4 + 1][4 * yh + y],
                        acc[xh * 4 + 2][4 * yh + y], acc[xh * 4 + 3][4 * yh + y]);
      }
  __syncthreads();
  const int q = tid % SPR;
  for (int c = tid / SPR; c < BT; c += THREADS / SPR) {
    const int j = j0 + c;
    if (j >= N) break;
    const float4 v = ts[c * SPR + (q ^ ((c >> 2) & 7))];
    const int i = i0 + q * 4;
    float* dst = g + (size_t)j * N + i;
    if (row_vec && i + 4 <= N) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i + e < N) dst[e] = w[e];
    }
  }
}

template <typename T, int BT>
cudaError_t launch(const void* a, float* g, int K, int N, cudaStream_t stream) {
  using TL = Tile<T, BT>;
  static bool configured[MAX_DEVICES] = {};
  cudaError_t err = smem_limit_once(reinterpret_cast<const void*>(gram_accum_kernel<T, BT>),
                                    (int)TL::bytes, configured);
  if (err != cudaSuccess) return err;
  const int nt = (N + BT - 1) / BT;
  const unsigned tiles = (unsigned)((long long)nt * (nt + 1) / 2);
  const int vec = aligned16(a) && N % TL::VEC == 0;
  gram_accum_kernel<T, BT><<<tiles, TL::THREADS, TL::bytes, stream>>>(
      static_cast<const T*>(a), g, K, N, nt, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile(const void* a, float* g, int K, int N, int tile, cudaStream_t stream) {
  if (tile == 128) return launch<T, 128>(a, g, K, N, stream);
  if (tile == 64) return launch<T, 64>(a, g, K, N, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// a (K, N) contiguous; g (N, N) fp32. The plan (kernels/gram_accum.py) picks
// the tile edge, 64 or 128. dtype: 0 = f32, 1 = bf16.
int repro_gram_accum(const void* a, void* g, int K, int N, int tile, int dtype,
                     void* stream) {
  if (K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* gf = static_cast<float*>(g);
  if (dtype == 0) return (int)launch_tile<float>(a, gf, K, N, tile, s);
  if (dtype == 1) return (int)launch_tile<__nv_bfloat16>(a, gf, K, N, tile, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
