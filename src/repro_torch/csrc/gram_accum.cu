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
// so it is bound by operations: fp32 FMAs on the CUDA cores here (tensor
// cores are later work).
//
// Design: a tiled K-reduction GEMM of a^T a. One block per 128 x 128 tile of
// the upper triangle (ti <= tj), 256 threads, each holding an 8 x 8 fp32
// accumulator in registers (rows ty*4 + {0..3, 64..67}, columns tx*4 + {0..3,
// 64..67}, so the shared-memory reads are float4 and conflict-free). The K
// loop stages 8 tokens of the two column panels a[:, i-tile] and a[:, j-tile]
// in shared memory as fp32; the K cursor is a loop inside the block because
// CUDA blocks run in no order. Off-diagonal tiles are written twice (G[i][j]
// and the mirror G[j][i]); a diagonal tile is symmetric as computed, since
// fmaf(x, y, z) == fmaf(y, x, z). Ragged N and K are masked here (the Pallas
// wrapper falls back to a.T @ a when a block does not divide; on the card
// there is no fallback). The sum across calibration records stays a tensor
// add outside the kernel, as in core/calibrate.py.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;   // 16 x 16
constexpr int BT = 128;        // G tile edge
constexpr int BKK = 8;         // tokens per shared-memory stage

template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_accum_kernel(const T* __restrict__ a, float* __restrict__ g, int K, int N, int nt) {
  __shared__ __align__(16) float ai[BKK][BT];
  __shared__ __align__(16) float aj[BKK][BT];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // linear block index -> upper-triangle tile (ti, tj), ti <= tj
  int idx = blockIdx.x, ti = 0;
  while (idx >= nt - ti) {
    idx -= nt - ti;
    ++ti;
  }
  const int tj = ti + idx;
  const int i0 = ti * BT, j0 = tj * BT;

  float acc[8][8];
#pragma unroll
  for (int x = 0; x < 8; ++x)
#pragma unroll
    for (int y = 0; y < 8; ++y) acc[x][y] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BKK) {
    for (int e = tid; e < BKK * BT; e += THREADS) {
      const int kk = e / BT, c = e % BT;
      const bool kin = k0 + kk < K;
      const T* row = a + (size_t)(k0 + kk) * N;
      ai[kk][c] = kin && i0 + c < N ? to_f(row[i0 + c]) : 0.f;
      aj[kk][c] = kin && j0 + c < N ? to_f(row[j0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKK; ++kk) {
      const float4 x0 = *reinterpret_cast<const float4*>(&ai[kk][ty * 4]);
      const float4 x1 = *reinterpret_cast<const float4*>(&ai[kk][64 + ty * 4]);
      const float4 y0 = *reinterpret_cast<const float4*>(&aj[kk][tx * 4]);
      const float4 y1 = *reinterpret_cast<const float4*>(&aj[kk][64 + tx * 4]);
      const float xi[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float yj[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[x][y] = fmaf(xi[x], yj[y], acc[x][y]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const int i = i0 + (x < 4 ? ty * 4 + x : 64 + ty * 4 + x - 4);
    if (i >= N) continue;
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      const int j = j0 + (y < 4 ? tx * 4 + y : 64 + tx * 4 + y - 4);
      if (j >= N) continue;
      g[(size_t)i * N + j] = acc[x][y];
      if (ti != tj) g[(size_t)j * N + i] = acc[x][y];
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, float* g, int K, int N, cudaStream_t stream) {
  const int nt = (N + BT - 1) / BT;
  gram_accum_kernel<T><<<nt * (nt + 1) / 2, THREADS, 0, stream>>>(
      static_cast<const T*>(a), g, K, N, nt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a (K, N) contiguous; g (N, N) fp32. dtype: 0 = f32, 1 = bf16.
int repro_gram_accum(const void* a, void* g, int K, int N, int dtype, void* stream) {
  if (K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* gf = static_cast<float*>(g);
  if (dtype == 0) return (int)launch<float>(a, gf, K, N, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, gf, K, N, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
