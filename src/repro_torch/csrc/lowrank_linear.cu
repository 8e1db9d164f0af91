// Low-rank (COALA-factored) linear layer: y = cast(x @ b_t) @ a_t.
//
// Replaces the Pallas kernel src/repro/kernels/lowrank_linear.py:27-61
// (`_kernel` / `lowrank_linear`), which fuses both products per (bm, bn)
// output tile and recomputes the (bm, r) intermediate for every column block.
//
// What bounds it on the H100: at decode (M <= 8 rows) the work is two thin
// products whose cost is reading b_t and a_t once; e.g. gate/up of llama3_1b
// at ratio 0.6 is (2048*983 + 983*8192) * 4 B = 40 MB, ~12 us at 3.35 TB/s.
// At prefill (M = B*L in the thousands) the same products are bound by the
// fp32 FLOPs (2*M*r*(d_in + d_out)).
//
// Design: two launches of one tiled shared-memory GEMM with fp32
// accumulation; t = x @ b_t goes to an (M, r) scratch in x's dtype (the cast
// of lowrank_linear.py:30), then y = t @ a_t. Not fused: fusing per row tile
// (as the Pallas kernel does) re-reads b_t once per output column block,
// which multiplies the bytes that bound decode, while t is only ~0.1% of the
// weight bytes at decode (and ~20% at a 2048-token prefill). Small M gets a
// 16-row tile and split-K across blocks (fp32 partials in a workspace plus a
// deterministic reduction pass), so that a rank-614 product still puts ~2
// blocks on each of the 132 SMs instead of 10 blocks in all. Every ragged
// edge (r = 614, 245, 983) is masked with zero fill; no shape falls back.
// Not yet used: wgmma / tensor cores, TMA, vectorised loads (later work).

#include "common.cuh"

namespace {

// C[M, N] = A[M, K] @ B[K, N], all row-major and contiguous. Block (x, y, z)
// computes the BM x BN tile (y, x) over the K range of split z; each thread
// owns a TM x TN micro-tile. With `work` set, the fp32 partial sums of split
// z go to work[z] and a reduction pass writes C; otherwise C directly.
template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
            float* __restrict__ work, int M, int N, int K, int kchunk) {
  constexpr int NTX = BN / TN;
  constexpr int NT = (BM / TM) * NTX;
  __shared__ float As[BK][BM + 4];   // A tile, transposed: As[k][m]
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % NTX;
  const int ty = tid / NTX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int m = e / BK, k = e % BK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < kend) ? to_f(A[(size_t)gm * K + gk]) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int k = e / BN, n = e % BN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < kend && gn < N) ? to_f(B[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      if (work != nullptr)
        work[(size_t)blockIdx.z * M * N + (size_t)gm * N + gn] = acc[i][j];
      else
        C[(size_t)gm * N + gn] = from_f<T>(acc[i][j]);
    }
  }
}

// C = sum over splits of work[s], cast to T (fixed order: deterministic).
template <typename T>
__global__ void splitk_reduce(const float* __restrict__ work, T* __restrict__ C,
                              long long mn, int splits) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < mn;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += work[z * mn + e];
    C[e] = from_f<T>(s);
  }
}

// Tile shapes: a 16-row tile for decode-sized M, a 64 x 64 tile otherwise.
constexpr int SMALL_M = 16;
constexpr int S_BM = 16, S_BN = 64, S_BK = 32, S_TM = 1, S_TN = 4;
constexpr int L_BM = 64, L_BN = 64, L_BK = 16, L_TM = 4, L_TN = 4;

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms <= 0)
      sms = 132;
  }
  return sms;
}

struct Plan {
  int splits;
  int kchunk;
};

// Split K across blocks only for small M, until ~2 blocks per SM are in
// flight, keeping at least two BK steps per split.
Plan plan_gemm(int M, int N, int K) {
  const bool small = M <= SMALL_M;
  const int bm = small ? S_BM : L_BM, bn = small ? S_BN : L_BN;
  const int bk = small ? S_BK : L_BK;
  const long long tiles = (long long)((M + bm - 1) / bm) * ((N + bn - 1) / bn);
  int splits = 1;
  if (small) {
    const long long want = 2LL * num_sms();
    long long s = (want + tiles - 1) / tiles;
    long long cap = K / (2 * bk);
    if (cap < 1) cap = 1;
    splits = (int)(s < cap ? s : cap);
    if (splits < 1) splits = 1;
  }
  int kchunk = (K + splits - 1) / splits;
  kchunk = ((kchunk + bk - 1) / bk) * bk;
  splits = (K + kchunk - 1) / kchunk;
  if (splits < 1) splits = 1;
  return {splits, kchunk};
}

long long gemm_workspace(int M, int N, int K) {
  Plan p = plan_gemm(M, N, K);
  return p.splits > 1 ? (long long)p.splits * M * N : 0;
}

template <typename T>
cudaError_t gemm(const T* A, const T* B, T* C, float* work, int M, int N, int K,
                 cudaStream_t stream) {
  const Plan p = plan_gemm(M, N, K);
  float* w = p.splits > 1 ? work : nullptr;
  if (M <= SMALL_M) {
    dim3 grid((N + S_BN - 1) / S_BN, (M + S_BM - 1) / S_BM, p.splits);
    gemm_kernel<T, S_BM, S_BN, S_BK, S_TM, S_TN>
        <<<grid, (S_BM / S_TM) * (S_BN / S_TN), 0, stream>>>(A, B, C, w, M, N, K, p.kchunk);
  } else {
    dim3 grid((N + L_BN - 1) / L_BN, (M + L_BM - 1) / L_BM, p.splits);
    gemm_kernel<T, L_BM, L_BN, L_BK, L_TM, L_TN>
        <<<grid, (L_BM / L_TM) * (L_BN / L_TN), 0, stream>>>(A, B, C, w, M, N, K, p.kchunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const long long mn = (long long)M * N;
  long long blocks = (mn + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  splitk_reduce<T><<<(int)blocks, 256, 0, stream>>>(work, C, mn, p.splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t lowrank(const void* x, const void* bt, const void* at, void* y, void* t,
                    void* work, int M, int d_in, int r, int d_out, cudaStream_t stream) {
  cudaError_t err = gemm<T>(static_cast<const T*>(x), static_cast<const T*>(bt),
                            static_cast<T*>(t), static_cast<float*>(work), M, r, d_in, stream);
  if (err != cudaSuccess) return err;
  return gemm<T>(static_cast<const T*>(t), static_cast<const T*>(at), static_cast<T*>(y),
                 static_cast<float*>(work), M, d_out, r, stream);
}

}  // namespace

extern "C" {

// fp32 elements of split-K workspace one repro_lowrank_linear call needs
// (the larger of its two products; 0 when neither splits).
long long repro_lowrank_linear_workspace(int M, int d_in, int r, int d_out) {
  long long a = gemm_workspace(M, r, d_in), b = gemm_workspace(M, d_out, r);
  return a > b ? a : b;
}

// y (M, d_out) = cast(x (M, d_in) @ bt (d_in, r)) @ at (r, d_out); t is an
// (M, r) scratch of the same dtype. dtype: 0 = float32, 1 = bfloat16.
int repro_lowrank_linear(const void* x, const void* bt, const void* at, void* y, void* t,
                         void* work, int M, int d_in, int r, int d_out, int dtype,
                         void* stream) {
  if (M <= 0 || d_in <= 0 || r <= 0 || d_out <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)lowrank<float>(x, bt, at, y, t, work, M, d_in, r, d_out, s);
  if (dtype == 1)
    return (int)lowrank<__nv_bfloat16>(x, bt, at, y, t, work, M, d_in, r, d_out, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
