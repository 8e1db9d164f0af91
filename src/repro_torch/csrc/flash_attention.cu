// Causal flash attention over contiguous (B, T, H, hd) tensors, with GQA and
// a logit softcap.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:30-110
// (`_kernel` / `flash_attention`): grid (B*Hq, T/bq, T/bk) with the KV axis
// sequential, (m, l, acc) in VMEM scratch, KV blocks above the diagonal
// skipped, and the GQA map h -> h // (Hq/Hkv) in the K/V BlockSpecs.
//
// What bounds it on the H100: 4*hd FLOPs per (query, key) pair of the causal
// half against reading q, k, v and writing o once. At the calibration and
// evaluation shapes (T 64-256, hd 64) the products dominate from T ~ 64 on,
// so it is bound by operations: fp32 FMAs on the CUDA cores here (tensor
// cores, TMA and wgmma are later work).
//
// Design: one block per (batch * query head, 64-query tile), 256 threads as
// 16 x 16. The block loops over 64-key tiles up to the diagonal; the KV
// cursor is a loop inside the block because CUDA blocks run in no order
// (the TPU grid carried the state across a sequential axis). The query tile,
// one K tile and one V tile are staged in shared memory as fp32; each thread
// holds a 4 x 4 block of scores (rows ty*4+i, keys tx+16c) and a 4 x hd/16
// block of the fp32 accumulator in registers. Row max and row sum are
// reduced over the 16 threads of a row with warp shuffles, the probabilities
// go through shared memory for the P.V product. Ragged T is masked here (the
// Pallas wrapper falls back to the reference when T % block != 0; on the
// card there is no fallback). The softcap is applied before the causal
// mask, masked scores are NEG_INF = -1e30, and the output is
// acc / max(l, 1e-30), as in the Pallas kernel. Tiles are walked from the
// last query tile down so the longest rows start first.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;   // 16 x 16
constexpr int BQ = 64;         // queries per block
constexpr int BK = 64;         // keys per KV tile

template <int HD>
constexpr size_t smem_floats() {
  // q tile (padded), K tile (padded), V tile, probabilities (padded)
  return (size_t)BQ * (HD + 1) + (size_t)BK * (HD + 1) + (size_t)BK * HD +
         (size_t)BQ * (BK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Tn, int Hq,
                       int Hkv, float scale, float cap) {
  constexpr int CO = HD / 16;            // accumulator columns per thread
  constexpr int QP = HD + 1, PP = BK + 1;
  extern __shared__ float smem[];
  float* qs = smem;                      // (BQ, HD + 1)
  float* ks = qs + BQ * QP;              // (BK, HD + 1)
  float* vs = ks + BK * QP;              // (BK, HD)
  float* ps = vs + BK * HD;              // (BQ, BK + 1)
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y % Hq, b = blockIdx.y / Hq;
  const int hk = h / (Hq / Hkv);         // GQA: the query head's KV head
  const int q0 = qt * BQ;
  const size_t sq = (size_t)Hq * HD, skv = (size_t)Hkv * HD;   // token strides
  const T* qb = q + (size_t)b * Tn * sq + (size_t)h * HD;
  const T* kb = k + (size_t)b * Tn * skv + (size_t)hk * HD;
  const T* vb = v + (size_t)b * Tn * skv + (size_t)hk * HD;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    qs[r * QP + d] = q0 + r < Tn ? to_f(qb[(size_t)(q0 + r) * sq + d]) : 0.f;
  }
  float m[4], l[4], acc[4][CO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;
  }

  const int last_q = min(q0 + BQ, Tn) - 1;   // last real query of the tile
  const int n_kt = last_q / BK + 1;          // KV tiles up to the diagonal
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                     // the previous tile's reads are done
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int r = e / HD, d = e % HD;
      const bool ok = k0 + r < Tn;
      ks[r * QP + d] = ok ? to_f(kb[(size_t)(k0 + r) * skv + d]) : 0.f;
      vs[r * HD + d] = ok ? to_f(vb[(size_t)(k0 + r) * skv + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * QP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = ks[(tx + 16 * c) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iq = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ik = k0 + tx + 16 * c;
        float x = s[i][c] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        x = (ik <= iq && ik < Tn) ? x : NEG_INF;
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 threads of a row are lanes 16*(ty%2) + tx of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // key 0 is live for every row, so m is finite after the first tile
      // and fully masked rows of later tiles add p = 0
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        ps[(ty * 4 + i) * PP + tx + 16 * c] = p;
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
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        const float vv = vs[kk * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= Tn) continue;
    T* orow = out + (size_t)b * Tn * sq + (size_t)t * sq + (size_t)h * HD;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CO; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] / den);
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out, int B,
                      int Tn, int Hq, int Hkv, float scale, float cap,
                      cudaStream_t stream) {
  const size_t bytes = smem_floats<HD>() * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Tn + BQ - 1) / BQ, B * Hq);
  flash_attention_kernel<T, HD><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Tn, Hq, Hkv, scale, cap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Tn,
                   int Hq, int Hkv, int hd, float scale, float cap, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(q, k, v, out, B, Tn, Hq, Hkv, scale, cap, stream);
    case 32: return launch_hd<T, 32>(q, k, v, out, B, Tn, Hq, Hkv, scale, cap, stream);
    case 64: return launch_hd<T, 64>(q, k, v, out, B, Tn, Hq, Hkv, scale, cap, stream);
    case 128: return launch_hd<T, 128>(q, k, v, out, B, Tn, Hq, Hkv, scale, cap, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, T, Hq, hd); k, v (B, T, Hkv, hd); out (B, T, Hq, hd), all contiguous.
// hd in {16, 32, 64, 128}. dtype: 0 = f32, 1 = bf16.
int repro_flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                          int Tn, int Hq, int Hkv, int hd, float scale, float cap,
                          int dtype, void* stream) {
  if (B <= 0 || Tn <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, out, B, Tn, Hq, Hkv, hd, scale, cap, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, out, B, Tn, Hq, Hkv, hd, scale, cap, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
