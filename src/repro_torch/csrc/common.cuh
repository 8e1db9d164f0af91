// Shared by the port's kernel sources: fp32 <-> storage-type conversions
// (every kernel loads fp32 or bf16 and accumulates in fp32), the masked
// score value of the attention kernels (the Pallas kernels' NEG_INF), the
// asynchronous 16-byte global -> shared copies (cp.async) of the pipelined
// kernels, the bf16 tensor-core fragment helpers (ldmatrix, mma.sync), the
// combine of flash-decoding split partials, and the per-device dynamic
// shared-memory limit.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// v rounded to T's precision, as fp32 (the identity for float).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// 16-byte asynchronous copy global -> shared; both addresses 16-byte
// aligned. Completion is tracked per thread in commit groups.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four consecutive values as fp32 (16 bytes of fp32, 8 of bf16; the address
// aligned to that size).
template <typename T> __device__ __forceinline__ float4 load4(const T* p);
template <> __device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <> __device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// One 16-byte chunk into shared memory: zeros when !ok, cp.async when the
// source is 16-byte aligned (vec), element by element otherwise.
template <typename T>
__device__ __forceinline__ void copy16(T* dst, const T* src, bool ok, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (!ok) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  } else if (vec) {
    cp_async16(dst, src);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = src[i];
  }
}

// Flash-decoding combine of n split partials (m_s, l_s, acc_s), in split
// order, so the result is the same bits on every run:
//   sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30),  w_s = exp(m_s - max_s m_s).
// ml points at split 0's (m, l) pair and acc at split 0's accumulator
// element; ml_step and acc_step are the strides between splits, in floats.
__device__ __forceinline__ float combine_splits(const float* ml, size_t ml_step,
                                                const float* acc, size_t acc_step, int n) {
  float mx = NEG_INF;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, ml[s * ml_step]);
  float lsum = 0.f, a = 0.f;
  for (int s = 0; s < n; ++s) {
    const float w = expf(ml[s * ml_step] - mx);
    lsum = fmaf(w, ml[s * ml_step + 1], lsum);
    a = fmaf(w, acc[s * acc_step], a);
  }
  return a / fmaxf(lsum, 1e-30f);
}

// bf16 tensor-core fragments (mma.sync.m16n8k16, fp32 accumulation): four
// 8 x 8 b16 matrices from shared memory, each lane giving one row address
// (lanes 8i..8i+7 the rows of matrix i); .trans hands each lane a column
// pair instead of a row pair.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

constexpr int MAX_DEVICES = 64;

// Raises a kernel's dynamic shared-memory limit to `bytes` the first time it
// launches on the current device (the attribute is per device); `done` is
// that kernel's own per-device flags.
inline cudaError_t smem_limit_once(const void* kernel, int bytes, bool (&done)[MAX_DEVICES]) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

}  // namespace
