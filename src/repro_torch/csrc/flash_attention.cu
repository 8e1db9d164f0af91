// Causal flash attention over contiguous (B, T, H, hd) tensors, with GQA and
// a logit softcap.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:30-110
// (`_kernel` / `flash_attention`): grid (B*Hq, T/bq, T/bk) with the KV axis
// sequential, (m, l, acc) in VMEM scratch, KV blocks above the diagonal
// skipped, and the GQA map h -> h // (Hq/Hkv) in the K/V BlockSpecs. As
// there, bf16 inputs give bf16 Q.K^T products summed in fp32 and P rounded
// to bf16 (`p.astype(v.dtype)`) before P.V, summed in fp32.
//
// What bounds it on the H100: 4*hd FLOPs per (query, key) pair of the causal
// half against one read of q, k, v and one write of o. From T ~ 64 on (hd
// 64) the products dominate: fp32 runs exact FMAs on the CUDA cores (67
// TFLOP/s; no TF32), bf16 runs on the tensor cores (989 TFLOP/s dense, of
// which mma.sync reaches a part). At the paths' B 8, T 64 the call is a few
// microseconds of work, so latency bounds it. On the CUDA cores the loops
// must not wait on shared-memory issue: each shared load has to feed many
// FMAs from registers.
//
// Design, both dtypes:
// - A block of 128 threads owns ROWS query rows of one (batch b, KV head hk)
//   (the plan's, kernels/flash_attention.py: 128 at hd 16, 32 and 64 where
//   that grid keeps two blocks on every SM, else 64; hd 48 and 192 serve
//   MLA, whose q/k are nope + rope dims and whose V is zero-padded to them):
//   the flat (query j, head g) pairs r = j*G + g, so each K/V tile is staged
//   once for all G query heads of hk. Its key tiles (64 keys) run from 0 to
//   the one holding its last row's diagonal. Tiles below the diagonal of the
//   block's first query run without masks or bounds; the last one or two are
//   masked and computed only up to kc keys (kc = the last query + 1 - k0, a
//   block-uniform bound). Row tiles are walked from the last (the longest
//   diagonal) down; the grid is one-dimensional, B*Hkv*row_tiles.
// - Q is staged once, K and V through 16-byte cp.async while the block
//   computes: keys at or past T are zero-filled, never read; query rows past
//   T*G are zero-filled and not written.
// - Masks and shifts as in the Pallas kernel: softcap before the causal mask,
//   masked scores NEG_INF = -1e30, output acc / max(l, 1e-30). Probabilities
//   are 2^(s*scale*log2 e - m*scale*log2 e), one FMA and one ex2 each (with a
//   softcap the scores go to log2 units first).
// - No key-range split, no atomics: a second identical call gives the same
//   bits.
// fp32: at 128 rows 16 x 8 threads, each an 8 x 8 register block of scores
//   (rows ty + 16i, keys tx + 8c) and of the accumulator (the same rows,
//   hd/8 dims); at 64 rows 8 x 16 threads with 8 x 4 blocks.
//   Q, K, V rows are padded to hd + 4 floats and read as float4 (d, keys
//   stepped by 4): 16 shared loads feed 256 FMAs in both products, and the
//   8 rows or 8 keys a warp reads at once fall in distinct banks. Row max by
//   shuffles over the 8 lanes of a row; each lane keeps its own part of the
//   row sum until the end; P goes through shared memory. fp32 tiles are
//   large (17 KB a K or V tile at hd 64), so K and V take one buffer each,
//   a two-slot ring: V(kt) lands while S(kt) is computed, K(kt+1) while
//   P(kt).V(kt) is; with Q and P that is 106 KB, two blocks to an SM (a
//   ring of two K/V tiles would leave one). At hd 192 (64 rows) it is 171 KB,
//   one block to an SM, and each lane holds 8 x 12 accumulator dims.
// bf16: FlashAttention-2 with mma.sync.m16n8k16 (fp32 accumulation), K/V
//   tiles through a ring of two stages (the next tile loads while this one
//   is computed). Each warp owns 16 * MI rows. Q fragments come once from
//   ldmatrix and stay in registers (at hd 192 they are read from shared
//   memory again in each key tile: registers); S = Q K^T from ldmatrix
//   fragments of K;
//   the running max and sum live in registers, reduced over each row's quad
//   of lanes; P is rounded to bf16 and repacked in registers as the A
//   operand of P.V (the C layout of two m16n8 tiles is the A layout of one
//   m16n8k16); V comes in through ldmatrix.trans; the fp32 accumulator is
//   written once as bf16. Rows are padded to hd + 8 elements, so ldmatrix
//   is conflict-free. At hd 192 the tiles take 125 KB, one block to an SM.

#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;   // 4 warps
constexpr int KEYS = 64;       // keys per K/V tile
constexpr float LOG2E = 1.4426950408889634f;

// The block's row tile and key range. Row tiles walk from the last down.
struct Tile {
  int b, hk;
  int r0;      // first row (j*G + g) of the tile
  int j0, j1;  // first and last query of the tile's real rows
  int n_kt;    // key tiles 0 .. n_kt-1 reach the diagonal
};

__device__ __forceinline__ Tile block_tile(int rows, int row_tiles, int B, int Tn, int Hkv,
                                           int G) {
  const int nbh = B * Hkv;
  const int rt = row_tiles - 1 - (int)(blockIdx.x / nbh);
  const int bh = (int)(blockIdx.x % nbh);
  Tile t;
  t.b = bh / Hkv;
  t.hk = bh % Hkv;
  t.r0 = rt * rows;
  t.j0 = t.r0 / G;
  t.j1 = min(Tn - 1, (t.r0 + rows - 1) / G);
  t.n_kt = t.j1 / KEYS + 1;
  return t;
}

// Scaled (and capped) score in log2 units: x * log2 e, x = s * scale or
// cap * tanh(s * scale / cap).
struct Logit {
  float mul;   // scale * log2 e, or scale / cap
  float cap;   // cap * log2 e, or 0 without a softcap
  __device__ __forceinline__ float operator()(float s) const {
    return cap > 0.f ? cap * tanhf(s * mul) : s * mul;
  }
};

// 2^x by the SFU (ex2.approx.ftz: relative error ~2^-22; 2^(-huge) = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Stage `rows` query rows (r0 ..) of (b, hk): row r is query r / G, head
// hk*G + r % G. Rows at or past T*G are zero.
template <typename T, int HD, int LD>
__device__ __forceinline__ void stage_q(T* qs, const T* q, const Tile& t, int rows, int Tn,
                                        int Hq, int G, bool vec) {
  constexpr int VEC = 16 / sizeof(T), CPR = HD / VEC;
  const int nrows = Tn * G;
  for (int e = threadIdx.x; e < rows * CPR; e += THREADS) {
    const int i = e / CPR, c = (e % CPR) * VEC;
    const int r = t.r0 + i;
    const bool ok = r < nrows;
    const int rr = ok ? r : 0;
    const T* src = q + ((size_t)(t.b * Tn + rr / G) * Hq + t.hk * G + rr % G) * HD + c;
    copy16(qs + i * LD + c, src, ok, vec);
  }
}

// Stage key tile k0 .. k0+63 of (b, hk) of K or V into dst. Keys at or past
// T are zero.
template <typename T, int HD, int LD>
__device__ __forceinline__ void stage_keys(T* dst, const T* src, const Tile& t, int k0, int Tn,
                                           int Hkv, bool vec) {
  constexpr int VEC = 16 / sizeof(T), CPR = HD / VEC;
  const size_t base = ((size_t)t.b * Tn * Hkv + t.hk) * HD;
  for (int e = threadIdx.x; e < KEYS * CPR; e += THREADS) {
    const int i = e / CPR, c = (e % CPR) * VEC;
    const int key = k0 + i;
    const bool ok = key < Tn;
    copy16(dst + i * LD + c, src + base + (size_t)(ok ? key : 0) * Hkv * HD + c, ok, vec);
  }
}

// Stage key tile k0 .. k0+63 of (b, hk) of both K and V (one loop).
template <typename T, int HD, int LD>
__device__ __forceinline__ void stage_kv(T* ks, T* vs, const T* k, const T* v, const Tile& t,
                                         int k0, int Tn, int Hkv, bool vec) {
  constexpr int VEC = 16 / sizeof(T), CPR = HD / VEC;
  const size_t base = ((size_t)t.b * Tn * Hkv + t.hk) * HD;
  for (int e = threadIdx.x; e < KEYS * CPR; e += THREADS) {
    const int i = e / CPR, c = (e % CPR) * VEC;
    const int key = k0 + i;
    const bool ok = key < Tn;
    const size_t off = base + (size_t)(ok ? key : 0) * Hkv * HD + c;
    copy16(ks + i * LD + c, k + off, ok, vec);
    copy16(vs + i * LD + c, v + off, ok, vec);
  }
}

// ---------------------------------------------------------------------------
// fp32: register-blocked exact FMAs on the CUDA cores
// ---------------------------------------------------------------------------

// 128 threads as (128 / TX) x TX: each thread holds 8 rows (ty + RS*i) x
// 64/TX keys (tx + TX*c) of S and the same 8 rows x hd/TX dims of the
// accumulator. TX 8: 8 x 8 blocks, 128 rows; TX 16: 8 x 4 blocks, 64 rows
// (the plan's choice at hd 48, 128 and 192, and where 128-row tiles would
// leave the card under two blocks per SM: twice the warps for the same rows).
template <int HD, int TX>
struct F32Tile {
  static constexpr int RS = THREADS / TX;  // row stride of a thread's rows
  static constexpr int ROWS = 8 * RS;
  static constexpr int KPT = KEYS / TX;    // keys per thread
  static constexpr int DPT = HD / TX;      // accumulator dims per thread
  static constexpr int LD = HD + 4;        // padded Q/K/V row (floats)
  static constexpr int PLD = KEYS + 2 * TX;   // padded P row: a warp's stores conflict-free
  static constexpr int TILE = KEYS * LD;   // floats of one K or V tile
  static constexpr size_t bytes() {
    return ((size_t)ROWS * (LD + PLD) + 2 * (size_t)TILE) * sizeof(float);
  }
};

// Accumulator dim e (< DPT) of lane tx: float4 chunks 4*TX*(e/4) + 4*tx (a
// warp's TX lanes read contiguous bytes), or DPT*tx + e when DPT < 4.
template <int DPT, int TX>
__device__ __forceinline__ int acc_dim(int tx, int e) {
  if constexpr (DPT >= 4) return 4 * TX * (e >> 2) + 4 * tx + (e & 3);
  else return DPT * tx + e;
}

template <int HD, int TX>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int B, int Tn,
                 int Hq, int Hkv, int row_tiles, Logit logit, int vec) {
  using L = F32Tile<HD, TX>;
  constexpr int LD = L::LD, PLD = L::PLD, DPT = L::DPT, RS = L::RS, KPT = L::KPT;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                         // (ROWS, LD)
  float* ks = qs + L::ROWS * LD;            // (KEYS, LD)
  float* vs = ks + L::TILE;                 // (KEYS, LD)
  float* ps = vs + L::TILE;                 // (ROWS, PLD)
  const int G = Hq / Hkv;
  const Tile t = block_tile(L::ROWS, row_tiles, B, Tn, Hkv, G);
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;

  stage_q<float, HD, LD>(qs, q, t, L::ROWS, Tn, Hq, G, vec);
  stage_keys<float, HD, LD>(ks, k, t, 0, Tn, Hkv, vec);
  cp_async_commit();

  float m[8], l[8], acc[8][DPT];
  int jq[8];                                // query of each row
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    jq[i] = (t.r0 + ty + RS * i) / G;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  const bool pre = logit.cap > 0.f || !(logit.mul > 0.f);   // log2 units before the max
  const float sl = pre ? 1.f : logit.mul;
  for (int kt = 0; kt < t.n_kt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();        // K(kt) landed; V(kt-1) and P read by all
    const int k0 = kt * KEYS;
    stage_keys<float, HD, LD>(vs, v, t, k0, Tn, Hkv, vec);   // V(kt) lands during S
    cp_async_commit();
    const int kc = min(KEYS, t.j1 - k0 + 1);    // keys any row of the block attends
    const int ng = (kc + TX - 1) / TX;          // live groups of TX keys

    // FULL: a tile below every row's diagonal (no mask, all 64 keys); else
    // the last tile or two, masked and cut to the first kc keys
    auto tile = [&](auto full) {
      constexpr bool FULL = decltype(full)::value;
      float s[8][KPT];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < KPT; ++c) s[i][c] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HD; d += 4) {
        float4 qv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qs + (ty + RS * i) * LD + d);
#pragma unroll
        for (int c = 0; c < KPT; ++c) {
          if (!FULL && c >= ng) continue;
          const float4 kv = *reinterpret_cast<const float4*>(ks + (tx + TX * c) * LD + d);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            s[i][c] = fmaf(qv[i].x, kv.x, s[i][c]);
            s[i][c] = fmaf(qv[i].y, kv.y, s[i][c]);
            s[i][c] = fmaf(qv[i].z, kv.z, s[i][c]);
            s[i][c] = fmaf(qv[i].w, kv.w, s[i][c]);
          }
        }
      }
      if (pre) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < KPT; ++c) s[i][c] = logit(s[i][c]);
      }
      if (!FULL) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < KPT; ++c)
            if (k0 + tx + TX * c > jq[i]) s[i][c] = NEG_INF;   // also keys past kc
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float mx = s[i][0];
#pragma unroll
        for (int c = 1; c < KPT; ++c) mx = fmaxf(mx, s[i][c]);
        // the TX lanes of a row are consecutive lanes of one warp
#pragma unroll
        for (int off = TX / 2; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        // key 0 is live for every row, so m is finite after the first tile
        // and fully masked rows of later tiles add p = 0
        const float mn = fmaxf(m[i], mx);
        const float corr = exp2_approx((m[i] - mn) * sl);
        const float base = -mn * sl;
        m[i] = mn;
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < KPT; ++c) {
          const float p = exp2_approx(fmaf(s[i][c], sl, base));
          s[i][c] = p;
          sum += p;
        }
        l[i] = fmaf(l[i], corr, sum);          // this lane's part of the row sum
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] *= corr;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < KPT; ++c)
          if (FULL || c < ng) ps[(ty + RS * i) * PLD + tx + TX * c] = s[i][c];
      cp_async_wait<0>();
      __syncthreads();      // V(kt) landed, P written, K(kt) read by all
      if (kt + 1 < t.n_kt) {   // K(kt+1) lands during P.V
        stage_keys<float, HD, LD>(ks, k, t, k0 + KEYS, Tn, Hkv, vec);
        cp_async_commit();
      }

      // P is written up to TX * ng >= the keys read here
      const int kend = FULL ? KEYS : (kc + 3) & ~3;
#pragma unroll 4
      for (int kk = 0; kk < kend; kk += 4) {
        float4 pv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          pv[i] = *reinterpret_cast<const float4*>(ps + (ty + RS * i) * PLD + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float vv[DPT];
          const float* vrow = vs + (kk + u) * LD;
          if constexpr (DPT >= 4) {
#pragma unroll
            for (int e = 0; e < DPT; e += 4) {
              const float4 f = *reinterpret_cast<const float4*>(vrow + acc_dim<DPT, TX>(tx, e));
              vv[e] = f.x;
              vv[e + 1] = f.y;
              vv[e + 2] = f.z;
              vv[e + 3] = f.w;
            }
          } else {
#pragma unroll
            for (int e = 0; e < DPT; ++e) vv[e] = vrow[acc_dim<DPT, TX>(tx, e)];
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
          }
        }
      }
    };
    if (k0 + KEYS - 1 <= t.j0)   // below the diagonal of the tile's first query
      tile(std::true_type{});
    else
      tile(std::false_type{});
  }

  const int nrows = Tn * G;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float den = l[i];
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) den += __shfl_xor_sync(0xffffffffu, den, off);
    const int r = t.r0 + ty + RS * i;
    if (r >= nrows) continue;
    const float inv = 1.f / fmaxf(den, 1e-30f);
    float* orow = out + ((size_t)(t.b * Tn + r / G) * Hq + t.hk * G + r % G) * HD;
    if constexpr (DPT >= 4) {
#pragma unroll
      for (int e = 0; e < DPT; e += 4)
        *reinterpret_cast<float4*>(orow + acc_dim<DPT, TX>(tx, e)) = make_float4(
            acc[i][e] * inv, acc[i][e + 1] * inv, acc[i][e + 2] * inv, acc[i][e + 3] * inv);
    } else {
#pragma unroll
      for (int e = 0; e < DPT; ++e) orow[acc_dim<DPT, TX>(tx, e)] = acc[i][e] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync.m16n8k16, fp32 accumulation)
// ---------------------------------------------------------------------------

template <int HD, int MI>
struct Bf16Tile {
  static constexpr int ROWS = 64 * MI;     // 4 warps of 16 * MI rows
  static constexpr int LD = HD + 8;        // padded row (elements): ldmatrix conflict-free
  static constexpr int TILE = KEYS * LD;
  static constexpr size_t bytes() {
    return ((size_t)ROWS * LD + 4 * (size_t)TILE) * sizeof(__nv_bfloat16);
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int HD, int MI>
__global__ void __launch_bounds__(THREADS)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int B,
                  int Tn, int Hq, int Hkv, int row_tiles, Logit logit, int vec) {
  using L = Bf16Tile<HD, MI>;
  constexpr int LD = L::LD, KD = HD / 16, NO = HD / 8;
  extern __shared__ __align__(16) uint16_t bsm[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(bsm);   // (ROWS, LD)
  __nv_bfloat16* kvs = qs + L::ROWS * LD;   // stage s: K at 2s, V at 2s + 1
  const int G = Hq / Hkv;
  const Tile t = block_tile(L::ROWS, row_tiles, B, Tn, Hkv, G);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  stage_q<__nv_bfloat16, HD, LD>(qs, q, t, L::ROWS, Tn, Hq, G, vec);
  stage_kv<__nv_bfloat16, HD, LD>(kvs, kvs + L::TILE, k, v, t, 0, Tn, Hkv, vec);
  cp_async_commit();

  // rows of this lane: wr + 16*mi + lane/4 (h = 0) and + 8 (h = 1)
  const int wr = warp * 16 * MI;
  float o[MI][NO][4], m[MI][2], l[MI][2];
  int jq[MI][2];
  // Q's A fragments stay in registers up to hd 128; at hd 192 (24 output
  // fragments a row tile already) they are read from shared memory again in
  // each key tile, which keeps the kernel inside 255 registers
  constexpr bool QREG = HD <= 128;
  uint32_t qf[QREG ? MI : 1][QREG ? KD : 1][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mi][h] = NEG_INF;
      l[mi][h] = 0.f;
      jq[mi][h] = (t.r0 + wr + 16 * mi + (lane >> 2) + 8 * h) / G;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mi][n][e] = 0.f;
  }

  auto q_frag = [&](uint32_t (&f)[4], int mi, int kk) {
    ldmatrix_x4(f, qs + (wr + 16 * mi + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
  };
  if constexpr (QREG) {
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) q_frag(qf[mi][kk], mi, kk);
  }

  const bool pre = logit.cap > 0.f || !(logit.mul > 0.f);   // log2 units before the max
  const float sl = pre ? 1.f : logit.mul;
  for (int kt = 0; kt < t.n_kt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();        // tile kt landed; tile kt-1's reads are done
    if (kt + 1 < t.n_kt) {
      __nv_bfloat16* nk = kvs + 2 * ((kt + 1) & 1) * L::TILE;
      stage_kv<__nv_bfloat16, HD, LD>(nk, nk + L::TILE, k, v, t, (kt + 1) * KEYS, Tn, Hkv,
                                      vec);
    }
    cp_async_commit();
    const __nv_bfloat16* ks = kvs + 2 * (kt & 1) * L::TILE;
    const __nv_bfloat16* vs = ks + L::TILE;
    const int k0 = kt * KEYS;
    const int kc = min(KEYS, t.j1 - k0 + 1);    // keys any row of the block attends

    // FULL: a tile below every row's diagonal (no mask, all 64 keys); else
    // the last tile or two, masked and cut to the first kc keys
    auto tile = [&](auto full) {
      constexpr bool FULL = decltype(full)::value;
      // S = Q K^T: s[mi][n] is the m16n8 tile of keys 8n .. 8n+7
      float s[MI][8][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mi][n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t qs_f[MI][4];   // this k-step's Q fragments (from shared memory)
        if constexpr (!QREG) {
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) q_frag(qs_f[mi], mi, kk);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (!FULL && 16 * np >= kc) continue;
          uint32_t kf[4];   // keys 16np + {0..7, 8..15} x dims 16kk + {0..7, 8..15}
          ldmatrix_x4(kf, ks + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                              ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            if constexpr (QREG) {
              mma_bf16(s[mi][2 * np], qf[mi][kk], kf[0], kf[1]);
              mma_bf16(s[mi][2 * np + 1], qf[mi][kk], kf[2], kf[3]);
            } else {
              mma_bf16(s[mi][2 * np], qs_f[mi], kf[0], kf[1]);
              mma_bf16(s[mi][2 * np + 1], qs_f[mi], kf[2], kf[3]);
            }
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        if (pre) {
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[mi][n][e] = logit(s[mi][n][e]);
        }
        if (!FULL) {   // keys past kc hold 0 and lie past every row's query
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (k0 + 8 * n + (lane & 3) * 2 + (e & 1) > jq[mi][e >> 1]) s[mi][n][e] = NEG_INF;
        }
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          mx[0] = fmaxf(mx[0], fmaxf(s[mi][n][0], s[mi][n][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[mi][n][2], s[mi][n][3]));
        }
        float base[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float mn = fmaxf(m[mi][h], mx[h]);
          const float corr = exp2_approx((m[mi][h] - mn) * sl);
          m[mi][h] = mn;
          base[h] = -mn * sl;
          l[mi][h] *= corr;
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            o[mi][n][2 * h] *= corr;
            o[mi][n][2 * h + 1] *= corr;
          }
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2_approx(fmaf(s[mi][n][e], sl, base[e >> 1]));
            s[mi][n][e] = p;
            l[mi][e >> 1] += p;          // this lane's part of the row sum
          }
      }

      // O += P V: P (rounded to bf16) of keys 16kk .. 16kk+15 is the A operand
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (!FULL && 16 * kk >= kc) continue;
        uint32_t a[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          a[mi][0] = pack_bf16(s[mi][2 * kk][0], s[mi][2 * kk][1]);
          a[mi][1] = pack_bf16(s[mi][2 * kk][2], s[mi][2 * kk][3]);
          a[mi][2] = pack_bf16(s[mi][2 * kk + 1][0], s[mi][2 * kk + 1][1]);
          a[mi][3] = pack_bf16(s[mi][2 * kk + 1][2], s[mi][2 * kk + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t vf[4];   // keys 16kk + {0..7, 8..15} x dims 16dp + {0..7, 8..15}
          ldmatrix_x4_trans(vf, vs + (16 * kk + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_bf16(o[mi][2 * dp], a[mi], vf[0], vf[1]);
            mma_bf16(o[mi][2 * dp + 1], a[mi], vf[2], vf[3]);
          }
        }
      }
    };
    if (k0 + KEYS - 1 <= t.j0)   // below the diagonal of the tile's first query
      tile(std::true_type{});
    else
      tile(std::false_type{});
  }

  const int nrows = Tn * G;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float den = l[mi][h];
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
      const int r = t.r0 + wr + 16 * mi + (lane >> 2) + 8 * h;
      if (r >= nrows) continue;
      const float inv = 1.f / fmaxf(den, 1e-30f);
      __nv_bfloat16* orow =
          out + ((size_t)(t.b * Tn + r / G) * Hq + t.hk * G + r % G) * HD + (lane & 3) * 2;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(o[mi][n][2 * h] * inv, o[mi][n][2 * h + 1] * inv);
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, typename Kern>
cudaError_t launch_kernel(Kern kernel, size_t bytes, bool (&configured)[MAX_DEVICES],
                          long long blocks, cudaStream_t stream, const void* q, const void* k,
                          const void* v, void* out, int B, int Tn, int Hq, int Hkv,
                          int row_tiles, Logit logit, int vec) {
  cudaError_t err = smem_limit_once(reinterpret_cast<const void*>(kernel), (int)bytes,
                                    configured);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), B, Tn, Hq, Hkv, row_tiles, logit, vec);
  return cudaGetLastError();
}

// The kernel of (dtype, HD, rows), or an error if the plan's rows are not
// compiled for it: 128 rows (fp32 8 x 8 blocks, bf16 two m16 tiles a warp)
// at hd 16, 32 and 64, 64 rows (fp32 8 x 4 blocks, bf16 one m16 tile a warp)
// at every hd. At hd 128 and 192 the 128-row tiles would not fit in
// registers; at hd 48 the fp32 8 x 8 block would give each lane 6 dims,
// which the float4 dim map does not split (8 x 4 blocks give it 3).
template <int HD>
cudaError_t launch_hd(int dtype, int rows, const void* q, const void* k, const void* v,
                      void* out, int B, int Tn, int Hq, int Hkv, Logit logit, int vec,
                      cudaStream_t stream) {
  const long long row_tiles = ((long long)Tn * (Hq / Hkv) + rows - 1) / rows;
  const long long blocks = row_tiles * B * Hkv;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const int rt = (int)row_tiles;
  if constexpr (HD == 16 || HD == 32 || HD == 64) {
    if (dtype == 0 && rows == F32Tile<HD, 8>::ROWS) {
      static bool configured[MAX_DEVICES] = {};
      return launch_kernel<float>(flash_f32_kernel<HD, 8>, F32Tile<HD, 8>::bytes(), configured,
                                  blocks, stream, q, k, v, out, B, Tn, Hq, Hkv, rt, logit, vec);
    }
    if (dtype == 1 && rows == Bf16Tile<HD, 2>::ROWS) {
      static bool configured[MAX_DEVICES] = {};
      return launch_kernel<__nv_bfloat16>(flash_bf16_kernel<HD, 2>, Bf16Tile<HD, 2>::bytes(),
                                          configured, blocks, stream, q, k, v, out, B, Tn, Hq,
                                          Hkv, rt, logit, vec);
    }
  }
  if (dtype == 0 && rows == F32Tile<HD, 16>::ROWS) {
    static bool configured[MAX_DEVICES] = {};
    return launch_kernel<float>(flash_f32_kernel<HD, 16>, F32Tile<HD, 16>::bytes(), configured,
                                blocks, stream, q, k, v, out, B, Tn, Hq, Hkv, rt, logit, vec);
  }
  if (dtype == 1 && rows == Bf16Tile<HD, 1>::ROWS) {
    static bool configured[MAX_DEVICES] = {};
    return launch_kernel<__nv_bfloat16>(flash_bf16_kernel<HD, 1>, Bf16Tile<HD, 1>::bytes(),
                                        configured, blocks, stream, q, k, v, out, B, Tn, Hq,
                                        Hkv, rt, logit, vec);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, T, Hq, hd); k, v (B, T, Hkv, hd); out (B, T, Hq, hd), all contiguous.
// hd in {16, 32, 48, 64, 128, 192}; rows: query rows per block, from the
// plan (kernels/flash_attention.py): 128 (hd 16, 32, 64) or 64.
// dtype: 0 = f32, 1 = bf16.
int repro_flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                          int Tn, int Hq, int Hkv, int hd, int rows, float scale, float cap,
                          int dtype, void* stream) {
  if (B <= 0 || Tn <= 0 || Hkv <= 0 || Hq % Hkv != 0 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Logit logit = cap > 0.f ? Logit{scale / cap, cap * LOG2E} : Logit{scale * LOG2E, 0.f};
  const int vec = aligned16(q) && aligned16(k) && aligned16(v);
  switch (hd) {
    case 16: return (int)launch_hd<16>(dtype, rows, q, k, v, out, B, Tn, Hq, Hkv, logit, vec, s);
    case 32: return (int)launch_hd<32>(dtype, rows, q, k, v, out, B, Tn, Hq, Hkv, logit, vec, s);
    case 64: return (int)launch_hd<64>(dtype, rows, q, k, v, out, B, Tn, Hq, Hkv, logit, vec, s);
    case 48: return (int)launch_hd<48>(dtype, rows, q, k, v, out, B, Tn, Hq, Hkv, logit, vec, s);
    case 128:
      return (int)launch_hd<128>(dtype, rows, q, k, v, out, B, Tn, Hq, Hkv, logit, vec, s);
    case 192:
      return (int)launch_hd<192>(dtype, rows, q, k, v, out, B, Tn, Hq, Hkv, logit, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
