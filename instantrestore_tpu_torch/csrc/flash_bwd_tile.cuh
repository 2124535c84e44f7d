// The d = 512 tile of the two backward kernels of the differentiable
// attention (flash_bwd_dq.cu, flash_bwd_dkv.cu: the VAE mid attention, one
// head, 4096 tokens). d = 64 runs on the wgmma + TMA tile of
// attn_wgmma_bwd.cuh. Plain C interface, no PyTorch headers.
//
// Both recompute the probabilities from the forward's residual instead of
// reading them from device memory: with qs = bf16(q * bf16(scale * log2 e)),
// exactly the forward's scaled q,
//     s2 = qs k^T (fp32, log2 units),   P = exp2(s2 - lse2)   (fp32, the
//     argument is NOT rounded to bf16 here, unlike the forward at d < 128),
//     dP = dO v^T (fp32),   dS = bf16(P * (dP - delta) * scale),
// with delta_i = sum_c dO_ic O_ic given by the caller. Then
//     dQ = sum_j dS_j k_j           (a block owns BQ query rows, streams keys)
//     dV = sum_i bf16(P_i)^T dO_i   (a block owns BK keys, streams queries)
//     dK = sum_i dS_i^T q_i         (the unscaled q)
// Two kernels and no atomics: each output element is summed by one thread
// block in a fixed order, so the gradients repeat bit for bit.
//
// Each step of a block: (1) copy the streamed tiles to shared memory with
// 16-byte loads; (2) the warps share out the 16x16 fragments of the two score
// products (s2 and dP) and store them as fp32; (3) every thread turns its
// share of one row into bf16 P / dS; (4) each warp adds the tile's products
// into the accumulator fragments it owns, which stay in registers across the
// whole loop. The dK/dV kernel computes the transposed scores s2^T = k qs^T
// directly (WMMA column-major loads of the query tile), so no tile is
// transposed in memory.
//
// A block cannot keep [64, 512] fp32 accumulators in its registers: it takes
// 32 rows in 8 warps with the accumulator split by channel slabs (64
// registers each; the dK/dV kernel holds two, 128 registers), the two score
// products reduced over all 512 channels cooperatively into shared memory
// first. dQ streams 64-key tiles, dK/dV 32-query tiles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace irt {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(h2[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) h2[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
  return u;
}

__device__ __forceinline__ void load8f(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// The fragments of two [ROWS, COLS] products over D channels, shared out to
// NW warps: warp w takes kPerWarp consecutive jobs, in groups of kGroup
// fragments that share a row tile (one A fragment load per group and k-step).
template <int D, int ROWS, int COLS, int NW>
struct ScoreJobs {
  static constexpr int kRT = ROWS / 16, kCT = COLS / 16;
  static constexpr int kPerProduct = kRT * kCT;
  static constexpr int kPerWarp = 2 * kPerProduct / NW;
  static constexpr int kGroup = kPerWarp < kCT ? kPerWarp : kCT;
  static constexpr int kGroups = kPerWarp / kGroup;
  static_assert(2 * kPerProduct % NW == 0 && kPerWarp >= 1, "score fragments divide over the warps");
  static_assert(kCT % kGroup == 0 && kPerWarp % kGroup == 0, "a group stays inside one row tile");
};

// out0 = a0 b0^T and out1 = a1 b1^T: a* [ROWS, D] and b* [COLS, D] bf16 tiles
// of row stride D + 8, out* [ROWS, COLS] fp32 of row stride COLS + 4.
template <int D, int ROWS, int COLS, int NW>
__device__ __forceinline__ void score_pair(const bf16* a0, const bf16* b0, float* out0,
                                           const bf16* a1, const bf16* b1, float* out1,
                                           int warp) {
  using J = ScoreJobs<D, ROWS, COLS, NW>;
  constexpr int ldh = D + 8, lds = COLS + 4;
#pragma unroll
  for (int g = 0; g < J::kGroups; ++g) {
    const int job = warp * J::kPerWarp + g * J::kGroup;
    const bool second = job >= J::kPerProduct;
    const int f = job % J::kPerProduct;
    const int rt = f / J::kCT, ct0 = f % J::kCT;
    const bf16* a = (second ? a1 : a0) + rt * 16 * ldh;
    const bf16* b = (second ? b1 : b0) + ct0 * 16 * ldh;
    float* out = (second ? out1 : out0) + rt * 16 * lds + ct0 * 16;
    AccFrag acc[J::kGroup];
#pragma unroll
    for (int i = 0; i < J::kGroup; ++i) wmma::fill_fragment(acc[i], 0.f);
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, a + kk * 16, ldh);
#pragma unroll
      for (int i = 0; i < J::kGroup; ++i) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(bfr, b + i * 16 * ldh + kk * 16, ldh);
        wmma::mma_sync(acc[i], af, bfr, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < J::kGroup; ++i)
      wmma::store_matrix_sync(out + i * 16, acc[i], lds, wmma::mem_row_major);
  }
}

// A [ROWS, D] fp32 accumulator in fragments, split over NW warps: each warp
// owns kFrags fragments of one 16-row tile.
template <int D, int ROWS, int NW>
struct AccCfg {
  static constexpr int kFrags = (ROWS / 16) * (D / 16) / NW;
  static_assert((ROWS / 16) * (D / 16) % NW == 0 && (D / 16) % kFrags == 0,
                "a warp's accumulator fragments share one 16-row tile");
};

// acc += a b: a [ROWS, INNER] bf16 of row stride INNER + 8, b [INNER, D] bf16
// of row stride D + 8.
template <int D, int ROWS, int INNER, int NW>
__device__ __forceinline__ void accumulate(AccFrag* acc, const bf16* a, const bf16* b, int warp) {
  constexpr int kFrags = AccCfg<D, ROWS, NW>::kFrags;
  constexpr int lda = INNER + 8, ldh = D + 8;
  const int first = warp * kFrags;
  const int rt = first / (D / 16), ct0 = first % (D / 16);
  // one k-step's operands at a time beside the accumulators (the dK/dV
  // kernel's two take 128 registers a thread); the sum's order is unchanged
#pragma unroll 1
  for (int kk = 0; kk < INNER / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
    wmma::load_matrix_sync(af, a + rt * 16 * lda + kk * 16, lda);
#pragma unroll
    for (int i = 0; i < kFrags; ++i) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
      wmma::load_matrix_sync(bfr, b + kk * 16 * ldh + (ct0 + i) * 16, ldh);
      wmma::mma_sync(acc[i], af, bfr, acc[i]);
    }
  }
}

// The accumulator -> a [ROWS, D] fp32 staging tile of row stride D + 4.
template <int D, int ROWS, int NW>
__device__ __forceinline__ void stage_acc(const AccFrag* acc, float* stage, int warp) {
  constexpr int kFrags = AccCfg<D, ROWS, NW>::kFrags;
  constexpr int ldo = D + 4;
  const int first = warp * kFrags;
  const int rt = first / (D / 16), ct0 = first % (D / 16);
#pragma unroll
  for (int i = 0; i < kFrags; ++i)
    wmma::store_matrix_sync(stage + rt * 16 * ldo + (ct0 + i) * 16, acc[i], ldo,
                            wmma::mem_row_major);
}

// The staged [ROWS, D] fp32 tile -> bf16 rows of dst (row stride D).
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void write_staged(const float* stage, bf16* dst, int tid) {
  constexpr int ldo = D + 4;
  for (int c = tid; c < ROWS * D / 8; c += THREADS) {
    const int row = c / (D / 8), col = (c % (D / 8)) * 8;
    float f[8];
    load8f(stage + row * ldo + col, f);
    *reinterpret_cast<uint4*>(dst + (size_t)row * D + col) = pack8(f);
  }
}

// [ROWS, D] bf16 rows of src (row stride D) -> a tile of row stride D + 8;
// with scaled != nullptr also the tile of bf16(x * qs_bf).
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(const bf16* src, bf16* tile, bf16* scaled, float qs_bf,
                                          int tid) {
  constexpr int ldh = D + 8;
  for (int c = tid; c < ROWS * D / 8; c += THREADS) {
    const int row = c / (D / 8), col = (c % (D / 8)) * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)row * D + col);
    if (tile != nullptr) *reinterpret_cast<uint4*>(tile + row * ldh + col) = raw;
    if (scaled != nullptr) {
      float f[8];
      unpack8(raw, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] *= qs_bf;
      *reinterpret_cast<uint4*>(scaled + row * ldh + col) = pack8(f);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: a block owns BQ query rows of one (batch, head) and streams key tiles
// ---------------------------------------------------------------------------

template <int D, int BQ, int BK, int NW>
struct DqCfg {
  static constexpr int kThreads = NW * 32;
  static constexpr int kLdh = D + 8, kLdp = BK + 8, kLds = BK + 4, kLdo = D + 4;
  static constexpr int kQOff = 0;                              // scaled q
  static constexpr int kGOff = kQOff + BQ * kLdh * 2;          // dO
  static constexpr int kKOff = kGOff + BQ * kLdh * 2;
  static constexpr int kVOff = kKOff + BK * kLdh * 2;
  static constexpr int kSOff = kVOff + BK * kLdh * 2;          // s2, fp32
  static constexpr int kPOff = kSOff + BQ * kLds * 4;          // dP, fp32
  static constexpr int kDsOff = kPOff + BQ * kLds * 4;         // dS, bf16
  static constexpr int kSmemBytes = kDsOff + BQ * kLdp * 2;
  static constexpr int kTpr = kThreads / BQ;  // threads per query row
  static_assert(kThreads % BQ == 0 && BK % kTpr == 0, "a row's threads share out its columns");
  static_assert(BQ * kLdo * 4 <= 2 * BK * kLdh * 2, "the staging tile reuses the K and V tiles");
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");
  static_assert(kGOff % 32 == 0 && kKOff % 32 == 0 && kVOff % 32 == 0 && kSOff % 32 == 0 &&
                    kPOff % 32 == 0 && kDsOff % 32 == 0,
                "WMMA needs 256-bit aligned tiles");
};

// q, dout, dq: [B, H, Sq, D]; k, v: [B, H, Skv, D]; lse, delta: [B, H, Sq]
// fp32. qscale = scale * log2(e).
template <int D, int BQ, int BK, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int H, int Sq, int Skv, float qscale, float scale) {
  using Cfg = DqCfg<D, BQ, BK, NW>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + Cfg::kQOff);
  bf16* Gs = reinterpret_cast<bf16*>(smem + Cfg::kGOff);
  bf16* Ks = reinterpret_cast<bf16*>(smem + Cfg::kKOff);
  bf16* Vs = reinterpret_cast<bf16*>(smem + Cfg::kVOff);
  float* Ss = reinterpret_cast<float*>(smem + Cfg::kSOff);
  float* Ps = reinterpret_cast<float*>(smem + Cfg::kPOff);
  bf16* Ds = reinterpret_cast<bf16*>(smem + Cfg::kDsOff);

  const int tid = threadIdx.x, warp = tid / 32;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const size_t row0 = bh * Sq + (size_t)blockIdx.x * BQ;
  const float qs_bf = __bfloat162float(__float2bfloat16(qscale));
  load_tile<D, BQ, Cfg::kThreads>(q + row0 * D, nullptr, Qs, qs_bf, tid);
  load_tile<D, BQ, Cfg::kThreads>(dout + row0 * D, Gs, nullptr, 0.f, tid);

  const int r = tid / Cfg::kTpr, part = tid % Cfg::kTpr;
  const float lse_r = lse[row0 + r], delta_r = delta[row0 + r];

  AccFrag acc[AccCfg<D, BQ, NW>::kFrags];
#pragma unroll
  for (int i = 0; i < AccCfg<D, BQ, NW>::kFrags; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int j0 = 0; j0 < Skv; j0 += BK) {
    const size_t kv0 = (bh * Skv + j0) * D;
    load_tile<D, BK, Cfg::kThreads>(k + kv0, Ks, nullptr, 0.f, tid);
    load_tile<D, BK, Cfg::kThreads>(v + kv0, Vs, nullptr, 0.f, tid);
    __syncthreads();
    score_pair<D, BQ, BK, NW>(Qs, Ks, Ss, Gs, Vs, Ps, warp);
    __syncthreads();
    for (int c = part; c < BK; c += Cfg::kTpr) {
      const float p = exp2f(Ss[r * Cfg::kLds + c] - lse_r);
      Ds[r * Cfg::kLdp + c] = __float2bfloat16(p * (Ps[r * Cfg::kLds + c] - delta_r) * scale);
    }
    __syncthreads();
    accumulate<D, BQ, BK, NW>(acc, Ds, Ks, warp);
    __syncthreads();
  }

  float* stage = reinterpret_cast<float*>(smem + Cfg::kKOff);
  stage_acc<D, BQ, NW>(acc, stage, warp);
  __syncthreads();
  write_staged<D, BQ, Cfg::kThreads>(stage, dq + row0 * D, tid);
}

template <int D, int BQ, int BK, int NW>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq, int B, int H, int Sq,
                          int Skv, float qscale, float scale, void* stream) {
  using Cfg = DqCfg<D, BQ, BK, NW>;
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || Sq % BQ != 0 || Skv % BK != 0 || B > 65535 ||
      H > 65535)
    return cudaErrorInvalidValue;
  auto kern = flash_bwd_dq_kernel<D, BQ, BK, NW>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg::kSmemBytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Sq / BQ, H, B), Cfg::kThreads, Cfg::kSmemBytes,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, Sq, Skv, qscale, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dK, dV: a block owns BK keys of one (batch, head) and streams query tiles
// ---------------------------------------------------------------------------

template <int D, int BQ, int BK, int NW>
struct DkvCfg {
  static constexpr int kThreads = NW * 32;
  static constexpr int kLdh = D + 8, kLdp = BQ + 8, kLds = BQ + 4, kLdo = D + 4;
  static constexpr int kKOff = 0;
  static constexpr int kVOff = kKOff + BK * kLdh * 2;
  static constexpr int kQsOff = kVOff + BK * kLdh * 2;         // scaled q
  static constexpr int kQrOff = kQsOff + BQ * kLdh * 2;        // q as given
  static constexpr int kGOff = kQrOff + BQ * kLdh * 2;         // dO
  static constexpr int kSOff = kGOff + BQ * kLdh * 2;          // s2^T, fp32
  static constexpr int kPOff = kSOff + BK * kLds * 4;          // dP^T, fp32
  static constexpr int kPtOff = kPOff + BK * kLds * 4;         // P^T, bf16
  static constexpr int kDsOff = kPtOff + BK * kLdp * 2;        // dS^T, bf16
  static constexpr int kLseOff = kDsOff + BK * kLdp * 2;       // lse2 and delta of the tile
  static constexpr int kSmemBytes = kLseOff + 2 * BQ * 4;
  static constexpr int kTpr = kThreads / BK;  // threads per key row
  static_assert(kThreads % BK == 0 && BQ % kTpr == 0, "a row's threads share out its columns");
  static_assert(BK * kLdo * 4 <= 3 * BQ * kLdh * 2, "the staging tile reuses the query tiles");
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");
  static_assert(kVOff % 32 == 0 && kQsOff % 32 == 0 && kQrOff % 32 == 0 && kGOff % 32 == 0 &&
                    kSOff % 32 == 0 && kPOff % 32 == 0 && kPtOff % 32 == 0 &&
                    kDsOff % 32 == 0 && kLseOff % 16 == 0,
                "WMMA needs 256-bit aligned tiles");
};

// Shapes as flash_bwd_dq_kernel; dk, dv: [B, H, Skv, D].
template <int D, int BQ, int BK, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq, int Skv,
                     float qscale, float scale) {
  using Cfg = DkvCfg<D, BQ, BK, NW>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + Cfg::kKOff);
  bf16* Vs = reinterpret_cast<bf16*>(smem + Cfg::kVOff);
  bf16* Qs = reinterpret_cast<bf16*>(smem + Cfg::kQsOff);
  bf16* Qr = reinterpret_cast<bf16*>(smem + Cfg::kQrOff);
  bf16* Gs = reinterpret_cast<bf16*>(smem + Cfg::kGOff);
  float* Ss = reinterpret_cast<float*>(smem + Cfg::kSOff);
  float* Ps = reinterpret_cast<float*>(smem + Cfg::kPOff);
  bf16* Pt = reinterpret_cast<bf16*>(smem + Cfg::kPtOff);
  bf16* Ds = reinterpret_cast<bf16*>(smem + Cfg::kDsOff);
  float* Lse = reinterpret_cast<float*>(smem + Cfg::kLseOff);
  float* Delta = Lse + BQ;

  const int tid = threadIdx.x, warp = tid / 32;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const size_t key0 = bh * Skv + (size_t)blockIdx.x * BK;
  const float qs_bf = __bfloat162float(__float2bfloat16(qscale));
  load_tile<D, BK, Cfg::kThreads>(k + key0 * D, Ks, nullptr, 0.f, tid);
  load_tile<D, BK, Cfg::kThreads>(v + key0 * D, Vs, nullptr, 0.f, tid);

  const int r = tid / Cfg::kTpr, part = tid % Cfg::kTpr;
  constexpr int kFrags = AccCfg<D, BK, NW>::kFrags;
  AccFrag acc_k[kFrags], acc_v[kFrags];
#pragma unroll
  for (int i = 0; i < kFrags; ++i) {
    wmma::fill_fragment(acc_k[i], 0.f);
    wmma::fill_fragment(acc_v[i], 0.f);
  }

  for (int i0 = 0; i0 < Sq; i0 += BQ) {
    const size_t q0 = bh * Sq + i0;
    load_tile<D, BQ, Cfg::kThreads>(q + q0 * D, Qr, Qs, qs_bf, tid);
    load_tile<D, BQ, Cfg::kThreads>(dout + q0 * D, Gs, nullptr, 0.f, tid);
    for (int c = tid; c < BQ; c += Cfg::kThreads) {
      Lse[c] = lse[q0 + c];
      Delta[c] = delta[q0 + c];
    }
    __syncthreads();
    score_pair<D, BK, BQ, NW>(Ks, Qs, Ss, Vs, Gs, Ps, warp);
    __syncthreads();
    for (int c = part; c < BQ; c += Cfg::kTpr) {
      const float p = exp2f(Ss[r * Cfg::kLds + c] - Lse[c]);
      Pt[r * Cfg::kLdp + c] = __float2bfloat16(p);
      Ds[r * Cfg::kLdp + c] = __float2bfloat16(p * (Ps[r * Cfg::kLds + c] - Delta[c]) * scale);
    }
    __syncthreads();
    accumulate<D, BK, BQ, NW>(acc_v, Pt, Gs, warp);
    accumulate<D, BK, BQ, NW>(acc_k, Ds, Qr, warp);
    __syncthreads();
  }

  float* stage = reinterpret_cast<float*>(smem + Cfg::kQsOff);
  stage_acc<D, BK, NW>(acc_v, stage, warp);
  __syncthreads();
  write_staged<D, BK, Cfg::kThreads>(stage, dv + key0 * D, tid);
  __syncthreads();
  stage_acc<D, BK, NW>(acc_k, stage, warp);
  __syncthreads();
  write_staged<D, BK, Cfg::kThreads>(stage, dk + key0 * D, tid);
}

template <int D, int BQ, int BK, int NW>
cudaError_t launch_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                           int Sq, int Skv, float qscale, float scale, void* stream) {
  using Cfg = DkvCfg<D, BQ, BK, NW>;
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || Sq % BQ != 0 || Skv % BK != 0 || B > 65535 ||
      H > 65535)
    return cudaErrorInvalidValue;
  auto kern = flash_bwd_dkv_kernel<D, BQ, BK, NW>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg::kSmemBytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Skv / BK, H, B), Cfg::kThreads, Cfg::kSmemBytes,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq,
      Skv, qscale, scale);
  return cudaGetLastError();
}

}  // namespace irt
