// Attention tile of the plain online flash kernels where the wgmma tile does
// not serve them: at d = 512 the online-max one (flash_online.cu) and the
// training forward (flash_fwd_lse.cu: the online policy plus the log-sum-exp
// of each row). The shared kernels, the plain kernels at d = 64 and the bound
// one (flash_bound.cu) at d = 512 run on the wgmma + TMA tiles of
// attn_wgmma.cuh and attn_wgmma_d512.cuh; flash_bwd_tile.cuh takes the
// bf16 packing helpers from here.
// Plain C interface, no PyTorch headers: built with nvcc -gencode
// arch=compute_90a,code=sm_90a and loaded through ctypes (ops/_build.py).
//
// One block computes BQ query rows of one (batch, head) against the keys of
// that (batch, head), streamed through shared memory in tiles of BK keys.
// Scores and the output accumulator are fp32.
//
// The running max of the JAX package's _flash_kernel. Each query row keeps m
// (log2 units, started at the finite -1e30, so that the first alpha is
// exp2(-1e30 - m) = 0 and never inf - inf); per key tile m_new = max(m,
// rowmax(s)), alpha = exp2(m - m_new), p = exp2(s - m_new) <= 1, and the row
// sum and the output accumulator are rescaled by alpha before the tile's P V
// is added. No row can flush. At
// d < 128 the argument s - m_new is rounded to bf16 before exp2 and the row
// sum adds the bf16-rounded p; at d >= 128 p stays fp32 for the sum and only
// the product's operand is rounded (as _flash_kernel's two branches do).
// The accumulator lives in WMMA fragments whose element-to-row mapping is
// opaque, so the rows' alphas go through a [BQ, 16] fp32 tile in shared
// memory that each warp loads as a fragment of the same type and multiplies
// in element by element (every channel slab of the d=512 tile included).
//
// Per key tile: (1) all threads copy K and V tiles to shared memory with
// 16-byte loads; (2) each warp computes its 16x16 score fragments S = Qs K^T
// with bf16 WMMA (mma.sync) and stores them as fp32; (3) every thread turns
// kColsPerThread scores of one query row into bf16 probabilities and adds
// them to its row sum; (4) each warp adds P V into
// the output fragments it owns, which stay in registers across the whole
// key loop. The epilogue divides by the row sums and writes bf16.
//
// The tile that fits: d=512 (the VAE mid attention) cannot hold a 64x512
// fp32 accumulator in one block's registers; it takes 32 query rows in 8
// warps, and the 32x512 accumulator is split by channel slabs across the
// warps (64 registers each). Its K and V tiles need 176 KB of shared memory,
// opted in with cudaFuncSetAttribute.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace irt {

using namespace nvcuda;

// kFlashOnline: plain attention with the running max (JAX _flash_kernel).
// kFlashLse: kFlashOnline that also writes lse2 = m + log2(row sum), the
// residual of the backward kernels (JAX ops/flash_vjp.py, _fwd_lse_kernel).
enum class Mode { kFlashOnline, kFlashLse };

constexpr float kNegInf = -1e30f;  // the JAX kernels' finite sentinel
constexpr int kAlphaCols = 16;     // width of the alpha tile: one fp32 WMMA fragment

template <int D, int BQ, int BK, int NW>
struct TileCfg {
  static constexpr int kThreads = NW * 32;
  static constexpr int kLdh = D + 8;   // bf16 row stride of the Q, K, V tiles
  static constexpr int kLdp = BK + 8;  // bf16 row stride of the P tile
  static constexpr int kLds = BK + 4;  // fp32 row stride of the score tile
  static constexpr int kLdo = D + 4;   // fp32 row stride of the output staging tile
  static constexpr int kQOff = 0;
  static constexpr int kKOff = kQOff + BQ * kLdh * 2;
  static constexpr int kVOff = kKOff + BK * kLdh * 2;
  static constexpr int kPOff = kVOff + BK * kLdh * 2;
  static constexpr int kSOff = kPOff + BQ * kLdp * 2;
  static constexpr int kAOff = kSOff + BQ * kLds * 4;  // the alpha tile
  static constexpr int kSmemBytes = kAOff + BQ * kAlphaCols * 4;
  static constexpr int kTpr = kThreads / BQ;          // threads per query row
  static constexpr int kColsPerThread = BK / kTpr;    // scores per thread per tile
  static constexpr int kDimsPerThread = D / kTpr;     // q channels per thread of the Q copy
  static constexpr int kSFrags = (BQ / 16) * (BK / 16) / NW;  // score fragments per warp
  static constexpr int kOFrags = (BQ / 16) * (D / 16) / NW;   // output fragments per warp

  static_assert(kThreads % BQ == 0 && kTpr <= 32 && (kTpr & (kTpr - 1)) == 0,
                "a query row's threads must be a power-of-two group inside one warp");
  static_assert((BQ / 16) * (BK / 16) % NW == 0 && (BK / 16) % kSFrags == 0,
                "a warp's score fragments must share one 16-row tile");
  static_assert((BQ / 16) * (D / 16) % NW == 0 && (D / 16) % kOFrags == 0,
                "a warp's output fragments must share one 16-row tile");
  static_assert(kColsPerThread % 8 == 0 && kDimsPerThread % 8 == 0,
                "per-thread spans are whole 16-byte vectors");
  static_assert(BQ * kLdo * 4 <= 2 * BK * kLdh * 2,
                "the output staging tile reuses the K and V tiles");
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");
  static_assert(kKOff % 32 == 0 && kVOff % 32 == 0 && kPOff % 32 == 0 && kSOff % 32 == 0 &&
                    kAOff % 32 == 0 && kSmemBytes % 128 == 0,
                "WMMA needs 256-bit aligned tiles");
};

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

// q, out: [B, H, Sq, D]; k, v: [B, H, S, D]. qscale = scale * log2(e). lse
// (kFlashLse only): [B, H, Sq] fp32, log2 units.
template <Mode M, int D, int BQ, int BK, int NW>
__global__ void __launch_bounds__(NW * 32)
attn_tile_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out,
                 int H, int Sq, int S, float qscale,
                 float* __restrict__ lse) {
  using Cfg = TileCfg<D, BQ, BK, NW>;
  constexpr bool kArgBf16 = D < 128;  // round s - m to bf16 before exp2
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + Cfg::kQOff);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + Cfg::kKOff);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + Cfg::kVOff);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + Cfg::kPOff);
  float* Ss = reinterpret_cast<float*>(smem + Cfg::kSOff);
  float* Al = reinterpret_cast<float*>(smem + Cfg::kAOff);

  const int warp = tid / 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t q_base = ((size_t)(b * H + h) * Sq + (size_t)blockIdx.x * BQ) * D;

  // Q tile, pre-scaled in bf16 as the JAX kernels do (q * bf16(scale*log2e)),
  // copied by the thread group that owns the row.
  const int r = tid / Cfg::kTpr;
  const int part = tid % Cfg::kTpr;
  const float qs_bf = __bfloat162float(__float2bfloat16(qscale));
  {
    const __nv_bfloat16* src = q + q_base + (size_t)r * D + part * Cfg::kDimsPerThread;
    __nv_bfloat16* dst = Qs + r * Cfg::kLdh + part * Cfg::kDimsPerThread;
#pragma unroll
    for (int c = 0; c < Cfg::kDimsPerThread; c += 8) {
      float f[8], g[8];
      unpack8(*reinterpret_cast<const uint4*>(src + c), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) g[e] = f[e] * qs_bf;
      *reinterpret_cast<uint4*>(dst + c) = pack8(g);
    }
  }

  // fragments owned by this warp
  const int s_first = warp * Cfg::kSFrags;
  const int s_rt = s_first / (BK / 16);
  const int s_ct0 = s_first % (BK / 16);
  const int o_first = warp * Cfg::kOFrags;
  const int o_rt = o_first / (D / 16);
  const int o_ct0 = o_first % (D / 16);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o_frag[Cfg::kOFrags];
#pragma unroll
  for (int i = 0; i < Cfg::kOFrags; ++i) wmma::fill_fragment(o_frag[i], 0.f);
  float lsum = 0.f;
  float m_run = kNegInf;

  for (int j0 = 0; j0 < S; j0 += BK) {
    // (1) K and V tiles -> shared memory
    const size_t kv_base = (((size_t)b * H + h) * S + j0) * D;
    for (int c = tid; c < BK * D / 8; c += Cfg::kThreads) {
      const int kr = c / (D / 8);
      const int kc = (c % (D / 8)) * 8;
      const size_t g = kv_base + (size_t)kr * D + kc;
      *reinterpret_cast<uint4*>(Ks + kr * Cfg::kLdh + kc) = *reinterpret_cast<const uint4*>(k + g);
      *reinterpret_cast<uint4*>(Vs + kr * Cfg::kLdh + kc) = *reinterpret_cast<const uint4*>(v + g);
    }
    __syncthreads();

    // (2) scores S = Qs K^T, fp32
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s_frag[Cfg::kSFrags];
#pragma unroll
      for (int i = 0; i < Cfg::kSFrags; ++i) wmma::fill_fragment(s_frag[i], 0.f);
#pragma unroll 4
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa;
        wmma::load_matrix_sync(qa, Qs + s_rt * 16 * Cfg::kLdh + kk * 16, Cfg::kLdh);
#pragma unroll
        for (int i = 0; i < Cfg::kSFrags; ++i) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
          wmma::load_matrix_sync(kb, Ks + (s_ct0 + i) * 16 * Cfg::kLdh + kk * 16, Cfg::kLdh);
          wmma::mma_sync(s_frag[i], qa, kb, s_frag[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < Cfg::kSFrags; ++i)
        wmma::store_matrix_sync(Ss + s_rt * 16 * Cfg::kLds + (s_ct0 + i) * 16, s_frag[i],
                                Cfg::kLds, wmma::mem_row_major);
    }
    __syncthreads();

    // (3) p = exp2(s - running max) -> bf16 P tile, row sums
    {
      const float* srow = Ss + r * Cfg::kLds + part * Cfg::kColsPerThread;
      __nv_bfloat16* prow = Ps + r * Cfg::kLdp + part * Cfg::kColsPerThread;
      float m_new = m_run;
#pragma unroll
      for (int c = 0; c < Cfg::kColsPerThread; c += 8) {
        float sc[8];
        load8f(srow + c, sc);
#pragma unroll
        for (int e = 0; e < 8; ++e) m_new = fmaxf(m_new, sc[e]);
      }
#pragma unroll
      for (int off = Cfg::kTpr / 2; off > 0; off >>= 1)
        m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, off));
      const float alpha = exp2f(m_run - m_new);
      m_run = m_new;
      lsum *= alpha;  // each thread's share of the row sum takes the row's alpha
      for (int c = part; c < kAlphaCols; c += Cfg::kTpr) Al[r * kAlphaCols + c] = alpha;
#pragma unroll
      for (int c = 0; c < Cfg::kColsPerThread; c += 8) {
        float p[8];
        load8f(srow + c, p);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float arg = p[e] - m_new;
          if constexpr (kArgBf16) arg = __bfloat162float(__float2bfloat16(arg));
          p[e] = exp2f(arg);
        }
        const uint4 packed = pack8(p);
        // sum what the product sees, except where the JAX kernel sums fp32 p
        if constexpr (kArgBf16) unpack8(packed, p);
#pragma unroll
        for (int e = 0; e < 8; ++e) lsum += p[e];
        *reinterpret_cast<uint4*>(prow + c) = packed;
      }
    }
    __syncthreads();

    // (4) O = O * alpha + P V
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> a_frag;
      wmma::load_matrix_sync(a_frag, Al + o_rt * 16 * kAlphaCols, kAlphaCols,
                             wmma::mem_row_major);
#pragma unroll
      for (int i = 0; i < Cfg::kOFrags; ++i) {
#pragma unroll
        for (int e = 0; e < a_frag.num_elements; ++e) o_frag[i].x[e] *= a_frag.x[e];
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, Ps + o_rt * 16 * Cfg::kLdp + kk * 16, Cfg::kLdp);
#pragma unroll
      for (int i = 0; i < Cfg::kOFrags; ++i) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, Vs + kk * 16 * Cfg::kLdh + (o_ct0 + i) * 16, Cfg::kLdh);
        wmma::mma_sync(o_frag[i], pa, vb, o_frag[i]);
      }
    }
    __syncthreads();
  }

  // epilogue: out = O / l in bf16; O is staged through the K/V tiles
#pragma unroll
  for (int off = Cfg::kTpr / 2; off > 0; off >>= 1)
    lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
  float* Os = reinterpret_cast<float*>(smem + Cfg::kKOff);
  float* Ls = reinterpret_cast<float*>(smem + Cfg::kPOff);
#pragma unroll
  for (int i = 0; i < Cfg::kOFrags; ++i)
    wmma::store_matrix_sync(Os + o_rt * 16 * Cfg::kLdo + (o_ct0 + i) * 16, o_frag[i],
                            Cfg::kLdo, wmma::mem_row_major);
  if (part == 0) Ls[r] = lsum;
  if constexpr (M == Mode::kFlashLse) {
    if (part == 0)
      lse[(size_t)(b * H + h) * Sq + (size_t)blockIdx.x * BQ + r] = m_run + log2f(lsum);
  }
  __syncthreads();
  for (int c = tid; c < BQ * D / 8; c += Cfg::kThreads) {
    const int orow = c / (D / 8);
    const int oc = (c % (D / 8)) * 8;
    const float l = Ls[orow];
    float f[8];
    load8f(Os + orow * Cfg::kLdo + oc, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = f[e] / l;
    *reinterpret_cast<uint4*>(out + q_base + (size_t)orow * D + oc) = pack8(f);
  }
}

template <Mode M, int D, int BQ, int BK, int NW>
cudaError_t launch_attn(const void* q, const void* k, const void* v, void* out, int B, int H,
                        int Sq, int S, float qscale, void* stream, void* lse = nullptr) {
  using Cfg = TileCfg<D, BQ, BK, NW>;
  if (B <= 0 || H <= 0 || Sq <= 0 || S <= 0 || Sq % BQ != 0 || S % BK != 0 || B > 65535 ||
      H > 65535 || (M == Mode::kFlashLse && lse == nullptr))
    return cudaErrorInvalidValue;
  constexpr int kBytes = Cfg::kSmemBytes;
  auto kern = attn_tile_kernel<M, D, BQ, BK, NW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(Sq / BQ, H, B);
  kern<<<grid, Cfg::kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), H, Sq, S, qscale,
      static_cast<float*>(lse));
  return cudaGetLastError();
}

}  // namespace irt
