// Backward tile of the differentiable attention at head dim 512
// (flash_bwd_dq.cu, flash_bwd_dkv.cu: the VAE mid-block attention, one head,
// 4096 tokens), designed for Hopper on the PTX wrappers of attn_wgmma.cuh:
// wgmma.mma_async for every product, every operand brought by TMA into shared
// memory behind mbarriers, the gradients accumulated in registers.
// Plain C interface, no PyTorch headers: built with nvcc -gencode
// arch=compute_90a,code=sm_90a and loaded through ctypes (ops/_build.py).
//
// The function (JAX: _bwd_dq_kernel and _bwd_dkv_kernel of
// instantrestore_tpu/ops/flash_vjp.py), as attn_wgmma_bwd.cuh computes it at
// d = 64, with qs = bf16(q * bf16(scale * log2 e)) given by the caller:
//     s2 = qs k^T (fp32, log2 units),   P = exp2(s2 - lse2)   (fp32, the
//     argument is not rounded),   dP = dO v^T (fp32),
//     dS = bf16(P * (dP - delta) * scale),
//     dQ = sum_j dS_j k_j,   dV = sum_i bf16(P_i)^T dO_i,   dK = sum_i dS_i^T q_i
// (the unscaled q), fp32 accumulators, bf16 outputs. No atomics: each output
// element is summed by one warpgroup in a fixed order, so launches repeat bit
// for bit.
//
// What bounds it on the H100: tensor-core operations (a batch-2 launch at
// 4096 x 4096 is 0.10 TFLOP for dQ, 0.14 for dK and dV, against 34 MB). What
// the card's limits force, and what the design does:
//   * A block owns 64 rows (query rows for dQ, keys for dK and dV) and streams
//     the other side in chunks of 16 rows. Its [64, 512] fp32 gradient is 128
//     registers a thread of each of two consumer warpgroups, each owning 256
//     output channels (setmaxnreg 40 / 232, as attn_wgmma_d512.cuh). A
//     block's dK and dV together would be 64K fp32 values, the SM's whole
//     register file, so dK/dV is two launches of this tile (Side::kDV, then
//     Side::kDK): five products where a joint kernel needs four, against
//     which the joint form has no room.
//   * The owned [64, 512] operands are the A operands of the score products
//     from shared memory (64 KB each, eight [64, 64] slabs in the 128-byte
//     swizzle): in registers they would take 128 more a thread. That leaves
//     room for chunks of 16 streamed rows only: a [16, 512] tile is 16 KB,
//     and dK's stage holds three (qs, dO, q). Two stages for dQ and dK, four
//     for dV.
//   * The score products need all 512 channels. Side::kDQ and Side::kDK run
//     two of them (S and dP, or S^T and dP^T), one a warpgroup over all the
//     channels, and the two hand their [64, 16] fp32 results to each other
//     through shared memory; Side::kDV runs one (S^T), each warpgroup over its
//     256 channels, and the two add their partial S^T (S0 + S1 and S1 + S0 are
//     the same fp32 bits). Either way both warpgroups then hold the same S and
//     dP and form the same P and dS on the accumulator fragments, packed
//     pairwise to bf16: the A fragment of the gradient product over its own
//     four slabs of the streamed tile read MN-major (dQ: K; dK: q; dV: dO).
//     The exchange of dK and dV is written over the streamed tile its writer
//     alone has read and waited for (qs, or dO), so it costs no shared
//     memory; dQ's has a buffer of its own, double-buffered by tile parity.
//   * lse2 and delta index the owned rows for dQ (registers) and the streamed
//     columns for dK and dV (a 64-byte bulk copy each on the stage's barrier).
//   Within a warpgroup the score products of chunk t + 1 and the gradient
//   product of chunk t are started back to back, P and dS of chunk t + 1 are
//   formed under the gradient product, and packed after its wait, as in
//   attn_wgmma_bwd.cuh. No wgmma batch sits on a runtime branch.
// Shapes: Sq % 64 == 0 and Skv % 32 == 0, those of the d = 512 forward
// (attn_wgmma_d512.cuh); owned keys past Skv are computed on the next rows
// (or zeros past the array) and never written.

#pragma once

#include "attn_wgmma.cuh"
#include "attn_wgmma_bwd.cuh"

namespace irt {
namespace wgb512 {

using wgb::BwdProblem;

constexpr int kD = 512;
constexpr int kSlabCols = 64;                        // channels of one 128-byte swizzle row
constexpr int kSlabs = kD / kSlabCols;               // 8
constexpr int kHalfSlabs = kSlabs / 2;               // a warpgroup's output channels
constexpr int kRows = 64;                            // owned rows a block
constexpr int kChunk = 16;                           // streamed rows a stage
constexpr int kOwnSlabBytes = kRows * 128;           // 8 KB
constexpr int kOwnBytes = kSlabs * kOwnSlabBytes;    // 64 KB
constexpr int kTileSlabBytes = kChunk * 128;         // 2 KB
constexpr int kTileBytes = kSlabs * kTileSlabBytes;  // 16 KB
constexpr int kVecBytes = kChunk * 4;                // 16 fp32 of lse2 or delta
constexpr int kXBytes = 128 * 8 * 4;                 // a warpgroup's [64, 16] fp32
constexpr int kThreads = 3 * 128;
constexpr int kProducerRegs = 40;  // 128 * 40 + 256 * 232 <= 65536
constexpr int kConsumerRegs = 232;
constexpr int kExchangeBar = 1;    // named barrier of the two consumer warpgroups

enum class Side { kDQ, kDK, kDV };

template <Side SD>
struct Cfg {
  static constexpr bool kTwo = SD != Side::kDV;  // two score products, one a warpgroup
  static constexpr bool kByRow = SD == Side::kDQ;  // lse2 and delta of the owned rows
  static constexpr bool kInStage = SD != Side::kDQ;  // the exchange over a consumed tile
  static constexpr int kOwn = kTwo ? 2 : 1;        // dQ: qs, dO; dK: K, V; dV: K
  static constexpr int kTiles = SD == Side::kDK ? 3 : 2;  // dQ: K, V; dK: qs, dO, q; dV: qs, dO
  static constexpr int kGrad = SD == Side::kDQ ? 0 : SD == Side::kDK ? 2 : 1;  // B of the gradient
  static constexpr int kStages = SD == Side::kDV ? 4 : 2;
  static constexpr int kSteps = kTwo ? kD / 16 : kD / 32;  // k16 steps of a score product
  static constexpr int kStageOff = kOwn * kOwnBytes;
  static constexpr int kStageBytes = kTiles * kTileBytes;
  static constexpr int kVecOff = kStageOff + kStages * kStageBytes;
  static constexpr int kXOff = kVecOff + (kByRow ? 0 : kStages * 2 * kVecBytes);
  static constexpr int kSmemBytes = kXOff + (kInStage ? 0 : 2 * 2 * kXBytes) + 1024;
  static_assert(kSmemBytes + 64 <= 232448, "over the 227 KB a block may use");
};

// d[64x16] (+)= a[64x16] b[16x16], A and B from shared memory, both K-major.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_m64n16k16_ss(float (&d)[8], uint64_t adesc, uint64_t bdesc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(adesc), "l"(bdesc), "n"(SCALE_D));
}

// map_own0/1: the owned operands as [B * H * own side, 512] with a [64, 64]
// box; map_t0/1/2: the streamed ones as [B * H * streamed side, 512] with a
// [16, 64] box (maps a side does not read alias a read one). Grid
// (ceil(own side / 64), H, B).
template <Side SD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_d512_kernel(const __grid_constant__ CUtensorMap map_own0,
                const __grid_constant__ CUtensorMap map_own1,
                const __grid_constant__ CUtensorMap map_t0,
                const __grid_constant__ CUtensorMap map_t1,
                const __grid_constant__ CUtensorMap map_t2, const BwdProblem pr) {
  using C = Cfg<SD>;
  constexpr int kSt = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kSt];

  const int H = pr.H, h = blockIdx.y, b = blockIdx.z;
  const int seg = b * H + h;
  const int own_len = C::kByRow ? pr.Sq : pr.Skv;
  const int str_len = C::kByRow ? pr.Skv : pr.Sq;
  const int r0 = blockIdx.x * kRows;
  const uint32_t raw_addr = wg::smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;  // the swizzle's 1024-byte period
  unsigned char* const base_ptr = smem_raw + (base - raw_addr);
  const uint32_t bar0 = wg::smem_u32(bars);
  const uint32_t own_full = bar0;
  auto full_bar = [&](int st) { return bar0 + 8u * (1 + st); };
  auto empty_bar = [&](int st) { return bar0 + 8u * (1 + kSt + st); };
  auto stage = [&](int st) { return base + static_cast<uint32_t>(C::kStageOff + st * C::kStageBytes); };
  auto vec = [&](int st) { return base + static_cast<uint32_t>(C::kVecOff + st * 2 * kVecBytes); };

  if (threadIdx.x == 0) {
    wg::mbar_init(own_full, 1);
    for (int st = 0; st < kSt; ++st) {
      wg::mbar_init(full_bar(st), 1);
      wg::mbar_init(empty_bar(st), 8);  // the consumer warps
    }
    wg::fence_barrier_init();
  }
  __syncthreads();

  const int wgrp = threadIdx.x / 128;
  const int tw = threadIdx.x % 128;
  const int warp = tw / 32;
  const int lane = tw % 32;
  const int n_tiles = str_len / kChunk;

  if (wgrp == 2) {
    wg::reg_dec<kProducerRegs>();
    // ---- producer: the owned operands once, then the streamed chunks ----
    if (warp == 0 && lane == 0) {
      const CUtensorMap* tmaps[3] = {&map_t0, &map_t1, &map_t2};
      wg::mbar_expect_tx(own_full, C::kOwn * kOwnBytes);
      for (int c = 0; c < kSlabs; ++c) {
        wg::tma_load_2d(base + c * kOwnSlabBytes, &map_own0, c * kSlabCols, seg * own_len + r0,
                        own_full);
        if constexpr (C::kTwo)
          wg::tma_load_2d(base + kOwnBytes + c * kOwnSlabBytes, &map_own1, c * kSlabCols,
                          seg * own_len + r0, own_full);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kSt;
        const int row = seg * str_len + t * kChunk;
        wg::mbar_wait(empty_bar(st), ((t / kSt) & 1) ^ 1u);
        wg::mbar_expect_tx(full_bar(st), C::kStageBytes + (C::kByRow ? 0 : 2 * kVecBytes));
        for (int i = 0; i < C::kTiles; ++i)
          for (int c = 0; c < kSlabs; ++c)
            wg::tma_load_2d(stage(st) + i * kTileBytes + c * kTileSlabBytes, tmaps[i],
                            c * kSlabCols, row, full_bar(st));
        if constexpr (!C::kByRow) {
          const size_t v0 = static_cast<size_t>(seg) * pr.lse_pitch + t * kChunk;
          wgb::bulk_load(vec(st), pr.lse + v0, kVecBytes, full_bar(st));
          wgb::bulk_load(vec(st) + kVecBytes, pr.delta + v0, kVecBytes, full_bar(st));
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: the 64 owned rows, output channels 256 w .. 256 w + 255 ----
  wg::reg_inc<kConsumerRegs>();
  const int g = lane >> 2;  // row of the warp's 16 (and g + 8)
  const int tq = lane & 3;  // column pair within each group of 8
  const float scale = pr.scale;
  // the score product of this warpgroup: own operand w against streamed tile
  // w over all channels (kTwo), or own operand 0 against tile 0 over the
  // channels of slabs 4 w .. 4 w + 3
  const uint32_t a_base = base + (C::kTwo ? wgrp * kOwnBytes : wgrp * kHalfSlabs * kOwnSlabBytes);
  const uint32_t b_off = C::kTwo ? wgrp * kTileBytes : wgrp * kHalfSlabs * kTileSlabBytes;
  const uint32_t b_other = C::kTwo ? (1 - wgrp) * kTileBytes : (1 - wgrp) * kHalfSlabs * kTileSlabBytes;
  float lse_r[2] = {0.f, 0.f}, dlt_r[2] = {0.f, 0.f};  // kByRow: rows g and g + 8
  if constexpr (C::kByRow) {
    const size_t v0 = static_cast<size_t>(seg) * pr.lse_pitch + r0 + warp * 16 + g;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lse_r[i] = pr.lse[v0 + 8 * i];
      dlt_r[i] = pr.delta[v0 + 8 * i];
    }
  }

  float acc[kHalfSlabs][32];
#pragma unroll
  for (int c = 0; c < kHalfSlabs; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float mine[8];   // this warpgroup's score product of one chunk
  float s[8], dp[8];  // the chunk's S (or S^T) and dP; then P or dS in s
  uint32_t a[4];   // bf16 P or dS of the chunk whose gradient product is next

  auto start_score = [&](int st) {
    const uint64_t ad = wg::smem_desc(a_base);
    const uint64_t bd = wg::smem_desc(stage(st) + b_off);
    wg::wgmma_fence();
    wgmma_m64n16k16_ss<0>(mine, ad, bd);
#pragma unroll
    for (int ks = 1; ks < C::kSteps; ++ks)
      wgmma_m64n16k16_ss<1>(mine, ad + (((ks / 4) * kOwnSlabBytes + (ks % 4) * 32) >> 4),
                            bd + (((ks / 4) * kTileSlabBytes + (ks % 4) * 32) >> 4));
    wg::wgmma_commit();
  };
  // acc[c] += a B, B = slab 4 w + c of the gradient's streamed tile, MN-major
  auto start_grad = [&](int st) {
    const uint64_t gd = wg::smem_desc(stage(st) + C::kGrad * kTileBytes +
                                      wgrp * kHalfSlabs * kTileSlabBytes);
    wg::wgmma_fence();
#pragma unroll
    for (int c = 0; c < kHalfSlabs; ++c)
      wg::wgmma_m64n64k16<1, 1>(acc[c], a, gd + ((c * kTileSlabBytes) >> 4));
    wg::wgmma_commit();
  };
  // this warpgroup's result of chunk t to the other, the other's back: both
  // then hold S and dP (kTwo: warpgroup 0 computed S) or the whole S^T
  auto exchange = [&](int t) {
    unsigned char* mine_x;
    const unsigned char* other_x;
    if constexpr (C::kInStage) {
      unsigned char* st_ptr = base_ptr + C::kStageOff + (t % kSt) * C::kStageBytes;
      mine_x = st_ptr + b_off;
      other_x = st_ptr + b_other;
    } else {
      unsigned char* x = base_ptr + C::kXOff + (t & 1) * 2 * kXBytes;
      mine_x = x + wgrp * kXBytes;
      other_x = x + (1 - wgrp) * kXBytes;
    }
    float4* mx = reinterpret_cast<float4*>(mine_x);
    mx[tw] = make_float4(mine[0], mine[1], mine[2], mine[3]);
    mx[128 + tw] = make_float4(mine[4], mine[5], mine[6], mine[7]);
    asm volatile("bar.sync %0, 256;\n" ::"n"(kExchangeBar) : "memory");
    const float4* ox = reinterpret_cast<const float4*>(other_x);
    const float4 y0 = ox[tw], y1 = ox[128 + tw];
    const float th[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if constexpr (C::kTwo) {
        s[i] = wgrp == 0 ? mine[i] : th[i];
        dp[i] = wgrp == 0 ? th[i] : mine[i];
      } else {
        s[i] = mine[i] + th[i];
      }
    }
  };
  // in s: dQ, dK: dS = P (dP - delta) scale; dV: P; P = exp2(s - lse2).
  // Element 4 j + e: row g + 8 (e >> 1), column 8 j + 2 tq + (e & 1).
  auto grad = [&](int st) {
    const float* v = reinterpret_cast<const float*>(base_ptr + (vec(st) - base));
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float2 l2 = make_float2(0.f, 0.f), d2 = make_float2(0.f, 0.f);
      if constexpr (!C::kByRow) {
        l2 = *reinterpret_cast<const float2*>(v + 8 * j + 2 * tq);
        d2 = *reinterpret_cast<const float2*>(v + kChunk + 8 * j + 2 * tq);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * j + e;
        const float l = C::kByRow ? lse_r[e >> 1] : ((e & 1) ? l2.y : l2.x);
        const float p = wg::ex2(s[c] - l);
        if constexpr (SD == Side::kDV) {
          s[c] = p;
        } else {
          const float d = C::kByRow ? dlt_r[e >> 1] : ((e & 1) ? d2.y : d2.x);
          s[c] = p * (dp[c] - d) * scale;
        }
      }
    }
  };
  auto pin_acc = [&]() {
#pragma unroll
    for (int c = 0; c < kHalfSlabs; ++c) wg::pin_regs(acc[c]);
  };
  // a stage goes back once both warpgroups are past its gradient product; an
  // exchange written over it is ordered before the next TMA write
  auto release = [&](int st) {
    if constexpr (C::kInStage) wg::fence_proxy_async();
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(empty_bar(st));
  };

  wg::mbar_wait(own_full, 0);
  // prologue: P or dS of chunk 0
  wg::mbar_wait(full_bar(0), 0);
  start_score(0);
  wg::wgmma_wait<0>();
  wg::pin_regs(mine);
  exchange(0);
  grad(0);
  wg::pack_p(s, a);

  for (int t = 0; t + 1 < n_tiles; ++t) {
    const int st = t % kSt;
    const int nx = (t + 1) % kSt;
    wg::mbar_wait(full_bar(nx), ((t + 1) / kSt) & 1);
    start_score(nx);
    start_grad(st);
    wg::wgmma_wait<1>();  // the score product of chunk t + 1 has landed
    wg::pin_regs(mine);
    exchange(t + 1);
    grad(nx);
    wg::wgmma_wait<0>();
    pin_acc();
    release(st);
    wg::pack_p(s, a);
    pin_acc();
    wg::pin_regs(a);
  }
  {
    const int last = (n_tiles - 1) % kSt;
    start_grad(last);
    wg::wgmma_wait<0>();
    pin_acc();
    release(last);
  }

  // epilogue: this warpgroup's 256 channels of the owned rows under own_len
  __nv_bfloat16* const out = SD == Side::kDQ ? pr.dq : SD == Side::kDK ? pr.dk : pr.dv;
  const int r_warp = r0 + warp * 16;
  __nv_bfloat16* const rows =
      out + (static_cast<size_t>(seg) * own_len + r_warp) * kD + wgrp * kHalfSlabs * kSlabCols;
#pragma unroll
  for (int c = 0; c < kHalfSlabs; ++c)
#pragma unroll
    for (int j = 0; j < kSlabCols / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (r_warp + g + 8 * i < own_len)
          *reinterpret_cast<__nv_bfloat162*>(rows + (g + 8 * i) * kD + c * kSlabCols + 8 * j +
                                             2 * tq) =
              __floats2bfloat162_rn(acc[c][4 * j + 2 * i], acc[c][4 * j + 2 * i + 1]);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <Side SD>
cudaError_t run_side(const BwdProblem& pr, void* stream) {
  using C = Cfg<SD>;
  const __nv_bfloat16* own[2];
  const __nv_bfloat16* str[3];
  if constexpr (SD == Side::kDQ) {
    own[0] = pr.qs, own[1] = pr.dout;
    str[0] = pr.k, str[1] = pr.v, str[2] = pr.k;
  } else if constexpr (SD == Side::kDK) {
    own[0] = pr.k, own[1] = pr.v;
    str[0] = pr.qs, str[1] = pr.dout, str[2] = pr.q;
  } else {
    own[0] = pr.k, own[1] = pr.k;
    str[0] = pr.qs, str[1] = pr.dout, str[2] = pr.qs;
  }
  const uint64_t segs = static_cast<uint64_t>(pr.B) * pr.H;
  const int own_len = C::kByRow ? pr.Sq : pr.Skv;
  const uint64_t own_rows = segs * own_len;
  const uint64_t str_rows = segs * (C::kByRow ? pr.Skv : pr.Sq);
  CUtensorMap maps[5];
  for (int i = 0; i < 2; ++i)
    if (!wg::encode_rows_map(&maps[i], own[i], own_rows, kRows, kD)) return cudaErrorNotSupported;
  for (int i = 0; i < 3; ++i)
    if (!wg::encode_rows_map(&maps[2 + i], str[i], str_rows, kChunk, kD))
      return cudaErrorNotSupported;
  auto kern = bwd_d512_kernel<SD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((own_len + kRows - 1) / kRows, pr.H, pr.B);
  kern<<<grid, kThreads, C::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], pr);
  return cudaGetLastError();
}

// What both entry points refuse: another tile than 64 owned rows and
// 16-row chunks (ops/flash_vjp.py: flash_bwd_tiles), Sq not a multiple of 64
// or Skv of 32, an lse pitch other than Sq, more than 65535 samples or heads,
// a missing array, and rows past the tensor maps' 2^31 row coordinates.
inline bool fits(const BwdProblem& pr, int rows, int chunk) {
  return rows == kRows && chunk == kChunk && pr.B > 0 && pr.H > 0 && pr.Sq > 0 && pr.Skv > 0 &&
         pr.Sq % kRows == 0 && pr.Skv % 32 == 0 && pr.lse_pitch == pr.Sq && pr.B <= 65535 &&
         pr.H <= 65535 && pr.q != nullptr && pr.qs != nullptr && pr.k != nullptr &&
         pr.v != nullptr && pr.dout != nullptr && pr.lse != nullptr && pr.delta != nullptr &&
         static_cast<uint64_t>(pr.B) * pr.H * (pr.Sq > pr.Skv ? pr.Sq : pr.Skv) + kRows <=
             0x7fffffffull;
}

inline cudaError_t launch_dq(const BwdProblem& pr, int rows, int chunk, void* stream) {
  if (!fits(pr, rows, chunk) || pr.dq == nullptr) return cudaErrorInvalidValue;
  return run_side<Side::kDQ>(pr, stream);
}

// dV, then dK: two launches of the tile on the caller's stream.
inline cudaError_t launch_dkv(const BwdProblem& pr, int rows, int chunk, void* stream) {
  if (!fits(pr, rows, chunk) || pr.dk == nullptr || pr.dv == nullptr)
    return cudaErrorInvalidValue;
  const cudaError_t err = run_side<Side::kDV>(pr, stream);
  if (err != cudaSuccess) return err;
  return run_side<Side::kDK>(pr, stream);
}

}  // namespace wgb512
}  // namespace irt
