// Backward tile of the differentiable attention at head dim 64
// (flash_bwd_dq.cu, flash_bwd_dkv.cu), designed for Hopper on the PTX
// wrappers of attn_wgmma.cuh: wgmma.mma_async for every product with every
// score, probability and accumulator in registers, the streamed tiles brought
// by TMA into a ring of shared-memory stages behind mbarriers. d = 512 runs
// on attn_wgmma_bwd_d512.cuh.
// Plain C interface, no PyTorch headers: built with nvcc -gencode
// arch=compute_90a,code=sm_90a and loaded through ctypes (ops/_build.py).
//
// The function (JAX: _bwd_dq_kernel and _bwd_dkv_kernel of
// instantrestore_tpu/ops/flash_vjp.py), with qs = bf16(q * bf16(scale *
// log2 e)), the forward's scaled q, given by the caller:
//     s2 = qs k^T (fp32, log2 units),   P = exp2(s2 - lse2)   (fp32, the
//     argument is not rounded),   dP = dO v^T (fp32),
//     dS = bf16(P * (dP - delta) * scale),
//     dQ = sum_j dS_j k_j,   dV = sum_i bf16(P_i)^T dO_i,   dK = sum_i dS_i^T q_i
// (the unscaled q), fp32 accumulators, bf16 outputs. Two kernels and no
// atomics: each output element is summed by one consumer warpgroup in a fixed
// order, so two launches give the same bits.
//
// Roles in a block of (NCONS + 1) * 128 threads, NCONS = 1 or 2:
//   * consumer warpgroups 0 .. NCONS-1, 64 rows each (query rows for dQ,
//     key rows for dK/dV). The warpgroup's own operands live in registers as
//     the A fragments of its two score products (16 registers a thread each),
//     and both products take B from the streamed tile in shared memory,
//     K-major (the 64 channels contiguous, 128-byte swizzle). The accumulator
//     of a [64, 64] product, packed pairwise to bf16 (pack_p), is already the
//     A fragment of the next product over the same 64 columns, so P and dS go
//     from the score products' accumulators to the gradient products'
//     operands without leaving the thread. A gradient product reads its B,
//     the tile whose rows are the summed index, MN-major: the descriptor's
//     transpose bit over the same swizzled tile (dQ: the K tile that S read
//     K-major; dV and dK: the dO tile that dP read K-major, and the q tile).
//   * producer warp (warp 0 of the last warpgroup): one lane keeps TMA loads
//     of the streamed [64, 64] tiles in flight, kStages deep, each stage
//     announced on its `full` mbarrier by the copy's byte count; consumers
//     hand a stage back on `empty`. With two consumer warpgroups setmaxnreg
//     moves registers from the producer warpgroup (40 a thread) to the
//     consumers (232).
// Within a warpgroup the tiles are pipelined as in attn_wgmma.cuh: the score
// products of tile t + 1 and the gradient products of tile t are started back
// to back, P and dS of tile t + 1 are formed in fp32, in place, while the
// tensor cores still read tile t's packed operands, and only after that wait
// are they packed. The two consumer warpgroups of a block start their batches
// in turns (named barriers 1 and 2), so that one's elementwise pass runs while
// the other's products queue. No batch sits on a runtime branch.
//
// dQ (row 5): a warpgroup owns 64 query rows (qs and dO as A fragments, lse2
// and delta of its rows g, g + 8 in registers) and streams K and V tiles of
// 64 keys: S = qs K^T and dP = dO V^T, then dQ += dS K.
// dK, dV (row 6): a warpgroup owns 64 keys (K and V as A fragments) and
// streams tiles of 64 queries: qs, q, dO, and their lse2 and delta (a
// 256-byte bulk copy each, on the same `full` barrier). S^T = K qs^T and
// dP^T = V dO^T, P^T = exp2(S^T - lse2) and dS^T with lse2 and delta per
// column: a thread holds columns 8 j + 2 t and 8 j + 2 t + 1 and reads their
// pairs from the stage as float2. Then dV += bf16(P^T) dO and dK += dS^T q.
//
// Any Sq and Skv (the shapes JAX's kernels take). The streamed tiles come
// through segment maps (one segment a (b, h)), so rows past the side's end
// arrive as zeros: in dK/dV a padded query column has qs = q = dO = 0 and,
// from the caller's zero-padded lse2 and delta (row pitch lse_pitch, a
// multiple of 64), P^T = 1 and dS^T = 0, which add exact zeros to dV and dK.
// In dQ the keys past Skv (RAGGED) have their scores masked to -inf, so P =
// 0 and dS = 0 whatever lse2 is. Owned rows past the side's end are read as
// zeros and never written.

#pragma once

#include "attn_wgmma.cuh"

namespace irt {
namespace wgb {

using wg::kD;
using wg::kRowBytes;

constexpr int kChunk = 64;                      // streamed rows a stage
constexpr int kTileBytes = kChunk * kRowBytes;  // one [64, 64] bf16 tile, 8 KB
constexpr int kStages = 4;
constexpr int kProducerRegs = 40;  // 128 * 40 + 256 * 232 <= 65536
constexpr int kConsumerRegs = 232;

// q, qs, dout, dq [B, H, Sq, 64]; k, v, dk, dv [B, H, Skv, 64]; lse, delta
// [B, H, lse_pitch] fp32, lse_pitch = Sq or, where 64 does not divide Sq, Sq
// rounded up to 64 with zeros past Sq.
struct BwdProblem {
  const __nv_bfloat16 *q, *qs, *k, *v, *dout;
  const float *lse, *delta;
  __nv_bfloat16 *dq, *dk, *dv;
  int B, H, Sq, Skv;
  float scale;
  int lse_pitch;
};

// One contiguous run of global memory (16-byte aligned, a multiple of 16
// bytes) into shared memory; completion counted in bytes on the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A warp's 16 rows of a [*, 64] bf16 array as the A fragments of a product
// over the 64 channels: per k16 slice (row g, cols 2t..), (row g + 8, cols
// 2t..), (row g, cols 2t + 8..), (row g + 8, ..). Rows at or past n_rows are
// zeros.
__device__ __forceinline__ void load_a(uint32_t (&a)[kD / 16][4], const __nv_bfloat16* rows,
                                       int g, int tq, int n_rows) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = g + (i & 1) * 8;
      a[kk][i] = r < n_rows ? *reinterpret_cast<const uint32_t*>(rows + r * kD + kk * 16 +
                                                                 tq * 2 + (i >> 1) * 8)
                            : 0u;
    }
}

// d = a b^T over the 64 channels: b the [64, 64] tile at desc, K-major.
__device__ __forceinline__ void product_k_major(float (&d)[32], const uint32_t (&a)[kD / 16][4],
                                                uint64_t desc) {
  wg::wgmma_m64n64k16<0, 0>(d, a[0], desc);
#pragma unroll
  for (int kk = 1; kk < kD / 16; ++kk)
    wg::wgmma_m64n64k16<0, 1>(d, a[kk], desc + static_cast<uint64_t>(kk * 32 >> 4));
}

// d += a b over the tile's 64 rows: a the packed [64, 64] operand, b the
// tile at desc read MN-major (its rows are the summed index).
__device__ __forceinline__ void product_mn_major(float (&d)[32], const uint32_t (&a)[16],
                                                 uint64_t desc) {
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk)
    wg::wgmma_m64n64k16<1, 1>(d, &a[4 * kk],
                              desc + static_cast<uint64_t>(kk * 16 * kRowBytes >> 4));
}

// acc -> bf16 rows g and g + 8 of the warp's 16 at dst (row stride 64), those
// under n_rows.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[32], int g,
                                           int tq, int n_rows) {
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (g + 8 * i < n_rows)
        *reinterpret_cast<__nv_bfloat162*>(dst + (g + 8 * i) * kD + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
}

// The two consumer warpgroups start their wgmma batches in turns: warpgroup w
// waits on named barrier 1 + w and passes the turn on the other's.
template <int NCONS>
struct Turns {
  int wgrp;
  __device__ __forceinline__ void wait() const {
    if constexpr (NCONS == 2) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wgrp) : "memory");
  }
  __device__ __forceinline__ void pass() const {
    if constexpr (NCONS == 2) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wgrp) : "memory");
  }
};

// ---------------------------------------------------------------------------
// dQ: a consumer warpgroup owns 64 query rows and streams K/V tiles
// ---------------------------------------------------------------------------

// map_k, map_v: k, v as B * H segments of [Skv, 64] with a [64, 64] box. Grid
// (ceil(Sq / (64 NCONS)), H, B).
template <int NCONS, bool RAGGED>
__global__ void __launch_bounds__((NCONS + 1) * 128, 1)
bwd_dq_kernel(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
              const BwdProblem pr) {
  constexpr int kStageBytes = 2 * kTileBytes;  // K, V
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];

  const int H = pr.H, h = blockIdx.y, b = blockIdx.z;
  const uint32_t raw_addr = wg::smem_u32(smem_raw);
  const uint32_t tiles = (raw_addr + 1023u) & ~1023u;  // the swizzle's 1024-byte period
  const uint32_t bar0 = wg::smem_u32(bars);
  auto full_bar = [&](int st) { return bar0 + 8u * st; };
  auto empty_bar = [&](int st) { return bar0 + 8u * (kStages + st); };
  auto k_tile = [&](int st) { return tiles + static_cast<uint32_t>(st * kStageBytes); };

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      wg::mbar_init(full_bar(st), 1);
      wg::mbar_init(empty_bar(st), 4 * NCONS);
    }
    wg::fence_barrier_init();
  }
  __syncthreads();

  const int wgrp = threadIdx.x / 128;
  const int tw = threadIdx.x % 128;
  const int warp = tw / 32;
  const int lane = tw % 32;
  const int n_tiles = (pr.Skv + kChunk - 1) / kChunk;

  if (wgrp == NCONS) {
    if constexpr (NCONS == 2) wg::reg_dec<kProducerRegs>();
    // ---- producer: K and V tiles, kStages ahead of the consumers ----
    if (warp == 0 && lane == 0) {
      const int seg = b * H + h;
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        wg::mbar_wait(empty_bar(st), ((t / kStages) & 1) ^ 1u);
        wg::mbar_expect_tx(full_bar(st), kStageBytes);
        wg::tma_load_3d(k_tile(st), &map_k, t * kChunk, seg, full_bar(st));
        wg::tma_load_3d(k_tile(st) + kTileBytes, &map_v, t * kChunk, seg, full_bar(st));
      }
    }
    return;
  }

  // ---- consumer warpgroup: 64 query rows ----
  if constexpr (NCONS == 2) wg::reg_inc<kConsumerRegs>();
  const int g = lane >> 2;  // row of the warp's 16 (and g + 8)
  const int tq = lane & 3;  // column pair within each group of 8
  const int r_warp = (blockIdx.x * NCONS + wgrp) * 64 + warp * 16;  // the warp's first query
  const int n_rows = pr.Sq - r_warp;  // of the warp's 16 rows, those under n_rows exist
  const size_t row0 = static_cast<size_t>(b * H + h) * pr.Sq + r_warp;
  const size_t vec0 = static_cast<size_t>(b * H + h) * pr.lse_pitch + r_warp;
  uint32_t qa[kD / 16][4], ga[kD / 16][4];  // qs and dO as A fragments
  load_a(qa, pr.qs + row0 * kD, g, tq, n_rows);
  load_a(ga, pr.dout + row0 * kD, g, tq, n_rows);
  float lse[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse[i] = g + 8 * i < n_rows ? pr.lse[vec0 + g + 8 * i] : 0.f;
    dlt[i] = g + 8 * i < n_rows ? pr.delta[vec0 + g + 8 * i] : 0.f;
  }
  const float scale = pr.scale;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float s[32], dp[32];  // S and dP of one tile; then dS in s, fp32
  uint32_t ds[16];      // bf16 dS of the tile whose dS K is next

  // each a wgmma batch of its own, the descriptors made before the fence
  auto start_scores = [&](int st) {
    const uint64_t k_desc = wg::smem_desc(k_tile(st));
    const uint64_t v_desc = wg::smem_desc(k_tile(st) + kTileBytes);
    wg::wgmma_fence();
    product_k_major(s, qa, k_desc);
    product_k_major(dp, ga, v_desc);
    wg::wgmma_commit();
  };
  auto start_dq = [&](int st) {
    const uint64_t k_desc = wg::smem_desc(k_tile(st));
    wg::wgmma_fence();
    product_mn_major(acc, ds, k_desc);
    wg::wgmma_commit();
  };
  // s <- P * (dP - delta) * scale with P = exp2(s - lse2), rows g and g + 8;
  // RAGGED: the keys of tile t past Skv first out (P = 0)
  auto grad_scores = [&](int t) {
    if constexpr (RAGGED) wg::mask_keys(s, pr.Skv - t * kChunk, tq);
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        s[4 * j + e] = wg::ex2(s[4 * j + e] - lse[i]) * (dp[4 * j + e] - dlt[i]) * scale;
      }
  };
  const Turns<NCONS> turns{wgrp};
  if (wgrp == 1) turns.pass();  // warpgroup 0 goes first
  auto release = [&](int st) {
    if (lane == 0) wg::mbar_arrive(empty_bar(st));
    __syncwarp();
  };

  // prologue: dS of tile 0
  wg::mbar_wait(full_bar(0), 0);
  turns.wait();
  start_scores(0);
  turns.pass();
  wg::wgmma_wait<0>();
  wg::pin_regs(s);
  wg::pin_regs(dp);
  grad_scores(0);
  wg::pack_p(s, ds);

  for (int t = 0; t + 1 < n_tiles; ++t) {
    const int st = t % kStages;
    const int nx = (t + 1) % kStages;
    wg::mbar_wait(full_bar(nx), ((t + 1) / kStages) & 1);
    turns.wait();
    start_scores(nx);
    start_dq(st);
    turns.pass();
    wg::wgmma_wait<1>();  // S and dP of tile t + 1 have landed; dS(t) K(t) may still run
    wg::pin_regs(s);
    wg::pin_regs(dp);
    grad_scores(t + 1);
    wg::wgmma_wait<0>();
    wg::pin_regs(acc);
    release(st);
    wg::pack_p(s, ds);
    wg::pin_regs(acc);
    wg::pin_regs(ds);
  }
  {
    const int last = (n_tiles - 1) % kStages;
    turns.wait();
    start_dq(last);
    turns.pass();
    wg::wgmma_wait<0>();
    wg::pin_regs(acc);
    release(last);
  }
  store_rows(pr.dq + row0 * kD, acc, g, tq, n_rows);
}

// ---------------------------------------------------------------------------
// dK, dV: a consumer warpgroup owns 64 keys and streams query tiles
// ---------------------------------------------------------------------------

// map_qs, map_q, map_do: qs, q, dout as B * H segments of [Sq, 64] with a
// [64, 64] box. Grid (ceil(Skv / (64 NCONS)), H, B).
template <int NCONS>
__global__ void __launch_bounds__((NCONS + 1) * 128, 1)
bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_qs,
               const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_do, const BwdProblem pr) {
  // a stage: qs, q and dO tiles, then lse2 and delta of the tile's 64 queries
  constexpr int kVecOff = 3 * kTileBytes;
  constexpr int kVecBytes = kChunk * 4;
  constexpr int kStageBytes = kVecOff + 1024;  // stages 1024-byte aligned
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];

  const int H = pr.H, h = blockIdx.y, b = blockIdx.z;
  const uint32_t raw_addr = wg::smem_u32(smem_raw);
  const uint32_t tiles = (raw_addr + 1023u) & ~1023u;
  unsigned char* const tiles_ptr = smem_raw + (tiles - raw_addr);
  const uint32_t bar0 = wg::smem_u32(bars);
  auto full_bar = [&](int st) { return bar0 + 8u * st; };
  auto empty_bar = [&](int st) { return bar0 + 8u * (kStages + st); };
  auto qs_tile = [&](int st) { return tiles + static_cast<uint32_t>(st * kStageBytes); };

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      wg::mbar_init(full_bar(st), 1);
      wg::mbar_init(empty_bar(st), 4 * NCONS);
    }
    wg::fence_barrier_init();
  }
  __syncthreads();

  const int wgrp = threadIdx.x / 128;
  const int tw = threadIdx.x % 128;
  const int warp = tw / 32;
  const int lane = tw % 32;
  const int n_tiles = (pr.Sq + kChunk - 1) / kChunk;

  if (wgrp == NCONS) {
    if constexpr (NCONS == 2) wg::reg_dec<kProducerRegs>();
    // ---- producer: qs, q, dO tiles and their lse2, delta, kStages ahead ----
    if (warp == 0 && lane == 0) {
      const int seg = b * H + h;
      const size_t vec0 = static_cast<size_t>(seg) * pr.lse_pitch;
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        const int row = t * kChunk;
        const uint32_t dst = qs_tile(st);
        wg::mbar_wait(empty_bar(st), ((t / kStages) & 1) ^ 1u);
        wg::mbar_expect_tx(full_bar(st), 3 * kTileBytes + 2 * kVecBytes);
        wg::tma_load_3d(dst, &map_qs, row, seg, full_bar(st));
        wg::tma_load_3d(dst + kTileBytes, &map_q, row, seg, full_bar(st));
        wg::tma_load_3d(dst + 2 * kTileBytes, &map_do, row, seg, full_bar(st));
        bulk_load(dst + kVecOff, pr.lse + vec0 + row, kVecBytes, full_bar(st));
        bulk_load(dst + kVecOff + kVecBytes, pr.delta + vec0 + row, kVecBytes, full_bar(st));
      }
    }
    return;
  }

  // ---- consumer warpgroup: 64 keys ----
  if constexpr (NCONS == 2) wg::reg_inc<kConsumerRegs>();
  const int g = lane >> 2;  // key row of the warp's 16 (and g + 8)
  const int tq = lane & 3;  // query column pair within each group of 8
  const int k_warp = (blockIdx.x * NCONS + wgrp) * 64 + warp * 16;  // the warp's first key
  const int n_keys = pr.Skv - k_warp;
  const size_t key0 = static_cast<size_t>(b * H + h) * pr.Skv + k_warp;
  uint32_t ka[kD / 16][4], va[kD / 16][4];  // K and V as A fragments
  load_a(ka, pr.k + key0 * kD, g, tq, n_keys);
  load_a(va, pr.v + key0 * kD, g, tq, n_keys);
  const float scale = pr.scale;

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  float s[32], dp[32];   // S^T and dP^T of one tile; then P^T in s and dS^T in dp, fp32
  uint32_t p[16], ds[16];  // bf16 P^T and dS^T of the tile whose products are next

  // each a wgmma batch of its own, the descriptors made before the fence;
  // the dO tile is read K-major by dP^T and MN-major by dV
  auto start_scores = [&](int st) {
    const uint64_t qs_desc = wg::smem_desc(qs_tile(st));
    const uint64_t do_desc = wg::smem_desc(qs_tile(st) + 2 * kTileBytes);
    wg::wgmma_fence();
    product_k_major(s, ka, qs_desc);
    product_k_major(dp, va, do_desc);
    wg::wgmma_commit();
  };
  auto start_grads = [&](int st) {
    const uint64_t q_desc = wg::smem_desc(qs_tile(st) + kTileBytes);
    const uint64_t do_desc = wg::smem_desc(qs_tile(st) + 2 * kTileBytes);
    wg::wgmma_fence();
    product_mn_major(dv, p, do_desc);
    product_mn_major(dk, ds, q_desc);
    wg::wgmma_commit();
  };
  // P^T = exp2(S^T - lse2) into s, dS^T = P^T * (dP^T - delta) * scale into
  // dp; lse2 and delta by query column, from stage st
  auto grad_scores = [&](int st) {
    const float* vec = reinterpret_cast<const float*>(tiles_ptr + st * kStageBytes + kVecOff);
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(vec + 8 * j + 2 * tq);
      const float2 d2 = *reinterpret_cast<const float2*>(vec + kChunk + 8 * j + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * j + e;
        const float pt = wg::ex2(s[c] - ((e & 1) ? l2.y : l2.x));
        s[c] = pt;
        dp[c] = pt * (dp[c] - ((e & 1) ? d2.y : d2.x)) * scale;
      }
    }
  };
  const Turns<NCONS> turns{wgrp};
  if (wgrp == 1) turns.pass();  // warpgroup 0 goes first
  auto release = [&](int st) {
    if (lane == 0) wg::mbar_arrive(empty_bar(st));
    __syncwarp();
  };

  // prologue: P^T and dS^T of tile 0
  wg::mbar_wait(full_bar(0), 0);
  turns.wait();
  start_scores(0);
  turns.pass();
  wg::wgmma_wait<0>();
  wg::pin_regs(s);
  wg::pin_regs(dp);
  grad_scores(0);
  wg::pack_p(s, p);
  wg::pack_p(dp, ds);

  for (int t = 0; t + 1 < n_tiles; ++t) {
    const int st = t % kStages;
    const int nx = (t + 1) % kStages;
    wg::mbar_wait(full_bar(nx), ((t + 1) / kStages) & 1);
    turns.wait();
    start_scores(nx);
    start_grads(st);
    turns.pass();
    wg::wgmma_wait<1>();  // S^T and dP^T of tile t + 1 have landed; tile t's products may run
    wg::pin_regs(s);
    wg::pin_regs(dp);
    grad_scores(nx);
    wg::wgmma_wait<0>();
    wg::pin_regs(dk);
    wg::pin_regs(dv);
    release(st);
    wg::pack_p(s, p);
    wg::pack_p(dp, ds);
    wg::pin_regs(dk);
    wg::pin_regs(dv);
    wg::pin_regs(p);
    wg::pin_regs(ds);
  }
  {
    const int last = (n_tiles - 1) % kStages;
    turns.wait();
    start_grads(last);
    turns.pass();
    wg::wgmma_wait<0>();
    wg::pin_regs(dk);
    wg::pin_regs(dv);
    release(last);
  }
  store_rows(pr.dk + key0 * kD, dk, g, tq, n_keys);
  store_rows(pr.dv + key0 * kD, dv, g, tq, n_keys);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Opts the kernel into its dynamic shared memory; the grid is (ceil(rows / (64
// NCONS)), H, B) over the `rows` of the side a block owns.
template <int NCONS, typename Kernel>
cudaError_t prepare(Kernel kern, int smem_bytes, int rows, const BwdProblem& pr, dim3* grid) {
  *grid = dim3((rows + 64 * NCONS - 1) / (64 * NCONS), pr.H, pr.B);
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

template <int NCONS, bool RAGGED>
cudaError_t run_dq(const CUtensorMap (&maps)[2], const BwdProblem& pr, void* stream) {
  constexpr int kSmem = kStages * 2 * kTileBytes + 1024;
  dim3 grid;
  cudaError_t err = prepare<NCONS>(bwd_dq_kernel<NCONS, RAGGED>, kSmem, pr.Sq, pr, &grid);
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<NCONS, RAGGED>
      <<<grid, (NCONS + 1) * 128, kSmem, static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1],
                                                                              pr);
  return cudaGetLastError();
}

template <int NCONS>
cudaError_t run_dkv(const CUtensorMap (&maps)[3], const BwdProblem& pr, void* stream) {
  constexpr int kSmem = kStages * (3 * kTileBytes + 1024) + 1024;
  dim3 grid;
  cudaError_t err = prepare<NCONS>(bwd_dkv_kernel<NCONS>, kSmem, pr.Skv, pr, &grid);
  if (err != cudaSuccess) return err;
  bwd_dkv_kernel<NCONS><<<grid, (NCONS + 1) * 128, kSmem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], pr);
  return cudaGetLastError();
}

// What both kernels refuse: another chunk than 64, a block of other than 64
// or 128 rows or one of 128 that does not divide its side, an lse pitch that
// is not Sq rounded up to 64, more than 65535 samples or heads, a missing
// array, and rows past 2^31 (ops/flash_vjp.py: flash_bwd_tiles gives rows
// and chunk). Any Sq and Skv.
inline bool bwd_fits(const BwdProblem& pr, int side, int rows, int chunk) {
  const int pitch = pr.Sq % kChunk == 0 ? pr.Sq : (pr.Sq / kChunk + 1) * kChunk;
  return pr.B > 0 && pr.H > 0 && pr.Sq > 0 && pr.Skv > 0 && pr.lse_pitch == pitch &&
         chunk == kChunk && (rows == 64 || (rows == 128 && side % rows == 0)) &&
         pr.B <= 65535 && pr.H <= 65535 && pr.q != nullptr &&
         pr.qs != nullptr && pr.k != nullptr && pr.v != nullptr && pr.dout != nullptr &&
         pr.lse != nullptr && pr.delta != nullptr &&
         static_cast<uint64_t>(pr.B) * pr.H * (pr.Sq > pr.Skv ? pr.Sq : pr.Skv) <= 0x7fffffffull;
}

// dQ: a block of `rows` query rows (64 or 128: one or two consumer
// warpgroups) streaming key chunks of `chunk` = 64.
inline cudaError_t launch_dq(const BwdProblem& pr, int rows, int chunk, void* stream) {
  if (!bwd_fits(pr, pr.Sq, rows, chunk) || pr.dq == nullptr) return cudaErrorInvalidValue;
  const uint64_t segs = static_cast<uint64_t>(pr.B) * pr.H;
  CUtensorMap maps[2];
  if (!wg::encode_seg_map(&maps[0], pr.k, segs, pr.Skv, kChunk) ||
      !wg::encode_seg_map(&maps[1], pr.v, segs, pr.Skv, kChunk))
    return cudaErrorNotSupported;
  if (pr.Skv % kChunk != 0) return run_dq<1, true>(maps, pr, stream);
  return rows == 128 ? run_dq<2, false>(maps, pr, stream) : run_dq<1, false>(maps, pr, stream);
}

// dK, dV: a block of `rows` keys (64 or 128) streaming query chunks of
// `chunk` = 64.
inline cudaError_t launch_dkv(const BwdProblem& pr, int rows, int chunk, void* stream) {
  if (!bwd_fits(pr, pr.Skv, rows, chunk) || pr.dk == nullptr || pr.dv == nullptr)
    return cudaErrorInvalidValue;
  const uint64_t segs = static_cast<uint64_t>(pr.B) * pr.H;
  CUtensorMap maps[3];
  if (!wg::encode_seg_map(&maps[0], pr.qs, segs, pr.Sq, kChunk) ||
      !wg::encode_seg_map(&maps[1], pr.q, segs, pr.Sq, kChunk) ||
      !wg::encode_seg_map(&maps[2], pr.dout, segs, pr.Sq, kChunk))
    return cudaErrorNotSupported;
  return rows == 128 ? run_dkv<2>(maps, pr, stream) : run_dkv<1>(maps, pr, stream);
}

}  // namespace wgb
}  // namespace irt
