// Attention tile of the plain flash kernels at head dim 512 (flash_bound.cu,
// flash_online.cu, flash_fwd_lse.cu: the VAE mid-block attention, one head,
// 4096 tokens), designed for Hopper on the PTX wrappers of attn_wgmma.cuh:
// wgmma.mma_async for both products, K and V tiles brought by TMA into rings
// of shared-memory stages behind mbarriers, the softmax on the register
// fragments.
// Plain C interface, no PyTorch headers: built with nvcc -gencode
// arch=compute_90a,code=sm_90a and loaded through ctypes (ops/_build.py).
//
// The function: out = softmax(q k^T * scale) v over the Skv keys of q's own
// (b, h), with q pre-scaled in bf16 by bf16(scale * log2 e), scores s in fp32
// log2 units, an fp32 accumulator and out = acc / l in bf16. Two softmax
// policies, a template parameter:
//   * Policy::kBound (flash_bound.cu; JAX: _flash_bound_kernel of
//     instantrestore_tpu/ops/shared_attention.py at d >= 128): no running
//     max but the Cauchy-Schwarz bound of each row, bound = ||q|| (the 512
//     unscaled channels, fp32) * scale * log2 e * kmax[b, h] - 64, p =
//     exp2(s - bound) rounded to bf16 (the result, not the argument), the
//     row sum over the rounded p (the JAX kernel's jnp.sum(p.astype(f32)) of
//     the bf16 p). A row whose largest score lies more than ~190 log2 units
//     under its bound sums to l = 0 and comes out non-finite.
//   * Policy::kOnline (flash_online.cu, flash_fwd_lse.cu; JAX: _flash_kernel
//     and _fwd_lse_kernel at d >= 128): a running max per row from the finite
//     -1e30, taken once per 32-key tile (the key chunk): m_new = max(m,
//     rowmax(s)), alpha = exp2(m - m_new), p = exp2(s - m_new) in fp32 (the
//     argument not rounded), l = alpha l + the sum of the fp32 p, acc = alpha
//     acc + bf16(p) v. With Problem::lse it also writes lse2 = m + log2(l),
//     fp32 [B, H, Sq]. No row can flush.
//
// What bounds it on the H100: tensor-core operations. A batch-16 launch is
// 4 * 16 * 4096^2 * 512 = 0.55 TFLOP (0.556 ms at 989 TFLOP/s) for 0.27 GB.
// What the card's limits force, and what the design does:
//   * A 64 x 512 fp32 accumulator is 256 registers a thread of one
//     warpgroup. Two consumer warpgroups share a block's 64 query rows, each
//     owning 256 of the output channels (64 x 256 fp32: 128 registers a
//     thread); setmaxnreg moves registers from the producer warpgroup (40 a
//     thread) to the consumers (232).
//   * Q (64 x 512 bf16, 64 KB) lives in shared memory as eight [64, 64]
//     slabs in the 128-byte swizzle, the A operand of S = Qs K^T by
//     descriptor (in registers it would take 128 more a thread). The
//     consumers write it themselves, pre-scaled, and (kBound) take the row
//     norms from the same loads.
//   * A TMA box in the 128-byte swizzle is 64 bf16 wide, so a [BK, 512] K or
//     V tile arrives as eight [BK, 64] slabs, one box each. At BK = 32 keys
//     a tile is 32 KB; K and V have rings of their own, two stages each
//     (128 KB), so that a K stage is handed back as soon as its product has
//     landed and reloaded a whole tile ahead of its use.
//   * Each consumer warpgroup needs every row's whole P. Each computes S
//     over its own 256 channels (16 k16 steps of m64n32k16 over its four
//     K-major slabs) and the two add their partial S through shared memory
//     (64 x 32 fp32 a warpgroup, double-buffered by tile parity, one named
//     barrier a tile); S0 + S1 and S1 + S0 are the same fp32 bits, so both
//     warpgroups reach the same running max, alpha and p without a second
//     exchange. Computing the whole S in each warpgroup instead (1.5x the
//     tensor work, no exchange) ran about 10% slower at batch 4, 16 and 64
//     on an H100 SXM (PERF.md).
//   * O += P V: P, packed pairwise to bf16, is the A fragment from registers;
//     each warpgroup's four MN-major V slabs are four m64n64k16 per 16 keys
//     (attn_wgmma.cuh's descriptors). kBound's row sums of the rounded P ride
//     the tensor cores as a product with a block of ones (m64n8k16); kOnline
//     sums its fp32 p in registers (each thread its share, the quad adds
//     them in the epilogue).
//   Within a warpgroup S(t + 1) and P(t) V(t) are started back to back, the
//   softmax of S(t + 1) runs under P(t) V(t), and P(t + 1) is packed after the
//   wait, as in attn_wgmma.cuh; kOnline rescales its O by alpha(t + 1) only
//   after that wait, before the next product starts (the first tile's alpha
//   is exp2(-1e30 - m) = 0 on a zero O). No wgmma batch sits on a runtime
//   branch.

#pragma once

#include "attn_wgmma.cuh"

namespace irt {
namespace wg512 {

using wg::Policy;
using wg::Problem;

constexpr int kD = 512;
constexpr int kSlabCols = 64;                  // channels of one 128-byte swizzle row
constexpr int kSlabs = kD / kSlabCols;         // 8
constexpr int kRows = 64;                      // query rows a block
constexpr int kConsumers = 2;                  // warpgroups, 256 output channels each
constexpr int kOwnSlabs = kSlabs / kConsumers;  // 4
constexpr int kBK = 32;                        // keys a tile
constexpr int kStages = 2;
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kQSlabBytes = kRows * 128;       // 8 KB
constexpr int kKVSlabBytes = kBK * 128;        // 4 KB
constexpr int kTileBytes = kSlabs * kKVSlabBytes;  // one K or V tile, 32 KB
constexpr int kKOff = kSlabs * kQSlabBytes;    // Q first: 64 KB
constexpr int kVOff = kKOff + kStages * kTileBytes;
constexpr int kXOff = kVOff + kStages * kTileBytes;  // the partial S
constexpr int kXBytes = 2 * kConsumers * kRows * kBK * 4;  // two tile parities
constexpr int kOnesOff = kXOff + kXBytes;
constexpr int kBoundOff = kOnesOff + wg::kOnesBytes;
// + room to align the first slab to 1024 bytes (the swizzle's period)
constexpr int kSmemBytes = kBoundOff + kRows * 4 + 1024;
static_assert(kSmemBytes + 256 <= 232448, "over the 227 KB a block may use");
constexpr int kEmptyCount = 4 * kConsumers;    // consumer warps on a ring
constexpr int kProducerRegs = 40;              // 128 * 40 + 256 * 232 <= 384 * 168
constexpr int kConsumerRegs = 232;
constexpr int kQReadyBar = 1;                  // named barriers of the consumers
constexpr int kExchangeBar = 2;

// d[64x32] (+)= a[64x16] b[16x32], A and B from shared memory, both K-major.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t adesc,
                                                   uint64_t bdesc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(adesc), "l"(bdesc), "n"(SCALE_D));
}

// One 32-key tile of kOnline's softmax on a thread's fragment of the
// exchanged S (rows g and g + 8, 8 scores each), in place: m_new = max(m,
// rowmax(s)) over the quad, alpha = exp2(m - m_new), s <- exp2(s - m_new) in
// fp32 (the d >= 128 rule: the argument is not rounded, unlike
// wg::online_softmax), and the thread's share of each row sum l <- alpha l +
// its fp32 p. m is updated in place; pack_p rounds p for the product only.
__device__ __forceinline__ void online_softmax_fp32(float (&s)[kBK / 2], float (&m)[2],
                                                    float (&alpha)[2], float (&l)[2]) {
  float m_new[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    m_new[0] = fmaxf(m_new[0], fmaxf(s[4 * j], s[4 * j + 1]));
    m_new[1] = fmaxf(m_new[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 1));
    m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 2));
    alpha[i] = wg::ex2(m[i] - m_new[i]);
    m[i] = m_new[i];
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s[4 * j + 2 * i] = wg::ex2(s[4 * j + 2 * i] - m_new[i]);
      s[4 * j + 2 * i + 1] = wg::ex2(s[4 * j + 2 * i + 1] - m_new[i]);
      l[i] += s[4 * j + 2 * i] + s[4 * j + 2 * i + 1];
    }
  }
}

// map_k/map_v: k, v as [B * H * Skv, 512] with a [kBK, 64] box. Grid
// (Sq / 64, H, B).
template <Policy P>
__global__ void __launch_bounds__(kThreads, 1)
flash_d512_kernel(const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const Problem pr) {
  static_assert(P == Policy::kBound || P == Policy::kOnline,
                "the bound and the online policy are built at d = 512");
  constexpr bool kOnes = P == Policy::kBound;  // row sums by the product with a block of ones
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[4 * kStages];

  const int H = pr.H, Sq = pr.Sq, S = pr.S;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kRows;
  const uint32_t raw_addr = wg::smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;  // Q slab 0, shared-window address
  unsigned char* const base_ptr = smem_raw + (base - raw_addr);
  float* const bound_s = reinterpret_cast<float*>(base_ptr + kBoundOff);
  const uint32_t bar0 = wg::smem_u32(bars);
  auto k_full = [&](int st) { return bar0 + 8u * st; };
  auto v_full = [&](int st) { return bar0 + 8u * (kStages + st); };
  auto k_empty = [&](int st) { return bar0 + 8u * (2 * kStages + st); };
  auto v_empty = [&](int st) { return bar0 + 8u * (3 * kStages + st); };
  auto k_tile = [&](int st) { return base + static_cast<uint32_t>(kKOff + st * kTileBytes); };
  auto v_tile = [&](int st) { return base + static_cast<uint32_t>(kVOff + st * kTileBytes); };

  if (kOnes && threadIdx.x < wg::kOnesBytes / 16) {
    const uint32_t one2 = 0x3F803F80u;  // two bf16 ones
    *reinterpret_cast<uint4*>(base_ptr + kOnesOff + threadIdx.x * 16) =
        make_uint4(one2, one2, one2, one2);
    wg::fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      wg::mbar_init(k_full(st), 1);
      wg::mbar_init(v_full(st), 1);
      wg::mbar_init(k_empty(st), kEmptyCount);
      wg::mbar_init(v_empty(st), kEmptyCount);
    }
    wg::fence_barrier_init();
  }
  __syncthreads();

  const int wgrp = threadIdx.x / 128;
  const int tw = threadIdx.x % 128;  // thread within its warpgroup
  const int warp = tw / 32;
  const int lane = tw % 32;
  const int n_tiles = S / kBK;
  const int kv_row0 = (b * H + h) * S;

  if (wgrp == kConsumers) {
    wg::reg_dec<kProducerRegs>();
    // ---- producers: lane 0 of warp 0 keeps the K ring full, of warp 1 the V ring ----
    if (warp < 2 && lane == 0) {
      const bool is_v = warp == 1;
      const CUtensorMap* map = is_v ? &map_v : &map_k;
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        const uint32_t parity = (t / kStages) & 1;
        const uint32_t full = is_v ? v_full(st) : k_full(st);
        wg::mbar_wait(is_v ? v_empty(st) : k_empty(st), parity ^ 1u);
        wg::mbar_expect_tx(full, kTileBytes);
        const uint32_t dst = is_v ? v_tile(st) : k_tile(st);
#pragma unroll
        for (int c = 0; c < kSlabs; ++c)
          wg::tma_load_2d(dst + c * kKVSlabBytes, map, c * kSlabCols, kv_row0 + t * kBK, full);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows, output channels 256 w .. 256 w + 255 ----
  wg::reg_inc<kConsumerRegs>();
  const int g = lane >> 2;  // row of the warp's 16 (and g + 8)
  const int tq = lane & 3;  // column pair within each group of 8
  const size_t q_base = (static_cast<size_t>(b * H + h) * Sq + q0) * kD;

  // Q -> shared memory, pre-scaled in bf16, into the 128-byte swizzle (16-byte
  // chunk j of row r of a slab at chunk j ^ (r % 8)); kBound: each row's bound
  // from the same unscaled values. Four threads a row, 16 chunks each.
  {
    const int ct = threadIdx.x;  // 0 .. 255
    const int r = ct >> 2;
    const int part = ct & 3;
    const __nv_bfloat16* src = pr.q + q_base + static_cast<size_t>(r) * kD;
    const float qs_bf = __bfloat162float(__float2bfloat16(pr.qscale));
    float ss = 0.f;
#pragma unroll 4
    for (int i = 0; i < kD / 8 / 4; ++i) {
      const int ch = i * 4 + part;  // 16-byte chunk of the row, 0 .. 63
      float f[8];
      wg::unpack8(*reinterpret_cast<const uint4*>(src + ch * 8), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        ss += f[e] * f[e];
        f[e] *= qs_bf;
      }
      const int slab = ch >> 3;
      const int j = ch & 7;
      *reinterpret_cast<uint4*>(base_ptr + slab * kQSlabBytes + r * 128 + ((j ^ (r & 7)) << 4)) =
          wg::pack8(f);
    }
    if constexpr (P == Policy::kBound) {
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      if (part == 0)
        bound_s[r] = sqrtf(ss) * pr.qscale * pr.kmax[b * H + h] - wg::kBoundExpShift;
    }
    wg::fence_proxy_async();  // the Q tile is read by wgmma (async proxy)
    asm volatile("bar.sync %0, 256;\n" ::"n"(kQReadyBar) : "memory");
  }
  float bnd[2] = {0.f, 0.f};
  if constexpr (P == Policy::kBound) {
    bnd[0] = bound_s[warp * 16 + g];
    bnd[1] = bound_s[warp * 16 + g + 8];
  }

  float o[kOwnSlabs][32];
#pragma unroll
  for (int c = 0; c < kOwnSlabs; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  // kBound: row sums of the rounded P, every column the same: [0], [1] row g,
  // [2], [3] row g + 8
  float l_acc[4] = {0.f, 0.f, 0.f, 0.f};
  float l_part[2] = {0.f, 0.f};  // kOnline: the thread's share of rows g and g + 8
  float m_run[2] = {wg::kNegInf, wg::kNegInf};  // kOnline: the running max of rows g, g + 8
  float alpha[2] = {0.f, 0.f};
  float s[kBK / 2];     // S = Qs K^T of one tile, first this warpgroup's part
  uint32_t p[kBK / 4];  // bf16 P of the tile whose P V is next
  const uint64_t ones = wg::ones_desc(base + kOnesOff);
  auto softmax = [&]() {
    if constexpr (P == Policy::kOnline)
      online_softmax_fp32(s, m_run, alpha, l_part);
    else
      wg::bound_softmax<false>(s, bnd, l_part);
  };

  // this warpgroup's part of S = Qs K^T of the tile in stage st, one wgmma
  // batch: k16 step ks reads 32 bytes at (ks % 4) * 32 of its Q slab and K
  // slab ks / 4
  constexpr int kSteps = kOwnSlabs * kSlabCols / 16;
  const uint32_t first_slab = wgrp * kOwnSlabs;
  const uint64_t q_desc = wg::smem_desc(base + first_slab * kQSlabBytes);
  auto start_qk = [&](int st) {
    const uint64_t k_desc = wg::smem_desc(k_tile(st) + first_slab * kKVSlabBytes);
    wg::wgmma_fence();
    wgmma_m64n32k16_ss<0>(s, q_desc, k_desc);
#pragma unroll
    for (int ks = 1; ks < kSteps; ++ks)
      wgmma_m64n32k16_ss<1>(s, q_desc + (((ks / 4) * kQSlabBytes + (ks % 4) * 32) >> 4),
                            k_desc + (((ks / 4) * kKVSlabBytes + (ks % 4) * 32) >> 4));
    wg::wgmma_commit();
  };
  // O += P V over this warpgroup's four V slabs, and (kBound) l += P 1
  auto start_pv = [&](int st) {
    const uint64_t v_desc = wg::smem_desc(v_tile(st) + wgrp * kOwnSlabs * kKVSlabBytes);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kOwnSlabs; ++c)
        wg::wgmma_m64n64k16<1, 1>(o[c], &p[4 * kk],
                                  v_desc + ((c * kKVSlabBytes + kk * 16 * 128) >> 4));
    if constexpr (kOnes) {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) wg::wgmma_m64n8k16(l_acc, &p[4 * kk], ones);
    }
    wg::wgmma_commit();
  };
  auto pin_acc = [&]() {
#pragma unroll
    for (int c = 0; c < kOwnSlabs; ++c) wg::pin_regs(o[c]);
    if constexpr (kOnes) wg::pin_regs(l_acc);
  };
  // the whole S of tile t in both warpgroups: this one's part plus the other's,
  // through shared memory (float4 i of thread tw at [parity][warpgroup][i][tw])
  auto exchange = [&](int t) {
    float4* x = reinterpret_cast<float4*>(base_ptr + kXOff) + (t & 1) * kConsumers * 4 * 128;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[(wgrp * 4 + i) * 128 + tw] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2],
                                                 s[4 * i + 3]);
    asm volatile("bar.sync %0, 256;\n" ::"n"(kExchangeBar) : "memory");
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 y = x[((1 - wgrp) * 4 + i) * 128 + tw];
      s[4 * i] += y.x;
      s[4 * i + 1] += y.y;
      s[4 * i + 2] += y.z;
      s[4 * i + 3] += y.w;
    }
  };
  auto release = [&](uint32_t bar) {
    if (lane == 0) wg::mbar_arrive(bar);
    __syncwarp();
  };

  // prologue: S and P of tile 0 (kOnline: alpha = exp2(-1e30 - m) = 0, O is zero)
  wg::mbar_wait(k_full(0), 0);
  start_qk(0);
  wg::wgmma_wait<0>();
  wg::pin_regs(s);
  release(k_empty(0));
  exchange(0);
  softmax();
  wg::pack_p(s, p);

  // Per tile t but the last: S(t + 1) and O += P(t) V(t) back to back; the K
  // stage goes back to the producer as soon as S(t + 1) has landed, the V
  // stage after P(t) V(t). kOnline rescales O by alpha(t + 1) after the wait
  // for P(t) V(t): the product still accumulates into O until then.
  for (int t = 0; t + 1 < n_tiles; ++t) {
    const int st = t % kStages;
    const int nx = (t + 1) % kStages;
    wg::mbar_wait(k_full(nx), ((t + 1) / kStages) & 1);
    wg::mbar_wait(v_full(st), (t / kStages) & 1);
    start_qk(nx);
    start_pv(st);
    wg::wgmma_wait<1>();  // S(t + 1) has landed; P(t) V(t) may still run
    wg::pin_regs(s);
    release(k_empty(nx));
    exchange(t + 1);
    softmax();
    wg::wgmma_wait<0>();
    pin_acc();
    release(v_empty(st));
    if constexpr (P == Policy::kOnline) {
#pragma unroll
      for (int c = 0; c < kOwnSlabs; ++c)
#pragma unroll
        for (int j = 0; j < kSlabCols / 8; ++j) {
          o[c][4 * j] *= alpha[0];
          o[c][4 * j + 1] *= alpha[0];
          o[c][4 * j + 2] *= alpha[1];
          o[c][4 * j + 3] *= alpha[1];
        }
    }
    wg::pack_p(s, p);
    pin_acc();
    wg::pin_regs(p);
  }
  {
    const int last = n_tiles - 1;
    wg::mbar_wait(v_full(last % kStages), (last / kStages) & 1);
    start_pv(last % kStages);
    wg::wgmma_wait<0>();
    pin_acc();
    release(v_empty(last % kStages));
  }

  // epilogue: out = O / l in bf16 from the registers, this warpgroup's
  // channels; kOnline's whole row sum from the quad's shares, in every lane
  float l_run[2] = {l_acc[0], l_acc[2]};
  if constexpr (P == Policy::kOnline) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_run[i] = l_part[i] + __shfl_xor_sync(0xffffffffu, l_part[i], 1);
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    }
  }
  __nv_bfloat16* const out_rows =
      pr.out + q_base + static_cast<size_t>(warp * 16) * kD + wgrp * kOwnSlabs * kSlabCols;
#pragma unroll
  for (int c = 0; c < kOwnSlabs; ++c)
#pragma unroll
    for (int j = 0; j < kSlabCols / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<__nv_bfloat162*>(out_rows + (g + 8 * i) * kD + c * kSlabCols + 8 * j +
                                           2 * tq) =
            __floats2bfloat162_rn(o[c][4 * j + 2 * i] / l_run[i],
                                  o[c][4 * j + 2 * i + 1] / l_run[i]);
  // lse2 = m + log2(l) of rows g and g + 8: both warpgroups hold the same
  // values; one lane of each quad of warpgroup 0 writes them
  if constexpr (P == Policy::kOnline) {
    if (pr.lse != nullptr && wgrp == 0 && tq == 0) {
      const size_t row0 = static_cast<size_t>(b * H + h) * Sq + q0 + warp * 16 + g;
#pragma unroll
      for (int i = 0; i < 2; ++i) pr.lse[row0 + 8 * i] = m_run[i] + log2f(l_run[i]);
    }
  }
}

// q, out [B, H, Sq, 512] against the Skv = pr.S keys of k_in/v_in [B, H, Skv,
// 512]; kBound: kmax [B, H] fp32; kOnline: lse [B, H, Sq] fp32 or null. The
// key chunk is the tile's, bk = 32 (ops/shared_attention.py,
// flash_bound_chunk and flash_online_chunk). Refuses Sq not a multiple of 64,
// Skv not a multiple of 32, another chunk, more than 65535 samples or heads,
// kBound without kmax, and key rows past the tensor maps' 2^31 row
// coordinates.
template <Policy P>
cudaError_t launch_flash_d512(const Problem& pr, int bk, void* stream) {
  if (pr.B <= 0 || pr.H <= 0 || pr.Sq <= 0 || pr.S <= 0 || pr.Sq % kRows != 0 || bk != kBK ||
      pr.S % kBK != 0 || pr.B > 65535 || pr.H > 65535 || pr.q == nullptr ||
      pr.k_in == nullptr || pr.v_in == nullptr || pr.out == nullptr ||
      (P == Policy::kBound && pr.kmax == nullptr) ||
      static_cast<uint64_t>(pr.B) * pr.H * pr.S > 0x7fffffffull)
    return cudaErrorInvalidValue;
  const uint64_t rows = static_cast<uint64_t>(pr.B) * pr.H * pr.S;
  CUtensorMap map_k, map_v;
  if (!wg::encode_rows_map(&map_k, pr.k_in, rows, kBK, kD) ||
      !wg::encode_rows_map(&map_v, pr.v_in, rows, kBK, kD))
    return cudaErrorNotSupported;
  auto kern = flash_d512_kernel<P>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(pr.Sq / kRows, pr.H, pr.B);
  kern<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(map_k, map_v, pr);
  return cudaGetLastError();
}

}  // namespace wg512
}  // namespace irt
