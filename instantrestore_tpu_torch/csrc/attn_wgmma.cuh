// Attention tile of the shared kernels (shared_online.cu,
// shared_online_pair.cu, shared_flash_bound.cu, shared_identity.cu) and of
// the plain kernels at d = 64 (flash_bound.cu, flash_online.cu,
// flash_fwd_lse.cu) at head dim 64, designed for Hopper: wgmma.mma_async for
// both products with every accumulator in registers, K and V tiles brought by
// TMA (cp.async.bulk.tensor) into a ring of shared-memory stages behind
// mbarriers, the softmax on the register fragments. The plain kernels at
// d = 512 (flash_bound.cu, flash_online.cu, flash_fwd_lse.cu) run on
// attn_wgmma_d512.cuh, built from this file's PTX wrappers.
// Plain C interface, no PyTorch headers: built with nvcc -gencode
// arch=compute_90a,code=sm_90a and loaded through ctypes (ops/_build.py).
//
// Two layouts of the keys (a template parameter, so that neither costs the
// other anything):
//   * Layout::kShared: segments [input |] reference 1 .. N, as below.
//   * Layout::kPlain (launch_flash): plain attention over the Skv keys of
//     q's own (b, h), the input segment alone (n_in = 1, N = 0, S = Skv, two
//     tensor maps). The affine warps leave at once and the second product
//     waits for nothing but the `full` its first product already waited for.
//     kOnline (flash_online.cu) and kBound with kmax [B, H] (flash_bound.cu,
//     JAX _flash_bound_kernel). With Problem::lse kOnline also writes lse2 =
//     m + log2(l) per row, fp32 [B, H, Sq] (the training forward, JAX
//     _fwd_lse_kernel).
//
// The function (JAX: the shared-attention kernels of
// instantrestore_tpu/ops/shared_attention.py):
//     out = softmax(q [K_in | K_1 .. K_N]^T * scale) [V_in | V_1 a_1 + c_1 ..]
// q is pre-scaled in bf16 by bf16(scale * log2 e). Segments in the order
// input, reference 1 .. N; chunks of BK keys never straddle a segment. The
// input segment takes raw v_in. Three softmax policies, one per family of
// TPU kernels:
//   * kOnline (_shared_kvouter_kernel, _shared_kernel,
//     _shared_kvouter_packed_kernel): a running row max. m starts at the
//     finite -1e30; per key chunk m_new = max(m, rowmax(s)), alpha = exp2(m -
//     m_new), p = exp2(bf16(s - m_new)) rounded to bf16, the row sum adds the
//     rounded p, the fp32 accumulator and the row sum take alpha. Reference V
//     takes bf16(v * bf16(a) + bf16(c)), rounded once from fp32.
//   * kBound (_shared_kvouter_bound_kernel): no running max but the
//     Cauchy-Schwarz bound of each row, bound = ||q|| (unscaled, fp32) *
//     scale * log2 e * kmax[b, h] - 64, kmax the largest key norm the row
//     sees; p = exp2(s - bound) rounded to bf16 (the result, not the
//     argument), the row sum over the rounded p; kOnline's affine. K/V rows
//     of sample b, or of ids[b] in an identity cache.
//   * kIdentity (_shared_kvouter_bound_paired_kernel): refs only, K/V of
//     ids[b]; bound = ||q_scaled|| (the bf16 pre-scaled q) * kmax[ids[b], h]
//     - 64; the row sum over the fp32 p; the affine bf16(v * a + c) with a and
//     c in fp32.
// out = acc / l in bf16. A bound row whose largest score lies more than ~190
// log2 units under its bound sums to l = 0 and comes out non-finite; an id
// outside [0, I) makes its sample's outputs NaN.
//
// Roles in a block of (NCONS + 1) * 128 threads:
//   * consumer warpgroups 0 .. NCONS-1, 64 query rows each. Q lives in
//     registers as the A fragments of the first product (16 registers a
//     thread), S = Qs K^T is one m64n<BK>k16 wgmma per 16 channels with the K
//     tile (K-major, 128-byte swizzle) as B from shared memory. The thread
//     that holds accumulator element i holds row lane/4 (i % 4 < 2) or
//     lane/4 + 8 of its warp's 16 rows, and the four lanes of a quad share a
//     row: the row max is two shuffles over the quad, alpha multiplies the
//     thread's own accumulator registers, and the bf16 P, packed pairwise, is
//     already the A fragment of O += P V (B = the V tile, MN-major: the
//     descriptor's transpose bit, not a transposed copy). The row sums of the
//     rounded P ride the tensor cores as the TPU kernels' ride the MXU: one
//     more product of the same P with a block of ones (m64n8k16), which
//     leaves the whole row's sum in every lane and takes the packing, the
//     unpacking and the adds out of the softmax's instruction stream. The
//     bound policies take each row's bound from the same Q fragments (a
//     thread holds 16 of a row's 64 channels: partial sums of squares, two
//     shuffles over the quad) and keep no max, alpha or rescale; kIdentity's
//     fp32 row sum is a register sum in the softmax pass, reduced over the
//     quad at the end. S, P, alpha, l and O never touch shared memory. Within
//     a warpgroup the tiles are pipelined: S(t + 1) = Qs K(t + 1)^T and O +=
//     P(t) V(t) are started back to back, the softmax of S(t + 1) runs while
//     the tensor cores work on P(t) V(t), and O is waited for, rescaled and
//     P(t + 1) packed only after it.
//   * producer warp (warp 0 of the last warpgroup): one lane keeps TMA loads
//     of [BK, 64] K and V boxes in flight, STAGES deep, each stage announced
//     on its `full` mbarrier by the copy's byte count. A block that reads an
//     identity cache reads ids[b] once at its start: no gather copy.
//   * affine warps (the last warpgroup's other three): wait for `full`,
//     rewrite the V tile of a reference segment in place with the AdaIN
//     affine (the 128-byte swizzle XORs the 16-byte chunk index with row % 8;
//     a thread keeps one channel chunk and four rows in flight), fence the
//     generic-proxy writes for the async proxy, and arrive on `ready`. The
//     first product waits for `full` only, the second for `ready`, so the
//     pass hides under the previous tile's work.
//   Consumers release a stage on `empty`; the producer waits for it before it
//   loads over the stage. With three warpgroups setmaxnreg moves registers
//   from the producer warpgroup (72 a thread) to the consumers (216).
// Work assignment: !PAIR: the NCONS consumer warpgroups take NCONS * 64
// query rows of one (b, h) and share one ring (each K/V byte is read once for
// 128 rows); PAIR (kOnline only): warpgroup w takes head 2 g + w, the same 64
// query rows, on a ring of its own. The two warpgroups start their wgmma
// batches in turns (a pair of named barriers), so one's softmax (exp2 on the
// MUFU, as scarce as the tensor cores at d = 64) runs while the other's
// products queue.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace irt {
namespace wg {

constexpr float kNegInf = -1e30f;  // the JAX kernels' finite sentinel
constexpr float kBoundExpShift = 64.0f;
constexpr int kD = 64;             // head dim: one 128-byte swizzle row
constexpr int kRowBytes = kD * 2;
constexpr int kAffineWarps = 3;

enum class Policy { kOnline, kBound, kIdentity };
enum class Layout { kShared, kPlain };

// What a launch computes on, besides the four tensor maps. q, out [B, H, Sq,
// 64]; k_in/v_in [B, H, S, 64] (read only when n_in == 1); rk/rv [rows, N, H,
// S, 64] with rows = I and reference rows ids[b] when ids is given, else rows
// = B and row b; aff [B, H, N, 2, 64] fp32 (scale, shift of reference V);
// kmax fp32, kBound [B, H] read at b, kIdentity [I, H] read at ids[b];
// qscale = scale * log2 e; lse (Layout::kPlain only, may be null) [B, H, Sq]
// fp32.
struct Problem {
  const __nv_bfloat16 *q, *k_in, *v_in, *rk, *rv;
  const float *aff, *kmax;
  const int* ids;
  __nv_bfloat16* out;
  int B, H, Sq, S, N, I, n_in;
  float qscale;
  float* lse;
};

inline Problem make_problem(const void* q, const void* k_in, const void* v_in, const void* rk,
                            const void* rv, const void* aff, const void* kmax, const void* ids,
                            void* out, int B, int H, int Sq, int S, int N, int I, int n_in,
                            float qscale) {
  return Problem{static_cast<const __nv_bfloat16*>(q),  static_cast<const __nv_bfloat16*>(k_in),
                 static_cast<const __nv_bfloat16*>(v_in), static_cast<const __nv_bfloat16*>(rk),
                 static_cast<const __nv_bfloat16*>(rv), static_cast<const float*>(aff),
                 static_cast<const float*>(kmax),        static_cast<const int*>(ids),
                 static_cast<__nv_bfloat16*>(out),       B, H, Sq, S, N, I, n_in, qscale,
                 nullptr};
}

// The plain layout's problem: q, out [B, H, Sq, 64], k/v [B, H, Skv, 64],
// lse [B, H, Sq] fp32 or null, kmax [B, H] fp32 (kBound) or null.
inline Problem make_flash_problem(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int B, int H, int Sq, int Skv, float qscale,
                                  const void* kmax = nullptr) {
  Problem pr = make_problem(q, k, v, nullptr, nullptr, nullptr, kmax, nullptr, out, B, H, Sq,
                            Skv, 0, B, 1, qscale);
  pr.lse = static_cast<float*>(lse);
  return pr;
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma operand reads, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One [box rows, 64] bf16 box at (0, row) of a tensor map into shared memory;
// completion is counted in bytes on the mbarrier.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int col, int row,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// One [1, box rows, 64] box at (0, row, seg) of a segment map (encode_seg_map):
// rows past the segment's end arrive as zeros, and still count in bytes.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int row, int seg,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row), "r"(seg)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The compiler knows nothing of wgmma's asynchrony: pinning the accumulator
// registers here, after the wait, keeps it from reading them any earlier.
template <int N>
__device__ __forceinline__ void pin_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin_regs(uint64_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+l"(r[i])::"memory");
}

// Registers handed from the producer warpgroup to the consumer warpgroups
// (all four warps of a warpgroup execute the same one).
template <int R>
__device__ __forceinline__ void reg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Shared-memory matrix descriptor of a tile of 128-byte rows in the 128-byte
// swizzle whose 8-row groups lie 1024 bytes apart. For a K-major operand
// (rows = M or N, the 64 channels contiguous) the stride field is the group
// pitch and the leading field is unused; for an MN-major operand (rows = K,
// N = 64 contiguous: one swizzle atom wide) the group pitch is the step
// between 8-row slices of K. Both fields carry it.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t desc = (addr & 0x3FFFFu) >> 4;
  desc |= static_cast<uint64_t>(1024 >> 4) << 16;
  desc |= static_cast<uint64_t>(1024 >> 4) << 32;
  desc |= static_cast<uint64_t>(1) << 62;  // 128-byte swizzle
  return desc;
}

// d[64x64] (+)= a[64x16] b[16x64]: A from registers (the mma fragment layout
// of a warp's 16 rows), B from shared memory, K-major (TRANS_B = 0) or
// MN-major (TRANS_B = 1).
template <int TRANS_B, int SCALE_D>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(SCALE_D), "n"(TRANS_B));
}

// d[64x128] (+)= a[64x16] b[16x128], B K-major.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(SCALE_D));
}

// d[64x8] += a[64x16] b[16x8], A from registers, B from shared memory. With
// a B of ones every column of d is the row sum of a.
__device__ __forceinline__ void wgmma_m64n8k16(float (&d)[4], const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// Descriptor of the block of bf16 ones (kOnesBytes of them, so that every
// core matrix of a [16 x 8] operand lies inside it whatever the layout): no
// swizzle, core matrices 128 bytes apart.
constexpr int kOnesBytes = 1024;
__device__ __forceinline__ uint64_t ones_desc(uint32_t addr) {
  uint64_t desc = (addr & 0x3FFFFu) >> 4;
  desc |= static_cast<uint64_t>(128 >> 4) << 16;
  desc |= static_cast<uint64_t>(128 >> 4) << 32;
  return desc;
}

// S = Qs K^T for one k16 slice of the channels, by the tile's key count.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_qk(float (&s)[32], const uint32_t* a, uint64_t desc) {
  wgmma_m64n64k16<0, SCALE_D>(s, a, desc);
}
template <int SCALE_D>
__device__ __forceinline__ void wgmma_qk(float (&s)[64], const uint32_t* a, uint64_t desc) {
  wgmma_m64n128k16<SCALE_D>(s, a, desc);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

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

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Eight fp32 values rounded to bf16, as fp32.
__device__ __forceinline__ void load8_rounded(const float* p, float* f) {
  float raw[8];
  load8(p, raw);
  unpack8(pack8(raw), f);
}

// One key chunk of the online softmax on a thread's score fragment (rows g
// and g + 8 of its warp's 16, NS / 2 scores each), in place: m_new = max(m,
// rowmax(s)) over the quad, alpha = exp2(m - m_new), s <- exp2(bf16(s -
// m_new)) in fp32. m is updated in place. pack_p rounds the result to bf16;
// the row sums of the rounded p come from the tensor cores (a product with a
// column of ones, as the TPU kernels take them on the MXU).
template <int NS>
__device__ __forceinline__ void online_softmax(float (&s)[NS], float (&m)[2], float (&alpha)[2]) {
  float m_new[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    m_new[0] = fmaxf(m_new[0], fmaxf(s[4 * j], s[4 * j + 1]));
    m_new[1] = fmaxf(m_new[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 1));
    m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 2));
    alpha[i] = ex2(m[i] - m_new[i]);
    m[i] = m_new[i];
  }
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 arg = __bfloat1622float2(__floats2bfloat162_rn(
          s[4 * j + 2 * i] - m_new[i], s[4 * j + 2 * i + 1] - m_new[i]));
      s[4 * j + 2 * i] = ex2(arg.x);
      s[4 * j + 2 * i + 1] = ex2(arg.y);
    }
  }
}

// One key chunk of the bound softmax, in place: s <- exp2(s - bound) in fp32,
// bound per row (g, g + 8); pack_p rounds the result. FP32_SUM adds the fp32
// p to the thread's share of its rows' sums (kIdentity); otherwise the row
// sums of the rounded p come from the product with the block of ones.
template <bool FP32_SUM, int NS>
__device__ __forceinline__ void bound_softmax(float (&s)[NS], const float (&bnd)[2],
                                              float (&l)[2]) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s[4 * j + 2 * i] = ex2(s[4 * j + 2 * i] - bnd[i]);
      s[4 * j + 2 * i + 1] = ex2(s[4 * j + 2 * i + 1] - bnd[i]);
      if constexpr (FP32_SUM) l[i] += s[4 * j + 2 * i] + s[4 * j + 2 * i + 1];
    }
  }
}

// Keys at or past `lim` of a tile out of the softmax: their scores become -inf
// (in place, after the product's wait), so p = exp2(-inf - x) = 0 and they add
// nothing to the max, the row sum or P V. Column of s[4 j + 2 i + e]: 8 j + 2
// tq + e.
template <int NS>
__device__ __forceinline__ void mask_keys(float (&s)[NS], int lim, int tq) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * j + e] = 8 * j + 2 * tq + (e & 1) < lim ? s[4 * j + e] : -INFINITY;
}

// p = the softmaxed fragment rounded to bf16 and packed pairwise: the A
// fragments of O += P V.
template <int NS>
__device__ __forceinline__ void pack_p(const float (&s)[NS], uint32_t (&p)[NS / 2]) {
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) p[i] = as_u32(__floats2bfloat162_rn(s[2 * i], s[2 * i + 1]));
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <int BK, int NCONS, bool PAIR, int STAGES>
struct Cfg {
  static_assert(BK == 64 || BK == 128, "one wgmma of N = BK keys per channel slice");
  static_assert(!PAIR || NCONS == 2, "a head pair is two consumer warpgroups");
  static constexpr int kRings = PAIR ? 2 : 1;
  static constexpr int kThreads = (NCONS + 1) * 128;
  static constexpr int kTileBytes = BK * kRowBytes;  // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  // the 128-byte swizzle wants 1024-byte aligned stages: room to round up
  static constexpr int kOnesOff = kRings * STAGES * kStageBytes;  // the block of bf16 ones
  static constexpr int kSmemBytes = kOnesOff + kOnesBytes + 1024;
  static constexpr int kEmptyCount = 4 * (PAIR ? 1 : NCONS);  // consumer warps on a ring
  static constexpr int kBlockRows = 64 * (PAIR ? 1 : NCONS);
  // setmaxnreg at three warpgroups: 128 * 72 + 256 * 216 <= 65536 registers.
  // A block of two warpgroups gets 255 a thread from the launch.
  static constexpr bool kSplitRegs = NCONS == 2;
  static constexpr int kProducerRegs = 72;
  static constexpr int kConsumerRegs = 216;
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");
};

// map_kin/map_vin: the input's K/V as B * H segments of [S, 64]; map_rk/map_rv:
// the references' as rows * N * H segments (reference n of row r, head h is
// segment (r * N + n) * H + h); each with a [BK, 64] box (encode_seg_map).
// Grid (ceil(Sq / kBlockRows), H or H / 2, B). Layout::kPlain reads map_kin and
// map_vin only. RAGGED (BK does not divide S): the last tile of each segment
// holds S % BK keys, the rest of its box zeros that mask_keys takes out of the
// softmax. Query rows past Sq are read as zeros and never written.
template <Policy P, int BK, int NCONS, bool PAIR, int STAGES, Layout L = Layout::kShared,
          bool RAGGED = false>
__global__ void __launch_bounds__((NCONS + 1) * 128, 1)
shared_attn_wgmma_kernel(const __grid_constant__ CUtensorMap map_kin,
                         const __grid_constant__ CUtensorMap map_vin,
                         const __grid_constant__ CUtensorMap map_rk,
                         const __grid_constant__ CUtensorMap map_rv, const Problem pr) {
  using C = Cfg<BK, NCONS, PAIR, STAGES>;
  static_assert(P == Policy::kOnline || !PAIR, "the bound policies take one head a block");
  static_assert(L == Layout::kShared || (P != Policy::kIdentity && !PAIR),
                "the plain layout serves the online and bound policies, one head a block");
  constexpr bool kPlain = L == Layout::kPlain;
  constexpr bool kOnes = P != Policy::kIdentity;  // row sums of the rounded p on the tensor cores
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[3 * C::kRings * STAGES];

  const int H = pr.H, Sq = pr.Sq, S = pr.S, N = pr.N, n_in = pr.n_in;
  const int b = blockIdx.z;
  // the references' row of sample b: ids[b] in an identity cache
  int ref_row = b;
  if constexpr (P != Policy::kOnline) {
    if (pr.ids != nullptr) {
      ref_row = pr.ids[b];
      if (ref_row < 0 || ref_row >= pr.I) {
        // an id outside the cache poisons its sample's outputs; the block
        // leaves before any barrier or copy
        const int r0 = blockIdx.x * C::kBlockRows;
        const int n_rows = Sq - r0 < C::kBlockRows ? Sq - r0 : C::kBlockRows;
        const size_t base = (static_cast<size_t>(b * H + blockIdx.y) * Sq + r0) * kD;
        for (int c = threadIdx.x; c < n_rows * kD; c += C::kThreads)
          pr.out[base + c] = __float2bfloat16(__int_as_float(0x7fc00000));
        return;
      }
    }
  }

  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t tiles = (raw_addr + 1023u) & ~1023u;  // first stage, shared-window address
  const uint32_t bar0 = smem_u32(bars);
  auto full_bar = [&](int ring, int stage) { return bar0 + 8u * (ring * STAGES + stage); };
  auto ready_bar = [&](int ring, int stage) {
    return bar0 + 8u * ((C::kRings + ring) * STAGES + stage);
  };
  auto empty_bar = [&](int ring, int stage) {
    return bar0 + 8u * ((2 * C::kRings + ring) * STAGES + stage);
  };
  auto k_tile = [&](int ring, int stage) {
    return tiles + static_cast<uint32_t>((ring * STAGES + stage) * C::kStageBytes);
  };

  if (kOnes && threadIdx.x < kOnesBytes / 16) {
    const uint32_t one2 = 0x3F803F80u;  // two bf16 ones
    *reinterpret_cast<uint4*>(smem_raw + (tiles - raw_addr) + C::kOnesOff + threadIdx.x * 16) =
        make_uint4(one2, one2, one2, one2);
    fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    for (int ring = 0; ring < C::kRings; ++ring)
      for (int stage = 0; stage < STAGES; ++stage) {
        mbar_init(full_bar(ring, stage), 1);
        mbar_init(ready_bar(ring, stage), kAffineWarps);
        mbar_init(empty_bar(ring, stage), C::kEmptyCount);
      }
    fence_barrier_init();
  }
  __syncthreads();

  const int wgrp = threadIdx.x / 128;
  const int tw = threadIdx.x % 128;  // thread within its warpgroup
  const int warp = tw / 32;
  const int lane = tw % 32;
  const int tiles_per_seg = (S + BK - 1) / BK;
  const int n_tiles = (n_in + N) * tiles_per_seg;

  if (wgrp == NCONS) {
    if constexpr (C::kSplitRegs) reg_dec<C::kProducerRegs>();
    if (warp == 0) {
      // ---- producer: TMA loads, STAGES tiles ahead of the consumers ----
      if (lane == 0) {
        for (int t = 0; t < n_tiles; ++t) {
          const int stage = t % STAGES;
          const uint32_t parity = (t / STAGES) & 1;
          const int seg = t / tiles_per_seg - n_in;  // reference index; -1 is the input
          const int j0 = (t % tiles_per_seg) * BK;
#pragma unroll
          for (int ring = 0; ring < C::kRings; ++ring) {
            const int h = PAIR ? 2 * blockIdx.y + ring : blockIdx.y;
            const int sidx = seg < 0 ? b * H + h : (ref_row * N + seg) * H + h;
            mbar_wait(empty_bar(ring, stage), parity ^ 1u);
            mbar_expect_tx(full_bar(ring, stage), C::kStageBytes);
            const uint32_t kt = k_tile(ring, stage);
            tma_load_3d(kt, seg < 0 ? &map_kin : &map_rk, j0, sidx, full_bar(ring, stage));
            tma_load_3d(kt + C::kTileBytes, seg < 0 ? &map_vin : &map_rv, j0, sidx,
                        full_bar(ring, stage));
          }
        }
      }
    } else if constexpr (!kPlain) {
      // ---- affine warps: reference V <- bf16(v * a + c), in place; a and c
      // rounded to bf16 first but under kIdentity (the plain layout has no
      // reference, and no consumer waits on `ready`) ----
      // a thread keeps one 8-channel chunk (16 bytes of a row) and every
      // 12th row; four rows are in flight at a time
      const int at = tw - 32;  // 0 .. 95
      const int chunk = at & 7;
      const int r0 = at >> 3;
      constexpr int kRowStep = kAffineWarps * 32 / 8;
      constexpr int kIters = (BK + kRowStep - 1) / kRowStep;
      for (int t = 0; t < n_tiles; ++t) {
        const int stage = t % STAGES;
        const uint32_t parity = (t / STAGES) & 1;
        const int seg = t / tiles_per_seg - n_in;
#pragma unroll
        for (int ring = 0; ring < C::kRings; ++ring) {
          mbar_wait(full_bar(ring, stage), parity);
          if (seg >= 0) {
            const int h = PAIR ? 2 * blockIdx.y + ring : blockIdx.y;
            const float* a_vec = pr.aff + (static_cast<size_t>(b * H + h) * N + seg) * 2 * kD;
            float sc[8], sh[8];
            if constexpr (P == Policy::kIdentity) {
              load8(a_vec + chunk * 8, sc);
              load8(a_vec + kD + chunk * 8, sh);
            } else {
              load8_rounded(a_vec + chunk * 8, sc);
              load8_rounded(a_vec + kD + chunk * 8, sh);
            }
            unsigned char* vt = smem_raw + (k_tile(ring, stage) + C::kTileBytes - raw_addr);
            // the swizzle stores 16-byte chunk c of row r at chunk c ^ (r % 8)
            auto at_row = [&](int kr) {
              return reinterpret_cast<uint4*>(vt + kr * kRowBytes + ((chunk ^ (kr & 7)) << 4));
            };
#pragma unroll
            for (int i0 = 0; i0 < kIters; i0 += 4) {
              uint4 raw[4];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int kr = r0 + (i0 + j) * kRowStep;
                if (i0 + j < kIters && kr < BK) raw[j] = *at_row(kr);
              }
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int kr = r0 + (i0 + j) * kRowStep;
                if (i0 + j < kIters && kr < BK) {
                  float f[8];
                  unpack8(raw[j], f);
#pragma unroll
                  for (int e = 0; e < 8; ++e) f[e] = f[e] * sc[e] + sh[e];
                  *at_row(kr) = pack8(f);
                }
              }
            }
            fence_proxy_async();
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(ready_bar(ring, stage));
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup: 64 query rows of one head ----
  if constexpr (C::kSplitRegs) reg_inc<C::kConsumerRegs>();
  const int ring = PAIR ? wgrp : 0;
  const int h = PAIR ? 2 * blockIdx.y + wgrp : blockIdx.y;
  const int q0 = PAIR ? blockIdx.x * 64 : (blockIdx.x * NCONS + wgrp) * 64;
  const int g = lane >> 2;   // row of the warp's 16 (and g + 8)
  const int tq = lane & 3;   // column pair within each group of 8
  const int r_warp = q0 + warp * 16;  // the warp's first query row
  const size_t row_base = (static_cast<size_t>(b * H + h) * Sq + r_warp) * kD;

  // Q as the A fragments of S = Qs K^T, pre-scaled in bf16: per k16 slice
  // (row g, cols 2t..), (row g + 8, cols 2t..), (row g, cols 2t + 8..), (row g + 8, ..).
  // The bound policies take each row's norm from the same values: the thread's
  // 16 channels of rows g and g + 8, then the quad's other three threads'.
  uint32_t qa[kD / 16][4];
  float bnd[2] = {0.f, 0.f};
  {
    const float qs_bf = __bfloat162float(__float2bfloat16(pr.qscale));
    float ss[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + (i & 1) * 8;
        const int c = kk * 16 + tq * 2 + (i >> 1) * 8;
        const float2 f =
            r_warp + r < Sq
                ? __bfloat1622float2(
                      *reinterpret_cast<const __nv_bfloat162*>(pr.q + row_base + r * kD + c))
                : make_float2(0.f, 0.f);
        const __nv_bfloat162 qs2 = __floats2bfloat162_rn(f.x * qs_bf, f.y * qs_bf);
        qa[kk][i] = as_u32(qs2);
        if constexpr (P == Policy::kBound) ss[i & 1] += f.x * f.x + f.y * f.y;
        if constexpr (P == Policy::kIdentity) {
          const float2 fs = __bfloat1622float2(qs2);
          ss[i & 1] += fs.x * fs.x + fs.y * fs.y;
        }
      }
    }
    if constexpr (P != Policy::kOnline) {
      const float kmax = pr.kmax[(P == Policy::kIdentity ? ref_row : b) * H + h];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], 1);
        ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], 2);
        bnd[i] = P == Policy::kIdentity ? sqrtf(ss[i]) * kmax - kBoundExpShift
                                        : sqrtf(ss[i]) * pr.qscale * kmax - kBoundExpShift;
      }
    }
  }

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // rows g and g + 8
  // row sums of the rounded P, every column the same: [0], [1] row g, [2], [3] row g + 8
  float l_acc[4] = {0.f, 0.f, 0.f, 0.f};
  float l_part[2] = {0.f, 0.f};  // kIdentity: the thread's share of rows g and g + 8
  float s[BK / 2];     // S = Qs K^T of one tile, fp32
  uint32_t p[BK / 4];  // bf16 P of the tile whose P V is next
  float alpha[2];
  const uint64_t ones = ones_desc(tiles + C::kOnesOff);
  // RAGGED: the keys of tile t still in its segment
  auto mask = [&](int t) {
    if constexpr (RAGGED) mask_keys(s, S - (t % tiles_per_seg) * BK, tq);
  };
  auto softmax = [&]() {
    if constexpr (P == Policy::kOnline)
      online_softmax(s, m_run, alpha);
    else
      bound_softmax<P == Policy::kIdentity>(s, bnd, l_part);
  };

  // The descriptors of a stage's K tile (one per k16 slice of the channels)
  // and V tile (one per 16 keys: 2048 bytes), in registers before a batch's
  // fence, so that nothing but wgmma lies between a fence and its commit.
  uint64_t kd[kD / 16], vd[BK / 16];
  auto k_descs = [&](int stage) {
    const uint64_t kdesc = smem_desc(k_tile(ring, stage));
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) kd[kk] = kdesc + static_cast<uint64_t>(kk * 32 >> 4);
    pin_regs(kd);
  };
  auto v_descs = [&](int stage) {
    const uint64_t vdesc = smem_desc(k_tile(ring, stage) + C::kTileBytes);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      vd[kk] = vdesc + static_cast<uint64_t>(kk * 16 * kRowBytes >> 4);
    pin_regs(vd);
  };
  // S = Qs K^T, and O += P V with l += P 1 (A = P from registers), of one
  // tile: each a wgmma batch of its own, fence to commit
  auto start_qk = [&]() {
    wgmma_fence();
    wgmma_qk<0>(s, qa[0], kd[0]);
#pragma unroll
    for (int kk = 1; kk < kD / 16; ++kk) wgmma_qk<1>(s, qa[kk], kd[kk]);
    wgmma_commit();
  };
  auto start_pv = [&]() {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_m64n64k16<1, 1>(o, &p[4 * kk], vd[kk]);
    if constexpr (P != Policy::kIdentity) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_m64n8k16(l_acc, &p[4 * kk], ones);
    }
    wgmma_commit();
  };
  auto pin_acc = [&]() {
    pin_regs(o);
    if constexpr (P != Policy::kIdentity) pin_regs(l_acc);
  };
  // The two consumer warpgroups of a block start their batches in turns
  // (named barriers 1 and 2: warpgroup w waits on 1 + w and passes the turn
  // on the other's), so that one's products queue while the other is in its
  // softmax and neither starts two batches in a row.
  auto turn_wait = [&]() {
    if constexpr (NCONS == 2) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wgrp) : "memory");
  };
  auto turn_pass = [&]() {
    if constexpr (NCONS == 2) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wgrp) : "memory");
  };
  if (wgrp == 1) turn_pass();  // warpgroup 0 goes first
  auto release = [&](int stage) {
    if (lane == 0) mbar_arrive(empty_bar(ring, stage));
    __syncwarp();
  };

  // prologue: S and P of tile 0 (alpha = exp2(-1e30 - m) = 0 on a zero O)
  k_descs(0);
  mbar_wait(full_bar(ring, 0), 0);
  turn_wait();
  start_qk();
  turn_pass();
  wgmma_wait<0>();
  pin_regs(s);
  mask(0);
  softmax();
  pack_p(s, p);

  // Per tile t but the last: S(t + 1) = Qs K(t + 1)^T and O += P(t) V(t) are
  // started back to back; the softmax of S(t + 1) runs while the tensor cores
  // are still on P(t) V(t), in place and in fp32: P(t)'s registers are read
  // by the tensor cores until the wait, and ptxas serialises the batches if
  // it can fold a later definition into them. Only then does the warpgroup
  // wait for O, rescale it (kOnline) and pack P(t + 1). Nothing but the
  // second fence lies between the two batches, and the loop body has no
  // branch: ptxas also serialises wgmma batches whose start or wait sits on a
  // conditional path.
  for (int t = 0; t + 1 < n_tiles; ++t) {
    const int stage = t % STAGES;
    const int next = (t + 1) % STAGES;
    k_descs(next);
    v_descs(stage);
    mbar_wait(full_bar(ring, next), ((t + 1) / STAGES) & 1);
    // the affine warps have passed over V (the plain layout: V came with K)
    if constexpr (!kPlain) mbar_wait(ready_bar(ring, stage), (t / STAGES) & 1);
    turn_wait();
    start_qk();
    start_pv();
    turn_pass();
    wgmma_wait<1>();  // S(t + 1) has landed; P(t) V(t) may still run
    pin_regs(s);
    mask(t + 1);
    softmax();
    wgmma_wait<0>();
    pin_acc();
    release(stage);
    if constexpr (P == Policy::kOnline) {
#pragma unroll
      for (int i = 0; i < 4; ++i) l_acc[i] *= alpha[i >> 1];
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
    }
    pack_p(s, p);
    // the rescaled O and l and the new P are in place before the next batch's fence
    pin_acc();
    pin_regs(p);
  }
  {
    const int last = n_tiles - 1;
    v_descs(last % STAGES);
    if constexpr (!kPlain) mbar_wait(ready_bar(ring, last % STAGES), (last / STAGES) & 1);
    turn_wait();
    start_pv();
    turn_pass();
    wgmma_wait<0>();
    pin_acc();
    release(last % STAGES);
  }

  // epilogue: out = O / l in bf16, straight from the accumulator registers;
  // the whole row's sum in every lane of the quad
  float l_run[2] = {l_acc[0], l_acc[2]};
  if constexpr (!kOnes) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_run[i] = l_part[i] + __shfl_xor_sync(0xffffffffu, l_part[i], 1);
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    }
  }
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (r_warp + g + 8 * i >= Sq) continue;
      __nv_bfloat16* dst = pr.out + row_base + (g + 8 * i) * kD + 8 * j + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] / l_run[i], o[4 * j + 2 * i + 1] / l_run[i]);
    }
  }
  // lse2 = m + log2(l) of rows g and g + 8: the quad shares both, one lane writes
  if constexpr (kPlain && P == Policy::kOnline) {
    if (pr.lse != nullptr && tq == 0) {
      const size_t row0 = static_cast<size_t>(b * H + h) * Sq + r_warp + g;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (r_warp + g + 8 * i < Sq) pr.lse[row0 + 8 * i] = m_run[i] + log2f(l_run[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up at run time: the libraries link no libcuda.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) !=
            cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Tensor map over a contiguous [rows, cols] bf16 array with a [box_rows, 64]
// box in the 128-byte swizzle (cols > 64: the box is one 64-channel slab of a
// row, addressed by its first column).
inline bool encode_rows_map(CUtensorMap* map, const void* base, uint64_t rows, uint32_t box_rows,
                            uint64_t cols = kD) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {kD, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor map over `segs` contiguous segments of [seg_rows, 64] bf16 with a [1,
// box_rows, 64] box in the 128-byte swizzle: a box that runs past the end of
// its segment is filled with zeros, never with the next segment's rows.
inline bool encode_seg_map(CUtensorMap* map, const void* base, uint64_t segs, uint64_t seg_rows,
                           uint32_t box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {kD, seg_rows, segs};
  const cuuint64_t strides[2] = {kRowBytes, seg_rows * kRowBytes};
  const cuuint32_t box[3] = {kD, box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <Policy P, int BK, int NCONS, bool PAIR, Layout L = Layout::kShared, bool RAGGED = false>
cudaError_t run_shared(const Problem& pr, void* stream) {
  constexpr int STAGES = (PAIR && BK == 128) ? 3 : 4;
  using C = Cfg<BK, NCONS, PAIR, STAGES>;
  const uint64_t in_segs = static_cast<uint64_t>(pr.B) * pr.H;
  CUtensorMap map_kin, map_vin, map_rk, map_rv;
  if constexpr (L == Layout::kPlain) {
    // two maps; the reference maps are never read
    if (!encode_seg_map(&map_kin, pr.k_in, in_segs, pr.S, BK) ||
        !encode_seg_map(&map_vin, pr.v_in, in_segs, pr.S, BK))
      return cudaErrorNotSupported;
    map_rk = map_kin;
    map_rv = map_vin;
  } else {
    const uint64_t ref_segs = static_cast<uint64_t>(pr.ids != nullptr ? pr.I : pr.B) * pr.N * pr.H;
    // without an input segment its two maps are never read: they alias the references
    const bool inp = pr.n_in != 0;
    if (!encode_seg_map(&map_rk, pr.rk, ref_segs, pr.S, BK) ||
        !encode_seg_map(&map_rv, pr.rv, ref_segs, pr.S, BK) ||
        !encode_seg_map(&map_kin, inp ? pr.k_in : pr.rk, inp ? in_segs : ref_segs, pr.S, BK) ||
        !encode_seg_map(&map_vin, inp ? pr.v_in : pr.rv, inp ? in_segs : ref_segs, pr.S, BK))
      return cudaErrorNotSupported;
  }
  auto kern = shared_attn_wgmma_kernel<P, BK, NCONS, PAIR, STAGES, L, RAGGED>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((pr.Sq + C::kBlockRows - 1) / C::kBlockRows, PAIR ? pr.H / 2 : pr.H, pr.B);
  kern<<<grid, C::kThreads, C::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map_kin, map_vin, map_rk, map_rv, pr);
  return cudaGetLastError();
}

// The tile of a segment of S keys: 128 keys where 128 divides S, 64 where 64
// does, else (a ragged last tile) 128 where S > 64 and 64 where it is shorter.
// The key chunk of the running max is that tile, the last one of a segment
// cut at its end (ops/shared_attention.py: key_tile, shared_online_chunk).
inline int key_tile(int S) {
  if (S % 128 == 0) return 128;
  if (S % 64 == 0) return 64;
  return S > 64 ? 128 : 64;
}

// The tile a call gets: key_tile(S) keys; !PAIR takes 128 query rows a block
// where they divide Sq and 64 otherwise, and 64 where the key tile is ragged
// (ops/shared_attention.py: shared_online_tile). Any Sq and S > 0. Refuses
// more than 65535 samples or heads, a head pair of odd H, an input segment
// under kIdentity, a bound policy without kmax, kIdentity without ids, and
// reference or input rows past 2^31.
template <Policy P, bool PAIR>
cudaError_t launch_shared(const Problem& pr, void* stream) {
  const bool has_ids = pr.ids != nullptr;
  const uint64_t rows = has_ids ? pr.I : pr.B;
  if (pr.B <= 0 || pr.H <= 0 || pr.N <= 0 || pr.Sq <= 0 || pr.S <= 0 ||
      pr.B > 65535 || pr.H > 65535 || (PAIR && pr.H % 2 != 0) ||
      pr.n_in < 0 || pr.n_in > 1 || (pr.n_in == 1 && (pr.k_in == nullptr || pr.v_in == nullptr)) ||
      pr.q == nullptr || pr.rk == nullptr || pr.rv == nullptr || pr.aff == nullptr ||
      pr.out == nullptr || (P != Policy::kOnline && pr.kmax == nullptr) ||
      (P == Policy::kOnline && has_ids) || (P == Policy::kIdentity && (!has_ids || pr.n_in)) ||
      (has_ids && pr.I <= 0) || rows * pr.N * pr.H * pr.S > 0x7fffffffull ||
      (pr.n_in && static_cast<uint64_t>(pr.B) * pr.H * pr.S > 0x7fffffffull))
    return cudaErrorInvalidValue;
#define IRT_RUN(BK, NCONS) run_shared<P, BK, NCONS, PAIR>(pr, stream)
#define IRT_RAGGED(BK) run_shared<P, BK, PAIR ? 2 : 1, PAIR, Layout::kShared, true>(pr, stream)
  const int bk = key_tile(pr.S);
  if (pr.S % bk != 0) return bk == 128 ? IRT_RAGGED(128) : IRT_RAGGED(64);
  if constexpr (PAIR) {
    return bk == 128 ? IRT_RUN(128, 2) : IRT_RUN(64, 2);
  } else {
    const bool wide = pr.Sq % 128 == 0;
    if (bk == 128) return wide ? IRT_RUN(128, 2) : IRT_RUN(128, 1);
    return wide ? IRT_RUN(64, 2) : IRT_RUN(64, 1);
  }
#undef IRT_RAGGED
#undef IRT_RUN
}

// The plain layout (flash_online.cu, flash_fwd_lse.cu: Policy::kOnline;
// flash_bound.cu: Policy::kBound with pr.kmax [B, H]): q [B, H, Sq, 64]
// against the Skv = pr.S keys of k_in/v_in [B, H, Skv, 64], any Sq and Skv.
// The key chunk is the caller's (kOnline's result depends on it at bf16
// rounding level, kBound's through fp32 summation order only:
// ops/shared_attention.py, flash_online_chunk and flash_bound_chunk): 128 or
// 64 keys, the last chunk cut at Skv, or all Skv keys where they are fewer
// than 128; its tile is 128 keys over 64, else 64. 128 query rows a block where
// they divide Sq and the tile divides Skv, else 64. Refuses another chunk,
// more than 65535 samples or heads, a bound policy without kmax, and key rows
// past 2^31.
template <Policy P>
cudaError_t launch_flash(const Problem& pr, int bk, void* stream) {
  static_assert(P != Policy::kIdentity, "the identity policy reads an identity cache");
  const bool chunk_ok = ((bk == 64 || bk == 128) && bk <= pr.S) || (bk == pr.S && bk < 128);
  if (pr.B <= 0 || pr.H <= 0 || pr.Sq <= 0 || pr.S <= 0 || bk <= 0 || !chunk_ok ||
      pr.B > 65535 || pr.H > 65535 || pr.N != 0 ||
      pr.n_in != 1 || pr.q == nullptr || pr.k_in == nullptr || pr.v_in == nullptr ||
      pr.out == nullptr || (P == Policy::kBound && pr.kmax == nullptr) || pr.ids != nullptr ||
      static_cast<uint64_t>(pr.B) * pr.H * pr.S > 0x7fffffffull)
    return cudaErrorInvalidValue;
#define IRT_RUN(BK, NCONS) run_shared<P, BK, NCONS, false, Layout::kPlain>(pr, stream)
#define IRT_RAGGED(BK) run_shared<P, BK, 1, false, Layout::kPlain, true>(pr, stream)
  const int tile = bk > 64 ? 128 : 64;
  if (pr.S % tile != 0) return tile == 128 ? IRT_RAGGED(128) : IRT_RAGGED(64);
  const bool wide = pr.Sq % 128 == 0;
  if (tile == 128) return wide ? IRT_RUN(128, 2) : IRT_RUN(128, 1);
  return wide ? IRT_RUN(64, 2) : IRT_RUN(64, 1);
#undef IRT_RAGGED
#undef IRT_RUN
}

}  // namespace wg
}  // namespace irt
