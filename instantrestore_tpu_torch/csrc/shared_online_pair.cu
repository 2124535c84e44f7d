// shared_online_pair: shared_online.cu's function with one thread block
// owning a pair of heads, the algorithm INSTANTRESTORE_ATTN_ALGO=
// kv_outer_packed selects at d <= 64 and even H (the H = 5 layers of SD-Turbo
// fall through to shared_online, as in the JAX package).
//
// Replaces the TPU kernel instantrestore_tpu/ops/shared_attention.py:
// _shared_kvouter_packed_kernel (launched by
// _shared_flash_attention_kvouter_packed). On the TPU the pair exists to fill
// a 128-lane matrix unit: q packs as [q_a | q_b] and K, V expand to
// block-diagonal tiles, half of them zeros. mma.sync tiles are 16 wide, so
// d = 64 wastes nothing here and the zeros would only double the work; what
// carries over is the work assignment. A block of 8 warps takes heads 2g and
// 2g + 1 of one sample and 64 query rows: warps 0-3 run head 2g on their own
// Q, K, V, P and score tiles, warps 4-7 head 2g + 1 on theirs, in step (the
// block's barriers are shared). Per head the arithmetic is shared_online's,
// so the two agree bit for bit: per-half running max and row sum, p =
// exp2(bf16(s - m_new)), row sum over the rounded p (the TPU kernel sums
// p.astype(fp32) on the VPU: the same number), bf16 scale and shift with one
// rounding of v * a + c.
//
// What bounds it on the H100: as shared_online.cu. Blocks are half as many
// and twice as large (256 threads, 114 KB of shared memory, one block per
// SM where shared_online fits three of 57 KB): the measured times stand
// beside shared_online's in PERF.md.

#include "attn_tile.cuh"

// Arguments as irt_shared_online_bf16; H must be even.
extern "C" int irt_shared_online_pair_bf16(const void* q, const void* k_in, const void* v_in,
                                           const void* rk, const void* rv, const void* aff,
                                           void* out, int B, int H, int Sq, int S, int N,
                                           int n_in, int D, float qscale, void* stream) {
  using irt::Mode;
  if (D == 64)
    return (int)irt::launch_attn<Mode::kSharedOnline, 64, 64, 64, 4, 2>(
        q, k_in, v_in, rk, rv, nullptr, aff, nullptr, out, B, H, Sq, S, N, B, n_in, qscale,
        stream);
  return (int)cudaErrorInvalidValue;
}
