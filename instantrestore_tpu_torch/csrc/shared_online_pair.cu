// shared_online_pair: shared_online.cu's function with one thread block
// owning a pair of heads, the algorithm INSTANTRESTORE_ATTN_ALGO=
// kv_outer_packed selects at d <= 64 and even H (the H = 5 layers of SD-Turbo
// fall through to shared_online, as in the JAX package).
//
// Replaces the TPU kernel instantrestore_tpu/ops/shared_attention.py:
// _shared_kvouter_packed_kernel (launched by
// _shared_flash_attention_kvouter_packed). On the TPU the pair exists to fill
// a 128-lane matrix unit: q packs as [q_a | q_b] and K, V expand to
// block-diagonal tiles, half of them zeros. A wgmma.mma_async tile is 64 rows
// by 16 channels a step, so d = 64 wastes nothing here and the zeros would
// only double the work; what carries over is the work assignment. A block
// takes heads 2g and 2g + 1 of one sample and 64 query rows: consumer
// warpgroup 0 runs head 2g, warpgroup 1 head 2g + 1, each on its own ring of
// K/V stages (TMA, cp.async.bulk.tensor, one producer warp feeds both rings;
// three affine warps serve both). The two share nothing else but their
// order: they take turns at their wgmma batches, so one head's exp2 pass
// runs while the other head's products queue. Per head the code and its
// order are shared_online's (the same consumer loop of attn_wgmma.cuh at the
// same key chunk), so the two agree bit for bit: per-head running max and row
// sum, p = exp2(bf16(s - m_new)), row sum over the rounded p (on the tensor
// cores here, on the VPU in the TPU kernel: the same number up to fp32
// summation order), bf16 scale and shift with one rounding of v * a + c.
//
// What bounds it on the H100: as shared_online.cu, operations and exp2
// alike. Against shared_online a block reads every K/V byte for 64 query
// rows, not 128, and holds two rings (192 KB of shared memory at the 128-key
// chunk, 3 stages each): the measured times stand beside shared_online's in
// PERF.md.

#include "attn_wgmma.cuh"

// Arguments as irt_shared_online_bf16; H must be even.
extern "C" int irt_shared_online_pair_bf16(const void* q, const void* k_in, const void* v_in,
                                           const void* rk, const void* rv, const void* aff,
                                           void* out, int B, int H, int Sq, int S, int N,
                                           int n_in, int D, float qscale, void* stream) {
  if (D == 64)
    return (int)irt::wg::launch_shared<irt::wg::Policy::kOnline, true>(
        irt::wg::make_problem(q, k_in, v_in, rk, rv, aff, nullptr, nullptr, out, B, H, Sq, S, N,
                              B, n_in, qscale),
        stream);
  return (int)cudaErrorInvalidValue;
}
