// shared_online: shared-image attention over [input |] N references with a
// running row max,
//     out = softmax(q [K_in | K_1 .. K_N]^T * scale) [V_in | V_1 a_1 + c_1 ..]
// the algorithm INSTANTRESTORE_ATTN_ALGO=kv_outer (and q_outer) selects for
// the 9 up-block self-attentions of a cold restore, of the Predictor and of a
// train_input model (references per call, [B, N, H, S, d], row = b). It is
// the way out for weights whose bound slack passes ~190 log2 units, where the
// bound kernels (shared_flash_bound.cu, shared_identity.cu) lose the row.
//
// Replaces the TPU kernel instantrestore_tpu/ops/shared_attention.py:
// _shared_kvouter_kernel (launched by _shared_flash_attention_kvouter), and
// serves _shared_kernel's algorithm name too: the two differ on the TPU in
// whether the full-Sq accumulator stays in VMEM across the segment grid
// (KV-outer) or a query block does (Q-outer). A thread block keeps its query
// rows' accumulator in registers and walks the segments itself either way,
// so there is one work assignment on this card and one kernel. Same numerics
// as both: q pre-scaled in bf16, segments in the order input, ref 1 .. N,
// per key chunk m_new = max(m, rowmax(s)) from m = -1e30, p =
// exp2(bf16(s - m_new)) rounded to bf16, row sum over the rounded p (the TPU
// kernels' ones column), alpha = exp2(m - m_new) on the row sum and the fp32
// accumulator, out = acc / l in bf16. The AdaIN scale and shift are rounded
// to bf16 and v * a + c is rounded once from fp32, as in
// shared_flash_bound.cu (the TPU kernels round the product and the sum, at
// most 1 bf16 ulp of the value apart); the input segment takes raw v_in.
// Zeroed references are read and attended with logit 0. The key chunk is 128
// (64 where 128 does not divide the segment but 64 does; a ragged last chunk
// of each segment where neither does) where the TPU kernels' is 512: bf16
// rounding level only.
//
// What bounds it on the H100: tensor-core operations and exp2 alike. The
// 64^2 layer of a batch-16 cold restore is 1.37 TFLOP (1.39 ms at 989
// TFLOP/s) and 5.4 G exp2 (1.3 ms at 16 per clock per SM) for 0.4 GB (0.1
// ms), so the two must overlap: run in turn they can never come under twice
// the bound. The tile of attn_wgmma.cuh does both products with
// wgmma.mma_async, S, P, alpha, l and O in registers (no score, P or alpha
// tile in shared memory), K and V by TMA (cp.async.bulk.tensor into a 4-stage
// ring behind mbarriers, fed by a producer warp), the AdaIN affine as an
// in-place pass of three spare warps over the arrived V tile, and the row
// sums of the rounded P as one more small product with a block of ones (the
// TPU kernels' ones column). A block is two consumer warpgroups of 64 query
// rows on one (b, h) and one ring: each K/V byte feeds 128 query rows. Each
// warpgroup starts S(t + 1) and P(t) V(t) together and runs the softmax of
// S(t + 1) under them; the two take turns at that, so one's exp2 pass
// runs while the other's products queue. Sq % 128 == 64 takes blocks of one
// consumer warpgroup.

#include "attn_wgmma.cuh"

// q, out [B, H, Sq, D]; k_in/v_in [B, H, S, D] (read only when n_in == 1,
// else may be null); rk/rv [B, N, H, S, D]; aff [B, H, N, 2, D] fp32.
extern "C" int irt_shared_online_bf16(const void* q, const void* k_in, const void* v_in,
                                      const void* rk, const void* rv, const void* aff,
                                      void* out, int B, int H, int Sq, int S, int N, int n_in,
                                      int D, float qscale, void* stream) {
  if (D == 64)
    return (int)irt::wg::launch_shared<irt::wg::Policy::kOnline, false>(
        irt::wg::make_problem(q, k_in, v_in, rk, rv, aff, nullptr, nullptr, out, B, H, Sq, S, N,
                              B, n_in, qscale),
        stream);
  return (int)cudaErrorInvalidValue;
}
