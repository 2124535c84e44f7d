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
// (KV-outer) or a query block does (Q-outer). A thread block holds 64 query
// rows' accumulator in registers and walks the segments itself either way,
// so there is one work assignment on this card and one kernel. Same numerics
// as both: q pre-scaled in bf16, segments in the order input, ref 1 .. N,
// per key tile m_new = max(m, rowmax(s)) from m = -1e30, p =
// exp2(bf16(s - m_new)) rounded to bf16, row sum over the rounded p (the TPU
// kernels' ones column), alpha = exp2(m - m_new) on the row sum and the fp32
// accumulator, out = acc / l in bf16. The AdaIN scale and shift are rounded
// to bf16 and v * a + c is rounded once from fp32, as in
// shared_flash_bound.cu (the TPU kernels round the product and the sum, at
// most 1 bf16 ulp of the value apart); the input segment takes raw v_in.
// Zeroed references are read and attended with logit 0. The key tile is 64
// wide where the TPU kernels' is 512: bf16 rounding level only.
//
// What bounds it on the H100: tensor-core operations and exp2, as
// shared_flash_bound.cu (1.37 TFLOP and 5.4 G exp2 for 0.4 GB at the 64^2
// layer of a batch-16 cold restore, 1.72 TFLOP with the input segment), plus
// a row max and an accumulator rescale per key tile. This is the simple
// correct tile of attn_tile.cuh.

#include "attn_tile.cuh"

// q, out [B, H, Sq, D]; k_in/v_in [B, H, S, D] (read only when n_in == 1,
// else may be null); rk/rv [B, N, H, S, D]; aff [B, H, N, 2, D] fp32.
extern "C" int irt_shared_online_bf16(const void* q, const void* k_in, const void* v_in,
                                      const void* rk, const void* rv, const void* aff,
                                      void* out, int B, int H, int Sq, int S, int N, int n_in,
                                      int D, float qscale, void* stream) {
  using irt::Mode;
  if (D == 64)
    return (int)irt::launch_attn<Mode::kSharedOnline, 64, 64, 64, 4>(
        q, k_in, v_in, rk, rv, nullptr, aff, nullptr, out, B, H, Sq, S, N, B, n_in, qscale,
        stream);
  return (int)cudaErrorInvalidValue;
}
