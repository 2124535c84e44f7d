// flash_bwd_dq: the query gradient of softmax(q k^T * scale) v, with the
// probabilities recomputed from the forward's log-sum-exp:
//     dQ = sum_j bf16(scale * P_j * (dO v_j^T - delta)) k_j,
//     P = exp2(bf16(q * bf16(scale * log2 e)) k^T - lse2)
// (fp32 scores and P, fp32 accumulator [BQ, d], bf16 out). A training step
// runs it once for every fused self-attention with a gradient, at the shapes
// of flash_fwd_lse.cu.
//
// Replaces the TPU kernel instantrestore_tpu/ops/flash_vjp.py:
// _bwd_dq_kernel. Q-outer like the forward: a block owns 64 query rows (32
// at d=512), keeps their accumulator in registers and streams 64-key tiles.
//
// What bounds it on the H100: tensor-core operations, 6 * B * H * Sq * Skv * d
// (three products) on q, k, v, dO, dQ read or written once: the shared 64^2
// layer of a batch-2 step (H=5, 4096 queries, 16384 keys) is 0.26 TFLOP for
// 32 MB. This is the simple correct tile of flash_bwd_tile.cuh (WMMA
// mma.sync, scores staged through shared memory, no copy/compute overlap).

#include "flash_bwd_tile.cuh"

extern "C" int irt_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, int B, int H, int Sq, int Skv, int D,
                                     float qscale, float scale, void* stream) {
  if (D == 64)
    return (int)irt::launch_bwd_dq<64, 64, 64, 4>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv,
                                                  qscale, scale, stream);
  if (D == 512)
    return (int)irt::launch_bwd_dq<512, 32, 64, 8>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv,
                                                   qscale, scale, stream);
  return (int)cudaErrorInvalidValue;
}
