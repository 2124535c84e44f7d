// flash_bwd_dq: the query gradient of softmax(q k^T * scale) v, with the
// probabilities recomputed from the forward's log-sum-exp:
//     dQ = sum_j bf16(scale * P_j * (dO v_j^T - delta)) k_j,
//     P = exp2(qs k^T - lse2),   qs = bf16(q * bf16(scale * log2 e))
// (fp32 scores and P, fp32 accumulator, bf16 out). A training step runs it
// once for every fused self-attention with a gradient, at the shapes of
// flash_fwd_lse.cu.
//
// Replaces the TPU kernel instantrestore_tpu/ops/flash_vjp.py:
// _bwd_dq_kernel. Q-outer like the forward: a block owns the caller's rows of
// one (batch, head) and streams the keys in chunks.
//
// What bounds it on the H100: tensor-core operations, 6 * B * H * Sq * Skv * d
// (three products) on q, k, v, dO, dQ read or written once: the shared 64^2
// layer of a batch-2 step (H=5, 4096 queries, 16384 keys) is 0.26 TFLOP for
// 32 MB. The two widths run on two tiles:
//   * d = 64: the wgmma + TMA tile of attn_wgmma_bwd.cuh. A consumer
//     warpgroup keeps its 64 query rows of qs and dO as the A fragments of S =
//     qs K^T and dP = dO V^T, forms P and dS on the accumulator fragments and
//     packs dS straight into the A fragments of dQ += dS K, whose B is the
//     same swizzled K tile read MN-major; K and V arrive by TMA in a 4-stage
//     ring, and the next chunk's score products run under this chunk's dQ
//     product. 128 query rows a block (two consumer warpgroups) where they
//     divide Sq, else 64; 64-key chunks. qs comes from the caller.
//     Any Sq and Skv: keys past Skv are masked out of P, query rows past Sq
//     neither read nor written.
//   * d = 512 (the VAE mid attention): the wgmma + TMA tile of
//     attn_wgmma_bwd_d512.cuh. A block owns 64 query rows; qs and dO live in
//     shared memory as the A operands of S and dP, one consumer warpgroup
//     each over all 512 channels, the two exchange their results through
//     shared memory and each accumulates 256 channels of dQ += dS K in
//     registers; 16-key chunks of K and V by TMA. Sq % 64 == 0 and Skv % 32
//     == 0, the d = 512 forward's shapes.

#include "attn_wgmma_bwd.cuh"
#include "attn_wgmma_bwd_d512.cuh"

extern "C" int irt_flash_bwd_dq_bf16(const void* q, const void* qs, const void* k,
                                     const void* v, const void* dout, const void* lse,
                                     const void* delta, void* dq, int B, int H, int Sq, int Skv,
                                     int D, int rows, int chunk, int lse_pitch, float scale,
                                     void* stream) {
  using bf16 = __nv_bfloat16;
  irt::wgb::BwdProblem pr{};
  pr.q = static_cast<const bf16*>(q);
  pr.qs = static_cast<const bf16*>(qs);
  pr.k = static_cast<const bf16*>(k);
  pr.v = static_cast<const bf16*>(v);
  pr.dout = static_cast<const bf16*>(dout);
  pr.lse = static_cast<const float*>(lse);
  pr.delta = static_cast<const float*>(delta);
  pr.dq = static_cast<bf16*>(dq);
  pr.B = B, pr.H = H, pr.Sq = Sq, pr.Skv = Skv, pr.scale = scale, pr.lse_pitch = lse_pitch;
  if (D == 64) return (int)irt::wgb::launch_dq(pr, rows, chunk, stream);
  if (D == 512) return (int)irt::wgb512::launch_dq(pr, rows, chunk, stream);
  return (int)cudaErrorInvalidValue;
}
