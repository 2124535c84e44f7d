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
//   * d = 512 (the VAE mid attention): the mma.sync tile of
//     flash_bwd_tile.cuh, 32 query rows in 8 warps, 64-key chunks.

#include "attn_wgmma_bwd.cuh"
#include "flash_bwd_tile.cuh"

extern "C" int irt_flash_bwd_dq_bf16(const void* q, const void* qs, const void* k,
                                     const void* v, const void* dout, const void* lse,
                                     const void* delta, void* dq, int B, int H, int Sq, int Skv,
                                     int D, int rows, int chunk, float qscale, float scale,
                                     void* stream) {
  using bf16 = __nv_bfloat16;
  if (D == 64) {
    irt::wgb::BwdProblem pr{};
    pr.q = static_cast<const bf16*>(q);
    pr.qs = static_cast<const bf16*>(qs);
    pr.k = static_cast<const bf16*>(k);
    pr.v = static_cast<const bf16*>(v);
    pr.dout = static_cast<const bf16*>(dout);
    pr.lse = static_cast<const float*>(lse);
    pr.delta = static_cast<const float*>(delta);
    pr.dq = static_cast<bf16*>(dq);
    pr.B = B, pr.H = H, pr.Sq = Sq, pr.Skv = Skv, pr.scale = scale;
    return (int)irt::wgb::launch_dq(pr, rows, chunk, stream);
  }
  if (D == 512 && rows == 32 && chunk == 64)
    return (int)irt::launch_bwd_dq<512, 32, 64, 8>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv,
                                                   qscale, scale, stream);
  return (int)cudaErrorInvalidValue;
}
