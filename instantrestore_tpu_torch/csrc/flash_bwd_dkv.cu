// flash_bwd_dkv: the key and value gradients of softmax(q k^T * scale) v,
// with the probabilities recomputed from the forward's log-sum-exp:
//     dV = sum_i bf16(P_i)^T dO_i,
//     dK = sum_i bf16(scale * P_i * (dO_i v^T - delta_i))^T q_i,
//     P = exp2(qs k^T - lse2),   qs = bf16(q * bf16(scale * log2 e))
// (fp32 scores and P, two fp32 accumulators, bf16 out). A training step runs
// it once for every fused self-attention with a gradient, at the shapes of
// flash_fwd_lse.cu.
//
// Replaces the TPU kernel instantrestore_tpu/ops/flash_vjp.py:
// _bwd_dkv_kernel. KV-outer as there: a block owns the caller's keys of one
// (batch, head), keeps both accumulators in registers and streams the queries
// in chunks with their lse2 and delta. No atomics: a key's gradient is summed
// by one warpgroup in query order, so it repeats bit for bit.
//
// What bounds it on the H100: tensor-core operations, 8 * B * H * Sq * Skv * d
// (four products) on q, k, v, dO read and dK, dV written once. The two widths
// run on two tiles:
//   * d = 64: the wgmma + TMA tile of attn_wgmma_bwd.cuh. A consumer
//     warpgroup keeps its 64 keys of K and V as the A fragments of the
//     transposed scores S^T = K qs^T and dP^T = V dO^T, so P^T and dS^T come
//     out of the accumulators already as the A fragments of dV += P^T dO and
//     dK += dS^T q; those read the dO and q tiles MN-major (the dO tile is
//     the one dP^T read K-major: two descriptors, one copy). lse2 and delta
//     index the columns here: each query tile's 64 of each arrive by a bulk
//     copy on the tile's own barrier and each thread reads its columns' pairs.
//     qs, q and dO arrive by TMA in a 4-stage ring; the next chunk's score
//     products run under this chunk's gradient products. 128 keys a block (two
//     consumer warpgroups) where they divide Skv, else 64; 64-query chunks.
//     qs comes from the caller. Any Sq and Skv: query rows past Sq arrive as
//     zeros with the caller's zero-padded lse2 and delta (pitch lse_pitch)
//     and add exact zeros; keys past Skv are neither read nor written.
//   * d = 512 (the VAE mid attention): the wgmma + TMA tile of
//     attn_wgmma_bwd_d512.cuh, in two launches, dV and then dK: a block's dK
//     and dV at 64 keys would be the SM's whole register file. A block owns
//     64 keys (K, and for dK also V, in shared memory as the A operands of the
//     transposed scores) and streams 16-query chunks of qs, dO (and q) by
//     TMA; each consumer warpgroup accumulates 256 channels. Sq % 64 == 0 and
//     Skv % 32 == 0, the d = 512 forward's shapes.

#include "attn_wgmma_bwd.cuh"
#include "attn_wgmma_bwd_d512.cuh"

extern "C" int irt_flash_bwd_dkv_bf16(const void* q, const void* qs, const void* k,
                                      const void* v, const void* dout, const void* lse,
                                      const void* delta, void* dk, void* dv, int B, int H, int Sq,
                                      int Skv, int D, int rows, int chunk, int lse_pitch,
                                      float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  irt::wgb::BwdProblem pr{};
  pr.q = static_cast<const bf16*>(q);
  pr.qs = static_cast<const bf16*>(qs);
  pr.k = static_cast<const bf16*>(k);
  pr.v = static_cast<const bf16*>(v);
  pr.dout = static_cast<const bf16*>(dout);
  pr.lse = static_cast<const float*>(lse);
  pr.delta = static_cast<const float*>(delta);
  pr.dk = static_cast<bf16*>(dk);
  pr.dv = static_cast<bf16*>(dv);
  pr.B = B, pr.H = H, pr.Sq = Sq, pr.Skv = Skv, pr.scale = scale, pr.lse_pitch = lse_pitch;
  if (D == 64) return (int)irt::wgb::launch_dkv(pr, rows, chunk, stream);
  if (D == 512) return (int)irt::wgb512::launch_dkv(pr, rows, chunk, stream);
  return (int)cudaErrorInvalidValue;
}
