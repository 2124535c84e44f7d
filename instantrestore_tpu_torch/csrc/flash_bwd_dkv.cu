// flash_bwd_dkv: the key and value gradients of softmax(q k^T * scale) v,
// with the probabilities recomputed from the forward's log-sum-exp:
//     dV = sum_i bf16(P_i)^T dO_i,
//     dK = sum_i bf16(scale * P_i * (dO_i v^T - delta_i))^T q_i,
//     P = exp2(bf16(q * bf16(scale * log2 e)) k^T - lse2)
// (fp32 scores and P, two fp32 accumulators [BK, d], bf16 out). A training
// step runs it once for every fused self-attention with a gradient, at the
// shapes of flash_fwd_lse.cu.
//
// Replaces the TPU kernel instantrestore_tpu/ops/flash_vjp.py:
// _bwd_dkv_kernel. KV-outer as there: a block owns 64 keys (32 at d=512),
// keeps both accumulators in registers and streams query tiles with their
// lse2 and delta; the transposed scores k qs^T come from column-major WMMA
// loads of the query tile. No atomics: a key's gradient is summed by one
// block in query order, so it repeats bit for bit.
//
// What bounds it on the H100: tensor-core operations, 8 * B * H * Sq * Skv * d
// (four products) on q, k, v, dO read and dK, dV written once. This is the
// simple correct tile of flash_bwd_tile.cuh; at d=512 the two [32, 512]
// accumulators take 128 registers of each of the 256 threads.

#include "flash_bwd_tile.cuh"

extern "C" int irt_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int B, int H, int Sq, int Skv, int D,
                                      float qscale, float scale, void* stream) {
  if (D == 64)
    return (int)irt::launch_bwd_dkv<64, 64, 64, 4>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq,
                                                   Skv, qscale, scale, stream);
  if (D == 512)
    return (int)irt::launch_bwd_dkv<512, 32, 32, 8>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq,
                                                    Skv, qscale, scale, stream);
  return (int)cudaErrorInvalidValue;
}
