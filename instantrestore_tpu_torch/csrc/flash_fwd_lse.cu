// flash_fwd_lse: softmax(q k^T * scale) v with a running row max, plus the
// log-sum-exp of every row: the forward of the differentiable attention
// (ops/flash_vjp.py). A training step runs it for every fused self-attention
// with a gradient: the restoration UNet's down/mid attn1 (d=64), its 9 shared
// up-block attentions on K/V widened over the references (Sq tokens against
// N * Sq keys), and the VAE mid-block attention (d=512, one head, 4096
// tokens).
//
// Replaces the TPU kernel instantrestore_tpu/ops/flash_vjp.py:
// _fwd_lse_kernel. Same numerics as flash_online.cu (q pre-scaled in bf16 by
// bf16(scale * log2 e), fp32 scores in log2 units, m from -1e30, alpha on the
// row sum and the accumulator; d < 128: p = exp2(bf16(s - m_new)) and the row
// sum over the rounded p, which is what the TPU kernel's ones column sums;
// d >= 128: fp32 p for the sum, bf16 for the product), and one more output,
// lse2 = m + log2(row sum), fp32 [B, H, Sq]. The TPU kernel stores it
// broadcast over 128 lanes; that is its tiling, not part of the function.
//
// What bounds it on the H100: tensor-core operations, as flash_online.cu
// (the LSE adds 4 bytes per query row). This is the simple correct tile of
// attn_tile.cuh (Mode::kFlashLse).

#include "attn_tile.cuh"

extern "C" int irt_flash_fwd_lse_bf16(const void* q, const void* k, const void* v, void* out,
                                      void* lse, int B, int H, int Sq, int Skv, int D,
                                      float qscale, void* stream) {
  using irt::Mode;
  if (D == 64)
    return (int)irt::launch_attn<Mode::kFlashLse, 64, 64, 64, 4>(
        q, k, v, nullptr, out, B, H, Sq, Skv, qscale, stream, lse);
  if (D == 512)
    return (int)irt::launch_attn<Mode::kFlashLse, 512, 32, 64, 8>(
        q, k, v, nullptr, out, B, H, Sq, Skv, qscale, stream, lse);
  return (int)cudaErrorInvalidValue;
}
