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
// The key chunk is the caller's: 128 or 64 at d=64, the last chunk cut at
// Skv (a shared attention's divides its segment length where 64 does, so
// that none straddles two segments), the tile's 32 at d=512.
//
// What bounds it on the H100: tensor-core operations and exp2 alike at d=64,
// tensor-core operations at d=512, as flash_online.cu (the LSE adds 4 bytes
// per query row), and it runs on the same tiles with Policy::kOnline: at d=64
// the plain layout of attn_wgmma.cuh, at d=512 attn_wgmma_d512.cuh; both
// epilogues write the LSE from the running max and the row sum already in
// registers.

#include "attn_wgmma.cuh"
#include "attn_wgmma_d512.cuh"

extern "C" int irt_flash_fwd_lse_bf16(const void* q, const void* k, const void* v, void* out,
                                      void* lse, int B, int H, int Sq, int Skv, int D,
                                      int block_k, float qscale, void* stream) {
  using irt::wg::Policy;
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  const irt::wg::Problem pr =
      irt::wg::make_flash_problem(q, k, v, out, lse, B, H, Sq, Skv, qscale);
  if (D == 64) return (int)irt::wg::launch_flash<Policy::kOnline>(pr, block_k, stream);
  if (D == 512) return (int)irt::wg512::launch_flash_d512<Policy::kOnline>(pr, block_k, stream);
  return (int)cudaErrorInvalidValue;
}
