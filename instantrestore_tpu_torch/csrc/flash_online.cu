// flash_online: softmax(q k^T * scale) v with a running row max, the
// algorithm INSTANTRESTORE_FLASH_ALGO=online selects for every plain
// self-attention of the serving path (UNet down/mid attn1 and the capture
// pass's up-block attn1 at d=64, the VAE mid-block attention at d=512, one
// head, 4096 tokens).
//
// Replaces the TPU kernel instantrestore_tpu/ops/shared_attention.py:
// _flash_kernel (launched by flash_attention under algo != "bound"). Same
// numerics: q pre-scaled in bf16 by bf16(scale * log2 e), scores in fp32
// log2 units, per key chunk m_new = max(m, rowmax(s)) from m = -1e30,
// alpha = exp2(m - m_new) on the row sum and the fp32 accumulator. d < 128:
// p = exp2(bf16(s - m_new)) rounded to bf16, row sum over the rounded p (the
// TPU kernel's ones column). d >= 128: p = exp2(s - m_new) in fp32, row sum
// over the fp32 p, only the product's operand rounded. out = acc / l in bf16.
// The key chunk is the caller's (ops/shared_attention.py,
// flash_online_chunk: at d=64 128 where it divides Skv, 64 where that does,
// else 128 (all Skv where fewer) with a ragged last chunk; at d=512 the tile's
// 32) where the TPU kernel's is 1024 or 512; the running maxima differ per
// chunk, which shows at bf16 rounding level only.
//
// What bounds it on the H100: tensor-core operations and exp2 alike at d=64
// (a 64^2 UNet layer at batch 16 is 0.34 TFLOP, 0.35 ms at 989 TFLOP/s, and
// 1.3 G exp2, 0.32 ms at 16 per clock per SM, for 0.08 GB), tensor-core
// operations at d=512 (0.55 TFLOP for 0.27 GB). Both widths run on wgmma +
// TMA tiles designed for Hopper, with Policy::kOnline:
//   * d = 64: the plain layout of attn_wgmma.cuh (Layout::kPlain): both
//     products on wgmma with S, P, alpha, l and O in registers, K/V by TMA
//     into a 4-stage ring, the softmax of one chunk under the previous
//     chunk's P V, 128 query rows a block where they divide Sq, else 64.
//   * d = 512: attn_wgmma_d512.cuh: a 64 x 512 fp32 accumulator does not fit
//     one warpgroup's registers, so two consumer warpgroups share 64 query
//     rows, 256 output channels each, and add their partial S through shared
//     memory; Q in shared memory as the A operand, K and V as eight
//     64-channel TMA slabs in rings of two 32-key stages; the running max
//     once per 32-key tile, O rescaled by alpha in registers after each P V.

#include "attn_wgmma.cuh"
#include "attn_wgmma_d512.cuh"

extern "C" int irt_flash_online_bf16(const void* q, const void* k, const void* v, void* out,
                                     int B, int H, int Sq, int Skv, int D, int block_k,
                                     float qscale, void* stream) {
  using irt::wg::Policy;
  const irt::wg::Problem pr =
      irt::wg::make_flash_problem(q, k, v, out, nullptr, B, H, Sq, Skv, qscale);
  if (D == 64) return (int)irt::wg::launch_flash<Policy::kOnline>(pr, block_k, stream);
  if (D == 512) return (int)irt::wg512::launch_flash_d512<Policy::kOnline>(pr, block_k, stream);
  return (int)cudaErrorInvalidValue;
}
