// flash_online: softmax(q k^T * scale) v with a running row max, the
// algorithm INSTANTRESTORE_FLASH_ALGO=online selects for every plain
// self-attention of the serving path (UNet down/mid attn1 and the capture
// pass's up-block attn1 at d=64, the VAE mid-block attention at d=512, one
// head, 4096 tokens).
//
// Replaces the TPU kernel instantrestore_tpu/ops/shared_attention.py:
// _flash_kernel (launched by flash_attention under algo != "bound"). Same
// numerics: q pre-scaled in bf16 by bf16(scale * log2 e), scores in fp32
// log2 units, per key tile m_new = max(m, rowmax(s)) from m = -1e30,
// alpha = exp2(m - m_new) on the row sum and the fp32 accumulator. d < 128:
// p = exp2(bf16(s - m_new)) rounded to bf16, row sum over the rounded p (the
// TPU kernel's ones column). d >= 128: p = exp2(s - m_new) in fp32, row sum
// over the fp32 p, only the product's operand rounded. out = acc / l in bf16.
// The key tile is 64 wide where the TPU kernel's is 1024 or 512; the running
// maxima differ per tile, which shows at bf16 rounding level only.
//
// What bounds it on the H100: tensor-core operations, as flash_bound.cu (the
// same products on the same bytes, no kmax): a 64^2 UNet layer at batch 16 is
// 0.34 TFLOP for 0.08 GB, the VAE mid attention 0.55 TFLOP for 0.27 GB. On
// top of the bound kernel's work each tile takes a row max over the scores
// and one multiply of every accumulator element by its row's alpha. This is
// the simple correct tile of attn_tile.cuh (WMMA mma.sync, scores staged
// through shared memory, no copy/compute overlap); at d=512 the alpha
// fragment reaches each of the 8 warps' channel slabs.

#include "attn_tile.cuh"

extern "C" int irt_flash_online_bf16(const void* q, const void* k, const void* v, void* out,
                                     int B, int H, int Sq, int Skv, int D, float qscale,
                                     void* stream) {
  using irt::Mode;
  if (D == 64)
    return (int)irt::launch_attn<Mode::kFlashOnline, 64, 64, 64, 4>(
        q, k, v, nullptr, out, B, H, Sq, Skv, qscale, stream);
  if (D == 512)
    return (int)irt::launch_attn<Mode::kFlashOnline, 512, 32, 64, 8>(
        q, k, v, nullptr, out, B, H, Sq, Skv, qscale, stream);
  return (int)cudaErrorInvalidValue;
}
