// flash_attention_bound: softmax(q k^T * scale) v with the per-(b, h)
// key-norm bound, for every plain self-attention of the serving path (UNet
// down/mid attn1 and the capture pass's up-block attn1 at d=64, and the VAE
// mid-block attention at d=512, one head, 4096 tokens).
//
// Replaces the TPU kernel instantrestore_tpu/ops/shared_attention.py:
// _flash_bound_kernel (launched by _flash_attention_bound). Same numerics:
// q pre-scaled in bf16 by bf16(scale * log2 e), scores in fp32 log2 units,
// bound = ||q|| (unscaled, fp32) * scale * log2 e * kmax[b, h] - 64, p =
// exp2(s - bound) rounded to bf16 for the P V product, row sum over the
// rounded p (the TPU kernel's ones column at d < 128, its sum of the bf16 p at
// d >= 128), fp32 accumulator, out = acc / l in bf16. kmax comes from the
// wrapper (torch), as the TPU wrapper computed it in XLA. No running max: the
// result depends on the key chunk through fp32 summation order only.
//
// What bounds it on the H100: tensor-core operations. A 64^2 UNet layer at
// batch 16 is 4 * B * H * S^2 * d = 0.34 TFLOP (0.35 ms at 989 TFLOP/s) for
// 0.08 GB of q/k/v/out, with as many exp2 as scores (1.3 G, 0.32 ms at 16 per
// clock per SM); the VAE mid attention is 0.55 TFLOP for 0.27 GB. Both widths
// run on wgmma + TMA tiles designed for Hopper:
//   * d = 64: the plain layout of attn_wgmma.cuh (Layout::kPlain,
//     Policy::kBound): Q fragments in registers, the bound from their norms,
//     both products on wgmma with S, P, l and O in registers, K/V by TMA into
//     a 4-stage ring, the softmax of one chunk under the previous chunk's P V;
//     128 query rows a block where they divide Sq, else 64; the caller's key
//     chunk of 128 or 64.
//   * d = 512: attn_wgmma_d512.cuh: two consumer warpgroups on 64 query rows,
//     256 output channels each, Q in shared memory as the A operand, K and V
//     as eight 64-channel TMA slabs in rings of two 32-key stages. Both
//     warpgroups need the whole S: each computes it over its own 256
//     channels and the two add their parts through shared memory.

#include "attn_wgmma.cuh"
#include "attn_wgmma_d512.cuh"

extern "C" int irt_flash_bound_bf16(const void* q, const void* k, const void* v,
                                    const void* kmax, void* out, int B, int H, int Sq, int Skv,
                                    int D, int block_k, float qscale, void* stream) {
  using irt::wg::Policy;
  if (kmax == nullptr) return (int)cudaErrorInvalidValue;
  const irt::wg::Problem pr =
      irt::wg::make_flash_problem(q, k, v, out, nullptr, B, H, Sq, Skv, qscale, kmax);
  if (D == 64) return (int)irt::wg::launch_flash<Policy::kBound>(pr, block_k, stream);
  if (D == 512) return (int)irt::wg512::launch_flash_d512<Policy::kBound>(pr, block_k, stream);
  return (int)cudaErrorInvalidValue;
}
