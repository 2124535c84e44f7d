// flash_attention_bound: softmax(q k^T * scale) v with the per-(b, h)
// key-norm bound, for every plain self-attention of the serving path (UNet
// down/mid attn1 and the capture pass's up-block attn1 at d=64, and the VAE
// mid-block attention at d=512, one head, 4096 tokens).
//
// Replaces the TPU kernel instantrestore_tpu/ops/shared_attention.py:
// _flash_bound_kernel (launched by _flash_attention_bound). Same numerics:
// q pre-scaled in bf16 by bf16(scale * log2 e), scores in fp32 log2 units,
// p = exp2(s - bound) rounded to bf16 for the P V product, row sum over the
// rounded p (the TPU kernel's ones-column / VPU sum), fp32 accumulator,
// out = acc / l in bf16. kmax comes from the wrapper (torch), as the TPU
// wrapper computed it in XLA.
//
// What bounds it on the H100: tensor-core operations. A 64^2 UNet layer at
// batch 16 is 4 * B * H * S^2 * d = 0.34 TFLOP (0.35 ms at 989 TFLOP/s) for
// 0.08 GB of q/k/v/out; the VAE mid attention is 0.55 TFLOP for 0.27 GB.
// This first kernel is the simple correct tile of attn_tile.cuh (WMMA
// mma.sync, fp32 scores staged through shared memory, no copy/compute
// overlap); it does not approach that bound. d=512 splits the 32x512 fp32
// accumulator across 8 warps by channel slabs (see attn_tile.cuh).

#include "attn_tile.cuh"

extern "C" int irt_flash_bound_bf16(const void* q, const void* k, const void* v,
                                    const void* kmax, void* out, int B, int H, int Sq,
                                    int Skv, int D, float qscale, void* stream) {
  using irt::Mode;
  if (D == 64)
    return (int)irt::launch_attn<Mode::kFlash, 64, 64, 64, 4>(
        q, k, v, kmax, out, B, H, Sq, Skv, qscale, stream);
  if (D == 512)
    return (int)irt::launch_attn<Mode::kFlash, 512, 32, 64, 8>(
        q, k, v, kmax, out, B, H, Sq, Skv, qscale, stream);
  return (int)cudaErrorInvalidValue;
}
