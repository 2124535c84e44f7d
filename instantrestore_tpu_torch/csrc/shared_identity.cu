// shared_identity_attention: refs-only shared-image attention of the 9
// up-block self-attentions in a warm-identity restore,
//     out = softmax(q K^T * scale) (V * a + c)
// over the N*S reference keys of identity ids[b], read straight from the
// identity cache [I, N, H, S, d] (each block reads ids[b] itself; no gather
// copy), with the AdaIN affine (a, c) per (sample, head, reference, channel)
// applied to V tiles as they load.
//
// Replaces the TPU kernel instantrestore_tpu/ops/shared_attention.py:
// _shared_kvouter_bound_paired_kernel (launched by shared_attention_identity,
// paired branch). Same numerics: q pre-scaled in bf16, bound = ||q_scaled|| *
// kmax - 64, p = exp2(s - bound) in fp32 summed in fp32, bf16(p) times
// bf16(v * a + c) into an fp32 accumulator. The TPU kernel's block-diagonal
// pairing of reference segments (_pack_segment_pairs) only filled the TPU's
// 128-lane matrix unit at d=64; this cache keeps the raw layout.
//
// What bounds it on the H100: tensor-core operations and exp2. The 64^2
// layer at batch 16 (H=5, Sq=4096, 16,384 keys) is 1.37 TFLOP (1.4 ms at
// 989 TFLOP/s) and 5.4 G exp2 on the SFUs, for 0.3 GB of K/V reads. This
// first kernel is the simple correct tile of attn_tile.cuh (WMMA mma.sync,
// scores staged through shared memory, no copy/compute overlap); making it
// approach that bound (wgmma, TMA, exp2 overlapped with the products) is
// later work.

#include "attn_tile.cuh"

extern "C" int irt_shared_identity_bf16(const void* q, const void* rk, const void* rv,
                                        const void* kmax, const void* aff, const void* ids,
                                        void* out, int B, int H, int Sq, int S, int N,
                                        int I, int D, float qscale, void* stream) {
  using irt::Mode;
  if (D == 64)
    return (int)irt::launch_attn<Mode::kIdentity, 64, 64, 64, 4>(
        q, nullptr, nullptr, rk, rv, kmax, aff, ids, out, B, H, Sq, S, N, I, 0, qscale, stream);
  return (int)cudaErrorInvalidValue;
}
