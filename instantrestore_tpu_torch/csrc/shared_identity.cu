// shared_identity_attention: refs-only shared-image attention of the 9
// up-block self-attentions in a warm-identity restore,
//     out = softmax(q K^T * scale) (V * a + c)
// over the N*S reference keys of identity ids[b], read straight from the
// identity cache [I, N, H, S, d] (each block reads ids[b] itself; no gather
// copy), with the AdaIN affine (a, c) per (sample, head, reference, channel)
// applied to V tiles after they arrive. The per-call paired route
// (INSTANTRESTORE_ATTN_ALGO=kv_outer_bound_paired) runs it on per-call
// references with ids = arange(B).
//
// Replaces the TPU kernel instantrestore_tpu/ops/shared_attention.py:
// _shared_kvouter_bound_paired_kernel (launched by shared_attention_identity,
// paired branch, and by the kv_outer_bound_paired route). Same numerics: q
// pre-scaled in bf16, bound = ||q_scaled|| * kmax[ids[b], h] - 64, p =
// exp2(s - bound) in fp32 summed in fp32, bf16(p) times bf16(v * a + c) (a, c
// fp32) into an fp32 accumulator. The TPU kernel's block-diagonal pairing of
// reference segments (_pack_segment_pairs) only filled the TPU's 128-lane
// matrix unit at d=64; this cache keeps the raw layout.
//
// What bounds it on the H100: tensor-core operations and exp2 alike. The 64^2
// layer at batch 16 (H=5, Sq=4096, 16,384 keys) is 1.37 TFLOP (1.39 ms at 989
// TFLOP/s) and 5.4 G exp2 (1.3 ms at 16 per clock per SM) for 0.3 GB of K/V
// reads, so the two must overlap. It runs on the wgmma + TMA tile of
// attn_wgmma.cuh (Policy::kIdentity): both products on wgmma.mma_async with S,
// P and O in registers, K/V by TMA (cp.async.bulk.tensor) into a ring behind
// mbarriers, the affine as an in-place pass of three spare warps, the softmax
// of one key tile under the products of the previous one. Against the online
// kernels it keeps no running max and no rescale: the bound comes from the Q
// fragments once, and the fp32 row sum is a register sum in the softmax pass
// (no ones product: the sum is over the unrounded p).

#include "attn_wgmma.cuh"

// q, out [B, H, Sq, D]; rk/rv [I, N, H, S, D]; kmax [I, H] fp32; aff
// [B, H, N, 2, D] fp32; ids [B] int32 rows of rk/rv.
extern "C" int irt_shared_identity_bf16(const void* q, const void* rk, const void* rv,
                                        const void* kmax, const void* aff, const void* ids,
                                        void* out, int B, int H, int Sq, int S, int N,
                                        int I, int D, float qscale, void* stream) {
  using irt::wg::Policy;
  if (D == 64)
    return (int)irt::wg::launch_shared<Policy::kIdentity, false>(
        irt::wg::make_problem(q, nullptr, nullptr, rk, rv, aff, kmax, ids, out, B, H, Sq, S, N,
                              I, 0, qscale),
        stream);
  return (int)cudaErrorInvalidValue;
}
