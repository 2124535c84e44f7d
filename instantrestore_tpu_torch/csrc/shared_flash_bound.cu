// shared_flash_bound: shared-image attention over [input |] N references,
//     out = softmax(q [K_in | K_1 .. K_N]^T * scale) [V_in | V_1 a_1 + c_1 ..]
// for the 9 up-block self-attentions of a cold restore (references captured
// in the same call, [B, N, H, S, d], row = b), of a warm restore of a
// train_input model (the per-call gather of the identity cache, with the
// input segment) and of the identity cache at odd N (row = ids[b], read
// straight from the cache [I, N, H, S, d]). The AdaIN affine (a, c) per
// (sample, head, reference, channel) applies to reference V tiles after they
// arrive; the input segment takes raw v_in.
//
// Replaces the TPU kernel instantrestore_tpu/ops/shared_attention.py:
// _shared_kvouter_bound_kernel (launched by _shared_flash_attention_kvouter_bound
// and by the unpaired branch of shared_attention_identity). Same numerics:
// q pre-scaled in bf16, bound = ||q|| (unscaled, fp32) * scale * log2 e *
// kmax - 64 with kmax over every key the row sees (input and references;
// zeroed invalid references count as norm 0 and still take their exp2(-bound)
// share of the mass), p = exp2(s - bound) in fp32 rounded to bf16, row sum
// over the rounded p (the TPU kernel's ones column of v_pad), scale and
// shift rounded to bf16 and v * a + c rounded once from fp32 (the TPU kernel
// rounds the product and the sum, at most 1 bf16 ulp of the value apart),
// fp32 accumulator, out = acc / l in bf16.
//
// What bounds it on the H100: tensor-core operations and exp2 alike. The 64^2
// layer of a batch-16 cold restore (H=5, Sq=4096, 4 x 4096 reference keys) is
// 1.37 TFLOP (1.39 ms at 989 TFLOP/s) and 5.4 G exp2 (1.3 ms at 16 per clock
// per SM) for 0.4 GB of q/K/V/out; with the input segment, 1.72 TFLOP. It runs
// on the wgmma + TMA tile of attn_wgmma.cuh (Policy::kBound): both products on
// wgmma.mma_async with S, P and O in registers, K/V by TMA
// (cp.async.bulk.tensor) into a ring behind mbarriers, the affine as an
// in-place pass of three spare warps, the row sums of the rounded P as a product
// with a block of ones (the TPU kernel's ones column), the softmax of one key
// tile under the products of the previous one. Against shared_online.cu it
// keeps no running max and no rescale: each row's bound comes from the Q
// fragments once.

#include "attn_wgmma.cuh"

// q, out [B, H, Sq, D]; k_in/v_in [B, H, S, D] (read only when n_in == 1,
// else may be null); rk/rv [I, N, H, S, D]; kmax [B, H] fp32; aff
// [B, H, N, 2, D] fp32; ids [B] int32 rows of rk/rv, or null for row = b
// (then I == B).
extern "C" int irt_shared_flash_bound_bf16(const void* q, const void* k_in, const void* v_in,
                                           const void* rk, const void* rv, const void* kmax,
                                           const void* aff, const void* ids, void* out, int B,
                                           int H, int Sq, int S, int N, int I, int n_in, int D,
                                           float qscale, void* stream) {
  using irt::wg::Policy;
  if (D == 64)
    return (int)irt::wg::launch_shared<Policy::kBound, false>(
        irt::wg::make_problem(q, k_in, v_in, rk, rv, aff, kmax, ids, out, B, H, Sq, S, N, I,
                              n_in, qscale),
        stream);
  return (int)cudaErrorInvalidValue;
}
