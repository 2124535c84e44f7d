"""Fused attention of the serving paths: plain flash attention and the
shared-image attention over reference K/V, each with the bound softmax and
with the online (running-max) softmax (counterpart of
``instantrestore_tpu/ops/shared_attention.py``).

Each kernel comes as a wrapper, a plain PyTorch version of the same function
and a launch count:

* ``flash_attention`` -> CUDA kernel ``csrc/flash_bound.cu`` (replaces the
  TPU kernel ``_flash_bound_kernel``); plain version ``flash_attention_plain``.
* ``shared_identity`` -> ``csrc/shared_identity.cu`` (replaces
  ``_shared_kvouter_bound_paired_kernel``); plain ``shared_identity_plain``.
* ``shared_flash_bound`` -> ``csrc/shared_flash_bound.cu`` (replaces
  ``_shared_kvouter_bound_kernel``); plain ``shared_flash_bound_plain``.
* ``flash_online`` -> ``csrc/flash_online.cu`` (replaces ``_flash_kernel``);
  plain ``flash_online_plain``.
* ``shared_online`` -> ``csrc/shared_online.cu`` (replaces
  ``_shared_kvouter_kernel`` and serves ``_shared_kernel``'s algorithm too:
  the KV-outer and Q-outer grids of the TPU are one work assignment on the
  card); plain ``shared_online_plain``.
* ``shared_online_pair`` -> ``csrc/shared_online_pair.cu`` (replaces
  ``_shared_kvouter_packed_kernel``: one thread block per head pair); plain
  ``shared_online_pair_plain``.

Which algorithm runs which, read from the environment at each call as in the
JAX package: ``INSTANTRESTORE_FLASH_ALGO`` = ``bound`` (default) runs
``flash_attention``'s own kernel, any other value (``online``) runs
``flash_online``. ``INSTANTRESTORE_ATTN_ALGO`` = ``kv_outer_bound`` (default)
runs ``shared_flash_bound``; ``kv_outer_bound_paired`` runs
``shared_identity`` on refs-only calls with even N, else the default;
``kv_outer_packed`` runs ``shared_online_pair`` at d <= 64 and even H, else
``shared_online``; ``kv_outer``, ``q_outer`` and every other string run
``shared_online``. ``shared_flash_attention`` (per-call reference K/V: cold
restore, the Predictor, ``train_input`` models) takes the algorithm;
``shared_attention_identity`` (an onboarded identity cache) takes none and
always runs a bound kernel, as in the JAX package.

A wrapper given CUDA tensors launches its kernel (bf16 only) on their card or
raises; given CPU tensors it runs the plain version. Every launch goes
through ``_build.launch``, which makes the tensors' card the current one for
the C launcher. ``<wrapper>.launches`` counts kernel launches and nothing else.

Numerics (shared with the JAX package): logits in log2 units, q pre-scaled
by ``scale * log2 e`` in the input dtype, fp32 scores and accumulator, P @ V
in the input dtype. The bound kernels keep no running max but the
Cauchy-Schwarz bound ``||q_i|| * scale * log2 e * max_j ||k_j|| - 64``
(``BOUND_EXP_SHIFT``), and only they can lose a row: it comes out NaN when
its bound slack exceeds ~190 log2 units. The online kernels keep a running
max per row (from the finite ``NEG_INF``), rescale the row sum and the
accumulator by ``exp2(m - m_new)`` per key chunk, and cannot: they are the
way out for such weights. Their result depends on the key chunk at bf16
rounding level (the running max differs per chunk). The four shared kernels,
bound and online, and ``flash_online`` and ``flash_attention`` at d = 64 run
on the wgmma + TMA tile of ``csrc/attn_wgmma.cuh``, whose chunk is
``key_tile`` of the segment length (``flash_online``, ``flash_attention``:
Skv): ``SHARED_ONLINE_BLOCK_K`` keys where that divides it,
``ONLINE_BLOCK_K`` where that does, else a ragged last chunk of the segment
(``shared_online_tile``, ``flash_online_chunk``, ``flash_bound_chunk``; the
bound kernels' result depends on it through the order of fp32 sums only).
They take every Sq and segment length, as the JAX kernels do: keys past a
segment's end are masked out of the softmax and query rows past Sq are
neither read nor written. ``flash_attention`` and ``flash_online`` at d =
512 run on the wgmma + TMA tile of ``csrc/attn_wgmma_d512.cuh``, whose chunk
is its ``D512_BLOCK_K`` keys (the running max once per such tile). The
online plain versions take the chunk as ``block_k`` and default to their
kernel's; the bound plain versions take the keys in one product. The TPU
tile knobs ``INSTANTRESTORE_BLOCK_K`` / ``INSTANTRESTORE_BLOCK_Q`` are not
read.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import List, NamedTuple, Optional, Tuple

import torch

from instantrestore_tpu_torch.ops import _build

LOG2E = 1.4426950408889634
BOUND_EXP_SHIFT = 64.0
NEG_INF = -1e30  # the online kernels' starting max: finite, so exp2(m - m_new) is never NaN
ONLINE_BLOCK_K = 64  # key chunk at d=64 (csrc/attn_wgmma.cuh) where 128 does not divide
SHARED_ONLINE_BLOCK_K = 128  # key chunk of the online kernels on csrc/attn_wgmma.cuh (d=64)
D512_BLOCK_K = 32  # key chunk of the flash kernels at d=512 (csrc/attn_wgmma_d512.cuh)
# plain versions materialise fp32 score blocks of at most this many elements
_PLAIN_BLOCK_ELEMS = 1 << 28


def _q_scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * (scale * log2 e), the constant and the product in q's dtype."""
    return q * torch.full((), scale * LOG2E, dtype=q.dtype, device=q.device)


def _row_norm(x: torch.Tensor) -> torch.Tensor:
    return x.float().square().sum(-1, keepdim=True).sqrt()


def key_norm_max(k: torch.Tensor, dims) -> torch.Tensor:
    """max ||k_j|| over ``dims`` in fp32."""
    return k.float().square().sum(-1).sqrt().amax(dim=dims)


def _key_norm_max_one_pass(k: torch.Tensor, dims) -> torch.Tensor:
    """``key_norm_max`` in one pass over the keys, for the per-call shared
    kernels and ``flash_attention`` (kernel and plain version alike): the
    same norms up to fp32 summation order, without the three fp32 copies of
    the keys that ``key_norm_max`` makes (1.5 GB for the batch-64 VAE
    encode's 64 x 4096 x 512 keys)."""
    return torch.linalg.vector_norm(k, dim=-1, dtype=torch.float32).amax(dim=dims)


def _bound_softmax_av(qs, keys, vals, bound, out_dtype, *, sum_rounded: bool):
    """sum_j bf16(p_ij) v_j / sum_j p_ij with p = exp2(qs k^T - bound), over
    query blocks so the fp32 scores stay bounded. ``sum_rounded`` sums the
    p rounded to the value dtype (flash kernel) instead of fp32 p."""
    b, h, sq, _ = qs.shape
    rows = max(1, _PLAIN_BLOCK_ELEMS // max(1, b * h * keys.shape[2]))
    kf, vf = keys.float(), vals.float()
    out = torch.empty(qs.shape[:3] + (vals.shape[-1],), dtype=out_dtype, device=qs.device)
    for i in range(0, sq, rows):
        s = qs[:, :, i : i + rows].float() @ kf.transpose(-1, -2)
        p = torch.exp2(s - bound[:, :, i : i + rows])
        pr = p.to(vals.dtype).float()
        l = (pr if sum_rounded else p).sum(-1, keepdim=True)
        out[:, :, i : i + rows] = ((pr @ vf) / l).to(out_dtype)
    return out


def _chunk_starts(skv: int, block_k: int, seg: int):
    """(start, end) of the key chunks over Skv keys in segments of ``seg``:
    ``block_k`` keys from each segment's start, the last chunk of a segment
    cut at its end, so that no chunk straddles two segments."""
    if block_k <= 0 or seg <= 0 or skv % seg:
        raise ValueError(f"key chunk {block_k} over {skv} keys in segments of {seg}")
    return [(j, min(j + block_k, s0 + seg)) for s0 in range(0, skv, seg)
            for j in range(s0, s0 + seg, block_k)]


def _online_softmax_av(qs, keys, vals, out_dtype, *, block_k: int, arg_rounded: bool,
                       return_lse: bool = False, seg: Optional[int] = None):
    """sum_j p_ij v_j / sum_j p_ij with a running max over key chunks of
    ``block_k`` in each segment of ``seg`` keys (default: the keys are one
    segment), the last chunk of a segment cut at its end: m_new = max(m,
    rowmax(s)), alpha = exp2(m - m_new), row sum and fp32 accumulator
    rescaled by alpha. ``arg_rounded``: p = exp2((s - m_new) rounded to the
    value dtype), summed as rounded; otherwise p = exp2(s - m_new) in fp32,
    summed in fp32, and only the product's operand is rounded.
    ``return_lse`` also returns m + log2(row sum), fp32 [B, H, Sq]."""
    b, h, sq, _ = qs.shape
    skv = keys.shape[2]
    qf = qs.float()
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32, device=qs.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, sq, vals.shape[-1]), dtype=torch.float32, device=qs.device)
    for j, end in _chunk_starts(skv, block_k, skv if seg is None else seg):
        s = qf @ keys[:, :, j:end].float().transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        if arg_rounded:
            p = psum = torch.exp2((s - m_new).to(vals.dtype)).float()
        else:
            psum = torch.exp2(s - m_new)
            p = psum.to(vals.dtype).float()
        l = alpha * l + psum.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ vals[:, :, j:end].float()
        m = m_new
    out = (acc / l).to(out_dtype)
    return (out, (m + torch.log2(l)).squeeze(-1)) if return_lse else out


# ---------------------------------------------------------------------------
# kernel 2: plain attention with the bound softmax
# ---------------------------------------------------------------------------


def key_tile(s: int) -> int:
    """Keys a tile of ``csrc/attn_wgmma.cuh`` (d = 64) takes from a segment
    of ``s`` keys, as its launchers choose it (``key_tile`` there):
    ``SHARED_ONLINE_BLOCK_K`` where it divides ``s``, ``ONLINE_BLOCK_K``
    where that does, else 128 where ``s`` is longer than 64 and 64 where it
    is not; the last tile of a ragged segment holds its last ``s`` % tile
    keys, the rest masked."""
    if s % SHARED_ONLINE_BLOCK_K == 0:
        return SHARED_ONLINE_BLOCK_K
    if s % ONLINE_BLOCK_K == 0:
        return ONLINE_BLOCK_K
    return SHARED_ONLINE_BLOCK_K if s > ONLINE_BLOCK_K else ONLINE_BLOCK_K


def _flash_tiles_fit(sq: int, skv: int, d: int) -> bool:
    """Whether the plain flash kernels (``flash_attention``'s bound kernel,
    ``flash_online``, ``flash_fwd_lse``) and the backward kernels take Sq
    queries against Skv keys at head dim d: at d = 64 any (the tile masks
    the ragged ends, as the JAX kernels take any length up to their block),
    at d = 512 Sq a multiple of 64 and Skv of ``D512_BLOCK_K`` (the VAE mid
    attention's n^2 tokens are, wherever the latent side n is a multiple of
    8)."""
    if min(sq, skv) <= 0:
        return False
    if d == 64:
        return True
    return d == 512 and sq % 64 == 0 and skv % D512_BLOCK_K == 0


def flash_bound_chunk(sq: int, skv: int, d: int) -> int:
    """Key chunk of ``flash_attention``'s bound kernel for Sq queries against
    Skv keys at head dim d: at d = 64 ``flash_online_chunk``'s (the plain
    layout of ``csrc/attn_wgmma.cuh``, whose launcher takes 128 query rows a
    block where they divide Sq and the key tile divides Skv, else 64), at
    d = 512 ``D512_BLOCK_K`` (``csrc/attn_wgmma_d512.cuh``, 64 rows a
    block). Raises on what the kernel refuses (``_flash_tiles_fit``)."""
    if not _flash_tiles_fit(sq, skv, d):
        raise ValueError(f"flash_attention: the bound kernel takes d = 64, or d = 512 with Sq % 64 "
                         f"== 0 and Skv % {D512_BLOCK_K} == 0, not Sq {sq}, Skv {skv}, d {d}")
    return flash_online_chunk(skv, d) if d == 64 else D512_BLOCK_K


def flash_attention_plain(q, k, v, *, scale: float) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/flash_bound.cu``: q [B, H, Sq, d],
    k/v [B, H, Skv, d] -> [B, H, Sq, d]."""
    kmax = _key_norm_max_one_pass(k, 2)[:, :, None, None]
    bound = _row_norm(q) * (scale * LOG2E) * kmax - BOUND_EXP_SHIFT
    return _bound_softmax_av(_q_scaled(q, scale), k, v, bound, q.dtype, sum_rounded=True)


def _check_flash(name: str, q, k, v, fits) -> None:
    """The flash kernels' inputs: CUDA bf16, k and v of one shape [B, H,
    Skv, d] beside q [B, H, Sq, d], and ``fits(Sq, Skv, d)``, the kernel's
    own rule for its tiles (``_flash_tiles_fit``; the backward kernels'
    ``ops.flash_vjp._bwd_tiles_fit``)."""
    if not q.is_cuda:
        raise ValueError(f"{name}: no kernel for device {q.device}")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    bf = torch.bfloat16
    _build.check_cuda(name, (q, bf), (k, bf), (v, bf))
    if k.shape != (b, h, skv, d) or v.shape != k.shape or not fits(sq, skv, d):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)}")


def flash_attention(q, k, v, *, scale: float, algo: Optional[str] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v for q [B, H, Sq, d], k/v [B, H, Skv, d].
    ``algo`` (default: ``INSTANTRESTORE_FLASH_ALGO``, else ``bound``) selects
    the algorithm as in the JAX package: ``bound`` runs this wrapper's
    kernel, any other value ``flash_online``. The bound kernel takes bf16 at
    d = 64 with any Sq and Skv, and at d = 512 with Sq % 64 == 0 and Skv %
    32 == 0 (``_flash_tiles_fit``); it raises on any other shape before a
    launch. The only d = 512 attention, the VAE mid block's, has n^2 tokens
    for a latent of side n, a multiple of 8, so it always fits."""
    if algo is None:
        algo = os.environ.get("INSTANTRESTORE_FLASH_ALGO", "bound")
    if algo != "bound":
        return flash_online(q, k, v, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale)
    _check_flash("flash_attention", q, k, v, _flash_tiles_fit)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    block_k = flash_bound_chunk(sq, skv, d)
    kmax = _key_norm_max_one_pass(k, 2).contiguous()
    out = torch.empty_like(q)
    _build.launch(flash_attention, "flash_bound", q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kmax.data_ptr(), out.data_ptr(),
            b, h, sq, skv, d, block_k, ctypes.c_float(scale * LOG2E))
    return out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# kernel 8: plain attention with the online softmax
# ---------------------------------------------------------------------------


def flash_online_chunk(skv: int, d: int) -> int:
    """Key chunk of the running max of ``flash_online`` and ``flash_fwd_lse``
    over Skv keys at head dim d: at d = 64 the tile of ``csrc/attn_wgmma.cuh``
    takes ``key_tile(Skv)`` keys a chunk, the last one cut at Skv; at d = 512
    the tile of ``csrc/attn_wgmma_d512.cuh`` takes its ``D512_BLOCK_K`` keys;
    the plain versions take ``ONLINE_BLOCK_K`` at any other width (no kernel
    does). Skv where that is shorter."""
    if d == 64:
        return min(key_tile(skv), skv)
    return min(D512_BLOCK_K if d == 512 else ONLINE_BLOCK_K, skv)


def check_flash_chunk(name: str, skv: int, d: int, block_k: int) -> None:
    """Raises unless the online flash kernels take a key chunk of ``block_k``
    over Skv keys at head dim d: at d = 64 (the tile of
    ``csrc/attn_wgmma.cuh``) 64 or 128 keys, the last chunk cut at Skv, or
    all Skv keys where they are fewer than 128; at d = 512 (the tile of
    ``csrc/attn_wgmma_d512.cuh``) 32 dividing Skv."""
    if d == 64:
        ok = (block_k in (ONLINE_BLOCK_K, SHARED_ONLINE_BLOCK_K) and block_k <= skv) or (
            block_k == skv < SHARED_ONLINE_BLOCK_K)
        takes = "64 or 128 keys (no more than Skv), or all Skv < 128"
    else:
        ok = block_k == D512_BLOCK_K and skv % block_k == 0
        takes = f"{D512_BLOCK_K} keys dividing Skv"
    if not ok:
        raise ValueError(f"{name}: the kernel takes a key chunk of {takes} at d={d}, not "
                         f"{block_k} over Skv {skv}")


def flash_online_plain(q, k, v, *, scale: float, block_k: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/flash_online.cu``: q [B, H, Sq, d],
    k/v [B, H, Skv, d] -> [B, H, Sq, d], the running max taken over key chunks
    of ``min(block_k, Skv)``, by default the kernel's (``flash_online_chunk``).
    d < 128 rounds the exponent's argument to the value dtype, d >= 128 keeps
    p in fp32 for the row sum, as the TPU kernel's two branches do."""
    skv, d = k.shape[2], q.shape[-1]
    bk = flash_online_chunk(skv, d) if block_k is None else min(block_k, skv)
    return _online_softmax_av(_q_scaled(q, scale), k, v, q.dtype, block_k=bk,
                              arg_rounded=d < 128)


def flash_online(q, k, v, *, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v with the numerics of the TPU's
    ``_flash_kernel`` (running max, no bound: no row can flush). Shapes as
    ``flash_attention``; the CUDA kernel takes bf16 and the shapes of
    ``_flash_tiles_fit``; the key chunk is ``flash_online_chunk``'s."""
    if q.device.type == "cpu":
        return flash_online_plain(q, k, v, scale=scale)
    _check_flash("flash_online", q, k, v, _flash_tiles_fit)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    out = torch.empty_like(q)
    _build.launch(flash_online, "flash_online", q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, sq, skv, d, flash_online_chunk(skv, d), ctypes.c_float(scale * LOG2E))
    return out


flash_online.launches = 0


# ---------------------------------------------------------------------------
# reference K/V: the identity cache and the AdaIN affine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IdentityKVCache:
    """One shared-attention layer's onboarded reference KV plus the
    reductions restores need, computed once at onboarding.

    rk/rv: [I, N, H, S, d] head-split reference keys/values.
    content_mean/content_std: [I, N, H, d] fp32 AdaIN value statistics
      (unbiased std, +eps).
    kmax: [I, H] fp32 max_j ||k_j|| over the identity's reference keys.
    """

    rk: torch.Tensor
    rv: torch.Tensor
    content_mean: torch.Tensor
    content_std: torch.Tensor
    kmax: torch.Tensor


class IdentityRef(NamedTuple):
    """Per-layer ``ref_kv`` entry of the identity-cached path: the cache
    layer and this batch's identity rows."""

    cache: IdentityKVCache
    ids: torch.Tensor  # [B] int


def build_identity_kv_cache(kv_list, eps: float = 1e-5) -> List[IdentityKVCache]:
    """[(k, v) x layers] with [I, N, H, S, d] leaves -> [IdentityKVCache x layers]."""
    out = []
    for k, v in kv_list:
        vf = v.float()
        out.append(IdentityKVCache(
            rk=k.contiguous(), rv=v.contiguous(),
            content_mean=vf.mean(dim=3),
            content_std=vf.var(dim=3, unbiased=True).sqrt() + eps,
            kmax=key_norm_max(k, (1, 3)),
        ))
    return out


def adain_affine_from_stats(v_in, content_mean, content_std, eps: float = 1e-5):
    """Per-(b, h, ref, channel) scale/shift with v * scale + shift ==
    AdaIN of reference values onto the input values' statistics (unbiased
    std, eps added to the std). v_in [B, H, S, d]; stats [B, N, H, d];
    returns two [B, H, N, d] fp32 tensors."""
    vf = v_in.float()
    style_mean = vf.mean(dim=2)
    style_std = vf.var(dim=2, unbiased=True).sqrt() + eps
    cm = content_mean.permute(0, 2, 1, 3)
    cs = content_std.permute(0, 2, 1, 3)
    scale = style_std[:, :, None, :] / cs
    shift = style_mean[:, :, None, :] - cm * scale
    return scale, shift


def _affine(v_affine, b: int, h: int, n: int, d: int, device) -> torch.Tensor:
    """Reference V scale and shift packed as [B, H, N, 2, d] fp32; the
    identity when ``v_affine`` is None."""
    if v_affine is None:
        vs = torch.ones((b, h, n, d), dtype=torch.float32, device=device)
        vh = torch.zeros_like(vs)
    else:
        vs, vh = (a.float() for a in v_affine)
    return torch.stack([vs, vh], dim=3).contiguous()


def adain_affine(v_in, ref_v, eps: float = 1e-5):
    """Per-(b, h, ref, channel) scale and shift with v * scale + shift ==
    AdaIN of the reference values onto the input values' statistics
    (unbiased std, eps added to the std). v_in [B, H, S, d]; ref_v
    [B, N, H, S, d]; returns two [B, H, N, d] fp32 tensors."""
    rf = ref_v.float()
    return adain_affine_from_stats(v_in, rf.mean(dim=3),
                                   rf.var(dim=3, unbiased=True).sqrt() + eps, eps)


# ---------------------------------------------------------------------------
# kernel 1: refs-only shared attention, fp32 affine and row sum
# ---------------------------------------------------------------------------


def shared_identity_plain(q, rk, rv, aff, kmax, ids, *, scale: float) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/shared_identity.cu``.

    q [B, H, Sq, d]; rk/rv [I, N, H, S, d]; aff [B, H, N, 2, d] fp32 (V
    scale, shift); kmax [I, H] over each row's reference keys; ids [B]."""
    b, h, sq, d = q.shape
    n, s = rk.shape[1], rk.shape[3]
    ids = ids.long()
    qs = _q_scaled(q, scale)
    bound = _row_norm(qs) * kmax[ids][:, :, None, None] - BOUND_EXP_SHIFT
    keys = rk[ids].permute(0, 2, 1, 3, 4).reshape(b, h, n * s, d)
    rvf = rv[ids].permute(0, 2, 1, 3, 4).float()
    vals = (rvf * aff[:, :, :, 0, None, :] + aff[:, :, :, 1, None, :]).to(q.dtype)
    return _bound_softmax_av(qs, keys, vals.reshape(b, h, n * s, d), bound, q.dtype,
                             sum_rounded=False)


def shared_identity(q, rk, rv, aff, kmax, ids, *, scale: float) -> torch.Tensor:
    """softmax(q K^T * scale) (V * a + c) over the N * S reference keys of
    row ``ids[b]`` of rk/rv [I, N, H, S, d], with the numerics of the TPU's
    paired kernel: bound from the pre-scaled q's norm, fp32 affine, fp32 row
    sum. aff [B, H, N, 2, d] fp32; kmax [I, H] fp32. The CUDA kernel takes
    bf16 at d = 64 with any Sq and S; its tile follows the shape
    (``shared_online_tile``). An id outside [0, I) makes its sample's
    outputs NaN on the card."""
    if q.device.type == "cpu":
        return shared_identity_plain(q, rk, rv, aff, kmax, ids, scale=scale)
    if not q.is_cuda:
        raise ValueError(f"shared_identity: no kernel for device {q.device}")
    b, h, sq, d = q.shape
    i_rows, n, _, s, _ = rk.shape
    ids32 = ids.to(device=q.device, dtype=torch.int32).contiguous()
    bf, f32 = torch.bfloat16, torch.float32
    _build.check_cuda("shared_identity", (q, bf), (rk, bf), (rv, bf), (aff, f32), (kmax, f32),
                (ids32, torch.int32))
    if (d != 64 or rk.shape != (i_rows, n, h, s, d) or rv.shape != rk.shape
            or aff.shape != (b, h, n, 2, d) or kmax.shape != (i_rows, h)
            or ids32.shape != (b,) or min(sq, s) <= 0):
        raise ValueError(
            f"shared_identity: unsupported shapes q {tuple(q.shape)} "
            f"cache {tuple(rk.shape)} ids {tuple(ids32.shape)}")
    out = torch.empty_like(q)
    _build.launch(shared_identity, "shared_identity", q,
            q.data_ptr(), rk.data_ptr(), rv.data_ptr(), kmax.data_ptr(), aff.data_ptr(),
            ids32.data_ptr(), out.data_ptr(),
            b, h, sq, s, n, i_rows, d, ctypes.c_float(scale * LOG2E))
    return out


shared_identity.launches = 0


# ---------------------------------------------------------------------------
# kernel 3: shared attention over [input |] references, bf16 affine, rounded
# row sum
# ---------------------------------------------------------------------------


def _widen_rounded_affine(k_in, v_in, rk, rv, aff, include_input: bool):
    """Keys and values [B, H, (1 +) N * S, d] as the per-call shared kernels
    see them: segments in the order input (raw), ref 1 .. N; scale and shift
    rounded to the value dtype, then one rounding of ``v * a + c`` computed
    in fp32."""
    b, n, h, s, d = rk.shape
    keys = rk.permute(0, 2, 1, 3, 4).reshape(b, h, n * s, d)
    a = aff.to(rv.dtype).float()
    vals = (rv.permute(0, 2, 1, 3, 4).float() * a[:, :, :, 0, None, :]
            + a[:, :, :, 1, None, :]).to(rv.dtype).reshape(b, h, n * s, d)
    if include_input:
        keys = torch.cat([k_in, keys], dim=2)
        vals = torch.cat([v_in, vals], dim=2)
    return keys, vals


def shared_flash_bound_plain(q, k_in, v_in, rk, rv, aff, kmax, ids=None, *, scale: float,
                             include_input: bool) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/shared_flash_bound.cu``.

    q [B, H, Sq, d]; k_in/v_in [B, H, S, d] (read only when
    ``include_input``); rk/rv [B, N, H, S, d], or an identity cache
    [I, N, H, S, d] read at rows ``ids``; aff [B, H, N, 2, d] fp32, rounded to
    the value dtype before use; kmax [B, H] fp32 over every key a row sees.
    The affine is one rounding of ``v * a + c`` computed in fp32, as in the
    kernel."""
    if ids is not None:
        rk, rv = rk[ids.long()], rv[ids.long()]
    keys, vals = _widen_rounded_affine(k_in, v_in, rk, rv, aff, include_input)
    bound = _row_norm(q) * (scale * LOG2E) * kmax[:, :, None, None] - BOUND_EXP_SHIFT
    return _bound_softmax_av(_q_scaled(q, scale), keys, vals, bound, q.dtype, sum_rounded=True)


def shared_flash_bound(q, k_in, v_in, rk, rv, aff, kmax, ids=None, *, scale: float,
                       include_input: bool) -> torch.Tensor:
    """softmax(q [K_in |] K_1..N ^T * scale) [V_in |] (V_n * a_n + c_n) with
    the numerics of the TPU's ``_shared_kvouter_bound_kernel`` (bound from the
    unscaled q norm, bf16 affine, row sum over bf16-rounded p). Shapes as in
    ``shared_flash_bound_plain``. The CUDA kernel takes bf16 at d = 64 with
    any Sq and S; its tile follows the shape (``shared_online_tile``)."""
    if q.device.type == "cpu":
        return shared_flash_bound_plain(q, k_in, v_in, rk, rv, aff, kmax, ids, scale=scale,
                                        include_input=include_input)
    if not q.is_cuda:
        raise ValueError(f"shared_flash_bound: no kernel for device {q.device}")
    b, h, sq, d = q.shape
    rows, n, _, s, _ = rk.shape
    bf, f32 = torch.bfloat16, torch.float32
    typed = [(q, bf), (rk, bf), (rv, bf), (aff, f32), (kmax, f32)]
    if include_input:
        typed += [(k_in, bf), (v_in, bf)]
    ids32 = None
    if ids is not None:
        ids32 = ids.to(device=q.device, dtype=torch.int32).contiguous()
        typed.append((ids32, torch.int32))
    _build.check_cuda("shared_flash_bound", *typed)
    if (d != 64 or rk.shape != (rows, n, h, s, d) or rv.shape != rk.shape
            or aff.shape != (b, h, n, 2, d) or kmax.shape != (b, h) or min(sq, s) <= 0
            or (ids32 is None and rows != b) or (ids32 is not None and ids32.shape != (b,))
            or (include_input and (k_in.shape != (b, h, s, d) or v_in.shape != k_in.shape))):
        raise ValueError(
            f"shared_flash_bound: unsupported shapes q {tuple(q.shape)} refs {tuple(rk.shape)}"
            f" input {tuple(k_in.shape) if include_input else None}")
    out = torch.empty_like(q)
    _build.launch(shared_flash_bound, "shared_flash_bound", q,
            q.data_ptr(), k_in.data_ptr() if include_input else None,
            v_in.data_ptr() if include_input else None, rk.data_ptr(), rv.data_ptr(),
            kmax.data_ptr(), aff.data_ptr(), None if ids32 is None else ids32.data_ptr(),
            out.data_ptr(), b, h, sq, s, n, rows, int(include_input), d,
            ctypes.c_float(scale * LOG2E))
    return out


shared_flash_bound.launches = 0


# ---------------------------------------------------------------------------
# kernels 7, 9, 10: shared attention over [input |] references with the
# online softmax
# ---------------------------------------------------------------------------


def shared_online_chunk(s: int, block_k: Optional[int] = None) -> int:
    """Key chunk of the running max over segments of ``s`` keys: chunks start
    at each segment's start and the last one of a segment is cut at its end,
    so that none straddles two segments. ``block_k`` None is the kernels' own
    choice, ``key_tile(s)``; a given ``block_k`` stands for ``min(block_k,
    s)``. Raises on a segment or chunk of no keys."""
    bk = min(key_tile(s) if block_k is None else block_k, s)
    if bk <= 0:
        raise ValueError(f"key chunk {bk} over a segment of {s} keys")
    return bk


def shared_online_tile(sq: int, s: int, h: int, *, pair: bool = False) -> Tuple[int, int]:
    """(query rows a thread block takes, key chunk) of the shared kernels on
    the wgmma tile (``csrc/shared_online.cu``, ``shared_flash_bound.cu``,
    ``shared_identity.cu``; ``pair``: ``csrc/shared_online_pair.cu``) for Sq
    queries, segments of S keys and H heads, as ``launch_shared`` of
    ``csrc/attn_wgmma.cuh`` chooses them: two consumer warpgroups of 64 rows
    on one head where 128 divides Sq and the key tile divides S, else one; a
    head pair always takes 64 rows, one warpgroup a head. Any Sq and S; raises
    on what the kernels refuse (an empty side, a head pair of odd H)."""
    if min(sq, s, h) <= 0 or (pair and h % 2):
        raise ValueError(f"online shared kernel: unsupported Sq {sq}, S {s}, H {h}"
                         f"{' for a head pair' if pair else ''}")
    wide = not pair and sq % 128 == 0 and s % key_tile(s) == 0
    return (128 if wide else 64), shared_online_chunk(s)


def shared_online_plain(q, k_in, v_in, rk, rv, aff, *, scale: float, include_input: bool,
                        block_k: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/shared_online.cu``.

    q [B, H, Sq, d]; k_in/v_in [B, H, S, d] (read only when
    ``include_input``); rk/rv [B, N, H, S, d]; aff [B, H, N, 2, d] fp32,
    rounded to the value dtype before use, the affine one rounding of
    ``v * a + c`` computed in fp32, as in the kernel. Segments in the order
    input, ref 1 .. N; the running max is taken over key chunks of
    ``shared_online_chunk(S, block_k)``: by default the kernel's."""
    keys, vals = _widen_rounded_affine(k_in, v_in, rk, rv, aff, include_input)
    s = rk.shape[3]
    return _online_softmax_av(_q_scaled(q, scale), keys, vals, q.dtype,
                              block_k=shared_online_chunk(s, block_k), arg_rounded=True, seg=s)


def shared_online_pair_plain(q, k_in, v_in, rk, rv, aff, *, scale: float, include_input: bool,
                             block_k: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/shared_online_pair.cu``: per head the
    pair kernel computes ``shared_online``'s function (the TPU's packed kernel
    sums the rounded p in fp32 on the VPU, the same number as the ones
    column), so this is ``shared_online_plain`` on an even number of heads."""
    if q.shape[1] % 2:
        raise ValueError(f"shared_online_pair: odd number of heads {q.shape[1]}")
    return shared_online_plain(q, k_in, v_in, rk, rv, aff, scale=scale,
                               include_input=include_input, block_k=block_k)


def _launch_shared_online(wrapper, source: str, q, k_in, v_in, rk, rv, aff, *, scale: float,
                          include_input: bool, heads_per_block: int) -> torch.Tensor:
    """Check the inputs of an online shared kernel, launch ``csrc/<source>.cu``
    and count the launch on ``wrapper``."""
    if not q.is_cuda:
        raise ValueError(f"{source}: no kernel for device {q.device}")
    b, h, sq, d = q.shape
    rows, n, _, s, _ = rk.shape
    bf, f32 = torch.bfloat16, torch.float32
    typed = [(q, bf), (rk, bf), (rv, bf), (aff, f32)]
    if include_input:
        typed += [(k_in, bf), (v_in, bf)]
    _build.check_cuda(source, *typed)
    if (d != 64 or rk.shape != (b, n, h, s, d) or rv.shape != rk.shape
            or aff.shape != (b, h, n, 2, d)
            or (include_input and (k_in.shape != (b, h, s, d) or v_in.shape != k_in.shape))):
        raise ValueError(
            f"{source}: unsupported shapes q {tuple(q.shape)} refs {tuple(rk.shape)}"
            f" input {tuple(k_in.shape) if include_input else None}")
    shared_online_tile(sq, s, h, pair=heads_per_block == 2)  # raises on a refused shape
    out = torch.empty_like(q)
    _build.launch(wrapper, source, q,
            q.data_ptr(), k_in.data_ptr() if include_input else None,
            v_in.data_ptr() if include_input else None, rk.data_ptr(), rv.data_ptr(),
            aff.data_ptr(), out.data_ptr(), b, h, sq, s, n, int(include_input), d,
            ctypes.c_float(scale * LOG2E))
    return out


def shared_online(q, k_in, v_in, rk, rv, aff, *, scale: float,
                  include_input: bool) -> torch.Tensor:
    """softmax(q [K_in |] K_1..N ^T * scale) [V_in |] (V_n * a_n + c_n) with
    the numerics of the TPU's ``_shared_kvouter_kernel`` and
    ``_shared_kernel`` (running max, no bound: no row can flush; bf16 affine;
    row sum over bf16-rounded p). Shapes as in ``shared_online_plain``. The
    CUDA kernel takes bf16 at d = 64 with any Sq and S; its tile follows the
    shape (``shared_online_tile``)."""
    if q.device.type == "cpu":
        return shared_online_plain(q, k_in, v_in, rk, rv, aff, scale=scale,
                                   include_input=include_input)
    return _launch_shared_online(shared_online, "shared_online", q, k_in, v_in, rk, rv, aff,
                                 scale=scale, include_input=include_input, heads_per_block=1)


shared_online.launches = 0


def shared_online_pair(q, k_in, v_in, rk, rv, aff, *, scale: float,
                       include_input: bool) -> torch.Tensor:
    """``shared_online``'s function with one thread block per head pair (the
    TPU's ``_shared_kvouter_packed_kernel``); H must be even."""
    if q.device.type == "cpu":
        return shared_online_pair_plain(q, k_in, v_in, rk, rv, aff, scale=scale,
                                        include_input=include_input)
    return _launch_shared_online(shared_online_pair, "shared_online_pair", q, k_in, v_in, rk, rv,
                                 aff, scale=scale, include_input=include_input,
                                 heads_per_block=2)


shared_online_pair.launches = 0


# ---------------------------------------------------------------------------
# the two entry points of shared attention: per-call references and the
# identity cache
# ---------------------------------------------------------------------------

def shared_flash_attention(q, k_in, v_in, ref_k, ref_v, *, scale: float,
                           v_affine: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                           include_input: bool = True,
                           algo: Optional[str] = None) -> torch.Tensor:
    """Fused widened attention over [input |] ref_1 .. ref_N K/V with
    per-call references: q/k_in/v_in [B, H, S, d], ref_k/ref_v
    [B, N, H, S, d], ``v_affine`` = (scale, shift) [B, H, N, d] applied to
    the reference values (identity when None).

    ``algo`` (default: ``INSTANTRESTORE_ATTN_ALGO``, else ``kv_outer_bound``)
    chooses the kernel as the JAX package does: ``kv_outer_bound`` runs
    ``shared_flash_bound``; ``kv_outer_bound_paired`` runs ``shared_identity``
    on the per-call K/V (rows ``arange(B)``) when the call is refs-only with
    even N and d <= 64, else falls back to ``kv_outer_bound``;
    ``kv_outer_packed`` runs ``shared_online_pair`` at d <= 64 and even H,
    else ``shared_online``; ``kv_outer``, ``q_outer`` and every other string
    run ``shared_online`` (the TPU's KV-outer kernel for a ``kv_outer*``
    string and its Q-outer kernel for the rest compute one function). Only
    the two bound algorithms can lose a row to bound slack beyond ~190 log2
    units; the online ones are the way out."""
    b, h, sq, d = q.shape
    n = ref_k.shape[1]
    aff = _affine(v_affine, b, h, n, d, q.device)
    if algo is None:
        algo = os.environ.get("INSTANTRESTORE_ATTN_ALGO", "kv_outer_bound")
    if algo == "kv_outer_bound_paired":
        if not include_input and n % 2 == 0 and d <= 64:
            return shared_identity(q, ref_k, ref_v, aff, _key_norm_max_one_pass(ref_k, (1, 3)),
                                   torch.arange(b, device=q.device), scale=scale)
        algo = "kv_outer_bound"  # pairing needs refs-only and even N
    if algo == "kv_outer_bound":
        kmax = _key_norm_max_one_pass(ref_k, (1, 3))
        if include_input:
            kmax = torch.maximum(kmax, _key_norm_max_one_pass(k_in, 2))
        return shared_flash_bound(q, k_in, v_in, ref_k, ref_v, aff, kmax, scale=scale,
                                  include_input=include_input)
    if algo == "kv_outer_packed" and d <= 64 and h % 2 == 0:
        return shared_online_pair(q, k_in, v_in, ref_k, ref_v, aff, scale=scale,
                                  include_input=include_input)
    return shared_online(q, k_in, v_in, ref_k, ref_v, aff, scale=scale,
                         include_input=include_input)


def shared_attention_identity(q, k_in, v_in, cache: IdentityKVCache, ids, *,
                              scale: float, use_adain: bool) -> torch.Tensor:
    """Refs-only shared attention over identity ``ids[b]``'s cached reference
    KV: softmax(q K^T * scale) (V * a + c), with (a, c) the AdaIN affine of
    the cached content statistics onto ``v_in``'s (or the identity when
    ``use_adain`` is off). ``k_in`` is unused (refs-only), as in the JAX
    package. Even N at d <= 64 runs ``shared_identity`` (the TPU's paired
    kernel); odd N or d > 64 runs ``shared_flash_bound`` on the cache by id,
    as the JAX package's unpaired branch does."""
    del k_in
    b, h, sq, d = q.shape
    n = cache.rk.shape[1]
    affine = None
    if use_adain:
        affine = adain_affine_from_stats(v_in, cache.content_mean[ids], cache.content_std[ids])
    aff = _affine(affine, b, h, n, d, q.device)
    if n % 2 == 0 and d <= 64:
        return shared_identity(q, cache.rk, cache.rv, aff, cache.kmax, ids, scale=scale)
    return shared_flash_bound(q, None, None, cache.rk, cache.rv, aff, cache.kmax[ids.long()],
                              ids, scale=scale, include_input=False)


KERNEL_WRAPPERS = (flash_attention, shared_identity, shared_flash_bound, flash_online,
                   shared_online, shared_online_pair)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
