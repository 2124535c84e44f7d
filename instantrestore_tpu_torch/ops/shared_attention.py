"""Fused attention of the serving path: the bound-softmax flash attention and
the identity-cached shared attention (counterpart of
``instantrestore_tpu/ops/shared_attention.py``).

Each kernel comes as a wrapper, a plain PyTorch version of the same function
and a launch count:

* ``flash_attention`` -> CUDA kernel ``csrc/flash_bound.cu`` (replaces the
  TPU kernel ``_flash_bound_kernel``); plain version ``flash_attention_plain``.
* ``shared_attention_identity`` -> CUDA kernel ``csrc/shared_identity.cu``
  (replaces ``_shared_kvouter_bound_paired_kernel``); plain version
  ``shared_identity_plain``.

A wrapper given CUDA tensors launches its kernel (bf16 only) or raises; given
CPU tensors it runs the plain version. ``<wrapper>.launches`` counts kernel
launches and nothing else.

Numerics (shared with the JAX package): logits in log2 units, q pre-scaled
by ``scale * log2 e`` in the input dtype, no running max but the
Cauchy-Schwarz bound ``||q_i|| * scale * log2 e * max_j ||k_j|| - 64``
(``BOUND_EXP_SHIFT``), fp32 scores and accumulator, P @ V in the input dtype.
A whole row comes out NaN only if its bound slack exceeds ~190 log2 units.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, NamedTuple

import torch

from instantrestore_tpu_torch.ops import _build

LOG2E = 1.4426950408889634
BOUND_EXP_SHIFT = 64.0
# plain versions materialise fp32 score blocks of at most this many elements
_PLAIN_BLOCK_ELEMS = 1 << 28


def _stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name: str, dtype, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data is not 16-byte aligned")
    for t in tensors[:3]:
        if t.dtype != dtype:
            raise TypeError(f"{name}: kernel takes {dtype}, got {t.dtype}")


def _q_scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * (scale * log2 e), the constant and the product in q's dtype."""
    return q * torch.tensor(scale * LOG2E, dtype=q.dtype, device=q.device)


def _row_norm(x: torch.Tensor) -> torch.Tensor:
    return x.float().square().sum(-1, keepdim=True).sqrt()


def key_norm_max(k: torch.Tensor, dims) -> torch.Tensor:
    """max ||k_j|| over ``dims`` in fp32."""
    return k.float().square().sum(-1).sqrt().amax(dim=dims)


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


# ---------------------------------------------------------------------------
# kernel 2: plain attention with the bound softmax
# ---------------------------------------------------------------------------


def flash_attention_plain(q, k, v, *, scale: float) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/flash_bound.cu``: q [B, H, Sq, d],
    k/v [B, H, Skv, d] -> [B, H, Sq, d]."""
    kmax = key_norm_max(k, 2)[:, :, None, None]
    bound = _row_norm(q) * (scale * LOG2E) * kmax - BOUND_EXP_SHIFT
    return _bound_softmax_av(_q_scaled(q, scale), k, v, bound, q.dtype, sum_rounded=True)


def flash_attention(q, k, v, *, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v for q [B, H, Sq, d], k/v [B, H, Skv, d];
    the CUDA kernel takes bf16, d in {64, 512}, Sq % (64 if d == 64 else 32)
    == 0 and Skv % 64 == 0."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    _check_cuda("flash_attention", torch.bfloat16, q, k, v)
    bq = 64 if d == 64 else 32
    if (d not in (64, 512) or k.shape != (b, h, skv, d) or v.shape != k.shape
            or sq % bq or skv % 64):
        raise ValueError(f"flash_attention: unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    kmax = key_norm_max(k, 2).contiguous()
    out = torch.empty_like(q)
    rc = _build.load("flash_bound").irt_flash_bound_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kmax.data_ptr(), out.data_ptr(),
        b, h, sq, skv, d, ctypes.c_float(scale * LOG2E), _stream_ptr(q),
    )
    if rc != 0:
        raise RuntimeError(f"flash_bound kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# identity-cached serving attention
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


def shared_identity_plain(q, rk, rv, aff, kmax, ids, *, scale: float) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/shared_identity.cu``.

    q [B, H, Sq, d]; rk/rv cache [I, N, H, S, d]; aff [B, H, N, 2, d] fp32
    (V scale, shift); kmax [I, H]; ids [B]."""
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


def shared_attention_identity(q, k_in, v_in, cache: IdentityKVCache, ids, *,
                              scale: float, use_adain: bool) -> torch.Tensor:
    """Refs-only shared attention over identity ``ids[b]``'s cached reference
    KV: softmax(q K^T * scale) (V * a + c), with (a, c) the AdaIN affine of
    the cached content statistics onto ``v_in``'s (or identity when
    ``use_adain`` is off). ``k_in`` is unused (refs-only), as in the JAX
    package. The CUDA kernel takes bf16 at d=64 with Sq % 64 == 0 and
    S % 64 == 0."""
    del k_in
    b, h, sq, d = q.shape
    n = cache.rk.shape[1]
    if use_adain:
        vs, vh = adain_affine_from_stats(v_in, cache.content_mean[ids], cache.content_std[ids])
    else:
        vs = torch.ones((b, h, n, d), dtype=torch.float32, device=q.device)
        vh = torch.zeros_like(vs)
    aff = torch.stack([vs, vh], dim=3).contiguous()  # [B, H, N, 2, d]
    if q.device.type == "cpu":
        return shared_identity_plain(q, cache.rk, cache.rv, aff, cache.kmax, ids, scale=scale)
    if not q.is_cuda:
        raise ValueError(f"shared_attention_identity: no kernel for device {q.device}")
    i_rows, _, _, s, _ = cache.rk.shape
    ids32 = ids.to(device=q.device, dtype=torch.int32).contiguous()
    _check_cuda("shared_attention_identity", torch.bfloat16, q, cache.rk, cache.rv,
                aff, cache.kmax, ids32)
    if (d != 64 or cache.rk.shape != (i_rows, n, h, s, d) or cache.rv.shape != cache.rk.shape
            or cache.kmax.shape != (i_rows, h) or cache.kmax.dtype != torch.float32
            or ids32.shape != (b,) or sq % 64 or s % 64):
        raise ValueError(
            f"shared_attention_identity: unsupported shapes q {tuple(q.shape)} "
            f"cache {tuple(cache.rk.shape)} ids {tuple(ids32.shape)}")
    out = torch.empty_like(q)
    rc = _build.load("shared_identity").irt_shared_identity_bf16(
        q.data_ptr(), cache.rk.data_ptr(), cache.rv.data_ptr(), cache.kmax.data_ptr(),
        aff.data_ptr(), ids32.data_ptr(), out.data_ptr(),
        b, h, sq, s, n, i_rows, d, ctypes.c_float(scale * LOG2E), _stream_ptr(q),
    )
    if rc != 0:
        raise RuntimeError(f"shared_identity kernel launch failed: CUDA error {rc}")
    shared_attention_identity.launches += 1
    return out


shared_attention_identity.launches = 0

KERNEL_WRAPPERS = (flash_attention, shared_attention_identity)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
