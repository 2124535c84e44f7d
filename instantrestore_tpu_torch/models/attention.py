"""Multi-head attention of the restoration UNet, including shared-image
attention (counterpart of ``instantrestore_tpu/models/attention.py``).

* ``capture_kv=True`` returns the head-split K/V projections [B, H, S, d]
  (the frozen capture pass).
* ``ref_kv=(ref_k, ref_v)`` [B, N, H, S, d] widens self-attention with the
  references; invalid references are zeroed K/V rows, not masked.
* ``ref_kv=IdentityRef(cache, ids)`` reads an onboarded identity cache by id
  (warm serving; refs-only).
* AdaIN of reference values onto the input values' statistics uses the
  unbiased std with +1e-5 added to the std.
* ``save_probs=True`` returns the fp32 attention probabilities in
  ``aux["probs"]`` (the unfused branch; the Predictor's attention-mass
  percentages).

* ``save_seg_sums=True`` returns each KV segment's softmax mass per query in
  ``aux["seg_sums"]`` [B, h, Sq, n_seg], streamed segment by segment (the
  attention regularisers of training; never a [B, h, Sq, n_seg * S] tensor).

``use_fused=True`` sends plain self-attention, per-call ``(ref_k, ref_v)``
shared attention (cold restore, ``train_input`` models; the AdaIN affine
folds into the kernel) and the identity-cache branch to the kernels of
``ops/shared_attention.py``; where an input wants a gradient (training) the
first two run the differentiable kernels of ``ops/flash_vjp.py``. The unfused
branch is the JAX package's einsum softmax. Cross-attention over the 77 text
tokens is always matmul + softmax.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from instantrestore_tpu_torch.ops.flash_vjp import flash_attention, shared_flash_attention
from instantrestore_tpu_torch.ops.primitives import dense
from instantrestore_tpu_torch.ops.shared_attention import (
    IdentityRef,
    adain_affine,
    shared_attention_identity,
)


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, h*d] -> [B, h, S, d] (a view)."""
    b, s, inner = x.shape
    return x.reshape(b, s, heads, inner // heads).transpose(1, 2)


def _to_out_from_heads(p: dict, out_heads: torch.Tensor, *, lora_scaling: float) -> torch.Tensor:
    """to_out applied to head-split [B, h, S, d] output (merge + linear)."""
    b, h, s, d = out_heads.shape
    return dense(p, out_heads.transpose(1, 2).reshape(b, s, h * d), lora_scaling=lora_scaling)


def adain_stats(v: torch.Tensor, dim: int, eps: float = 1e-5):
    """Mean and unbiased std (+eps on the std) over ``dim``, keepdim, fp32."""
    vf = v.float()
    return vf.mean(dim=dim, keepdim=True), vf.var(dim=dim, unbiased=True, keepdim=True).sqrt() + eps


def widen_kv(k, v, ref_k, ref_v, *, use_adain: bool = False, train_input: bool = True):
    """Concatenate per-head reference K/V [B, N, h, S, d] onto the input K/V
    [B, h, S, d]: [B, h, (1 + N) * S, d], or [B, h, N * S, d] refs-only."""
    b, n, heads, s, d = ref_k.shape
    rk = ref_k.permute(0, 2, 1, 3, 4)
    rv = ref_v.permute(0, 2, 1, 3, 4)
    if use_adain:
        style_mean, style_std = adain_stats(v, dim=2)       # [B, h, 1, d]
        content_mean, content_std = adain_stats(rv, dim=3)  # [B, h, N, 1, d]
        rvf = (rv.float() - content_mean) / content_std
        rv = (rvf * style_std[:, :, None] + style_mean[:, :, None]).to(v.dtype)
    rk = rk.reshape(b, heads, n * s, d).to(k.dtype)
    rv = rv.reshape(b, heads, n * s, d).to(v.dtype)
    if train_input:
        return torch.cat([k, rk], dim=2), torch.cat([v, rv], dim=2)
    return rk, rv


def softmax_attention(q, k, v, scale: float, *, return_probs: bool = False):
    """Unfused attention: fp32 logits and softmax, P in v's dtype, fp32
    accumulation, output in q's dtype; with ``return_probs`` also the fp32
    probabilities."""
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    out = (probs.to(v.dtype).float() @ v.float()).to(q.dtype)
    return (out, probs) if return_probs else out


def segment_softmax_sums(q: torch.Tensor, k_segments: Sequence[torch.Tensor],
                         scale: float) -> torch.Tensor:
    """Per-query softmax mass of each KV segment, [B, h, Sq, n_seg] with rows
    summing to 1, without the [B, h, Sq, n_seg * S] probabilities: the
    segments are streamed twice (row max without gradient, then exp-sums),
    one [B, h, Sq, S] fp32 logits block alive at a time and each segment's
    block rebuilt in the backward. q [B, h, Sq, d]; k_segments: the widened
    K/V's segments [B, h, S, d] in ``widen_kv`` order."""
    qf = q.float()

    def logits(k_seg):
        return (qf @ k_seg.float().transpose(-1, -2)) * scale

    with torch.no_grad():
        m = logits(k_segments[0]).amax(dim=-1)
        for k_seg in k_segments[1:]:
            m = torch.maximum(m, logits(k_seg).amax(dim=-1))
        m = m[..., None]

    def seg_sum(k_seg):
        return torch.exp(logits(k_seg) - m).sum(dim=-1)

    if torch.is_grad_enabled():
        sums = [checkpoint(seg_sum, k_seg, use_reentrant=False, preserve_rng_state=False)
                for k_seg in k_segments]
    else:
        sums = [seg_sum(k_seg) for k_seg in k_segments]
    sums = torch.stack(sums, dim=-1)
    return sums / sums.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def attention(
    p: dict,
    hidden: torch.Tensor,
    *,
    heads: int,
    encoder_hidden: Optional[torch.Tensor] = None,
    ref_kv=None,
    use_adain: bool = False,
    train_input: bool = True,
    capture_kv: bool = False,
    save_probs: bool = False,
    save_seg_sums: bool = False,
    lora_scaling: float = 1.0,
    use_fused: bool = False,
    use_faceid: bool = False,
) -> Tuple[torch.Tensor, dict]:
    """hidden [B, S, C]; returns (out [B, S, C], aux with 'kv' when
    ``capture_kv``, 'probs' [B, h, Sq, Skv] when ``save_probs`` and 'seg_sums'
    [B, h, Sq, n_seg] when ``save_seg_sums`` and per-call references are
    given). ``use_faceid`` (a cross-attention): ``encoder_hidden`` holds face
    embeddings, projected by ``face_projection`` and read through the
    bias-free ``to_k_face_embed`` / ``to_v_face_embed`` instead of
    ``to_k`` / ``to_v``."""
    aux = {}
    ctx = hidden if encoder_hidden is None else encoder_hidden
    q = _split_heads(dense(p["to_q"], hidden, lora_scaling=lora_scaling), heads)
    if use_faceid and encoder_hidden is not None:
        ctx = dense(p["face_projection"], ctx)
        k = _split_heads(dense(p["to_k_face_embed"], ctx), heads)
        v = _split_heads(dense(p["to_v_face_embed"], ctx), heads)
    else:
        k = _split_heads(dense(p["to_k"], ctx, lora_scaling=lora_scaling), heads)
        v = _split_heads(dense(p["to_v"], ctx, lora_scaling=lora_scaling), heads)
    if capture_kv:
        aux["kv"] = (k, v)
    scale = q.shape[-1] ** -0.5

    if isinstance(ref_kv, IdentityRef):
        if train_input or save_probs or save_seg_sums:
            raise ValueError("the identity cache is refs-only (train_input=False) and keeps no "
                             "probs or segment sums")
        if use_fused:
            out = shared_attention_identity(
                q.contiguous(), k, v, ref_kv.cache, ref_kv.ids, scale=scale, use_adain=use_adain
            )
        else:
            cache, ids = ref_kv.cache, ref_kv.ids
            wk, wv = widen_kv(k, v, cache.rk[ids], cache.rv[ids], use_adain=use_adain,
                              train_input=False)
            out = softmax_attention(q, wk, wv, scale)
        return _to_out_from_heads(p["to_out"], out, lora_scaling=lora_scaling), aux

    if save_seg_sums and ref_kv is not None:
        rk = ref_kv[0]
        segs = ([k] if train_input else []) + [rk[:, i] for i in range(rk.shape[1])]
        aux["seg_sums"] = segment_softmax_sums(q, segs, scale)

    if use_fused and not save_probs:
        if ref_kv is not None:
            rk, rv = ref_kv
            affine = adain_affine(v, rv) if use_adain else None
            out = shared_flash_attention(
                q.contiguous(), k.contiguous() if train_input else k,
                v.contiguous() if train_input else v, rk.contiguous(), rv.contiguous(),
                scale=scale, v_affine=affine, include_input=train_input,
            )
        else:
            out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale=scale)
    else:
        if ref_kv is not None:
            k, v = widen_kv(k, v, ref_kv[0], ref_kv[1], use_adain=use_adain,
                            train_input=train_input)
        out = softmax_attention(q, k, v, scale, return_probs=save_probs)
        if save_probs:
            out, aux["probs"] = out
    return _to_out_from_heads(p["to_out"], out, lora_scaling=lora_scaling), aux
