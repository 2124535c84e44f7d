"""Differentiable fused attention: the forward that keeps each row's
log-sum-exp and the two backward kernels that recompute the probabilities
from it (counterpart of ``instantrestore_tpu/ops/flash_vjp.py``).

Each kernel comes as a wrapper, a plain PyTorch version of the same function
and a launch count:

* ``flash_fwd_lse`` -> CUDA kernel ``csrc/flash_fwd_lse.cu`` (replaces the TPU
  kernel ``_fwd_lse_kernel``); plain version ``flash_fwd_lse_plain``. It runs
  on ``flash_online``'s tiles: at d = 64 the wgmma + TMA tile of
  ``csrc/attn_wgmma.cuh``, at d = 512 that of ``csrc/attn_wgmma_d512.cuh``,
  on the key chunk of ``ops.shared_attention.flash_online_chunk`` (32 keys at
  d = 512).
* ``flash_bwd_dq`` -> ``csrc/flash_bwd_dq.cu`` (replaces ``_bwd_dq_kernel``);
  plain ``flash_bwd_dq_plain``.
* ``flash_bwd_dkv`` -> ``csrc/flash_bwd_dkv.cu`` (replaces
  ``_bwd_dkv_kernel``); plain ``flash_bwd_dkv_plain``.

At d = 64 the two backward kernels run on the wgmma + TMA tile of
``csrc/attn_wgmma_bwd.cuh`` (any Sq and Skv), at d = 512 on that of
``csrc/attn_wgmma_bwd_d512.cuh`` (the d = 512 forward's shapes);
``flash_bwd_tiles`` gives both kernels their block and chunk and refuses,
before any launch, a shape the tiles do not take.

A wrapper given CUDA tensors launches its kernel (bf16 only) on their card
(``shared_attention._launch``) or raises; given CPU tensors it runs the
plain version. ``<wrapper>.launches`` counts kernel launches and nothing
else.

``flash_attention`` and ``shared_flash_attention`` are drop-ins for the
functions of the same names in ``ops/shared_attention.py``. When no input
wants a gradient they call those (the inference kernels, chosen by
``INSTANTRESTORE_FLASH_ALGO`` / ``INSTANTRESTORE_ATTN_ALGO``), as the JAX
package's primal does. When one does, the forward is ``flash_fwd_lse`` and
the backward ``flash_bwd_dq`` + ``flash_bwd_dkv``; the shared attention first
widens K/V over the references in plain torch (fp32 AdaIN affine ``v * a +
c``, cast back, input segment first) and splits the wide gradients again
afterwards, as the JAX package does outside its Pallas bodies.

Numerics (shared with the JAX package): logits in log2 units from q
pre-scaled by ``scale * log2 e`` in the input dtype; the forward is the
online softmax of ``flash_online`` (at d < 128 ``p = exp2(bf16(s - m_new))``
summed as rounded, at d >= 128 fp32 p for the sum) and also returns ``lse2 =
m + log2(row sum)`` as fp32 [B, H, Sq] (the TPU stores it broadcast over 128
lanes). The backward recomputes ``P = exp2(s2 - lse2)`` in fp32 with no
rounding of the argument, so at d < 128 its rows do not sum to exactly 1;
``dS = (P * (dO v^T - delta) * scale)`` rounded to the input dtype, ``delta =
rowsum(dO * O)`` in fp32, fp32 accumulators, outputs in the input dtype. Two
backward kernels and no atomics: gradients repeat bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from instantrestore_tpu_torch.ops import shared_attention as sa
from instantrestore_tpu_torch.ops.shared_attention import (  # re-exported
    LOG2E,
    adain_affine,
)

# ---------------------------------------------------------------------------
# kernel 4: forward with the log-sum-exp residual
# ---------------------------------------------------------------------------


def flash_fwd_lse_plain(q, k, v, *, scale: float, block_k: Optional[int] = None):
    """Plain PyTorch version of ``csrc/flash_fwd_lse.cu``: q [B, H, Sq, d],
    k/v [B, H, Skv, d] -> (out [B, H, Sq, d], lse2 [B, H, Sq] fp32), the
    running max taken over key chunks of ``min(block_k, Skv)``, by default
    the kernel's (``flash_online_chunk``)."""
    skv, d = k.shape[2], q.shape[-1]
    bk = sa.flash_online_chunk(skv, d) if block_k is None else min(block_k, skv)
    return sa._online_softmax_av(sa._q_scaled(q, scale), k, v, q.dtype, block_k=bk,
                                 arg_rounded=d < 128, return_lse=True)


def flash_fwd_lse(q, k, v, *, scale: float,
                  block_k: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T * scale) v and each row's log-sum-exp in log2 units.
    Shapes and the CUDA kernel's limits as ``ops.shared_attention
    .flash_online``. ``block_k`` is the key chunk of the running max
    (default ``flash_online_chunk``'s); the kernel takes the chunks of
    ``check_flash_chunk``, and raises on any other."""
    if q.device.type == "cpu":
        return flash_fwd_lse_plain(q, k, v, scale=scale, block_k=block_k)
    sa._check_flash("flash_fwd_lse", q, k, v, sa._flash_tiles_fit)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if block_k is None:
        block_k = sa.flash_online_chunk(skv, d)
    sa.check_flash_chunk("flash_fwd_lse", skv, d, block_k)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    sa._launch(flash_fwd_lse, "flash_fwd_lse", q,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
               b, h, sq, skv, d, block_k, ctypes.c_float(scale * LOG2E))
    return out, lse


flash_fwd_lse.launches = 0


# ---------------------------------------------------------------------------
# kernels 5 and 6: the backward
# ---------------------------------------------------------------------------


class BwdTiles(NamedTuple):
    """The backward kernels' tiles: ``flash_bwd_dq``'s query rows a block and
    the key chunk it streams, ``flash_bwd_dkv``'s keys a block and the query
    chunk it streams."""

    dq_rows: int
    dq_chunk: int
    dkv_rows: int
    dkv_chunk: int


BWD_CHUNK = 64  # streamed rows a stage of csrc/attn_wgmma_bwd.cuh (d = 64)
D512_BWD_CHUNK = 16  # streamed rows a stage of csrc/attn_wgmma_bwd_d512.cuh


def flash_bwd_tiles(sq: int, skv: int, d: int) -> BwdTiles:
    """The tiles of ``flash_bwd_dq`` and ``flash_bwd_dkv`` for Sq queries
    against Skv keys at head dim d: they take the forward's shapes
    (``ops.shared_attention._flash_tiles_fit``). d = 64
    (``csrc/attn_wgmma_bwd.cuh``): 128 rows a block (two consumer
    warpgroups) where they divide the block's side and (dQ) 64 divides Skv,
    else 64, and chunks of 64. d = 512 (``csrc/attn_wgmma_bwd_d512.cuh``): 64
    rows a block and chunks of 16. Raises on what the tiles do not take; the
    C entry points refuse any other tile."""
    if not sa._flash_tiles_fit(sq, skv, d):
        raise ValueError(f"flash_bwd: the backward kernels take d = 64, or d = 512 with Sq % 64 "
                         f"== 0 and Skv % 32 == 0, not Sq {sq}, Skv {skv}, d {d}")
    if d == 512:
        return BwdTiles(64, D512_BWD_CHUNK, 64, D512_BWD_CHUNK)
    wide_q = sq % 128 == 0 and skv % BWD_CHUNK == 0
    return BwdTiles(128 if wide_q else 64, BWD_CHUNK, 128 if skv % 128 == 0 else 64, BWD_CHUNK)


def _chunk(other: int) -> int:
    """Rows per block so that a [rows, other] fp32 score block stays within
    the plain versions' budget."""
    return max(1, sa._PLAIN_BLOCK_ELEMS // max(1, other))


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, scale: float,
                       block_k: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/flash_bwd_dq.cu`` (its tiles
    ``csrc/attn_wgmma_bwd.cuh`` at d = 64, ``csrc/attn_wgmma_bwd_d512.cuh`` at
    d = 512): dQ [B, H, Sq, d] from q/do [B, H, Sq, d], k/v [B, H, Skv, d],
    lse2/delta [B, H, Sq] fp32, summed over key chunks of ``block_k``
    (default: what bounds the fp32 score block; the chunk only orders the
    fp32 sum)."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if block_k is None:
        block_k = _chunk(b * h * sq)
    qs = sa._q_scaled(q, scale).float()
    dof = do.float()
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for j in range(0, skv, block_k):
        kf = k[:, :, j : j + block_k].float()
        p = torch.exp2(qs @ kf.transpose(-1, -2) - lse[..., None])
        dp = dof @ v[:, :, j : j + block_k].float().transpose(-1, -2)
        ds = (p * (dp - delta[..., None]) * scale).to(k.dtype)
        acc += ds.float() @ kf
    return acc.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, scale: float,
                        block_q: Optional[int] = None):
    """Plain PyTorch version of ``csrc/flash_bwd_dkv.cu`` (its tiles as
    ``flash_bwd_dq_plain``'s): (dK, dV) [B, H, Skv, d], summed over query
    chunks of ``block_q`` (default as ``flash_bwd_dq_plain``'s
    ``block_k``). Shapes as there."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if block_q is None:
        block_q = _chunk(b * h * skv)
    kf, vf = k.float(), v.float()
    acc_k = torch.zeros((b, h, skv, d), dtype=torch.float32, device=q.device)
    acc_v = torch.zeros_like(acc_k)
    for i in range(0, sq, block_q):
        rows = slice(i, i + block_q)
        qi, doi = q[:, :, rows], do[:, :, rows].float()
        s2t = kf @ sa._q_scaled(qi, scale).float().transpose(-1, -2)  # [B, H, Skv, bq]
        pt = torch.exp2(s2t - lse[:, :, None, rows])
        acc_v += pt.to(do.dtype).float() @ doi
        dpt = vf @ doi.transpose(-1, -2)
        dst = (pt * (dpt - delta[:, :, None, rows]) * scale).to(q.dtype)
        acc_k += dst.float() @ qi.float()
    return acc_k.to(k.dtype), acc_v.to(v.dtype)


def _check_backward(name: str, q, k, v, do, lse, delta, qs) -> BwdTiles:
    """The backward kernels' inputs (``_flash_tiles_fit``, bf16 q and dO,
    fp32 lse and delta of [B, H, Sq], and a given qs bf16 of q's shape) and
    their tiles; raises before any launch."""
    sa._check_flash(name, q, k, v, sa._flash_tiles_fit)
    f32 = torch.float32
    sa._check_cuda(name, (q, torch.bfloat16), (do, torch.bfloat16), (lse, f32), (delta, f32))
    if do.shape != q.shape or lse.shape != q.shape[:3] or delta.shape != q.shape[:3]:
        raise ValueError(f"{name}: dO {tuple(do.shape)}, lse {tuple(lse.shape)}, delta "
                         f"{tuple(delta.shape)} do not fit q {tuple(q.shape)}")
    if qs is not None:
        sa._check_cuda(name, (q, torch.bfloat16), (qs, torch.bfloat16))
        if qs.shape != q.shape:
            raise ValueError(f"{name}: qs {tuple(qs.shape)} does not fit q {tuple(q.shape)}")
    return flash_bwd_tiles(q.shape[2], k.shape[2], q.shape[-1])


@functools.lru_cache(maxsize=64)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(value, dtype=dtype))


def _backward_qs(q, scale: float) -> torch.Tensor:
    """The scaled q that both tiles read: ``sa._q_scaled``'s bits (the
    forward's), with the constant rounded on the host instead of copied to
    the device."""
    return q * _rounded(scale * LOG2E, q.dtype)


def _lse_rows(lse, delta):
    """(lse, delta, pitch) as the kernels read them: [B, H, pitch] with
    pitch = Sq where 64 divides it, else Sq rounded up to 64 with zeros past
    Sq (the d = 64 dK/dV tile bulk-copies 64 of each a query chunk)."""
    sq = lse.shape[-1]
    pitch = -(-sq // BWD_CHUNK) * BWD_CHUNK
    if pitch == sq:
        return lse, delta, sq
    pad = (0, pitch - sq)
    return (torch.nn.functional.pad(lse, pad), torch.nn.functional.pad(delta, pad), pitch)


def flash_bwd_dq(q, k, v, do, lse, delta, *, scale: float,
                 qs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dQ of softmax(q k^T * scale) v given the output gradient ``do``, the
    forward's ``lse`` and ``delta = rowsum(do * out)``. Shapes as
    ``flash_bwd_dq_plain``; the CUDA kernel (``csrc/flash_bwd_dq.cu``: the
    wgmma + TMA tiles of ``csrc/attn_wgmma_bwd.cuh`` at d = 64 and
    ``csrc/attn_wgmma_bwd_d512.cuh`` at d = 512) takes the tiles of
    ``flash_bwd_tiles``. ``qs``, ``q * (scale * log2 e)`` in bf16, may be
    given where the caller has it (``_flash_backward`` shares it with
    ``flash_bwd_dkv``); else the wrapper computes it."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, scale=scale)
    tiles = _check_backward("flash_bwd_dq", q, k, v, do, lse, delta, qs)
    if qs is None:
        qs = _backward_qs(q, scale)
    b, h, sq, d = q.shape
    lse, delta, pitch = _lse_rows(lse, delta)
    dq = torch.empty_like(q)
    sa._launch(flash_bwd_dq, "flash_bwd_dq", q,
               q.data_ptr(), qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
               lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, sq, k.shape[2], d,
               tiles.dq_rows, tiles.dq_chunk, pitch, ctypes.c_float(scale))
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, *, scale: float,
                  qs: Optional[torch.Tensor] = None):
    """(dK, dV) of softmax(q k^T * scale) v; arguments as ``flash_bwd_dq``.
    The CUDA kernel is ``csrc/flash_bwd_dkv.cu`` on the same two tiles (at
    d = 512 two launches of its tile, dV then dK)."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale=scale)
    tiles = _check_backward("flash_bwd_dkv", q, k, v, do, lse, delta, qs)
    if qs is None:
        qs = _backward_qs(q, scale)
    b, h, sq, d = q.shape
    lse, delta, pitch = _lse_rows(lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    sa._launch(flash_bwd_dkv, "flash_bwd_dkv", q,
               q.data_ptr(), qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
               lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, sq,
               k.shape[2], d, tiles.dkv_rows, tiles.dkv_chunk, pitch, ctypes.c_float(scale))
    return dk, dv


flash_bwd_dkv.launches = 0


def _flash_backward(q, k, v, out, lse, do, scale: float, want_q: bool, want_kv: bool):
    """(dq, dk, dv) through the two backward kernels; an unwanted side is
    None and its kernel is not launched. ``do`` may be any view."""
    do = do.contiguous()
    delta = (do.float() * out.float()).sum(dim=-1)
    # the scaled q, once for both kernels (the plain versions scale their own)
    qs = None if q.device.type == "cpu" else _backward_qs(q, scale)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale=scale, qs=qs) if want_q else None
    dk, dv = (flash_bwd_dkv(q, k, v, do, lse, delta, scale=scale, qs=qs) if want_kv
              else (None, None))
    return dq, dk, dv


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


# ---------------------------------------------------------------------------
# plain flash attention, differentiable
# ---------------------------------------------------------------------------


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_fwd_lse(q, k, v, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        need = ctx.needs_input_grad
        dq, dk, dv = _flash_backward(q, k, v, out, lse, do, ctx.scale, need[0],
                                     need[1] or need[2])
        return dq, dk if need[1] else None, dv if need[2] else None, None


def flash_attention(q, k, v, *, scale: float, algo: Optional[str] = None) -> torch.Tensor:
    """Differentiable drop-in for ``ops.shared_attention.flash_attention``:
    the same call (the inference kernel ``algo`` selects) when no input wants
    a gradient, else ``flash_fwd_lse`` with the kernel backward."""
    if not _wants_grad(q, k, v):
        return sa.flash_attention(q, k, v, scale=scale, algo=algo)
    return _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(), float(scale))


# ---------------------------------------------------------------------------
# shared-image attention, differentiable
# ---------------------------------------------------------------------------


def _widen(k_in, v_in, ref_k, ref_v, vs, vh, include_input: bool):
    """[B, N, H, S, d] references -> wide K/V [B, H, (1 +) N * S, d] with the
    affine ``v * vs + vh`` applied in fp32 and cast back; the input segment
    first."""
    b, n, h, s, d = ref_k.shape
    rk = ref_k.permute(0, 2, 1, 3, 4).reshape(b, h, n * s, d).to(k_in.dtype)
    rv = ref_v.permute(0, 2, 1, 3, 4).float() * vs[:, :, :, None, :] + vh[:, :, :, None, :]
    rv = rv.reshape(b, h, n * s, d).to(v_in.dtype)
    if include_input:
        return torch.cat([k_in, rk], dim=2), torch.cat([v_in, rv], dim=2)
    return rk.contiguous(), rv.contiguous()


class _Shared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k_in, v_in, ref_k, ref_v, vs, vh, scale, include_input):
        wide_k, wide_v = _widen(k_in, v_in, ref_k, ref_v, vs, vh, include_input)
        # the shared kernels' chunk at d = 64, flash_online_chunk's at other
        # widths (32 keys at d = 512, the kernel's), so that no chunk
        # straddles two segments; where 64 does not divide a segment at
        # d = 64 (no kernel chunk does), the plain layout's chunk over the
        # wide keys
        s, d = ref_k.shape[3], q.shape[-1]
        if d == 64 and s % sa.ONLINE_BLOCK_K:
            chunk = sa.flash_online_chunk(wide_k.shape[2], d)
        else:
            chunk = sa.shared_online_chunk(s, None if d == 64 else sa.flash_online_chunk(s, d))
        out, lse = flash_fwd_lse(q, wide_k, wide_v, scale=scale, block_k=chunk)
        # the wide K/V are rebuilt in the backward, not kept
        ctx.save_for_backward(q, k_in, v_in, ref_k, ref_v, vs, vh, out, lse)
        ctx.scale, ctx.include_input = scale, include_input
        return out

    @staticmethod
    def backward(ctx, do):
        q, k_in, v_in, ref_k, ref_v, vs, vh, out, lse = ctx.saved_tensors
        need = ctx.needs_input_grad
        b, n, h, s, d = ref_k.shape
        inc = ctx.include_input
        wide_k, wide_v = _widen(k_in, v_in, ref_k, ref_v, vs, vh, inc)
        want_kv = (inc and (need[1] or need[2])) or any(need[3:7])
        dq, dkw, dvw = _flash_backward(q, wide_k, wide_v, out, lse, do, ctx.scale, need[0],
                                       want_kv)
        grads = [dq, None, None, None, None, None, None, None, None]
        if not want_kv:
            return tuple(grads)
        off = s if inc else 0
        if inc and need[1]:
            grads[1] = dkw[:, :, :s]
        if inc and need[2]:
            grads[2] = dvw[:, :, :s]
        if need[3]:
            grads[3] = dkw[:, :, off:].reshape(b, h, n, s, d).permute(0, 2, 1, 3, 4).to(ref_k.dtype)
        if any(need[4:7]):
            dv_eff = dvw[:, :, off:].reshape(b, h, n, s, d).float()  # d(ref_v * vs + vh)
            if need[4]:
                grads[4] = (dv_eff * vs[:, :, :, None, :]).permute(0, 2, 1, 3, 4).to(ref_v.dtype)
            if need[5]:
                grads[5] = (dv_eff * ref_v.permute(0, 2, 1, 3, 4).float()).sum(dim=3).to(vs.dtype)
            if need[6]:
                grads[6] = dv_eff.sum(dim=3).to(vh.dtype)
        return tuple(grads)


def shared_flash_attention(q, k_in, v_in, ref_k, ref_v, *, scale: float,
                           v_affine: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                           include_input: bool = True,
                           algo: Optional[str] = None) -> torch.Tensor:
    """Differentiable drop-in for ``ops.shared_attention
    .shared_flash_attention`` (shapes there): the same call when no input
    wants a gradient, else the widened ``flash_fwd_lse`` forward with the
    kernel backward and gradients for q, k_in, v_in (none without the input
    segment), ref_k, ref_v and the affine, each only where asked."""
    affine = v_affine or ()
    if not _wants_grad(q, k_in, v_in, ref_k, ref_v, *affine):
        return sa.shared_flash_attention(q, k_in, v_in, ref_k, ref_v, scale=scale,
                                         v_affine=v_affine, include_input=include_input,
                                         algo=algo)
    b, h, _, d = q.shape
    n = ref_k.shape[1]
    if v_affine is None:
        vs = torch.ones((b, h, n, d), dtype=torch.float32, device=q.device)
        vh = torch.zeros_like(vs)
    else:
        vs, vh = (a.float() for a in v_affine)
    if include_input:
        k_in, v_in = k_in.contiguous(), v_in.contiguous()
    return _Shared.apply(q.contiguous(), k_in, v_in, ref_k, ref_v, vs, vh, float(scale),
                         bool(include_input))


KERNEL_WRAPPERS = sa.KERNEL_WRAPPERS + (flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv)


def reset_launch_counts() -> None:
    """Zero the launch count of every kernel wrapper of the port."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launches in this process, by its name."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add launches made in another process on this one's behalf (the
    serving engine's worker processes, ``inference/workers.py``) to the
    wrappers' counts, so that they count every launch of a call."""
    by_name = {fn.__name__: fn for fn in KERNEL_WRAPPERS}
    with sa._count_lock:
        for name, n in counts.items():
            by_name[name].launches += n
