"""NN primitives over param dicts: NHWC convolutions, linears, norms,
activations, LoRA, timestep embedding, and random initialisers.

Counterpart of ``instantrestore_tpu/ops/primitives.py``. Activations keep the
JAX package's NHWC layout at every function boundary; a convolution views its
NHWC input as a channels-last NCHW tensor (a free permute), so cuDNN runs it
without a relayout copy. Only the functions are ported, not the TPU conv
formulations (im2col, space-to-depth, tap matmul, sub-pixel upsampling):
those are layout choices for the TPU's matrix unit with the same results.

LoRA is data: a param dict may carry ``lora_A``/``lora_B`` (peft layouts)
and the delta ``scaling * B(A(x))`` is added by the caller-given scaling.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


# ---------------------------------------------------------------------------
# linear / conv with optional LoRA
# ---------------------------------------------------------------------------


def dense(p: dict, x: torch.Tensor, *, lora_scaling: float = 1.0) -> torch.Tensor:
    """y = x @ W^T + b (+ scaling * (x @ A^T) @ B^T); ``weight`` [out, in]."""
    dtype = x.dtype
    y = F.linear(x, p["weight"].to(dtype), _cast(p.get("bias"), dtype))
    if "lora_A" in p:
        y = y + F.linear(F.linear(x, p["lora_A"].to(dtype)), p["lora_B"].to(dtype)) * lora_scaling
    return y


def conv2d(
    p: dict,
    x: torch.Tensor,
    *,
    stride: int = 1,
    padding: int = 1,
    lora_scaling: float = 1.0,
) -> torch.Tensor:
    """NHWC conv with an OIHW ``weight`` and optional peft conv-LoRA (a kxk
    conv in->r with the base conv's stride/padding, then a 1x1 conv r->out)."""
    dtype = x.dtype
    xc = x.permute(0, 3, 1, 2)
    y = F.conv2d(xc, p["weight"].to(dtype), _cast(p.get("bias"), dtype), stride, padding)
    if "lora_A" in p:
        a = F.conv2d(xc, p["lora_A"].to(dtype), None, stride, padding)
        y = y + F.conv2d(a, p["lora_B"].to(dtype)) * lora_scaling
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# normalisation (fp32 statistics)
# ---------------------------------------------------------------------------


def group_norm(p: dict, x: torch.Tensor, *, num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC input with fp32 statistics.

    fp32 inputs use the exact two-pass formula. Reduced-precision inputs take
    the JAX package's memory-light form: fp32 mean and mean-square reduced
    straight from the NHWC activation (no fp32 copy, no NCHW relayout), then
    one ``x * a + b`` pass with per-(batch, channel) coefficients in x's dtype.
    """
    if x.dtype == torch.float32:
        y = F.group_norm(x.permute(0, 3, 1, 2), num_groups, p["weight"].float(),
                         p["bias"].float(), eps)
        return y.permute(0, 2, 3, 1)
    b, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    xg = x.reshape(b, -1, num_groups, cg)
    n = xg.shape[1] * cg
    mean = xg.mean(dim=(1, 3), dtype=torch.float32)  # [B, G]
    m2 = torch.linalg.vector_norm(xg, dim=(1, 3), dtype=torch.float32).square() / n
    inv = torch.rsqrt((m2 - mean * mean).clamp_min(0.0) + eps)
    a = inv.repeat_interleave(cg, dim=1) * p["weight"].float()  # [B, C]
    shift = p["bias"].float() - mean.repeat_interleave(cg, dim=1) * a
    shape = (b,) + (1,) * (x.ndim - 2) + (c,)
    return torch.addcmul(shift.to(x.dtype).view(shape), x, a.to(x.dtype).view(shape))


def layer_norm(p: dict, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in fp32 and cast back."""
    y = F.layer_norm(
        x.float(), (x.shape[-1],), p["weight"].float(), p["bias"].float(), eps
    )
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# activations and resampling
# ---------------------------------------------------------------------------


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as diffusers' GEGLU uses."""
    return F.gelu(x, approximate="none")


def geglu(p: dict, x: torch.Tensor, *, lora_scaling: float = 1.0) -> torch.Tensor:
    """diffusers GEGLU: project to 2*d_ff, gate with exact GELU."""
    h, gate = dense(p, x, lora_scaling=lora_scaling).chunk(2, dim=-1)
    return h * gelu(gate)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of [B, H, W, C]."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    return y.permute(0, 2, 3, 1)


def upsample2x_conv(p: dict, x: torch.Tensor, *, lora_scaling: float = 1.0) -> torch.Tensor:
    """Nearest-2x upsample followed by a 3x3 'same' conv."""
    return conv2d(p, nearest_upsample_2x(x), lora_scaling=lora_scaling)


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    *,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: int = 10000,
) -> torch.Tensor:
    """Sinusoidal embedding [B] -> [B, dim] fp32 (diffusers
    get_timestep_embedding), with the same explicit mod-2pi range reduction
    as the JAX package."""
    half = dim // 2
    freqs = torch.from_numpy(
        np.exp(-np.log(max_period) * np.arange(half) / (half - downscale_freq_shift)).astype(
            np.float32
        )
    ).to(timesteps.device)
    args = timesteps.float()[:, None] * freqs[None, :]
    two_pi = 2.0 * math.pi
    args = args - two_pi * torch.floor(args / two_pi)
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


# ---------------------------------------------------------------------------
# random initialisers (random weights for smoke runs; real weights arrive
# through convert.py). Same distributions as the JAX package's initialisers.
# ---------------------------------------------------------------------------


def _uniform(gen: torch.Generator, shape, bound: float, device) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0) * bound


def init_dense(gen, in_dim: int, out_dim: int, *, bias: bool = True, device=None) -> dict:
    p = {"weight": _uniform(gen, (out_dim, in_dim), 1.0 / math.sqrt(in_dim), device)}
    if bias:
        p["bias"] = torch.zeros(out_dim, device=device)
    return p


def init_conv2d(gen, in_ch: int, out_ch: int, kernel_size: int = 3, *, device=None) -> dict:
    bound = 1.0 / math.sqrt(in_ch * kernel_size * kernel_size)
    return {
        "weight": _uniform(gen, (out_ch, in_ch, kernel_size, kernel_size), bound, device),
        "bias": torch.zeros(out_ch, device=device),
    }


def init_norm(dim: int, *, device=None) -> dict:
    return {"weight": torch.ones(dim, device=device), "bias": torch.zeros(dim, device=device)}


def add_lora(p: dict, gen, rank: int, *, b_std: float, device=None) -> dict:
    """Attach peft-layout LoRA factors: A ~ N(0, 1/rank) (peft "gaussian"),
    B ~ N(0, b_std) (peft starts B at zero; a nonzero ``b_std`` gives random
    smoke weights a LoRA delta that merging actually changes)."""
    w = p["weight"]
    out_ch, in_ch = w.shape[:2]
    a_shape = (rank, in_ch) + tuple(w.shape[2:])
    b_shape = (out_ch, rank) + ((1, 1) if w.ndim == 4 else ())
    p = dict(p)
    p["lora_A"] = torch.randn(a_shape, generator=gen, device=device) / rank
    p["lora_B"] = torch.randn(b_shape, generator=gen, device=device) * b_std
    return p
