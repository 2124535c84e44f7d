"""Plain PyTorch reference of InstantRestore's restore (fp32, NCHW).

Written from the published description, not from the program under test:
SD-Turbo's UNet2DConditionModel and AutoencoderKL (diffusers), FreeU
(s1 0.9, s2 0.2, b1 1.4, b2 1.6), the DDPM scaled-linear schedule, and
InstantRestore's shared attention (``face_replace``): the 9 self-attentions
of the cross-attention up blocks attend over the keys and values that a
frozen copy of the UNet (no LoRA, its own ``conv_in``) captured from the
reference photos at timestep 1, the reference values moved to the input
values' statistics (AdaIN, unbiased std + 1e-5), and without the input's own
keys when ``train_input`` is off. A restore encodes the degraded photo,
noises its latent to the serving timestep, predicts the noise once, takes
the closed-form x0 and decodes it.

Conventions: images ``[B, H, W, 3]`` (NHWC, as served) in [-1, 1]; noise
``[B, h, w, 4]`` NHWC as the program takes it; everything inside is NCHW
fp32. LoRA is merged here from the unmerged tree (``W + s B A``).
It imports torch and numpy only: no kernel, no cache, no batching tricks.
Works on the ``meta`` device too (FreeU's FFT is then skipped: it has no
matrix work), which is how ``gpubench/flops.py`` counts the model's work.
"""

from __future__ import annotations

import contextvars
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FREEU = {0: (1.4, 0.9), 1: (1.6, 0.2)}  # up block -> (backbone scale b, skip scale s)
# the open ``AttentionRecord``, if any
_ATTENTION_CALLS: contextvars.ContextVar = contextvars.ContextVar("attention_calls", default=None)


class AttentionRecord(list):
    """A list that, while open as a context, receives every attention call
    of the forwards run inside it as (kind, q shape [B, H, Sq, d], k shape
    [B, H, Skv, d]); kinds ``self`` (a UNet self-attention), ``shared`` (one
    widened with the references), ``cross`` (over the prompt) and ``vae``
    (the VAE's mid attention)."""

    def __enter__(self) -> "AttentionRecord":
        self._token = _ATTENTION_CALLS.set(self)
        return self

    def __exit__(self, *exc) -> None:
        _ATTENTION_CALLS.reset(self._token)


# ---------------------------------------------------------------- building blocks


def merged(p: Dict[str, torch.Tensor], scaling: float) -> torch.Tensor:
    """The module's fp32 weight with its LoRA delta folded in."""
    w = p["weight"].float()
    if "lora_A" not in p:
        return w
    a, b = p["lora_A"].float(), p["lora_B"].float()
    if w.ndim == 4:
        delta = torch.einsum("or,rihw->oihw", b.flatten(1), a)
    else:
        delta = b @ a
    return w + scaling * delta


def linear(p, x, s: float = 1.0):
    bias = p.get("bias")
    return F.linear(x, merged(p, s), None if bias is None else bias.float())


def conv(p, x, s: float = 1.0, stride: int = 1, padding: Optional[int] = None):
    w = merged(p, s)
    if padding is None:
        padding = w.shape[-1] // 2
    return F.conv2d(x, w, p["bias"].float(), stride, padding)


def gnorm(p, x, groups: int, eps: float):
    return F.group_norm(x, groups, p["weight"].float(), p["bias"].float(), eps)


def lnorm(p, x, eps: float = 1e-5):
    return F.layer_norm(x, (x.shape[-1],), p["weight"].float(), p["bias"].float(), eps)


def attend(q, k, v, scale: float, kind: str):
    """softmax(q k^T scale) v over [B, H, S, d]."""
    calls = _ATTENTION_CALLS.get()
    if calls is not None:
        calls.append((kind, tuple(q.shape), tuple(k.shape)))
    return torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1) @ v


def heads_split(x, h: int):
    b, s, c = x.shape
    return x.reshape(b, s, h, c // h).transpose(1, 2)


def heads_merge(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def alphas_cumprod(device) -> torch.Tensor:
    """SD's scaled-linear DDPM schedule: 1000 steps, betas in [0.00085, 0.012]."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000, dtype=np.float64) ** 2
    return torch.tensor(np.cumprod(1.0 - betas), dtype=torch.float32, device=device)


def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' sinusoidal embedding, flip_sin_to_cos, shift 0 (float64 args)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float64,
                                                          device=t.device) / half)
    args = t.to(torch.float64)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1).float()


def fourier_filter(x, scale: float):
    """diffusers' FreeU ``fourier_filter(threshold=1)``: the 2 x 2 lowest
    frequencies around the shifted centre scaled by ``scale``."""
    if x.is_meta:
        return x
    h, w = x.shape[-2:]
    xf = torch.fft.fftshift(torch.fft.fftn(x.double(), dim=(-2, -1)), dim=(-2, -1))
    mask = torch.ones(h, w, dtype=torch.float64, device=x.device)
    mask[h // 2 - 1:h // 2 + 1, w // 2 - 1:w // 2 + 1] = scale
    xf = torch.fft.ifftshift(xf * mask, dim=(-2, -1))
    return torch.fft.ifftn(xf, dim=(-2, -1)).real.float()


# ---------------------------------------------------------------- UNet


def resnet(p, x, temb, groups: int, eps: float, s: float):
    h = conv(p["conv1"], F.silu(gnorm(p["norm1"], x, groups, eps)), s)
    if temb is not None:
        h = h + linear(p["time_emb_proj"], F.silu(temb), s)[:, :, None, None]
    h = conv(p["conv2"], F.silu(gnorm(p["norm2"], h, groups, eps)), s)
    if "conv_shortcut" in p:
        x = conv(p["conv_shortcut"], x, s, padding=0)
    return x + h


def self_attention(p, h, heads: int, s: float, mode: Dict[str, Any]):
    """attn1 of a transformer block. ``mode``: {} plain; {"capture": list}
    appends this layer's (k, v) [B, H, S, d]; {"refs": (rk, rv) [B, N, H, S,
    d], "adain": bool, "train_input": bool} widens the keys with the
    references."""
    q = heads_split(linear(p["to_q"], h, s), heads)
    k = heads_split(linear(p["to_k"], h, s), heads)
    v = heads_split(linear(p["to_v"], h, s), heads)
    if "capture" in mode:
        mode["capture"].append((k, v))
    if "refs" in mode:
        rk, rv = mode["refs"]
        b, n, hh, sr, d = rk.shape
        if mode["adain"]:
            s_mean, s_std = v.mean(dim=2, keepdim=True), v.std(dim=2, keepdim=True) + 1e-5
            c_mean, c_std = rv.mean(dim=3, keepdim=True), rv.std(dim=3, keepdim=True) + 1e-5
            rv = (rv - c_mean) / c_std * s_std[:, None] + s_mean[:, None]
        rk = rk.transpose(1, 2).reshape(b, hh, n * sr, d)
        rv = rv.transpose(1, 2).reshape(b, hh, n * sr, d)
        if mode["train_input"]:
            k, v = torch.cat([k, rk], dim=2), torch.cat([v, rv], dim=2)
        else:
            k, v = rk, rv
    out = attend(q, k, v, q.shape[-1] ** -0.5, "shared" if "refs" in mode else "self")
    return linear(p["to_out"], heads_merge(out), s)


def cross_attention(p, h, ctx, heads: int, s: float):
    q = heads_split(linear(p["to_q"], h, s), heads)
    k = heads_split(linear(p["to_k"], ctx, s), heads)
    v = heads_split(linear(p["to_v"], ctx, s), heads)
    return linear(p["to_out"], heads_merge(attend(q, k, v, q.shape[-1] ** -0.5, "cross")), s)


def transformer(p, x, ctx, heads: int, u: Dict[str, Any], s: float, mode: Dict[str, Any]):
    b, c, hh, ww = x.shape
    h = gnorm(p["norm"], x, u["norm_num_groups"], u["transformer_norm_eps"])
    h = linear(p["proj_in"], h.flatten(2).transpose(1, 2), s)
    for bp in p["transformer_blocks"]:
        h = h + self_attention(bp["attn1"], lnorm(bp["norm1"], h), heads, s, mode)
        h = h + cross_attention(bp["attn2"], lnorm(bp["norm2"], h), ctx, heads, s)
        a, gate = linear(bp["ff"]["net_0_proj"], lnorm(bp["norm3"], h), s).chunk(2, dim=-1)
        h = h + linear(bp["ff"]["net_2"], a * F.gelu(gate), s)
    h = linear(p["proj_out"], h, s)
    return h.transpose(1, 2).reshape(b, c, hh, ww) + x


def unet(p, x, t, ctx, u: Dict[str, Any], s: float, shared: Optional[List] = None,
         adain: bool = False, train_input: bool = True, capture: Optional[List] = None):
    """eps [B, 4, h, w] from x [B, 4, h, w], t [B], ctx [B, T, C]. ``shared``:
    one (rk, rv) per shared layer; ``capture``: a list that receives each
    shared layer's (k, v)."""
    groups, eps = u["norm_num_groups"], u["norm_eps"]
    heads, chs = u["attention_head_dim"], u["block_out_channels"]
    temb = linear(p["time_embedding"]["linear_1"], time_embedding(t, chs[0]))
    temb = linear(p["time_embedding"]["linear_2"], F.silu(temb))
    x = conv(p["conv_in"], x, s)
    skips = [x]
    for i, bp in enumerate(p["down_blocks"]):
        for j, rp in enumerate(bp["resnets"]):
            x = resnet(rp, x, temb, groups, eps, s)
            if "attentions" in bp:
                x = transformer(bp["attentions"][j], x, ctx, heads[i], u, s, {})
            skips.append(x)
        if "downsamplers" in bp:
            x = conv(bp["downsamplers"][0]["conv"], x, s, stride=2)
            skips.append(x)
    mp = p["mid_block"]
    x = resnet(mp["resnets"][0], x, temb, groups, eps, s)
    x = transformer(mp["attentions"][0], x, ctx, heads[-1], u, s, {})
    x = resnet(mp["resnets"][1], x, temb, groups, eps, s)
    layer = 0
    for i, bp in enumerate(p["up_blocks"]):
        for j, rp in enumerate(bp["resnets"]):
            skip = skips.pop()
            if i in FREEU:
                b_scale, s_scale = FREEU[i]
                half = x.shape[1] // 2
                x = torch.cat([x[:, :half] * b_scale, x[:, half:]], dim=1)
                skip = fourier_filter(skip, s_scale)
            x = resnet(rp, torch.cat([x, skip], dim=1), temb, groups, eps, s)
            if "attentions" in bp:
                mode: Dict[str, Any] = {}
                if capture is not None:
                    mode["capture"] = capture
                if shared is not None:
                    mode.update(refs=shared[layer], adain=adain, train_input=train_input)
                x = transformer(bp["attentions"][j], x, ctx, heads[len(chs) - 1 - i], u, s, mode)
                layer += 1
        if "upsamplers" in bp:
            x = conv(bp["upsamplers"][0]["conv"], F.interpolate(x, scale_factor=2.0,
                                                                  mode="nearest"), s)
    x = F.silu(gnorm(p["conv_norm_out"], x, groups, eps))
    return conv(p["conv_out"], x, s)


# ---------------------------------------------------------------- VAE


def vae_attention(p, x, groups: int, eps: float, s: float):
    b, c, hh, ww = x.shape
    t = gnorm(p["group_norm"], x, groups, eps).flatten(2).transpose(1, 2)
    q, k, v = (linear(p[n], t, s)[:, None] for n in ("to_q", "to_k", "to_v"))
    out = linear(p["to_out"], attend(q, k, v, c ** -0.5, "vae")[:, 0], s)
    return out.transpose(1, 2).reshape(b, c, hh, ww) + x


def vae_mid(p, x, groups: int, eps: float, s: float):
    x = resnet(p["resnets"][0], x, None, groups, eps, s)
    x = vae_attention(p["attentions"][0], x, groups, eps, s)
    return resnet(p["resnets"][1], x, None, groups, eps, s)


def vae_encode(p, img, v: Dict[str, Any], s: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """img [B, 3, H, W] -> (mean, logvar) [B, 4, h, w]."""
    g, eps, e = v["norm_num_groups"], v["norm_eps"], p["encoder"]
    x = conv(e["conv_in"], img, s)
    for bp in e["down_blocks"]:
        for rp in bp["resnets"]:
            x = resnet(rp, x, None, g, eps, s)
        if "downsamplers" in bp:  # diffusers Downsample2D: pad right/bottom by one
            x = conv(bp["downsamplers"][0]["conv"], F.pad(x, (0, 1, 0, 1)), s, stride=2,
                     padding=0)
    x = vae_mid(e["mid_block"], x, g, eps, s)
    x = conv(e["conv_out"], F.silu(gnorm(e["conv_norm_out"], x, g, eps)), s)
    mean, logvar = conv(p["quant_conv"], x, s).chunk(2, dim=1)
    return mean, logvar.clamp(-30.0, 20.0)


def vae_decode(p, z, v: Dict[str, Any], s: float):
    """z [B, 4, h, w] (divided by the scaling factor) -> [B, 3, H, W]."""
    g, eps, d = v["norm_num_groups"], v["norm_eps"], p["decoder"]
    x = conv(d["conv_in"], conv(p["post_quant_conv"], z, s), s)
    x = vae_mid(d["mid_block"], x, g, eps, s)
    for bp in d["up_blocks"]:
        for rp in bp["resnets"]:
            x = resnet(rp, x, None, g, eps, s)
        if "upsamplers" in bp:
            x = conv(bp["upsamplers"][0]["conv"], F.interpolate(x, scale_factor=2.0,
                                                                  mode="nearest"), s)
    return conv(d["conv_out"], F.silu(gnorm(d["conv_norm_out"], x, g, eps)), s)


# ---------------------------------------------------------------- the restore


def strip_lora(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: strip_lora(v) for k, v in tree.items() if k not in ("lora_A", "lora_B")}
    if isinstance(tree, list):
        return [strip_lora(v) for v in tree]
    return tree


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).float()


def to_unit(images: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] at the model's resolution -> NCHW fp32 in [-1, 1]."""
    return nchw(images) / 255.0 * 2.0 - 1.0


class Restorer:
    """The model over one unmerged weight tree (``layout.restorer_layout``)."""

    def __init__(self, params: Dict[str, Any], cfg: Dict[str, Any]):
        m = cfg["model"]
        self.u, self.v, self.m = cfg["unet"], cfg["vae"], m
        self.s_unet = (m["lora_rank_unet"] // 2) / m["lora_rank_unet"]
        self.s_vae = (m["lora_rank_vae"] // 2) / m["lora_rank_vae"]
        self.p = params
        # the frozen capture networks: base weights, no LoRA, the pretrained conv_in
        self.orig_unet = dict(strip_lora(params["unet"]), conv_in=params["unet_orig_conv_in"])
        self.orig_vae = strip_lora(params["vae"])
        self.sf = self.v["scaling_factor"]

    def _ctx(self, b: int, device) -> torch.Tensor:
        return self.p["caption_enc"].float().to(device).expand(b, -1, -1)

    def capture(self, refs: torch.Tensor, latent_noise, diffusion_noise) -> List:
        """refs uint8 [B, N, H, W, 3], noise [B*N, h, w, 4] -> per shared
        layer (k, v) [B, N, H, S, d]."""
        b, n = refs.shape[:2]
        abar = alphas_cumprod(refs.device)
        mean, logvar = vae_encode(self.orig_vae, to_unit(refs.flatten(0, 1)), self.v, 1.0)
        z = (mean + torch.exp(0.5 * logvar) * nchw(latent_noise)) * self.sf
        t = torch.full((b * n,), self.m["cond_timestep"], dtype=torch.long, device=z.device)
        a = abar[t][:, None, None, None]
        zt = a.sqrt() * z + (1 - a).sqrt() * nchw(diffusion_noise)
        kv: List = []
        unet(self.orig_unet, zt, t, self._ctx(b * n, z.device), self.u, 1.0, capture=kv)
        return [(k.reshape(b, n, *k.shape[1:]), v.reshape(b, n, *v.shape[1:])) for k, v in kv]

    def restore(self, images: torch.Tensor, shared: List, latent_noise, diffusion_noise):
        """images uint8 [B, H, W, 3], shared from ``capture`` -> the restored
        images [B, H, W, 3] in [-1, 1]."""
        b = images.shape[0]
        abar = alphas_cumprod(images.device)
        mean, logvar = vae_encode(self.p["vae"], to_unit(images), self.v, self.s_vae)
        z = (mean + torch.exp(0.5 * logvar) * nchw(latent_noise)) * self.sf
        t = torch.full((b,), self.m["timestep"], dtype=torch.long, device=z.device)
        a = abar[t][:, None, None, None]
        zt = a.sqrt() * z + (1 - a).sqrt() * nchw(diffusion_noise)
        eps = unet(self.p["unet"], zt, t, self._ctx(b, z.device), self.u, self.s_unet,
                   shared=shared, adain=self.m["use_adain"], train_input=self.m["train_input"])
        x0 = (zt - (1 - a).sqrt() * eps) / a.sqrt()
        out = vae_decode(self.p["vae"], x0 / self.sf, self.v, self.s_vae)
        return out.clamp(-1.0, 1.0).permute(0, 2, 3, 1)
