"""SD VAE (AutoencoderKL), NHWC (counterpart of
``instantrestore_tpu/models/vae.py``): ``vae_encode`` returns the moments and
the pre-down-block activations, ``vae_decode`` optionally adds them back
through the four 1x1 skip convs. The mid-block attention (one head over all
channels) runs through the flash kernel when ``use_fused_attention``: the
inference kernel, or the differentiable one of ``ops/flash_vjp.py`` where an
input wants a gradient."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from instantrestore_tpu_torch.models.attention import softmax_attention
from instantrestore_tpu_torch.ops.primitives import (
    conv2d,
    conv2d_bias_apart,
    dense,
    group_norm,
    init_conv2d,
    init_dense,
    init_norm,
    quantize_block_convs_int8,
    upsample2x_conv,
)
from instantrestore_tpu_torch.ops.flash_vjp import flash_attention

SD_VAE_SCALING_FACTOR = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    scaling_factor: float = SD_VAE_SCALING_FACTOR
    use_shortcuts: bool = False


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_resnet(gen, in_ch: int, out_ch: int, device) -> Dict[str, Any]:
    p = {
        "norm1": init_norm(in_ch, device=device),
        "conv1": init_conv2d(gen, in_ch, out_ch, 3, device=device),
        "norm2": init_norm(out_ch, device=device),
        "conv2": init_conv2d(gen, out_ch, out_ch, 3, device=device),
    }
    if in_ch != out_ch:
        p["conv_shortcut"] = init_conv2d(gen, in_ch, out_ch, 1, device=device)
    return p


def _init_mid(gen, ch: int, device) -> Dict[str, Any]:
    attn = {"group_norm": init_norm(ch, device=device)}
    for name in ("to_q", "to_k", "to_v", "to_out"):
        attn[name] = init_dense(gen, ch, ch, device=device)
    return {
        "resnets": [_init_resnet(gen, ch, ch, device), _init_resnet(gen, ch, ch, device)],
        "attentions": [attn],
    }


def init_vae_params(gen: torch.Generator, cfg: VAEConfig = VAEConfig(), *, device=None) -> Dict[str, Any]:
    """Random-init parameter tree (fp32) in the port's layout, with the
    decoder's ``skip_conv_1..4`` when ``cfg.use_shortcuts``."""
    chs = cfg.block_out_channels
    encoder: Dict[str, Any] = {
        "conv_in": init_conv2d(gen, cfg.in_channels, chs[0], 3, device=device),
        "down_blocks": [],
        "mid_block": _init_mid(gen, chs[-1], device),
        "conv_norm_out": init_norm(chs[-1], device=device),
        "conv_out": init_conv2d(gen, chs[-1], 2 * cfg.latent_channels, 3, device=device),
    }
    in_ch = chs[0]
    for i, out_ch in enumerate(chs):
        block: Dict[str, Any] = {"resnets": [
            _init_resnet(gen, in_ch if j == 0 else out_ch, out_ch, device)
            for j in range(cfg.layers_per_block)
        ]}
        if i != len(chs) - 1:
            block["downsamplers"] = [{"conv": init_conv2d(gen, out_ch, out_ch, 3, device=device)}]
        encoder["down_blocks"].append(block)
        in_ch = out_ch

    rev = list(reversed(chs))
    decoder: Dict[str, Any] = {
        "conv_in": init_conv2d(gen, cfg.latent_channels, rev[0], 3, device=device),
        "mid_block": _init_mid(gen, rev[0], device),
        "up_blocks": [],
        "conv_norm_out": init_norm(rev[-1], device=device),
        "conv_out": init_conv2d(gen, rev[-1], cfg.out_channels, 3, device=device),
    }
    in_ch = rev[0]
    for i, out_ch in enumerate(rev):
        block = {"resnets": [
            _init_resnet(gen, in_ch if j == 0 else out_ch, out_ch, device)
            for j in range(cfg.layers_per_block + 1)
        ]}
        if i != len(rev) - 1:
            block["upsamplers"] = [{"conv": init_conv2d(gen, out_ch, out_ch, 3, device=device)}]
        decoder["up_blocks"].append(block)
        in_ch = out_ch

    if cfg.use_shortcuts:
        # the reference's 1x1 bias-free skip convs, set to 1e-5: the widths of
        # the SD VAE's encoder outputs into its decoder (512 and 256 are fixed,
        # as in the JAX package, so only a decoder of SD's widths runs them)
        shapes = [(chs[3], 512), (chs[1], 512), (chs[0], 512), (chs[0], 256)]
        for i, (cin, cout) in enumerate(shapes, start=1):
            decoder[f"skip_conv_{i}"] = {
                "weight": torch.full((cout, cin, 1, 1), 1e-5, device=device)}

    lat2 = 2 * cfg.latent_channels
    return {
        "encoder": encoder,
        "decoder": decoder,
        "quant_conv": init_conv2d(gen, lat2, lat2, 1, device=device),
        "post_quant_conv": init_conv2d(gen, cfg.latent_channels, cfg.latent_channels, 1, device=device),
    }


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _resnet(p, x, *, cfg: VAEConfig, lora_scaling: float):
    """diffusers ResnetBlock2D; conv1's bias is added inside norm2."""
    h = group_norm(p["norm1"], x, num_groups=cfg.norm_num_groups, eps=cfg.norm_eps, act="silu")
    h, bias = conv2d_bias_apart(p["conv1"], h, lora_scaling=lora_scaling)
    h = group_norm(p["norm2"], h, num_groups=cfg.norm_num_groups, eps=cfg.norm_eps,
                   in_bias=bias, act="silu")
    h = conv2d(p["conv2"], h, lora_scaling=lora_scaling)
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding=0, lora_scaling=lora_scaling)
    return x + h


def _attn(p, x, *, cfg: VAEConfig, lora_scaling: float, use_fused: bool):
    """Single-head full-width attention of the mid block (residual)."""
    b, hh, ww, c = x.shape
    h = group_norm(p["group_norm"], x, num_groups=cfg.norm_num_groups, eps=cfg.norm_eps)
    tokens = h.reshape(b, hh * ww, c)
    q = dense(p["to_q"], tokens, lora_scaling=lora_scaling)[:, None]
    k = dense(p["to_k"], tokens, lora_scaling=lora_scaling)[:, None]
    v = dense(p["to_v"], tokens, lora_scaling=lora_scaling)[:, None]
    scale = c ** -0.5
    if use_fused:
        out = flash_attention(q, k, v, scale=scale)
    else:
        out = softmax_attention(q, k, v, scale)
    out = dense(p["to_out"], out[:, 0], lora_scaling=lora_scaling)
    return out.reshape(b, hh, ww, c) + x


def _mid(p, x, *, cfg: VAEConfig, lora_scaling: float, use_fused: bool):
    x = _resnet(p["resnets"][0], x, cfg=cfg, lora_scaling=lora_scaling)
    x = _attn(p["attentions"][0], x, cfg=cfg, lora_scaling=lora_scaling, use_fused=use_fused)
    return _resnet(p["resnets"][1], x, cfg=cfg, lora_scaling=lora_scaling)


def vae_encode(
    params: Dict[str, Any],
    images: torch.Tensor,
    *,
    cfg: VAEConfig = VAEConfig(),
    lora_scaling: float = 1.0,
    compute_dtype=torch.bfloat16,
    use_fused_attention: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """images [B, H, W, 3] in [-1, 1] -> (mean, logvar [B, h, w, 4] fp32,
    pre-down-block activations)."""
    p = params["encoder"]
    x = conv2d(p["conv_in"], images.to(compute_dtype), lora_scaling=lora_scaling)
    acts: List[torch.Tensor] = []
    for block in p["down_blocks"]:
        acts.append(x)
        for rp in block["resnets"]:
            x = _resnet(rp, x, cfg=cfg, lora_scaling=lora_scaling)
        if "downsamplers" in block:
            # diffusers Downsample2D: pad right/bottom by one, stride-2 conv
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
            x = conv2d(block["downsamplers"][0]["conv"], x, stride=2, padding=0,
                       lora_scaling=lora_scaling)
    x = _mid(p["mid_block"], x, cfg=cfg, lora_scaling=lora_scaling, use_fused=use_fused_attention)
    x = group_norm(p["conv_norm_out"], x, num_groups=cfg.norm_num_groups, eps=cfg.norm_eps,
                   act="silu")
    x = conv2d(p["conv_out"], x, lora_scaling=lora_scaling)
    moments = conv2d(params["quant_conv"], x, padding=0, lora_scaling=lora_scaling)
    mean, logvar = moments.float().chunk(2, dim=-1)
    return mean, torch.clamp(logvar, -30.0, 20.0), acts


def sample_latent(mean: torch.Tensor, logvar: torch.Tensor, noise: Optional[torch.Tensor]) -> torch.Tensor:
    """DiagonalGaussianDistribution.sample() with the standard-normal draw
    given explicitly; ``noise=None`` gives the mode (the mean)."""
    if noise is None:
        return mean
    return mean + torch.exp(0.5 * logvar) * noise


def vae_decode(
    params: Dict[str, Any],
    latents: torch.Tensor,
    *,
    cfg: VAEConfig = VAEConfig(),
    skip_acts: Optional[List[torch.Tensor]] = None,
    gamma: float = 1.0,
    lora_scaling: float = 1.0,
    compute_dtype=torch.bfloat16,
    use_fused_attention: bool = False,
) -> torch.Tensor:
    """latents [B, h, w, 4] (already divided by the scaling factor) ->
    images [B, H, W, 3] in the compute dtype."""
    p = params["decoder"]
    x = conv2d(params["post_quant_conv"], latents.to(compute_dtype), padding=0,
               lora_scaling=lora_scaling)
    x = conv2d(p["conv_in"], x, lora_scaling=lora_scaling)
    x = _mid(p["mid_block"], x, cfg=cfg, lora_scaling=lora_scaling, use_fused=use_fused_attention)
    use_skips = skip_acts is not None and "skip_conv_1" in p
    for i, block in enumerate(p["up_blocks"]):
        if use_skips:
            act = skip_acts[::-1][i].to(x.dtype) * gamma
            x = x + conv2d(p[f"skip_conv_{i + 1}"], act, padding=0, lora_scaling=lora_scaling)
        for rp in block["resnets"]:
            x = _resnet(rp, x, cfg=cfg, lora_scaling=lora_scaling)
        if "upsamplers" in block:
            x = upsample2x_conv(block["upsamplers"][0]["conv"], x, lora_scaling=lora_scaling)
    x = group_norm(p["conv_norm_out"], x, num_groups=cfg.norm_num_groups, eps=cfg.norm_eps,
                   act="silu")
    return conv2d(p["conv_out"], x, lora_scaling=lora_scaling)


def quantize_decoder_int8(vae_params: Dict[str, Any]) -> Dict[str, Any]:
    """Serving-only int8 of the decoder's conv mass: the mid and up blocks'
    resnet convs and the upsamplers (folded). conv_in, conv_out, the
    mid-block attention and the encoder stay as they are. Not parity-exact
    with the reference by design; LoRA must be merged first."""
    out = dict(vae_params)
    dec = dict(out["decoder"])
    dec["mid_block"] = quantize_block_convs_int8(dec["mid_block"])
    dec["up_blocks"] = [quantize_block_convs_int8(b) for b in dec["up_blocks"]]
    out["decoder"] = dec
    return out
