"""SD-Turbo (SD2.1-base) conditional UNet, NHWC (counterpart of
``instantrestore_tpu/models/unet.py``).

``capture_kv=True`` returns the K/V of the 9 up-block self-attentions (the
frozen capture pass); ``ref_kv=[...]`` injects one entry per shared layer, in
traversal order (the reference's self_attn_idx 0..8); ``save_attn_probs``
returns those layers' attention probabilities and ``save_seg_sums`` their
streamed per-segment softmax masses. FreeU is always on
(DEFAULT_FREEU) and LoRA rides in the param tree with a caller-given scaling.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from instantrestore_tpu_torch.models.attention import attention
from instantrestore_tpu_torch.models.freeu import FreeUParams, apply_freeu
from instantrestore_tpu_torch.ops.primitives import (
    conv2d,
    dense,
    geglu,
    group_norm,
    init_conv2d,
    init_dense,
    init_norm,
    layer_norm,
    silu,
    timestep_embedding,
    upsample2x_conv,
)

DEFAULT_FREEU = FreeUParams(s1=0.9, s2=0.2, b1=1.4, b2=1.6)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
    )
    layers_per_block: int = 2
    # diffusers SD2 quirk: "attention_head_dim" holds the head COUNT
    attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    transformer_norm_eps: float = 1e-6
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @property
    def num_shared_attn_layers(self) -> int:
        """Self-attention layers in cross-attn up blocks (9 for SD2)."""
        return sum(self.layers_per_block + 1 for t in self.up_block_types
                   if t == "CrossAttnUpBlock2D")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_resnet(gen, in_ch, out_ch, temb_dim, device) -> Dict[str, Any]:
    p = {
        "norm1": init_norm(in_ch, device=device),
        "conv1": init_conv2d(gen, in_ch, out_ch, 3, device=device),
        "time_emb_proj": init_dense(gen, temb_dim, out_ch, device=device),
        "norm2": init_norm(out_ch, device=device),
        "conv2": init_conv2d(gen, out_ch, out_ch, 3, device=device),
    }
    if in_ch != out_ch:
        p["conv_shortcut"] = init_conv2d(gen, in_ch, out_ch, 1, device=device)
    return p


def _init_attention(gen, query_dim, context_dim, device) -> Dict[str, Any]:
    return {
        "to_q": init_dense(gen, query_dim, query_dim, bias=False, device=device),
        "to_k": init_dense(gen, context_dim, query_dim, bias=False, device=device),
        "to_v": init_dense(gen, context_dim, query_dim, bias=False, device=device),
        "to_out": init_dense(gen, query_dim, query_dim, device=device),
    }


def _init_transformer(gen, ch, ctx_dim, device) -> Dict[str, Any]:
    block = {
        "norm1": init_norm(ch, device=device),
        "attn1": _init_attention(gen, ch, ch, device),
        "norm2": init_norm(ch, device=device),
        "attn2": _init_attention(gen, ch, ctx_dim, device),
        "norm3": init_norm(ch, device=device),
        "ff": {
            "net_0_proj": init_dense(gen, ch, ch * 8, device=device),  # GEGLU: 2 * 4ch
            "net_2": init_dense(gen, ch * 4, ch, device=device),
        },
    }
    return {
        "norm": init_norm(ch, device=device),
        "proj_in": init_dense(gen, ch, ch, device=device),
        "transformer_blocks": [block],
        "proj_out": init_dense(gen, ch, ch, device=device),
    }


def _up_block_skip_channels(cfg: UNetConfig, up_idx: int) -> List[int]:
    """Widths of the skips popped by up block ``up_idx``."""
    stack = [cfg.block_out_channels[0]]
    for i in range(len(cfg.down_block_types)):
        ch = cfg.block_out_channels[i]
        stack.extend([ch] * cfg.layers_per_block)
        if i != len(cfg.down_block_types) - 1:
            stack.append(ch)
    per_block = cfg.layers_per_block + 1
    return [stack[-(up_idx * per_block + j + 1)] for j in range(per_block)]


def init_unet_params(gen: torch.Generator, cfg: UNetConfig = UNetConfig(), *, device=None) -> Dict[str, Any]:
    """Random-init parameter tree (fp32) in the port's layout."""
    ch0 = cfg.block_out_channels[0]
    temb = cfg.time_embed_dim
    ctx = cfg.cross_attention_dim
    params: Dict[str, Any] = {
        "conv_in": init_conv2d(gen, cfg.in_channels, ch0, 3, device=device),
        "time_embedding": {
            "linear_1": init_dense(gen, ch0, temb, device=device),
            "linear_2": init_dense(gen, temb, temb, device=device),
        },
        "conv_norm_out": init_norm(ch0, device=device),
        "conv_out": init_conv2d(gen, ch0, cfg.out_channels, 3, device=device),
    }
    down_blocks = []
    out_ch = ch0
    for i, btype in enumerate(cfg.down_block_types):
        in_ch, out_ch = out_ch, cfg.block_out_channels[i]
        block: Dict[str, Any] = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block):
            block["resnets"].append(_init_resnet(gen, in_ch if j == 0 else out_ch, out_ch, temb, device))
            if btype == "CrossAttnDownBlock2D":
                block["attentions"].append(_init_transformer(gen, out_ch, ctx, device))
        if not block["attentions"]:
            del block["attentions"]
        if i != len(cfg.down_block_types) - 1:
            block["downsamplers"] = [{"conv": init_conv2d(gen, out_ch, out_ch, 3, device=device)}]
        down_blocks.append(block)
    params["down_blocks"] = down_blocks

    mid_ch = cfg.block_out_channels[-1]
    params["mid_block"] = {
        "resnets": [_init_resnet(gen, mid_ch, mid_ch, temb, device) for _ in range(2)],
        "attentions": [_init_transformer(gen, mid_ch, ctx, device)],
    }

    up_blocks = []
    rev = list(reversed(cfg.block_out_channels))
    for i, btype in enumerate(cfg.up_block_types):
        prev_ch = rev[i - 1] if i > 0 else mid_ch
        out_ch = rev[i]
        skips = _up_block_skip_channels(cfg, i)
        block = {"resnets": [], "attentions": []}
        hidden_ch = prev_ch
        for j in range(cfg.layers_per_block + 1):
            block["resnets"].append(_init_resnet(gen, hidden_ch + skips[j], out_ch, temb, device))
            hidden_ch = out_ch
            if btype == "CrossAttnUpBlock2D":
                block["attentions"].append(_init_transformer(gen, out_ch, ctx, device))
        if not block["attentions"]:
            del block["attentions"]
        if i != len(cfg.up_block_types) - 1:
            block["upsamplers"] = [{"conv": init_conv2d(gen, out_ch, out_ch, 3, device=device)}]
        up_blocks.append(block)
    params["up_blocks"] = up_blocks
    return params


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _resnet(p, x, temb, *, cfg: UNetConfig, lora_scaling: float):
    h = silu(group_norm(p["norm1"], x, num_groups=cfg.norm_num_groups, eps=cfg.norm_eps))
    h = conv2d(p["conv1"], h, lora_scaling=lora_scaling)
    h = h + dense(p["time_emb_proj"], silu(temb), lora_scaling=lora_scaling)[:, None, None, :]
    h = silu(group_norm(p["norm2"], h, num_groups=cfg.norm_num_groups, eps=cfg.norm_eps))
    h = conv2d(p["conv2"], h, lora_scaling=lora_scaling)
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding=0, lora_scaling=lora_scaling)
    return x + h


def _transformer(p, x, ctx, *, cfg: UNetConfig, heads: int, lora_scaling: float,
                 shared: dict):
    """Transformer2DModel with linear projections; ``shared`` carries the
    self-attention's options (ref_kv, use_adain, train_input, capture_kv,
    save_probs, save_seg_sums, use_fused) and the cross-attention's
    use_faceid. Returns (out, aux)."""
    b, hh, ww, c = x.shape
    h = group_norm(p["norm"], x, num_groups=cfg.norm_num_groups, eps=cfg.transformer_norm_eps)
    h = dense(p["proj_in"], h.reshape(b, hh * ww, c), lora_scaling=lora_scaling)
    aux_out = {}
    for bp in p["transformer_blocks"]:
        attn_out, aux = attention(
            bp["attn1"], layer_norm(bp["norm1"], h), heads=heads,
            ref_kv=shared.get("ref_kv"),
            use_adain=shared.get("use_adain", False),
            train_input=shared.get("train_input", True),
            capture_kv=shared.get("capture_kv", False),
            save_probs=shared.get("save_probs", False),
            save_seg_sums=shared.get("save_seg_sums", False),
            use_fused=shared.get("use_fused", False),
            lora_scaling=lora_scaling,
        )
        aux_out.update(aux)
        h = h + attn_out
        attn_out, _ = attention(bp["attn2"], layer_norm(bp["norm2"], h), heads=heads,
                                encoder_hidden=ctx, lora_scaling=lora_scaling,
                                use_faceid=shared.get("use_faceid", False))
        h = h + attn_out
        ff = geglu(bp["ff"]["net_0_proj"], layer_norm(bp["norm3"], h), lora_scaling=lora_scaling)
        h = h + dense(bp["ff"]["net_2"], ff, lora_scaling=lora_scaling)
    h = dense(p["proj_out"], h, lora_scaling=lora_scaling)
    return h.reshape(b, hh, ww, c) + x, aux_out


def unet_apply(
    params: Dict[str, Any],
    sample: torch.Tensor,
    timesteps: torch.Tensor,
    encoder_hidden_states: torch.Tensor,
    *,
    cfg: UNetConfig = UNetConfig(),
    ref_kv: Optional[Sequence[Any]] = None,
    capture_kv: bool = False,
    save_attn_probs: bool = False,
    probs_layers: Optional[Sequence[int]] = None,
    save_seg_sums: bool = False,
    use_adain: bool = False,
    train_input: bool = True,
    freeu: Optional[FreeUParams] = DEFAULT_FREEU,
    lora_scaling: float = 1.0,
    use_fused_attention: bool = False,
    use_faceid: bool = False,
    capture_taps: bool = False,
    compute_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """sample [B, H, W, 4] NHWC latents, timesteps [B] (or scalar) int,
    encoder_hidden_states [B, 77, ctx] -> (epsilon [B, H, W, 4] in the sample
    dtype, aux = {'kv': [(k, v) x 9] when capture_kv, 'attn_probs': [p x 9]
    when save_attn_probs (fp32 [B, h, Sq, Skv]; None at layers outside
    ``probs_layers`` when given), 'seg_sums': [s x 9] when save_seg_sums
    (fp32 [B, h, Sq, n_seg]), 'taps': {...} when capture_taps}). Tap
    names match the JAX package: conv_in, down_block_i, mid_block,
    shared_attn_i, up_block_i. ``use_faceid``: ``encoder_hidden_states`` are
    face embeddings [B, M, 512], read through every cross-attention's FaceID
    projections."""
    if timesteps.ndim == 0:
        timesteps = timesteps.expand(sample.shape[0])
    x = sample.to(compute_dtype)
    ctx = encoder_hidden_states.to(compute_dtype)

    t_emb = timestep_embedding(
        timesteps, cfg.block_out_channels[0],
        flip_sin_to_cos=cfg.flip_sin_to_cos, downscale_freq_shift=cfg.freq_shift,
    ).to(compute_dtype)
    temb = dense(params["time_embedding"]["linear_1"], t_emb)
    temb = dense(params["time_embedding"]["linear_2"], silu(temb))

    x = conv2d(params["conv_in"], x, lora_scaling=lora_scaling)
    taps: Dict[str, torch.Tensor] = {}
    if capture_taps:
        taps["conv_in"] = x
    plain = {"use_fused": use_fused_attention, "use_faceid": use_faceid}

    skips = [x]
    for i, (btype, bp) in enumerate(zip(cfg.down_block_types, params["down_blocks"])):
        for j, rp in enumerate(bp["resnets"]):
            x = _resnet(rp, x, temb, cfg=cfg, lora_scaling=lora_scaling)
            if btype == "CrossAttnDownBlock2D":
                x, _ = _transformer(bp["attentions"][j], x, ctx, cfg=cfg,
                                    heads=cfg.attention_heads[i], lora_scaling=lora_scaling,
                                    shared=plain)
            skips.append(x)
        if "downsamplers" in bp:
            x = conv2d(bp["downsamplers"][0]["conv"], x, stride=2, lora_scaling=lora_scaling)
            skips.append(x)
        if capture_taps:
            taps[f"down_block_{i}"] = x

    mp = params["mid_block"]
    x = _resnet(mp["resnets"][0], x, temb, cfg=cfg, lora_scaling=lora_scaling)
    x, _ = _transformer(mp["attentions"][0], x, ctx, cfg=cfg, heads=cfg.attention_heads[-1],
                        lora_scaling=lora_scaling, shared=plain)
    x = _resnet(mp["resnets"][1], x, temb, cfg=cfg, lora_scaling=lora_scaling)
    if capture_taps:
        taps["mid_block"] = x

    kv_list: List[Tuple[torch.Tensor, torch.Tensor]] = []
    probs_list: List[Optional[torch.Tensor]] = []
    seg_sums_list: List[torch.Tensor] = []
    shared_idx = 0
    n_blocks = len(cfg.block_out_channels)
    for i, (btype, bp) in enumerate(zip(cfg.up_block_types, params["up_blocks"])):
        heads = cfg.attention_heads[n_blocks - 1 - i]
        for j, rp in enumerate(bp["resnets"]):
            x, skip = apply_freeu(i, x, skips.pop(), freeu)
            x = torch.cat([x, skip.to(x.dtype)], dim=-1)
            x = _resnet(rp, x, temb, cfg=cfg, lora_scaling=lora_scaling)
            if btype == "CrossAttnUpBlock2D":
                shared = {
                    "ref_kv": ref_kv[shared_idx] if ref_kv is not None else None,
                    "use_adain": use_adain,
                    "train_input": train_input,
                    "capture_kv": capture_kv,
                    "save_probs": save_attn_probs and (probs_layers is None
                                                       or shared_idx in probs_layers),
                    "save_seg_sums": save_seg_sums,
                    "use_fused": use_fused_attention,
                    "use_faceid": use_faceid,
                }
                x, aux = _transformer(bp["attentions"][j], x, ctx, cfg=cfg, heads=heads,
                                      lora_scaling=lora_scaling, shared=shared)
                if capture_kv:
                    kv_list.append(aux["kv"])
                if save_attn_probs:
                    probs_list.append(aux.get("probs"))
                if save_seg_sums and "seg_sums" in aux:
                    seg_sums_list.append(aux["seg_sums"])
                if capture_taps:
                    taps[f"shared_attn_{shared_idx}"] = x
                shared_idx += 1
        if "upsamplers" in bp:
            x = upsample2x_conv(bp["upsamplers"][0]["conv"], x, lora_scaling=lora_scaling)
        if capture_taps:
            taps[f"up_block_{i}"] = x

    x = silu(group_norm(params["conv_norm_out"], x, num_groups=cfg.norm_num_groups, eps=cfg.norm_eps))
    x = conv2d(params["conv_out"], x, lora_scaling=lora_scaling)
    aux_out: Dict[str, Any] = {}
    if capture_kv:
        aux_out["kv"] = kv_list
    if save_attn_probs:
        aux_out["attn_probs"] = probs_list
    if save_seg_sums:
        aux_out["seg_sums"] = seg_sums_list
    if capture_taps:
        aux_out["taps"] = taps
    return x.to(sample.dtype), aux_out
