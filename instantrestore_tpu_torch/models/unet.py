"""The conditional UNet of SD-Turbo (SD2.1-base) and of SDXL-Turbo, NHWC
(counterpart of ``instantrestore_tpu/models/unet.py``, which runs SD-Turbo's).

A ``UNetConfig`` gives each level's Transformer2DModel depth
(``transformer_layers_per_block``; the mid block takes the last level's) and
SDXL's text-time added conditioning (``addition_embed_type="text_time"``:
``unet_apply(added_cond=...)``); ``unet_config_from_diffusers`` reads a
diffusers ``unet/config.json``. The shared layers are the self-attentions
of every transformer block of the cross-attention up blocks
(``UNetConfig.num_shared_attn_layers``: 9 for SD-Turbo, 36 for SDXL-Turbo),
in traversal order (the reference's self_attn_idx): ``capture_kv=True``
returns their K/V (the frozen capture pass), ``ref_kv=[...]`` injects one
entry per shared layer, ``save_attn_probs`` returns their attention
probabilities and ``save_seg_sums`` their streamed per-segment softmax
masses. FreeU is on with the caller's ``freeu`` values (SD 2.1's by
default) and LoRA rides in the param tree with a caller-given scaling. Each
Transformer2DModel is a ``transformer`` span of ``utils/profiling.py``
whose count is its blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from instantrestore_tpu_torch.models.attention import attention
from instantrestore_tpu_torch.models.freeu import FreeUParams, apply_freeu
from instantrestore_tpu_torch.ops.primitives import (
    conv2d,
    conv2d_bias_apart,
    dense,
    geglu,
    group_norm,
    init_conv2d,
    init_dense,
    init_norm,
    layer_norm,
    quantize_block_convs_int8,
    silu,
    timestep_embedding,
    upsample2x_conv,
)
from instantrestore_tpu_torch.utils import profiling

# SDXL's text-time ids: original size (h, w), crop top-left (y, x), target size (h, w)
ADDED_TIME_IDS = 6


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
    # transformer blocks of each level's Transformer2DModels (one int for all)
    transformer_layers_per_block: Union[int, Tuple[int, ...]] = 1
    # SDXL's added conditioning: None or "text_time", whose add_embedding
    # takes the pooled text embedding and the ADDED_TIME_IDS time ids, each
    # as a sinusoid of addition_time_embed_dim
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 0

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @property
    def transformer_depths(self) -> Tuple[int, ...]:
        """Transformer blocks a Transformer2DModel at each level (down order)."""
        d = self.transformer_layers_per_block
        return (d,) * len(self.block_out_channels) if isinstance(d, int) else tuple(d)

    @property
    def added_text_embed_dim(self) -> int:
        """Width of the pooled text embedding of the text-time conditioning."""
        return (self.projection_class_embeddings_input_dim
                - ADDED_TIME_IDS * self.addition_time_embed_dim)

    @property
    def num_shared_attn_layers(self) -> int:
        """Transformer blocks (each one shared self-attention) in the
        cross-attention up blocks: 9 for SD-Turbo, 36 for SDXL-Turbo."""
        depths = self.transformer_depths[::-1]
        return sum((self.layers_per_block + 1) * depths[i]
                   for i, t in enumerate(self.up_block_types) if t == "CrossAttnUpBlock2D")


# diffusers config keys whose other values the port does not build
_DIFFUSERS_FIXED = {
    "act_fn": "silu", "attention_type": "default", "center_input_sample": False,
    "class_embed_type": None, "class_embeddings_concat": False, "conv_in_kernel": 3,
    "conv_out_kernel": 3, "cross_attention_norm": None, "downsample_padding": 1,
    "dual_cross_attention": False, "encoder_hid_dim": None, "encoder_hid_dim_type": None,
    "mid_block_scale_factor": 1, "mid_block_type": "UNetMidBlock2DCrossAttn",
    "num_class_embeds": None, "only_cross_attention": False, "resnet_out_scale_factor": 1.0,
    "resnet_skip_time_act": False, "resnet_time_scale_shift": "default",
    "reverse_transformer_layers_per_block": None, "time_cond_proj_dim": None,
    "time_embedding_act_fn": None, "time_embedding_dim": None,
    "time_embedding_type": "positional", "timestep_post_act": None,
    "use_linear_projection": True,
}


def unet_config_from_diffusers(config: Dict[str, Any]) -> UNetConfig:
    """A diffusers ``unet/config.json`` dict -> ``UNetConfig``. Its
    ``attention_head_dim`` holds head COUNTS where ``num_attention_heads`` is
    null (diffusers' quirk, kept for SD 2 and SDXL). A key the port does not
    build (a conv ``proj_in``, class embeddings, ...) at another value than
    ``_DIFFUSERS_FIXED``'s raises ``ValueError``; keys that change no
    computation (``sample_size`` aside, which sets the default resolution)
    are ignored. ``transformer_norm_eps`` is not a diffusers key
    (Transformer2DModel's GroupNorm eps is fixed at 1e-6) and is read where
    given."""
    bad = {k: config[k] for k, v in _DIFFUSERS_FIXED.items() if k in config and config[k] != v}
    if bad:
        raise ValueError(f"UNet config values the port does not build: {bad}")
    if config.get("addition_embed_type") not in (None, "text_time"):
        raise ValueError(f"addition_embed_type {config['addition_embed_type']!r} is not built")
    n = len(config["block_out_channels"])

    def per_level(v):
        return (v,) * n if isinstance(v, int) else tuple(v)

    heads = per_level(config.get("num_attention_heads") or config["attention_head_dim"])
    depth = config.get("transformer_layers_per_block", 1)
    kw = {k: config[k] for k in (
        "sample_size", "in_channels", "out_channels", "layers_per_block", "cross_attention_dim",
        "norm_num_groups", "norm_eps", "flip_sin_to_cos", "transformer_norm_eps",
        "addition_time_embed_dim", "projection_class_embeddings_input_dim",
    ) if config.get(k) is not None}
    return UNetConfig(
        block_out_channels=tuple(config["block_out_channels"]),
        down_block_types=tuple(config["down_block_types"]),
        up_block_types=tuple(config["up_block_types"]),
        attention_heads=heads, freq_shift=float(config.get("freq_shift", 0)),
        transformer_layers_per_block=depth if isinstance(depth, int) else tuple(depth),
        addition_embed_type=config.get("addition_embed_type"), **kw)


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


def _init_transformer(gen, ch, ctx_dim, depth, device) -> Dict[str, Any]:
    blocks = [{
        "norm1": init_norm(ch, device=device),
        "attn1": _init_attention(gen, ch, ch, device),
        "norm2": init_norm(ch, device=device),
        "attn2": _init_attention(gen, ch, ctx_dim, device),
        "norm3": init_norm(ch, device=device),
        "ff": {
            "net_0_proj": init_dense(gen, ch, ch * 8, device=device),  # GEGLU: 2 * 4ch
            "net_2": init_dense(gen, ch * 4, ch, device=device),
        },
    } for _ in range(depth)]
    return {
        "norm": init_norm(ch, device=device),
        "proj_in": init_dense(gen, ch, ch, device=device),
        "transformer_blocks": blocks,
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
    if cfg.addition_embed_type == "text_time":
        params["add_embedding"] = {
            "linear_1": init_dense(gen, cfg.projection_class_embeddings_input_dim, temb,
                                   device=device),
            "linear_2": init_dense(gen, temb, temb, device=device),
        }
    depths = cfg.transformer_depths
    down_blocks = []
    out_ch = ch0
    for i, btype in enumerate(cfg.down_block_types):
        in_ch, out_ch = out_ch, cfg.block_out_channels[i]
        block: Dict[str, Any] = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block):
            block["resnets"].append(_init_resnet(gen, in_ch if j == 0 else out_ch, out_ch, temb, device))
            if btype == "CrossAttnDownBlock2D":
                block["attentions"].append(_init_transformer(gen, out_ch, ctx, depths[i], device))
        if not block["attentions"]:
            del block["attentions"]
        if i != len(cfg.down_block_types) - 1:
            block["downsamplers"] = [{"conv": init_conv2d(gen, out_ch, out_ch, 3, device=device)}]
        down_blocks.append(block)
    params["down_blocks"] = down_blocks

    mid_ch = cfg.block_out_channels[-1]
    params["mid_block"] = {
        "resnets": [_init_resnet(gen, mid_ch, mid_ch, temb, device) for _ in range(2)],
        "attentions": [_init_transformer(gen, mid_ch, ctx, depths[-1], device)],
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
                block["attentions"].append(
                    _init_transformer(gen, out_ch, ctx, depths[-1 - i], device))
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
    """diffusers ResnetBlock2D; conv1's bias, then the time-embedding
    projection [B, C], are added inside norm2."""
    h = group_norm(p["norm1"], x, num_groups=cfg.norm_num_groups, eps=cfg.norm_eps, act="silu")
    h, bias = conv2d_bias_apart(p["conv1"], h, lora_scaling=lora_scaling)
    t = dense(p["time_emb_proj"], silu(temb), lora_scaling=lora_scaling)
    h = group_norm(p["norm2"], h, num_groups=cfg.norm_num_groups, eps=cfg.norm_eps,
                   in_bias=bias + (t,), act="silu")
    h = conv2d(p["conv2"], h, lora_scaling=lora_scaling)
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding=0, lora_scaling=lora_scaling)
    return x + h


def _transformer(p, x, ctx, *, cfg: UNetConfig, heads: int, lora_scaling: float,
                 shared: Sequence[dict]):
    """Transformer2DModel with linear projections, a ``transformer`` span
    whose count is its blocks; ``shared`` holds each block's options: its
    self-attention's (ref_kv, use_adain, train_input, capture_kv, save_probs,
    save_seg_sums, use_fused) and its cross-attention's use_faceid. Returns
    (out, [each block's aux])."""
    blocks = p["transformer_blocks"]
    with profiling.span("transformer", count=len(blocks)):
        b, hh, ww, c = x.shape
        h = group_norm(p["norm"], x, num_groups=cfg.norm_num_groups, eps=cfg.transformer_norm_eps)
        h = dense(p["proj_in"], h.reshape(b, hh * ww, c), lora_scaling=lora_scaling)
        auxes = []
        for bp, opts in zip(blocks, shared, strict=True):
            attn_out, aux = attention(
                bp["attn1"], layer_norm(bp["norm1"], h), heads=heads,
                ref_kv=opts.get("ref_kv"),
                use_adain=opts.get("use_adain", False),
                train_input=opts.get("train_input", True),
                capture_kv=opts.get("capture_kv", False),
                save_probs=opts.get("save_probs", False),
                save_seg_sums=opts.get("save_seg_sums", False),
                use_fused=opts.get("use_fused", False),
                lora_scaling=lora_scaling,
            )
            auxes.append(aux)
            h = h + attn_out
            attn_out, _ = attention(bp["attn2"], layer_norm(bp["norm2"], h), heads=heads,
                                    encoder_hidden=ctx, lora_scaling=lora_scaling,
                                    use_faceid=opts.get("use_faceid", False))
            h = h + attn_out
            ff = geglu(bp["ff"]["net_0_proj"], layer_norm(bp["norm3"], h),
                       lora_scaling=lora_scaling)
            h = h + dense(bp["ff"]["net_2"], ff, lora_scaling=lora_scaling)
        h = dense(p["proj_out"], h, lora_scaling=lora_scaling)
        return h.reshape(b, hh, ww, c) + x, auxes


def _text_time_embedding(p, added_cond: Optional[Dict[str, torch.Tensor]], cfg: UNetConfig,
                         dtype) -> torch.Tensor:
    """SDXL's added conditioning [B, temb]: add_embedding (linear, SiLU,
    linear) of the pooled text embedding ``text_embeds`` [B, D] beside the
    sinusoid of each of the ``time_ids`` [B, 6] (diffusers' add_time_proj)."""
    if added_cond is None:
        raise ValueError("a text_time UNet needs added_cond={'text_embeds': [B, D], "
                         "'time_ids': [B, 6]}")
    text, ids = added_cond["text_embeds"], added_cond["time_ids"]
    time = timestep_embedding(ids.reshape(-1), cfg.addition_time_embed_dim,
                              flip_sin_to_cos=cfg.flip_sin_to_cos,
                              downscale_freq_shift=cfg.freq_shift)
    h = torch.cat([text.float(), time.reshape(text.shape[0], -1)], dim=-1).to(dtype)
    h = dense(p["linear_1"], h)
    return dense(p["linear_2"], silu(h))


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
    freeu: Optional[FreeUParams] = FreeUParams(),
    added_cond: Optional[Dict[str, torch.Tensor]] = None,
    lora_scaling: float = 1.0,
    use_fused_attention: bool = False,
    use_faceid: bool = False,
    capture_taps: bool = False,
    compute_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """sample [B, H, W, 4] NHWC latents, timesteps [B] (or scalar) int,
    encoder_hidden_states [B, 77, ctx] -> (epsilon [B, H, W, 4] in the sample
    dtype, aux = {'kv': [(k, v) a shared layer] when capture_kv,
    'attn_probs': [p a shared layer] when save_attn_probs (fp32 [B, h, Sq,
    Skv]; None at layers outside ``probs_layers`` when given), 'seg_sums':
    [s a shared layer] when save_seg_sums (fp32 [B, h, Sq, n_seg]), 'taps':
    {...} when capture_taps}), with ``cfg.num_shared_attn_layers`` shared
    layers. Tap names match the JAX package: conv_in, down_block_i,
    mid_block, shared_attn_i (the output of the transformer whose first
    shared layer is i), up_block_i. ``use_faceid``: ``encoder_hidden_states``
    are face embeddings [B, M, 512], read through every cross-attention's
    FaceID projections. ``freeu``: FreeU's factors (None: off).
    ``added_cond``: {'text_embeds' [B, D], 'time_ids' [B, 6]} for a
    ``text_time`` UNet."""
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
    if cfg.addition_embed_type == "text_time":
        temb = temb + _text_time_embedding(params["add_embedding"], added_cond, cfg,
                                           compute_dtype)

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
                tp = bp["attentions"][j]
                x, _ = _transformer(tp, x, ctx, cfg=cfg, heads=cfg.attention_heads[i],
                                    lora_scaling=lora_scaling,
                                    shared=[plain] * len(tp["transformer_blocks"]))
            skips.append(x)
        if "downsamplers" in bp:
            x = conv2d(bp["downsamplers"][0]["conv"], x, stride=2, lora_scaling=lora_scaling)
            skips.append(x)
        if capture_taps:
            taps[f"down_block_{i}"] = x

    mp = params["mid_block"]
    x = _resnet(mp["resnets"][0], x, temb, cfg=cfg, lora_scaling=lora_scaling)
    tp = mp["attentions"][0]
    x, _ = _transformer(tp, x, ctx, cfg=cfg, heads=cfg.attention_heads[-1],
                        lora_scaling=lora_scaling, shared=[plain] * len(tp["transformer_blocks"]))
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
                tp = bp["attentions"][j]
                layers = range(shared_idx, shared_idx + len(tp["transformer_blocks"]))
                shared = [{
                    "ref_kv": ref_kv[layer] if ref_kv is not None else None,
                    "use_adain": use_adain,
                    "train_input": train_input,
                    "capture_kv": capture_kv,
                    "save_probs": save_attn_probs and (probs_layers is None
                                                       or layer in probs_layers),
                    "save_seg_sums": save_seg_sums,
                    "use_fused": use_fused_attention,
                    "use_faceid": use_faceid,
                } for layer in layers]
                x, auxes = _transformer(tp, x, ctx, cfg=cfg, heads=heads,
                                        lora_scaling=lora_scaling, shared=shared)
                for aux in auxes:
                    if capture_kv:
                        kv_list.append(aux["kv"])
                    if save_attn_probs:
                        probs_list.append(aux.get("probs"))
                    if save_seg_sums and "seg_sums" in aux:
                        seg_sums_list.append(aux["seg_sums"])
                if capture_taps:
                    taps[f"shared_attn_{shared_idx}"] = x
                shared_idx += len(layers)
        if "upsamplers" in bp:
            x = upsample2x_conv(bp["upsamplers"][0]["conv"], x, lora_scaling=lora_scaling)
        if capture_taps:
            taps[f"up_block_{i}"] = x

    x = group_norm(params["conv_norm_out"], x, num_groups=cfg.norm_num_groups, eps=cfg.norm_eps,
                   act="silu")
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


def quantize_unet_int8(unet_params: Dict[str, Any]) -> Dict[str, Any]:
    """Serving-only int8 of the UNet's conv mass: the down, mid and up
    blocks' resnet convs and their down/upsamplers (upsamplers folded), as
    ``models/vae.py::quantize_decoder_int8``. conv_in, conv_out, the time
    embedding and the transformers stay as they are. For the restoration
    UNet only: the capture UNet keeps full precision."""
    out = dict(unet_params)
    out["down_blocks"] = [quantize_block_convs_int8(b) for b in unet_params["down_blocks"]]
    out["mid_block"] = quantize_block_convs_int8(unet_params["mid_block"])
    out["up_blocks"] = [quantize_block_convs_int8(b) for b in unet_params["up_blocks"]]
    return out
