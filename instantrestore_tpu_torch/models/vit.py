"""ViT backbones of the vision-aided GAN discriminator (counterpart of
``instantrestore_tpu/models/vit.py``): DINOv2 ViT-L/14 (the shipped
discriminator), DINO ViT-B/16 and the CLIP ViT-B/32 visual tower.

``vit_intermediate_layers`` gives the final-norm outputs of the last n
blocks (patch tokens and class token); ``clip_multi_level`` the CLIP
tower's raw taps at depth/3 and 2 depth/3 and its projected class
embedding. Patch-14/16/32 conv embed, class token, learned position
embedding (resized from its training grid as ``jax.image.resize(method=
"cubic")`` does, antialias included), pre-norm blocks with optional
LayerScale, exact GELU or QuickGELU. The block's attention is plain
matmuls and a softmax over fp32 logits, as in JAX (no fused kernel there).

Parameters: the JAX tree's nesting with PyTorch layouts (``weight`` [out,
in], OIHW patch embed, norms ``weight``/``bias``; ``cls_token``,
``pos_embed``, ``proj`` [d, proj_dim] and LayerScale ``gamma`` as they are).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from instantrestore_tpu_torch.ops.image_ops import resize
from instantrestore_tpu_torch.ops.primitives import dense, init_dense, init_norm, layer_norm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    pos_grid: int = 37  # DINOv2's 518 px training grid
    layerscale: bool = True
    norm_eps: float = 1e-6
    quick_gelu: bool = False  # CLIP: x * sigmoid(1.702 x)
    ln_pre: bool = False      # CLIP: LayerNorm after the position embedding
    proj_dim: int = 0         # CLIP: > 0 projects ln_post(cls) @ proj


DINOV2_VITL14 = ViTConfig()

# DINO v1 ViT-B/16: plain pre-norm ViT, no LayerScale, 224 px training grid
DINO_VITB16 = ViTConfig(patch_size=16, embed_dim=768, depth=12, num_heads=12, pos_grid=14,
                        layerscale=False)

# CLIP ViT-B/32 visual tower: ln_pre, QuickGELU, 512-d projected embedding
CLIP_VITB32 = ViTConfig(patch_size=32, embed_dim=768, depth=12, num_heads=12, pos_grid=7,
                        layerscale=False, norm_eps=1e-5, quick_gelu=True, ln_pre=True,
                        proj_dim=512)


def init_vit_params(gen: torch.Generator, cfg: ViTConfig = DINOV2_VITL14, *,
                    device=None) -> Dict[str, Any]:
    """Random weights with JAX's ``init_vit_params`` distributions."""
    d = cfg.embed_dim
    hidden = int(d * cfg.mlp_ratio)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    params: Dict[str, Any] = {
        "patch_embed": {"weight": randn(d, 3, cfg.patch_size, cfg.patch_size) * 0.02,
                        "bias": torch.zeros(d, device=device)},
        "cls_token": torch.zeros((1, 1, d), device=device),
        "pos_embed": randn(1, cfg.pos_grid ** 2 + 1, d) * 0.02,
        "blocks": [],
        "norm": init_norm(d, device=device),
    }
    for _ in range(cfg.depth):
        block = {
            "norm1": init_norm(d, device=device),
            "attn": {"qkv": init_dense(gen, d, 3 * d, device=device),
                     "proj": init_dense(gen, d, d, device=device)},
            "norm2": init_norm(d, device=device),
            "mlp": {"fc1": init_dense(gen, d, hidden, device=device),
                    "fc2": init_dense(gen, hidden, d, device=device)},
        }
        if cfg.layerscale:
            block["ls1"] = {"gamma": torch.full((d,), 1e-5, device=device)}
            block["ls2"] = {"gamma": torch.full((d,), 1e-5, device=device)}
        params["blocks"].append(block)
    if cfg.ln_pre:
        params["ln_pre"] = init_norm(d, device=device)
    if cfg.proj_dim:
        params["proj"] = randn(d, cfg.proj_dim) * d ** -0.5
    return params


def _interp_pos_embed(pos: torch.Tensor, grid: int, target: int) -> torch.Tensor:
    """Bicubic resize of the patch position grid (DINOv2's
    interpolate_pos_encoding)."""
    if grid == target:
        return pos
    d = pos.shape[-1]
    patch = resize(pos[:, 1:].reshape(1, grid, grid, d), (target, target), "cubic")
    return torch.cat([pos[:, :1], patch.reshape(1, target * target, d)], dim=1)


def _embed(params, images: torch.Tensor, cfg: ViTConfig, compute_dtype) -> Tuple[torch.Tensor, int]:
    """Patch embed, class token and position embedding: [B, 1 + g*g, D]."""
    b = images.shape[0]
    x = F.conv2d(images.to(compute_dtype).permute(0, 3, 1, 2),
                 params["patch_embed"]["weight"].to(compute_dtype),
                 params["patch_embed"]["bias"].to(compute_dtype), stride=cfg.patch_size)
    g = x.shape[-2]
    x = x.flatten(2).transpose(1, 2)
    cls = params["cls_token"].to(compute_dtype).expand(b, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1)
    return x + _interp_pos_embed(params["pos_embed"], cfg.pos_grid, g).to(compute_dtype), g


def vit_block(bp, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """One pre-norm block: attention with fp32 logits, then the MLP, each
    with optional LayerScale."""
    b, n, d = x.shape
    heads = cfg.num_heads
    hd = d // heads
    qkv = dense(bp["attn"]["qkv"], layer_norm(bp["norm1"], x, eps=cfg.norm_eps))
    q, k, v = (t.reshape(b, n, heads, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(logits * (hd ** -0.5), dim=-1).to(v.dtype)
    o = torch.matmul(probs, v).transpose(1, 2).reshape(b, n, d)
    o = dense(bp["attn"]["proj"], o)
    if "ls1" in bp:
        o = o * bp["ls1"]["gamma"].to(o.dtype)
    x = x + o
    h = dense(bp["mlp"]["fc1"], layer_norm(bp["norm2"], x, eps=cfg.norm_eps))
    h = h * torch.sigmoid(1.702 * h) if cfg.quick_gelu else F.gelu(h)
    h = dense(bp["mlp"]["fc2"], h)
    if "ls2" in bp:
        h = h * bp["ls2"]["gamma"].to(h.dtype)
    return x + h


def vit_intermediate_layers(params: Dict[str, Any], images: torch.Tensor, n: int = 8, *,
                            cfg: ViTConfig = DINOV2_VITL14, compute_dtype=torch.float32
                            ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """images [B, H, W, 3] (backbone-normalised) -> for each of the last n
    blocks (patch tokens [B, g*g, D], class token [B, D]) after the final
    LayerNorm."""
    x, _ = _embed(params, images, cfg, compute_dtype)
    depth = len(params["blocks"])
    outputs = []
    for li, bp in enumerate(params["blocks"]):
        x = vit_block(bp, x, cfg)
        if li >= depth - n:
            outputs.append(layer_norm(params["norm"], x, eps=cfg.norm_eps))
    return [(o[:, 1:], o[:, 0]) for o in outputs]


def clip_multi_level(params: Dict[str, Any], images: torch.Tensor, *,
                     cfg: ViTConfig = CLIP_VITB32, compute_dtype=torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CLIP tower's taps: raw hidden states after blocks depth/3 and
    2 depth/3 (class token dropped, [B, g, g, D], not final-normed) and the
    projected class embedding ln_post(cls) @ proj."""
    x, g = _embed(params, images, cfg, compute_dtype)
    b = x.shape[0]
    if "ln_pre" in params:
        x = layer_norm(params["ln_pre"], x, eps=cfg.norm_eps)
    depth = len(params["blocks"])
    taps = {depth // 3 - 1, 2 * depth // 3 - 1}
    spatial = []
    for li, bp in enumerate(params["blocks"]):
        x = vit_block(bp, x, cfg)
        if li in taps:
            spatial.append(x[:, 1:].reshape(b, g, g, -1))
    cls_out = layer_norm(params["norm"], x[:, 0], eps=cfg.norm_eps)
    return spatial[0], spatial[1], cls_out @ params["proj"].to(cls_out.dtype)


def _t(sd, name) -> torch.Tensor:
    return torch.as_tensor(sd[name]).detach().float().clone()


def _lin(sd, name) -> Dict[str, torch.Tensor]:
    return {"weight": _t(sd, f"{name}.weight"), "bias": _t(sd, f"{name}.bias")}


def convert_clip_visual(sd: Dict[str, Any]) -> Dict[str, Any]:
    """A CLIP ``model.visual`` state dict (OpenAI clip / open_clip names:
    conv1, class_embedding, positional_embedding, ln_pre,
    transformer.resblocks.N.{ln_1, attn.in_proj, attn.out_proj, mlp.c_fc,
    mlp.c_proj, ln_2}, ln_post, proj) -> the tree of ``clip_multi_level``."""
    d = _t(sd, "class_embedding").shape[-1]
    params: Dict[str, Any] = {
        "patch_embed": {"weight": _t(sd, "conv1.weight"), "bias": torch.zeros(d)},  # no bias
        "cls_token": _t(sd, "class_embedding").reshape(1, 1, d),
        "pos_embed": _t(sd, "positional_embedding")[None],
        "ln_pre": _lin(sd, "ln_pre"),
        "blocks": [],
        "norm": _lin(sd, "ln_post"),
        "proj": _t(sd, "proj"),
    }
    i = 0
    while f"transformer.resblocks.{i}.ln_1.weight" in sd:
        pre = f"transformer.resblocks.{i}"
        params["blocks"].append({
            "norm1": _lin(sd, f"{pre}.ln_1"),
            "attn": {"qkv": {"weight": _t(sd, f"{pre}.attn.in_proj_weight"),
                             "bias": _t(sd, f"{pre}.attn.in_proj_bias")},
                     "proj": _lin(sd, f"{pre}.attn.out_proj")},
            "norm2": _lin(sd, f"{pre}.ln_2"),
            "mlp": {"fc1": _lin(sd, f"{pre}.mlp.c_fc"), "fc2": _lin(sd, f"{pre}.mlp.c_proj")},
        })
        i += 1
    return params


def convert_vit_params(sd: Dict[str, Any]) -> Dict[str, Any]:
    """A DINOv2 (torch hub) state dict -> the port's tree."""
    params: Dict[str, Any] = {
        "patch_embed": _lin(sd, "patch_embed.proj"),
        "cls_token": _t(sd, "cls_token"),
        "pos_embed": _t(sd, "pos_embed"),
        "blocks": [],
        "norm": _lin(sd, "norm"),
    }
    i = 0
    while f"blocks.{i}.norm1.weight" in sd:
        pre = f"blocks.{i}"
        blk = {
            "norm1": _lin(sd, f"{pre}.norm1"),
            "attn": {"qkv": _lin(sd, f"{pre}.attn.qkv"), "proj": _lin(sd, f"{pre}.attn.proj")},
            "norm2": _lin(sd, f"{pre}.norm2"),
            "mlp": {"fc1": _lin(sd, f"{pre}.mlp.fc1"), "fc2": _lin(sd, f"{pre}.mlp.fc2")},
        }
        if f"{pre}.ls1.gamma" in sd:
            blk["ls1"] = {"gamma": _t(sd, f"{pre}.ls1.gamma")}
            blk["ls2"] = {"gamma": _t(sd, f"{pre}.ls2.gamma")}
        params["blocks"].append(blk)
        i += 1
    return params
