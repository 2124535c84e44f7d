"""Swin-Transformer-Tiny encoder (counterpart of
``instantrestore_tpu/models/swin.py``): the backbone of the 'swin',
'seg_ade' and 'det_coco' discriminators. Patch embed, four stages of
(shifted-)window attention with a relative-position bias and patch merging,
final LayerNorm -> [B, H/32, W/32, 768].

The relative-position index and the shifted windows' masks are numpy,
built once per shape. A grid that is not a multiple of the window is
zero-padded bottom and right and cut back after the attention.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from instantrestore_tpu_torch import device_constant
from instantrestore_tpu_torch.ops.primitives import dense, init_dense, init_norm, layer_norm


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: float = 4.0
    norm_eps: float = 1e-5


SWIN_TINY = SwinConfig()


def init_swin_params(gen: torch.Generator, cfg: SwinConfig = SWIN_TINY, *,
                     device=None) -> Dict[str, Any]:
    """Random weights with JAX's ``init_swin_params`` distributions."""
    d = cfg.embed_dim

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    params: Dict[str, Any] = {
        "patch_embed": {"weight": randn(d, 3, cfg.patch_size, cfg.patch_size) * 0.02,
                        "bias": torch.zeros(d, device=device)},
        "patch_norm": init_norm(d, device=device),
        "stages": [],
        "norm": init_norm(d * 2 ** (len(cfg.depths) - 1), device=device),
    }
    dim = d
    for si, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
        hidden = int(dim * cfg.mlp_ratio)
        blocks = [{
            "norm1": init_norm(dim, device=device),
            "attn": {"qkv": init_dense(gen, dim, 3 * dim, device=device),
                     "proj": init_dense(gen, dim, dim, device=device),
                     "rel_bias": randn((2 * cfg.window - 1) ** 2, heads) * 0.02},
            "norm2": init_norm(dim, device=device),
            "mlp": {"fc1": init_dense(gen, dim, hidden, device=device),
                    "fc2": init_dense(gen, hidden, dim, device=device)},
        } for _ in range(depth)]
        stage: Dict[str, Any] = {"blocks": blocks}
        if si < len(cfg.depths) - 1:
            stage["downsample"] = {"norm": init_norm(4 * dim, device=device),
                                   "reduction": {"weight": randn(2 * dim, 4 * dim) * 0.02}}
            dim *= 2
        params["stages"].append(stage)
    return params


@functools.lru_cache(maxsize=8)
def _rel_position_index(w: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)  # [w*w, w*w]


@functools.lru_cache(maxsize=32)
def _shift_attn_mask(h: int, w_img: int, w: int, shift: int) -> np.ndarray:
    """Per-window additive mask of shifted-window attention [nW, w2, w2]."""
    img = np.zeros((h, w_img))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(h // w, w, w_img // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    b, h, w_img, c = x.shape
    x = x.reshape(b, h // w, w, w_img // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def _window_reverse(wins: torch.Tensor, w: int, h: int, w_img: int) -> torch.Tensor:
    c = wins.shape[-1]
    x = wins.reshape(-1, h // w, w_img // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h, w_img, c)


def _swin_block(bp, x, h, w_img, heads, window, shift, cfg: SwinConfig):
    b, _, c = x.shape
    hd = c // heads
    shortcut = x
    hx = layer_norm(bp["norm1"], x, eps=cfg.norm_eps).reshape(b, h, w_img, c)
    pad_h, pad_w = (-h) % window, (-w_img) % window
    hp, wp = h + pad_h, w_img + pad_w
    if pad_h or pad_w:
        hx = F.pad(hx, (0, 0, 0, pad_w, 0, pad_h))
    if shift:
        hx = torch.roll(hx, (-shift, -shift), (1, 2))
    wins = _window_partition(hx, window)  # [b*nW, w2, c]
    nw = wins.shape[0] // b
    w2 = window * window
    qkv = dense(bp["attn"]["qkv"], wins)
    q, k, v = (t.reshape(-1, w2, heads, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (hd ** -0.5)
    index = device_constant(("swin_rel_index", window), x.device,
                            lambda: torch.from_numpy(_rel_position_index(window)))
    bias = bp["attn"]["rel_bias"][index]  # [w2, w2, heads]
    logits = logits + bias.permute(2, 0, 1)[None].to(logits.dtype)
    if shift:
        mask = device_constant(("swin_shift_mask", hp, wp, window, shift), x.device,
                               lambda: torch.from_numpy(_shift_attn_mask(hp, wp, window, shift)))
        logits = (logits.reshape(b, nw, heads, w2, w2) + mask[None, :, None]).reshape(
            -1, heads, w2, w2)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.matmul(probs, v).transpose(1, 2).reshape(-1, w2, c)
    o = _window_reverse(dense(bp["attn"]["proj"], o), window, hp, wp)
    if shift:
        o = torch.roll(o, (shift, shift), (1, 2))
    if pad_h or pad_w:
        o = o[:, :h, :w_img]
    x = shortcut + o.reshape(b, h * w_img, c)
    hx = layer_norm(bp["norm2"], x, eps=cfg.norm_eps)
    return x + dense(bp["mlp"]["fc2"], F.gelu(dense(bp["mlp"]["fc1"], hx)))


def _patch_merge(dp, x, h, w_img, cfg: SwinConfig):
    b, _, c = x.shape
    x = x.reshape(b, h, w_img, c)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                  dim=-1).reshape(b, (h // 2) * (w_img // 2), 4 * c)
    return dense(dp["reduction"], layer_norm(dp["norm"], x, eps=cfg.norm_eps))


def swin_features(params: Dict[str, Any], images: torch.Tensor, *, cfg: SwinConfig = SWIN_TINY,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """images [B, H, W, 3] (backbone-normalised) -> final-norm features
    [B, H/32, W/32, 8 * embed_dim]."""
    b = images.shape[0]
    x = F.conv2d(images.to(compute_dtype).permute(0, 3, 1, 2),
                 params["patch_embed"]["weight"].to(compute_dtype),
                 params["patch_embed"]["bias"].to(compute_dtype), stride=cfg.patch_size)
    h, w_img = x.shape[-2:]
    x = layer_norm(params["patch_norm"], x.flatten(2).transpose(1, 2), eps=cfg.norm_eps)
    for si, stage in enumerate(params["stages"]):
        heads = cfg.num_heads[si]
        window = min(cfg.window, h)
        for bi, bp in enumerate(stage["blocks"]):
            shift = 0 if bi % 2 == 0 or window >= h else window // 2
            x = _swin_block(bp, x, h, w_img, heads, window, shift, cfg)
        if "downsample" in stage:
            x = _patch_merge(stage["downsample"], x, h, w_img, cfg)
            h, w_img = h // 2, w_img // 2
    x = layer_norm(params["norm"], x, eps=cfg.norm_eps)
    return x.reshape(b, h, w_img, -1)


def convert_swin_params(sd: Dict[str, Any]) -> Dict[str, Any]:
    """A timm Swin state dict (MoBY, after the 'encoder.' strip) or an
    mmdet one (seg_ade / det_coco, after the 'backbone.' strip, whose
    stride-32 norm is 'norm3') -> the port's tree."""

    def t(name):
        return torch.as_tensor(sd[name]).detach().float().clone()

    def norm(name):
        return {"weight": t(f"{name}.weight"), "bias": t(f"{name}.bias")}

    def lin(name):
        p = {"weight": t(f"{name}.weight")}
        if f"{name}.bias" in sd:
            p["bias"] = t(f"{name}.bias")
        return p

    params: Dict[str, Any] = {
        "patch_embed": lin("patch_embed.proj"),
        "patch_norm": norm("patch_embed.norm"),
        "stages": [],
        "norm": norm("norm" if "norm.weight" in sd else "norm3"),
    }
    si = 0
    while f"layers.{si}.blocks.0.norm1.weight" in sd:
        blocks = []
        bi = 0
        while f"layers.{si}.blocks.{bi}.norm1.weight" in sd:
            pre = f"layers.{si}.blocks.{bi}"
            blocks.append({
                "norm1": norm(f"{pre}.norm1"),
                "attn": {"qkv": lin(f"{pre}.attn.qkv"), "proj": lin(f"{pre}.attn.proj"),
                         "rel_bias": t(f"{pre}.attn.relative_position_bias_table")},
                "norm2": norm(f"{pre}.norm2"),
                "mlp": {"fc1": lin(f"{pre}.mlp.fc1"), "fc2": lin(f"{pre}.mlp.fc2")},
            })
            bi += 1
        stage: Dict[str, Any] = {"blocks": blocks}
        if f"layers.{si}.downsample.reduction.weight" in sd:
            stage["downsample"] = {"norm": norm(f"layers.{si}.downsample.norm"),
                                   "reduction": lin(f"layers.{si}.downsample.reduction")}
        params["stages"].append(stage)
        si += 1
    return params
