"""Vision-aided GAN discriminator (counterpart of
``instantrestore_tpu/training/losses/gan.py``): a frozen backbone, trainable
spectral-norm heads, DiffAugment ('color,translation,cutout') and the
multi-level sigmoid loss (BCE with logits against 0.8-smoothed real
targets).

Functional, as in JAX: the heads' parameters and their power-iteration
vectors ``u`` are data, and ``discriminate`` returns ``(loss, new_heads)``
with the new ``u`` vectors instead of updating buffers behind the caller.
torch cannot replay ``jax.random``: DiffAugment takes its draws as a dict
(``diff_augment_draws`` draws them from a ``torch.Generator``; the tests
inject JAX's).

Backbones by ``disc_type``: 'dinov2' (ViT-L/14, the shipped recipe),
'dino' (ViT-B/16) and 'clip' (ViT-B/32) under the multi-level heads;
'vgg', 'swin', 'seg_ade', 'det_coco', 'face_seg' and 'face_normals' under
a SimpleD head.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from instantrestore_tpu_torch import device_constant
from instantrestore_tpu_torch.models.vit import (
    CLIP_VITB32,
    DINOV2_VITL14,
    ViTConfig,
    clip_multi_level,
    vit_intermediate_layers,
)
from instantrestore_tpu_torch.ops.image_ops import resize
from instantrestore_tpu_torch.ops.primitives import conv2d, init_conv2d, init_dense

_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# only the CLIP backbone is normalised with CLIP's own std; dino, dinov2 and
# swin take the CLIP mean with the ImageNet std, as the reference does
_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)

_BLUR4 = np.array([1.0, 3.0, 3.0, 1.0])
_BLUR4 = np.outer(_BLUR4, _BLUR4)
_BLUR4 = (_BLUR4 / _BLUR4.sum()).astype(np.float32)

SIMPLE_HEAD_TYPES = ("vgg", "swin", "face_seg", "face_normals", "seg_ade", "det_coco")


# ---------------------------------------------------------------------------
# spectral norm (the power iteration's u as data)
# ---------------------------------------------------------------------------


def _sn_init(gen: torch.Generator, out_dim: int, device=None) -> torch.Tensor:
    u = torch.randn(out_dim, generator=gen, device=device)
    return u / torch.linalg.vector_norm(u)


def _sn_apply(weight: torch.Tensor, u: torch.Tensor, update: bool):
    """One power iteration over the weight as an [out, in*kh*kw] matrix;
    returns (weight / sigma, new u). sigma uses the new u when ``update``
    and the old one otherwise; the new u is returned either way, detached
    (gradients flow through the iteration into sigma, as in JAX)."""
    w2 = weight.reshape(weight.shape[0], -1).float()
    v = w2.t() @ u
    v = v / (torch.linalg.vector_norm(v) + 1e-12)
    u_new = w2 @ v
    u_new = u_new / (torch.linalg.vector_norm(u_new) + 1e-12)
    sigma = v @ (w2.t() @ (u_new if update else u))
    return (w2 / sigma).reshape(weight.shape).to(weight.dtype), u_new.detach()


def _sn_conv(p, x, *, stride, padding, update):
    w, u_new = _sn_apply(p["weight"], p["u"], update)
    y = conv2d({"weight": w, "bias": p["bias"]}, x, stride=stride, padding=padding)
    return y, {**p, "u": u_new}


def _sn_dense(p, x, *, update):
    w, u_new = _sn_apply(p["weight"], p["u"], update)
    return F.linear(x, w.to(x.dtype), p["bias"].to(x.dtype)), {**p, "u": u_new}


def _depthwise_blur(x: torch.Tensor, stride: int) -> torch.Tensor:
    """The 4x4 binomial filter per channel over NCHW ``x``, no padding."""
    c = x.shape[1]
    filt = device_constant("blur4", x.device, lambda: torch.from_numpy(_BLUR4)).to(x.dtype)
    filt = filt[None, None].expand(c, 1, 4, 4)
    return F.conv2d(x, filt, stride=stride, groups=c)


def _blurpool(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Antialiasing blur of NHWC ``x``: zero pad, then the 4-tap filter at
    stride 1."""
    y = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad))
    return _depthwise_blur(y, 1).permute(0, 2, 3, 1)


def _sn_sample(gen, p: Dict[str, torch.Tensor], device=None) -> Dict[str, torch.Tensor]:
    return {**p, "u": _sn_init(gen, p["weight"].shape[0], device)}


# ---------------------------------------------------------------------------
# DiffAugment (color, translation, cutout), per sample, differentiable
# ---------------------------------------------------------------------------


def diff_augment_draws(b: int, h: int, w: int, generator: torch.Generator,
                       device=None) -> Dict[str, torch.Tensor]:
    """The draws of one DiffAugment call: brightness U(-0.5, 0.5),
    saturation U(0, 2), contrast U(0.5, 1.5) per sample; integer shifts in
    [-h/8, h/8] and [-w/8, w/8]; the cutout square's centre."""
    def u(lo, hi):
        return torch.rand(b, generator=generator, device=generator.device) * (hi - lo) + lo

    def ints(lo, hi):
        return torch.randint(lo, hi, (b,), generator=generator, device=generator.device)

    ch = h // 2
    draws = {"brightness": u(-0.5, 0.5), "saturation": u(0.0, 2.0), "contrast": u(0.5, 1.5),
             "shift_y": ints(-(h // 8), h // 8 + 1), "shift_x": ints(-(w // 8), w // 8 + 1),
             "cut_y": ints(0, h + (1 - ch % 2) - ch // 2),
             "cut_x": ints(0, w + (1 - ch % 2) - ch // 2)}
    return {k: v.to(device) for k, v in draws.items()}


def diff_augment(x: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """DiffAugment 'color,translation,cutout' on NHWC images in [-1, 1] with
    the given draws (``diff_augment_draws``)."""
    b, h, w, _ = x.shape
    dev = x.device
    d = {k: v.to(dev) for k, v in draws.items()}
    x = x + d["brightness"].to(x.dtype)[:, None, None, None]
    mean_c = x.mean(dim=-1, keepdim=True)
    x = (x - mean_c) * d["saturation"].to(x.dtype)[:, None, None, None] + mean_c
    mean_all = x.mean(dim=(1, 2, 3), keepdim=True)
    x = (x - mean_all) * d["contrast"].to(x.dtype)[:, None, None, None] + mean_all
    # translation by whole pixels, zero fill
    ys = torch.arange(h, device=dev)[None, :] - d["shift_y"].long()[:, None]
    xs = torch.arange(w, device=dev)[None, :] - d["shift_x"].long()[:, None]
    ok = (((ys >= 0) & (ys < h))[:, :, None] & ((xs >= 0) & (xs < w))[:, None, :])
    rows = torch.arange(b, device=dev)[:, None, None]
    x = x[rows, ys.clamp(0, h - 1)[:, :, None], xs.clamp(0, w - 1)[:, None, :]]
    x = x * ok[..., None].to(x.dtype)
    # cutout: a zeroed square of side h/2 around the drawn centre
    ch = h // 2
    gy = torch.arange(h, device=dev)[None, :]
    gx = torch.arange(w, device=dev)[None, :]
    oy, ox = d["cut_y"].long()[:, None], d["cut_x"].long()[:, None]
    cut = (((gy >= oy - ch // 2) & (gy < oy + (ch + 1) // 2))[:, :, None]
           & ((gx >= ox - ch // 2) & (gx < ox + (ch + 1) // 2))[:, None, :])
    return x * (1.0 - cut[..., None].to(x.dtype))


# ---------------------------------------------------------------------------
# VGG16 backbone ('vgg': antialiased VGG16 features -> [B, 7, 7, 512])
# ---------------------------------------------------------------------------

_VGG_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


def init_vgg_backbone(gen: torch.Generator, *, device=None) -> Dict[str, Any]:
    """Random VGG16 conv trunk (13 convs, the LPIPS trunk's layout)."""
    stages, in_ch = [], 3
    for out_ch, n_convs in _VGG_STAGES:
        stage = []
        for _ in range(n_convs):
            stage.append(init_conv2d(gen, in_ch, out_ch, 3, device=device))
            in_ch = out_ch
        stages.append(stage)
    return {"vgg": stages}


def _blurpool_s2(x: torch.Tensor) -> torch.Tensor:
    """Antialiased downsample of NCHW ``x``: reflect pad (1, 2), the 4-tap
    filter at stride 2."""
    return _depthwise_blur(F.pad(x, (1, 2, 1, 2), mode="reflect"), 2)


def vgg_backbone_features(params: Dict[str, Any], x_pm1: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images -> [B, 7, 7, 512]: resize to 224, ImageNet
    normalisation, conv stages each followed by max-pool k2 s1 (right and
    bottom padded) and a blurpool of stride 2."""
    x = resize(x_pm1.float() * 0.5 + 0.5, (224, 224), "linear")
    x = (x - _const(_IMAGENET_MEAN, x.device)) / _const(_IMAGENET_STD, x.device)
    for stage in params["vgg"]:
        for conv in stage:
            x = F.relu(conv2d(conv, x))
        y = F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1), value=float("-inf"))
        x = _blurpool_s2(F.max_pool2d(y, 2, 1)).permute(0, 2, 3, 1)
    return x


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------


def init_simple_head(gen: torch.Generator, in_ch: int = 512, out_ch: int = 256,
                     out_size: int = 3, *, device=None) -> Dict[str, Any]:
    """SimpleD: blurpool -> SNConv3x3 s2 -> LeakyReLU -> SNLinear ->
    LeakyReLU -> SNLinear(1); out_size 3 on 7x7 maps, 4 on 8x8 ones."""
    return {
        "conv1": _sn_sample(gen, init_conv2d(gen, in_ch, out_ch, 3, device=device), device),
        "fc1": _sn_sample(gen, init_dense(gen, out_ch * out_size * out_size, out_ch,
                                          device=device), device),
        "out": _sn_sample(gen, init_dense(gen, out_ch, 1, device=device), device),
    }


def _simple_head_apply(heads, fmap, *, update_sn: bool):
    """fmap [B, S, S, C] -> ([[B, 1] logits], new heads)."""
    h = _blurpool(fmap, pad=2)
    h, c1 = _sn_conv(heads["conv1"], h, stride=2, padding=0, update=update_sn)
    h = F.leaky_relu(h, 0.2).reshape(h.shape[0], -1).float()
    h, f1 = _sn_dense(heads["fc1"], h, update=update_sn)
    out, fo = _sn_dense(heads["out"], F.leaky_relu(h, 0.2), update=update_sn)
    return [out], {"conv1": c1, "fc1": f1, "out": fo}


def init_mlp_head(gen: torch.Generator, in_ch: int = 768, out_ch: int = 256, *,
                  device=None) -> Dict[str, Any]:
    """MLPD: SNLinear -> LeakyReLU -> SNLinear(1), for pooled embeddings."""
    return {"fc1": _sn_sample(gen, init_dense(gen, in_ch, out_ch, device=device), device),
            "out": _sn_sample(gen, init_dense(gen, out_ch, 1, device=device), device)}


def _mlp_head_apply(heads, embed, *, update_sn: bool):
    """embed [B, C] -> ([[B, 1] logits], new heads)."""
    h, f1 = _sn_dense(heads["fc1"], embed.float(), update=update_sn)
    out, fo = _sn_dense(heads["out"], F.leaky_relu(h, 0.2), update=update_sn)
    return [out], {"fc1": f1, "out": fo}


def init_discriminator_heads(gen: torch.Generator, embed_dim: int = 1024, out_ch: int = 256,
                             token_dim: Optional[int] = None, *, device=None) -> Dict[str, Any]:
    """MultiLevelDViT: two conv branches and a class-token MLP branch
    (dinov2 1024/256/1024, dino 768/128/768, clip 768/256/512)."""
    token_dim = embed_dim if token_dim is None else token_dim
    branches = [{
        "conv1": _sn_sample(gen, init_conv2d(gen, embed_dim, out_ch, 3, device=device), device),
        "conv2": _sn_sample(gen, init_conv2d(gen, out_ch, 1, 1, device=device), device),
    } for _ in range(2)]
    return {
        "spatial": branches,
        "token_fc": _sn_sample(gen, init_dense(gen, token_dim, out_ch, device=device), device),
        "token_out": _sn_sample(gen, init_dense(gen, out_ch, 1, device=device), device),
    }


def _heads_apply(heads, feats, *, update_sn: bool, down: int = 2):
    """feats (fmap, fmap, token) -> ([[B, 4, 4], [B, 4, 4], [B, 1]] logits,
    new heads). ``down`` 2: blurpool + strided conv (dino, dinov2); 1: a
    stride-1 conv (clip's 7x7 grid)."""
    new_heads: Dict[str, Any] = {"spatial": []}
    logits = []
    for branch, fmap in zip(heads["spatial"], feats[:2]):
        if down > 1:
            h, c1 = _sn_conv(branch["conv1"], _blurpool(fmap, pad=2), stride=2, padding=0,
                             update=update_sn)
        else:
            h, c1 = _sn_conv(branch["conv1"], fmap, stride=1, padding=1, update=update_sn)
        h = _blurpool(F.leaky_relu(h, 0.2), pad=1 if down > 1 else 2)
        h, c2 = _sn_conv(branch["conv2"], h, stride=2, padding=0, update=update_sn)
        logits.append(h[..., 0])
        new_heads["spatial"].append({"conv1": c1, "conv2": c2})
    h, fc = _sn_dense(heads["token_fc"], feats[2].float(), update=update_sn)
    out, to = _sn_dense(heads["token_out"], F.leaky_relu(h, 0.2), update=update_sn)
    logits.append(out)
    new_heads["token_fc"], new_heads["token_out"] = fc, to
    return logits, new_heads


def multilevel_sigmoid_loss(logits: List[torch.Tensor], *, for_real: bool, for_g: bool = False,
                            alpha: float = 0.8) -> torch.Tensor:
    """Per-level BCE with logits against ``alpha`` (real, or G) or 0 (fake),
    averaged over space, summed over the levels: [B, 1]."""
    target = alpha if (for_real or for_g) else 0.0
    total = 0.0
    for lg in logits:
        lgf = lg.float()
        bce = lgf.clamp_min(0) - lgf * target + torch.log1p(torch.exp(-lgf.abs()))
        if bce.ndim > 2:
            bce = bce.mean(dim=tuple(range(1, bce.ndim))).reshape(-1, 1)
        total = total + bce
    return total


def _const(a: np.ndarray, device) -> torch.Tensor:
    """A normalisation constant on ``device`` (``device_constant``)."""
    return device_constant(("gan_const", a.dtype.str, a.tobytes()), device,
                           lambda: torch.from_numpy(a))


def _normalised(x01: torch.Tensor, size: int, mean: np.ndarray, std: np.ndarray) -> torch.Tensor:
    x = resize(x01, (size, size), "linear")
    return (x - _const(mean, x.device)) / _const(std, x.device)


def discriminate(
    backbone_params: Dict[str, Any],
    heads: Dict[str, Any],
    images: torch.Tensor,
    *,
    draws: Optional[Dict[str, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    for_real: bool = True,
    for_g: bool = False,
    vit_cfg: ViTConfig = DINOV2_VITL14,
    update_sn: bool = True,
    diffaug: bool = True,
    disc_type: str = "dinov2",
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One vision-aided D pass on NHWC images in [-1, 1]: DiffAugment (its
    ``draws``, else drawn from ``generator``) -> frozen backbone features
    -> spectral-norm heads -> multi-level sigmoid loss. Returns (per-sample
    loss [B, 1], new heads). Without ``for_g`` the features carry no
    gradient to the images."""
    if diffaug:
        if draws is None:
            if generator is None:
                raise ValueError("discriminate needs draws= or a torch.Generator for DiffAugment")
            draws = diff_augment_draws(*images.shape[:3], generator, images.device)
        x = diff_augment(images, draws)
    else:
        x = images

    def frozen(*feats):
        return feats if for_g else tuple(f.detach() for f in feats)

    if disc_type in SIMPLE_HEAD_TYPES:
        if disc_type == "vgg":
            fmap = vgg_backbone_features(backbone_params, x)
        elif disc_type in ("swin", "seg_ade", "det_coco"):
            from instantrestore_tpu_torch.models.swin import swin_features

            x01 = x.float() * 0.5 + 0.5
            fmap = swin_features(backbone_params,
                                 _normalised(x01, 224, _CLIP_MEAN, _IMAGENET_STD)
                                 if disc_type == "swin"
                                 else _normalised(x01, 256, _IMAGENET_MEAN, _IMAGENET_STD))
        elif disc_type == "face_seg":
            from instantrestore_tpu_torch.training.losses.backbones import face_seg_features

            fmap = face_seg_features(backbone_params, x)
        else:
            from instantrestore_tpu_torch.training.losses.backbones import face_normals_features

            fmap = face_normals_features(backbone_params, x)
        logits, new_heads = _simple_head_apply(heads, *frozen(fmap), update_sn=update_sn)
        return multilevel_sigmoid_loss(logits, for_real=for_real, for_g=for_g), new_heads

    std = _CLIP_STD if disc_type == "clip" else _IMAGENET_STD
    x224 = _normalised(x * 0.5 + 0.5, 224, _CLIP_MEAN, std)
    if disc_type == "clip":
        clip_cfg = vit_cfg if vit_cfg.proj_dim else CLIP_VITB32
        feats = frozen(*clip_multi_level(backbone_params, x224, cfg=clip_cfg))
        logits, new_heads = _heads_apply(heads, feats, update_sn=update_sn, down=1)
        return multilevel_sigmoid_loss(logits, for_real=for_real, for_g=for_g), new_heads

    # dinov2 / dino: indices [0, n/2, -1] of the last n = min(8, depth) blocks
    n_taps = min(8, vit_cfg.depth)
    inter = vit_intermediate_layers(backbone_params, x224, n=n_taps, cfg=vit_cfg)
    b, g = x224.shape[0], 224 // vit_cfg.patch_size
    feats = frozen(inter[0][0].reshape(b, g, g, -1), inter[n_taps // 2][0].reshape(b, g, g, -1),
                   inter[-1][1])
    logits, new_heads = _heads_apply(heads, feats, update_sn=update_sn)
    return multilevel_sigmoid_loss(logits, for_real=for_real, for_g=for_g), new_heads
