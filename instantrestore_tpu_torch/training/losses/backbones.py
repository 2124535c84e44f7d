"""Frozen conv backbones of the vision-aided GAN discriminator (counterpart
of ``instantrestore_tpu/training/losses/backbones.py``), each a feature
extractor under a SimpleD head:

* ``face_normals``: the ResNet18 encoder of the face-normals ResNetUNet;
  resize to 256 (antialiased linear), input in [0, 1], layer4 features
  [B, 8, 8, 512];
* ``face_seg``: the encoder ("center") of the CelebA parsing UNet
  (feature_scale 4); resize to 256, input in [-1, 1], center features
  average-pooled by 2 -> [B, 8, 8, 256].

BatchNorm runs in eval mode: a per-channel affine from the running
statistics (``weight``, ``bias``, ``mean``, ``var``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from instantrestore_tpu_torch.ops.image_ops import resize

BN_EPS = 1e-5


def _bn_eval(p, x):
    """Folded eval-mode BatchNorm of NCHW ``x``."""
    inv = torch.rsqrt(p["var"].float() + BN_EPS)
    scale = (p["weight"].float() * inv).to(x.dtype)
    bias = (p["bias"].float() - p["mean"].float() * p["weight"].float() * inv).to(x.dtype)
    return x * scale[None, :, None, None] + bias[None, :, None, None]


def _conv(p, x, stride=1, padding=0):
    """NCHW conv with an OIHW ``weight`` and optional ``bias``."""
    b = p.get("bias")
    return F.conv2d(x, p["weight"].to(x.dtype), None if b is None else b.to(x.dtype),
                    stride, padding)


def _init_conv(gen, cin, cout, k, bias=True, device=None):
    p = {"weight": torch.randn((cout, cin, k, k), generator=gen, device=device)
         * math.sqrt(2.0 / (cin * k * k))}
    if bias:
        p["bias"] = torch.zeros(cout, device=device)
    return p


def _init_bn(c, device=None):
    return {"weight": torch.ones(c, device=device), "bias": torch.zeros(c, device=device),
            "mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)}


# ---------------------------------------------------------------------------
# ResNet18 encoder (torchvision layout)
# ---------------------------------------------------------------------------

_RESNET18_STAGES = [(64, 1), (128, 2), (256, 2), (512, 2)]  # (width, stride)


def init_resnet18(gen: torch.Generator, *, device=None) -> Dict[str, Any]:
    params: Dict[str, Any] = {"conv1": _init_conv(gen, 3, 64, 7, bias=False, device=device),
                              "bn1": _init_bn(64, device), "layers": []}
    cin = 64
    for width, stride in _RESNET18_STAGES:
        blocks = []
        for b in range(2):
            s = stride if b == 0 else 1
            blk = {"conv1": _init_conv(gen, cin, width, 3, bias=False, device=device),
                   "bn1": _init_bn(width, device),
                   "conv2": _init_conv(gen, width, width, 3, bias=False, device=device),
                   "bn2": _init_bn(width, device)}
            if s != 1 or cin != width:
                blk["down_conv"] = _init_conv(gen, cin, width, 1, bias=False, device=device)
                blk["down_bn"] = _init_bn(width, device)
            blocks.append(blk)
            cin = width
        params["layers"].append(blocks)
    return params


def resnet18_features(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] -> layer4 features [B, H/32, W/32, 512]."""
    h = x.permute(0, 3, 1, 2)
    h = F.relu(_bn_eval(params["bn1"], _conv(params["conv1"], h, stride=2, padding=3)))
    h = F.max_pool2d(h, 3, 2, 1)
    for stage, (_, stride) in zip(params["layers"], _RESNET18_STAGES):
        for b, blk in enumerate(stage):
            s = stride if b == 0 else 1
            o = F.relu(_bn_eval(blk["bn1"], _conv(blk["conv1"], h, stride=s, padding=1)))
            o = _bn_eval(blk["bn2"], _conv(blk["conv2"], o, padding=1))
            idn = _bn_eval(blk["down_bn"], _conv(blk["down_conv"], h, stride=s)) \
                if "down_conv" in blk else h
            h = F.relu(o + idn)
    return h.permute(0, 2, 3, 1)


def face_normals_features(params: Dict[str, Any], x_pm1: torch.Tensor) -> torch.Tensor:
    """Resize to 256, map to [0, 1], ResNet18 layer4 -> [B, 8, 8, 512]."""
    x = resize(x_pm1.float(), (256, 256), "linear")
    return resnet18_features(params, x * 0.5 + 0.5)


def convert_resnet18(sd: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A torchvision resnet18 state dict (optionally under ``prefix``, e.g.
    the face-normals checkpoint's base model) -> the port's tree."""

    def t(name):
        return torch.as_tensor(sd[prefix + name]).detach().float().clone()

    def bn(name):
        return {"weight": t(f"{name}.weight"), "bias": t(f"{name}.bias"),
                "mean": t(f"{name}.running_mean"), "var": t(f"{name}.running_var")}

    params = {"conv1": {"weight": t("conv1.weight")}, "bn1": bn("bn1"), "layers": []}
    for li in range(1, 5):
        blocks = []
        for b in range(2):
            base = f"layer{li}.{b}"
            blk = {"conv1": {"weight": t(f"{base}.conv1.weight")}, "bn1": bn(f"{base}.bn1"),
                   "conv2": {"weight": t(f"{base}.conv2.weight")}, "bn2": bn(f"{base}.bn2")}
            if f"{prefix}{base}.downsample.0.weight" in sd:
                blk["down_conv"] = {"weight": t(f"{base}.downsample.0.weight")}
                blk["down_bn"] = bn(f"{base}.downsample.1")
            blocks.append(blk)
        params["layers"].append(blocks)
    return params


# ---------------------------------------------------------------------------
# CelebA parsing UNet encoder
# ---------------------------------------------------------------------------

_PARSING_FILTERS = [16, 32, 64, 128, 256]  # [64, 128, 256, 512, 1024] / feature_scale 4


def init_parsing_unet(gen: torch.Generator, *, device=None) -> Dict[str, Any]:
    stages: List[Dict[str, Any]] = []
    cin = 3
    for width in _PARSING_FILTERS:
        stages.append({"conv1": _init_conv(gen, cin, width, 3, device=device),
                       "bn1": _init_bn(width, device),
                       "conv2": _init_conv(gen, width, width, 3, device=device),
                       "bn2": _init_bn(width, device)})
        cin = width
    return {"stages": stages}


def parsing_unet_center(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Four conv-bn-relu x2 + max-pool stages, then the centre block:
    [B, H, W, 3] -> [B, H/16, W/16, 256]."""
    h = x.permute(0, 3, 1, 2)
    n = len(params["stages"])
    for i, st in enumerate(params["stages"]):
        h = F.relu(_bn_eval(st["bn1"], _conv(st["conv1"], h, padding=1)))
        h = F.relu(_bn_eval(st["bn2"], _conv(st["conv2"], h, padding=1)))
        if i < n - 1:
            h = F.max_pool2d(h, 2, 2)
    return h.permute(0, 2, 3, 1)


def face_seg_features(params: Dict[str, Any], x_pm1: torch.Tensor) -> torch.Tensor:
    """Resize to 256 (input stays in [-1, 1]), centre features, 2x2 average
    pool -> [B, 8, 8, 256]."""
    h = parsing_unet_center(params, resize(x_pm1.float(), (256, 256), "linear"))
    return F.avg_pool2d(h.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def convert_parsing_unet(sd: Dict[str, Any]) -> Dict[str, Any]:
    """A CelebA parsing checkpoint (convN.convM.K / center.convM.K, K 0 =
    conv, 1 = bn inside each Sequential) -> the encoder's tree."""

    def t(name):
        return torch.as_tensor(sd[name]).detach().float().clone()

    def pair(mod):
        out = {}
        for j in (1, 2):
            out[f"conv{j}"] = {"weight": t(f"{mod}.conv{j}.0.weight"),
                               "bias": t(f"{mod}.conv{j}.0.bias")}
            out[f"bn{j}"] = {"weight": t(f"{mod}.conv{j}.1.weight"),
                             "bias": t(f"{mod}.conv{j}.1.bias"),
                             "mean": t(f"{mod}.conv{j}.1.running_mean"),
                             "var": t(f"{mod}.conv{j}.1.running_var")}
        return out

    return {"stages": [pair(f"conv{i}") for i in range(1, 5)] + [pair("center")]}
