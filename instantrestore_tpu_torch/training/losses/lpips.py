"""LPIPS (v0.1, VGG16 trunk) (counterpart of
``instantrestore_tpu/training/losses/lpips.py``): fixed input scaling, VGG16
features after relu{1_2, 2_2, 3_3, 4_3, 5_3}, channel unit-normalisation,
squared difference, learned 1x1 linear heads, spatial average, sum over the
layers. fp32 throughout, NHWC images.

Weights come from torchvision's vgg16 state dict and the LPIPS linear-head
state dict through ``convert_lpips_params``, or from a JAX-layout tree through
``convert.from_jax_tree``. ``init_lpips_params`` gives random ones for smoke
runs and tests: the metric then means nothing but the graph is the same.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from instantrestore_tpu_torch import device_constant
from instantrestore_tpu_torch.ops.primitives import conv2d, init_conv2d

# VGG16 conv plan up to relu5_3: (out_channels, convs per stage)
VGG_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
LIN_CHANNELS = [64, 128, 256, 512, 512]

# lpips.LPIPS ScalingLayer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def init_lpips_params(gen: torch.Generator, *, device=None) -> Dict[str, Any]:
    """Random trunk and heads (heads ``|N(0, 1)| * 0.01``, non-negative as
    the trained ones are), fp32, drawn from ``gen``."""
    vgg: List[List[dict]] = []
    in_ch = 3
    for out_ch, n_convs in VGG_STAGES:
        stage = []
        for _ in range(n_convs):
            stage.append(init_conv2d(gen, in_ch, out_ch, 3, device=device))
            in_ch = out_ch
        vgg.append(stage)
    lins = [{"weight": torch.randn((1, c, 1, 1), generator=gen, device=device).abs() * 0.01}
            for c in LIN_CHANNELS]
    return {"vgg": vgg, "lins": lins}


def _vgg_features(params, x: torch.Tensor) -> List[torch.Tensor]:
    """Features after the last ReLU of each stage; 2x2 max-pool between stages."""
    feats = []
    for si, stage in enumerate(params["vgg"]):
        for conv in stage:
            x = F.relu(conv2d(conv, x))
        feats.append(x)
        if si < len(params["vgg"]) - 1:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    return feats


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (x.square().sum(dim=-1, keepdim=True).sqrt() + eps)


def lpips(params, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """img1/img2 [B, H, W, 3] in [-1, 1] -> per-sample LPIPS distance [B]."""
    shift = device_constant("lpips_shift", img1.device,
                            lambda: torch.tensor(_SHIFT, dtype=torch.float32))
    scale = device_constant("lpips_scale", img1.device,
                            lambda: torch.tensor(_SCALE, dtype=torch.float32))
    f1 = _vgg_features(params, (img1.float() - shift) / scale)
    f2 = _vgg_features(params, (img2.float() - shift) / scale)
    total = 0.0
    for a, b, lin in zip(f1, f2, params["lins"]):
        diff = (_unit_normalize(a) - _unit_normalize(b)) ** 2
        total = total + conv2d(lin, diff, padding=0).mean(dim=(1, 2, 3))
    return total


# torchvision vgg16 'features' indices of the conv layers per stage
_TV_CONV_IDX = [[0, 2], [5, 7], [10, 12, 14], [17, 19, 21], [24, 26, 28]]


def convert_lpips_params(vgg_sd: Dict[str, Any], lin_sd: Dict[str, Any]) -> Dict[str, Any]:
    """torchvision vgg16 state dict + LPIPS v0.1 linear state dict (keys
    ``lin0.model.1.weight`` or ``lins.0.model.1.weight``, [1, C, 1, 1]) ->
    params; both already hold PyTorch's OIHW layout."""

    def t(x):
        return torch.as_tensor(x).detach().float().clone()

    vgg = [[{"weight": t(vgg_sd[f"features.{ci}.weight"]), "bias": t(vgg_sd[f"features.{ci}.bias"])}
            for ci in conv_ids] for conv_ids in _TV_CONV_IDX]
    lins = []
    for i in range(5):
        key = f"lin{i}.model.1.weight"
        if key not in lin_sd:
            key = f"lins.{i}.model.1.weight"
        lins.append({"weight": t(lin_sd[key])})
    return {"vgg": vgg, "lins": lins}
