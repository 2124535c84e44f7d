"""Serving preprocessing (counterpart of ``instantrestore_tpu/ops/image_ops.py``
``preprocess``): resize the shorter side, center-crop, map [0, 1] -> [-1, 1].

At the model resolution the resize is an identity and is skipped, as in the
JAX package. Off-size inputs go through PyTorch's antialiased bicubic
resize, whose cubic kernel (a = -0.75) differs slightly from the JAX
package's (Keys, a = -0.5); both approximate the reference's PIL LANCZOS.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_shorter_side(images: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W, C] -> shorter side == size, aspect preserved."""
    _, h, w, _ = images.shape
    if h <= w:
        nh, nw = size, max(1, int(round(w * size / h)))
    else:
        nh, nw = max(1, int(round(h * size / w))), size
    if (nh, nw) == (h, w):
        return images
    y = F.interpolate(
        images.permute(0, 3, 1, 2), size=(nh, nw), mode="bicubic",
        align_corners=False, antialias=True,
    )
    return y.permute(0, 2, 3, 1)


def center_crop(images: torch.Tensor, size: int) -> torch.Tensor:
    _, h, w, _ = images.shape
    top = (h - size) // 2
    left = (w - size) // 2
    return images[:, top : top + size, left : left + size, :]


def preprocess(images_01: torch.Tensor, resolution: int = 512) -> torch.Tensor:
    """[0, 1] float images [B, H, W, 3] -> [-1, 1] at resolution x resolution."""
    x = resize_shorter_side(images_01, resolution)
    x = torch.clamp(center_crop(x, resolution), 0.0, 1.0)
    return x * 2.0 - 1.0
