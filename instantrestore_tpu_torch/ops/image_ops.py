"""Serving preprocessing (counterpart of ``instantrestore_tpu/ops/image_ops.py``
``preprocess``): resize the shorter side, center-crop, map [0, 1] -> [-1, 1].

At the model resolution the resize is an identity and is skipped, as in the
JAX package. Off-size inputs are resampled as ``jax.image.resize(method=
"cubic", antialias=True)`` resamples them: separably, one fp32 weight matrix
per axis, built as JAX's ``compute_weight_mat`` builds it (Keys' cubic with
a = -0.5, stretched when downsampling, columns normalised, samples outside
the input zeroed). Both packages approximate the reference's PIL LANCZOS the
same way.
"""

from __future__ import annotations

import torch


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel (a = -0.5) at distances x >= 0."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x >= 2.0, torch.zeros_like(x), torch.where(x >= 1.0, far, near))


def cubic_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """[in_size, out_size] fp32 weights of an antialiased cubic resize along
    one axis: output pixel j samples the input at (j + 0.5) / scale - 0.5
    (half-pixel centres), with the kernel stretched by max(1 / scale, 1)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None])
    w = _keys_cubic(x.abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_shorter_side(images: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W, C] -> shorter side == size, aspect preserved."""
    _, h, w, _ = images.shape
    if h <= w:
        nh, nw = size, max(1, int(round(w * size / h)))
    else:
        nh, nw = max(1, int(round(h * size / w))), size
    if (nh, nw) == (h, w):
        return images
    x = images.float()
    wh = cubic_weights(h, nh, device=x.device)
    ww = cubic_weights(w, nw, device=x.device)
    y = torch.einsum("bhwc,hH->bHwc", x, wh)
    y = torch.einsum("bHwc,wW->bHWc", y, ww)
    return y.to(images.dtype)


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
