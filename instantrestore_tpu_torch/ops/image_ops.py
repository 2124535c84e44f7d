"""On-device image ops (counterpart of ``instantrestore_tpu/ops/image_ops.py``):
serving preprocessing (resize the shorter side, center-crop, map [0, 1] ->
[-1, 1]) and the differentiable degradation chain of the cycle loss
(per-sample anisotropic blur, antialiased down-resize, noise, DCT JPEG,
resize back).

At the model resolution the resize is an identity and is skipped, as in the
JAX package. Off-size inputs are resampled as ``jax.image.resize(method=
"cubic", antialias=True)`` resamples them: separably, one fp32 weight matrix
per axis, built as JAX's ``compute_weight_mat`` builds it (Keys' cubic with
a = -0.5, stretched when downsampling, columns normalised, samples outside
the input zeroed). Both packages approximate the reference's PIL LANCZOS the
same way.

``jax.image.resize(method="linear")`` is resampled the same way with the
triangle kernel (``resize_weights(..., "linear")``), so the degradations and
the 112 px / 224 px resizes of the loss networks match JAX's, antialias
included. torch cannot replay ``jax.random``: the degradations take their
noise as an argument or draw it from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel (a = -0.5) at distances x >= 0."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x >= 2.0, torch.zeros_like(x), torch.where(x >= 1.0, far, near))


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return (1.0 - x).clamp_min(0.0)


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


def resize_weights(in_size: int, out_size: int, method: str = "cubic", device=None) -> torch.Tensor:
    """[in_size, out_size] fp32 weights of an antialiased resize along one
    axis (``method`` "cubic" or "linear"): output pixel j samples the input
    at (j + 0.5) / scale - 0.5 (half-pixel centres), with the kernel
    stretched by max(1 / scale, 1)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None])
    w = _KERNELS[method](x.abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def cubic_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    return resize_weights(in_size, out_size, "cubic", device)


def resize(images: torch.Tensor, size, method: str = "linear") -> torch.Tensor:
    """[B, H, W, C] -> [B, size[0], size[1], C], antialiased, as
    ``jax.image.resize(images, shape, method)`` (an axis whose size does not
    change is left as it is); computed in fp32, returned in the input dtype."""
    _, h, w, _ = images.shape
    nh, nw = size
    y = images.float()
    if nh != h:
        y = torch.einsum("bhwc,hH->bHwc", y, resize_weights(h, nh, method, y.device))
    if nw != w:
        y = torch.einsum("bhwc,wW->bhWc", y, resize_weights(w, nw, method, y.device))
    return y.to(images.dtype)


def resize_shorter_side(images: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W, C] -> shorter side == size, aspect preserved."""
    _, h, w, _ = images.shape
    if h <= w:
        nh, nw = size, max(1, int(round(w * size / h)))
    else:
        nh, nw = max(1, int(round(h * size / w))), size
    if (nh, nw) == (h, w):
        return images
    return resize(images, (nh, nw), "cubic")


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


# ---------------------------------------------------------------------------
# the differentiable degradation chain (cycle loss, demo slider)
# ---------------------------------------------------------------------------


def _depthwise(images: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """'same' depthwise conv of NHWC ``images`` with per-channel [C, k, k]
    kernels."""
    c, k = kern.shape[0], kern.shape[-1]
    y = F.conv2d(images.permute(0, 3, 1, 2), kern[:, None].to(images.dtype),
                 padding=k // 2, groups=c)
    return y.permute(0, 2, 3, 1)


def gaussian_blur(images: torch.Tensor, sigma_x: float, sigma_y: float,
                  rotation: float = 0.0, kernel_size: int = 41) -> torch.Tensor:
    """Anisotropic Gaussian blur of [B, H, W, C] with one kernel (built in
    numpy from Python floats, as the JAX package builds it)."""
    d = np.array([[sigma_x**2, 0.0], [0.0, sigma_y**2]])
    u = np.array([[np.cos(rotation), -np.sin(rotation)],
                  [np.sin(rotation), np.cos(rotation)]])
    sigma = u @ d @ u.T
    ax = np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    grid = np.stack([xx, yy], -1)
    k = np.exp(-0.5 * np.einsum("hwi,ij,hwj->hw", grid, np.linalg.inv(sigma), grid))
    k = torch.from_numpy((k / k.sum()).astype(np.float32)).to(images.device)
    return _depthwise(images, k.expand(images.shape[-1], kernel_size, kernel_size))


def aniso_kernels(sigma_x: torch.Tensor, sigma_y: torch.Tensor, rotation: torch.Tensor,
                  kernel_size: int = 41) -> torch.Tensor:
    """Per-sample rotated 2-D Gaussian kernels [B, k, k] from [B] parameters
    (sigma = U diag(sx^2, sy^2) U^T, inverted in closed form)."""
    sx2, sy2 = sigma_x.float().square(), sigma_y.float().square()
    rotation = rotation.float()
    c, s = torch.cos(rotation), torch.sin(rotation)
    a = c * c * sx2 + s * s * sy2
    b_ = c * s * (sx2 - sy2)
    d = s * s * sx2 + c * c * sy2
    det = a * d - b_ * b_
    ia, ib, id_ = d / det, -b_ / det, a / det
    ax = torch.arange(-(kernel_size // 2), kernel_size // 2 + 1, dtype=torch.float32,
                      device=sigma_x.device)
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")  # np.meshgrid(ax, ax)'s (xx, yy)
    quad = (ia[:, None, None] * xx.square() + 2.0 * ib[:, None, None] * xx * yy
            + id_[:, None, None] * yy.square())
    k = torch.exp(-0.5 * quad)
    return k / k.sum(dim=(1, 2), keepdim=True)


def gaussian_blur_per_sample(images: torch.Tensor, sigma_x: torch.Tensor, sigma_y: torch.Tensor,
                             rotation: torch.Tensor, kernel_size: int = 41) -> torch.Tensor:
    """Anisotropic blur with a different kernel per batch item: one grouped
    conv over the B*C channels of a batch folded into channels."""
    b, h, w, c = images.shape
    k = aniso_kernels(sigma_x, sigma_y, rotation, kernel_size)  # [B, k, k]
    x = images.permute(1, 2, 0, 3).reshape(1, h, w, b * c)
    y = _depthwise(x, k.repeat_interleave(c, dim=0))
    return y.reshape(h, w, b, c).permute(2, 0, 1, 3)


# the 12 downsample factors of the training degradation; sizes snapped to
# multiples of 16 so that the 8x8 DCT blocks and 4:2:0 subsampling tile exactly
CYCLE_FACTORS = tuple(range(1, 13))


def _snapped(n: int, f: int) -> int:
    return max(16, (n // f) // 16 * 16)


def cycle_noise_shapes(b: int, h: int, w: int, c: int = 3):
    """The shape of each factor branch's noise in ``degrade_with_params``
    (factor f -> [B, h/f, w/f, C] snapped to multiples of 16), in
    ``CYCLE_FACTORS`` order."""
    return [(b, _snapped(h, f), _snapped(w, f), c) for f in CYCLE_FACTORS]


def degrade_with_params(images_01: torch.Tensor, params: dict, *,
                        noise: Optional[Sequence[torch.Tensor]] = None,
                        generator: Optional[torch.Generator] = None,
                        resolution: int = 512) -> torch.Tensor:
    """Re-degrade [B, H, W, 3] images in [0, 1] with each item's own
    parameters (``params``: [B] tensors blur_sigma_x / blur_sigma_y /
    blur_rotation, downsample_factor (int), noise_sigma (0-255 units),
    jpeg_quality): per-sample blur, then every one of the 12 factor branches
    batch-wide (antialiased linear down-resize, noise, DCT JPEG, linear
    resize to ``resolution``) and a per-item select.

    ``noise``: one standard-normal tensor per branch, shaped as
    ``cycle_noise_shapes`` gives (the tests inject JAX's
    ``normal(fold_in(rng, f))``); else drawn from ``generator``."""
    from instantrestore_tpu_torch.ops.dct_jpeg import jpeg_compress_dct_traced

    x = gaussian_blur_per_sample(images_01, params["blur_sigma_x"], params["blur_sigma_y"],
                                 params["blur_rotation"])
    b, h, w, c = x.shape
    dev = x.device
    factor = torch.as_tensor(params["downsample_factor"], device=dev).long()
    sigma = torch.as_tensor(params["noise_sigma"], device=dev).float() / 255.0
    quality = torch.as_tensor(params["jpeg_quality"], device=dev)
    shapes = cycle_noise_shapes(b, h, w, c)
    if noise is None:
        if generator is None:
            raise ValueError("degrade_with_params needs noise= or a torch.Generator")
        noise = [torch.randn(s, generator=generator, device=generator.device).to(dev)
                 for s in shapes]
    out = torch.zeros_like(x)
    for f, z, shape in zip(CYCLE_FACTORS, noise, shapes):
        y = resize(x, shape[1:3], "linear")
        y = (y + z.to(y) * sigma[:, None, None, None].to(y.dtype)).clamp(0.0, 1.0)
        y = jpeg_compress_dct_traced(y, quality)
        y = resize(y, (resolution, resolution), "linear")
        sel = (factor == f)[:, None, None, None]
        out = torch.where(sel, y.clamp(0.0, 1.0).to(out.dtype), out)
    return out


def degrade_on_device(images_01: torch.Tensor, *, noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      severity: Optional[float] = None, resolution: int = 512) -> torch.Tensor:
    """Degradation of [B, H, W, 3] images in [0, 1] at one severity in [0, 1]
    (0.5 when None): blur, antialiased down-resize (sizes snapped to
    multiples of 16), noise (``noise`` [B, h, w, C] standard normal at the
    down-resized size, else drawn from ``generator``), DCT JPEG, linear
    resize to ``resolution``."""
    from instantrestore_tpu_torch.ops.dct_jpeg import jpeg_compress_dct

    s = 0.5 if severity is None else float(np.clip(severity, 0.0, 1.0))
    sigma = 0.1 + s * 11.9
    factor = max(1, int(round(1 + s * 11)))
    noise_sigma = (10.0 + s * 10.0) / 255.0
    quality = int(round(19 - s * 9))

    x = gaussian_blur(images_01, sigma, sigma)
    b, h, w, c = x.shape
    x = resize(x, (_snapped(h, factor), _snapped(w, factor)), "linear")
    if noise is None:
        if generator is None:
            raise ValueError("degrade_on_device needs noise= or a torch.Generator")
        noise = torch.randn(x.shape, generator=generator, device=generator.device)
    x = (x + noise.to(x) * noise_sigma).clamp(0.0, 1.0)
    x = jpeg_compress_dct(x, quality)
    x = resize(x, (resolution, resolution), "linear")
    return x.clamp(0.0, 1.0)
