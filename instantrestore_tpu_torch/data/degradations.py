"""The training data's degradation chain, on the host (counterpart of
``instantrestore_tpu/data/degradations.py``): anisotropic Gaussian blur
(k=41, sigma_x/y ~ U[0.1, 12], random rotation) -> bilinear downsample by
U{1..12} -> Gaussian noise sigma ~ U[10, 20]/255 -> libjpeg at quality
U{10..19} -> bilinear upsample back to the resolution.

Every function takes and returns float32 numpy HWC images in [0, 1] and is
driven by an explicit ``np.random.Generator``, so the same generator gives
the same bits as the JAX package's copy. OpenCV is imported inside the
three functions that call it, so the module imports without it. The
on-device counterpart (the cycle term's re-degradation) is
``ops/image_ops.degrade_with_params``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DegradationParams:
    blur_sigma_x: float
    blur_sigma_y: float
    blur_rotation: float
    downsample_factor: int
    noise_sigma: float  # in [0, 255] units, as the reference
    jpeg_quality: int
    noise_seed: int


def sample_degradation_params(rng: np.random.Generator) -> DegradationParams:
    """The reference's distribution, with a random rotation of the blur
    kernel."""
    return DegradationParams(
        blur_sigma_x=float(rng.uniform(0.1, 12.0)),
        blur_sigma_y=float(rng.uniform(0.1, 12.0)),
        blur_rotation=float(rng.uniform(-np.pi, np.pi)),
        downsample_factor=int(rng.integers(1, 13)),
        noise_sigma=float(rng.uniform(10.0, 20.0)),
        jpeg_quality=int(rng.integers(10, 20)),
        noise_seed=int(rng.integers(0, 2**31 - 1)),
    )


def anisotropic_gaussian_kernel(kernel_size: int, sigma_x: float, sigma_y: float,
                                rotation: float) -> np.ndarray:
    """Rotated 2-D Gaussian kernel, normalised to sum 1."""
    d = np.array([[sigma_x**2, 0.0], [0.0, sigma_y**2]])
    u = np.array([[np.cos(rotation), -np.sin(rotation)], [np.sin(rotation), np.cos(rotation)]])
    sigma = u @ d @ u.T
    ax = np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    grid = np.stack([xx, yy], axis=-1)  # [k, k, 2]
    inv = np.linalg.inv(sigma)
    kernel = np.exp(-0.5 * np.einsum("hwi,ij,hwj->hw", grid, inv, grid))
    return (kernel / kernel.sum()).astype(np.float32)


def gaussian_blur(image: np.ndarray, params: DegradationParams, kernel_size: int = 41):
    import cv2

    kernel = anisotropic_gaussian_kernel(kernel_size, params.blur_sigma_x, params.blur_sigma_y,
                                         params.blur_rotation)
    return cv2.filter2D(image.astype(np.float32), -1, kernel)


def bilinear_resize(image: np.ndarray, size: int) -> np.ndarray:
    """(size, size): area interpolation down (the antialiased resize), bilinear up."""
    import cv2

    h, w = image.shape[:2]
    interp = cv2.INTER_AREA if size < min(h, w) else cv2.INTER_LINEAR
    return cv2.resize(image, (size, size), interpolation=interp)


def add_gaussian_noise(image: np.ndarray, sigma255: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    noisy = image + rng.standard_normal(image.shape).astype(np.float32) * (sigma255 / 255.0)
    return np.clip(noisy, 0.0, 1.0)


def jpeg_compress(image: np.ndarray, quality: int) -> np.ndarray:
    """A real libjpeg round trip at ``quality``, on [0, 1] float RGB."""
    import cv2

    u8 = np.clip(image * 255.0, 0, 255).astype(np.uint8)
    ok, enc = cv2.imencode(".jpg", cv2.cvtColor(u8, cv2.COLOR_RGB2BGR),
                           [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)])
    if not ok:
        raise RuntimeError("cv2.imencode failed")
    dec = cv2.imdecode(enc, cv2.IMREAD_COLOR)
    return cv2.cvtColor(dec, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


def degrade(image: np.ndarray, params: Optional[DegradationParams] = None,
            rng: Optional[np.random.Generator] = None, resolution: int = 512) -> np.ndarray:
    """The whole chain: blur -> downsample -> noise -> JPEG -> upsample."""
    if params is None:
        params = sample_degradation_params(rng or np.random.default_rng())
    x = gaussian_blur(image, params)
    x = bilinear_resize(x, resolution // params.downsample_factor)
    x = add_gaussian_noise(x, params.noise_sigma, params.noise_seed)
    x = jpeg_compress(x, params.jpeg_quality)
    x = bilinear_resize(x, resolution)
    return np.clip(x, 0.0, 1.0)


def degrade_at_severity(image: np.ndarray, severity: float, seed: int = 0,
                        resolution: int = 512) -> np.ndarray:
    """Deterministic degradation at ``severity`` in [0, 1] (the demo's slider)."""
    severity = float(np.clip(severity, 0.0, 1.0))
    params = DegradationParams(
        blur_sigma_x=0.1 + severity * 11.9,
        blur_sigma_y=0.1 + severity * 11.9,
        blur_rotation=0.0,
        downsample_factor=max(1, int(round(1 + severity * 11))),
        noise_sigma=10.0 + severity * 10.0,
        jpeg_quality=int(round(19 - severity * 9)),
        noise_seed=seed,
    )
    return degrade(image, params, resolution=resolution)
