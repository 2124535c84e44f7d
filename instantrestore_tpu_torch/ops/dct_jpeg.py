"""Differentiable JPEG by 8x8 DCT quantisation (counterpart of
``instantrestore_tpu/ops/dct_jpeg.py``).

RGB -> YCbCr, 4:2:0 chroma subsampling (2x2 mean), blockwise orthonormal
DCT-II, quantisation by the Annex-K tables scaled to the quality with a
differentiable rounding (round(x) + (x - round(x))^3), then the inverse
chain. ``torch.round`` rounds half to even, as ``jnp.round`` does. Not
libjpeg: no entropy coding and a plain chroma filter, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from instantrestore_tpu_torch import device_constant

# the Annex-K quantisation tables
_LUMA_TABLE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.float32)

_CHROMA_TABLE = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], np.float32)


def _quality_scale(quality: int) -> float:
    quality = max(1, min(100, int(quality)))
    return 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality


def _scaled_table(table: np.ndarray, quality: int) -> np.ndarray:
    s = _quality_scale(quality)
    return np.clip(np.floor((table * s + 50.0) / 100.0), 1.0, 255.0).astype(np.float32)


def _dct_matrix() -> np.ndarray:
    """Orthonormal 8x8 DCT-II matrix."""
    n = 8
    m = np.zeros((n, n), np.float64)
    for k in range(n):
        for i in range(n):
            m[k, i] = np.cos(np.pi * k * (2 * i + 1) / (2 * n))
        m[k] *= np.sqrt(2.0 / n) * (np.sqrt(0.5) if k == 0 else 1.0)
    return m.astype(np.float32)


def _diff_round(x: torch.Tensor) -> torch.Tensor:
    r = torch.round(x)
    return r + (x - r) ** 3


def _scaled_table_traced(table: np.ndarray, quality: torch.Tensor) -> torch.Tensor:
    """Per-sample quantisation tables [B, 8, 8] from a quality tensor [B]."""
    q = quality.float().clamp(1.0, 100.0)
    s = torch.where(q < 50.0, 5000.0 / q, 200.0 - 2.0 * q)
    t = device_constant(("jpeg_table", table.tobytes()), q.device,
                        lambda: torch.from_numpy(table))[None] * s[:, None, None]
    return torch.floor((t + 50.0) / 100.0).clamp(1.0, 255.0)


def _channel_jpeg(x: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """x [B, H, W] centred at 0; tables [8, 8] or [B, 8, 8]."""
    b, h, w = x.shape
    d = device_constant("dct_matrix", x.device, lambda: torch.from_numpy(_dct_matrix()))
    blocks = x.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    coeffs = torch.einsum("ki,bnmij,lj->bnmkl", d, blocks, d)
    q = tables if tables.ndim == 2 else tables[:, None, None]
    coeffs = _diff_round(coeffs / q) * q
    blocks = torch.einsum("ik,bnmkl,jl->bnmij", d, coeffs, d)
    return blocks.permute(0, 1, 3, 2, 4).reshape(b, h, w)


def _jpeg(images_01: torch.Tensor, luma: torch.Tensor, chroma: torch.Tensor) -> torch.Tensor:
    x = images_01.float() * 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    def down(c):  # 4:2:0 by a 2x2 mean
        bsz, h, w = c.shape
        return c.reshape(bsz, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

    def up(c, h, w):
        return c.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)[:, :h, :w]

    h, w = y.shape[1:]
    y2 = _channel_jpeg(y - 128.0, luma) + 128.0
    cb2 = up(_channel_jpeg(down(cb) - 128.0, chroma) + 128.0, h, w)
    cr2 = up(_channel_jpeg(down(cr) - 128.0, chroma) + 128.0, h, w)

    r2 = y2 + 1.402 * (cr2 - 128.0)
    g2 = y2 - 0.344136 * (cb2 - 128.0) - 0.714136 * (cr2 - 128.0)
    b2 = y2 + 1.772 * (cb2 - 128.0)
    return (torch.stack([r2, g2, b2], dim=-1) / 255.0).clamp(0.0, 1.0)


def jpeg_compress_dct(images_01: torch.Tensor, quality: int) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> differentiable JPEG round trip (4:2:0) at
    one integer quality; fp32 out."""
    dev = images_01.device
    return _jpeg(images_01, torch.from_numpy(_scaled_table(_LUMA_TABLE, quality)).to(dev),
                 torch.from_numpy(_scaled_table(_CHROMA_TABLE, quality)).to(dev))


def jpeg_compress_dct_traced(images_01: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """As ``jpeg_compress_dct`` with a quality per sample (a [B] tensor)."""
    quality = torch.as_tensor(quality, device=images_01.device)
    return _jpeg(images_01, _scaled_table_traced(_LUMA_TABLE, quality),
                 _scaled_table_traced(_CHROMA_TABLE, quality))
