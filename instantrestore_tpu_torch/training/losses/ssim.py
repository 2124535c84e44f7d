"""SSIM and MS-SSIM with pytorch_msssim's semantics (counterpart of
``instantrestore_tpu/training/losses/ssim.py``): separable 11-tap Gaussian
window (sigma 1.5), K1 = 0.01, K2 = 0.03, valid padding, per channel then
averaged; MS-SSIM with the canonical 5 weights, 2x average-pool between
scales and ReLU on the contrast-structure terms. NHWC images, fp32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from instantrestore_tpu_torch import device_constant

MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    coords = np.arange(size) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return device_constant(("ssim_window", size, sigma), device,
                           lambda: torch.from_numpy((g / g.sum()).astype(np.float32)))


def _filter2d_separable(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Depthwise separable valid-padding blur over NCHW."""
    c = x.shape[1]
    x = F.conv2d(x, win.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(x, win.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


def _ssim_terms(x, y, win, data_range, k1=0.01, k2=0.03):
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x = _filter2d_separable(x, win)
    mu_y = _filter2d_separable(y, win)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = _filter2d_separable(x * x, win) - mu_xx
    sigma_y = _filter2d_separable(y * y, win) - mu_yy
    sigma_xy = _filter2d_separable(x * y, win) - mu_xy
    cs = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    ssim_map = ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    return ssim_map, cs


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.float().permute(0, 3, 1, 2)


def ssim(x: torch.Tensor, y: torch.Tensor, *, data_range: float = 1.0, win_size: int = 11,
         win_sigma: float = 1.5, reduce: bool = True) -> torch.Tensor:
    """SSIM over NHWC images: batch-mean scalar, or per-sample [B] with
    ``reduce=False``."""
    win = _gaussian_window(win_size, win_sigma, x.device)
    s, _ = _ssim_terms(_nchw(x), _nchw(y), win, data_range)
    return s.mean() if reduce else s.mean(dim=(1, 2, 3))


def ms_ssim(x: torch.Tensor, y: torch.Tensor, *, data_range: float = 1.0,
            weights: Sequence[float] = MS_WEIGHTS, win_size: int = 11,
            win_sigma: float = 1.5) -> torch.Tensor:
    """Multi-scale SSIM over NHWC images (scalar, batch mean)."""
    win = _gaussian_window(win_size, win_sigma, x.device)
    x, y = _nchw(x), _nchw(y)
    levels = len(weights)
    min_side = min(x.shape[2], x.shape[3])
    if min_side <= (win_size - 1) * 2 ** (levels - 1):
        raise ValueError(
            f"image side {min_side} too small for {levels}-level MS-SSIM with window "
            f"{win_size} (needs > {(win_size - 1) * 2 ** (levels - 1)})")
    mcs = []
    for i in range(levels):
        s, cs = _ssim_terms(x, y, win, data_range)
        if i < levels - 1:
            mcs.append(F.relu(cs.mean(dim=(1, 2, 3))))
            pad = (0, x.shape[3] % 2, 0, x.shape[2] % 2)
            x = F.avg_pool2d(F.pad(x, pad), 2)
            y = F.avg_pool2d(F.pad(y, pad), 2)
    vals = torch.stack(mcs + [F.relu(s.mean(dim=(1, 2, 3)))], dim=0)  # [levels, B]
    w = device_constant(("ms_ssim_weights", tuple(weights)), x.device,
                        lambda: torch.tensor(weights, dtype=torch.float32))
    return torch.prod(vals ** w[:, None], dim=0).mean()
