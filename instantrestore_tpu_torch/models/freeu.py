"""FreeU on the up-block skips (counterpart of
``instantrestore_tpu/models/freeu.py``). Its factors are the model's
(``RestorerStatics.freeu``): ``FreeUParams()`` holds SD 2.1's, which the
reference uses (s1=0.9, s2=0.2, b1=1.4, b2=1.6); diffusers' FreeU guide
gives SDXL's (s1=0.6, s2=0.4, b1=1.1, b2=1.2).

At up-block resolution index 0 (resp. 1) the first half of the backbone
channels is scaled by b1 (b2) and the skip's lowest Fourier bins are scaled
by s1 (s2). diffusers' ``fourier_filter(threshold=1)`` touches only the 2x2
lowest-frequency bins, so ``torch.fft`` of the skip, rescaled at those bins
and inverted, gives the same result as the JAX package's 4-bin projection.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from instantrestore_tpu_torch import device_constant


@dataclasses.dataclass(frozen=True)
class FreeUParams:
    s1: float = 0.9
    s2: float = 0.2
    b1: float = 1.4
    b2: float = 1.6


def lowfreq_component(x: torch.Tensor) -> torch.Tensor:
    """Real part of the inverse DFT of x [B, H, W, C] restricted to the
    frequencies {0, -1} x {0, -1}, in fp32."""
    xf = torch.fft.fft2(x.float(), dim=(1, 2))
    h, w = x.shape[1:3]

    def make():
        m = torch.zeros(h, w, 1)
        m[[0, 0, -1, -1], [0, -1, 0, -1]] = 1.0
        return m

    mask = device_constant(("freeu_lowfreq_mask", h, w), x.device, make)
    return torch.fft.ifft2(xf * mask, dim=(1, 2)).real


def fourier_filter(x: torch.Tensor, scale: float) -> torch.Tensor:
    """out = x + (scale - 1) * lowfreq_component(x), in fp32, cast back."""
    out = x.float() + (scale - 1.0) * lowfreq_component(x)
    return out.to(x.dtype)


def apply_freeu(
    resolution_idx: int,
    hidden: torch.Tensor,
    skip: torch.Tensor,
    freeu: Optional[FreeUParams],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale backbone half-channels and filter skip features (NHWC); only
    resolution indices 0 and 1 are touched."""
    if freeu is None or resolution_idx not in (0, 1):
        return hidden, skip
    b = freeu.b1 if resolution_idx == 0 else freeu.b2
    s = freeu.s1 if resolution_idx == 0 else freeu.s2
    half = hidden.shape[-1] // 2
    hidden = torch.cat([hidden[..., :half] * b, hidden[..., half:]], dim=-1)
    return hidden, fourier_filter(skip, s)
