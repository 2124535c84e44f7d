"""Host-side image transforms of inference (counterpart of the inference part
of ``instantrestore_tpu/data/transforms.py``): LANCZOS resize of the shorter
side, center crop, [0, 1] float, normalize to [-1, 1]. Outputs are float32
numpy HWC.

PIL is imported inside the functions that need it, so the module imports
without Pillow.
"""

from __future__ import annotations

import numpy as np


def resize_shorter_side(img, size: int, resample=None):
    """torchvision Resize(size) semantics on a PIL image: shorter side ->
    size, LANCZOS unless ``resample`` says otherwise."""
    if resample is None:
        from PIL import Image

        resample = Image.LANCZOS
    w, h = img.size
    if w <= h:
        nw, nh = size, max(1, int(round(h * size / w)))
    else:
        nw, nh = max(1, int(round(w * size / h))), size
    return img.resize((nw, nh), resample)


def center_crop(img, size: int):
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def to_float01(img) -> np.ndarray:
    return np.asarray(img.convert("RGB"), np.float32) / 255.0


def normalize_pm1(x: np.ndarray) -> np.ndarray:
    """Normalize(0.5, 0.5): [0, 1] -> [-1, 1]."""
    return x * 2.0 - 1.0


def denormalize_pm1(x: np.ndarray) -> np.ndarray:
    return np.clip((x + 1.0) / 2.0, 0.0, 1.0)


def infer_transform(img, resolution: int = 512) -> np.ndarray:
    """Predictor preprocessing: LANCZOS resize, center crop, [0, 1],
    normalize to [-1, 1]. Returns HWC float32."""
    img = center_crop(resize_shorter_side(img, resolution), resolution)
    return normalize_pm1(to_float01(img))
