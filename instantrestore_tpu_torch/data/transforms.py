"""Host-side image transforms (counterpart of
``instantrestore_tpu/data/transforms.py``).

Inference: LANCZOS resize of the shorter side, center crop, [0, 1] float,
normalize to [-1, 1]. Training, applied alike to an (input, target) pair:
resize and crop, grayscale with p = 0.1, a paired color jitter (brightness,
contrast, saturation 0.3 in a random order), an optional paired blur. The
random choices come from the caller's ``random.Random``, in the JAX
package's order, so the same seed gives the same images. Outputs are
float32 numpy HWC.

PIL is imported inside the functions that need it, so the module imports
without Pillow.
"""

from __future__ import annotations

import math
import random

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


class PairedColorJitter:
    """torchvision ColorJitter applied alike to a pair: brightness,
    contrast and saturation in a random order, each factor drawn from
    [max(0, 1 - v), 1 + v]."""

    def __init__(self, brightness=0.3, contrast=0.3, saturation=0.3):
        self.ranges = {
            0: (max(0.0, 1 - brightness), 1 + brightness),
            1: (max(0.0, 1 - contrast), 1 + contrast),
            2: (max(0.0, 1 - saturation), 1 + saturation),
        }

    def __call__(self, img1, img2, rng: random.Random):
        from PIL import ImageEnhance

        order = [0, 1, 2]
        rng.shuffle(order)
        enhancers = {0: ImageEnhance.Brightness, 1: ImageEnhance.Contrast, 2: ImageEnhance.Color}
        for fn_id in order:
            lo, hi = self.ranges[fn_id]
            f = rng.uniform(lo, hi)
            img1 = enhancers[fn_id](img1).enhance(f)
            img2 = enhancers[fn_id](img2).enhance(f)
        return img1, img2


class PairedRandomBlur:
    """With probability ``p``, one Gaussian or box blur of radius 1-5 on both."""

    def __init__(self, p: float = 0.4):
        self.p = p

    def __call__(self, img1, img2, rng: random.Random):
        from PIL import ImageFilter

        if rng.random() < self.p:
            radius = rng.randint(1, 5)
            filt = (ImageFilter.GaussianBlur(radius) if rng.random() < 0.5
                    else ImageFilter.BoxBlur(radius))
            img1, img2 = img1.filter(filt), img2.filter(filt)
        return img1, img2


class PairedTrainTransform:
    """The face_restore pair pipeline: resize and crop always, grayscale with
    probability ``grayscale_p``, the paired color jitter always."""

    def __init__(self, resolution: int = 512, grayscale_p: float = 0.1, color_jitter: bool = True):
        self.resolution = resolution
        self.grayscale_p = grayscale_p
        self.jitter = PairedColorJitter() if color_jitter else None

    def __call__(self, img1, img2, rng: random.Random):
        img1 = center_crop(resize_shorter_side(img1, self.resolution), self.resolution)
        img2 = center_crop(resize_shorter_side(img2, self.resolution), self.resolution)
        if rng.random() < self.grayscale_p:
            img1 = img1.convert("L").convert("RGB")
            img2 = img2.convert("L").convert("RGB")
        if self.jitter is not None:
            img1, img2 = self.jitter(img1, img2, rng)
        return img1, img2


class PairedTestTransform:
    """Resize and crop only."""

    def __init__(self, resolution: int = 512):
        self.resolution = resolution

    def __call__(self, img1, img2, rng=None):
        img1 = center_crop(resize_shorter_side(img1, self.resolution), self.resolution)
        img2 = center_crop(resize_shorter_side(img2, self.resolution), self.resolution)
        return img1, img2


def resize_large_axis(img, max_scale: float, resample=None):
    """Scale so that the larger side is ``max_scale`` (floor of each side),
    BICUBIC unless ``resample`` says otherwise."""
    if resample is None:
        from PIL import Image

        resample = Image.BICUBIC
    factor = float(max_scale) / max(img.size)
    return img.resize((int(math.floor(img.size[0] * factor)),
                       int(math.floor(img.size[1] * factor))), resample)
