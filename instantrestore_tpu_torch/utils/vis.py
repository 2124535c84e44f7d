"""Visualisation helpers (counterpart of ``instantrestore_tpu/utils/vis.py``):
``vis_data`` side-by-side batch grids and ``vis_attn_probs``, the attention
mass each reference receives in a shared layer, overlaid on the reference
images. Inputs are numpy arrays; PIL is imported inside the functions.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def to_uint8(img_pm1: np.ndarray) -> np.ndarray:
    return ((np.clip(img_pm1, -1, 1) + 1) / 2 * 255).astype(np.uint8)


def vis_data(input_img: np.ndarray, pred: np.ndarray, gt: np.ndarray,
             cond_images: Optional[np.ndarray] = None, max_rows: int = 4):
    """A row per sample: degraded | pred | gt | references... ([B, H, W, 3]
    each, the references [B, N, H, W, 3])."""
    from PIL import Image

    rows = []
    for i in range(min(max_rows, input_img.shape[0])):
        cells = [to_uint8(input_img[i]), to_uint8(pred[i]), to_uint8(gt[i])]
        if cond_images is not None:
            cells.extend(to_uint8(cond_images[i, j]) for j in range(cond_images.shape[1]))
        rows.append(np.concatenate(cells, axis=1))
    return Image.fromarray(np.concatenate(rows, axis=0))


def attention_heatmap(attn_probs: np.ndarray, segment: int, out_size: int = 512) -> np.ndarray:
    """The mean attention mass each key position of one segment receives in
    one shared layer ([B, heads, q, K]), normalised per sample and resized to
    the image: [B, out, out] in [0, 1]."""
    from PIL import Image

    b, h, q, k = attn_probs.shape
    size = int(np.sqrt(q))
    seg = attn_probs[:, :, :, segment * q:(segment + 1) * q]
    mass = seg.mean(axis=(1, 2)).reshape(b, size, size)
    mass = mass / (mass.max(axis=(1, 2), keepdims=True) + 1e-12)
    img = np.asarray([np.asarray(Image.fromarray((m * 255).astype(np.uint8))
                                 .resize((out_size, out_size))) for m in mass])
    return img.astype(np.float32) / 255.0


def vis_attn_probs(attn_probs: Sequence[np.ndarray], cond_images: np.ndarray,
                   train_input: bool = False, layer: int = -1, alpha: float = 0.6):
    """Each reference's received-attention heatmap of shared layer ``layer``
    blended in red over the reference image ([B, N, H, W, 3]); a row per
    sample."""
    from PIL import Image

    probs = np.asarray(attn_probs[layer], np.float32)
    b, n = cond_images.shape[:2]
    offset = 1 if train_input else 0
    rows = []
    for i in range(b):
        cells = []
        for j in range(n):
            heat = attention_heatmap(probs[i:i + 1], j + offset, out_size=cond_images.shape[2])[0]
            base = to_uint8(cond_images[i, j]).astype(np.float32)
            red = np.zeros_like(base)
            red[..., 0] = 255.0
            cells.append((base * (1 - alpha * heat[..., None])
                          + red * (alpha * heat[..., None])).astype(np.uint8))
        rows.append(np.concatenate(cells, axis=1))
    return Image.fromarray(np.concatenate(rows, axis=0))
