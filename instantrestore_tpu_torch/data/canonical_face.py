"""Canonical face preprocessing (counterpart of
``instantrestore_tpu/data/canonical_face.py``): bbox expansion, square crop,
optional background masking and landmark remapping into the crop frame,
with a pluggable detector (``data.mtcnn.default_detector``) and segmenter.

Host-side numpy, copied. Pillow is imported only where an image is resized,
so that the detector runs on a machine without it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class FaceDetection:
    bbox: np.ndarray  # [4] x0, y0, x1, y1
    landmarks: Optional[np.ndarray] = None  # [K, 2]


Detector = Callable[[np.ndarray], Optional[FaceDetection]]
Segmenter = Callable[[np.ndarray], np.ndarray]  # HWC -> HW float mask


def expand_bbox(bbox: np.ndarray, scale: float, w: int, h: int) -> np.ndarray:
    """Symmetric bbox expansion, clipped to the image."""
    x0, y0, x1, y1 = bbox
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    half = max(x1 - x0, y1 - y0) * scale / 2
    return np.array(
        [max(0, cx - half), max(0, cy - half), min(w, cx + half), min(h, cy + half)]
    )


def square_crop(image: np.ndarray, bbox: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Crop the (expanded) bbox as a square; returns (crop, offset_xy)."""
    x0, y0, x1, y1 = bbox.astype(int)
    side = min(max(x1 - x0, y1 - y0), min(image.shape[0], image.shape[1]))
    cx, cy = (x0 + x1) // 2, (y0 + y1) // 2
    x0 = int(np.clip(cx - side // 2, 0, image.shape[1] - side))
    y0 = int(np.clip(cy - side // 2, 0, image.shape[0] - side))
    return image[y0 : y0 + side, x0 : x0 + side], np.array([x0, y0])


class CanonicalFaceProcess:
    def __init__(
        self,
        detector: Optional[Detector] = None,
        segmenter: Optional[Segmenter] = None,
        bbox_scale: float = 1.6,
        output_size: int = 512,
    ):
        self.detector = detector
        self.segmenter = segmenter
        self.bbox_scale = bbox_scale
        self.output_size = output_size

    def __call__(self, image):
        """PIL image -> dict(image=canonical PIL crop, landmarks | None,
        mask | None). Without a detector (or a detection) the centre square
        crop is used."""
        from PIL import Image

        arr = np.asarray(image.convert("RGB"))
        h, w = arr.shape[:2]
        det = self.detector(arr) if self.detector is not None else None
        if det is None:
            side = min(h, w)
            bbox = np.array([(w - side) / 2, (h - side) / 2,
                             (w + side) / 2, (h + side) / 2])
            landmarks = None
        else:
            bbox = expand_bbox(det.bbox, self.bbox_scale, w, h)
            landmarks = det.landmarks
        crop, offset = square_crop(arr, bbox)
        scale = self.output_size / crop.shape[0]
        out = Image.fromarray(crop).resize(
            (self.output_size, self.output_size), Image.LANCZOS
        )
        mask = None
        if self.segmenter is not None:
            m = self.segmenter(np.asarray(out))
            out_arr = np.asarray(out) * m[..., None] + 255 * (1 - m[..., None])
            out = Image.fromarray(out_arr.astype(np.uint8))
            mask = m
        if landmarks is not None:
            landmarks = (landmarks - offset[None]) * scale
        return {"image": out, "landmarks": landmarks, "mask": mask}
