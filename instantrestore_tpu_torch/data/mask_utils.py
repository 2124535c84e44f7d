"""Mask augmentation utilities, host-side numpy and OpenCV (counterpart of
``instantrestore_tpu/data/mask_utils.py``).

Re-specification of the reference's missing-source ``data/mask_utils.py``:
jitter segmentation-mask boundaries for training-time augmentation —
extract mask contours, push each contour vertex outward/inward along its
outward normal by a smooth random amount, and redraw the filled mask.
OpenCV is imported inside the functions that call it, so the module imports
without it (the card's machine does not promise it).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

# distinct BGR-ish colors for landmark-group drawing
LANDMARK_COLORS = [
    (255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0),
    (255, 0, 255), (0, 255, 255), (255, 128, 0), (128, 0, 255),
]


def compute_outward_normals(vertices: np.ndarray) -> np.ndarray:
    """Unit outward normals of a closed 2-D contour [N, 2] (x, y order).

    Tangents via np.gradient along the contour; normals are the tangents
    rotated -90deg, then sign-fixed to point away from the centroid."""
    v = np.asarray(vertices, np.float64)
    tangents = np.gradient(v, axis=0)
    normals = np.stack([tangents[:, 1], -tangents[:, 0]], axis=1)
    norms = np.linalg.norm(normals, axis=1)[:, np.newaxis]
    normals = normals / np.maximum(norms, 1e-12)
    # orient outward (away from the centroid)
    center = v.mean(axis=0)
    outward = ((v - center) * normals).sum(axis=1) < 0
    normals[outward] *= -1.0
    return normals


def generate_smooth_shifts(
    length: int,
    min_shift: float,
    max_shift: float,
    smoothness_factor: int = 5,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Per-vertex random shift magnitudes, low-pass filtered along the
    contour (uniform noise convolved with a ones kernel, mode='same')."""
    rng = rng or np.random.default_rng()
    random_shifts = rng.uniform(min_shift, max_shift, size=length)
    # np.convolve(mode='same') returns max(len, k) values — clamp the kernel
    k = max(1, min(int(smoothness_factor), length))
    kernel = np.ones(k) / k
    return np.convolve(random_shifts, kernel, mode="same")


def shift_points_smoothly(
    vertices: np.ndarray,
    image_shape: Tuple[int, int],
    min_shift_percentage: float = -0.05,
    max_shift_percentage: float = 0.05,
    smoothness_factor: int = 7,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Shift each contour vertex along its outward normal by a smooth random
    fraction of the image size; clipped to the image bounds."""
    v = np.asarray(vertices, np.float64)
    h, w = image_shape[:2]
    base = float(min(h, w))
    normals = compute_outward_normals(v)
    shifts = generate_smooth_shifts(
        len(v), min_shift_percentage * base, max_shift_percentage * base,
        smoothness_factor, rng,
    )
    new_vertices = v + normals * shifts[:, np.newaxis]
    new_vertices[:, 0] = np.clip(new_vertices[:, 0], 0, w - 1)
    new_vertices[:, 1] = np.clip(new_vertices[:, 1], 0, h - 1)
    return new_vertices


def get_vertices(binary_image: np.ndarray, min_len: int = 8) -> List[np.ndarray]:
    """Contours of a binary mask as float vertex lists [N, 2] in (x, y)."""
    import cv2

    u8 = (np.asarray(binary_image) > 0).astype(np.uint8)
    contours, _ = cv2.findContours(u8, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
    return [
        c.reshape(-1, 2).astype(np.float64) for c in contours if len(c) >= min_len
    ]


def get_augmented_mask(
    mask_image: np.ndarray,
    min_shift_percentage: float = -0.05,
    max_shift_percentage: float = 0.05,
    smoothness_factor: int = 7,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Boundary-jittered version of a binary mask: extract contours, shift
    vertices smoothly along outward normals, redraw filled polygons."""
    import cv2

    mask = (np.asarray(mask_image) > 0).astype(np.uint8)
    verts = get_vertices(mask)
    if not verts:
        return mask.astype(bool)
    new_mask = np.zeros_like(mask)
    for v in verts:
        shifted = shift_points_smoothly(
            v, mask.shape, min_shift_percentage, max_shift_percentage,
            smoothness_factor, rng,
        )
        cv2.fillPoly(new_mask, [np.round(shifted).astype(np.int32)], 1)
    return new_mask.astype(bool)


def recolor_enclosed_regions(
    mask: np.ndarray,
    outer_value: int = 1,
    inner_value: int = 2,
    enclosure_threshold: float = 0.9,
    iterations: int = 2,
) -> np.ndarray:
    """Label regions of ``mask`` fully enclosed by ``outer_value`` pixels with
    ``inner_value`` (erode/dilate cleanup + contour fill, as in the bytecode's
    erode/dilate/findContours/drawContours sequence)."""
    import cv2

    m = np.asarray(mask).copy()
    outer = (m == outer_value).astype(np.uint8)
    kernel = np.ones((3, 3), np.uint8)
    cleaned = cv2.dilate(cv2.erode(outer, kernel, iterations=iterations),
                         kernel, iterations=iterations)
    contours, _ = cv2.findContours(cleaned, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    filled = np.zeros_like(cleaned)
    cv2.drawContours(filled, contours, -1, 1, thickness=cv2.FILLED)
    inner = (filled == 1) & (cleaned == 0)
    m[inner] = inner_value
    return m


def draw_landmarks_on_image(
    image: np.ndarray,
    landmarks: Sequence[Sequence[float]],
    reference_size: int = 512,
    landmark_size: int = 2,
) -> np.ndarray:
    """Draw colored landmark dots scaled to the image size (redraw_landmarks
    equivalent: circles via cv2, anti-aliased)."""
    import cv2

    out = np.ascontiguousarray(np.asarray(image).copy())
    h, w = out.shape[:2]
    scale_factor = min(h, w) / float(reference_size)
    r = max(1, int(round(landmark_size * scale_factor)))
    for i, (x, y) in enumerate(landmarks):
        center = (int(round(x * scale_factor)), int(round(y * scale_factor)))
        color = LANDMARK_COLORS[i % len(LANDMARK_COLORS)]
        cv2.circle(out, center, r, color, thickness=-1, lineType=cv2.LINE_AA)
    return out
