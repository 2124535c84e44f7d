"""Datasets: identity-folder face-restoration data on the host, numpy NHWC
(counterpart of ``instantrestore_tpu/data/datasets.py``).

* ``RestoreDataset``: training, ``<root>/<identity>/cropped_images/*``;
  paired transforms, the degradation chain on the fly, 1..N references of
  the same identity padded to N, and optionally landmark-attention targets,
  positive / negative reference swaps, facial-component masks and boxes,
  ArcFace alignment matrices and the degradation parameters.
* ``RestoreDatasetTest``: validation, ``<root>/<identity>/{degraded.png,
  gt.png, conditioning/*}``, references padded with flipped duplicates.
* ``PairedDataset``: the debug dataset over ``<identity>/canonical_images``.
* ``collate``: stacks items to the batch schema; ``to_torch_batch`` moves
  the keys a train or eval step reads onto a device.

Batch schema (numpy float32, NHWC, images in [-1, 1]): image [B, R, R, 3],
gt [B, R, R, 3], conditioning_images [B, N, R, R, 3], valid_indices [B]
int32, and the optional training extras.

An item is a function of (seed, index, file name) alone: its
``random.Random`` is seeded with ``(hash((seed, idx)) ^ crc32(name)) &
0x7FFFFFFF`` (a tuple of ints hashes the same in every process), so runs,
resumes and processes see the same items. PIL is imported inside the
functions that open images, so the module imports without Pillow.
"""

from __future__ import annotations

import random
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from instantrestore_tpu_torch.data import degradations as deg
from instantrestore_tpu_torch.data.transforms import (
    PairedTestTransform,
    PairedTrainTransform,
    infer_transform,
    normalize_pm1,
    to_float01,
)
from instantrestore_tpu_torch.training.losses.composite import facial_comp_sizes

IMAGE_SUFFIXES = (".jpg", ".png", ".jpeg")

# (heads, spatial size) of SD-Turbo's 9 shared self-attention layers in
# traversal order at 512 px
SHARED_LAYER_STATS = [(20, 16)] * 3 + [(10, 32)] * 3 + [(5, 64)] * 3

PROMPT = "A high-quality photo of a person; professional, 8k"

# (dx, dy) from a landmark to its facial-component window's origin, at 512 px
# (the windows' sizes are ``facial_comp_sizes``)
FACIAL_COMP_OFFSETS = ((50, 50), (50, 50), (80, 30))

# the keys a train or eval step reads (``to_torch_batch``)
DEVICE_KEYS = ("image", "gt", "conditioning_images", "valid_indices", "pos_reg_idx",
               "neg_reg_idx", "facial_comps", "facial_comp_boxes", "degradation_params",
               "id_mats_pred", "id_mats_target", "id_valid")


def _open_rgb(path):
    from PIL import Image

    return Image.open(path).convert("RGB")


def build_landmark_target(gt_lm, cond_lm, layer: int, resolution: int):
    """The Gaussian-splatted landmark-correspondence map at one shared
    layer: for each landmark inside the layer's grid, a Gaussian (sigma =
    size / 32) around the reference's landmark in the query row of the
    input's. Returns (attn [heads, q, q] float32, mask [q] bool)."""
    heads, size = SHARED_LAYER_STATS[layer]
    factor = resolution // size
    sigma = 0.03125 * size
    xs = np.arange(size)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    attn = np.zeros((size * size, size * size), np.float32)
    mask = np.zeros(size * size, bool)
    for (x_up, y_up), (cx_up, cy_up) in zip(gt_lm, cond_lm):
        x, y = int(x_up) // factor, int(y_up) // factor
        cx, cy = int(cx_up) // factor, int(cy_up) // factor
        if x >= size or y >= size or cx >= size or cy >= size:
            continue
        pos = y * size + x
        g = np.exp(-((gx - cx) ** 2 + (gy - cy) ** 2) / (2 * sigma ** 2))
        attn[pos] += g.reshape(-1)
        mask[pos] = True
    return attn[None].repeat(heads, 0), mask


class CoachDataset:
    """Base dataset: an ordered path list, its shuffle and its length."""

    def __init__(self):
        self.paths: List[Path] = []

    def __len__(self):
        return len(self.paths)

    def shuffle(self, seed: Optional[int] = None):
        random.Random(seed).shuffle(self.paths)


class PathsDataset(CoachDataset):
    """Images of a path list through the inference transform."""

    def __init__(self, image_paths: Sequence, resolution: int = 512):
        super().__init__()
        self.paths = [Path(p) for p in image_paths]
        self.resolution = resolution

    def __getitem__(self, idx):
        from PIL import Image

        return infer_transform(Image.open(self.paths[idx]), self.resolution)


def _images_in(folder: Path) -> List[Path]:
    return [p for p in sorted(folder.glob("*")) if p.suffix.lower() in IMAGE_SUFFIXES]


class RestoreDataset(CoachDataset):
    def __init__(
        self,
        dataset_folder,
        identity_names: Optional[Sequence[str]] = None,
        max_conditioning_images: int = 4,
        resolution: int = 512,
        train_input: bool = True,
        get_gt_attn_probs: bool = False,
        get_attn_pos_reg: bool = False,
        get_attn_neg_reg: bool = False,
        get_facial_comps: bool = False,
        get_id_mats: bool = False,
        return_degradation_params: bool = False,
        seed: int = 0,
    ):
        super().__init__()
        folders = dataset_folder if isinstance(dataset_folder, (list, tuple)) else [dataset_folder]
        self.resolution = resolution
        self.max_cond = max_conditioning_images
        self.train_input = train_input
        self.get_gt_attn_probs = get_gt_attn_probs
        self.get_attn_pos_reg = get_attn_pos_reg
        self.get_attn_neg_reg = get_attn_neg_reg
        self.get_facial_comps = get_facial_comps
        self.get_id_mats = get_id_mats
        self.return_degradation_params = return_degradation_params
        self.joined = PairedTrainTransform(resolution)
        self._seed = seed

        self.identity_dirs: List[Path] = []
        for folder in folders:
            for identity in sorted(Path(folder).glob("*")):
                if not identity.is_dir():
                    continue
                if len(list((identity / "cropped_images").glob("*"))) <= 1:
                    continue
                if get_gt_attn_probs and len(list(identity.glob("new_landmarks/*"))) <= 1:
                    continue
                self.identity_dirs.append(identity)
        self.paths = [p for identity in self.identity_dirs
                      for p in _images_in(identity / "cropped_images")]

    def _sample_refs(self, identity_dir: Path, target: Path, rng: random.Random):
        """1..N other images of the identity, padded to N by cyclic
        duplication -> (images, paths, number drawn)."""
        pool = [p for p in _images_in(identity_dir / "cropped_images") if p != target]
        n = min(len(pool), rng.randint(1, self.max_cond))
        chosen = rng.sample(pool, n)
        images = [_open_rgb(p) for p in chosen]
        full_images, full_paths = list(images), list(chosen)
        for i in range(self.max_cond - len(images)):
            full_images.append(images[i % len(images)])
            full_paths.append(chosen[i % len(images)])
        return full_images, full_paths, n

    def _landmarks(self, identity_dir: Path, image_path: Path) -> Optional[np.ndarray]:
        f = identity_dir / "new_landmarks" / (image_path.stem + ".npy")
        return np.load(f) if f.exists() else None

    def _gt_attn_probs(self, identity_dir, image_path, cond_paths, layer, cond):
        gt_lm = self._landmarks(identity_dir, image_path)
        if gt_lm is None:
            return None
        if self.train_input and cond == 0:
            cond_lm = gt_lm
        else:
            cond_lm = self._landmarks(identity_dir,
                                      cond_paths[cond - 1 if self.train_input else cond])
            if cond_lm is None:
                return None
        attn, mask = build_landmark_target(gt_lm, cond_lm, layer, self.resolution)
        return attn, mask, layer, cond, gt_lm, cond_lm

    def _facial_comps(self, identity_dir, image_path):
        """(masks, boxes): three [R, R] bool rectangles around the eyes and
        the mouth (the masked L2 / LPIPS terms) and [3, 2] int32 (y0, x0)
        origins of the fixed-size windows of ``facial_comp_sizes`` (the
        adversarial crops), shifted inward at the borders."""
        lm = self._landmarks(identity_dir, image_path)
        if lm is None:
            return None
        res = self.resolution

        def rect(cx, cy, dx0, dy0, dx1, dy1):
            m = np.zeros((res, res), bool)
            x0, x1 = np.clip([cx + dx0, cx + dx1], 0, res)
            y0, y1 = np.clip([cy + dy0, cy + dy1], 0, res)
            m[y0:y1, x0:x1] = True
            return m

        s = res / 512.0
        lx, ly = int(lm[626][0]), int(lm[626][1])
        rx, ry = int(lm[590][0]), int(lm[590][1])
        mx, my = int(lm[0][0]), int(lm[0][1])
        masks = (
            rect(lx, ly, -int(50 * s), -int(50 * s), int(51 * s), int(21 * s)),
            rect(rx, ry, -int(50 * s), -int(50 * s), int(51 * s), int(21 * s)),
            rect(mx, my, -int(80 * s), -int(30 * s), int(81 * s), int(61 * s)),
        )
        boxes = np.zeros((3, 2), np.int32)
        for i, ((cx, cy), (ox, oy), (hh, ww)) in enumerate(
                zip(((lx, ly), (rx, ry), (mx, my)), FACIAL_COMP_OFFSETS, facial_comp_sizes(res))):
            boxes[i, 0] = np.clip(cy - int(round(oy * s)), 0, res - hh)
            boxes[i, 1] = np.clip(cx - int(round(ox * s)), 0, res - ww)
        return masks, boxes

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        from instantrestore_tpu_torch.training.losses.id_loss import (
            ARCFACE_REFERENCE_POINTS_3,
            alignment_transforms,
        )

        path = self.paths[idx]
        identity_dir = path.parent.parent
        # crc32, not hash(), of the name: str hashes differ between processes
        stable = zlib.crc32(path.name.encode("utf-8"))
        rng = random.Random((hash((self._seed, idx)) ^ stable) & 0x7FFFFFFF)
        nprng = np.random.default_rng(rng.randint(0, 2**31 - 1))

        img = _open_rgb(path)
        inp, out = self.joined(img, img.copy(), rng)

        params = deg.sample_degradation_params(nprng)
        degraded = deg.degrade(to_float01(inp), params, resolution=self.resolution)

        refs, ref_paths, n_valid = self._sample_refs(identity_dir, path, rng)

        pos_idx = -1
        if self.get_attn_pos_reg and rng.random() < 0.25:
            pos_idx = rng.randint(0, len(refs) - 1)
            refs[pos_idx] = _open_rgb(path)
        neg_idx = -1
        if self.get_attn_neg_reg and rng.random() < 0.25:
            other = rng.randrange(len(self.identity_dirs))
            if self.identity_dirs[other] == identity_dir:
                other = len(self.identity_dirs) - 1 - other
            neg_pool = _images_in(self.identity_dirs[other] / "cropped_images")
            neg_idx = rng.randint(0, len(refs) - 1)
            if neg_idx == pos_idx:
                neg_idx = len(refs) - 1 - pos_idx
            refs[neg_idx] = _open_rgb(rng.choice(neg_pool))

        cond = np.stack([infer_transform(r, self.resolution) for r in refs])
        item: Dict[str, Any] = {
            "image": normalize_pm1(degraded).astype(np.float32),
            "gt": normalize_pm1(to_float01(out)).astype(np.float32),
            "conditioning_images": cond.astype(np.float32),
            "valid_indices": np.int32(n_valid),
            "caption": PROMPT,
            "pos_reg_idx": np.int32(pos_idx),
            "neg_reg_idx": np.int32(neg_idx),
        }
        if self.return_degradation_params:
            item["degradation_params"] = params
        if self.get_gt_attn_probs:
            layer = rng.randint(0, 8)
            chosen_cond = rng.randint(0, self.max_cond if self.train_input else self.max_cond - 1)
            item["gt_attn_probs"] = self._gt_attn_probs(identity_dir, path, ref_paths, layer,
                                                        chosen_cond)
        if self.get_facial_comps:
            fc = self._facial_comps(identity_dir, path)
            if fc is not None:
                item["facial_comps"], item["facial_comp_boxes"] = fc
            else:
                item["facial_comps"] = None
        if self.get_id_mats:
            # the aligned-crop ID term: one 3-point (eyes, mouth centre)
            # similarity from the target's landmarks aligns prediction and
            # target alike, since they share their geometry
            lm = self._landmarks(identity_dir, path)
            pts = (np.stack([lm[626], lm[590], lm[0]]).astype(np.float32)
                   if lm is not None and len(lm) > 626 else None)
            mats, valid = alignment_transforms([pts], ref_points=ARCFACE_REFERENCE_POINTS_3)
            item["id_mat"] = mats[0]
            item["id_valid"] = bool(valid[0])
        return item


class RestoreDatasetTest(CoachDataset):
    """Validation layout ``<identity>/{degraded.png, gt.png, conditioning/*}``;
    the references padded with duplicates, every other one flipped."""

    def __init__(self, dataset_folder, max_conditioning_images: int = 4, resolution: int = 512):
        super().__init__()
        folders = dataset_folder if isinstance(dataset_folder, (list, tuple)) else [dataset_folder]
        self.resolution = resolution
        self.max_cond = max_conditioning_images
        self.joined = PairedTestTransform(resolution)
        self.paths = [identity for folder in folders for identity in sorted(Path(folder).glob("*"))
                      if identity.is_dir() and (identity / "degraded.png").exists()]

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        from PIL import Image

        identity = self.paths[idx]
        degraded = _open_rgb(identity / "degraded.png")
        gt_path = identity / "gt.png"
        gt = _open_rgb(gt_path) if gt_path.exists() else degraded
        degraded, gt = self.joined(degraded, gt)
        refs = [_open_rgb(p) for p in _images_in(identity / "conditioning")[: self.max_cond]]
        n_valid = len(refs)
        for i in range(self.max_cond - n_valid):
            src = refs[i % n_valid]
            refs.append(src.transpose(Image.Transpose.FLIP_LEFT_RIGHT) if i % 2 == 0
                        else src.copy())
        cond = np.stack([infer_transform(r, self.resolution) for r in refs])
        return {
            "image": normalize_pm1(to_float01(degraded)).astype(np.float32),
            "gt": normalize_pm1(to_float01(gt)).astype(np.float32),
            "conditioning_images": cond.astype(np.float32),
            "valid_indices": np.int32(n_valid),
            "caption": PROMPT,
            "identity": identity.name,
        }


def collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a list of items to the batch schema. Landmark targets of a
    batch share one layer, item 0's: an item whose own layer differs is
    splatted again at it from its raw coordinates."""
    batch: Dict[str, Any] = {
        "image": np.stack([it["image"] for it in items]),
        "gt": np.stack([it["gt"] for it in items]),
        "conditioning_images": np.stack([it["conditioning_images"] for it in items]),
        "valid_indices": np.asarray([it["valid_indices"] for it in items], np.int32),
        "caption": [it["caption"] for it in items],
    }
    if "pos_reg_idx" in items[0]:
        batch["pos_reg_idx"] = np.asarray([it["pos_reg_idx"] for it in items], np.int32)
        batch["neg_reg_idx"] = np.asarray([it["neg_reg_idx"] for it in items], np.int32)
    if items[0].get("gt_attn_probs") is not None:
        entries = [it.get("gt_attn_probs") for it in items]
        if all(e is not None for e in entries):
            layer = int(entries[0][2])
            resolution = items[0]["image"].shape[0]
            probs, masks, conds, coords = [], [], [], []
            for p, m, l, c, gt_lm, cond_lm in entries:
                if int(l) != layer:
                    p, m = build_landmark_target(gt_lm, cond_lm, layer, resolution)
                probs.append(p)
                masks.append(m)
                conds.append(c)
                coords.append((gt_lm, cond_lm))
            batch["gt_attn_probs"] = (
                np.stack(probs).astype(np.float32),  # [B, heads, q, q]
                np.stack(masks),                     # [B, q]
                layer,
                np.asarray(conds, np.int32),         # [B]
            )
            batch["landmark_coords"] = coords
    if items[0].get("facial_comps") is not None:
        comps = [it["facial_comps"] for it in items]
        if all(c is not None for c in comps):
            batch["facial_comps"] = tuple(np.stack([c[k] for c in comps]) for k in range(3))
            batch["facial_comp_boxes"] = np.stack([it["facial_comp_boxes"] for it in items])
    if "id_mat" in items[0]:
        mats = np.stack([it["id_mat"] for it in items]).astype(np.float32)
        batch["id_mats_pred"] = mats
        batch["id_mats_target"] = mats
        batch["id_valid"] = np.asarray([it["id_valid"] for it in items], bool)
    if "degradation_params" in items[0]:
        ps = [it["degradation_params"] for it in items]
        batch["degradation_params"] = {
            "blur_sigma_x": np.asarray([p.blur_sigma_x for p in ps], np.float32),
            "blur_sigma_y": np.asarray([p.blur_sigma_y for p in ps], np.float32),
            "blur_rotation": np.asarray([p.blur_rotation for p in ps], np.float32),
            "downsample_factor": np.asarray([p.downsample_factor for p in ps], np.int32),
            "noise_sigma": np.asarray([p.noise_sigma for p in ps], np.float32),
            "jpeg_quality": np.asarray([p.jpeg_quality for p in ps], np.int32),
        }
    if "identity" in items[0]:
        batch["identity"] = [it["identity"] for it in items]
    return batch


def to_torch_batch(batch: Dict[str, Any], device) -> Tuple[Dict[str, Any], Optional[int]]:
    """A collated batch -> (the keys a train or eval step reads as tensors on
    ``device``, the landmark layer or None). ``facial_comps`` becomes a list
    of tensors, ``degradation_params`` a dict of them, and the
    ``gt_attn_probs`` tuple the keys ``gt_attn_probs``, ``gt_attn_mask`` and
    ``gt_attn_cond``; the layer is returned as a host int."""
    def put(x):
        return torch.as_tensor(np.asarray(x)).to(device)

    dev: Dict[str, Any] = {}
    for k in DEVICE_KEYS:
        if k not in batch:
            continue
        v = batch[k]
        if isinstance(v, dict):
            dev[k] = {name: put(x) for name, x in v.items()}
        elif isinstance(v, (tuple, list)):
            dev[k] = [put(x) for x in v]
        else:
            dev[k] = put(v)
    landmark_layer = None
    if batch.get("gt_attn_probs") is not None:
        probs, masks, layer, conds = batch["gt_attn_probs"]
        landmark_layer = int(layer)
        dev["gt_attn_probs"] = put(np.asarray(probs, np.float32))
        dev["gt_attn_mask"] = put(np.asarray(masks, bool))
        dev["gt_attn_cond"] = put(np.asarray(conds, np.int32))
    return dev, landmark_layer


class PairedDataset(CoachDataset):
    """The debug dataset over ``<identity>/canonical_images/*``: (input,
    target) views of one image through the test transform, references drawn
    as ``RestoreDataset`` draws them, no degradation."""

    def __init__(self, dataset_folder, max_conditioning_images: int = 4, resolution: int = 512,
                 images_subdir: str = "canonical_images", seed: int = 0):
        super().__init__()
        folders = dataset_folder if isinstance(dataset_folder, (list, tuple)) else [dataset_folder]
        self.resolution = resolution
        self.max_cond = max_conditioning_images
        self.joined = PairedTestTransform(resolution)
        self._seed = seed
        self.identity_dirs = [(identity, images_subdir) for folder in folders
                              for identity in sorted(Path(folder).glob("*"))
                              if identity.is_dir()
                              and len(list((identity / images_subdir).glob("*"))) > 1]
        self.paths = [p for identity, sub in self.identity_dirs
                      for p in _images_in(identity / sub)]

    def __getitem__(self, idx: int):
        path = self.paths[idx]
        rng = random.Random(hash((self._seed, idx)) & 0x7FFFFFFF)
        img = _open_rgb(path)
        inp, out = self.joined(img, img.copy())
        pool = [p for p in _images_in(path.parent) if p != path]
        n = min(len(pool), rng.randint(1, self.max_cond))
        refs = [_open_rgb(p) for p in rng.sample(pool, n)]
        for i in range(self.max_cond - n):
            refs.append(refs[i % n])
        cond = np.stack([infer_transform(r, self.resolution) for r in refs])
        return {
            "image": normalize_pm1(to_float01(inp)).astype(np.float32),
            "gt": normalize_pm1(to_float01(out)).astype(np.float32),
            "conditioning_images": cond.astype(np.float32),
            "valid_indices": np.int32(n),
            "caption": PROMPT,
        }
