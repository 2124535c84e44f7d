"""Identity loss: ArcFace IR-SE-50 cosine similarity on aligned face crops
(counterpart of ``instantrestore_tpu/training/losses/id_loss.py``).

1. 5-point landmarks -> least-squares similarity transform to the ArcFace
   template (matlab cp2tform semantics; host-side numpy, copied);
2. a differentiable 112x112 warp of the prediction (floor-based bilinear,
   zero outside), gradients flow to the generator;
3. the frozen IR-SE-50 embedding, loss = 1 - cos(pred, target) over the
   samples whose alignment is valid.

Parameters: the JAX tree's nesting with PyTorch layouts (OIHW conv
``weight``, dense ``weight`` [out, in], BatchNorm ``weight``/``bias``/
``mean``/``var``, PReLU ``alpha``); ``convert.from_jax_tree`` converts a JAX
tree, ``convert_arcface_params`` the reference's ``model_ir_se50.pth``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from instantrestore_tpu_torch.ops.image_ops import resize
from instantrestore_tpu_torch.ops.primitives import conv2d, dense

# the canonical 112x112 ArcFace template
ARCFACE_REFERENCE_POINTS = np.array(
    [
        [38.29459953, 51.69630051],
        [72.53179932, 51.50139999],
        [56.02519989, 71.73660278],
        [41.54930115, 92.3655014],
        [70.72990036, 92.20410156],
    ],
    np.float32,
)

# 3-point template (left eye, right eye, mouth centre) for datasets that carry
# eye and mouth landmarks only
ARCFACE_REFERENCE_POINTS_3 = np.stack(
    [
        ARCFACE_REFERENCE_POINTS[0],
        ARCFACE_REFERENCE_POINTS[1],
        ARCFACE_REFERENCE_POINTS[3:5].mean(axis=0),
    ]
).astype(np.float32)

IR50_BLOCKS = [(64, 64, 3), (64, 128, 4), (128, 256, 14), (256, 512, 3)]


# ---------------------------------------------------------------------------
# similarity transform (host-side numpy; matlab cp2tform semantics)
# ---------------------------------------------------------------------------


def _nonreflective_similarity(uv: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Least-squares fit of the similarity xy -> uv, then inverted (as
    cp2tform does, not a direct uv -> xy fit). Returns the 2x3 map uv -> xy."""
    n = xy.shape[0]
    x, y = xy[:, 0], xy[:, 1]
    u, v = uv[:, 0], uv[:, 1]
    A = np.zeros((2 * n, 4), np.float64)
    A[:n, 0], A[:n, 1], A[:n, 2] = x, -y, 1.0
    A[n:, 0], A[n:, 1], A[n:, 3] = y, x, 1.0
    b = np.concatenate([u, v])
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    sc, ss, tx, ty = sol
    t_inv = np.array([[sc, -ss, tx], [ss, sc, ty], [0.0, 0.0, 1.0]])  # xy -> uv
    t = np.linalg.inv(t_inv)
    return t[:2].astype(np.float32)


def similarity_transform(src_pts: np.ndarray, dst_pts: np.ndarray,
                         reflective: bool = True) -> np.ndarray:
    """2x3 similarity mapping src_pts -> dst_pts; with ``reflective`` the
    mirrored solution is tried too and the one of lower error kept."""
    src = np.asarray(src_pts, np.float64)
    dst = np.asarray(dst_pts, np.float64)
    t1 = _nonreflective_similarity(src, dst)
    if not reflective:
        return t1
    dst_m = dst.copy()
    dst_m[:, 0] = -dst_m[:, 0]
    t2 = _nonreflective_similarity(src, dst_m).copy()
    t2[0, :] = -t2[0, :]

    def err(t):
        mapped = np.hstack([src, np.ones((src.shape[0], 1))]) @ t.T
        return np.linalg.norm(mapped - dst)

    return t1 if err(t1) <= err(t2) else t2


def alignment_transforms(
    landmarks: List[Optional[np.ndarray]], output_size: int = 112,
    ref_points: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sample 2x3 transforms [B, 2, 3] and validity [B] from landmark
    points (None: identity and invalid). ``ref_points`` defaults to the
    5-point template."""
    mats, valid = [], []
    base = ARCFACE_REFERENCE_POINTS if ref_points is None else ref_points
    ref = base / 112.0 * output_size
    for lm in landmarks:
        if lm is None:
            mats.append(np.eye(2, 3, dtype=np.float32))
            valid.append(False)
        else:
            mats.append(similarity_transform(np.asarray(lm, np.float32), ref))
            valid.append(True)
    return np.stack(mats).astype(np.float32), np.asarray(valid)


def detector_alignment_mats(detect_fn, images_pm1, output_size: int = 112
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Detect 5-point landmarks on each image ([B, H, W, 3] in [-1, 1], an
    array or a tensor) with ``detect_fn`` (uint8 [H, W, 3] -> [5, 2] or
    None, e.g. ``data.mtcnn.landmark_detector``) and solve the transforms."""
    if isinstance(images_pm1, torch.Tensor):
        images_pm1 = images_pm1.detach().float().cpu().numpy()
    pts = []
    for im in np.asarray(images_pm1):
        u8 = ((np.clip(im, -1.0, 1.0) + 1.0) * 127.5).astype(np.uint8)
        pts.append(detect_fn(u8))
    return alignment_transforms(pts, output_size=output_size)


# ---------------------------------------------------------------------------
# differentiable warp
# ---------------------------------------------------------------------------


def warp_affine(images: torch.Tensor, mats: torch.Tensor, out_size: int) -> torch.Tensor:
    """``mats`` [B, 2, 3] map source pixel coordinates to the output's;
    output[y, x] samples the source bilinearly at M^-1 (x, y), zero outside.
    images [B, H, W, C] -> [B, out, out, C]; differentiable in images."""
    b, h, w, _ = images.shape
    mats = mats.to(images.device, torch.float32)
    a, bb, tx = mats[:, 0, 0], mats[:, 0, 1], mats[:, 0, 2]
    c, d, ty = mats[:, 1, 0], mats[:, 1, 1], mats[:, 1, 2]
    det = a * d - bb * c
    ia, ib = d / det, -bb / det
    ic, id_ = -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    r = torch.arange(out_size, dtype=torch.float32, device=images.device)
    ys, xs = torch.meshgrid(r, r, indexing="ij")
    sx = ia[:, None, None] * xs + ib[:, None, None] * ys + itx[:, None, None]
    sy = ic[:, None, None] * xs + id_[:, None, None] * ys + ity[:, None, None]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx = (sx - x0)[..., None].to(images.dtype)
    wy = (sy - y0)[..., None].to(images.dtype)
    rows = torch.arange(b, device=images.device)[:, None, None]

    def gather(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = images[rows, yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]
        return vals * inside[..., None].to(images.dtype)

    return (gather(y0, x0) * (1 - wx) * (1 - wy) + gather(y0, x0 + 1) * wx * (1 - wy)
            + gather(y0 + 1, x0) * (1 - wx) * wy + gather(y0 + 1, x0 + 1) * wx * wy)


# ---------------------------------------------------------------------------
# IR-SE-50 (inference mode, frozen)
# ---------------------------------------------------------------------------


def _bn(p, x, eps=1e-5):
    """Eval-mode BatchNorm over the last axis, in fp32, cast back."""
    inv = torch.rsqrt(p["var"].float() + eps)
    out = (x.float() - p["mean"].float()) * inv
    if "weight" in p:
        out = out * p["weight"].float() + p["bias"].float()
    return out.to(x.dtype)


def _prelu(p, x):
    return torch.where(x >= 0, x, p["alpha"].to(x.dtype) * x)


def _se(p, x):
    pooled = x.mean(dim=(1, 2), keepdim=True)
    h = F.relu(conv2d(p["fc1"], pooled, padding=0))
    return x * torch.sigmoid(conv2d(p["fc2"], h, padding=0))


def _bottleneck(p, x, stride: int):
    if p.get("shortcut") is None:
        shortcut = x if stride == 1 else x[:, ::stride, ::stride, :]
    else:
        shortcut = _bn(p["shortcut"]["bn"], conv2d(p["shortcut"]["conv"], x, stride=stride,
                                                   padding=0))
    h = _bn(p["res"]["bn1"], x)
    h = conv2d(p["res"]["conv1"], h, stride=1, padding=1)
    h = _prelu(p["res"]["prelu"], h)
    h = conv2d(p["res"]["conv2"], h, stride=stride, padding=1)
    h = _bn(p["res"]["bn2"], h)
    return _se(p["res"]["se"], h) + shortcut


def _strides() -> List[int]:
    out = []
    for _, _, units in IR50_BLOCKS:
        out += [2] + [1] * (units - 1)
    return out


def arcface_apply(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x [B, 112, 112, 3] in [-1, 1] -> l2-normalised embeddings [B, 512] fp32."""
    h = conv2d(params["input"]["conv"], x, padding=1)
    h = _bn(params["input"]["bn"], h)
    h = _prelu(params["input"]["prelu"], h)
    for bp, s in zip(params["body"], _strides()):
        h = _bottleneck(bp, h, s)
    h = _bn(params["output"]["bn2d"], h)
    flat = h.permute(0, 3, 1, 2).reshape(h.shape[0], -1)  # torch flattens NCHW
    emb = _bn(params["output"]["bn1d"], dense(params["output"]["linear"], flat))
    norm = torch.linalg.vector_norm(emb.float(), dim=1, keepdim=True)
    return (emb / norm.to(emb.dtype)).float()


def init_arcface_params(gen: torch.Generator, *, device=None) -> Dict[str, Any]:
    """Random IR-SE-50 tree (JAX's ``init_arcface_params`` distributions:
    U(+-1/sqrt(fan_in)) kernels, identity BatchNorm, PReLU 0.25)."""

    def conv(cin, cout, k):
        bound = 1.0 / math.sqrt(cin * k * k)
        w = (torch.rand((cout, cin, k, k), generator=gen, device=device) * 2 - 1) * bound
        return {"weight": w}

    def bn(c, affine=True):
        p = {"mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)}
        if affine:
            p.update(weight=torch.ones(c, device=device), bias=torch.zeros(c, device=device))
        return p

    def prelu(c):
        return {"alpha": torch.full((c,), 0.25, device=device)}

    bound = 1.0 / math.sqrt(512 * 7 * 7)
    params: Dict[str, Any] = {
        "input": {"conv": conv(3, 64, 3), "bn": bn(64), "prelu": prelu(64)},
        "body": [],
        "output": {
            "bn2d": bn(512),
            "linear": {"weight": (torch.rand((512, 512 * 7 * 7), generator=gen, device=device)
                                  * 2 - 1) * bound, "bias": torch.zeros(512, device=device)},
            "bn1d": bn(512),
        },
    }
    for in_c, depth, units in IR50_BLOCKS:
        for u in range(units):
            ic = in_c if u == 0 else depth
            params["body"].append({
                "shortcut": None if ic == depth else {"conv": conv(ic, depth, 1), "bn": bn(depth)},
                "res": {
                    "bn1": bn(ic), "conv1": conv(ic, depth, 3), "prelu": prelu(depth),
                    "conv2": conv(depth, depth, 3), "bn2": bn(depth),
                    "se": {"fc1": conv(depth, depth // 16, 1), "fc2": conv(depth // 16, depth, 1)},
                },
            })
    return params


def convert_arcface_params(sd: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's IR-SE-50 state dict (``model_ir_se50.pth`` names) ->
    the port's tree (already PyTorch layouts: copied as fp32)."""

    def t(name):
        return torch.as_tensor(sd[name]).detach().float().clone()

    def conv(prefix):
        return {"weight": t(f"{prefix}.weight")}

    def bn(prefix):
        return {"weight": t(f"{prefix}.weight"), "bias": t(f"{prefix}.bias"),
                "mean": t(f"{prefix}.running_mean"), "var": t(f"{prefix}.running_var")}

    params: Dict[str, Any] = {
        "input": {"conv": conv("input_layer.0"), "bn": bn("input_layer.1"),
                  "prelu": {"alpha": t("input_layer.2.weight")}},
        "body": [],
    }
    i = 0
    while f"body.{i}.res_layer.1.weight" in sd:
        pre = f"body.{i}"
        params["body"].append({
            "shortcut": ({"conv": conv(f"{pre}.shortcut_layer.0"),
                          "bn": bn(f"{pre}.shortcut_layer.1")}
                         if f"{pre}.shortcut_layer.0.weight" in sd else None),
            "res": {
                "bn1": bn(f"{pre}.res_layer.0"), "conv1": conv(f"{pre}.res_layer.1"),
                "prelu": {"alpha": t(f"{pre}.res_layer.2.weight")},
                "conv2": conv(f"{pre}.res_layer.3"), "bn2": bn(f"{pre}.res_layer.4"),
                "se": {"fc1": conv(f"{pre}.res_layer.5.fc1"), "fc2": conv(f"{pre}.res_layer.5.fc2")},
            },
        })
        i += 1
    bn1d = {"mean": t("output_layer.4.running_mean"), "var": t("output_layer.4.running_var")}
    if "output_layer.4.weight" in sd:
        bn1d.update(weight=t("output_layer.4.weight"), bias=t("output_layer.4.bias"))
    params["output"] = {
        "bn2d": bn("output_layer.0"),
        "linear": {"weight": t("output_layer.3.weight"), "bias": t("output_layer.3.bias")},
        "bn1d": bn1d,
    }
    return params


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


def id_loss(arcface_params: Dict[str, Any], pred: torch.Tensor, target: torch.Tensor,
            pred_mats: torch.Tensor, target_mats: torch.Tensor, valid: torch.Tensor,
            count: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, mean similarity): 1 - cos over the valid samples, 0 when none
    is valid. ``*_mats`` [B, 2, 3] from ``alignment_transforms``; the target
    branch carries no gradient. ``count``: the valid samples of the whole
    batch when this call sees one rank's part of it (default: ``valid``'s)."""
    pred_feats = arcface_apply(arcface_params, warp_affine(pred.float(), pred_mats, 112))
    with torch.no_grad():
        target_feats = arcface_apply(arcface_params, warp_affine(target.float(), target_mats, 112))
    sims = (pred_feats * target_feats).sum(dim=1)
    validf = torch.as_tensor(valid, device=sims.device).float()
    n = validf.sum() if count is None else count
    denom = n.clamp_min(1.0)
    any_valid = (n > 0).float()
    loss = ((1.0 - sims) * validf).sum() / denom
    sim = (sims * validf).sum() / denom
    return loss * any_valid, sim * any_valid


def id_loss_whole_image(arcface_params: Dict[str, Any], pred: torch.Tensor,
                        target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Detection-free ID loss: both images resized to 112 (antialiased
    linear, as ``jax.image.resize``) and their embeddings compared."""
    pred_feats = arcface_apply(arcface_params, resize(pred.float(), (112, 112), "linear"))
    with torch.no_grad():
        target_feats = arcface_apply(arcface_params, resize(target.float(), (112, 112), "linear"))
    sims = (pred_feats * target_feats).sum(dim=1)
    return (1.0 - sims).mean(), sims.mean()
