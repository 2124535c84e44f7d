"""MTCNN face detection (Zhang et al. 2016), counterpart of
``instantrestore_tpu/data/mtcnn.py``: the three-stage cascade of P-net (the
fully convolutional 12x12 proposal net over an image pyramid), R-net (24x24
refinement) and O-net (48x48 output net with 5-point landmarks), with
bounding-box regression, square re-rectification and NMS between stages.

The nets run in torch on the device their parameters are on (PReLU per
channel, max-pooling in ceil mode); the pyramid, crops and NMS are host-side
numpy, copied. Parameters: the JAX tree's nesting with PyTorch layouts (OIHW
conv ``weight``, dense ``weight`` [out, in], PReLU slopes as [C] tensors);
``convert.from_jax_tree`` converts a JAX tree, ``convert_mtcnn_params`` the
facenet_pytorch state dicts. ``landmark_detector`` feeds
``training/losses/id_loss.detector_alignment_mats``; ``default_detector``
feeds ``data/canonical_face.py``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# networks (facenet_pytorch layer plan; PReLU activations), NHWC in and out
# ---------------------------------------------------------------------------


def _prelu(a, x):
    """PReLU with one slope per channel (the last axis)."""
    return torch.where(x >= 0, x, a.to(x.dtype) * x)


def _conv(p, x, stride=1):
    """'valid' conv of NCHW ``x``."""
    return F.conv2d(x, p["weight"].to(x.dtype), p["bias"].to(x.dtype), stride)


def _prelu_c(a, x):
    """PReLU of NCHW ``x``, one slope per channel."""
    return torch.where(x >= 0, x, a.to(x.dtype)[None, :, None, None] * x)


def _maxpool_ceil(x, k, stride):
    """Max-pooling of NCHW ``x`` in ceil mode (windows past the right and
    bottom edges see only the pixels inside)."""
    return F.max_pool2d(x, k, stride, ceil_mode=True)


def _dense(p, x):
    return F.linear(x, p["weight"].to(x.dtype), p["bias"].to(x.dtype))


def _flatten_whc(h):
    """facenet_pytorch flattens after permute(0, 3, 2, 1): (N, W, H, C)
    order, which the converted dense weights expect."""
    return h.permute(0, 3, 2, 1).reshape(h.shape[0], -1)


def pnet_apply(p, x: torch.Tensor):
    """x [B, H, W, 3] normalised -> (probs [B, H', W'], reg [B, H', W', 4]);
    fully convolutional, stride 2, cell 12."""
    h = x.permute(0, 3, 1, 2)
    h = _prelu_c(p["prelu1"], _conv(p["conv1"], h))
    h = _maxpool_ceil(h, 2, 2)
    h = _prelu_c(p["prelu2"], _conv(p["conv2"], h))
    h = _prelu_c(p["prelu3"], _conv(p["conv3"], h))
    probs = torch.softmax(_conv(p["conv4_1"], h), dim=1)[:, 1]
    reg = _conv(p["conv4_2"], h).permute(0, 2, 3, 1)
    return probs, reg


def rnet_apply(p, x: torch.Tensor):
    """x [B, 24, 24, 3] -> (probs [B], reg [B, 4])."""
    h = x.permute(0, 3, 1, 2)
    h = _maxpool_ceil(_prelu_c(p["prelu1"], _conv(p["conv1"], h)), 3, 2)
    h = _maxpool_ceil(_prelu_c(p["prelu2"], _conv(p["conv2"], h)), 3, 2)
    h = _prelu_c(p["prelu3"], _conv(p["conv3"], h))
    h = _prelu(p["prelu4"], _dense(p["dense4"], _flatten_whc(h)))
    return torch.softmax(_dense(p["dense5_1"], h), -1)[:, 1], _dense(p["dense5_2"], h)


def onet_apply(p, x: torch.Tensor):
    """x [B, 48, 48, 3] -> (probs [B], reg [B, 4], landmarks [B, 10])."""
    h = x.permute(0, 3, 1, 2)
    h = _maxpool_ceil(_prelu_c(p["prelu1"], _conv(p["conv1"], h)), 3, 2)
    h = _maxpool_ceil(_prelu_c(p["prelu2"], _conv(p["conv2"], h)), 3, 2)
    h = _maxpool_ceil(_prelu_c(p["prelu3"], _conv(p["conv3"], h)), 2, 2)
    h = _prelu_c(p["prelu4"], _conv(p["conv4"], h))
    h = _prelu(p["prelu5"], _dense(p["dense5"], _flatten_whc(h)))
    probs = torch.softmax(_dense(p["dense6_1"], h), -1)[:, 1]
    return probs, _dense(p["dense6_2"], h), _dense(p["dense6_3"], h)


def init_mtcnn_params(gen: torch.Generator, *, device=None) -> Dict[str, Any]:
    """Random cascade weights (JAX's ``init_mtcnn_params`` distributions:
    N(0, 2 / fan_in) convs, N(0, 1 / fan_in) dense, PReLU 0.25)."""

    def conv(cin, cout, k):
        w = torch.randn((cout, cin, k, k), generator=gen, device=device) * math.sqrt(2.0 / (cin * k * k))
        return {"weight": w, "bias": torch.zeros(cout, device=device)}

    def dense(cin, cout):
        w = torch.randn((cout, cin), generator=gen, device=device) / math.sqrt(cin)
        return {"weight": w, "bias": torch.zeros(cout, device=device)}

    def prelu(c):
        return torch.full((c,), 0.25, device=device)

    return {
        "pnet": {
            "conv1": conv(3, 10, 3), "prelu1": prelu(10),
            "conv2": conv(10, 16, 3), "prelu2": prelu(16),
            "conv3": conv(16, 32, 3), "prelu3": prelu(32),
            "conv4_1": conv(32, 2, 1), "conv4_2": conv(32, 4, 1),
        },
        "rnet": {
            "conv1": conv(3, 28, 3), "prelu1": prelu(28),
            "conv2": conv(28, 48, 3), "prelu2": prelu(48),
            "conv3": conv(48, 64, 2), "prelu3": prelu(64),
            "dense4": dense(576, 128), "prelu4": prelu(128),
            "dense5_1": dense(128, 2), "dense5_2": dense(128, 4),
        },
        "onet": {
            "conv1": conv(3, 32, 3), "prelu1": prelu(32),
            "conv2": conv(32, 64, 3), "prelu2": prelu(64),
            "conv3": conv(64, 64, 3), "prelu3": prelu(64),
            "conv4": conv(64, 128, 2), "prelu4": prelu(128),
            "dense5": dense(1152, 256), "prelu5": prelu(256),
            "dense6_1": dense(256, 2), "dense6_2": dense(256, 4), "dense6_3": dense(256, 10),
        },
    }


# ---------------------------------------------------------------------------
# cascade glue (host-side numpy)
# ---------------------------------------------------------------------------


def nms(boxes: np.ndarray, scores: np.ndarray, threshold: float,
        method: str = "union") -> np.ndarray:
    """Greedy NMS; method 'union' = IoU, 'min' = overlap / min-area."""
    if len(boxes) == 0:
        return np.empty((0,), np.int64)
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = np.maximum(x1 - x0, 0) * np.maximum(y1 - y0, 0)
    order = scores.argsort()[::-1]
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        rest = order[1:]
        ix0 = np.maximum(x0[i], x0[rest])
        iy0 = np.maximum(y0[i], y0[rest])
        ix1 = np.minimum(x1[i], x1[rest])
        iy1 = np.minimum(y1[i], y1[rest])
        inter = np.maximum(ix1 - ix0, 0) * np.maximum(iy1 - iy0, 0)
        if method == "min":
            o = inter / np.maximum(np.minimum(area[i], area[rest]), 1e-9)
        else:
            o = inter / np.maximum(area[i] + area[rest] - inter, 1e-9)
        order = rest[o <= threshold]
    return np.asarray(keep, np.int64)


def _rerec(boxes: np.ndarray) -> np.ndarray:
    """Square boxes around their centres."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    side = np.maximum(w, h)
    out = boxes.copy()
    out[:, 0] += w / 2 - side / 2
    out[:, 1] += h / 2 - side / 2
    out[:, 2] = out[:, 0] + side
    out[:, 3] = out[:, 1] + side
    return out


def _apply_reg(boxes: np.ndarray, reg: np.ndarray) -> np.ndarray:
    w = (boxes[:, 2] - boxes[:, 0])[:, None]
    h = (boxes[:, 3] - boxes[:, 1])[:, None]
    return boxes[:, :4] + reg * np.concatenate([w, h, w, h], 1)


def _bilinear_resize(patch: np.ndarray, sh: int, sw: int) -> np.ndarray:
    yi = np.linspace(0, patch.shape[0] - 1, sh)
    xi = np.linspace(0, patch.shape[1] - 1, sw)
    y_lo = yi.astype(int)
    x_lo = xi.astype(int)
    y_hi = np.minimum(y_lo + 1, patch.shape[0] - 1)
    x_hi = np.minimum(x_lo + 1, patch.shape[1] - 1)
    wy = (yi - y_lo)[:, None, None]
    wx = (xi - x_lo)[None, :, None]
    return (
        patch[y_lo][:, x_lo] * (1 - wy) * (1 - wx)
        + patch[y_lo][:, x_hi] * (1 - wy) * wx
        + patch[y_hi][:, x_lo] * wy * (1 - wx)
        + patch[y_hi][:, x_hi] * wy * wx
    )


def _crop_resize(img: np.ndarray, boxes: np.ndarray, size: int) -> np.ndarray:
    """Square crops (zero-padded at the borders) resized bilinearly to
    size x size."""
    hh, ww = img.shape[:2]
    out = np.zeros((len(boxes), size, size, 3), np.float32)
    for i, (x0, y0, x1, y1) in enumerate(boxes[:, :4].astype(int)):
        x0c, y0c = max(x0, 0), max(y0, 0)
        x1c, y1c = min(x1, ww), min(y1, hh)
        if x1c <= x0c or y1c <= y0c:
            continue
        patch = np.zeros((y1 - y0, x1 - x0, 3), np.float32)
        patch[y0c - y0 : y1c - y0, x0c - x0 : x1c - x0] = img[y0c:y1c, x0c:x1c]
        out[i] = _bilinear_resize(patch, size, size)
    return out


def _normalize(x: np.ndarray) -> np.ndarray:
    return (x - 127.5) * (1.0 / 128.0)


def _params_device(params: Dict[str, Any]) -> torch.device:
    return params["pnet"]["conv1"]["weight"].device


def _run(net, p, x: np.ndarray, device) -> Tuple[np.ndarray, ...]:
    """One net on a host batch: normalised, on the params' device, back as
    numpy."""
    with torch.no_grad():
        outs = net(p, torch.from_numpy(np.ascontiguousarray(_normalize(x), np.float32)).to(device))
    return tuple(o.float().cpu().numpy() for o in outs)


def detect_faces(
    params: Dict[str, Any],
    image: np.ndarray,
    *,
    min_size: int = 20,
    thresholds: Tuple[float, float, float] = (0.6, 0.7, 0.7),
    factor: float = 0.709,
    max_proposals: int = 512,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """image uint8 [H, W, 3] -> (boxes [K, 4], scores [K], landmarks [K, 5, 2]):
    pyramid P-net proposals -> NMS -> R-net -> NMS -> O-net scores,
    regression and landmarks -> NMS('min'). The nets run where ``params``
    are."""
    dev = _params_device(params)
    img = np.asarray(image, np.float32)
    hh, ww = img.shape[:2]
    m = 12.0 / min_size
    min_dim = min(hh, ww) * m

    # --- stage 1: pyramid P-net ---
    scales = []
    while min_dim >= 12:
        scales.append(m)
        m *= factor
        min_dim *= factor
    all_boxes: List[np.ndarray] = []
    for s in scales:
        sh, sw = int(np.ceil(hh * s)), int(np.ceil(ww * s))
        probs, reg = _run(pnet_apply, params["pnet"], _bilinear_resize(img, sh, sw)[None], dev)
        probs, reg = probs[0], reg[0]
        ys, xs = np.where(probs > thresholds[0])
        if len(ys) == 0:
            continue
        score = probs[ys, xs]
        r = reg[ys, xs]
        stride, cell = 2, 12
        b = np.stack([
            (stride * xs + 1) / s, (stride * ys + 1) / s,
            (stride * xs + cell) / s, (stride * ys + cell) / s,
        ], 1).astype(np.float32)
        keep = nms(b, score, 0.5)
        all_boxes.append(np.concatenate([b[keep], score[keep, None], r[keep]], 1))
    if not all_boxes:
        return np.empty((0, 4)), np.empty((0,)), np.empty((0, 5, 2))
    boxes = np.concatenate(all_boxes)
    keep = nms(boxes[:, :4], boxes[:, 4], 0.7)[:max_proposals]
    boxes = boxes[keep]
    b4 = _rerec(_apply_reg(boxes[:, :4], boxes[:, 5:9]))

    # --- stage 2: R-net ---
    probs, reg = _run(rnet_apply, params["rnet"], _crop_resize(img, b4, 24), dev)
    sel = probs > thresholds[1]
    if not sel.any():
        return np.empty((0, 4)), np.empty((0,)), np.empty((0, 5, 2))
    b4, probs, reg = b4[sel], probs[sel], reg[sel]
    keep = nms(b4, probs, 0.7)
    b4 = _rerec(_apply_reg(b4[keep], reg[keep]))

    # --- stage 3: O-net ---
    probs3, reg, lmk = _run(onet_apply, params["onet"], _crop_resize(img, b4, 48), dev)
    sel = probs3 > thresholds[2]
    if not sel.any():
        return np.empty((0, 4)), np.empty((0,)), np.empty((0, 5, 2))
    b4, probs3, reg, lmk = b4[sel], probs3[sel], reg[sel], lmk[sel]
    w = (b4[:, 2] - b4[:, 0])[:, None]
    h = (b4[:, 3] - b4[:, 1])[:, None]
    # facenet_pytorch landmark layout: [x1..x5, y1..y5] relative to the box
    points = np.stack([b4[:, 0:1] + lmk[:, :5] * w, b4[:, 1:2] + lmk[:, 5:] * h], -1)
    b4 = _apply_reg(b4, reg)
    keep = nms(b4, probs3, 0.7, method="min")
    return b4[keep], probs3[keep], points[keep]


def landmark_detector(params: Dict[str, Any], **kwargs):
    """uint8 image -> [5, 2] landmarks of the highest-scoring face, or None
    (the ``detect_fn`` of ``id_loss.detector_alignment_mats``)."""

    def detect(image: np.ndarray):
        boxes, scores, points = detect_faces(params, image, **kwargs)
        if len(boxes) == 0:
            return None
        return points[int(np.argmax(scores))]

    return detect


def default_detector(params: Dict[str, Any], **kwargs):
    """The cascade as ``data/canonical_face.py``'s Detector: the
    highest-scoring face or None."""
    from instantrestore_tpu_torch.data.canonical_face import FaceDetection

    def detect(image: np.ndarray) -> Optional[FaceDetection]:
        boxes, scores, points = detect_faces(params, image, **kwargs)
        if len(boxes) == 0:
            return None
        i = int(np.argmax(scores))
        return FaceDetection(bbox=boxes[i], landmarks=points[i])

    return detect


def convert_mtcnn_params(pnet_sd, rnet_sd, onet_sd) -> Dict[str, Any]:
    """facenet_pytorch PNet / RNet / ONet state dicts -> the port's tree
    (already PyTorch layouts: copied as fp32, PReLU weights flattened)."""

    def t(sd, name):
        return torch.as_tensor(sd[name]).detach().float().clone()

    def lin(sd, name):
        return {"weight": t(sd, f"{name}.weight"), "bias": t(sd, f"{name}.bias")}

    def prelu(sd, name):
        return t(sd, f"{name}.weight").reshape(-1)

    def net(sd, layers, prelus):
        out = {name: lin(sd, name) for name in layers}
        out.update({name: prelu(sd, name) for name in prelus})
        return out

    return {
        "pnet": net(pnet_sd, ("conv1", "conv2", "conv3", "conv4_1", "conv4_2"),
                    ("prelu1", "prelu2", "prelu3")),
        "rnet": net(rnet_sd, ("conv1", "conv2", "conv3", "dense4", "dense5_1", "dense5_2"),
                    ("prelu1", "prelu2", "prelu3", "prelu4")),
        "onet": net(onet_sd, ("conv1", "conv2", "conv3", "conv4", "dense5", "dense6_1",
                              "dense6_2", "dense6_3"),
                    ("prelu1", "prelu2", "prelu3", "prelu4", "prelu5")),
    }
