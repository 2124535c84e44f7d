"""Restoration quality over folders of images (counterpart of
``scripts/evaluate.py``): PSNR, SSIM, and with trained weights LPIPS and
ArcFace identity cosine, of each prediction against the ground truth of the
same file stem. Prints one JSON line of means and writes a per-image
report. Works on any method's outputs.

    python -m instantrestore_tpu_torch.cli.evaluate --pred_dir RESULTS --gt_dir GT \
        [--lpips_vgg vgg16.pth --lpips_lin vgg.pth]   # LPIPS v0.1 weights
        [--arcface model_ir_se50.pth]                 # ID cosine
        [--resolution 512] [--batch 8] [--out eval.json] [--device cuda]

The LPIPS and ID rows appear only when trained weights are given: random
features would give meaningless numbers, so the report's ``lpips`` /
``id_cosine`` keys are absent, not made up. Images are read with Pillow.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from instantrestore_tpu_torch import resolve_device

IMG_EXTS = {".png", ".jpg", ".jpeg", ".webp", ".bmp"}


def _pairs(pred_dir: Path, gt_dir: Path):
    """(prediction, ground truth) paths matched by stem, in the predictions' order."""
    gts = {p.stem: p for p in gt_dir.iterdir() if p.suffix.lower() in IMG_EXTS}
    return [(p, gts[p.stem]) for p in sorted(pred_dir.iterdir())
            if p.suffix.lower() in IMG_EXTS and p.stem in gts]


def _load(path: Path, resolution: int) -> np.ndarray:
    from PIL import Image

    from instantrestore_tpu_torch.data.transforms import infer_transform

    return infer_transform(Image.open(path).convert("RGB"), resolution)


@torch.no_grad()
def metrics_batch(pred: torch.Tensor, gt: torch.Tensor, lpips_params=None,
                  arcface_params=None) -> dict:
    """pred, gt [B, H, W, 3] in [-1, 1] -> per-image metrics [B]; PSNR with
    peak-to-peak 2 (MAX^2 = 4)."""
    from instantrestore_tpu_torch.ops.image_ops import resize
    from instantrestore_tpu_torch.training.losses.id_loss import arcface_apply
    from instantrestore_tpu_torch.training.losses.lpips import lpips
    from instantrestore_tpu_torch.training.losses.ssim import ssim

    mse = (pred - gt).square().mean(dim=(1, 2, 3))
    out = {"psnr": 10.0 * torch.log10(4.0 / mse.clamp_min(1e-12)),
           "ssim": ssim(pred, gt, data_range=2.0, reduce=False)}
    if lpips_params is not None:
        out["lpips"] = lpips(lpips_params, pred, gt)
    if arcface_params is not None:
        b = pred.shape[0]
        e = arcface_apply(arcface_params, resize(torch.cat([pred, gt]), (112, 112), "linear"))
        out["id_cosine"] = (e[:b] * e[b:]).sum(dim=-1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pred_dir", required=True)
    ap.add_argument("--gt_dir", required=True)
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lpips_vgg", default=None, help="torchvision vgg16 features state dict (.pth)")
    ap.add_argument("--lpips_lin", default=None, help="LPIPS v0.1 linear-head weights (vgg.pth)")
    ap.add_argument("--arcface", default=None, help="model_ir_se50.pth")
    ap.add_argument("--out", default="eval.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    pairs = _pairs(Path(args.pred_dir), Path(args.gt_dir))
    if not pairs:
        print("no matching (prediction, gt) stems found", file=sys.stderr)
        return 1
    from instantrestore_tpu_torch.convert import tree_to

    dev = resolve_device(args.device)
    lpips_params = arcface_params = None
    if args.lpips_vgg and args.lpips_lin:
        from instantrestore_tpu_torch.training.losses.lpips import convert_lpips_params

        lpips_params = tree_to(convert_lpips_params(
            torch.load(args.lpips_vgg, map_location="cpu", weights_only=True),
            torch.load(args.lpips_lin, map_location="cpu", weights_only=True)), dev)
    if args.arcface:
        from instantrestore_tpu_torch.training.losses.id_loss import convert_arcface_params

        arcface_params = tree_to(convert_arcface_params(
            torch.load(args.arcface, map_location="cpu", weights_only=True)), dev)

    rows = []
    for start in range(0, len(pairs), args.batch):
        chunk = pairs[start:start + args.batch]

        def stack(i):
            return torch.from_numpy(np.stack([_load(pair[i], args.resolution)
                                              for pair in chunk])).to(dev)

        m = metrics_batch(stack(0), stack(1), lpips_params, arcface_params)
        m = {k: v.float().cpu().numpy() for k, v in m.items()}
        for i, (p, _) in enumerate(chunk):
            rows.append({"image": p.name, **{k: float(v[i]) for k, v in m.items()}})

    keys = [k for k in rows[0] if k != "image"]
    report = {
        "n_images": len(rows),
        "aggregate": {k: float(np.mean([r[k] for r in rows])) for k in keys},
        "weights": {"lpips": "converted" if lpips_params is not None else "absent",
                    "arcface": "converted" if arcface_params is not None else "absent"},
        "per_image": rows,
    }
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({"n_images": len(rows), **report["aggregate"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
