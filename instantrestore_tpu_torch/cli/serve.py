"""Batched serving from a checkpoint over the identity-cached ServingEngine
(counterpart of ``scripts/serve.py``).

Every identity is onboarded once into the warm K/V cache; then the degraded
images are restored in batches across identities (one VAE encode, one UNet
reading the cache, one VAE decode each), the last batch padded with copies of
its last image, whose outputs are not written.

    <data_root>/<identity>/degraded.png        an image to restore
    <data_root>/<identity>/degraded/*          more of them
    <data_root>/<identity>/conditioning/*.png  its references (>= 1)

    python -m instantrestore_tpu_torch.cli.serve --checkpoint ckpt.pt --data_root DIR \
        [--results_dir results] [--batch 16] [--refs 4] [--base_weights_dir DIR] \
        [--tokenizer_dir DIR] [--seed 0] [--device cuda]

Onboarding draws its noise from ``torch.Generator(device).manual_seed(seed)``,
the batch starting at image ``start`` from ``manual_seed(seed + 1 + start)``.
``--int8`` (calibrated int8 serving) is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from instantrestore_tpu_torch import resolve_device
from instantrestore_tpu_torch.convert import tree_to
from instantrestore_tpu_torch.inference.predictor import load_predictor_params
from instantrestore_tpu_torch.inference.serving import ServingEngine
from instantrestore_tpu_torch.models.restorer import serving_bundle


def load_engine(checkpoint, *, statics=None, base_weights_dir=None, tokenizer_dir=None,
                device=None) -> ServingEngine:
    """A checkpoint -> a ServingEngine on ``device`` (CUDA unless asked
    otherwise): LoRA merged on the device, the text tower dropped."""
    dev = resolve_device(device)
    params, statics = load_predictor_params(checkpoint, statics, base_weights_dir=base_weights_dir,
                                            tokenizer_dir=tokenizer_dir, device=dev)
    params.pop("text_encoder", None)  # caption_enc was computed at load
    return ServingEngine(serving_bundle(tree_to(params, dev), statics), statics, device=dev)


def run(engine: ServingEngine, refs, images, slots, *, batch: int = 16, seed: int = 0
        ) -> torch.Tensor:
    """Onboard ``refs`` [I, N, H, W, 3] and restore ``images`` [M, H, W, 3]
    of identities ``slots`` [M] in batches of ``batch`` -> [M, res, res, 3]
    float32 on the CPU in [-1, 1]. Inputs are uint8 (or float in [-1, 1])."""
    dev = engine.device
    refs, images = torch.as_tensor(refs), torch.as_tensor(images)
    slots = torch.as_tensor(slots, dtype=torch.long)
    print(f"# onboarding {refs.shape[0]} identities ({refs.shape[1]} refs each, "
          f"{engine.resolution}px)", file=sys.stderr)
    t0 = time.perf_counter()
    engine.onboard(refs, generator=torch.Generator(device=dev).manual_seed(seed))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"# onboarded in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    outs, t_restore = [], 0.0
    for start in range(0, len(images), batch):
        imgs, ids = images[start:start + batch], slots[start:start + batch]
        n = len(imgs)
        if n < batch:  # a fixed batch shape: pad with the last item
            imgs = torch.cat([imgs, imgs[-1:].expand(batch - n, *imgs.shape[1:])])
            ids = torch.cat([ids, ids[-1:].expand(batch - n)])
        t0 = time.perf_counter()
        out = engine.restore(imgs, ids,
                             generator=torch.Generator(device=dev).manual_seed(seed + 1 + start))
        outs.append(out[:n].float().cpu())
        t_restore += time.perf_counter() - t0
        print(f"# {start + n}/{len(images)} restored", file=sys.stderr)
    print(f"restored {len(images)} images from {refs.shape[0]} identities in {t_restore:.2f}s "
          f"({len(images) / max(t_restore, 1e-9):.1f} faces/sec incl. the first batch's set-up)")
    return torch.cat(outs)


def load_identity_refs(identity_dir: Path, n_refs: int, resolution: int):
    """conditioning/* -> [n_refs, res, res, 3] uint8, cycled when fewer are
    present, each cycled copy flipped left-right; None without references."""
    from PIL import Image

    paths = sorted((identity_dir / "conditioning").glob("*"))
    if not paths:
        return None
    imgs = []
    for i in range(n_refs):
        im = Image.open(paths[i % len(paths)]).convert("RGB")
        arr = np.asarray(im.resize((resolution, resolution), Image.LANCZOS), np.uint8)
        imgs.append(arr[:, ::-1] if i >= len(paths) else arr)
    return np.stack(imgs)


def main(argv=None, statics=None) -> int:
    """``statics`` overrides the checkpoint's own. A LoRA-only file carries
    none, so without ``statics`` the defaults serve it (``train_input``, no
    AdaIN), as in the JAX package; its LoRA scalings come from the file."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--results_dir", default="results")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--refs", type=int, default=4)
    ap.add_argument("--int8", action="store_true",
                    help="calibrated static-scale int8 decoder + UNet (not ported yet)")
    ap.add_argument("--no_calibrate", action="store_true",
                    help="with --int8: keep dynamic per-call scales")
    ap.add_argument("--base_weights_dir", default=None,
                    help="sd-turbo/sd-vae base weights for LoRA-only checkpoints")
    ap.add_argument("--tokenizer_dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.int8:
        raise NotImplementedError("int8 serving is not ported yet (ROADMAP.md Queue 1 item 6)")

    from PIL import Image

    from instantrestore_tpu_torch.data.transforms import denormalize_pm1

    engine = load_engine(args.checkpoint, statics=statics, base_weights_dir=args.base_weights_dir,
                         tokenizer_dir=args.tokenizer_dir, device=args.device)
    res = engine.resolution
    identities, refs, work = [], [], []  # work: (identity slot, image path)
    for d in sorted(p for p in Path(args.data_root).glob("*") if p.is_dir()):
        r = load_identity_refs(d, args.refs, res)
        if r is None:
            continue
        slot = len(identities)
        identities.append(d.name)
        refs.append(r)
        degraded = [d / "degraded.png"] if (d / "degraded.png").exists() else []
        degraded += sorted((d / "degraded").glob("*")) if (d / "degraded").is_dir() else []
        work += [(slot, p) for p in degraded]
    if not work:
        print("no identities with degraded images found", file=sys.stderr)
        return 1

    def load_image(p):
        im = Image.open(p).convert("RGB").resize((res, res), Image.LANCZOS)
        return np.asarray(im, np.uint8)

    images = np.stack([load_image(p) for _, p in work])
    out = run(engine, np.stack(refs), images, [s for s, _ in work], batch=args.batch,
              seed=args.seed).numpy()
    out_dir = Path(args.results_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for (slot, p), img in zip(work, out):
        pil = Image.fromarray((denormalize_pm1(img) * 255).clip(0, 255).astype(np.uint8))
        stem = "" if p.name == "degraded.png" else f"_{p.stem}"
        pil.save(out_dir / f"{identities[slot]}{stem}.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
