"""Parity and fidelity reports of the port (counterpart of
``scripts/parity.py``): four sub-commands, one JSON report each, with the
JAX script's arguments and report fields, plus ``--device``.

* ``gradio``: the Predictor over ``<data>/<id>/{degraded.png, gt.png,
  conditioning/*}``: per identity PSNR and L2 against gt, ArcFace cosines
  (prediction against gt and against the mean reference embedding; the
  IR-SE-50 of ``training/losses/id_loss.py`` on whole images resized to 112)
  and the per-reference attention-mass percentages. Without ``--arcface``
  the network is random and the report says ``arcface_weights: random``.
* ``convert-diff``: a reference ``.pt`` through ``utils/torch_convert.py``:
  per network the tensor count, per-tensor stats, the |.| mass before and
  after conversion; with ``--strict`` the round trip of every key (unmapped
  and drifted keys) and the leaves missing against a freshly initialised
  template (the model's widths), exit code 1 on any.
* ``dump-activations``: ``restore_forward(debug_taps=True)`` (the latent's
  mode, the seeded noise, t = 249, unfused attention) into an ``.npz`` whose
  keys are the JAX script's, so the two dumps diff key by key.
* ``determinism``: two predictions and their max-abs difference; ``--dump``
  writes the image, the references, the noise the port drew, the output and
  the timestep.

    python -m instantrestore_tpu_torch.cli.parity gradio --checkpoint ckpt --data DIR \
        [--arcface model_ir_se50.pth] [--out report.json] [--device cuda]
    python -m instantrestore_tpu_torch.cli.parity convert-diff --pt model.pt [--strict] \
        [--no-template] [--out report.json]
    python -m instantrestore_tpu_torch.cli.parity determinism --checkpoint ckpt \
        --input img.png --refs DIR [--dump parity_dump.npz]
    python -m instantrestore_tpu_torch.cli.parity dump-activations --checkpoint ckpt \
        --input img.png --refs DIR [--dump activations.npz] [--fp32]

A LoRA-only checkpoint finds its base weights as ``cli.serve`` does
(``--base_weights_dir``, ``--tokenizer_dir`` or the environment).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg")


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR on [-1, 1] images (peak 2)."""
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float(10.0 * np.log10(4.0 / max(mse, 1e-12)))


def _arcface_embed(arcface_params, images_pm1: np.ndarray, device) -> np.ndarray:
    """Whole-image ArcFace embeddings at 112 px (the training ID loss's
    detection-free path on pre-cropped faces)."""
    from instantrestore_tpu_torch.ops.image_ops import resize
    from instantrestore_tpu_torch.training.losses.id_loss import arcface_apply

    x = torch.as_tensor(np.asarray(images_pm1, np.float32)).to(device)
    with torch.no_grad():
        return arcface_apply(arcface_params, resize(x, (112, 112), "linear")).float().cpu().numpy()


def _predictor(args, statics=None, dtype=torch.bfloat16):
    from instantrestore_tpu_torch.inference.predictor import Predictor

    return Predictor(args.checkpoint, statics=statics, resolution=args.resolution,
                     deterministic=True, dtype=dtype, device=args.device,
                     base_weights_dir=args.base_weights_dir, tokenizer_dir=args.tokenizer_dir)


def _open_rgb(path):
    from PIL import Image

    return Image.open(path).convert("RGB")


def _refs(folder, limit: int = 4):
    return [_open_rgb(p) for p in sorted(Path(folder).glob("*"))
            if p.suffix.lower() in IMAGE_SUFFIXES][:limit]


def gradio_report(predictor, data_root, arcface, resolution: int, arc_src: str = "unknown",
                  limit: int = 0) -> Dict[str, Any]:
    """The Predictor over the gradio fixtures: one row per identity."""
    from instantrestore_tpu_torch.data.transforms import infer_transform

    dev = predictor.device
    rows = []
    for identity in sorted(p for p in Path(data_root).glob("*") if p.is_dir()):
        degraded_p, gt_p = identity / "degraded.png", identity / "gt.png"
        if not degraded_p.exists():
            continue
        conds = [_open_rgb(p) for p in sorted((identity / "conditioning").glob("*"))][:4]
        if not conds:
            continue
        pred_pil, attn = predictor.predict(_open_rgb(degraded_p), conds, return_attention=True)
        pred = infer_transform(pred_pil, resolution)
        row: Dict[str, Any] = {"identity": identity.name, "attention_pct": attn}
        if gt_p.exists():
            gt = infer_transform(_open_rgb(gt_p), resolution)
            row["psnr_vs_gt"] = _psnr(pred, gt)
            row["l2_vs_gt"] = float(np.mean((pred - gt) ** 2))
            e = _arcface_embed(arcface, np.stack([pred, gt]), dev)
            row["id_cosine_vs_gt"] = float(np.dot(e[0], e[1]))
        e_refs = _arcface_embed(arcface, np.stack([infer_transform(c, resolution)
                                                   for c in conds]), dev)
        e_pred = _arcface_embed(arcface, pred[None], dev)[0]
        mean_ref = e_refs.mean(axis=0)
        mean_ref /= max(np.linalg.norm(mean_ref), 1e-12)
        row["id_cosine_vs_refs"] = float(np.dot(e_pred, mean_ref))
        rows.append(row)
        print(json.dumps(row))
        if limit and len(rows) >= limit:
            break
    agg_keys = ["psnr_vs_gt", "id_cosine_vs_gt", "id_cosine_vs_refs"]
    return {
        "mode": "gradio",
        "arcface_weights": arc_src,
        "n_identities": len(rows),
        "aggregate": {k: float(np.mean([r[k] for r in rows if k in r]))
                      for k in agg_keys if any(k in r for r in rows)},
        "per_identity": rows,
    }


def cmd_gradio(args, statics=None) -> Dict[str, Any]:
    from instantrestore_tpu_torch.convert import tree_to
    from instantrestore_tpu_torch.training.losses import id_loss as id_mod
    from instantrestore_tpu_torch.utils.torch_convert import torch_load

    predictor = _predictor(args, statics)
    if args.arcface:
        arcface = id_mod.convert_arcface_params(torch_load(args.arcface))
        arc_src = "converted"
    else:
        arcface = id_mod.init_arcface_params(torch.Generator().manual_seed(0))
        arc_src = "random"
    return gradio_report(predictor, args.data, tree_to(arcface, predictor.device),
                         predictor.resolution, arc_src=arc_src)


def _canonical_torch_key(key: str) -> str:
    """A peft-decorated key in the names the port's writer emits:
    ``base_layer`` dropped, any LoRA adapter name ``default``."""
    parts, out, i = key.split("."), [], 0
    while i < len(parts):
        p = parts[i]
        if p == "base_layer":
            i += 1
            continue
        if p in ("lora_A", "lora_B") and i + 2 < len(parts):
            out.extend([p, "default", parts[i + 2]])
            i += 3
            continue
        out.append(p)
        i += 1
    return ".".join(out)


def _leaf_paths(tree, prefix=""):
    """(path, leaf) of a tree, paths as the JAX script writes them
    (``a.b[0].c``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def strict_group_check(group_sd, template_tree=None) -> Dict[str, Any]:
    """The converter check of one network's state dict: every weight and
    bias key survives state dict -> tree -> state dict unchanged (unmapped
    keys and drift fail), and the tree's leaves cover a template's (missing
    leaves fail; extra ones are reported)."""
    from instantrestore_tpu_torch.convert import state_dict, tree_from_state_dict

    tree = tree_from_state_dict(group_sd)
    back = {_canonical_torch_key(k): v for k, v in state_dict(tree).items()}
    expected = {_canonical_torch_key(k): v for k, v in group_sd.items()
                if k.split(".")[-1] in ("weight", "bias")}
    unmapped = sorted(set(expected) - set(back))
    roundtrip_maxabs, drifted = 0.0, []
    for k, v in expected.items():
        if k in back:
            d = float((back[k].double() - v.double()).abs().max()) if v.numel() else 0.0
            roundtrip_maxabs = max(roundtrip_maxabs, d)
            if d > 1e-6:
                drifted.append({"key": k, "maxabs": d})
    missing, extra = [], []
    if template_tree is not None:
        got = {p for p, _ in _leaf_paths(tree)}
        want = {p for p, _ in _leaf_paths(template_tree)}
        missing, extra = sorted(want - got), sorted(got - want)
    return {"n_torch_tensors": len(group_sd), "unmapped_keys": unmapped,
            "roundtrip_maxabs": roundtrip_maxabs, "drifted_keys": drifted,
            "missing_template_leaves": missing, "extra_template_leaves": extra,
            "ok": not unmapped and not drifted and not missing}


def templates(statics=None, text_tree=None) -> Dict[str, Any]:
    """Freshly initialised trees to hold a file's leaves against: the UNet
    and VAE with LoRA (only the paths are compared, so the rank is any),
    the frozen capture networks and the text encoder, at ``statics``'s
    widths (SD-Turbo's by default; a given ``statics`` takes the text
    encoder's widths from ``text_tree``)."""
    from instantrestore_tpu_torch.models.restorer import (
        RestorerStatics,
        init_restorer_params,
        original_unet_view,
        original_vae_view,
    )
    from instantrestore_tpu_torch.models.text_encoder import (
        CLIPTextConfig,
        infer_text_config,
        init_text_encoder_params,
    )

    gen = torch.Generator().manual_seed(0)
    bundle = init_restorer_params(gen, statics or RestorerStatics(), lora_rank_unet=4,
                                  lora_rank_vae=4)
    text_cfg = (infer_text_config(text_tree) if statics is not None and text_tree is not None
                else CLIPTextConfig())
    return {"unet": bundle["unet"], "vae": bundle["vae"],
            "original_unet": original_unet_view(bundle),
            "original_vae": original_vae_view(bundle),
            "text_encoder": init_text_encoder_params(gen, text_cfg)}


def cmd_convert_diff(args, statics=None) -> Dict[str, Any]:
    """Per network, the golden diff of the reference -> tree conversion."""
    from instantrestore_tpu_torch.convert import tree_from_state_dict
    from instantrestore_tpu_torch.utils.torch_convert import split_full_checkpoint, torch_load

    raw = torch_load(args.pt)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    groups = split_full_checkpoint({k: v for k, v in sd.items() if hasattr(v, "shape")})
    tmpl = {}
    if args.strict and args.template:
        text = (tree_from_state_dict(groups["text_encoder"]) if "text_encoder" in groups
                else None)
        tmpl = templates(statics, text)
    report: Dict[str, Any] = {"mode": "convert-diff", "pt": str(args.pt),
                              "strict": bool(args.strict), "groups": {}}
    failed = []
    for net, group_sd in groups.items():
        out_leaves = dict(_leaf_paths(tree_from_state_dict(group_sd)))
        stats, torch_mass = [], 0.0
        for key, t in sorted(group_sd.items()):
            a = t.detach().cpu().double()
            torch_mass += float(a.abs().sum())
            stats.append({"torch_key": key, "shape": list(a.shape),
                          "mean": float(a.mean()) if a.numel() else 0.0,
                          "std": float(a.std(unbiased=False)) if a.numel() else 0.0,
                          "absmax": float(a.abs().max()) if a.numel() else 0.0,
                          "finite": bool(torch.isfinite(a).all())})
        ours_mass = sum(float(v.detach().cpu().double().abs().sum())
                        for v in out_leaves.values())
        g = report["groups"][net] = {
            "n_torch_tensors": len(group_sd),
            "n_converted_leaves": len(out_leaves),
            # the conversion renames only: the total |.| mass must match
            "abs_mass_torch": torch_mass,
            "abs_mass_converted": ours_mass,
            "abs_mass_rel_err": abs(torch_mass - ours_mass) / max(torch_mass, 1e-12),
            "tensors": stats if args.verbose else stats[:8],
        }
        if args.strict:
            check = g["strict"] = strict_group_check(group_sd, tmpl.get(net))
            if not check["ok"]:
                failed.append(net)
            print(f"{net} strict: unmapped={len(check['unmapped_keys'])} "
                  f"drifted={len(check['drifted_keys'])} "
                  f"missing={len(check['missing_template_leaves'])} "
                  f"-> {'OK' if check['ok'] else 'FAIL'}")
        print(f"{net}: {len(group_sd)} torch tensors -> {len(out_leaves)} leaves, "
              f"mass rel err {g['abs_mass_rel_err']:.2e}")
    report["ok"] = not failed
    if args.strict and failed:
        report["failed_groups"] = failed
        print(f"STRICT CONVERT-DIFF FAILED for groups: {failed}")
    return report


def _inputs(predictor, args):
    """The prepared input [1, res, res, 3] and references [1, N, res, res, 3]
    (numpy, [-1, 1]) and the valid count."""
    img = _open_rgb(args.input)
    refs = _refs(args.refs)
    image = predictor.prepare_image(img, predictor.resolution)[None]
    conds, _ = predictor.prepare_conditioning_images(refs, resolution=predictor.resolution)
    return img, refs, image, conds


def dump_activations(predictor, image: np.ndarray, conds: np.ndarray,
                     noise: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, np.ndarray]:
    """The JAX script's dump: every tap of ``restore_forward(debug_taps=True)``
    (the latent's mode, t = the Predictor's, unfused attention, the noise
    from a generator seeded as the Predictor's unless given) plus
    ``output_image``, ``input_image`` and ``conds``, as fp32 arrays."""
    from instantrestore_tpu_torch.models.restorer import restore_forward

    dev = predictor.device
    gen = torch.Generator(device=dev).manual_seed(predictor._seed)
    with torch.no_grad():
        out = restore_forward(
            predictor.params, torch.as_tensor(image).to(dev), torch.as_tensor(conds)[None].to(dev),
            torch.full((1,), conds.shape[0], device=dev), statics=predictor.statics,
            timestep=predictor.noise_timestep, sample_posterior=False, generator=gen,
            noise=noise, debug_taps=True, use_fused_attention=False)
    taps = {k: v.float().cpu().numpy() for k, v in out["taps"].items()}
    taps["output_image"] = out["output_image"].float().cpu().numpy()
    taps["input_image"] = np.asarray(image, np.float32)
    taps["conds"] = np.asarray(conds, np.float32)
    return taps


def cmd_dump_activations(args, statics=None) -> Dict[str, Any]:
    predictor = _predictor(args, statics, torch.float32 if args.fp32 else torch.bfloat16)
    _, _, image, conds = _inputs(predictor, args)
    t0 = time.perf_counter()
    taps = dump_activations(predictor, image, conds)
    seconds = time.perf_counter() - t0
    np.savez(args.dump, **taps)  # uncompressed: zlib takes a minute over a 512 px dump
    print(f"dumped {len(taps)} stages to {args.dump}")
    return {"mode": "dump-activations", "dump": str(args.dump), "stages": sorted(taps),
            "stage_absmax": {k: float(np.abs(v).max()) for k, v in taps.items()},
            "seconds": seconds}


def drawn_noise(predictor, n_refs: int) -> Dict[str, torch.Tensor]:
    """The noise a deterministic Predictor's forward draws from its seeded
    generator, in ``restore_forward``'s order: the references' diffusion
    noise [N, h, w, 4], then the input's [1, h, w, 4] (fp32)."""
    lat = predictor.resolution // 2 ** (len(predictor.statics.vae_cfg.block_out_channels) - 1)
    gen = torch.Generator(device=predictor.device).manual_seed(predictor._seed)
    out = {}
    if predictor.statics.use_shared_attention:
        out["cond_diffusion"] = torch.randn((n_refs, lat, lat, 4), generator=gen,
                                            device=predictor.device)
    out["diffusion"] = torch.randn((1, lat, lat, 4), generator=gen, device=predictor.device)
    return out


def cmd_determinism(args, statics=None) -> Dict[str, Any]:
    predictor = _predictor(args, statics)
    img, refs, image, conds = _inputs(predictor, args)
    out1, _ = predictor.predict(img, refs)
    out2, _ = predictor.predict(img, refs)
    a1, a2 = np.asarray(out1, np.float32), np.asarray(out2, np.float32)
    maxabs = float(np.abs(a1 - a2).max())
    report: Dict[str, Any] = {"mode": "determinism", "repeat_maxabs_uint8": maxabs,
                              "deterministic": maxabs == 0.0}
    if args.dump:
        noise = drawn_noise(predictor, conds.shape[0])
        again, _ = predictor.predict(img, refs, noise=noise)
        # the dumped noise is the noise the two predictions drew
        report["dump_noise_reproduces_output"] = bool(np.array_equal(np.asarray(again), a1))
        np.savez(args.dump, image=image, conds=conds, output=a1,
                 timestep=predictor.noise_timestep,
                 **{("noise" if k == "diffusion" else f"noise_{k}"): v.float().cpu().numpy()
                    for k, v in noise.items()})
        report["dump"] = str(args.dump)
    return report


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def predictor_args(p, out):
        p.add_argument("--checkpoint", required=True)
        p.add_argument("--resolution", type=int, default=512)
        p.add_argument("--base_weights_dir", default=None,
                       help="sd-turbo/sd-vae base weights for LoRA-only checkpoints")
        p.add_argument("--tokenizer_dir", default=None)
        p.add_argument("--device", default="cuda")
        p.add_argument("--out", default=out)

    g = sub.add_parser("gradio")
    predictor_args(g, "parity_gradio.json")
    g.add_argument("--data", required=True, help="<id>/{degraded.png, gt.png, conditioning/*}")
    g.add_argument("--arcface", default=None, help="ArcFace model_ir_se50.pth")

    c = sub.add_parser("convert-diff")
    c.add_argument("--pt", required=True)
    c.add_argument("--verbose", action="store_true")
    c.add_argument("--strict", action="store_true",
                   help="exit 1 on unmapped keys, round-trip drift or missing template leaves")
    c.add_argument("--template", action="store_true", default=True,
                   help="compare against freshly initialised trees")
    c.add_argument("--no-template", dest="template", action="store_false")
    c.add_argument("--out", default="parity_convert.json")

    da = sub.add_parser("dump-activations")
    predictor_args(da, "parity_activations.json")
    da.add_argument("--input", required=True)
    da.add_argument("--refs", required=True)
    da.add_argument("--fp32", action="store_true")
    da.add_argument("--dump", default="activations.npz")

    d = sub.add_parser("determinism")
    predictor_args(d, "parity_determinism.json")
    d.add_argument("--input", required=True)
    d.add_argument("--refs", required=True)
    d.add_argument("--dump", default=None)
    return ap


def main(argv=None, statics=None) -> int:
    """``statics`` overrides the checkpoint's own (tiny test models) and sets
    the template's widths. Returns 1 when ``convert-diff --strict`` fails."""
    args = _parser().parse_args(argv)
    report = {"gradio": cmd_gradio, "convert-diff": cmd_convert_diff,
              "determinism": cmd_determinism,
              "dump-activations": cmd_dump_activations}[args.cmd](args, statics)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(f"wrote {args.out}")
    return 1 if args.cmd == "convert-diff" and args.strict and not report["ok"] else 0


if __name__ == "__main__":
    sys.exit(main())
