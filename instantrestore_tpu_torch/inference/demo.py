"""Interactive demo (counterpart of ``instantrestore_tpu/inference/demo.py``,
the reference's gradio_demo.py): a model selector over the released
checkpoints, bundled identity fixtures
(``<data_root>/<identity>/{degraded.png, gt.png, conditioning/*}``), a
restore that returns the prediction and each reference's share of the
attention mass, and a degradation slider over the training degradations.
gradio is imported only by ``launch_gradio``; without it ``Demo.run`` and
the one-shot CLI serve:

    python -m instantrestore_tpu_torch.inference.demo --data_root DIR \
        [--model "Final Model"] [--identity NAME] [--out demo_result.png] [--device cuda]

Pillow is imported where images are read or made.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from instantrestore_tpu_torch.data import degradations as deg
from instantrestore_tpu_torch.data.transforms import center_crop, resize_shorter_side, to_float01
from instantrestore_tpu_torch.inference.predictor import Predictor

DEFAULT_MODELS = {
    "Base Model": "checkpoints/base_ablation_ckpt.pt",
    "AdaIn Model": "checkpoints/adain_ablation_ckpt.pt",
    "Landmark Attn Loss Model": "checkpoints/landmark_attn_loss_ablation_ckpt.pt",
    "Final Model": "checkpoints/final_model_ckpt.pt",
}


def degrade_image(gt_img, deg_level: float, seed: int = 0):
    """A PIL image degraded at the slider's ``deg_level`` in [0, 100] (the
    demo's mapping: blur sigma 0.1..12, downsample 1..13, noise 0..15,
    JPEG quality 99..60) -> a 512 px PIL image."""
    from PIL import Image

    img = center_crop(resize_shorter_side(gt_img, 512), 512)
    params = deg.DegradationParams(
        blur_sigma_x=11.9 * deg_level / 100 + 0.1,
        blur_sigma_y=11.9 * deg_level / 100 + 0.1,
        blur_rotation=0.0,
        downsample_factor=int(12 * deg_level / 100) + 1,
        noise_sigma=15 * deg_level / 100,
        jpeg_quality=99 - int(39 * deg_level / 100),
        noise_seed=seed,
    )
    out = deg.degrade(to_float01(img), params)
    return Image.fromarray((out * 255).astype(np.uint8))


class Demo:
    """The demo's state: the identities under ``data_root`` and the
    Predictor of the selected model (``predictor_kwargs`` go to every
    ``Predictor(...)``: statics, resolution, dtype, tokenizer_dir, device)."""

    def __init__(self, data_root: str, models: Optional[Dict[str, str]] = None,
                 predictor_kwargs: Optional[Dict] = None):
        self.data_root = Path(data_root)
        self.models = models or DEFAULT_MODELS
        self.predictor_kwargs = predictor_kwargs or {}
        self.identities = sorted(p.name for p in self.data_root.glob("*")
                                 if p.is_dir() and (p / "degraded.png").exists())
        self._predictor: Optional[Predictor] = None
        self._current_model: Optional[str] = None

    def select_model(self, name: str) -> None:
        """Load model ``name`` unless it is the one loaded."""
        if name != self._current_model:
            self._predictor = Predictor(self.models[name], **self.predictor_kwargs)
            self._current_model = name

    def load_identity(self, identity: str) -> dict:
        """An identity's degraded image, ground truth (or None) and up to 4
        references, as PIL images."""
        from PIL import Image

        d = self.data_root / identity
        refs = sorted((d / "conditioning").glob("*.png"))[:4]
        return {
            "degraded": Image.open(d / "degraded.png").convert("RGB"),
            "gt": Image.open(d / "gt.png").convert("RGB") if (d / "gt.png").exists() else None,
            "conditioning": [Image.open(p).convert("RGB") for p in refs],
        }

    def run(self, model_name: str, identity: str):
        """(restored PIL image, attention-mass percentage of each reference slot)."""
        self.select_model(model_name)
        data = self.load_identity(identity)
        return self._predictor.predict(data["degraded"], data["conditioning"],
                                       return_attention=True)

    def launch_gradio(self, **kwargs):  # pragma: no cover - needs gradio
        try:
            import gradio as gr
        except ImportError as e:
            raise RuntimeError(
                "gradio is not installed in this environment; use Demo.run() or the CLI "
                "(python -m instantrestore_tpu_torch.inference.demo)") from e
        with gr.Blocks() as ui:
            gr.Markdown("# InstantRestore: personalized face restoration")
            model = gr.Dropdown(list(self.models), value=list(self.models)[0], label="Model")
            ident = gr.Dropdown(self.identities, value=self.identities[0], label="Identity")
            btn = gr.Button("Restore")
            out_img = gr.Image(label="Restored")
            attn_out = gr.JSON(label="Per-reference attention %")
            btn.click(self.run, [model, ident], [out_img, attn_out])
            level = gr.Slider(0, 100, 50, label="Degradation level")
            gt_in = gr.Image(type="pil", label="Clean input")
            deg_out = gr.Image(label="Degraded")
            level.release(lambda l, im: degrade_image(im, l), [level, gt_in], [deg_out])
        return ui.launch(**kwargs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--model", default="Final Model")
    ap.add_argument("--identity", default=None)
    ap.add_argument("--out", default="demo_result.png")
    ap.add_argument("--gradio", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    demo = Demo(args.data_root, predictor_kwargs={"device": args.device})
    if args.gradio:
        demo.launch_gradio()
        return 0
    pred, attn = demo.run(args.model, args.identity or demo.identities[0])
    pred.save(args.out)
    print(f"saved {args.out}; attention mass per reference: {attn}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
