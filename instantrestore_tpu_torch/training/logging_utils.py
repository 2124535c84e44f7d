"""The trainer's logger (counterpart of
``instantrestore_tpu/training/logging_utils.py``): messages to stderr and
``logs/log.txt``, the config as ``config.yaml``, metric lines, tensorboardX
scalars where that package imports, and image grids under
``logs/<title>/step_<n>.jpg``.

PIL and yaml are imported only in the methods that write images or the
config; without Pillow the grids are skipped, without yaml the config is
written as JSON.
"""

from __future__ import annotations

import datetime
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Dict

import numpy as np


class CoachLogger:
    def __init__(self, exp_dir, use_tensorboard: bool = True, primary: bool = True):
        """``primary=False`` (a process other than the first of a
        multi-process run) makes every method a no-op that touches no file."""
        self.primary = primary
        self.exp_dir = Path(exp_dir)
        self.log_dir = self.exp_dir / "logs"
        self.step = 0
        self.tb = None
        if not primary:
            return
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.log_file = self.log_dir / "log.txt"
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self.tb = SummaryWriter(logdir=str(self.log_dir / "tb"))
            except Exception:
                self.tb = None

    def update_step(self, step: int):
        self.step = step

    def log_message(self, msg: str):
        if not self.primary:
            return
        stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        line = f"[{stamp}] step {self.step}: {msg}"
        print(line, file=sys.stderr)
        with open(self.log_file, "a") as f:
            f.write(line + "\n")

    def log_metrics(self, metrics: Dict[str, Any], prefix: str = "train"):
        """One line of the scalar metrics (floats, 0-d arrays or tensors)."""
        if not self.primary:
            return
        flat = {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0}
        self.log_message(f"{prefix}: " + ", ".join(f"{k}={v:.5f}" for k, v in flat.items()))
        if self.tb is not None:
            for k, v in flat.items():
                self.tb.add_scalar(f"{prefix}/{k}", v, self.step)

    def log_config(self, cfg_dict: Dict[str, Any]):
        """``config.yaml``: yaml's dump, or where yaml does not import, the
        same dict as JSON (which YAML reads)."""
        if not self.primary:
            return
        try:
            import yaml
        except ImportError:
            text = json.dumps(cfg_dict, indent=2) + "\n"
        else:
            text = yaml.safe_dump(cfg_dict)
        (self.exp_dir / "config.yaml").write_text(text)

    def can_write_images(self) -> bool:
        """Pillow imports (image grids are skipped, with one message, where
        it does not)."""
        ok = importlib.util.find_spec("PIL") is not None
        if not ok and not getattr(self, "_told_no_pil", False):
            self._told_no_pil = True
            self.log_message("Pillow does not import: image grids are not written")
        return ok

    def vis_batch(self, title: str, images: Dict[str, np.ndarray], max_rows: int = 4):
        """Save the named [B, H, W, 3] images in [-1, 1] side by side, one
        row per sample (up to ``max_rows``), to logs/<title>/step_<n>.jpg."""
        if not self.primary or not self.can_write_images():
            return
        from PIL import Image

        cols = []
        rows = min(max_rows, next(iter(images.values())).shape[0])
        for arr in images.values():
            arr = np.asarray(arr[:rows], np.float32)
            if arr.ndim == 5:  # [B, N, H, W, C] reference strips
                arr = arr.reshape(-1, *arr.shape[2:])[:rows]
            cols.append(np.concatenate(list(arr), axis=0))
        grid = np.concatenate(cols, axis=1)
        grid = ((np.clip(grid, -1, 1) + 1) / 2 * 255).astype(np.uint8)
        out_dir = self.log_dir / title
        out_dir.mkdir(parents=True, exist_ok=True)
        Image.fromarray(grid).save(out_dir / f"step_{self.step:07d}.jpg", quality=92)

    def save_image(self, title: str, image):
        """Save a PIL image under logs/<title>/."""
        if not self.primary:
            return
        out_dir = self.log_dir / title
        out_dir.mkdir(parents=True, exist_ok=True)
        image.save(out_dir / f"step_{self.step:07d}.jpg", quality=92)

    def close(self):
        if self.tb is not None:
            self.tb.close()
