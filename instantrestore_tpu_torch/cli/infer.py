"""Restore every identity folder under ``--data_root`` with the Predictor
(counterpart of ``scripts/infer.py``, the reference's per-image loop).

    python -m instantrestore_tpu_torch.cli.infer --checkpoint ckpt.pt --data_root DIR \
        [--results_dir results] [--max_refs 4] [--device cuda]

Each ``<data_root>/<identity>/`` holds ``degraded.png`` and
``conditioning/*``; the result goes to ``<results_dir>/<identity>.png``. A
LoRA-only checkpoint finds its base weights through
$INSTANTRESTORE_BASE_WEIGHTS, the tokenizer files through
$INSTANTRESTORE_TOKENIZER_DIR (or the base folder's ``tokenizer/``).
"""

from __future__ import annotations

import argparse
import sys

from instantrestore_tpu_torch.inference.predictor import Predictor


def main(argv=None, statics=None) -> int:
    """``statics`` overrides the checkpoint's own (tiny test models)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--results_dir", default="results")
    ap.add_argument("--max_refs", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    Predictor(args.checkpoint, statics=statics, device=args.device).run_directory(
        args.data_root, args.results_dir, max_refs=args.max_refs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
