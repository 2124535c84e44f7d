"""Train with the Coach (counterpart of ``scripts/train.py``).

    python -m instantrestore_tpu_torch.cli.train --config_path X.yaml \
        [section.field=value ...] [--device cuda|cpu]

The config is the YAML file (yaml is needed only to read it) with the dotted
overrides laid over it, as in the JAX script; without ``--config_path`` the
defaults and the overrides alone. One process trains on one card (``cuda``,
the default) or on the CPU (``--device cpu``). ``--multihost`` and its
rendezvous flags are accepted as the JAX script's, and raise: DDP over the
trainable leaves is ROADMAP Queue 1 item 1e.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None, statics=None, **coach_kw) -> int:
    """``statics`` and ``coach_kw`` (``params=``, ``vit_cfg=``, ...) go to
    the Coach (tiny test models)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config_path", type=str, default=None)
    ap.add_argument("--multihost", action="store_true",
                    help="a multi-process run (not ported yet: raises)")
    ap.add_argument("--coordinator_address", type=str, default=None)
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args, overrides = ap.parse_known_args(argv)
    if args.multihost:
        raise NotImplementedError("--multihost: multi-process training is not ported yet (DDP "
                                  "over the trainable leaves is ROADMAP Queue 1 item 1e)")

    from instantrestore_tpu_torch.configs.config import load_config
    from instantrestore_tpu_torch.training.coach import Coach

    cfg = load_config(args.config_path, overrides)
    Coach(cfg, statics=statics, device=args.device, **coach_kw).train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
