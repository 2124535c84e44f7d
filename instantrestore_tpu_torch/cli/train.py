"""Train with the Coach (counterpart of ``scripts/train.py``).

    python -m instantrestore_tpu_torch.cli.train --config_path X.yaml \
        [section.field=value ...] [--device cuda|cuda:N|cpu]

The config is the YAML file (yaml is needed only to read it) with the dotted
overrides laid over it, as in the JAX script; without ``--config_path`` the
defaults and the overrides alone. One process trains on one card (``cuda``,
the default) or on the CPU (``--device cpu``).

Data-parallel over N cards, one process each, the global
``compute.batch_size`` split evenly over them:

    torchrun --nproc_per_node=N -m instantrestore_tpu_torch.cli.train ...

or, on each process, as the JAX script takes it,

    python -m instantrestore_tpu_torch.cli.train --multihost \
        --coordinator_address HOST:PORT --num_processes N --process_id I ...

Under ``torchrun`` (``WORLD_SIZE`` > 1) or with ``--multihost`` the process
group is joined first (NCCL, gloo with ``--device cpu``) on this process's
card, which is made the current one: ``--device cuda:N`` if given, else
``cuda:LOCAL_RANK`` under torchrun, else the process id modulo the visible
cards.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def main(argv=None, statics=None, **coach_kw) -> int:
    """``statics`` and ``coach_kw`` (``params=``, ``vit_cfg=``, ...) go to
    the Coach (tiny test models)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config_path", type=str, default=None)
    ap.add_argument("--multihost", action="store_true",
                    help="join a multi-process run (the coordinator flags, or torchrun's "
                         "environment)")
    ap.add_argument("--coordinator_address", type=str, default=None)
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu; in a multi-process run cuda "
                         "means this process's card (module docstring)")
    args, overrides = ap.parse_known_args(argv)

    from instantrestore_tpu_torch.configs.config import load_config
    from instantrestore_tpu_torch.parallel import distributed as pdist
    from instantrestore_tpu_torch.training.coach import Coach

    device = args.device
    joined = args.multihost or int(os.environ.get("WORLD_SIZE", "1")) > 1
    if joined:
        card = torch.device(device) if device not in (None, "cpu") else None
        pdist.init_distributed(args.coordinator_address, args.num_processes, args.process_id,
                               local_device_ids=None if card is None or card.index is None
                               else [card.index],
                               backend="gloo" if device == "cpu" else None)
        if device != "cpu":
            device = pdist.local_device()
            torch.cuda.set_device(device)
    try:
        cfg = load_config(args.config_path, overrides)
        Coach(cfg, statics=statics, device=device or "cuda", **coach_kw).train()
    finally:
        if joined:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
