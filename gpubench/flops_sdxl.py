"""The work of a serving cell of ``instantrestore-sdxl-turbo-serve``, counted
as ``gpubench/flops.py`` counts the SD-Turbo cells' but through the SDXL
reference (``gpubench/reference/sdxl.py``) on the ``meta`` device:
``model_flops`` (one face's restore, LoRA taken as merged) and
``attention_calls`` (a batch's attention calls). ``peaks_for`` and
``least_seconds`` are ``flops.py``'s, so the serving driver can take this
module in that one's place (``gpubench/drivers/serve_sdxl.py``).

Imports torch and the reference only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench.flops import _meta_tree, least_seconds, peaks_for  # noqa: F401
from gpubench.reference import model, sdxl


def _restore(cfg: Dict[str, Any], mode: str, batch: int, measure) -> None:
    """``flops._restore`` on the SDXL reference: one restore of ``batch``
    faces on meta with only the served work inside ``measure``."""
    m = cfg["model"]
    res, n = m["resolution"], m["n_refs"]
    lat = res // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    meta = torch.device("meta")
    ref = sdxl.Restorer(_meta_tree(sdxl.restorer_layout(cfg)), cfg)
    images = torch.empty((batch, res, res, 3), dtype=torch.uint8, device=meta)
    noise = torch.empty((batch, lat, lat, 4), device=meta)
    if mode == "warm":
        one = ref.capture(torch.empty((1, n, res, res, 3), dtype=torch.uint8, device=meta),
                          noise[:1].expand(n, -1, -1, -1), noise[:1].expand(n, -1, -1, -1))
        shared = [(k.expand(batch, *k.shape[1:]), v.expand(batch, *v.shape[1:]))
                  for k, v in one]
        with measure:
            ref.restore(images, shared, noise, noise)
        return
    refs = torch.empty((batch, n, res, res, 3), dtype=torch.uint8, device=meta)
    cond_noise = torch.empty((batch * n, lat, lat, 4), device=meta)
    with measure:
        ref.restore(images, ref.capture(refs, cond_noise, cond_noise), noise, noise)


def model_flops(cfg: Dict[str, Any], mode: str) -> float:
    """FLOPs of one face's restore (``warm``: the restore alone; ``cold``:
    its references' capture too)."""
    counter = FlopCounterMode(display=False)
    _restore(cfg, mode, 1, counter)
    return float(counter.get_total_flops())


def attention_calls(cfg: Dict[str, Any], mode: str, batch: int) -> List[Tuple[str, tuple, tuple]]:
    """(kind, q shape, k shape) of every attention call of one batch's restore."""
    calls = model.AttentionRecord()
    _restore(cfg, mode, batch, calls)
    return list(calls)
