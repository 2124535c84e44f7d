"""The work of a serving cell, counted from the configuration's shapes.

- ``model_flops``: FLOPs of one face's restore, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` over the plain reference on
  the ``meta`` device (every conv, matmul and attention product once; LoRA
  taken as merged, as it is served; norms and elementwise work not counted).
- ``attention_calls``: the attention calls of a batch (kind and shapes), as
  the reference makes them on ``meta``.
- ``least_seconds``: an attention call's least time on the chip, the larger
  of its matmul FLOPs (4 B H Sq Skv d) over the bf16 peak and its bytes (q,
  k, v and the output once each, bf16) over the HBM peak. Warm shared calls
  read the cached K/V of each distinct identity once.

Imports torch and the reference only.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench.reference import layout, model

PEAKS = Path(__file__).resolve().parent / "peaks.json"
BF16_BYTES = 2


def peaks_for(kind: str) -> Optional[Dict[str, float]]:
    """The published peaks of the card named ``kind`` (None if the table
    does not know it)."""
    for entry in json.loads(PEAKS.read_text())["cards"]:
        if entry["match"] in kind:
            return entry
    return None


def _meta_tree(tree: Any) -> Any:
    """A layout as meta tensors, without its LoRA leaves (merged shapes)."""
    if isinstance(tree, layout.Leaf):
        return torch.empty(tree.shape, device="meta")
    if isinstance(tree, dict):
        return {k: _meta_tree(v) for k, v in tree.items() if k not in ("lora_A", "lora_B")}
    return [_meta_tree(v) for v in tree]


def _restore(cfg: Dict[str, Any], mode: str, batch: int, measure) -> None:
    """One restore of ``batch`` faces on meta with only the served work
    inside the context ``measure``: ``warm`` from one identity's K/V
    (captured outside it, at onboarding), ``cold`` with the capture of each
    face's references."""
    m = cfg["model"]
    res, n = m["resolution"], m["n_refs"]
    lat = res // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    meta = torch.device("meta")
    ref = model.Restorer(_meta_tree(layout.restorer_layout(cfg)), cfg)
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


def least_seconds(call: Tuple[str, tuple, tuple], peaks: Dict[str, float],
                  kv_rows: Optional[int] = None) -> Tuple[float, float, float]:
    """(least seconds, FLOPs, bytes) of one attention call; ``kv_rows``: the
    number of distinct K/V rows read (warm shared calls), else the batch."""
    _, (b, h, sq, d), (_, _, skv, _) = call
    flops = 4.0 * b * h * sq * skv * d
    nbytes = BF16_BYTES * (2 * b * h * sq * d + 2 * (kv_rows or b) * h * skv * d)
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"]), flops, nbytes
