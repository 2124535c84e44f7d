"""Seeded weights for a layout tree (``gpubench/reference/layout.py``), made
on the device in one draw.

One ``torch.randn`` over a flat fp32 buffer with a ``torch.Generator`` on
the device, then each leaf is a view of it, scaled in place by its kind:

- ``weight``: std 1 / sqrt(3 fan_in), the spread of PyTorch's default
  uniform(+-1 / sqrt(fan_in)) initialisation, times the leaf's ``gain``
  (every attention's queries and keys: ``layout.QK_GAIN``);
- ``bias``: the same spread;
- ``norm_weight``: 1 + 0.1 N(0, 1); ``norm_bias``: 0.1 N(0, 1), so that a
  norm's affine is not the identity;
- ``lora_A``: std 1 / rank (peft's gaussian init);
- ``lora_B``: std such that the merged delta ``scaling * B @ A`` has a fifth
  of the base weight's spread, as a trained adapter moves its weights (a
  zero B, peft's start, would make the adapter invisible);
- ``embedding``: N(0, 1).

The same seed on the same device gives the same tensors, so the plain
reference rebuilds the exact weights the program was handed.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from gpubench.reference.layout import Leaf, leaves

LORA_DELTA_SHARE = 0.2  # merged LoRA delta spread / base weight spread


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for draw ``stream`` of run ``seed`` (any
    non-negative integer; streams keep the run's draws apart)."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % 2**63)


def _scale(leaf: Leaf, lora_scaling: float) -> float:
    if leaf.kind == "weight":
        return leaf.gain / math.sqrt(3.0 * leaf.fan_in)
    if leaf.kind == "bias":
        return 1.0 / math.sqrt(3.0 * leaf.fan_in)
    if leaf.kind in ("norm_weight", "norm_bias"):
        return 0.1
    if leaf.kind == "lora_A":
        return 1.0 / leaf.rank
    if leaf.kind == "lora_B":
        # std(s B A) = s sqrt(r) std(B) / r  ->  LORA_DELTA_SHARE * std(W)
        w_std = leaf.gain / math.sqrt(3.0 * leaf.fan_in)
        return LORA_DELTA_SHARE * w_std * math.sqrt(leaf.rank) / lora_scaling
    if leaf.kind == "embedding":
        return 1.0
    raise ValueError(f"unknown leaf kind {leaf.kind!r}")


def materialize(layout: Any, seed: int, device, *, lora_scaling: float, stream: int = 0) -> Any:
    """The layout's tensors (fp32, views of one buffer) drawn from ``seed``."""
    specs = leaves(layout)
    total = sum(math.prod(s.shape) for s in specs)
    flat = torch.randn(total, generator=generator(seed, device, stream), device=device)
    offsets: Dict[int, int] = {}
    pos = 0
    for s in specs:
        offsets[id(s)] = pos
        pos += math.prod(s.shape)

    with torch.no_grad():
        def fill(node):
            if isinstance(node, Leaf):
                off = offsets[id(node)]
                t = flat[off:off + math.prod(node.shape)].view(node.shape)
                t.mul_(_scale(node, lora_scaling))
                if node.kind == "norm_weight":
                    t.add_(1.0)
                return t
            if isinstance(node, dict):
                return {k: fill(v) for k, v in node.items()}
            return [fill(v) for v in node]

        return fill(layout)
