"""LoRA merge/strip over port param trees (counterpart of
``instantrestore_tpu/models/lora.py``), with the reference's target lists.

Factors use peft's layouts: linear A [r, in], B [out, r]; conv A
[r, in, kh, kw], B [out, r, 1, 1]."""

from __future__ import annotations

from typing import Any

import torch

from instantrestore_tpu_torch.ops.primitives import add_lora

UNET_LORA_TARGETS = (
    "to_k", "to_q", "to_v", "to_out.0", "conv", "conv1", "conv2",
    "conv_shortcut", "conv_out", "proj_in", "proj_out", "ff.net.2",
    "ff.net.0.proj",
)
VAE_LORA_TARGETS = (
    "conv1", "conv2", "conv_in", "conv_shortcut", "conv", "conv_out",
    "to_k", "to_q", "to_v", "to_out.0",
)

_TORCH_NAMES = {"net_0_proj": "net.0.proj", "net_2": "net.2", "to_out": "to_out.0"}


def attach_lora(params: Any, gen, rank: int, targets, *, b_std: float, device=None) -> Any:
    """Copy of ``params`` with LoRA factors on every module whose dotted
    diffusers name equals a target or ends with ``.<target>`` (peft's rule)."""

    def matches(name):
        return any(name == t or name.endswith("." + t) for t in targets)

    def walk(node, name):
        if isinstance(node, dict):
            if "weight" in node and node["weight"].ndim >= 2:
                if matches(name) and "lora_A" not in node:
                    return add_lora(node, gen, rank, b_std=b_std, device=device)
                return node
            return {
                k: walk(v, f"{name}.{_TORCH_NAMES.get(k, k)}" if name else _TORCH_NAMES.get(k, k))
                for k, v in node.items()
            }
        if isinstance(node, list):
            return [walk(v, f"{name}.{i}") for i, v in enumerate(node)]
        return node

    return walk(params, "")


def merge_lora(params: Any, scaling: float) -> Any:
    """Fold LoRA into the base weights: linear W += s * B @ A; conv
    W += s * einsum(B[:, :, 0, 0], A) (exact: B is 1x1). Returns a tree
    without LoRA leaves."""
    if isinstance(params, dict):
        if "lora_A" in params and "weight" in params:
            a, b, w = params["lora_A"], params["lora_B"], params["weight"]
            if w.ndim == 4:
                delta = torch.einsum("or,rihw->oihw", b[:, :, 0, 0].float(), a.float())
            else:
                delta = b.float() @ a.float()
            out = {k: v for k, v in params.items() if k not in ("lora_A", "lora_B")}
            out["weight"] = (w.float() + scaling * delta).to(w.dtype)
            return out
        return {k: merge_lora(v, scaling) for k, v in params.items()}
    if isinstance(params, list):
        return [merge_lora(v, scaling) for v in params]
    return params


def strip_lora(params: Any) -> Any:
    """View of the tree without LoRA leaves (the frozen original network);
    shares the tensors."""
    if isinstance(params, dict):
        return {k: strip_lora(v) for k, v in params.items() if k not in ("lora_A", "lora_B")}
    if isinstance(params, list):
        return [strip_lora(v) for v in params]
    return params
