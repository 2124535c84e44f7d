"""LoRA attach/merge/strip, the FaceID projections and the trainable mask
over port param trees (counterpart of ``instantrestore_tpu/models/lora.py``),
with the reference's target lists. Trainables of the generator: the LoRA
leaves everywhere, plus the modules named in ``extra_trainable`` (the UNet's
``conv_in``, the VAE's skip convs). As in the JAX package, the FaceID leaves
are not among them.

Factors use peft's layouts: linear A [r, in], B [out, r]; conv A
[r, in, kh, kw], B [out, r, 1, 1]."""

from __future__ import annotations

from typing import Any, Sequence

import torch

from instantrestore_tpu_torch.ops.primitives import add_lora, init_dense

UNET_LORA_TARGETS = (
    "to_k", "to_q", "to_v", "to_out.0", "conv", "conv1", "conv2",
    "conv_shortcut", "conv_out", "proj_in", "proj_out", "ff.net.2",
    "ff.net.0.proj",
)
VAE_LORA_TARGETS = (
    "conv1", "conv2", "conv_in", "conv_shortcut", "conv", "conv_out",
    "to_k", "to_q", "to_v", "to_out.0",
)
VAE_SHORTCUT_TARGETS = VAE_LORA_TARGETS + (
    "skip_conv_1", "skip_conv_2", "skip_conv_3", "skip_conv_4",
)

_TORCH_NAMES = {"net_0_proj": "net.0.proj", "net_2": "net.2", "to_out": "to_out.0"}


def _matches(name: str, targets: Sequence[str]) -> bool:
    """peft's rule: the dotted name equals a target or ends with ``.<target>``."""
    return any(name == t or name.endswith("." + t) for t in targets)


def _child(name: str, key) -> str:
    key = _TORCH_NAMES.get(key, str(key))
    return f"{name}.{key}" if name else key


def attach_lora(params: Any, gen, rank: int, targets, *, b_std: float, device=None) -> Any:
    """Copy of ``params`` with LoRA factors on every module whose dotted
    diffusers name matches a target."""

    def walk(node, name):
        if isinstance(node, dict):
            if "weight" in node and node["weight"].ndim >= 2:
                if _matches(name, targets) and "lora_A" not in node:
                    return add_lora(node, gen, rank, b_std=b_std, device=device)
                return node
            return {k: walk(v, _child(name, k)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, _child(name, i)) for i, v in enumerate(node)]
        return node

    return walk(params, "")


def trainable_mask(params: Any, *, extra_trainable: Sequence[str] = ()) -> Any:
    """Tree of bools shaped like ``params``: True for the LoRA leaves and for
    every leaf of a module whose dotted name matches ``extra_trainable``
    (``("conv_in",)`` for the UNet)."""

    def walk(node, name):
        if isinstance(node, dict):
            full = _matches(name, extra_trainable)
            return {k: True if k in ("lora_A", "lora_B")
                    else walk(v, _child(name, k)) if isinstance(v, (dict, list)) else full
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, _child(name, i)) for i, v in enumerate(node)]
        return _matches(name, extra_trainable)

    return walk(params, "")


def count_lora_params(params: Any) -> int:
    """Number of elements in the LoRA leaves of a tree."""
    if isinstance(params, dict):
        return sum(v.numel() if k in ("lora_A", "lora_B") else count_lora_params(v)
                   for k, v in params.items())
    if isinstance(params, list):
        return sum(count_lora_params(v) for v in params)
    return 0


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


def attach_faceid(params: Any, gen, *, cross_dim: int = 1024, embed_dim: int = 512,
                  device=None) -> Any:
    """Copy of a UNet tree with the FaceID projections on every
    cross-attention (``attn2``): ``face_projection`` (``embed_dim`` ->
    ``cross_dim``, with a bias) and the bias-free ``to_k_face_embed`` /
    ``to_v_face_embed`` (``cross_dim`` -> the attention's width)."""

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "attn2" and isinstance(v, dict) and "to_q" in v:
                    hidden = v["to_q"]["weight"].shape[0]
                    out[k] = dict(v, face_projection=init_dense(gen, embed_dim, cross_dim,
                                                                device=device),
                                  to_k_face_embed=init_dense(gen, cross_dim, hidden, bias=False,
                                                             device=device),
                                  to_v_face_embed=init_dense(gen, cross_dim, hidden, bias=False,
                                                             device=device))
                else:
                    out[k] = walk(v)
            return out
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)
