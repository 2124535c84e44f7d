"""The reference's two ``.pt`` schemas <-> the port's parameter trees
(counterpart of ``instantrestore_tpu/utils/torch_convert.py``).

1. FULL, as the reference trainer writes it: ``{"state_dict": ..., "cfg":
   ...}`` with ``net.`` / ``module.`` prefixes over ``unet``, ``vae``,
   ``original_unet``, ``original_vae`` and ``text_encoder``; a module with
   LoRA appears as ``*.base_layer.weight`` beside
   ``*.lora_A.<adapter>.weight``.
2. LoRA-only: ``{rank_unet, rank_vae, unet_lora_target_modules,
   vae_lora_target_modules, state_dict_unet, state_dict_vae}``, laid over
   base sd-turbo / sd-vae weights.

A reference file is already in PyTorch's layout, so no leaf is transposed:
names go through ``convert.tree_from_state_dict`` and ``convert.state_dict``,
the port's one name mapping. Files are read with ``weights_only=True`` and
memory-mapped, and every tensor keeps the file's dtype until the caller
moves the tree to its device.

The reference quirk kept for parity: loading a LoRA-only file, the reference
rebuilds its LoraConfig without ``lora_alpha``, so peft's default alpha of 8
applies and the scaling is 8 / rank (0.25 at the shipped rank 32), not the
rank / 2 of training (``lora_scaling_for_loaded``).
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Mapping, Optional

import torch

from instantrestore_tpu_torch.convert import state_dict, tree_from_state_dict
from instantrestore_tpu_torch.models.lora import UNET_LORA_TARGETS, VAE_LORA_TARGETS

NETWORKS = ("original_unet", "original_vae", "text_encoder", "unet", "vae")


def lora_scaling_for_loaded(rank: int) -> float:
    """The LoRA scaling of a loaded LoRA-only file (module docstring)."""
    return 8.0 / float(rank)


def torch_load(path) -> Any:
    """``torch.load`` of a checkpoint file onto the CPU, memory-mapped, with
    ``weights_only=True``. A file that needs more than that (pickled
    objects of other classes) raises; it is never unpickled in full."""
    try:
        return torch.load(str(path), map_location="cpu", weights_only=True, mmap=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path} needs more than torch.load(weights_only=True) to read (it pickles "
            "objects other than tensors, containers and numbers); the port does not unpickle "
            f"arbitrary objects. Re-save its tensors and plain-dict cfg. ({e})") from e


def split_full_checkpoint(sd: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """A FULL state dict -> one flat dict a network, with the ``net.`` /
    ``module.`` prefixes stripped."""
    groups: Dict[str, Dict[str, Any]] = {}
    for key, v in sd.items():
        k = key
        for prefix in ("net.", "module."):
            while k.startswith(prefix):
                k = k[len(prefix):]
        for net in NETWORKS:
            if k.startswith(net + "."):
                groups.setdefault(net, {})[k[len(net) + 1:]] = v
                break
    return groups


def convert_full_checkpoint(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A FULL state dict -> {unet, vae, original_unet, original_vae,
    text_encoder} trees (those present)."""
    return {net: tree_from_state_dict(part) for net, part in split_full_checkpoint(sd).items()}


def apply_lora_only_checkpoint(base_tree: Any, overlay: Any) -> Any:
    """Lay a LoRA-only overlay tree (LoRA leaves, the UNet's conv_in, the
    VAE's skip convs) over a base tree. An overlay's int-keyed dict is a
    sparse set of list indices."""
    if isinstance(overlay, dict):
        if isinstance(base_tree, list):
            out = list(base_tree)
            for k, v in overlay.items():
                idx = int(k)
                if idx >= len(out):
                    out.extend({} for _ in range(idx + 1 - len(out)))
                out[idx] = apply_lora_only_checkpoint(out[idx], v)
            return out
        out = dict(base_tree) if isinstance(base_tree, dict) else {}
        for k, v in overlay.items():
            out[k] = apply_lora_only_checkpoint(out.get(k), v)
        return out
    if isinstance(overlay, list):
        base = base_tree if isinstance(base_tree, list) else [None] * len(overlay)
        return [apply_lora_only_checkpoint(b, o) for b, o in zip(base, overlay)]
    return overlay


def load_torch_checkpoint(path) -> Dict[str, Any]:
    """A reference ``.pt`` -> {"format": "full" | "lora_only", "params",
    "meta"}; the LoRA-only meta carries the load-time scalings."""
    raw = torch_load(path)
    if "state_dict" in raw:
        return {"format": "full", "params": convert_full_checkpoint(raw["state_dict"]),
                "meta": {"cfg": raw.get("cfg")}}
    if "state_dict_unet" in raw:
        return {
            "format": "lora_only",
            "params": {
                "unet_overlay": tree_from_state_dict(raw["state_dict_unet"]),
                "vae_overlay": tree_from_state_dict(raw.get("state_dict_vae") or {}),
            },
            "meta": {
                "rank_unet": raw.get("rank_unet"),
                "rank_vae": raw.get("rank_vae"),
                "unet_lora_target_modules": raw.get("unet_lora_target_modules"),
                "vae_lora_target_modules": raw.get("vae_lora_target_modules"),
                "unet_lora_scaling": lora_scaling_for_loaded(raw.get("rank_unet") or 8),
                "vae_lora_scaling": lora_scaling_for_loaded(raw.get("rank_vae") or 4),
            },
        }
    raise ValueError(f"{path}: unrecognized checkpoint schema (keys {sorted(raw)[:8]})")


def _peft_names(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A module with LoRA factors keeps its own weight and bias under
    ``base_layer``, as peft's wrapper names them."""
    suffix = ".lora_A.default.weight"
    wrapped = {k[: -len(suffix)] for k in sd if k.endswith(suffix)}
    out = {}
    for k, v in sd.items():
        module, _, leaf = k.rpartition(".")
        out[f"{module}.base_layer.{leaf}" if module in wrapped else k] = v
    return out


def export_full_checkpoint(nets: Dict[str, Any], path, *, cfg: Optional[Dict[str, Any]] = None
                           ) -> None:
    """Write a FULL ``.pt`` as the reference trainer does: every network of
    ``nets`` (``unet``, ``vae``, ``original_unet``, ``original_vae``,
    ``text_encoder``) under ``net.<name>.`` with peft's names, and ``cfg``
    (a plain dict) beside it. Tensors are written in their own dtype."""
    sd: Dict[str, torch.Tensor] = {}
    for name, tree in nets.items():
        sd.update(_peft_names(state_dict(tree, prefix=f"net.{name}.")))
    torch.save({"state_dict": sd, "cfg": cfg}, str(path))


def export_lora_only_checkpoint(params: Dict[str, Any], path, *, rank_unet: int,
                                rank_vae: int) -> None:
    """Write a LoRA-only ``.pt`` as the reference's ``save_model`` does: the
    LoRA leaves and the UNet's conv_in, the VAE's LoRA leaves and skip
    convs, under peft's names."""
    def keep(sd, words):
        return {k: v.detach().to("cpu").contiguous() for k, v in sd.items()
                if any(w in k for w in words)}

    torch.save({
        "unet_lora_target_modules": list(UNET_LORA_TARGETS),
        "vae_lora_target_modules": list(VAE_LORA_TARGETS),
        "rank_unet": rank_unet,
        "rank_vae": rank_vae,
        "state_dict_unet": keep(state_dict(params["unet"]), ("lora", "conv_in")),
        "state_dict_vae": keep(state_dict(params["vae"]), ("lora", "skip")),
    }, str(path))
