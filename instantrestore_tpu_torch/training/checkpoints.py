"""Checkpoints: the port's own file, and the reference's ``.pt`` files made
servable (counterpart of ``instantrestore_tpu/training/checkpoints.py``).

The port's own checkpoint is one ``torch.save`` file of ``{"params",
"step", "cfg"}`` (the cfg as a plain dict, ``encode_config``), plus what the
trainer adds (``training/coach.py``: the discriminator's heads, and in a
full checkpoint both optimizers' moments, counts and accumulation buffers,
and the best validation loss). The JAX package's orbax checkpoints are not
read: orbax imports JAX.

A reference ``.pt`` becomes a restorer bundle through
``import_reference_checkpoint``. Where its files are found, unless the
caller says:
  INSTANTRESTORE_BASE_WEIGHTS   a diffusers-layout folder of the base
                                sd-turbo unet / text_encoder / tokenizer and
                                the sd-vae-ft-mse vae, for LoRA-only files
  INSTANTRESTORE_TOKENIZER_DIR  a folder of CLIP's vocab.json and merges.txt,
                                to embed the fixed prompt
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from instantrestore_tpu_torch.configs.config import encode_config
from instantrestore_tpu_torch.convert import tree_from_state_dict, tree_to
from instantrestore_tpu_torch.models.text_encoder import PROMPT, encode_prompt, infer_text_config
from instantrestore_tpu_torch.models.tokenizer import load_tokenizer
from instantrestore_tpu_torch.utils import safetensors
from instantrestore_tpu_torch.utils.torch_convert import (
    apply_lora_only_checkpoint,
    load_torch_checkpoint,
    torch_load,
)

BASE_WEIGHTS_ENV = "INSTANTRESTORE_BASE_WEIGHTS"
TOKENIZER_DIR_ENV = "INSTANTRESTORE_TOKENIZER_DIR"


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def save_checkpoint(path, params: Dict[str, Any], *, cfg=None, step: Optional[int] = None,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Write the port's own checkpoint: ``params`` (moved to the CPU),
    ``step``, ``cfg`` (a config dataclass, stored as a plain dict) and the
    entries of ``extra`` (trees of tensors, numbers and strings; their
    tensors moved to the CPU). The file is written beside ``path`` and moved
    over it, so a crash never leaves half a checkpoint. In a multi-process
    run rank 0 alone writes (``Coach.save``) and the others wait at a
    barrier until the file is whole; every rank reads it to resume."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {k: _to_cpu(v) for k, v in (extra or {}).items()}
    payload.update({"params": _to_cpu(params), "step": step,
                    "cfg": None if cfg is None else encode_config(cfg)})
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, str(tmp))
    os.replace(tmp, path)


def load_checkpoint(path) -> Dict[str, Any]:
    """Read the port's own checkpoint: {"params", "step", "cfg"} and any
    entries the trainer added."""
    raw = torch_load(path)
    if "params" not in raw:
        raise ValueError(f"{path} is not a checkpoint of the port (no 'params' entry)")
    return {**raw, "step": raw.get("step"), "cfg": raw.get("cfg")}


def _load_weight_file(path: Path) -> Dict[str, torch.Tensor]:
    """One weights file -> a flat state dict in the file's dtype."""
    if path.suffix == ".safetensors":
        return safetensors.load_file(path)
    raw = torch_load(path)
    return raw.get("state_dict", raw)


def _find_weight_files(root: Path, subfolder: str) -> List[Path]:
    """One network's files in a diffusers-layout folder: the
    ``<root>/<subfolder>/*.safetensors`` (else ``*.bin``), whose shards
    merge, or one ``<root>/<subfolder>.safetensors|.bin|.pt|.pth``."""
    sub = root / subfolder
    if sub.is_dir():
        files = sorted(sub.glob("*.safetensors")) or sorted(sub.glob("*.bin"))
        if files:
            return files
    for suffix in (".safetensors", ".bin", ".pt", ".pth"):
        flat = root / f"{subfolder}{suffix}"
        if flat.is_file():
            return [flat]
    return []


def load_base_weights(base_dir) -> Dict[str, Any]:
    """A folder of the base weights a LoRA-only file is laid over, in the
    diffusers layout::

        <base_dir>/unet/diffusion_pytorch_model.safetensors
        <base_dir>/vae/diffusion_pytorch_model.safetensors
        <base_dir>/text_encoder/model.safetensors
        <base_dir>/tokenizer/{vocab.json, merges.txt}

    (``.bin`` files and a flat ``<base_dir>/unet.safetensors`` are taken
    too) -> {"unet", "vae", "text_encoder" (or None), "tokenizer_dir" (or
    None)}."""
    root = Path(base_dir)
    if not root.is_dir():
        raise FileNotFoundError(
            f"base weights directory not found: {base_dir} — assemble the "
            "stabilityai/sd-turbo (unet/, text_encoder/, tokenizer/) and "
            "stabilityai/sd-vae-ft-mse (as vae/) snapshots there, or set "
            f"${BASE_WEIGHTS_ENV}"
        )
    out: Dict[str, Any] = {}
    for net in ("unet", "vae", "text_encoder"):
        files = _find_weight_files(root, net)
        if not files:
            if net == "text_encoder":
                out[net] = None
                continue
            raise FileNotFoundError(
                f"no {net} weights under {base_dir} (looked for "
                f"{net}/*.safetensors|*.bin and {net}.safetensors)"
            )
        sd: Dict[str, torch.Tensor] = {}
        for f in files:
            sd.update(_load_weight_file(f))
        out[net] = tree_from_state_dict(sd)
    tok = root / "tokenizer"
    out["tokenizer_dir"] = str(tok) if (tok / "vocab.json").exists() else None
    return out


def build_caption_enc(text_encoder_params: Dict[str, Any], *, tokenizer_dir: Optional[str] = None,
                      prompt_ids=None, device=None) -> torch.Tensor:
    """The fixed prompt's embedding ``caption_enc`` [1, 77, D], fp32 on
    ``device`` (default: the CPU), the text tower run in fp32. Token ids come
    from ``prompt_ids`` when given, else from the BPE files in
    ``tokenizer_dir`` or $INSTANTRESTORE_TOKENIZER_DIR."""
    cfg = infer_text_config(text_encoder_params)
    if prompt_ids is None:
        tok = load_tokenizer(tokenizer_dir or os.environ.get(TOKENIZER_DIR_ENV))
        if tok is None:
            raise FileNotFoundError(
                "cannot build the fixed-prompt embedding (caption_enc): no "
                "tokenizer files. Point tokenizer_dir= (or "
                f"${TOKENIZER_DIR_ENV}) at a directory containing the CLIP "
                "vocab.json + merges.txt that ship with stabilityai/sd-turbo "
                "(tokenizer subfolder), or pass prompt_ids= with the 77 "
                "precomputed token ids of the fixed prompt."
            )
        prompt_ids = tok(PROMPT, max_length=cfg.max_position_embeddings)
    with torch.no_grad():
        return encode_prompt(tree_to(text_encoder_params, device, torch.float32), prompt_ids,
                             cfg=cfg)


def import_reference_checkpoint(pt_path, *, base_weights_dir: Optional[str] = None,
                                tokenizer_dir: Optional[str] = None, prompt_ids=None,
                                device=None) -> Dict[str, Any]:
    """A reference ``.pt`` (either schema) -> {"bundle", "meta"}: a restorer
    bundle in the file's dtype on the CPU, with ``caption_enc`` computed on
    ``device``.

    FULL: the four networks and the text encoder of the file, the frozen
    capture UNet's conv_in as ``unet_orig_conv_in``. LoRA-only: the overlay
    laid over the base weights of ``base_weights_dir`` (or
    $INSTANTRESTORE_BASE_WEIGHTS); the frozen capture branch keeps the pure
    base weights (its LoRA view strips the overlay's LoRA leaves, and
    ``unet_orig_conv_in`` is the base conv_in, not the overlay's trained
    one). ``meta`` carries the LoRA-only file's load-time scalings."""
    loaded = load_torch_checkpoint(pt_path)
    if loaded["format"] == "full":
        nets = loaded["params"]
        bundle = {"unet": nets["unet"], "vae": nets["vae"]}
        if "original_unet" in nets:
            bundle["original_unet"] = nets["original_unet"]
            # its own copy: the original's conv_in is trainable with
            # train_reference_networks, and the step updates in place
            bundle["unet_orig_conv_in"] = {k: v.clone()
                                           for k, v in nets["original_unet"]["conv_in"].items()}
        if "original_vae" in nets:
            bundle["original_vae"] = nets["original_vae"]
        if "text_encoder" in nets:
            bundle["text_encoder"] = nets["text_encoder"]
            bundle["caption_enc"] = build_caption_enc(
                nets["text_encoder"], tokenizer_dir=tokenizer_dir, prompt_ids=prompt_ids,
                device=device)
        return {"bundle": bundle, "meta": loaded["meta"]}

    base_weights_dir = base_weights_dir or os.environ.get(BASE_WEIGHTS_ENV)
    if base_weights_dir is None:
        raise FileNotFoundError(
            f"{pt_path} is a LoRA-only checkpoint; it must be composed onto "
            "base sd-turbo/sd-vae weights (the reference downloads these "
            "from HF at load time, pix2pix_turbo.py:28-58). Pass "
            f"base_weights_dir= or set ${BASE_WEIGHTS_ENV} to a diffusers-"
            "layout directory (see load_base_weights)."
        )
    base = load_base_weights(base_weights_dir)
    if base["text_encoder"] is None:
        raise FileNotFoundError(
            f"no text_encoder weights under {base_weights_dir}; they are "
            "required to build the fixed-prompt embedding (caption_enc, "
            "pix2pix_turbo.py:100-106)"
        )
    overlay = loaded["params"]
    bundle = {
        "unet": apply_lora_only_checkpoint(base["unet"], overlay["unet_overlay"]),
        "vae": apply_lora_only_checkpoint(base["vae"], overlay["vae_overlay"]),
        "unet_orig_conv_in": dict(base["unet"]["conv_in"]),
        "text_encoder": base["text_encoder"],
        "caption_enc": build_caption_enc(
            base["text_encoder"], tokenizer_dir=tokenizer_dir or base["tokenizer_dir"],
            prompt_ids=prompt_ids, device=device),
    }
    return {"bundle": bundle, "meta": loaded["meta"]}
