"""Predictor: the single and batch inference surface (counterpart of
``instantrestore_tpu/inference/predictor.py``, the reference's test.py /
gradio demo).

Preprocess with LANCZOS resize, center crop and [-1, 1] normalisation, run
one cold restore forward at timestep 249 against up to 4 references
(missing ones padded by flipped copies), and optionally report the
per-reference attention-mass percentages summed over the UNet's shared layers
(``UNetConfig.num_shared_attn_layers``).

Weights come as a parameter bundle (``params``) or from a checkpoint
(``checkpoint_path``): a reference ``.pt`` of either schema, or the port's own
file (``load_predictor_params``). A FaceID model (``condition_on_face_embeds``)
conditions on face embeddings of the references: given to ``predict`` /
``predict_batch`` as ``face_embeds``, or computed by ``face_embed_provider``
(any callable from a reference image to a 512-d embedding or None, e.g. a
wrapped insightface ``FaceAnalysis``; the port tries no default). Without
either it raises rather than fall back to the prompt.

Randomness comes from a ``torch.Generator`` seeded with ``seed``; ``predict``
and ``predict_batch`` also take ready-made ``noise`` as ``restore_forward``
does. PIL is imported only where images are read or written.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from instantrestore_tpu_torch import resolve_device
from instantrestore_tpu_torch.configs.config import ModelConfig, _decode_section
from instantrestore_tpu_torch.convert import tree_to
from instantrestore_tpu_torch.data.transforms import denormalize_pm1, infer_transform
from instantrestore_tpu_torch.models.restorer import RestorerStatics, restore_forward
from instantrestore_tpu_torch.training.checkpoints import (
    import_reference_checkpoint,
    load_checkpoint,
)
from instantrestore_tpu_torch.utils.torch_convert import torch_load


def attention_mass_percentages(attn_probs: Sequence[Optional[torch.Tensor]], n_refs: int = 4,
                               train_input: bool = False) -> List[float]:
    """Per-reference mean attention mass summed over the shared layers'
    probabilities [B, h, Sq, Skv], normalised to percentages (rounded to 3
    decimals, the last one taking the remainder). With ``train_input`` the
    first segment is the input image and is skipped. Layers without
    probabilities (None) are skipped."""
    means = np.zeros(n_refs)
    offset = 1 if train_input else 0
    for probs in attn_probs:
        if probs is None:
            continue
        probs = torch.as_tensor(probs)
        q = probs.shape[2]
        for ref_idx in range(n_refs):
            seg = probs[:, :, :, q * (ref_idx + offset): q * (ref_idx + offset + 1)]
            means[ref_idx] += float(seg.float().mean())
    total = means.sum()
    normalized = [round(float(m / total) * 100, 3) for m in means]
    normalized[-1] = round(100 - sum(normalized[:-1]), 3)
    return normalized


class Predictor:
    """Holds the weights on the device and restores many images.

    ``params`` is a parameter bundle (``init_restorer_params`` or
    ``serving_bundle`` output, or a converted JAX tree); without it the
    weights and, unless ``statics`` is given, the statics come from
    ``checkpoint_path`` (``load_predictor_params``, with
    ``base_weights_dir``, ``tokenizer_dir`` and ``prompt_ids``). The bundle
    is moved to ``device`` (CUDA unless asked otherwise) in ``dtype``.
    ``resolution`` is the pixel size inputs are resized and cropped to
    (default: the model's, 512 for SD-Turbo).
    ``deterministic`` takes the latent's mode instead of sampling it and
    reseeds the noise with ``seed`` on every ``predict``.
    ``face_embed_provider``: the FaceID model's embedder (module docstring)."""

    def __init__(
        self,
        checkpoint_path: Optional[str] = None,
        *,
        params: Optional[Dict[str, Any]] = None,
        statics: Optional[RestorerStatics] = None,
        noise_timestep: int = 249,
        dtype=torch.bfloat16,
        use_fused_attention: Optional[bool] = None,
        seed: int = 0,
        resolution: Optional[int] = None,
        deterministic: bool = False,
        device=None,
        base_weights_dir: Optional[str] = None,
        tokenizer_dir: Optional[str] = None,
        prompt_ids=None,
        face_embed_provider: Optional[Callable[[Any], Any]] = None,
    ):
        self.device = resolve_device(device)
        if params is None:
            if checkpoint_path is None:
                raise ValueError("need checkpoint_path or params")
            params, statics = load_predictor_params(
                checkpoint_path, statics, base_weights_dir=base_weights_dir,
                tokenizer_dir=tokenizer_dir, prompt_ids=prompt_ids, device=self.device)
        self.statics = statics or RestorerStatics()
        self.face_embed_provider = face_embed_provider
        # the frozen text tower never runs at inference; caption_enc suffices
        params = {k: v for k, v in params.items() if k != "text_encoder"}
        self.params = tree_to(params, self.device, dtype)
        self.noise_timestep = noise_timestep
        if resolution is None:  # the model's: the latent grid times the VAE's downsampling
            resolution = self.statics.unet_cfg.sample_size * 2 ** (
                len(self.statics.vae_cfg.block_out_channels) - 1)
        self.resolution = resolution
        self.deterministic = deterministic
        self._seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if use_fused_attention is None:
            use_fused_attention = self.device.type == "cuda"
        self._fused = use_fused_attention

    @torch.no_grad()
    def _fwd(self, image, conds, valid, generator, save_attn: bool, noise, face_embeds=None):
        if self.statics.condition_on_face_embeds:
            if face_embeds is None:
                raise ValueError("a FaceID model (condition_on_face_embeds) needs face_embeds= "
                                 "or a Predictor(face_embed_provider=)")
            face_embeds = torch.as_tensor(face_embeds).to(self.device, torch.float32)
        return restore_forward(
            self.params, image, conds, valid, statics=self.statics, face_embeds=face_embeds,
            timestep=self.noise_timestep, save_attn_probs=save_attn,
            sample_posterior=not self.deterministic, generator=generator, noise=noise,
            use_fused_attention=self._fused and not save_attn,
        )

    def compute_face_embeds(self, cond_imgs, max_refs: int = 4) -> np.ndarray:
        """[max_refs, 512] face embeddings of the first ``max_refs``
        references by the provider: zeros where it finds no face (returns
        None), the given ones repeated to fill ``max_refs``, all zeros with
        no references."""
        if self.face_embed_provider is None:
            raise ValueError("no face_embed_provider: pass face_embeds= to predict() or a "
                             "Predictor(face_embed_provider=)")
        embeds = []
        for im in cond_imgs[:max_refs]:
            e = self.face_embed_provider(im)
            embeds.append(np.zeros(512, np.float32) if e is None else np.asarray(e, np.float32))
        if not embeds:
            return np.zeros((max_refs, 512), np.float32)
        n = len(embeds)
        embeds += [embeds[i % n] for i in range(max_refs - n)]
        return np.stack(embeds)

    # -- preprocessing --------------------------------------------------

    @staticmethod
    def prepare_image(img, resolution: int = 512) -> np.ndarray:
        return infer_transform(img, resolution)

    def prepare_conditioning_images(self, cond_imgs, max_refs: int = 4,
                                    resolution: int = 512) -> Tuple[np.ndarray, int]:
        """Up to ``max_refs`` references [N, res, res, 3]; missing ones are
        copies of the given ones, every other copy flipped left-right."""
        refs = [self.prepare_image(im, resolution) for im in cond_imgs[:max_refs]]
        n_valid = len(refs)
        for i in range(max_refs - n_valid):
            refs.append(refs[i % n_valid][:, ::-1] if i % 2 == 0 else refs[i % n_valid])
        return np.stack(refs), n_valid

    # -- prediction -----------------------------------------------------

    def predict(self, input_img, cond_imgs, *, return_attention: bool = False,
                noise: Optional[Dict[str, torch.Tensor]] = None, face_embeds=None):
        """One restoration of a PIL image against PIL references. Returns
        (PIL image, attention percentages or None). A FaceID model reads
        ``face_embeds`` [M, 512], by default ``compute_face_embeds(cond_imgs)``."""
        from PIL import Image

        image = torch.from_numpy(self.prepare_image(input_img, self.resolution))[None]
        conds, _ = self.prepare_conditioning_images(cond_imgs, resolution=self.resolution)
        # padded references count as valid, as in the reference Predictor
        valid = torch.full((1,), conds.shape[0], device=self.device)
        generator = (torch.Generator(device=self.device).manual_seed(self._seed)
                     if self.deterministic else self.generator)
        if self.statics.condition_on_face_embeds and face_embeds is None:
            face_embeds = self.compute_face_embeds(cond_imgs)
        out = self._fwd(image.to(self.device), torch.from_numpy(conds)[None].to(self.device),
                        valid, generator, return_attention, noise,
                        None if face_embeds is None else torch.as_tensor(face_embeds)[None])
        pred = out["output_image"][0].float().cpu().numpy()
        pil = Image.fromarray((denormalize_pm1(pred) * 255).astype(np.uint8))
        attn = None
        if return_attention:
            attn = attention_mass_percentages(out["attn_probs"], n_refs=conds.shape[0],
                                              train_input=self.statics.train_input)
        return pil, attn

    def predict_batch(self, images, conds, valid=None, *,
                      noise: Optional[Dict[str, torch.Tensor]] = None,
                      face_embeds=None) -> np.ndarray:
        """Array in, array out: images [B, res, res, 3] and conds
        [B, N, res, res, 3] in [-1, 1] (numpy or tensors) -> [B, res, res, 3]
        float32 numpy in [-1, 1]. A FaceID model reads ``face_embeds``
        [B, M, 512]."""
        images = torch.as_tensor(images).to(self.device)
        conds = torch.as_tensor(conds).to(self.device)
        if valid is None:
            valid = torch.full((images.shape[0],), conds.shape[1])
        out = self._fwd(images, conds, torch.as_tensor(valid).to(self.device), self.generator,
                        False, noise, face_embeds)
        return out["output_image"].float().cpu().numpy()

    def run_directory(self, data_root: str, results_dir: str = "results", max_refs: int = 4):
        """For each identity directory under ``data_root`` holding
        ``degraded.png`` and ``conditioning/*``, write
        ``results_dir/<identity>.png``."""
        from PIL import Image

        out_dir = Path(results_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for identity in sorted(p for p in Path(data_root).glob("*") if p.is_dir()):
            degraded = identity / "degraded.png"
            if not degraded.exists():
                continue
            conds = [Image.open(p).convert("RGB")
                     for p in sorted((identity / "conditioning").glob("*"))][:max_refs]
            pred, _ = self.predict(Image.open(degraded).convert("RGB"), conds)
            pred.save(out_dir / f"{identity.name}.png")


def _statics_from_cfg(cfg: Optional[Dict[str, Any]]) -> RestorerStatics:
    """RestorerStatics from a checkpoint's embedded config dict (its
    ``model`` section; defaults where absent)."""
    model = _decode_section(ModelConfig, (cfg or {}).get("model", {}))
    return RestorerStatics.from_model_config(model)


def load_predictor_params(checkpoint_path, statics: Optional[RestorerStatics], *,
                          base_weights_dir: Optional[str] = None,
                          tokenizer_dir: Optional[str] = None, prompt_ids=None, device=None):
    """A checkpoint file -> (bundle, statics), the bundle in the file's dtype
    on the CPU and its ``caption_enc`` computed on ``device``.

    A FULL reference ``.pt`` and the port's own file decode their statics
    from their embedded cfg unless ``statics`` is given. A LoRA-only ``.pt``
    carries no cfg (the defaults or ``statics`` apply), but its LoRA
    scalings are always the file's ranks under peft's load-time alpha of 8,
    since the file, not a config, decides them."""
    path = Path(checkpoint_path)
    if path.is_dir():
        raise ValueError(
            f"{path} is a directory: the port reads a reference .pt or its own torch.save file, "
            "not the JAX package's orbax checkpoints (ROADMAP.md Queue 1)")
    if "params" in torch_load(path):  # the port's own file
        loaded = load_checkpoint(path)
        return loaded["params"], statics or _statics_from_cfg(loaded["cfg"])
    imported = import_reference_checkpoint(path, base_weights_dir=base_weights_dir,
                                           tokenizer_dir=tokenizer_dir, prompt_ids=prompt_ids,
                                           device=device)
    meta = imported["meta"]
    if statics is None:
        statics = _statics_from_cfg(meta.get("cfg"))
    if "unet_lora_scaling" in meta:  # a LoRA-only file
        statics = dataclasses.replace(statics, unet_lora_scaling=meta["unet_lora_scaling"],
                                      vae_lora_scaling=meta["vae_lora_scaling"])
    return imported["bundle"], statics
