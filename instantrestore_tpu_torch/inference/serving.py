"""Batched serving on one GPU (counterpart of
``instantrestore_tpu/inference/serving.py``).

Warm path: identities are onboarded once; their reference images go through
the frozen VAE and UNet, and the 9 shared layers' reference K/V land in a
cache. A restore then runs one VAE encode, one UNet whose shared attentions
read that cache, and one VAE decode. With ``identity_cache`` (by default on
for the fused attention of a refs-only model, ``train_input=False``, unless
``INSTANTRESTORE_IDENT_CACHE`` is set to anything but ``1``, as in the JAX
engine) the cache holds each layer's AdaIN statistics and key-norm bounds
too and is read by identity id (the ``shared_identity`` kernel, no gather
copy). Otherwise it is a plain ``[(k, v) x 9]`` list of ``[I, N, H, S, d]``
leaves: each restore gathers its rows and takes the per-call shared
attention (``shared_flash_bound``, with its input segment for
``train_input`` models, which attend to the input image's own K/V as well,
what the identity cache does not model).

Cold path: ``restore_cold`` re-encodes each request's references in the call
(the reference implementation's own flow).

Differences from the JAX engine: onboarding is a Python loop over
identities (no ``lax.map``), there is no mesh, and a restore draws its batch
noise from one ``torch.Generator`` (or takes it through ``noise``) instead of
per-row PRNG keys.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import torch

from instantrestore_tpu_torch import resolve_device
from instantrestore_tpu_torch.convert import tree_to
from instantrestore_tpu_torch.models import scheduler as sched
from instantrestore_tpu_torch.models.restorer import (
    RestorerStatics,
    get_conditioning_kv,
    restore_forward,
)
from instantrestore_tpu_torch.ops.image_ops import preprocess
from instantrestore_tpu_torch.ops.shared_attention import IdentityRef, build_identity_kv_cache


def _maybe_preprocess(images: torch.Tensor, resolution: int) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> [-1, 1] at the model resolution; float inputs
    are taken as [-1, 1] and resized/cropped only when off-size."""
    if images.dtype == torch.uint8:
        return preprocess(images.float() / 255.0, resolution)
    if images.shape[1] != resolution or images.shape[2] != resolution:
        return preprocess(images.float() * 0.5 + 0.5, resolution)
    return images


class ServingEngine:
    """Batched restoration, warm (identity-cached) and cold.

        eng = ServingEngine(params, statics)             # on cuda
        eng.onboard(identity_refs)                       # [I, N, H, W, 3] once
        out = eng.restore(images, identity_ids)          # [B, H, W, 3], [B]
        out = eng.restore_cold(images, cond_images)      # refs [B, N, H, W, 3]

    ``params`` is a bundle (``serving_bundle`` output or a training bundle);
    it is moved to ``device`` in ``statics.compute_dtype``. ``timestep`` is
    the diffusion step of every restore; ``resolution`` the pixel size
    inputs are resized and cropped to (default: the model's, the latent grid
    times the VAE's downsampling). ``identity_cache`` None takes the JAX
    engine's default: ``use_fused_attention and not statics.train_input``
    and ``INSTANTRESTORE_IDENT_CACHE`` unset or ``1``.
    """

    def __init__(
        self,
        params: Dict[str, Any],
        statics: RestorerStatics,
        *,
        device=None,
        use_fused_attention: bool = True,
        timestep: int = 249,
        resolution: Optional[int] = None,
        identity_cache: Optional[bool] = None,
    ):
        self.device = resolve_device(device)
        self.statics = statics
        self.params = tree_to(params, self.device, statics.compute_dtype)
        self.use_fused_attention = use_fused_attention
        self.timestep = timestep
        if resolution is None:
            resolution = statics.unet_cfg.sample_size * 2 ** (
                len(statics.vae_cfg.block_out_channels) - 1)
        self.resolution = resolution
        self.abar = sched.make_alphas_cumprod(device=self.device)
        if identity_cache is None:
            # the identity cache is refs-only: train_input models keep (k, v) rows
            identity_cache = (use_fused_attention and not statics.train_input
                              and os.environ.get("INSTANTRESTORE_IDENT_CACHE", "1") == "1")
        self.identity_cache = identity_cache
        self.kv_cache: Optional[List[Any]] = None

    def _refs_kv(self, refs: torch.Tensor, generator, noise):
        """One identity's references [N, H, W, 3] -> 9 (k, v) [N, H, S, d]."""
        n = refs.shape[0]
        refs = _maybe_preprocess(refs.to(self.device), self.resolution)
        kv, _ = get_conditioning_kv(
            self.params, refs[None], torch.full((1,), n, device=self.device),
            statics=self.statics, alphas_cumprod=self.abar, generator=generator,
            noise=noise, use_fused_attention=self.use_fused_attention,
        )
        return [(k[0], v[0]) for k, v in kv]

    @torch.no_grad()
    def onboard(self, identity_refs: torch.Tensor, *, generator: Optional[torch.Generator] = None,
                noise: Optional[Dict[str, torch.Tensor]] = None) -> List[Any]:
        """identity_refs [I, N, H, W, 3] (uint8, or float in [-1, 1]) -> the
        warm cache: 9 ``IdentityKVCache`` layers, or (k, v) [I, N, H, S, d]
        pairs without ``identity_cache``. I fixes the capacity; ``onboard_one``
        replaces rows. ``noise`` may give ``latent``/``diffusion``
        [I, N, h, w, 4]."""
        n_ident = identity_refs.shape[0]
        rows: Optional[List[List[torch.Tensor]]] = None
        for i in range(n_ident):
            kv = self._refs_kv(identity_refs[i], generator,
                               None if noise is None else {k: v[i] for k, v in noise.items()})
            if rows is None:
                rows = [[k.new_empty((n_ident, *k.shape)), v.new_empty((n_ident, *v.shape))]
                        for k, v in kv]
            for (rk, rv), (k, v) in zip(rows, kv):
                rk[i], rv[i] = k, v
        self.kv_cache = (build_identity_kv_cache(rows) if self.identity_cache
                         else [(k, v) for k, v in rows])
        return self.kv_cache

    @torch.no_grad()
    def onboard_one(self, identity_refs: torch.Tensor, slot: int, *,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[Dict[str, torch.Tensor]] = None) -> List[Any]:
        """Onboard or replace one identity ([N, H, W, 3]) in row ``slot`` of
        the cache, in place; other rows are untouched."""
        if self.kv_cache is None:
            raise RuntimeError("call onboard() first")
        capacity = self._capacity()
        if not 0 <= int(slot) < capacity:
            raise ValueError(f"slot {slot} out of range for a cache of {capacity} identities")
        kv = self._refs_kv(identity_refs, generator, noise)
        if not self.identity_cache:
            for (rk, rv), (k, v) in zip(self.kv_cache, kv):
                rk[slot], rv[slot] = k, v
            return self.kv_cache
        new = build_identity_kv_cache([(k[None], v[None]) for k, v in kv])
        for cur, one in zip(self.kv_cache, new):
            for field in ("rk", "rv", "content_mean", "content_std", "kmax"):
                getattr(cur, field)[slot] = getattr(one, field)[0]
        return self.kv_cache

    def _capacity(self) -> int:
        first = self.kv_cache[0]
        return (first.rk if self.identity_cache else first[0]).shape[0]

    @torch.no_grad()
    def restore(self, images: torch.Tensor, identity_ids, *,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Warm restore: images [B, H, W, 3] (uint8, or float in [-1, 1]) of
        identities ``identity_ids`` [B] -> [B, res, res, 3] in [-1, 1].
        ``noise`` may give ``latent``/``diffusion`` [B, h, w, 4]."""
        if self.kv_cache is None:
            raise RuntimeError("call onboard() first")
        ids = torch.as_tensor(identity_ids)
        if ids.device.type == "cpu":
            capacity = self._capacity()
            if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= capacity):
                raise ValueError(f"identity ids outside [0, {capacity})")
        ids = ids.to(device=self.device, dtype=torch.long)
        images = _maybe_preprocess(images.to(self.device), self.resolution)
        if self.identity_cache:
            ref_kv = [IdentityRef(c, ids) for c in self.kv_cache]
        else:  # gather each sample's identity K/V: [I, N, H, S, d] -> [B, N, H, S, d]
            ref_kv = [(k[ids], v[ids]) for k, v in self.kv_cache]
        out = restore_forward(
            self.params, images, statics=self.statics, timestep=self.timestep,
            precomputed_ref_kv=ref_kv, generator=generator, noise=noise,
            use_fused_attention=self.use_fused_attention,
        )
        return out["output_image"]

    @torch.no_grad()
    def restore_cold(self, images: torch.Tensor, cond_images: torch.Tensor, *,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Cold restore: images [B, H, W, 3] with their references
        cond_images [B, N, H, W, 3] (each uint8, or float in [-1, 1]),
        re-encoded in this call -> [B, res, res, 3] in [-1, 1]. ``noise``
        may give ``latent``/``diffusion`` [B, h, w, 4] and
        ``cond_latent``/``cond_diffusion`` [B*N, h, w, 4]."""
        images = _maybe_preprocess(images.to(self.device), self.resolution)
        b, n = cond_images.shape[:2]
        res = self.resolution
        conds = _maybe_preprocess(cond_images.to(self.device).reshape(b * n, *cond_images.shape[2:]),
                                  res).reshape(b, n, res, res, 3)
        out = restore_forward(
            self.params, images, conds, statics=self.statics, timestep=self.timestep,
            generator=generator, noise=noise, use_fused_attention=self.use_fused_attention,
        )
        return out["output_image"]
