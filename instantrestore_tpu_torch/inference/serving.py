"""Batched serving on one GPU or several (counterpart of
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

Several cards (``devices=``, the counterpart of JAX's ``mesh=``): params
and the identity cache are copied to each listed device (a device listed
twice shares its copy). Every draw is made once for the whole batch, from
the caller's generator on its own device in the order a one-device restore
draws (or taken through ``noise``), and each device gets its contiguous rows
of images, identity ids and noise; so the output does not depend on the
number of devices beyond the order of fp sums. A batch must divide by the
device count (``ValueError`` "...divisible..." as in JAX). Each card's
share is issued from a host thread of its own under ``torch.cuda.device``,
so the cards run at once (CPU devices take turns), and the output is
gathered on the first device.
Onboarding splits the identities over the devices when their count divides
by the number of devices (each identity's encode is the one-device one, so
the cache is bit-equal), else it onboards on the first device; the cache is
then copied to every device.

Differences from the JAX engine: onboarding is a Python loop over
identities (no ``lax.map``), and a restore draws its batch noise from one
``torch.Generator`` (or takes it through ``noise``) instead of per-row PRNG
keys.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

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
from instantrestore_tpu_torch.parallel.distributed import local_rows


def _maybe_preprocess(images: torch.Tensor, resolution: int) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> [-1, 1] at the model resolution; float inputs
    are taken as [-1, 1] and resized/cropped only when off-size."""
    if images.dtype == torch.uint8:
        return preprocess(images.float() / 255.0, resolution)
    if images.shape[1] != resolution or images.shape[2] != resolution:
        return preprocess(images.float() * 0.5 + 0.5, resolution)
    return images


def _fields(layer) -> List[torch.Tensor]:
    """An ``IdentityKVCache`` layer's tensors, in field order (not copies)."""
    return [getattr(layer, f.name) for f in dataclasses.fields(layer)]


def _cache_to(cache: List[Any], device: torch.device) -> List[Any]:
    """A warm cache's layers on ``device`` (shared where already there)."""
    return [dataclasses.replace(c, **{f.name: getattr(c, f.name).to(device)
                                      for f in dataclasses.fields(c)})
            if dataclasses.is_dataclass(c) else tuple(t.to(device) for t in c) for c in cache]


def _on(device: torch.device):
    """``device`` the calling thread's current CUDA device (no-op off CUDA)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


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
    and ``INSTANTRESTORE_IDENT_CACHE`` unset or ``1``. ``devices`` (instead
    of ``device``): serve on each of them (the module's docstring).
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
        devices: Optional[List[Any]] = None,
    ):
        if devices is not None and device is not None:
            raise ValueError("pass device= or devices=, not both")
        self.devices = [resolve_device(d) for d in (devices if devices is not None else [device])]
        if not self.devices:
            raise ValueError("devices= is empty")
        self.device = self.devices[0]
        self.statics = statics
        copies: Dict[torch.device, Any] = {}
        for d in self.devices:
            if d not in copies:
                copies[d] = tree_to(params, d, statics.compute_dtype)
        self._replicas = [copies[d] for d in self.devices]
        self.params = self._replicas[0]
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
        self._caches: List[List[Any]] = []  # kv_cache on each of self.devices

    def _set_cache(self, cache: List[Any]) -> None:
        self.kv_cache = cache
        copies = {self.device: cache}
        for d in self.devices:
            if d not in copies:
                copies[d] = _cache_to(cache, d)
        self._caches = [copies[d] for d in self.devices]

    def _latent_side(self) -> int:
        return self.resolution // 2 ** (len(self.statics.vae_cfg.block_out_channels) - 1)

    def _draw(self, names, rows: int, generator) -> Dict[str, torch.Tensor]:
        """Standard-normal latents [rows, l, l, 4] from ``generator`` on its
        device, one per name in order (a one-device forward's draws)."""
        if generator is None:
            raise ValueError("pass noise= or a torch.Generator")
        side = self._latent_side()
        return {k: torch.randn((rows, side, side, 4), generator=generator,
                               device=generator.device) for k in names}

    def _per_device(self, fn: Callable[[int], Any]) -> List[Any]:
        """[fn(j) for each device j] without gradients, each card's from a
        host thread of its own with that card current (CPU "devices" share
        the cores torch already uses, so they take their turns)."""
        def run(j):
            with torch.no_grad(), _on(self.devices[j]):
                return fn(j)

        if self.device.type != "cuda":
            return [run(j) for j in range(len(self.devices))]
        with ThreadPoolExecutor(len(self.devices)) as pool:
            return list(pool.map(run, range(len(self.devices))))

    def _split_batch(self, b: int, noise, fn: Callable[[int, slice, Any], torch.Tensor]
                     ) -> torch.Tensor:
        """``fn(j, rows, noise rows)`` on each device j for its contiguous
        rows of a batch of ``b``; the outputs gathered on the first device."""
        n_dev = len(self.devices)
        if b % n_dev:
            raise ValueError(f"batch {b} must be divisible by the {n_dev} serving devices")
        per = b // n_dev
        outs = self._per_device(lambda j: fn(j, slice(j * per, (j + 1) * per),
                                             local_rows(noise, b, j, n_dev)))
        return torch.cat([o.to(self.device) for o in outs])

    def _refs_kv(self, refs: torch.Tensor, generator, noise, j: int = 0):
        """One identity's references [N, H, W, 3] -> 9 (k, v) [N, H, S, d]
        on device ``j``."""
        n, dev = refs.shape[0], self.devices[j]
        refs = _maybe_preprocess(refs.to(dev), self.resolution)
        kv, _ = get_conditioning_kv(
            self._replicas[j], refs[None], torch.full((1,), n, device=dev),
            statics=self.statics, alphas_cumprod=self.abar.to(dev), generator=generator,
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
        n_ident, n_dev = identity_refs.shape[0], len(self.devices)
        if n_dev > 1 and noise is None:  # each identity's draws, in the one-device order
            n_refs = identity_refs.shape[1]
            draws = [self._draw(("latent", "diffusion"), n_refs, generator)
                     for _ in range(n_ident)]
            noise = {k: torch.stack([d[k] for d in draws]) for k in ("latent", "diffusion")}

        def rows_of(idents, j):
            rows: Optional[List[List[torch.Tensor]]] = None
            for r, i in enumerate(idents):
                kv = self._refs_kv(identity_refs[i], generator,
                                   None if noise is None else {k: v[i] for k, v in noise.items()},
                                   j)
                if rows is None:
                    rows = [[k.new_empty((len(idents), *k.shape)),
                             v.new_empty((len(idents), *v.shape))] for k, v in kv]
                for (rk, rv), (k, v) in zip(rows, kv):
                    rk[r], rv[r] = k, v
            return rows

        if n_dev > 1 and n_ident % n_dev == 0:  # identities split over the devices
            per = n_ident // n_dev
            parts = self._per_device(lambda j: rows_of(range(j * per, (j + 1) * per), j))
            rows = [[torch.cat([p[l][x].to(self.device) for p in parts]) for x in (0, 1)]
                    for l in range(len(parts[0]))]
        else:
            rows = rows_of(range(n_ident), 0)
        self._set_cache(build_identity_kv_cache(rows) if self.identity_cache
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
        if self.identity_cache:
            kv = [[t[0] for t in _fields(one)]
                  for one in build_identity_kv_cache([(k[None], v[None]) for k, v in kv])]
        # the row on each device's cache (one copy per distinct device)
        for cache in {id(c): c for c in self._caches}.values():
            for cur, row in zip(cache, kv):
                for t, r in zip(_fields(cur) if self.identity_cache else cur, row):
                    t[slot].copy_(r)
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

        def rows(j, sel, noise_rows):
            dev = self.devices[j]
            ids_j = ids[sel].to(device=dev, dtype=torch.long)
            if self.identity_cache:
                ref_kv = [IdentityRef(c, ids_j) for c in self._caches[j]]
            else:  # gather each sample's identity K/V: [I, N, H, S, d] -> [B, N, H, S, d]
                ref_kv = [(k[ids_j], v[ids_j]) for k, v in self._caches[j]]
            out = restore_forward(
                self._replicas[j], _maybe_preprocess(images[sel].to(dev), self.resolution),
                statics=self.statics, timestep=self.timestep, precomputed_ref_kv=ref_kv,
                generator=generator, noise=noise_rows,
                use_fused_attention=self.use_fused_attention,
            )
            return out["output_image"]

        b = images.shape[0]
        if len(self.devices) == 1:
            return rows(0, slice(None), noise)
        if noise is None and b % len(self.devices) == 0:
            noise = self._draw(("latent", "diffusion"), b, generator)
        return self._split_batch(b, noise, rows)

    @torch.no_grad()
    def restore_cold(self, images: torch.Tensor, cond_images: torch.Tensor, *,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Cold restore: images [B, H, W, 3] with their references
        cond_images [B, N, H, W, 3] (each uint8, or float in [-1, 1]),
        re-encoded in this call -> [B, res, res, 3] in [-1, 1]. ``noise``
        may give ``latent``/``diffusion`` [B, h, w, 4] and
        ``cond_latent``/``cond_diffusion`` [B*N, h, w, 4]."""
        b, n = cond_images.shape[:2]
        res = self.resolution

        def rows(j, sel, noise_rows):
            dev = self.devices[j]
            conds = cond_images[sel].to(dev)
            conds = _maybe_preprocess(conds.reshape(-1, *cond_images.shape[2:]), res)
            out = restore_forward(
                self._replicas[j], _maybe_preprocess(images[sel].to(dev), res),
                conds.reshape(-1, n, res, res, 3), statics=self.statics,
                timestep=self.timestep, generator=generator, noise=noise_rows,
                use_fused_attention=self.use_fused_attention,
            )
            return out["output_image"]

        if len(self.devices) == 1:
            return rows(0, slice(None), noise)
        if noise is None and b % len(self.devices) == 0:  # in a one-device forward's order
            noise = self._draw(("latent",), b, generator)
            noise.update({f"cond_{k}": v for k, v in
                          self._draw(("latent", "diffusion"), b * n, generator).items()})
            noise.update(self._draw(("diffusion",), b, generator))
        return self._split_batch(b, noise, rows)
