"""The InstantRestore model: single-step personalized face restoration
(counterpart of ``instantrestore_tpu/models/restorer.py``).

One parameter bundle holds the LoRA'd restoration UNet/VAE; the frozen
"original" nets that capture reference K/V are views of the same base
weights (LoRA stripped, pretrained conv_in), or explicit trees in a serving
bundle or, with ``train_reference_networks``, trees with their own rank-16
LoRA (applied at ``reference_lora_scaling``) and their own ``conv_in`` and
skip convs. The options ``use_shortcuts`` (the VAE's skip convs) and
``condition_on_face_embeds`` (``restore_forward(face_embeds=)``) are as in
the JAX package. Ported: ``get_conditioning_kv`` (the reference branch),
``restore_forward`` against references encoded in the call (cold) or
precomputed (warm), for serving (fixed timestep) and for training
(``timestep=None`` draws one per batch from ``statics.noise_timesteps``;
``remat`` checkpoints each stage; ``save_seg_sums``), and
``restore_forward_multistep``.

Randomness: the forwards draw their standard-normal noise, and the training
timestep, from an explicit ``torch.Generator``, or take the noise ready-made
through ``noise`` (keys ``latent`` and ``diffusion`` for the input,
``cond_latent`` and ``cond_diffusion`` for the references) and the timestep
through ``timestep``, which is how tests inject what JAX drew.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from instantrestore_tpu_torch import device_constant
from instantrestore_tpu_torch.configs.config import ModelConfig
from instantrestore_tpu_torch.models import scheduler as sched
from instantrestore_tpu_torch.models.lora import (
    UNET_LORA_TARGETS,
    VAE_LORA_TARGETS,
    VAE_SHORTCUT_TARGETS,
    attach_faceid,
    attach_lora,
    merge_lora,
    strip_lora,
)
from instantrestore_tpu_torch.models.freeu import FreeUParams
from instantrestore_tpu_torch.models.unet import UNetConfig, init_unet_params, unet_apply
from instantrestore_tpu_torch.models.vae import (
    VAEConfig,
    init_vae_params,
    sample_latent,
    vae_decode,
    vae_encode,
)
from instantrestore_tpu_torch.ops.shared_attention import IdentityRef
from instantrestore_tpu_torch.utils import profiling

NOISE_TIMESTEPS = (249, 499, 749)  # the training timesteps, one drawn per batch
COND_TIMESTEP = 1      # noise level of the reference branch
SERVING_TIMESTEP = 249  # fixed restore timestep at inference
# random LoRA B ~ N(0, 1e-3) instead of peft's zeros, so the merged
# restoration nets differ from the frozen capture nets as trained ones do
LORA_B_STD = 1e-3


@dataclasses.dataclass(frozen=True)
class RestorerStatics:
    """Static knobs of the restore forward."""

    unet_cfg: UNetConfig = UNetConfig()
    vae_cfg: VAEConfig = VAEConfig()
    # FreeU's factors for this UNet (SD 2.1's by default; None: off)
    freeu: Optional[FreeUParams] = FreeUParams()
    use_shared_attention: bool = True
    use_adain: bool = False
    train_input: bool = True
    use_shortcuts: bool = False
    condition_on_face_embeds: bool = False
    unet_lora_scaling: float = 0.5  # alpha = r // 2 at training
    vae_lora_scaling: float = 0.5
    noise_timesteps: Tuple[int, ...] = NOISE_TIMESTEPS
    # rank-16, alpha-8 LoRA on the capture networks (off in the shipped configs)
    train_reference_networks: bool = False
    reference_lora_scaling: float = 0.5
    compute_dtype: Any = torch.bfloat16

    @classmethod
    def from_model_config(cls, mcfg: ModelConfig, **overrides) -> "RestorerStatics":
        kw = dict(
            use_shared_attention=mcfg.use_shared_attention,
            use_adain=mcfg.use_adain,
            train_input=mcfg.train_input,
            use_shortcuts=mcfg.use_shortcuts,
            unet_lora_scaling=(mcfg.lora_rank_unet // 2) / mcfg.lora_rank_unet,
            vae_lora_scaling=(mcfg.lora_rank_vae // 2) / mcfg.lora_rank_vae,
        )
        kw.update(overrides)
        kw.setdefault("condition_on_face_embeds", mcfg.condition_on_face_embeds)
        kw.setdefault("train_reference_networks", mcfg.train_reference_networks)
        return cls(**kw)


def init_restorer_params(
    gen: torch.Generator,
    statics: RestorerStatics,
    *,
    lora_rank_unet: int = 32,
    lora_rank_vae: int = 32,
    device=None,
) -> Dict[str, Any]:
    """Random-init bundle at any width, fp32, drawn from ``gen`` (whose
    device must be ``device``): ``unet`` and ``vae`` with LoRA factors on the
    reference's target modules (and the VAE's skip convs with
    ``use_shortcuts``), ``unet_orig_conv_in`` (its own copy of the UNet's
    conv_in, which training updates in place) and the prompt embedding
    ``caption_enc`` [1, 77, ctx]; for a text-time UNet (SDXL) the pooled
    prompt embedding ``caption_pooled`` [1, D] and the time ids
    ``add_time_ids`` (``text_time_ids`` at the model's resolution); the
    UNet's FaceID projections with
    ``condition_on_face_embeds``; with ``train_reference_networks`` explicit
    ``original_unet`` / ``original_vae`` with rank-16 LoRA, which share only
    frozen base weights with the restoration nets (their ``conv_in`` and
    skip convs are copies). LoRA B starts at N(0, ``LORA_B_STD``) rather
    than peft's zeros."""
    vae_cfg = dataclasses.replace(statics.vae_cfg, use_shortcuts=statics.use_shortcuts)
    vae_targets = VAE_SHORTCUT_TARGETS if statics.use_shortcuts else VAE_LORA_TARGETS
    base_unet = init_unet_params(gen, statics.unet_cfg, device=device)
    base_vae = init_vae_params(gen, vae_cfg, device=device)
    unet = attach_lora(base_unet, gen, lora_rank_unet, UNET_LORA_TARGETS,
                       b_std=LORA_B_STD, device=device)
    vae = attach_lora(base_vae, gen, lora_rank_vae, vae_targets, b_std=LORA_B_STD, device=device)
    caption = torch.randn((1, 77, statics.unet_cfg.cross_attention_dim),
                          generator=gen, device=device)
    added = {}
    if statics.unet_cfg.addition_embed_type == "text_time":
        res = statics.unet_cfg.sample_size * 2 ** (len(statics.vae_cfg.block_out_channels) - 1)
        added = {"caption_pooled": torch.randn((1, statics.unet_cfg.added_text_embed_dim),
                                               generator=gen, device=device),
                 "add_time_ids": text_time_ids(res, device=device)}
    if statics.condition_on_face_embeds:
        unet = attach_faceid(unet, gen, cross_dim=statics.unet_cfg.cross_attention_dim,
                             device=device)
    bundle = {
        "unet": unet,
        "unet_orig_conv_in": {k: v.clone() for k, v in unet["conv_in"].items()},
        "vae": vae,
        "caption_enc": caption,
        **added,
    }
    if statics.train_reference_networks:
        # in-place updates: a leaf trainable in one tree gets its own tensor
        ounet = dict(base_unet, conv_in={k: v.clone() for k, v in base_unet["conv_in"].items()})
        ovae = dict(base_vae, decoder={
            k: {n: t.clone() for n, t in v.items()} if k.startswith("skip_conv_") else v
            for k, v in base_vae["decoder"].items()})
        bundle["original_unet"] = attach_lora(ounet, gen, 16, UNET_LORA_TARGETS,
                                              b_std=LORA_B_STD, device=device)
        bundle["original_vae"] = attach_lora(ovae, gen, 16, vae_targets, b_std=LORA_B_STD,
                                             device=device)
    return bundle


def text_time_ids(resolution: int, *, device=None) -> torch.Tensor:
    """SDXL's time ids [1, 6] (int64) of an uncropped square photo served at
    ``resolution``: original size, crop top-left (0, 0), target size."""
    r = int(resolution)
    return torch.tensor([[r, r, 0, 0, r, r]], dtype=torch.long, device=device)


def added_conditioning(params: Dict[str, Any], statics: RestorerStatics,
                       batch: int) -> Optional[Dict[str, torch.Tensor]]:
    """The UNet's ``added_cond`` for ``batch`` rows from the bundle's
    ``caption_pooled`` and ``add_time_ids`` (beside ``caption_enc``), or
    None for a UNet without added conditioning."""
    if statics.unet_cfg.addition_embed_type is None:
        return None
    return {"text_embeds": params["caption_pooled"].expand(batch, -1),
            "time_ids": params["add_time_ids"].expand(batch, -1)}


def original_unet_view(params: Dict[str, Any]) -> Dict[str, Any]:
    """The frozen K/V-capture UNet: base weights with the pretrained conv_in
    (or the bundle's explicit ``original_unet``)."""
    if "original_unet" in params:
        return params["original_unet"]
    view = strip_lora(params["unet"])
    view["conv_in"] = params["unet_orig_conv_in"]
    return view


def original_vae_view(params: Dict[str, Any]) -> Dict[str, Any]:
    if "original_vae" in params:
        return params["original_vae"]
    return strip_lora(params["vae"])


def serving_bundle(params: Dict[str, Any], statics: RestorerStatics) -> Dict[str, Any]:
    """Inference bundle: LoRA merged into the restoration nets, the frozen
    originals materialised explicitly for the capture branch, the prompt
    embedding (and a text-time UNet's ``caption_pooled`` and
    ``add_time_ids``) as given."""
    bundle = {
        "unet": merge_lora(params["unet"], statics.unet_lora_scaling),
        "vae": merge_lora(params["vae"], statics.vae_lora_scaling),
        "original_unet": original_unet_view(params),
        "original_vae": original_vae_view(params),
        "caption_enc": params["caption_enc"],
    }
    bundle.update({k: params[k] for k in ("caption_pooled", "add_time_ids") if k in params})
    return bundle


def mask_ref_kv(kv, valid_indices: torch.Tensor, batch: int, n_refs: int):
    """Captured head-split [B*N, H, S, d] K/V -> [B, N, H, S, d], zeroing
    references at or beyond each sample's valid count."""
    valid = valid_indices.to(kv[0][0].device)
    mask = torch.arange(n_refs, device=valid.device)[None, :] < valid[:, None]
    masked = []
    for k, v in kv:
        m = mask[:, :, None, None, None].to(k.dtype)
        masked.append((k.reshape(batch, n_refs, *k.shape[1:]) * m,
                       v.reshape(batch, n_refs, *v.shape[1:]) * m))
    return masked


def _noise(noise: Optional[Dict[str, torch.Tensor]], key: str, like: torch.Tensor,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    if noise is not None and key in noise:
        n = noise[key]
        if n.shape != like.shape:
            raise ValueError(f"noise[{key!r}] has shape {tuple(n.shape)}, expected {tuple(like.shape)}")
        return n.to(device=like.device, dtype=like.dtype)
    if generator is None:
        raise ValueError(f"no noise[{key!r}] given: pass it or a torch.Generator")
    return torch.randn(like.shape, generator=generator, device=like.device, dtype=like.dtype)


def get_conditioning_kv(
    params: Dict[str, Any],
    cond_images: torch.Tensor,
    valid_indices: torch.Tensor,
    *,
    statics: RestorerStatics,
    alphas_cumprod: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Dict[str, torch.Tensor]] = None,
    sample_posterior: bool = True,
    decode_conditions: bool = False,
    use_fused_attention: bool = False,
    debug_taps: bool = False,
):
    """Reference branch: cond_images [B, N, H, W, 3] in [-1, 1] -> (the
    masked (K, V) pairs [B, N, H, S, d] of the UNet's
    ``num_shared_attn_layers`` shared layers from the frozen nets at t=1, the decoded
    references [B, N, H, W, 3] when ``decode_conditions`` else None), plus
    the taps {cond_latent, cond_latent_noised} [B*N, h, w, 4] as a third
    element when ``debug_taps``. ``noise`` may give ``latent`` and
    ``diffusion`` [B*N, h, w, 4]."""
    b, n = cond_images.shape[:2]
    flat = cond_images.reshape(b * n, *cond_images.shape[2:])
    sf = statics.vae_cfg.scaling_factor
    ovae = original_vae_view(params)
    # the capture nets' own LoRA (train_reference_networks); a tree without
    # LoRA leaves ignores the scaling
    ref_scaling = statics.reference_lora_scaling
    mean, logvar, _ = vae_encode(
        ovae, flat, cfg=statics.vae_cfg, lora_scaling=ref_scaling,
        compute_dtype=statics.compute_dtype, use_fused_attention=use_fused_attention,
    )
    eps = _noise(noise, "latent", mean, generator) if sample_posterior else None
    z = sample_latent(mean, logvar, eps) * sf
    t1 = torch.full((b * n,), COND_TIMESTEP, dtype=torch.long, device=z.device)
    zt = sched.add_noise(alphas_cumprod, z, _noise(noise, "diffusion", z, generator), t1)
    caption = params["caption_enc"].expand(b * n, *params["caption_enc"].shape[1:])
    eps_pred, aux = unet_apply(
        original_unet_view(params), zt, t1, caption, cfg=statics.unet_cfg,
        capture_kv=True, freeu=statics.freeu,
        added_cond=added_conditioning(params, statics, b * n), lora_scaling=ref_scaling,
        use_fused_attention=use_fused_attention, compute_dtype=statics.compute_dtype,
    )
    ref_kv = mask_ref_kv(aux["kv"], valid_indices, b, n)
    decoded = None
    if decode_conditions:
        x0 = sched.pred_original_sample(alphas_cumprod, eps_pred, zt, t1)
        decoded = torch.clamp(
            vae_decode(ovae, x0 / sf, cfg=statics.vae_cfg, compute_dtype=statics.compute_dtype,
                       lora_scaling=ref_scaling, use_fused_attention=use_fused_attention),
            -1.0, 1.0,
        ).reshape(b, n, *cond_images.shape[2:])
    if debug_taps:
        return ref_kv, decoded, {"cond_latent": z, "cond_latent_noised": zt}
    return ref_kv, decoded


def _cond_noise(noise: Optional[Dict[str, torch.Tensor]]):
    """The reference branch's entries of a forward's ``noise`` dict."""
    if noise is None:
        return None
    return {k[len("cond_"):]: v for k, v in noise.items() if k.startswith("cond_")}


def timestep_table(statics: RestorerStatics, device) -> torch.Tensor:
    """``statics.noise_timesteps`` as an int64 tensor on ``device`` (made once):
    a timestep drawn as an index into it stays on the device."""
    ts = tuple(statics.noise_timesteps)
    return device_constant(("noise_timesteps", ts), device,
                           lambda: torch.tensor(ts, dtype=torch.long))


def restore_forward(
    params: Dict[str, Any],
    image: torch.Tensor,
    cond_images: Optional[torch.Tensor] = None,
    valid_indices: Optional[torch.Tensor] = None,
    *,
    statics: RestorerStatics,
    face_embeds: Optional[torch.Tensor] = None,
    timestep: Optional[int] = SERVING_TIMESTEP,
    sample_posterior: bool = True,
    decode_conditions: bool = False,
    save_attn_probs: bool = False,
    probs_layers: Optional[Sequence[int]] = None,
    save_seg_sums: bool = False,
    precomputed_ref_kv=None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Dict[str, torch.Tensor]] = None,
    use_fused_attention: bool = False,
    remat: bool = False,
    debug_taps: bool = False,
) -> Dict[str, Any]:
    """Restore degraded images [B, H, W, 3] in [-1, 1].

    The references are either encoded here from ``cond_images``
    [B, N, H, W, 3] in [-1, 1] with ``valid_indices`` [B] valid counts (all
    N when None; cold restore), or given as ``precomputed_ref_kv``: a list of
    ``(k, v)`` [B, N, H, S, d] or ``IdentityRef`` entries, one for each of
    the UNet's ``num_shared_attn_layers`` shared layers (warm restore).
    Neither runs without shared attention.

    ``face_embeds`` [B, M, 512] (face embeddings of the references) replace
    the prompt embedding as the restoration UNet's cross-attention context,
    through its FaceID projections, when ``statics.condition_on_face_embeds``
    (without them that model attends to the prompt, as in the JAX package).

    ``timestep=None`` (training) draws one timestep for the batch from
    ``statics.noise_timesteps`` with ``generator`` (as a 0-d tensor);
    ``timestep`` may be an int or a 0-d integer tensor, which is read on its
    device only (a step captured in a CUDA graph takes it so), and comes
    back as given. Each stage (encode, capture, unet, decode) is a span of
    ``utils/profiling.py``. ``remat`` checkpoints each stage: its
    activations are rebuilt in the backward instead of kept;
    all noise is drawn outside the stages, so the rebuilt forward is the
    first one.

    ``noise`` may give ``latent`` and ``diffusion`` [B, h, w, 4], and
    ``cond_latent`` and ``cond_diffusion`` [B*N, h, w, 4]. Returns
    {output_image [B, H, W, 3] in [-1, 1], timestep, latent_pred;
    output_image_conditions when ``decode_conditions``; attn_probs when
    ``save_attn_probs``; attn_seg_sums when ``save_seg_sums``; taps when
    ``debug_taps``: vae_enc_mean, vae_enc_logvar, latent, latent_noised,
    unet_eps, x0, decoded, cond_latent, cond_latent_noised, unet.<stage>,
    ref_kv.<i>.k/v}."""

    def stage(name, fn, *args):
        # the stage's span (``utils/profiling.py``); no stage draws random
        # numbers, so there is no RNG state to preserve
        with profiling.span(name):
            return (checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
                    if remat else fn(*args))

    b = image.shape[0]
    abar = sched.make_alphas_cumprod(device=image.device)
    sf = statics.vae_cfg.scaling_factor
    mean, logvar, skip_acts = stage(
        "encode", lambda p, img: vae_encode(
            p, img, cfg=statics.vae_cfg, lora_scaling=statics.vae_lora_scaling,
            compute_dtype=statics.compute_dtype, use_fused_attention=use_fused_attention),
        params["vae"], image)
    eps = _noise(noise, "latent", mean, generator) if sample_posterior else None
    z = sample_latent(mean, logvar, eps) * sf

    ref_kv, decoded_conds, cond_taps = None, None, {}
    if precomputed_ref_kv is not None:
        ref_kv = precomputed_ref_kv
    elif cond_images is not None and statics.use_shared_attention:
        if valid_indices is None:
            valid_indices = torch.full((b,), cond_images.shape[1], device=image.device)
        # the reference noise is drawn here, outside the checkpointed stage
        like = mean.new_empty((b * cond_images.shape[1], *mean.shape[1:]))
        given = _cond_noise(noise)
        cond_noise = {k: _noise(given, k, like, generator)
                      for k in (("latent",) if sample_posterior else ()) + ("diffusion",)}
        ref_kv, decoded_conds, *rest = stage(
            "capture", lambda p, conds, valid: get_conditioning_kv(
                p, conds, valid, statics=statics, alphas_cumprod=abar, noise=cond_noise,
                sample_posterior=sample_posterior, decode_conditions=decode_conditions,
                use_fused_attention=use_fused_attention, debug_taps=debug_taps),
            params, cond_images, valid_indices)
        if debug_taps:
            cond_taps = rest[0]

    if timestep is None:
        if generator is None:
            raise ValueError("timestep=None draws the timestep: pass a torch.Generator")
        idx = torch.randint(len(statics.noise_timesteps), (), generator=generator,
                            device=generator.device)
        timestep = timestep_table(statics, z.device)[idx.to(z.device).reshape(1)][0]
    if isinstance(timestep, torch.Tensor):  # read on the device, never on the host
        tb = timestep.to(z.device, torch.long).reshape(1).repeat(b)
    else:
        tb = torch.full((b,), timestep, dtype=torch.long, device=z.device)
    zt = sched.add_noise(abar, z, _noise(noise, "diffusion", z, generator), tb)
    use_faceid = statics.condition_on_face_embeds and face_embeds is not None
    if use_faceid:
        caption = face_embeds.to(z.device)
    else:
        caption = params["caption_enc"].expand(b, *params["caption_enc"].shape[1:])
    if not statics.use_shared_attention:
        ref_kv = None
    added = added_conditioning(params, statics, b)
    eps_pred, aux = stage(
        "unet", lambda p, zt_, ref_kv_, caption_: unet_apply(
            p, zt_, tb, caption_, cfg=statics.unet_cfg, ref_kv=ref_kv_,
            use_adain=statics.use_adain, train_input=statics.train_input,
            save_attn_probs=save_attn_probs, probs_layers=probs_layers,
            save_seg_sums=save_seg_sums, use_fused_attention=use_fused_attention,
            use_faceid=use_faceid, capture_taps=debug_taps, freeu=statics.freeu,
            added_cond=added, lora_scaling=statics.unet_lora_scaling,
            compute_dtype=statics.compute_dtype),
        params["unet"], zt, ref_kv, caption)
    x0 = sched.pred_original_sample(abar, eps_pred, zt, tb)
    out = stage(
        "decode", lambda p, z_, skips: vae_decode(
            p, z_, cfg=statics.vae_cfg, skip_acts=skips,
            lora_scaling=statics.vae_lora_scaling, compute_dtype=statics.compute_dtype,
            use_fused_attention=use_fused_attention),
        params["vae"], x0 / sf, skip_acts if statics.use_shortcuts else None)
    result = {"output_image": torch.clamp(out, -1.0, 1.0), "timestep": timestep,
              "latent_pred": x0}
    if decoded_conds is not None:
        result["output_image_conditions"] = decoded_conds
    if save_attn_probs:
        result["attn_probs"] = aux.get("attn_probs")
    if save_seg_sums:
        result["attn_seg_sums"] = aux.get("seg_sums")
    if debug_taps:
        taps = {"vae_enc_mean": mean, "vae_enc_logvar": logvar, "latent": z,
                "latent_noised": zt, "unet_eps": eps_pred, "x0": x0, "decoded": out}
        taps.update(cond_taps)
        for k, v in aux["taps"].items():
            taps[f"unet.{k}"] = v
        if ref_kv is not None:
            for i, entry in enumerate(ref_kv):
                if not isinstance(entry, IdentityRef):
                    taps[f"ref_kv.{i}.k"], taps[f"ref_kv.{i}.v"] = entry
        result["taps"] = taps
    return result


def restore_forward_multistep(
    params: Dict[str, Any],
    image: torch.Tensor,
    cond_images: Optional[torch.Tensor] = None,
    valid_indices: Optional[torch.Tensor] = None,
    *,
    statics: RestorerStatics,
    timesteps: Tuple[int, ...] = (749, 499, 249),
    sample_posterior: bool = True,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Dict[str, torch.Tensor]] = None,
    use_fused_attention: bool = False,
) -> Dict[str, Any]:
    """Multi-step restoration: noise the input latent to ``timesteps[0]``,
    then DDIM-denoise through the list with the same reference K/V at every
    step (captured once), and decode. Single-step equals timesteps=(249,).
    ``noise`` keys as in ``restore_forward``. Returns {output_image}."""
    b = image.shape[0]
    abar = sched.make_alphas_cumprod(device=image.device)
    sf = statics.vae_cfg.scaling_factor
    mean, logvar, skip_acts = vae_encode(
        params["vae"], image, cfg=statics.vae_cfg, lora_scaling=statics.vae_lora_scaling,
        compute_dtype=statics.compute_dtype, use_fused_attention=use_fused_attention,
    )
    eps = _noise(noise, "latent", mean, generator) if sample_posterior else None
    z = sample_latent(mean, logvar, eps) * sf

    ref_kv = None
    if cond_images is not None and statics.use_shared_attention:
        if valid_indices is None:
            valid_indices = torch.full((b,), cond_images.shape[1], device=image.device)
        ref_kv, _ = get_conditioning_kv(
            params, cond_images, valid_indices, statics=statics, alphas_cumprod=abar,
            generator=generator, noise=_cond_noise(noise), sample_posterior=sample_posterior,
            use_fused_attention=use_fused_attention,
        )

    caption = params["caption_enc"].expand(b, *params["caption_enc"].shape[1:])
    added = added_conditioning(params, statics, b)
    t0 = torch.full((b,), timesteps[0], dtype=torch.long, device=z.device)
    x = sched.add_noise(abar, z, _noise(noise, "diffusion", z, generator), t0)
    for i, t in enumerate(timesteps):
        tb = torch.full((b,), t, dtype=torch.long, device=z.device)
        eps_pred, _ = unet_apply(
            params["unet"], x, tb, caption, cfg=statics.unet_cfg, ref_kv=ref_kv,
            use_adain=statics.use_adain, train_input=statics.train_input,
            use_fused_attention=use_fused_attention, freeu=statics.freeu, added_cond=added,
            lora_scaling=statics.unet_lora_scaling, compute_dtype=statics.compute_dtype,
        )
        t_next = timesteps[i + 1] if i + 1 < len(timesteps) else -1
        x = sched.ddim_step(abar, eps_pred, x, tb, torch.full_like(tb, t_next))
    out = vae_decode(
        params["vae"], x / sf, cfg=statics.vae_cfg,
        skip_acts=skip_acts if statics.use_shortcuts else None,
        lora_scaling=statics.vae_lora_scaling, compute_dtype=statics.compute_dtype,
        use_fused_attention=use_fused_attention,
    )
    return {"output_image": torch.clamp(out, -1.0, 1.0)}
