"""The generator's composite loss (counterpart of
``instantrestore_tpu/training/losses/composite.py``; weights are
``OptimConfig.lambda_*``):

  reconstruction (L1, else L2) | LPIPS (when its params are given) | MS-SSIM
  | ArcFace ID (dataset-aligned crops, else whole images) |
  attention-entropy regulariser (from streamed segment sums, else from
  probabilities) | cycle (``degrade_fn`` of the prediction against the
  degraded input) | landmark attention | positive / negative
  reference-usage regularisers (per sample) | facial-component L2 + LPIPS
  | the vision-aided GAN's G term, and its facial-component crops.

A term whose network is not given (LPIPS, ArcFace, the discriminator) is
skipped whatever its weight, as in JAX. The random choices come from
``generator`` or are given: the layer the reference-usage regularisers read
(``layer_idx``, an int, or a 0-d tensor chosen on the device, as a step
captured in a CUDA graph takes it) and DiffAugment's draws of the G term
and of each facial crop (``gan_draws``, a list: the whole image's, then one
per crop).

Across ranks each value is this rank's share of the global batch's value,
so the shares sum to JAX's loss on the mesh and their gradients to its
gradient. Every term was checked for its denominator:

  a mean over the samples, each of equal size, scaled by b / B (local over
  global samples): L1 / L2, LPIPS, MS-SSIM (a batch mean of per-sample
  values), the whole-image ID term and its similarity, the attention
  entropy (a sum over samples over B), the cycle term, the
  facial-component L2 and LPIPS, the GAN term and its crops' terms;
  a denominator that depends on the data, which takes the global count
  (``loss_counts``, summed over the ranks without a gradient): the aligned
  ID term and its similarity (valid samples), the landmark term (masked
  rows), the pos / neg regularisers (valid samples).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from instantrestore_tpu_torch.configs.config import OptimConfig
from instantrestore_tpu_torch.training.losses import gan as gan_mod
from instantrestore_tpu_torch.training.losses import id_loss as id_mod
from instantrestore_tpu_torch.training.losses.lpips import lpips as lpips_fn
from instantrestore_tpu_torch.training.losses.ssim import ms_ssim

# eye, eye and mouth windows at 512 px (the reference's facial-component
# crops); the data pipeline's boxes (data/datasets.py) use these sizes too
FACIAL_COMP_SIZES = ((71, 101), (71, 101), (91, 161))


def facial_comp_sizes(resolution: int):
    """FACIAL_COMP_SIZES scaled from 512 px to ``resolution``."""
    s = resolution / 512.0
    return tuple((max(2, int(round(h * s))), max(2, int(round(w * s))))
                 for h, w in FACIAL_COMP_SIZES)


def _minmax(x: torch.Tensor) -> torch.Tensor:
    lo, hi = x.amin(dim=(1, 2, 3), keepdim=True), x.amax(dim=(1, 2, 3), keepdim=True)
    return (x - lo) / (hi - lo + 1e-12)


def landmark_attention_loss(pred_probs, gt_probs, mask, chosen_cond,
                            count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pred_probs [B, heads, q, K] (widened), gt_probs [1|B, heads, q, q]
    gaussian-splatted targets, mask [1|B, q] bool landmark rows, chosen_cond
    [] or [B] int KV segment: both maps min-max normalised per sample, the
    chosen segment sliced per sample, MSE over the masked rows (mean over
    the selected elements). ``count``: the masked rows of the whole batch
    when this call sees one rank's part of it (default: this call's own)."""
    b, h, q, k = pred_probs.shape
    pf = _minmax(pred_probs.float())
    gf = _minmax(gt_probs.float().expand(b, h, q, q))
    cond = torch.as_tensor(chosen_cond, device=pf.device).long().expand(b)
    seg = pf.reshape(b, h, q, k // q, q)[torch.arange(b, device=pf.device), :, :, cond]
    w = torch.as_tensor(mask, device=pf.device).expand(b, q)[:, None, :, None].float()
    n = w.sum() if count is None else count
    return ((seg - gf).square() * w).sum() / (n * h * q).clamp_min(1.0)


def _entropy_from_mean_act(mean_act: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Cross-entropy between the per-query argmax-segment histogram and the
    uniform distribution (no gradient passes the argmax)."""
    # F.one_hot without its range check, which reads the indices on the host
    segments = torch.arange(n_segments, device=mean_act.device)
    one_hot = (mean_act.argmax(dim=-1)[..., None] == segments).float()
    avg = one_hot.mean(dim=2)  # [B, h, n]
    return -(torch.log(avg + 1e-8) * (1.0 / n_segments)).sum() / mean_act.shape[0]


def attention_entropy_reg(attn_probs: List[torch.Tensor], n_segments: int = 5,
                          train_input: bool = True) -> torch.Tensor:
    """Mean over the layers of the entropy term on probabilities
    [B, h, q, n_segments * S]. With ``train_input`` the input segment is
    dropped from the argmax but keeps its (never selected) histogram column,
    as in the reference."""
    regs = []
    for probs in attn_probs:
        b, h, q, k = probs.shape
        seg = probs.reshape(b, h, q, n_segments, k // n_segments)
        if train_input:
            seg = seg[:, :, :, 1:, :]
        regs.append(_entropy_from_mean_act(seg.mean(dim=-1), n_segments))
    return sum(regs) / len(regs)


def attention_entropy_reg_from_sums(seg_sums: List[torch.Tensor], n_segments: int = 5,
                                    train_input: bool = True) -> torch.Tensor:
    """``attention_entropy_reg`` from streamed per-segment masses
    [B, h, q, n_seg] (``models/attention.py::segment_softmax_sums``): the
    argmax over segment means equals the argmax over segment masses."""
    regs = [_entropy_from_mean_act(s[:, :, :, 1:] if train_input else s, n_segments)
            for s in seg_sums]
    return sum(regs) / len(regs)


def reference_usage_means_per_sample(attn_probs: List[torch.Tensor], layer_idx: int) -> torch.Tensor:
    """Per-sample per-segment attention mass of layer ``layer_idx``,
    [B, n_segments], from probabilities [B, h, q, n_segments * q]."""
    probs = attn_probs[layer_idx]
    q = probs.shape[2]
    seg = probs.reshape(*probs.shape[:-1], probs.shape[-1] // q, q)
    return seg.sum(dim=(1, 2, 4)).float()


def pos_neg_reg_loss_per_sample(means: torch.Tensor, target_idx: torch.Tensor, *,
                                negative: bool,
                                count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """means [B, n_segments]; target_idx [B] int, -1 = no swap for the sample
    (masked out of the mean): normalise by the row max, softmax over the
    segments, NLL toward (pos) or away from (neg) the target segment.
    ``count``: the valid samples of the whole batch (as in
    ``landmark_attention_loss``)."""
    m = means / means.amax(dim=1, keepdim=True).clamp_min(1e-12)
    probs = torch.softmax(m, dim=1)
    log_p = torch.log((1.0 - probs if negative else probs).clamp_min(1e-12))
    nll = -log_p.gather(1, target_idx.clamp_min(0).long()[:, None])[:, 0]
    valid = (target_idx >= 0).float()
    n = valid.sum() if count is None else count
    return (nll * valid).sum() / n.clamp_min(1.0)


def crop_with_boxes(images: torch.Tensor, origins: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Fixed-size per-sample crops: images [B, H, W, C], origins [B, 2]
    (y0, x0) -> [B, h, w, C]; an origin too near the edge is clamped inside."""
    hh, ww = images.shape[1:3]
    o = origins.long()
    y0 = o[:, 0].clamp(0, hh - h)[:, None] + torch.arange(h, device=images.device)
    x0 = o[:, 1].clamp(0, ww - w)[:, None] + torch.arange(w, device=images.device)
    rows = torch.arange(images.shape[0], device=images.device)[:, None, None]
    return images[rows, y0[:, :, None], x0[:, None, :]]


COUNT_KEYS = ("batch", "id", "landmark", "pos", "neg")


def loss_counts(batch: Dict[str, Any]) -> torch.Tensor:
    """The counts behind the composite loss's denominators, as fp32 [5] in
    ``COUNT_KEYS`` order: the batch's samples, the ID term's valid ones, the
    landmark term's masked rows and the pos / neg regularisers' valid
    samples (0 where the batch lacks the key). Summed over the ranks they
    are the global batch's, which ``compute_generator_loss(counts=)``
    takes."""
    gt = batch["gt"]
    b, dev = gt.shape[0], gt.device
    out = torch.zeros(len(COUNT_KEYS), device=dev)
    out[0].fill_(b)
    if "id_valid" in batch:
        out[1] = torch.as_tensor(batch["id_valid"], device=dev).float().sum()
    if batch.get("gt_attn_mask") is not None:
        mask = torch.as_tensor(batch["gt_attn_mask"], device=dev)
        out[2] = mask.expand(b, mask.shape[-1]).float().sum()
    for i, key in ((3, "pos_reg_idx"), (4, "neg_reg_idx")):
        if key in batch:
            out[i] = (torch.as_tensor(batch[key], device=dev).expand(b) >= 0).float().sum()
    return out


def compute_generator_loss(
    out: Dict[str, Any],
    batch: Dict[str, Any],
    cfg: OptimConfig,
    *,
    generator: Optional[torch.Generator] = None,
    layer_idx: Optional[Union[int, torch.Tensor]] = None,
    lpips_params: Optional[Dict] = None,
    arcface_params: Optional[Dict] = None,
    disc_backbone: Optional[Dict] = None,
    disc_heads: Optional[Dict] = None,
    vit_cfg=None,
    disc_type: str = "dinov2",
    gan_draws: Optional[List[Dict[str, torch.Tensor]]] = None,
    train_input: bool = True,
    degrade_fn=None,
    landmark_layer: Optional[int] = None,
    counts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {term: value}) of a restore forward's ``out`` against
    ``batch`` (``gt`` [B, H, W, 3]; optional ``image`` (the degraded input,
    for the cycle term), ``id_mats_pred``, ``id_mats_target``, ``id_valid``,
    ``gt_attn_probs``, ``gt_attn_mask``, ``gt_attn_cond``, ``pos_reg_idx``,
    ``neg_reg_idx``, ``facial_comps``, ``facial_comp_boxes`` [B, 3, 2]).

    ``counts``: ``loss_counts`` of the global batch (summed over the ranks),
    which makes every value this rank's share of the global batch's (the
    module's docstring); by default this batch's own."""
    pred = out["output_image"].float()
    gts = batch["gt"].float()
    losses: Dict[str, torch.Tensor] = {}
    total = pred.new_zeros(())
    if counts is None:
        counts = loss_counts(batch)

    def part(x):  # a mean over this batch -> its share of the global batch's
        return x * (pred.shape[0] / counts[0])

    def count(key):
        return counts[COUNT_KEYS.index(key)]

    # reconstruction: l1 takes precedence over l2
    if cfg.lambda_l1 > 0:
        losses["loss_l1"] = part((pred - gts).abs().mean())
        total = total + losses["loss_l1"] * cfg.lambda_l1
    else:
        losses["loss_l2"] = part((pred - gts).square().mean())
        total = total + losses["loss_l2"] * cfg.lambda_l2

    if lpips_params is not None:
        losses["loss_lpips"] = part(lpips_fn(lpips_params, pred, gts).mean())
        total = total + losses["loss_lpips"] * cfg.lambda_lpips

    if cfg.lambda_ssim > 0:
        losses["loss_ssim"] = part(1.0 - ms_ssim((pred + 1) / 2, (gts + 1) / 2, data_range=1.0))
        total = total + losses["loss_ssim"] * cfg.lambda_ssim

    if cfg.lambda_id_loss > 0 and arcface_params is not None:
        if "id_mats_pred" in batch:
            lid, sim = id_mod.id_loss(arcface_params, pred, gts, batch["id_mats_pred"],
                                      batch["id_mats_target"], batch["id_valid"],
                                      count=count("id"))
        else:  # no alignment given (pre-cropped faces): whole images
            lid, sim = (part(x) for x in id_mod.id_loss_whole_image(arcface_params, pred, gts))
        losses["loss_id"], losses["sim_id"] = lid, sim
        total = total + lid * cfg.lambda_id_loss

    attn_probs = out.get("attn_probs")
    seg_sums = out.get("attn_seg_sums")
    n_segments = 5 if train_input else 4

    if cfg.lambda_attn_reg > 0 and (seg_sums or attn_probs):
        if seg_sums:
            reg = attention_entropy_reg_from_sums(seg_sums, n_segments, train_input=train_input)
        else:
            reg = attention_entropy_reg(attn_probs, n_segments, train_input=train_input)
        losses["loss_attn_reg"] = reg = part(reg)
        total = total + reg * cfg.lambda_attn_reg

    if cfg.lambda_cycle > 0 and degrade_fn is not None:
        losses["loss_cycle"] = part(
            (degrade_fn(pred) - batch["image"].float().detach()).square().mean())
        total = total + losses["loss_cycle"] * cfg.lambda_cycle

    if (cfg.lambda_landmark > 0 and attn_probs and landmark_layer is not None
            and batch.get("gt_attn_probs") is not None):
        losses["loss_landmark"] = landmark_attention_loss(
            attn_probs[landmark_layer], batch["gt_attn_probs"], batch["gt_attn_mask"],
            batch["gt_attn_cond"], count=count("landmark"))
        total = total + losses["loss_landmark"] * cfg.lambda_landmark

    if (cfg.lambda_pos_reg > 0 or cfg.lambda_neg_reg > 0) and (seg_sums or attn_probs):
        # per-sample segment masses [B, n_segments] of one layer drawn at random
        n_layers = len(seg_sums or attn_probs)
        if layer_idx is None:
            if generator is None:
                raise ValueError("the reference-usage regularisers draw a layer: pass "
                                 "layer_idx or a torch.Generator")
            layer_idx = torch.randint(n_layers, (), generator=generator,
                                      device=generator.device).to(pred.device)

        def layer_means(i):
            if seg_sums:
                return seg_sums[i].float().sum(dim=(1, 2))
            return reference_usage_means_per_sample(attn_probs, i)

        if isinstance(layer_idx, torch.Tensor):  # chosen on the device: every layer's means
            means = torch.stack([layer_means(i) for i in range(n_layers)])[
                layer_idx.reshape(1)][0]
        else:
            means = layer_means(layer_idx)
        for name, lam, key, negative in (("pos", cfg.lambda_pos_reg, "pos_reg_idx", False),
                                         ("neg", cfg.lambda_neg_reg, "neg_reg_idx", True)):
            if lam > 0 and key in batch:
                idx = torch.as_tensor(batch[key], device=means.device).expand(means.shape[0])
                losses[f"loss_attn_{name}_reg"] = pos_neg_reg_loss_per_sample(
                    means, idx, negative=negative, count=count(name))
                total = total + losses[f"loss_attn_{name}_reg"] * lam

    if cfg.lambda_facial_comp > 0 and batch.get("facial_comps") is not None:
        fc_total, fc_lpips = pred.new_zeros(()), pred.new_zeros(())
        for m in batch["facial_comps"]:
            mask = m[..., None].float()
            fc_total = fc_total + (pred * mask - gts * mask).square().mean()
            if lpips_params is not None:
                fc_lpips = fc_lpips + lpips_fn(lpips_params, pred * mask, gts * mask).mean()
        losses["loss_facial_comp_l2"] = fc_total = part(fc_total)
        losses["loss_facial_comp_lpips"] = fc_lpips = part(fc_lpips)
        total = total + cfg.lambda_facial_comp * (
            fc_total * cfg.lambda_l2 + fc_lpips * cfg.lambda_lpips)

    if cfg.lambda_gan > 0 and disc_backbone is not None and disc_heads is not None:
        image = out["output_image"]
        boxes = batch.get("facial_comp_boxes") if cfg.lambda_facial_comp > 0 else None
        crops = [] if boxes is None else [
            crop_with_boxes(image, boxes[:, i], hh, ww)
            for i, (hh, ww) in enumerate(facial_comp_sizes(pred.shape[1]))]
        if gan_draws is None:
            if generator is None:
                raise ValueError("the GAN term draws DiffAugment's parameters: pass gan_draws "
                                 "or a torch.Generator")
            gan_draws = [gan_mod.diff_augment_draws(*x.shape[:3], generator, image.device)
                         for x in [image] + crops]
        kw = dict(for_g=True, update_sn=False, disc_type=disc_type,
                  vit_cfg=vit_cfg or gan_mod.DINOV2_VITL14)
        g_loss, _ = gan_mod.discriminate(disc_backbone, disc_heads, image, draws=gan_draws[0],
                                         **kw)
        losses["loss_g"] = part(g_loss.mean())
        total = total + losses["loss_g"] * cfg.lambda_gan
        # facial-component G terms on eye and mouth crops
        if crops:
            fc_g = pred.new_zeros(())
            for crop, draws in zip(crops, gan_draws[1:]):
                gi, _ = gan_mod.discriminate(disc_backbone, disc_heads, crop, draws=draws, **kw)
                fc_g = fc_g + gi.mean()
            losses["fc_loss_g"] = fc_g = part(fc_g)
            total = total + fc_g * cfg.lambda_gan * cfg.lambda_facial_comp

    losses["loss"] = total
    return total, losses
