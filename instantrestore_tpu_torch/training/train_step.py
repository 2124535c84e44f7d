"""The generator training step (counterpart of
``instantrestore_tpu/training/train_step.py``): forward the restorer, compose
the weighted losses, backpropagate into the trainable subset (LoRA leaves and
``unet.conv_in``), clip by the global norm and take an AdamW step.

Where the JAX step returns new params and optimizer state, this one updates
the trainable leaves of ``params`` in place and the optimizer's moments with
them; frozen leaves are never written. The raw (unclipped) gradients of the
last step stay on the trainable leaves' ``.grad``. The whole composite loss
plugs in through ``loss_fn``; the reconstruction terms live here.

Across processes (``process_group``, one rank per card) each rank's batch
is its rows of the global batch and its loss its share of the global
loss (``training/losses/composite.py``): the loss's counts are summed over
the ranks before it, the gradients after ``torch.autograd.grad`` and before
the optimizer (so the clip reads the global norm, as JAX's on the mesh),
and the metrics after it, so every rank reports the global values and
takes the same update.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from instantrestore_tpu_torch import resolve_device
from instantrestore_tpu_torch.configs.config import OptimConfig
from instantrestore_tpu_torch.models.restorer import RestorerStatics, restore_forward
from instantrestore_tpu_torch.parallel.distributed import all_reduce_sum_
from instantrestore_tpu_torch.training.losses.composite import loss_counts
from instantrestore_tpu_torch.training.optim import (
    MaskedAdamW,
    freeze_non_trainable,
    trainable_leaves,
)


def reconstruction_losses(pred: torch.Tensor, target: torch.Tensor, cfg: OptimConfig):
    """The weighted l2 / l1 reconstruction terms."""
    losses = {}
    pf, tf = pred.float(), target.float()
    if cfg.lambda_l2 > 0:
        losses["l2"] = (pf - tf).square().mean() * cfg.lambda_l2
    if cfg.lambda_l1 > 0:
        losses["l1"] = (pf - tf).abs().mean() * cfg.lambda_l1
    return losses


def default_loss_fn(out: Dict[str, Any], batch: Dict[str, Any], cfg: OptimConfig,
                    counts: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The weighted reconstruction terms as this batch's share of the global
    batch's means (``counts``: ``loss_counts`` of the global batch; by
    default this batch's own)."""
    if counts is None:
        counts = loss_counts(batch)
    losses = reconstruction_losses(out["output_image"], batch["gt"], cfg)
    losses = {k: v * (batch["gt"].shape[0] / counts[0]) for k, v in losses.items()}
    total = sum(losses.values()) if losses else out["output_image"].new_zeros(())
    return total, losses


def reduce_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Each rank's share of each 0-d metric summed over ``group``: the
    global values, the same on every rank (one all-reduce)."""
    vals = torch.stack([v.float() for v in metrics.values()])
    all_reduce_sum_([vals], group)
    return dict(zip(metrics, vals.unbind()))


def _aliased(params: Any, trainable: set) -> list:
    """The dotted paths of the bundle's leaves whose tensor is trainable and
    stands at another place of the bundle too (the step updates trainable
    leaves in place, so a frozen view or a second tree would change with
    them)."""
    named = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}{k}.")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}{i}.")
        elif isinstance(node, torch.Tensor):
            named.append((path[:-1], id(node)))

    walk(params, "")
    uses = collections.Counter(i for _, i in named)
    return [n for n, i in named if i in trainable and uses[i] > 1]


def make_train_step(
    statics: RestorerStatics,
    optim_cfg: OptimConfig,
    optimizer: MaskedAdamW,
    trainable_mask: Any,
    loss_fn: Callable = default_loss_fn,
    save_attn_probs: bool = False,
    use_fused_attention: bool = False,
    remat: bool = False,
    save_seg_sums: bool = False,
    device=None,
    probs_layers=None,
    process_group=None,
):
    """Build the generator train step ``step(params, batch, *, generator=None,
    noise=None, timestep=None) -> (metrics, out)``.

    ``params``: an unmerged bundle (``init_restorer_params`` or a converted
    one) of fp32 leaves on ``device`` (CUDA unless ``device="cpu"`` is asked);
    the leaves ``trainable_mask`` marks are updated in place. ``batch``:
    {"image": degraded [B, H, W, 3], "gt": clean [B, H, W, 3],
    "conditioning_images": [B, N, H, W, 3], "valid_indices": [B]} plus what
    ``loss_fn(out, batch, optim_cfg)`` reads; its tensors (and lists of
    them) are moved to the device. ``probs_layers`` limits
    ``save_attn_probs`` to those shared layers (the landmark term reads
    one). ``generator`` / ``noise`` / ``timestep`` as ``restore_forward``
    (``timestep=None`` draws one per batch). ``opt_phase``: as
    ``MaskedAdamW.update``'s ``phase`` (a step captured in a CUDA graph,
    whose caller writes the optimizer's scalars and advances its counts).
    ``metrics``: the loss terms,
    ``loss`` and ``grad_norm`` (before clipping), detached; ``out``: the
    forward's result.

    ``process_group`` (``parallel.distributed.default_group()`` in a
    multi-process run): ``batch`` is this rank's rows of the global batch,
    ``noise`` its rows of the global draws, and ``loss_fn`` takes
    ``counts=`` (``composite.loss_counts`` summed over the ranks); the
    gradients and the metrics are summed over the ranks (module docstring)."""
    dev = resolve_device(device)

    def train_step(params, batch, *, generator: Optional[torch.Generator] = None,
                   noise: Optional[Dict[str, torch.Tensor]] = None,
                   timestep=None, opt_phase: Optional[bool] = None):
        freeze_non_trainable(params, trainable_mask)
        leaves = trainable_leaves(params, trainable_mask)
        if any(t.device.type != dev.type for t in leaves):
            raise ValueError(f"the params are not on {dev}")
        twice = _aliased(params, {id(t) for t in leaves})
        if twice:
            raise ValueError(f"a trainable tensor stands at several places of the bundle "
                             f"({', '.join(twice[:4])}); each needs its own copy")
        batch = {k: v.to(dev) if isinstance(v, torch.Tensor)
                 else [t.to(dev) for t in v] if isinstance(v, list) else v
                 for k, v in batch.items()}
        out = restore_forward(
            params, batch["image"], batch.get("conditioning_images"), batch.get("valid_indices"),
            statics=statics, timestep=timestep, generator=generator, noise=noise,
            save_attn_probs=save_attn_probs, probs_layers=probs_layers,
            save_seg_sums=save_seg_sums,
            use_fused_attention=use_fused_attention, remat=remat,
        )
        kw = {}
        if process_group is not None:  # the global batch's counts
            kw["counts"] = loss_counts(batch)
            all_reduce_sum_([kw["counts"]], process_group)
        total, losses = loss_fn(out, batch, optim_cfg, **kw)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        # a leaf the loss does not reach (to_k of a refs-only shared layer) has a zero gradient
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        if process_group is not None:
            all_reduce_sum_(grads, process_group)
            metrics = reduce_metrics(metrics, process_group)
        for t, g in zip(leaves, grads):
            t.grad = g
        optimizer.update(params, grads, phase=opt_phase)
        metrics["grad_norm"] = optimizer.last_grad_norm
        return metrics, out

    return train_step
