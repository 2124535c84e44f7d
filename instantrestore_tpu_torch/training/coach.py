"""The trainer (counterpart of ``instantrestore_tpu/training/coach.py``): a
GAN-style loop of a generator step (the restore forward, the composite loss,
AdamW on the LoRA leaves and ``unet.conv_in``) and a discriminator step (the
vision-aided D on the real image and the detached prediction, AdamW on its
heads) per batch, gradient accumulation, metric / image / validation / save
intervals, validation over the whole test set with best-model tracking, and
resumable checkpoints.

Across processes (``parallel.distributed.init_distributed`` before the
Coach; ``cli.train`` does it under ``torchrun`` or ``--multihost``) each
rank runs on its own card (``local_device()``), its loaders hand it its
rows of every global batch, and it draws the global batch's noise,
timestep, layer, DiffAugment and cycle noise from the (seed, step)
generator and keeps its rows (``local_rows``), so a run over any number of
ranks takes the steps of one process over the same global batch. Rank 0's
params and discriminator heads are broadcast at the start; the loss terms
are each rank's share of the global batch's, and the G and D gradients, the
loss counts and the metrics are summed over the ranks, so every rank takes
the same update (``u`` stays the power iteration's, the same on each).
Validation sums each batch's loss shares over the ranks, so
``best_val_loss`` and the ``best_model`` save agree. Rank 0 alone writes
logs and checkpoints, a barrier follows each save, every rank restores, and
the ranks' trainable leaves and heads are checked bit-equal at each save
interval. A batch key that not every rank's batch has (collate adds some
only when each item has them) is dropped on all, and the landmark term
takes rank 0's layer.

``compute.steps_per_dispatch`` N > 1 runs N steps per dispatch, as JAX's
``lax.scan`` of the G + D step does: the N collated batches are stacked on
the card once (``_stack_batches``, JAX's keys and landmark re-splat), and
each step writes its batch and its draws (the same as a one-step run's at
that step) into static buffers and replays one CUDA graph of the whole G +
D step: forward, loss, gradients, the all-reduces of a multi-process run
and both optimizers (``_StaticStep``). A graph is captured per landmark
layer, accumulation phase and input structure, after a first eager run of
that step on a side stream, into one memory pool; a capture error raises.
On the CPU the same static-buffer step runs eagerly. Either way a dispatch
run ends bit for bit where the one-step run ends; the intervals fire when a
dispatch crosses them (JAX's ``_after_steps``).

Differences from the JAX Coach, each deliberate:
  * one card per process (CUDA unless ``device="cpu"`` is asked).
  * the G step is the port's ``make_train_step`` (trainable leaves and
    moments updated in place).
  * the random draws are explicit: ``draw_g`` / ``draw_d`` / ``draw_eval``
    make them from a ``torch.Generator`` and ``g_step`` / ``d_step`` /
    ``eval_step`` take them, so tests inject what JAX drew. ``train()``
    re-seeds one generator from (``cfg.compute.seed``, step) before each
    step and starts the loader at the restored step's epoch and batch, so a
    run resumed from a full checkpoint takes the steps the uninterrupted run
    takes; ``validate()`` draws every batch from a generator seeded 0, as
    JAX's validation uses one key for every batch.
  * the D step leaves every spectral-norm ``u`` to the power iteration.
    JAX's optimizer masks ``u`` out, but ``optax.masked`` passes a masked
    leaf's update through unchanged, so its D step also adds the loss's
    gradient w.r.t. ``u`` to the new ``u``; torch's ``spectral_norm`` keeps
    ``u`` a buffer, and so does the port.
  * checkpoints are one ``torch.save`` file each (``training/checkpoints.py``),
    not orbax directories.
"""

from __future__ import annotations

import math
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from instantrestore_tpu_torch import resolve_device
from instantrestore_tpu_torch.configs.config import TrainConfig, encode_config
from instantrestore_tpu_torch.convert import tree_to
from instantrestore_tpu_torch.data.datasets import (
    DEVICE_KEYS,
    RestoreDataset,
    RestoreDatasetTest,
    build_landmark_target,
    to_torch_batch,
)
from instantrestore_tpu_torch.data.loader import DataLoader
from instantrestore_tpu_torch.models.lora import strip_lora, trainable_mask
from instantrestore_tpu_torch.models.restorer import (
    RestorerStatics,
    init_restorer_params,
    restore_forward,
    timestep_table,
)
from instantrestore_tpu_torch.models.vit import CLIP_VITB32, DINO_VITB16, DINOV2_VITL14
from instantrestore_tpu_torch.ops.flash_vjp import add_launch_counts, launch_counts
from instantrestore_tpu_torch.parallel import distributed as pdist
from instantrestore_tpu_torch.training import checkpoints as ckpt_mod
from instantrestore_tpu_torch.training.logging_utils import CoachLogger
from instantrestore_tpu_torch.training.losses import gan as gan_mod
from instantrestore_tpu_torch.training.losses.composite import (
    compute_generator_loss,
    crop_with_boxes,
    facial_comp_sizes,
    loss_counts,
)
from instantrestore_tpu_torch.training.losses.lpips import init_lpips_params
from instantrestore_tpu_torch.training.optim import (
    freeze_non_trainable,
    make_optimizer,
    trainable_leaves,
)
from instantrestore_tpu_torch.training.train_step import make_train_step, reduce_metrics

# backbone -> (head in_ch, out_size) of the SimpleD-headed conv backbones
SIMPLE_HEADS = {"vgg": (512, 3), "swin": (768, 3), "face_seg": (256, 4), "face_normals": (512, 4),
                "seg_ade": (768, 4), "det_coco": (768, 4)}
KNOWN_DISC_TYPES = ("face_normals", "face_seg", "swin", "clip", "dinov2", "dino", "vgg",
                    "seg_ade", "det_coco")


def _dealias(tree):
    """Clone every leaf whose storage an earlier leaf already uses, so that
    in-place updates of one never reach another (a bundle may share
    ``unet.conv_in`` with ``unet_orig_conv_in``)."""
    seen = set()

    def f(x):
        if isinstance(x, dict):
            return {k: f(v) for k, v in x.items()}
        if isinstance(x, list):
            return [f(v) for v in x]
        if not isinstance(x, torch.Tensor):
            return x
        ptr = x.untyped_storage().data_ptr()
        if ptr in seen:
            return x.clone()
        seen.add(ptr)
        return x

    return f(tree)


def _const_mask(tree, value: bool):
    """A mask tree shaped like ``tree`` with every entry ``value``."""
    if isinstance(tree, dict):
        return {k: _const_mask(v, value) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_const_mask(v, value) for v in tree]
    return value


def _set_u_untrainable(mask_tree):
    """Every ``u`` (a power-iteration vector) of a head mask set to False."""
    if isinstance(mask_tree, dict):
        for k in mask_tree:
            if k == "u":
                mask_tree[k] = False
            else:
                _set_u_untrainable(mask_tree[k])
    elif isinstance(mask_tree, list):
        for v in mask_tree:
            _set_u_untrainable(v)
    return mask_tree


@torch.no_grad()
def _copy_into(dst, src, path=""):
    """Copy the leaves of ``src`` into the tensors of ``dst`` in place."""
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"checkpoint tree differs at '{path}': {sorted(set(dst) ^ set(src))}")
        for k in dst:
            _copy_into(dst[k], src[k], f"{path}.{k}" if path else k)
    elif isinstance(dst, list):
        if len(dst) != len(src):
            raise ValueError(f"checkpoint tree differs at '{path}'")
        for i, (d, s) in enumerate(zip(dst, src)):
            _copy_into(d, s, f"{path}.{i}")
    elif isinstance(dst, torch.Tensor):
        if dst.shape != src.shape:
            raise ValueError(f"checkpoint leaf '{path}': {tuple(src.shape)}, "
                             f"the model has {tuple(dst.shape)}")
        dst.copy_(src)


def _named_leaves(tree, prefix=""):
    """(dotted path, tensor) of every leaf of a param tree, in tree order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named_leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _named_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)] if isinstance(tree, torch.Tensor) else []


def _u_leaves(tree, out=None):
    """The ``u`` entries of a head tree as (parent dict, tensor) in tree order."""
    out = [] if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "u":
                out.append(tree)
            else:
                _u_leaves(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _u_leaves(v, out)
    return out


def _landmark_maps(batch, layer: int):
    """The landmark targets of a collated batch's items splatted again at
    ``layer`` from its ``landmark_coords``: (probs, masks) stacked."""
    res = batch["image"].shape[1]
    maps = [build_landmark_target(g, c, layer, res) for g, c in batch["landmark_coords"]]
    return np.stack([m[0] for m in maps]), np.stack([m[1] for m in maps])


def _tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dicts and lists (None kept)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _structure(tree):
    """A hashable key of a tree's layout: its keys, and each tensor's shape
    and dtype (a captured step takes inputs of one structure only)."""
    if isinstance(tree, dict):
        return tuple((k, _structure(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(_structure(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    return tree


class _StaticStep:
    """The dispatch's step for one (landmark layer, accumulation phase,
    input structure): the Coach's G + D step (``Coach._step``) over static
    input buffers, which each step of a dispatch fills.

    On the card the step's first run is eager, on a side stream (it builds
    every kernel and is the dispatch's real step); then the same step is
    captured into a ``torch.cuda.CUDAGraph`` in the Coach's memory pool and
    each later step is one replay, which writes the static outputs (the
    loss terms, the prediction, the gradients on the leaves' ``.grad``). A
    replay does not pass through the kernel wrappers, so it adds the
    capture's launches to their counts. A capture error raises. On the CPU
    the same static-buffer step runs eagerly each time."""

    def __init__(self, coach: "Coach", inputs, landmark_layer: Optional[int], phase: bool):
        self.inputs = _tree_map(torch.clone, inputs)
        self.graph = None
        self.launches: Dict[str, int] = {}
        self.capture_seconds = 0.0

        def body():
            x = self.inputs
            return coach._step(x["batch"], landmark_layer, x["g"], x["d"], opt_phase=phase)

        self._body = body
        if coach.device.type != "cuda":
            self.first = body()
            return
        dev, side = coach.device, coach._side_stream
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.first = body()
        before = launch_counts()
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        # in a process group the collective library's own threads keep querying
        # its events while this thread captures
        mode = "global" if coach.group is None else "thread_local"
        with torch.cuda.graph(self.graph, pool=coach.graph_pool, stream=side,
                              capture_error_mode=mode):
            self.outputs = body()
        self.capture_seconds = time.perf_counter() - t0
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        add_launch_counts({k: -n for k, n in self.launches.items()})  # nothing ran yet
        torch.cuda.current_stream(dev).wait_stream(side)
        self._leaves = trainable_leaves(coach.params, coach.g_mask)
        self._grads = [t.grad for t in self._leaves]  # held: the pool keeps them apart

    def run(self):
        """One step over the static inputs: (the loss terms, the prediction)."""
        if self.graph is None:
            return self._body()
        self.graph.replay()
        add_launch_counts(self.launches)
        for t, g in zip(self._leaves, self._grads):
            t.grad = g
        return self.outputs


class Coach:
    def __init__(
        self,
        cfg: TrainConfig,
        *,
        statics: Optional[RestorerStatics] = None,
        params: Optional[Dict[str, Any]] = None,
        lpips_params=None,
        arcface_params=None,
        disc_backbone=None,
        vit_cfg=DINOV2_VITL14,
        datasets=None,
        mtcnn_params=None,
        device=None,
    ):
        if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not torch.distributed.is_initialized():
            raise RuntimeError("WORLD_SIZE > 1 but no process group: call "
                               "parallel.distributed.init_distributed() before the Coach")
        self.cfg = cfg
        # multi-process: rank 0 owns logs and checkpoints, every rank feeds
        # its rows of the global batch
        self.group = pdist.default_group()
        self.process_count = pdist.process_count()
        self.primary = pdist.is_primary()
        if device is None and self.process_count > 1:
            device = pdist.local_device()
        self.device = resolve_device(device)
        if (cfg.compute.steps_per_dispatch > 1 and self.device.type == "cuda"
                and self.group is not None and torch.distributed.get_backend() != "nccl"):
            raise ValueError(
                "steps_per_dispatch > 1 captures the step in a CUDA graph, and only NCCL's "
                f"all-reduces can join one ({torch.distributed.get_backend()} copies CUDA "
                "tensors through the host): run the group on NCCL or dispatch one step")
        self.statics = statics or RestorerStatics.from_model_config(cfg.model)
        self.vit_cfg = vit_cfg
        self.logger = CoachLogger(cfg.log.exp_dir, use_tensorboard=cfg.log.log2wandb,
                                  primary=self.primary)
        self.logger.log_config(encode_config(cfg))
        if cfg.compute.batch_size % self.process_count:
            raise ValueError(f"multi-process run: global batch_size={cfg.compute.batch_size} "
                             f"must be divisible by the {self.process_count} processes")
        if self.process_count > 1:
            self.logger.log_message(f"multi-process: {self.process_count} processes, one card "
                                    f"each, {torch.distributed.get_backend()}")
        self.train_step_num = 0
        self.best_val_loss = float("inf")
        dev = self.device

        gen = torch.Generator(device=dev).manual_seed(cfg.compute.seed)
        if params is None:
            if cfg.model.checkpoint_path:
                params = ckpt_mod.import_reference_checkpoint(cfg.model.checkpoint_path,
                                                              device=dev)["bundle"]
                self.logger.log_message(f"loaded checkpoint {cfg.model.checkpoint_path}")
            else:
                params = init_restorer_params(gen, self.statics,
                                              lora_rank_unet=cfg.model.lora_rank_unet,
                                              lora_rank_vae=cfg.model.lora_rank_vae, device=dev)
                if not cfg.model.train_vae:
                    params["vae"] = strip_lora(params["vae"])
        # fp32 leaves on the device (the optimizer's rule), no two sharing storage
        self.params = _dealias(tree_to(params, dev, torch.float32))

        self.lpips_params = tree_to(lpips_params, dev)
        if self.lpips_params is None and cfg.optim.lambda_lpips > 0:
            self.lpips_params = init_lpips_params(gen, device=dev)
        self.arcface_params = tree_to(arcface_params, dev)
        self._id_detect_fn = None
        if cfg.optim.id_detect_predictions and mtcnn_params is not None:
            from instantrestore_tpu_torch.data.mtcnn import landmark_detector

            self._id_detect_fn = landmark_detector(tree_to(mtcnn_params, dev))

        # the discriminator: backbone by gan_disc_type, 'dinov2' for anything
        # unknown (the config default 'vagan_clip' included)
        gd = cfg.optim.gan_disc_type
        self.disc_type = gd if gd in KNOWN_DISC_TYPES else "vgg" if "vgg" in gd else "dinov2"
        self.disc_backbone = tree_to(disc_backbone, dev)
        self.disc_heads = None
        if cfg.optim.lambda_gan > 0:
            if self.disc_type in SIMPLE_HEADS:
                if self.disc_backbone is None:
                    self.disc_backbone = self._init_conv_backbone(gen)
                in_ch, out_size = SIMPLE_HEADS[self.disc_type]
                self.disc_heads = gan_mod.init_simple_head(gen, in_ch=in_ch, out_size=out_size,
                                                           device=dev)
            else:
                if vit_cfg is DINOV2_VITL14:  # the default: the backbone of the disc type
                    self.vit_cfg = {"clip": CLIP_VITB32, "dino": DINO_VITB16}.get(
                        self.disc_type, vit_cfg)
                if self.disc_backbone is None:
                    from instantrestore_tpu_torch.models.vit import init_vit_params

                    self.disc_backbone = init_vit_params(gen, self.vit_cfg, device=dev)
                self.disc_heads = gan_mod.init_discriminator_heads(
                    gen, embed_dim=self.vit_cfg.embed_dim,
                    out_ch=128 if self.disc_type == "dino" else 256,
                    token_dim=self.vit_cfg.proj_dim or self.vit_cfg.embed_dim, device=dev)

        # the two optimizers: G over LoRA, unet.conv_in (and the VAE skip
        # convs with use_shortcuts; the capture nets' LoRA and their conv_in
        # with train_reference_networks); D over the heads but their u vectors
        p = self.params
        skips = (("skip_conv_1", "skip_conv_2", "skip_conv_3", "skip_conv_4")
                 if cfg.model.use_shortcuts else ())
        self.g_mask = {
            "unet": trainable_mask(p["unet"], extra_trainable=("conv_in",)),
            "unet_orig_conv_in": trainable_mask(p["unet_orig_conv_in"]),
            "vae": trainable_mask(p["vae"], extra_trainable=skips),
            "caption_enc": False,
        }
        if cfg.model.train_reference_networks and "original_unet" in p:
            self.g_mask["original_unet"] = trainable_mask(p["original_unet"],
                                                          extra_trainable=("conv_in",))
            self.g_mask["original_vae"] = trainable_mask(p["original_vae"])
        for k in p:
            self.g_mask.setdefault(k, _const_mask(p[k], False))
        acc = cfg.optim.gradient_accumulation_steps
        self.g_opt = make_optimizer(cfg.optim, cfg.steps.max_steps, self.g_mask, acc)
        self.d_mask = self.d_opt = None
        if self.disc_heads is not None:
            self.d_mask = _set_u_untrainable(_const_mask(self.disc_heads, True))
            self.d_opt = make_optimizer(cfg.optim, cfg.steps.max_steps, self.d_mask, acc)

        if datasets is not None:
            self.train_dataset, self.test_dataset = datasets
        else:
            self.train_dataset, self.test_dataset = self._build_datasets()
        if cfg.data.overfit:
            self.logger.log_message("WARNING: Running in overfit mode!")
            self.train_dataset.shuffle(cfg.compute.seed)
            self.train_dataset.paths = self.train_dataset.paths[: cfg.compute.batch_size]
            self.test_dataset = self.train_dataset
        ranks = dict(process_index=pdist.process_index(), process_count=self.process_count)
        self.train_loader = DataLoader(self.train_dataset, cfg.compute.batch_size,
                                       shuffle=not cfg.data.overfit,
                                       num_workers=cfg.compute.workers, seed=cfg.compute.seed,
                                       **ranks)
        # multi-process: a partial final batch cannot split across processes
        self.test_loader = DataLoader(self.test_dataset, cfg.compute.test_batch_size,
                                      shuffle=False, num_workers=cfg.compute.test_workers,
                                      drop_last=self.process_count > 1, **ranks)

        self._build_steps()
        if self.group is not None:  # every rank starts from rank 0's state
            pdist.broadcast_([t for _, t in _named_leaves(self.params)]
                             + [t for _, t in _named_leaves(self.disc_heads)], group=self.group)
        if cfg.log.resume_from:
            self.restore(cfg.log.resume_from)

    # ------------------------------------------------------------------

    def _init_conv_backbone(self, gen):
        dev, dt = self.device, self.disc_type
        if dt == "vgg":
            return gan_mod.init_vgg_backbone(gen, device=dev)
        if dt in ("swin", "seg_ade", "det_coco"):
            from instantrestore_tpu_torch.models.swin import init_swin_params

            return init_swin_params(gen, device=dev)
        from instantrestore_tpu_torch.training.losses import backbones

        if dt == "face_seg":
            return backbones.init_parsing_unet(gen, device=dev)
        return backbones.init_resnet18(gen, device=dev)

    def _build_datasets(self):
        cfg = self.cfg
        if cfg.data.dataset_type == "face_restore":
            train = RestoreDataset(
                cfg.data.data_root,
                max_conditioning_images=cfg.data.max_conditioning_images,
                resolution=cfg.data.resolution,
                train_input=cfg.model.train_input,
                get_gt_attn_probs=cfg.optim.lambda_landmark > 0,
                get_attn_pos_reg=cfg.optim.lambda_pos_reg > 0,
                get_attn_neg_reg=cfg.optim.lambda_neg_reg > 0,
                get_facial_comps=cfg.optim.lambda_facial_comp > 0,
                get_id_mats=cfg.optim.lambda_id_loss > 0 and self.arcface_params is not None,
                return_degradation_params=cfg.optim.lambda_cycle > 0,
                seed=cfg.compute.seed,
            )
            test = RestoreDatasetTest(cfg.data.val_data_root,
                                      max_conditioning_images=cfg.data.max_conditioning_images,
                                      resolution=cfg.data.resolution)
            return train, test
        if cfg.data.dataset_type in ("debug", "augmentations"):
            from instantrestore_tpu_torch.data.datasets import PairedDataset

            kw = dict(max_conditioning_images=cfg.data.max_conditioning_images,
                      resolution=cfg.data.resolution)
            return (PairedDataset(cfg.data.data_root, seed=cfg.compute.seed, **kw),
                    PairedDataset(cfg.data.val_data_root, **kw))
        raise ValueError(f"unknown dataset type {cfg.data.dataset_type!r}")

    def _build_steps(self):
        cfg = self.cfg
        # full probabilities only for the landmark term's layer; the entropy
        # and pos/neg regularisers read streamed per-segment sums
        self._need_landmark_probs = cfg.optim.lambda_landmark > 0
        self._need_seg_stats = (cfg.optim.lambda_attn_reg > 0 or cfg.optim.lambda_pos_reg > 0
                                or cfg.optim.lambda_neg_reg > 0)
        on_cuda = self.device.type == "cuda"
        fused = cfg.compute.fused_attention
        self._fused_attention = on_cuda if fused is None else fused
        remat = cfg.compute.remat
        self._remat = on_cuda if remat is None else remat
        self.logger.log_message(
            f"attention path: {'fused kernels' if self._fused_attention else 'unfused'}, "
            f"remat {'on' if self._remat else 'off'}"
            + (" [the landmark layer's shared attention runs unfused for its probabilities]"
               if self._need_landmark_probs and self._fused_attention else ""))
        self._g_steps: Dict[Optional[int], Any] = {}
        self._g_draws: Dict[str, Any] = {}
        # the dispatch's static steps by (landmark layer, phase, input structure)
        self._static_steps: Dict[Any, _StaticStep] = {}
        self.graph_pool = torch.cuda.graph_pool_handle() if on_cuda else None
        self._side_stream = torch.cuda.Stream(self.device) if on_cuda else None
        # the moments and device scalars exist before any capture
        self.g_opt.bind(self.params)
        if self.d_opt is not None:
            self.d_opt.bind(self.disc_heads)

    def _g_step_fn(self, landmark_layer: Optional[int]):
        """The port's train step, one per landmark layer (the layer whose
        probabilities it saves)."""
        if landmark_layer not in self._g_steps:
            probs = self._need_landmark_probs and landmark_layer is not None
            self._g_steps[landmark_layer] = make_train_step(
                self.statics, self.cfg.optim, self.g_opt, self.g_mask, self._g_loss,
                save_attn_probs=probs, probs_layers=(landmark_layer,) if probs else None,
                save_seg_sums=self._need_seg_stats, use_fused_attention=self._fused_attention,
                remat=self._remat, device=self.device, process_group=self.group)
        return self._g_steps[landmark_layer]

    def _g_loss(self, out, batch, ocfg, counts=None):
        d = self._g_draws
        degrade_fn = None
        if ocfg.lambda_cycle > 0 and "degradation_params" in batch:
            from instantrestore_tpu_torch.ops.image_ops import degrade_with_params

            def degrade_fn(pred_pm1):
                # the batch's own degradation parameters on the prediction, in [0, 1]
                return degrade_with_params((pred_pm1 + 1.0) * 0.5, batch["degradation_params"],
                                           noise=d["cycle_noise"],
                                           resolution=pred_pm1.shape[1]) * 2.0 - 1.0

        return compute_generator_loss(
            out, batch, ocfg, layer_idx=d["layer_idx"], lpips_params=self.lpips_params,
            arcface_params=self.arcface_params, disc_backbone=self.disc_backbone,
            disc_heads=self.disc_heads, vit_cfg=self.vit_cfg, disc_type=self.disc_type,
            gan_draws=d["gan_draws"], train_input=self.statics.train_input,
            degrade_fn=degrade_fn, landmark_layer=d["landmark_layer"], counts=counts)

    # ---- the random draws ----------------------------------------------

    def _global_batch(self, batch) -> int:
        return batch["image"].shape[0] * self.process_count

    def _local(self, draws, batch):
        """This rank's rows of draws made for the global batch."""
        return pdist.local_rows(draws, self._global_batch(batch))

    def _restore_noise(self, batch, gen) -> Dict[str, torch.Tensor]:
        _, h, w = batch["image"].shape[:3]
        b = self._global_batch(batch)
        shape = (b, h // 8, w // 8, 4)
        noise = {k: torch.randn(shape, generator=gen, device=gen.device)
                 for k in ("latent", "diffusion")}
        if batch.get("conditioning_images") is not None and self.statics.use_shared_attention:
            n = batch["conditioning_images"].shape[1]
            for k in ("cond_latent", "cond_diffusion"):
                noise[k] = torch.randn((b * n,) + shape[1:], generator=gen, device=gen.device)
        return {k: v.to(self.device) for k, v in self._local(noise, batch).items()}

    def _draw_layer(self, gen) -> torch.Tensor:
        """The shared layer the reference-usage regularisers read (a 0-d
        tensor on the card: the loss selects it there)."""
        n = self.statics.unet_cfg.num_shared_attn_layers
        return torch.randint(n, (), generator=gen, device=gen.device).to(self.device)

    def _crop_sizes(self, batch, boxes_used: bool):
        return facial_comp_sizes(batch["image"].shape[1]) if boxes_used else ()

    def draw_g(self, batch, gen: torch.Generator) -> Dict[str, Any]:
        """Every random choice of one G step on ``batch``, from ``gen``: the
        restore noise and timestep, the reference-usage layer, DiffAugment's
        draws (the whole image, then each facial crop) and the cycle term's
        noise, each drawn for the global batch and cut to this rank's rows.
        The timestep and the layer are 0-d tensors on the card."""
        from instantrestore_tpu_torch.ops.image_ops import cycle_noise_shapes

        _, h, w = batch["image"].shape[:3]
        b = self._global_batch(batch)
        ts = self.statics.noise_timesteps
        draws: Dict[str, Any] = {
            "noise": self._restore_noise(batch, gen),
            "timestep": timestep_table(self.statics, self.device)[  # a [1] index: no host read
                torch.randint(len(ts), (1,), generator=gen, device=gen.device).to(self.device)][0],
            "layer_idx": self._draw_layer(gen),
            "gan_draws": None, "cycle_noise": None,
        }
        if self.disc_heads is not None:
            crops = self._crop_sizes(batch, self.cfg.optim.lambda_facial_comp > 0
                                     and batch.get("facial_comp_boxes") is not None)
            draws["gan_draws"] = self._local(
                [gan_mod.diff_augment_draws(b, hh, ww, gen, self.device)
                 for hh, ww in [(h, w)] + list(crops)], batch)
        if self.cfg.optim.lambda_cycle > 0 and "degradation_params" in batch:
            draws["cycle_noise"] = self._local(
                [torch.randn(s, generator=gen, device=gen.device).to(self.device)
                 for s in cycle_noise_shapes(b, h, w)], batch)
        return draws

    def draw_d(self, batch, gen: torch.Generator) -> List[Dict[str, torch.Tensor]]:
        """DiffAugment's draws of one D step: the real image's, the fake's,
        then (real, fake) per facial crop (the global batch's, cut to this
        rank's rows)."""
        _, h, w = batch["gt"].shape[:3]
        sizes = [(h, w)] * 2
        for hh, ww in self._crop_sizes(batch, batch.get("facial_comp_boxes") is not None):
            sizes += [(hh, ww)] * 2
        b = self._global_batch(batch)
        return self._local([gan_mod.diff_augment_draws(b, hh, ww, gen, self.device)
                            for hh, ww in sizes], batch)

    def draw_eval(self, batch, gen: torch.Generator) -> Dict[str, Any]:
        """The eval step's draws: the restore noise and the reference-usage layer."""
        return {"noise": self._restore_noise(batch, gen),
                "layer_idx": self._draw_layer(gen)}

    # ---- the steps ---------------------------------------------------------

    def g_step(self, batch: Dict[str, Any], landmark_layer: Optional[int],
               draws: Dict[str, Any], opt_phase: Optional[bool] = None
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One generator step on a device batch (``to_torch_batch``) with
        ``draws`` (``draw_g``): the trainable leaves and the G optimizer move
        in place (every k-th call under accumulation). ``opt_phase``: as
        ``MaskedAdamW.update``'s ``phase`` (the dispatch's static step).
        Returns (the loss terms, the prediction)."""
        self._g_draws = dict(draws, landmark_layer=landmark_layer)
        try:
            metrics, out = self._g_step_fn(landmark_layer)(
                self.params, batch, noise=draws["noise"], timestep=draws["timestep"],
                opt_phase=opt_phase)
        finally:
            self._g_draws = {}
        return metrics, out["output_image"].detach()

    def d_step(self, pred: torch.Tensor, real: torch.Tensor, boxes: Optional[torch.Tensor], *,
               draws: List[Dict[str, torch.Tensor]], opt_phase: Optional[bool] = None
               ) -> torch.Tensor:
        """One discriminator step: the multi-level loss on the real images and
        on the detached prediction (and on their facial crops at ``boxes``),
        its gradient w.r.t. the heads but their ``u`` vectors, the new ``u``
        of the power iteration, then AdamW on the heads in place
        (``opt_phase`` as ``g_step``'s). Returns the loss."""
        cfg, heads = self.cfg.optim, self.disc_heads
        fake = pred.detach()
        kw = dict(vit_cfg=self.vit_cfg, disc_type=self.disc_type, update_sn=True)
        freeze_non_trainable(heads, self.d_mask)
        try:
            l_real, new = gan_mod.discriminate(self.disc_backbone, heads, real, draws=draws[0],
                                               for_real=True, **kw)
            l_fake, new = gan_mod.discriminate(self.disc_backbone, new, fake, draws=draws[1],
                                               for_real=False, **kw)
            loss = 0.5 * (l_real.mean() + l_fake.mean()) * cfg.lambda_gan
            if boxes is not None:
                # the facial-component terms on eye and mouth crops of both
                fc = loss.new_zeros(())
                for i, (hh, ww) in enumerate(facial_comp_sizes(real.shape[1])):
                    o = boxes[:, i]
                    lr, new = gan_mod.discriminate(
                        self.disc_backbone, new, crop_with_boxes(real, o, hh, ww),
                        draws=draws[2 + 2 * i], for_real=True, **kw)
                    lf, new = gan_mod.discriminate(
                        self.disc_backbone, new, crop_with_boxes(fake, o, hh, ww),
                        draws=draws[3 + 2 * i], for_real=False, **kw)
                    fc = fc + lr.mean() + lf.mean()
                loss = loss + fc * cfg.lambda_gan * cfg.lambda_facial_comp
            loss = loss / self.process_count  # this rank's share of the global batch's means
            leaves = trainable_leaves(heads, self.d_mask)
            grads = list(torch.autograd.grad(loss, leaves))
        finally:
            freeze_non_trainable(heads, _const_mask(heads, False))
        with torch.no_grad():
            for old, fresh in zip(_u_leaves(heads), _u_leaves(new)):
                old["u"].copy_(fresh["u"])
        loss = loss.detach()
        if self.group is not None:
            pdist.all_reduce_sum_(grads, self.group)
            loss = reduce_metrics({"loss_d": loss}, self.group)["loss_d"]
        self.d_opt.update(heads, grads, phase=opt_phase)
        return loss

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, Any], draws: Dict[str, Any], *, save_attn: bool = False,
                  save_stats: bool = False):
        """The restore at ``cfg.model.noise_timestep`` and its loss terms
        (no GAN or cycle term), without gradients. ``save_stats`` adds the
        streamed segment sums (the attention regularisers on every batch),
        ``save_attn`` the probabilities (the visualised batches). Returns
        (the loss terms, the prediction, the probabilities or None); across
        processes the terms are the global batch's, the prediction this
        rank's rows."""
        counts = loss_counts(batch)
        if self.group is not None:  # the global batch's
            pdist.all_reduce_sum_([counts], self.group)
        out = restore_forward(
            self.params, batch["image"], batch.get("conditioning_images"),
            batch.get("valid_indices"), statics=self.statics,
            timestep=self.cfg.model.noise_timestep, noise=draws["noise"],
            save_attn_probs=save_attn, save_seg_sums=save_stats,
            use_fused_attention=self._fused_attention)
        _, losses = compute_generator_loss(
            out, batch, self.cfg.optim, layer_idx=draws["layer_idx"],
            lpips_params=self.lpips_params, arcface_params=self.arcface_params,
            train_input=self.statics.train_input, counts=counts)
        if self.group is not None:
            losses = reduce_metrics(losses, self.group)
        return losses, out["output_image"], out.get("attn_probs")

    # ---- the loop ----------------------------------------------------------

    def _step_seed(self, step: int) -> int:
        return (self.cfg.compute.seed * 2**32 + step) % 2**63

    def train(self):
        """Steps until ``cfg.steps.max_steps`` (``compute.steps_per_dispatch``
        at a time), then a validation and the ``final`` checkpoint."""
        cfg = self.cfg
        n_batches = len(self.train_loader)
        if n_batches == 0:
            raise ValueError(f"the training set ({len(self.train_dataset)} items) holds no batch "
                             f"of {cfg.compute.batch_size}")
        spd = max(1, cfg.compute.steps_per_dispatch)
        gen = torch.Generator(device=self.device)
        self._t0 = time.time()
        self._steps_since_metric = 0
        pending: List[Dict[str, Any]] = []  # carries across the loader's epoch ends
        while self.train_step_num < cfg.steps.max_steps:
            epoch, offset = divmod(self.train_step_num + len(pending), n_batches)
            self.train_loader.start_at(epoch, offset)
            for batch in self.train_loader:
                if self.train_step_num >= cfg.steps.max_steps:
                    break
                if spd == 1:
                    gen.manual_seed(self._step_seed(self.train_step_num))
                    self._run_single_step(batch, gen)
                    continue
                pending.append(batch)
                if len(pending) < min(spd, cfg.steps.max_steps - self.train_step_num):
                    continue
                self._run_dispatch(pending, gen)
                pending = []
        self.validate()
        self.save(tag="final")

    def _agree_on_batch(self, batch, dev_batch, landmark_layer):
        """Multi-process: keep only the keys every rank's batch has (one
        all-reduce of their presence and of rank 0's landmark layer), and
        splat this rank's landmark targets again at rank 0's layer where
        its own differs, as collate does for the items of one batch.
        ``batch``: the host batch behind ``dev_batch``, or the list of a
        dispatch's host batches behind its [N, B, ...] stack."""
        keys = DEVICE_KEYS + ("gt_attn_probs",)
        layer0 = (landmark_layer + 1 if landmark_layer is not None and self.primary else 0)
        vec = torch.tensor([float(k in dev_batch) for k in keys] + [float(layer0)],
                           device=self.device)
        pdist.all_reduce_sum_([vec], self.group)
        have = vec.tolist()
        drop = [k for k, n in zip(keys, have) if k in dev_batch and n < self.process_count]
        if drop:
            self.logger.log_message(f"dropping {drop}: not in every rank's batch")
        for k in drop:
            dev_batch.pop(k)
            if k == "gt_attn_probs":
                dev_batch.pop("gt_attn_mask")
                dev_batch.pop("gt_attn_cond")
                landmark_layer = None
        if landmark_layer is not None and landmark_layer != int(have[-1]) - 1:
            landmark_layer = int(have[-1]) - 1
            stacked = isinstance(batch, list)
            maps = [_landmark_maps(b, landmark_layer) for b in (batch if stacked else [batch])]
            for i, k in enumerate(("gt_attn_probs", "gt_attn_mask")):
                x = np.stack([m[i] for m in maps]) if stacked else maps[0][i]
                dev_batch[k] = torch.as_tensor(x).to(self.device)
        return dev_batch, landmark_layer

    def _run_single_step(self, batch, gen: torch.Generator):
        dev_batch, landmark_layer = to_torch_batch(batch, self.device)
        if self.group is not None:
            dev_batch, landmark_layer = self._agree_on_batch(batch, dev_batch, landmark_layer)
        losses, pred = self._step(dev_batch, landmark_layer, self.draw_g(dev_batch, gen),
                                  self._draw_d_if(dev_batch, gen))
        self._after_steps(1, losses, pred, batch)

    def _draw_d_if(self, dev_batch, gen):
        return self.draw_d(dev_batch, gen) if self.disc_heads is not None else None

    def _step(self, batch, landmark_layer, g_draws, d_draws, opt_phase=None):
        """One G step and one D step on the prediction (the body of a
        one-step run and of the dispatch's static step). Returns (the loss
        terms with ``loss_d``, the prediction)."""
        losses, pred = self.g_step(batch, landmark_layer, g_draws, opt_phase)
        if self.disc_heads is not None:
            losses["loss_d"] = self.d_step(pred, batch["gt"], batch.get("facial_comp_boxes"),
                                           draws=d_draws, opt_phase=opt_phase)
        return losses, pred

    # ---- the multi-step dispatch ----------------------------------------

    def _stack_batches(self, batches) -> Tuple[Dict[str, Any], Optional[int]]:
        """N collated batches -> one [N, B, ...] tree of ``to_torch_batch``'s
        keys on the card, and the landmark layer (JAX's ``_stack_batches``).
        The steps share the first batch's landmark layer: a batch whose
        layer differs is splatted again at it from its ``landmark_coords``;
        the targets are dropped where some batch lacks them or its
        coordinates, and so is every key that only some batches hold."""
        all_lm = all(b.get("gt_attn_probs") is not None for b in batches)
        if batches[0].get("gt_attn_probs") is not None and not all_lm:
            self.logger.log_message("dispatch: dropping landmark targets (present in only some "
                                    "of the stacked batches)")
        if all_lm and not all(b.get("landmark_coords") for b in batches):
            self.logger.log_message("dispatch: dropping landmark targets (no landmark_coords to "
                                    "rebuild a shared layer)")
            all_lm = False
        landmark_layer = None
        host = []
        for b in batches:
            keep = {k: b[k] for k in DEVICE_KEYS if k in b}
            if all_lm:
                probs, masks, layer, conds = b["gt_attn_probs"]
                if landmark_layer is None:
                    landmark_layer = int(layer)
                elif int(layer) != landmark_layer:
                    probs, masks = _landmark_maps(b, landmark_layer)
                keep["gt_attn_probs"] = np.asarray(probs, np.float32)
                keep["gt_attn_mask"] = np.asarray(masks, bool)
                keep["gt_attn_cond"] = np.asarray(conds, np.int32)
            host.append(keep)
        common = [k for k in host[0] if all(k in h for h in host[1:])]
        dropped = sorted({k for h in host for k in h} - set(common))
        if dropped:
            self.logger.log_message(f"dispatch: dropping {dropped} (present in only some of the "
                                    "stacked batches)")

        def stack(*xs):
            if isinstance(xs[0], dict):
                return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
            if isinstance(xs[0], (tuple, list)):
                return [stack(*parts) for parts in zip(*xs)]
            return torch.as_tensor(np.stack([np.asarray(x) for x in xs])).to(self.device)

        return {k: stack(*(h[k] for h in host)) for k in common}, landmark_layer

    def _run_dispatch(self, batches, gen: torch.Generator):
        """N G + D steps on N batches: stacked on the card once; per step its
        draws from the per-step seed, then the static step."""
        n = len(batches)
        stacked, landmark_layer = self._stack_batches(batches)
        if self.group is not None:
            stacked, landmark_layer = self._agree_on_batch(list(batches), stacked,
                                                           landmark_layer)
        for i in range(n):
            batch = _tree_map(lambda t: t[i], stacked)
            gen.manual_seed(self._step_seed(self.train_step_num + i))
            losses, pred = self._static_step(batch, landmark_layer, self.draw_g(batch, gen),
                                             self._draw_d_if(batch, gen))
        self._after_steps(n, losses, pred, batches[-1])

    def _static_step(self, batch, landmark_layer, g_draws, d_draws):
        """One step of a dispatch: the optimizers' device scalars written,
        the inputs copied into the static buffers of the step for this
        (landmark layer, accumulation phase, input structure), that step
        replayed (captured first if new), the counts advanced."""
        opts = [o for o in (self.g_opt, self.d_opt) if o is not None]
        for o in opts:
            o.write_scalars()
        phase = self.g_opt.applies()  # the D optimizer's micro-steps keep the same count
        inputs = {"batch": batch, "g": g_draws, "d": d_draws}
        key = (landmark_layer, phase, _structure(inputs))
        step = self._static_steps.get(key)
        if step is None:
            step = self._static_steps[key] = _StaticStep(self, inputs, landmark_layer, phase)
            out = step.first
        else:
            _copy_into(step.inputs, inputs)
            out = step.run()
        for o in opts:
            o.advance()
        return out

    def _after_steps(self, n, losses, pred, last_batch):
        """Bookkeeping after n steps (JAX's): an interval fires when the step
        count crosses a multiple of it; the metrics are the last step's
        losses and ``steps_per_sec`` over the steps since the last log."""
        cfg = self.cfg
        prev = self.train_step_num
        self.train_step_num += n
        self.logger.update_step(self.train_step_num)

        def crossed(interval):
            return self.train_step_num // interval > prev // interval

        self._steps_since_metric += n
        if crossed(cfg.steps.metric_interval):
            scalars = {k: float(v) for k, v in losses.items()}
            scalars["steps_per_sec"] = self._steps_since_metric / max(time.time() - self._t0, 1e-9)
            self._t0 = time.time()
            self._steps_since_metric = 0
            self.logger.log_metrics(scalars, "train")
        if crossed(cfg.steps.image_interval):
            self.logger.vis_batch("train_images", {"input": last_batch["image"],
                                                   "pred": pred.float().cpu().numpy(),
                                                   "gt": last_batch["gt"]})
        if crossed(cfg.steps.val_interval):
            self.validate()
        if crossed(cfg.steps.save_interval):
            if self.group is not None:
                self.check_replicas_agree()
            # interval checkpoints are for crash recovery: the full trainer state
            self.save(tag=f"step_{self.train_step_num}", full=True)

    def check_replicas_agree(self):
        """Raise on every rank unless the ranks' trainable leaves and heads
        are bit-equal (one checksum all-reduce)."""
        trainable = {id(t) for t in trainable_leaves(self.params, self.g_mask)}
        named = [(n, t) for n, t in _named_leaves(self.params) if id(t) in trainable]
        named += _named_leaves(self.disc_heads, "disc_heads.")
        pdist.check_replicas_agree([t for _, t in named], [n for n, _ in named], self.group)

    def validate(self) -> Optional[float]:
        """The whole test set: losses averaged over every batch;
        ``val_vis_count`` caps the visualised batches (batch_idx <=
        val_vis_count) and attention overlays go to the first six; the
        attention regularisers enter every batch's loss through the streamed
        segment sums, so the cap does not bias best-model selection."""
        agg: Dict[str, list] = {}
        gen = torch.Generator(device=self.device)
        for batch_idx, batch in enumerate(self.test_loader):
            dev_batch, _ = to_torch_batch(batch, self.device)
            shared_live = (self.statics.use_shared_attention
                           and "conditioning_images" in dev_batch)
            save_attn = batch_idx <= 5 and self.cfg.log.vis_attention and shared_live
            o = self.cfg.optim
            save_stats = shared_live and (o.lambda_attn_reg > 0 or o.lambda_pos_reg > 0
                                          or o.lambda_neg_reg > 0)
            gen.manual_seed(0)
            losses, pred, attn_probs = self.eval_step(dev_batch, self.draw_eval(dev_batch, gen),
                                                      save_attn=save_attn, save_stats=save_stats)
            for k, v in losses.items():
                agg.setdefault(k, []).append(float(v))
            pred_np = pred.float().cpu().numpy()
            if batch_idx == 0 and self._id_detect_fn is not None and (
                    self.arcface_params is not None):
                self._log_detected_id_sim(agg, pred_np, batch)
            if batch_idx <= self.cfg.log.val_vis_count:
                self.logger.vis_batch(f"val_images/{batch_idx:04d}",
                                      {"input": batch["image"], "pred": pred_np,
                                       "gt": batch["gt"]})
                if save_attn and attn_probs and self.logger.can_write_images():
                    from instantrestore_tpu_torch.utils.vis import vis_attn_probs

                    self.logger.save_image(f"val_attention/{batch_idx:04d}", vis_attn_probs(
                        [p.float().cpu().numpy() for p in attn_probs],
                        np.asarray(batch["conditioning_images"]),
                        train_input=self.statics.train_input))
        if not agg:
            return None
        mean_losses = {k: float(np.mean(v)) for k, v in agg.items()}
        self.logger.log_metrics(mean_losses, "val")
        if mean_losses.get("loss", math.inf) < self.best_val_loss:
            self.best_val_loss = mean_losses["loss"]
            self.save(tag="best_model")
            if self.primary:
                (Path(self.cfg.log.exp_dir) / "checkpoints" / "timestep.txt").write_text(
                    f"best val loss {self.best_val_loss:.5f} at step {self.train_step_num}\n")
        return mean_losses.get("loss")

    def _log_detected_id_sim(self, agg, pred: np.ndarray, batch):
        """The ID similarity of the first val batch aligned by MTCNN on the
        predictions and targets, beside the dataset-aligned one, so that the
        alignment's drift is a logged metric."""
        from instantrestore_tpu_torch.training.losses import id_loss as id_mod

        dev = self.device
        gt = np.asarray(batch["gt"], np.float32)
        mats_p, valid_p = id_mod.detector_alignment_mats(self._id_detect_fn, pred)
        mats_g, valid_g = id_mod.detector_alignment_mats(self._id_detect_fn, gt)
        valid = valid_p & valid_g
        t = lambda x: torch.as_tensor(np.asarray(x)).to(dev)  # noqa: E731
        with torch.no_grad():
            _, sim_det = id_mod.id_loss(self.arcface_params, t(pred), t(gt), t(mats_p), t(mats_g),
                                        t(valid))
            agg.setdefault("id_sim_detected", []).append(float(sim_det))
            agg.setdefault("id_detect_rate", []).append(float(valid.mean()))
            if "id_mats_pred" in batch:
                _, sim_ds = id_mod.id_loss(self.arcface_params, t(pred), t(gt),
                                           t(np.asarray(batch["id_mats_pred"], np.float32)),
                                           t(np.asarray(batch["id_mats_target"], np.float32)),
                                           t(batch["id_valid"]))
                agg.setdefault("id_sim_dataset_aligned", []).append(float(sim_ds))
                agg.setdefault("id_align_drift", []).append(abs(float(sim_det) - float(sim_ds)))

    # ---- checkpoints -------------------------------------------------------

    def save(self, tag: str, full: bool = False):
        """Write ``checkpoints/<tag>``: the weights (the file the Predictor
        serves) and the discriminator's heads, and with ``full`` the
        resumable state besides: both optimizers' moments, counts and
        accumulation buffers, and the best validation loss."""
        out = Path(self.cfg.log.exp_dir) / "checkpoints" / tag
        extra: Dict[str, Any] = {"full": full, "best_val_loss": self.best_val_loss}
        if self.disc_heads is not None:
            extra["disc_heads"] = self.disc_heads
        if full:
            extra["g_opt"] = self.g_opt.state()
            if self.d_opt is not None:
                extra["d_opt"] = self.d_opt.state()
        if self.primary:
            ckpt_mod.save_checkpoint(out, self.params, cfg=self.cfg, step=self.train_step_num,
                                     extra=extra)
            self.logger.log_message(f"saved checkpoint {out}")
        pdist.barrier(self.group)  # no rank reads a save before it is whole

    def restore(self, path):
        """Resume from a ``save`` file: the weights, the heads and the step
        counter, and from a full one both optimizers' state and the best
        validation loss. Every tensor is copied into the live one, so the
        optimizers stay bound to the leaves."""
        state = ckpt_mod.load_checkpoint(path)
        full = bool(state.get("full", False))
        _copy_into(self.params, state["params"])
        if self.disc_heads is not None and "disc_heads" in state:
            _copy_into(self.disc_heads, state["disc_heads"])
        if full:
            self.g_opt.load_state(self.params, state["g_opt"])
            if self.d_opt is not None and "d_opt" in state:
                self.d_opt.load_state(self.disc_heads, state["d_opt"])
        self.train_step_num = int(state.get("step") or 0)
        self.best_val_loss = float(state.get("best_val_loss", math.inf))
        self.logger.update_step(self.train_step_num)
        self.logger.log_message(f"resumed from {path} at step {self.train_step_num}"
                                f" ({'full' if full else 'weights-only'})")
        if not full and self.train_step_num > 0:
            self.logger.log_message(
                "WARNING: weights-only resume: the optimizer state (its step count, which the "
                f"learning-rate schedule reads, too) starts at 0 while train_step_num="
                f"{self.train_step_num}. Resume from an interval checkpoint (save(full=True)) "
                "for an exact continuation.")
