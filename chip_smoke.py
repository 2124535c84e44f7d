#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one NVIDIA GPU.

    python3 chip_smoke.py [--only kernels,vjp,serving,int8,training,options,recipe,small,checkpoint,coach,dispatch,parallel]

Without arguments every phase runs and the last two lines are the result;
``--only`` runs the named phases for a quick look and prints no result line.

1. prints the card (nvidia-smi name and power limit);
2. builds the CUDA kernels of instantrestore_tpu_torch/csrc (one nvcc each,
   in parallel) and prints the build seconds;
3. kernel phase: each kernel at the shapes a batch-16 restore gives it,
   bf16, held against its plain PyTorch version (max-abs error within a
   stated tolerance) and timed beside the plain version, one PyTorch
   library call on the same inputs (scaled_dot_product_attention, timed
   here only) and the card's bound for the same work. The bound and the
   online kernel of each function run on the same inputs: flash_bound and
   flash_online (d=64 and the d=512 VAE shape); shared_flash_bound,
   shared_online and shared_online_pair refs-only and with the input
   segment, with the AdaIN affine and one zeroed reference. Also an odd-N
   identity-cache row, the per-call paired route
   (INSTANTRESTORE_ATTN_ALGO=kv_outer_bound_paired, the identity kernel) and
   the q_outer route (shared_online). shared_online_pair must equal
   shared_online bit for bit on the same inputs, two launches of
   shared_online agree bit for bit, and the other tiles of the wgmma kernel
   (one consumer warpgroup at Sq % 128 == 64, the 64-key chunk at S = 64)
   are held against the plain versions too, for the online kernels and the
   two bound ones (shared_flash_bound, and shared_identity through the
   paired route). flash_online and flash_bound at d=64 run on the same wgmma
   tile in its plain layout, and at d=512 on the d=512 wgmma tile (the
   online and the bound policy): two launches agree bit for bit at every
   shape, and their other tiles (FLASH_VARIANT_SHAPES: Sq % 128 == 64, a
   64-key chunk, Sq != Skv; FLASH_VARIANT_D512: Sq != Skv at d=512) are held
   against the plain versions, flash_online's on the kernel's chunk; both
   also at d=512 at the cold capture's batch of 64 (FLASH_CAPTURE_D512).
   Each shared row also carries
   exp2_ms: its scores over 16 exp2 per clock per SM on 132 SMs at the
   card's maximum SM clock (nvidia-smi clocks.max.sm), the other unit that
   bounds a d=64 attention. The escape hatch: on a call whose bound slack
   passes 190 log2 units the two bound shared kernels (shared_flash_bound and,
   through the paired route, shared_identity) return no finite row, the
   online kernel finite rows equal to its plain version, twice the same bits;
   flash_bound at d=64 and d=512 loses exactly the rows its plain version
   loses (the rows of large norm, not those of small), and flash_online is
   finite on the same inputs.
   An identity id outside the cache makes exactly its sample's outputs NaN in
   both bound kernels that read the cache by id. Every d=64 serving kernel
   also runs at RAGGED_SHAPES (Sq or S off the tiles' 64 rows, as the JAX
   kernels take them), against its plain version, two launches bit for bit.
   GroupNorm (csrc/group_norm.cu) at every GroupNorm shape of a batch-16
   warm restore and of the batch-32 cold capture (GN_ENCODER, GN_UNET,
   GN_DECODER: with SiLU, conv1's bias and the time-embedding term where the
   model passes them) against its plain version, two launches bit for bit,
   timed beside the plain version, F.group_norm + F.silu and its bound (one
   read of x for the statistics, one read and one write for the output);
   the warm and cold phases check that each of their restores launched it
   113 and 196 times;
3b. flash-VJP kernel phase ("vjp"): flash_fwd_lse, flash_bwd_dq and
   flash_bwd_dkv at the shapes a batch-2 train step gives them (the 9 shared
   layers on K/V widened over 4 references, the UNet's down/mid
   self-attention, the d=512 VAE attention) and at FLASH_VARIANT_SHAPES (the
   other tiles: 64 query rows a block of the forward and of flash_bwd_dq, a
   64-key chunk of the forward, 64 keys a block of flash_bwd_dkv; the
   forward and the d=512 backward tile also at FLASH_VARIANT_D512, Sq != Skv
   at d=512, and all three at RAGGED_SHAPES, d=64): out, LSE (max-abs within
   1e-3 log2 units), dQ, dK, dV against the plain versions on the same
   inputs, two launches of each kernel bit-identical, one mid shape and the
   d=512 train-step shape against fp32 autograd through the unfused
   attention, and all three at the capture's shapes under a gradient
   (VJP_CAPTURE_SHAPES: batch 8, the capture UNet's self-attentions and the
   original VAE encoder's, with their time per G step of
   train_reference_networks printed); timed beside
   the plain versions, scaled_dot_product_attention forward and its autograd
   backward (dQ, dK, dV together), and the bounds;
4. warm phase: random full-width SD-Turbo weights (seeded), LoRA rank 32
   merged by serving_bundle, bf16; onboards 16 identities x 4 uint8 512^2
   references and restores batch 16 a few times. Checks the output
   ([16, 512, 512, 3] and finite; restore clamps it to [-1, 1], so the
   range holds by construction and is not checked), the kernel launch
   counts (9 + 9 per restore, 17 flash launches per onboarded identity),
   agreement with the unfused path on two samples; prints bound slack and a
   torch.profiler breakdown;
5. cold phase: restore_cold of the same batch with each sample's identity
   references re-encoded in the call (64 references captured in one pass);
   checks launches per cold restore (9 shared_flash_bound, 0
   shared_identity, 26 flash_bound), output shape and finiteness, agreement
   with the unfused path on two samples and with the warm restore of the
   same references and noise; prints latency, faces/sec, peak memory, the
   bound slack of every layer of a cold restore and a profile;
6. online-max phase: the same batch-16 restore_cold under
   INSTANTRESTORE_ATTN_ALGO=kv_outer and INSTANTRESTORE_FLASH_ALGO=online;
   checks launches per restore (9 shared_online, 26 flash_online, 0 of any
   bound kernel), output shape and finiteness, agreement with the default
   algorithms' cold restore; prints latency, faces/sec, peak memory and a
   profile, and a profile of one batch-16 warm restore under
   FLASH_ALGO=online (each with the d=512 flash kernels' share);
7. other paths at reduced batch: a train_input engine (warm restore through
   shared_flash_bound with its input segment), restore_forward_multistep
   (749, 499, 249), a cold restore under kv_outer_bound_paired (the identity
   kernel on per-call K/V), a warm restore under FLASH_ALGO=online, the
   train_input engine under kv_outer (shared_online with its input
   segment), cold restores under q_outer and kv_outer_packed (the pair
   kernel on the even-H layers, shared_online on the H = 5 ones), and
   Predictor.predict_batch; each checks its launch counts and its output
   against the default algorithms';
8. replacing one identity's references changes exactly its outputs;
8i. int8 phase ("int8"): the warm phase's seeded bundle in a bf16 engine
   and in ServingEngine(int8_decoder=True, int8_unet=True) (quantized from
   the fp32 bundle); 16 identities onboarded in each, the caches bit-equal
   (the capture networks stay bf16); warm batch-16 restores with dynamic
   scales, calibrate_int8 on another batch at margin 1.05, calibrated warm
   restores: faces/sec, device busy and peak memory of each against the
   bf16 engine's, launches as the warm phase's, bench.py's quality gates on
   the calibrated images against the bf16 ones (PSNR >= 30 dB with
   peak-to-peak 2, MS-SSIM >= 0.98, max-abs <= 0.5); each distinct int8
   conv shape of a warm restore with its count, the int8 route's ms, the
   cuDNN bf16 conv's ms on the same shape and the bound (int8 operations at
   1,979 TOPS or bytes at 3.35 TB/s); one cold int8 restore (finite, the
   cold phase's launches);
9. training phase: the generator step at full width (batch 2, 4 references,
   512 px, fp32 params with unmerged rank-32 LoRA, bf16 compute, L2 + LPIPS
   with random VGG weights, AdamW with global-norm clipping on the LoRA
   leaves and unet.conv_in, fused attention, remat): a warm-up step and 4
   timed steps. Checks a finite loss and gradients; launches per step (36
   flash_fwd_lse: 18 attentions with a gradient, each forward run again when
   remat rebuilds its stage; 18 flash_bwd_dq; 18 flash_bwd_dkv; 17
   flash_bound in the frozen capture and no backward launch from it); only
   trainable leaves changed; under deterministic cuDNN two runs of one step
   give identical gradients, remat=False gives the same bits (or its
   out-of-memory line is printed), and the fused step agrees with the
   unfused one on the loss and on gradients by leaf group; a step with
   save_seg_sums and the attention regularisers runs. Prints ms per step,
   faces/sec, peak memory with and without remat and a profile with the
   share of the three flash-VJP kernels;
9o. options phase ("options"): the three model options at full width. A G
   step with use_shortcuts (the VAE's skip convs) and
   train_reference_networks (rank-16 LoRA on the capture nets), the
   training phase's batch, L2 + LPIPS and remat, over the Coach's mask (the
   capture nets' LoRA and conv_in, the skip convs): a warm-up and 2 timed
   steps, launches per step (70 flash_fwd_lse: the 18 attentions with a
   gradient and the capture's 17, each forward twice; 34 flash_bwd_dq and
   34 flash_bwd_dkv: the capture's last self-attention reaches no captured
   K/V; no flash_bound), the capture nets' gradients finite and nonzero by
   group, fused against unfused (loss 1e-3, gradients 0.1 by group), ms
   and peak memory. Then a FaceID model (condition_on_face_embeds): a
   batch-16 restore_forward(face_embeds=) (9 shared_flash_bound + 26
   flash_bound; finite, moved by other embeddings and by none, fused vs
   unfused on 2 samples) and a 512 px Predictor restore with embeddings
   from a stub provider (PIL images where Pillow imports, else
   predict_batch);
9a. recipe phase ("recipe"): the reference's full generator loss at full
   width. First each network and image op it adds, on the card against the
   same port code on the CPU, fp32 with TF32 off in cuBLAS and cuDNN
   (relative RMS within 1e-4): the DINOv2 ViT-L/14's three taps that
   discriminate reads (batch 2, 224 px), IR-SE50 embeddings (batch 2,
   112 px), P-net on a 512 px image and R- and O-net on crops of it,
   degrade_with_params (batch 2, 512 px, the same noise) and the DCT JPEG.
   Then the shipped recipe's train step (OptimConfig()'s weights: L2 5,
   LPIPS 5, ID 1.0 on aligned crops, GAN 0.5 with the DINOv2 discriminator,
   random seeded networks; otherwise the training phase's step): fused vs
   unfused from the seeded state on the loss (1e-3) and on gradients by
   leaf group (0.1), and the same without the ID term (printed: its share
   of the gap); a warm-up and 3 timed steps, launches per step as the
   training phase's (the loss networks run no attention kernel), loss_id
   and loss_g finite, ms per step, peak memory, and profiles of the step,
   of the L2 + LPIPS step, of the G term alone and of the ID term alone
   (device busy and their shares). Then one step with every term live (cycle through
   degrade_with_params per sample, landmark, pos/neg regularisers,
   facial-component L2, LPIPS and GAN terms: each finite) and the
   discriminator's side (discriminate for_real on the ground truth and not
   for_real on the detached prediction, update_sn: finite head gradients,
   every u vector of more than one element moved);
9b. small-model phase ("small"): the same seeded weights at sample_size 32
   (256 px) and 24 (192 px), whose attention shapes are off the tiles' 64
   rows (16 and 9 tokens in the UNet mid block; 144 and 36 in the shared
   layers at 24): onboarding 4 identities and a batch-4 warm restore, a cold
   restore, a cold restore under kv_outer + online, and one train step at
   batch 2; each checks its launch counts, finite outputs and agreement
   with the unfused path (the train step: loss and gradients, fused vs
   unfused, from one state);
9c. checkpoint phase ("checkpoint"): serving from checkpoint files at full
   width. A seeded SD-Turbo model (LoRA rank 32, the UNet's conv_in moved off
   the capture UNet's) and a 23-layer, 1024-wide text encoder are written in
   fp16 as a FULL .pt of the reference trainer's schema (net. prefixes, peft
   base_layer / lora_A.default names, a cfg with the shipped statics) and as
   a LoRA-only .pt over a diffusers-layout base folder of .safetensors, with
   a synthetic tokenizer, under _scratch/ (disk space checked first, the
   folder removed after). Prints the file sizes and the seconds to write, to
   torch.load, to convert, for the text encoder and to move to the card;
   holds the card's caption_enc to the text tower run in fp32 on the CPU
   (relative RMS 1e-3); Predictor(checkpoint_path=FULL) must give
   predict_batch (4 images x 4 refs) bit for bit as Predictor(params=the
   same fp16 tree), 9 shared_flash_bound + 26 flash launches each;
   cli.serve.load_engine(LoRA-only) + run (4 identities, 8 images, batch 8)
   bit for bit as a ServingEngine of the same tree at LoRA scaling 8/32, 68
   + 9 flash and 9 shared_identity launches; prints first and steady ms;
   then, where Pillow imports, cli.infer.main and cli.serve.main on PNGs of
   2 identities (the LoRA-only file, which carries no cfg, under the default
   statics, train_input: 9 shared_flash_bound launches), and cli.parity
   determinism (deterministic: true, and its dumped noise reproduces the
   output; 3 x 9 + 26 launches) and dump-activations (its stage count and
   seconds) on the FULL .pt at 512 px, and a line saying whether they ran;
9d. coach phase ("coach"): the trainer (training/coach.py) at full width:
   seeded SD-Turbo widths with LoRA, batch 2 x 4 references, 512 px, bf16
   over fp32 params, OptimConfig()'s weights (L2, LPIPS, ID on aligned crops,
   GAN 0.5 with the seeded DINOv2 ViT-L/14 and its heads), on an in-memory
   set of seeded items with RestoreDataset's keys and a 4-item validation
   set. Coach.train for 3 G + D steps (metric interval 1, validation at step
   3, a full save at step 2): launches per step (36 flash_fwd_lse, 18
   flash_bwd_dq, 18 flash_bwd_dkv, 17 flash_bound; the D step none), finite
   losses with loss_d, every u vector of more than one element and every
   head weight moved, no frozen leaf changed, best_model and timestep.txt
   written; a fresh Coach resumed from the step-2 file ends bit for bit
   where the run ended (params and heads, deterministic cuDNN); validation
   batches launch 9 shared_flash_bound + 26 flash_bound, and with
   vis_attention on (probabilities saved) 0 + 26; the Predictor serves the
   run's final file (9 + 26 launches); with gradient_accumulation_steps=2
   no LoRA leaf moves after micro-step 1 and they do after micro-step 2.
   Where Pillow and OpenCV import, cli.train.main trains 2 steps on PNGs
   through RestoreDataset (loader workers 2, the cycle term on; dotted
   overrides, and a --config_path where yaml imports); one line says
   whether this ran.
   Prints G and D ms per step, the device-busy ms of one step with the D
   step's share, host data ms per batch, ms per validation batch, peak
   memory, and the checkpoint's size and write / read seconds;
9f. dispatch phase ("dispatch"): the Coach's multi-step dispatch at the
   coach phase's width and data (deterministic cuDNN). Two Coaches from one
   seeded init train 8 steps, steps_per_dispatch 1 and 4 (the second's
   steps replays of a captured CUDA graph of the G + D step; metrics at 4
   and 8, its full save at 4): every trainable leaf, head and u vector,
   both optimizers' moments and counts and the last step's losses
   bit-equal, and the launches per step the same (36 / 18 / 18 / 17 of rows
   4 / 5 / 6 / 2, a replay's counted per replay); a Coach resumed from the
   dispatch run's step-4 file ends bit for bit where that run ended; 2-step
   accumulation under dispatches of 4 (a static step per phase) equals the
   one-step accumulation on the same 4 batches. Prints, for both Coaches:
   wall ms per step over a few more (a dispatch of 4; 2 one a call), the
   device-busy ms of one step and
   the launch API calls a step (cudaLaunchKernel against cudaGraphLaunch in
   the profiler), and for the dispatch its capture seconds, its graph
   pool's bytes and peak memory;
9e. parallel phase ("parallel"): training and serving across processes and
   cards. With two cards or more, every kernel at one 512 px shape on cuda:1,
   launched from a thread at current device 0, equals its cuda:0 launch bit
   for bit (with one card a line says the check needs a second). DDP at
   the coach phase's full width (TrainConfig(), OptimConfig()'s weights,
   global batch 2, seeded in-memory data) in worker processes of this
   script (--ddp-worker), each group under a wall-clock limit and killed
   past it: one process without a process group and then in an NCCL group
   of world size 1 (bit for bit the same after 2 G + D steps); two ranks on
   the one card over gloo with CUDA tensors (NCCL refuses one card twice);
   with two cards or more two NCCL ranks on cuda:0 and cuda:1. Each pair
   against the one process: global loss within 1e-3; the first step's
   gradient within 1e-5 relative RMS by leaf group of the split witness
   (one process without a group summing the two halves' shares of the
   global batch: the ranks' arithmetic without the collectives), and from
   the one process at batch 2 at most 1.5x the witness's own distance (the
   batch-1 algorithms' rounding); the two ranks bit-identical, 36 / 18 / 18 / 17 launches a G step on each rank;
   the two NCCL ranks also run their 2 steps as one dispatch
   (steps_per_dispatch 2, a captured graph with its all-reduces): both
   ranks bit-equal to each other and to their eager DDP steps; prints
   per rank the G and D ms, the device busy of one G + D step, the G
   gradient all-reduce's ms and bytes, and peak memory. Then
   ServingEngine(devices=) on every card (two shares of cuda:0 with one
   card; a worker process for each device after the first) against the
   one-device engine: onboarding seconds of 16 identities on both and every
   device's cache bit-equal to the one-device cache, warm and cold batch-16
   restores and, with two cards or more, batches of 16 rows a card, within
   mean-abs 2e-2, launches summed over the processes as the warm and cold
   phases count them, faces/sec beside one device's at batch 16, a batch of
   3 refused, and no worker process left after close(); then an int8
   engine on the same devices against the one-device int8 engine: caches
   bit-equal, calibrate_int8 on the same batch giving the same scales, and
   each device's rows of a calibrated warm restore against the one-device
   engine's restore of those rows (mean-abs 2e-2);
10. prints each kernel's factor over its library call per pass of its path,
   largest first, with its d=64 and d=512 parts where it runs at both
   (flash_bwd_dq and flash_bwd_dkv ranked as one pair against SDPA's joint
   backward), then
   {"kernels": [...]} (launches summed over the paths of 4-9e) and, last,
   {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result.
It needs a CUDA device and the repository beside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3 rate
BATCH, N_IDENT, N_REFS, RES = 16, 16, 4, 512
RESTORE_RUNS = 3
# (heads, tokens, launches per restore) of the main path at 512 px, head dim 64:
# the warm restore's shared_identity and the cold restore's shared_flash_bound
# or shared_online
SHARED_SHAPES = [(20, 256, 3), (10, 1024, 3), (5, 4096, 3)]
# (heads, queries, segment keys) that take the other tiles of the online shared
# kernels: one consumer warpgroup a block (Sq % 128 == 64), the 64-key chunk
ONLINE_VARIANT_SHAPES = [(10, 192, 256), (10, 256, 64)]
EXP2_PER_CLOCK_PER_SM, N_SMS = 16, 132  # H100 SXM: 4 MUFU lanes on each of an SM's 4 partitions
ODD_SHAPE = (10, 1024)  # the odd-N and per-call paired rows run at this layer
FLASH_SHAPES = [(5, 4096, 64, 2), (10, 1024, 64, 2), (20, 256, 64, 2), (20, 64, 64, 1),
                (1, 4096, 512, 2)]
TRAIN_BATCH, TRAIN_STEPS = 2, 4
# (heads, queries, keys, head dim, launches per train step) of the differentiable
# attention at batch 2, refs-only with 4 references: the 9 shared up-block
# layers on the widened K/V, the restoration UNet's down/mid self-attention,
# the VAE mid attention of the encoder and the decoder
VJP_SHAPES = [(20, 256, 1024, 64, 3), (10, 1024, 4096, 64, 3), (5, 4096, 16384, 64, 3),
              (5, 4096, 4096, 64, 2), (10, 1024, 1024, 64, 2), (20, 256, 256, 64, 2),
              (20, 64, 64, 64, 1), (1, 4096, 4096, 512, 2)]
# (heads, tokens, head dim, forwards, backwards per forward pass) of the
# capture under a gradient (train_reference_networks) at batch B * N = 8:
# the capture UNet's 16 self-attentions and the original VAE encoder's; the
# last up-block layer's output reaches no captured K/V, so it has no backward
VJP_CAPTURE_BATCH = TRAIN_BATCH * 4
VJP_CAPTURE_SHAPES = [(5, 4096, 64, 5, 4), (10, 1024, 64, 5, 5), (20, 256, 64, 5, 5),
                      (20, 64, 64, 1, 1), (1, 4096, 512, 1, 1)]
VJP_AUTOGRAD_SHAPE = (10, 1024, 4096, 64)  # held against fp32 autograd too
VJP_AUTOGRAD_D512 = (1, 4096, 4096, 512)  # and the d=512 backward tile at its train-step shape
VJP_AUTOGRAD_REL_RMS = 3e-2  # bf16 P, dS and outputs against an fp32 reference
# (batch, heads, Sq, Skv) at d=64 that take the other tiles of flash_online and
# flash_fwd_lse on the wgmma tile: one consumer warpgroup a block (Sq % 128 ==
# 64) on 128-key chunks; the 64-key chunk (128 does not divide Skv). The
# backward tile takes 64 query rows a block of flash_bwd_dq in the first and 64
# keys a block of flash_bwd_dkv in the second (flash_bwd_tiles).
FLASH_VARIANT_SHAPES = [(2, 4, 192, 256), (2, 4, 256, 320)]
# (batch, heads, Sq, Skv) at d=512 with Sq != Skv: flash_online and
# flash_fwd_lse on the d=512 wgmma tile (three 64-row blocks, three 32-key tiles)
FLASH_VARIANT_D512 = (2, 2, 192, 96)
# (batch, heads, tokens, head dim) of flash_bound (flash_online under
# INSTANTRESTORE_FLASH_ALGO=online) in the cold restore's capture pass: the VAE
# mid attention of the 64 references' encode
FLASH_CAPTURE_D512 = (64, 1, 4096, 512)
LSE_TOL = 1e-3  # flash_fwd_lse's LSE against its plain version, max-abs in log2 units
# (batch, heads, Sq, S or Skv) at d=64 off the tiles' 64 rows, the shapes the
# JAX kernels take at any length up to their block: every d=64 kernel against
# its plain version, two launches bit for bit. A 128-key tile cut at 144 and
# at 100 keys (Sq != S), one masked 64-key tile of 36, 16, 9, 4 and 1 keys.
RAGGED_SHAPES = [(2, 4, 144, 144), (2, 4, 200, 100), (2, 2, 36, 36), (2, 2, 16, 16),
                 (2, 2, 9, 9), (2, 4, 4, 4), (2, 2, 1, 1)]
# (H, W, C, act, bias terms, calls a pass) of the GroupNorms of a 512 px
# restore: the VAE encoder's 22 and the UNet's 61 (a warm restore at batch
# 16, and the capture at batch B * N = 32 again), the VAE decoder's 30; "c":
# conv1's bias [C], "c+bc": it and the UNet's time-embedding term [B, C]
GN_ENCODER = [(512, 512, 128, "silu", "", 2), (512, 512, 128, "silu", "c", 2),
              (256, 256, 128, "silu", "", 1), (256, 256, 256, "silu", "", 1),
              (256, 256, 256, "silu", "c", 2), (128, 128, 256, "silu", "", 1),
              (128, 128, 512, "silu", "", 1), (128, 128, 512, "silu", "c", 2),
              (64, 64, 512, "silu", "", 5), (64, 64, 512, "silu", "c", 4), (64, 64, 512, None, "", 1)]
GN_UNET = [(64, 64, 320, "silu", "", 3), (64, 64, 320, "silu", "c+bc", 5), (64, 64, 320, None, "", 5),
           (32, 32, 320, "silu", "", 1), (32, 32, 640, "silu", "", 1),
           (32, 32, 640, "silu", "c+bc", 5), (32, 32, 640, None, "", 5), (16, 16, 640, "silu", "", 1),
           (16, 16, 1280, "silu", "", 1), (16, 16, 1280, "silu", "c+bc", 5),
           (16, 16, 1280, None, "", 5), (8, 8, 1280, "silu", "", 4), (8, 8, 1280, "silu", "c+bc", 7),
           (8, 8, 1280, None, "", 1), (8, 8, 2560, "silu", "", 3), (16, 16, 2560, "silu", "", 2),
           (16, 16, 1920, "silu", "", 1), (32, 32, 1920, "silu", "", 1), (32, 32, 1280, "silu", "", 1),
           (32, 32, 960, "silu", "", 1), (64, 64, 960, "silu", "", 1), (64, 64, 640, "silu", "", 2)]
GN_DECODER = [(64, 64, 512, "silu", "", 5), (64, 64, 512, "silu", "c", 5), (64, 64, 512, None, "", 1),
              (128, 128, 512, "silu", "", 3), (128, 128, 512, "silu", "c", 3),
              (256, 256, 512, "silu", "", 1), (256, 256, 256, "silu", "", 2),
              (256, 256, 256, "silu", "c", 3), (512, 512, 256, "silu", "", 1),
              (512, 512, 128, "silu", "", 3), (512, 512, 128, "silu", "c", 3)]
# GroupNorm kernel launches: a pass of each net, of the capture (the frozen
# encoder and UNet, also in a train step, whose every other GroupNorm wants
# a gradient: the plain path) and of a restore
GN_ENC, GN_UNET_PASS, GN_DEC = (sum(n for *_, n in t) for t in (GN_ENCODER, GN_UNET, GN_DECODER))
GN_CAPTURE = GN_ENC + GN_UNET_PASS  # 83: a capture, and onboarding one identity
GN_WARM = GN_CAPTURE + GN_DEC  # 113 a warm restore
GN_COLD = GN_WARM + GN_CAPTURE  # 196: the capture's too
CAPTURE_BATCH = 32
# the small models of the serving and training paths: the same seeded
# weights at sample_size 32 (256 px; the UNet mid block has 4 x 4 tokens)
# and 24 (192 px; 576, 144, 36 and 9 tokens, the shared layers' too)
SMALL_SAMPLE_SIZES = (32, 24)
SMALL_BATCH, SMALL_IDENT = 4, 4
# the checkpoint phase: a FULL .pt (about 4.5 GB in fp16) and a LoRA-only
# .pt over a base folder (about 2.6 GB), both written and read on this disk
CKPT_DISK_BYTES = 10e9
CKPT_BATCH, CKPT_SERVE_IDENT, CKPT_SERVE_IMAGES = 4, 4, 8
CKPT_CAPTION_REL_RMS = 1e-3  # caption_enc on the card against the text tower in fp32 on the CPU
# a synthetic CLIP vocab: every byte alone and as a word's end, a few merges
# over the fixed prompt's words
TOKENIZER_MERGES = [("h", "e</w>"), ("p", "h"), ("ph", "o"), ("pho", "t"), ("phot", "o</w>"),
                    ("o", "f</w>"), ("8", "k</w>")]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return float(out[0]) * 1e6


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tolerance(ref) -> float:
    """Max-abs tolerance between bf16 outputs of two implementations that
    differ only in fp32 summation order and exp2 rounding, each of which can
    flip one bf16 rounding of an output: 1e-3 plus 1e-2 of the output's
    largest magnitude (a few bf16 ulps at that magnitude)."""
    return 1e-3 + 1e-2 * float(ref.abs().max())


REL_RMS_TOL = 1e-2  # ||out - ref|| / ||ref||: bf16 rounding alone gives ~2e-3


def compare(name: str, out, ref):
    """Max-abs error, its tolerance and the relative RMS error of a kernel's
    output against its plain version; raises when either is exceeded. A
    reference that is zero up to rounding (|ref| <= 1e-5 everywhere: dQ over a
    single key) has no relative error: its relative RMS is 0 and max-abs
    judges."""
    import torch

    o, r = out.float(), ref.float()
    err, tol = float((o - r).abs().max()), tolerance(r)
    rel_rms = float((o - r).norm() / r.norm()) if float(r.abs().max()) > 1e-5 else 0.0
    if not torch.isfinite(out).all() or err > tol or rel_rms > REL_RMS_TOL:
        raise AssertionError(f"{name}: max-abs {err} (tol {tol}), relative RMS {rel_rms} "
                             f"(tol {REL_RMS_TOL})")
    return err, tol, rel_rms


def kernel_phase(card: str):
    """Each kernel vs its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from instantrestore_tpu_torch.ops import shared_attention as sa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    exp2_rate = EXP2_PER_CLOCK_PER_SM * N_SMS * max_sm_clock_hz()

    def row(label, call, plain, lib, flops, nbytes, **meta):
        """One launch against its plain version, then the three times. At
        head dim ``d`` there are flops / (4 d) scores, one exp2 each: the
        shared rows (d = 64) carry their time at the card's exp2 rate."""
        out = call()
        torch.cuda.synchronize()
        err, tol, rel_rms = compare(label, out, plain())
        del out
        b_ms, b_by = bound(flops, nbytes)
        if "head_dim" not in meta:
            meta["exp2_ms"] = flops / (4 * d) / exp2_rate * 1e3
        return dict(**meta, max_abs_err=err, tol=tol, rel_rms=rel_rms, ms=cuda_ms(call, 10),
                    plain_ms=cuda_ms(plain, 2), library_ms=cuda_ms(lib, 10), bound_ms=b_ms,
                    bound_by=b_by)

    def widened(rk, rv, aff, k_in=None, v_in=None, include_input=False):
        """K/V as the kernel sees them (bf16 affine), for the library call."""
        b, n, h, s, d = rk.shape
        a = aff.to(rv.dtype).float()
        keys = rk.permute(0, 2, 1, 3, 4).reshape(b, h, n * s, d)
        vals = (rv.permute(0, 2, 1, 3, 4).float() * a[:, :, :, 0, None, :]
                + a[:, :, :, 1, None, :]).to(rv.dtype).reshape(b, h, n * s, d)
        if include_input:
            keys, vals = torch.cat([k_in, keys], dim=2), torch.cat([v_in, vals], dim=2)
        return keys.contiguous(), vals.contiguous()

    d, scale = 64, 64 ** -0.5  # every shared kernel runs at head dim 64
    ident_rows, flash_rows, bound_rows = [], [], []
    fonline_rows, online_rows, pair_rows = [], [], []

    # kernel 1: identity-cached shared attention (ids shuffled, with repeats)
    ids = torch.tensor([3, 7, 7, 0, 15, 2, 3, 9, 12, 7, 1, 0, 5, 15, 8, 3], device=dev)
    uniq = int(torch.unique(ids).numel())
    for h, s, per_pass in SHARED_SHAPES:
        q, v_in = rnd(BATCH, h, s, d), rnd(BATCH, h, s, d)
        rk, rv = rnd(N_IDENT, N_REFS, h, s, d), rnd(N_IDENT, N_REFS, h, s, d)
        (cache,) = sa.build_identity_kv_cache([(rk, rv)])
        vs, vh = sa.adain_affine_from_stats(v_in, cache.content_mean[ids], cache.content_std[ids])
        aff = torch.stack([vs, vh], dim=3).contiguous()
        keys, vals = widened(rk[ids], rv[ids], aff)
        n_keys = N_REFS * s
        ident_rows.append(row(
            f"shared_identity H={h} S={s}",
            lambda: sa.shared_attention_identity(q, None, v_in, cache, ids, scale=scale,
                                                 use_adain=True),
            lambda: sa.shared_identity_plain(q, rk, rv, aff, cache.kmax, ids, scale=scale),
            lambda: F.scaled_dot_product_attention(q, keys, vals, scale=scale),
            4.0 * BATCH * h * s * n_keys * d,
            (2 * BATCH * h * s * d * 2 + 2 * uniq * N_REFS * h * s * d * 2
             + BATCH * h * N_REFS * 2 * d * 4 + uniq * h * 4 + BATCH * 8),
            heads=h, tokens=s, keys=n_keys, per_pass=per_pass))
        del q, v_in, rk, rv, cache, keys, vals, aff
        torch.cuda.empty_cache()

    # kernels 2 and 8: plain flash attention, bound softmax and online softmax,
    # on the same inputs (the online kernel reads no kmax: 4 bytes per (b, h) fewer)
    for h, s, fd, per_pass in FLASH_SHAPES:
        q, k, v = rnd(BATCH, h, s, fd), rnd(BATCH, h, s, fd), rnd(BATCH, h, s, fd)
        fscale = fd ** -0.5
        lib = lambda: F.scaled_dot_product_attention(q, k, v, scale=fscale)
        flops, nbytes = 4.0 * BATCH * h * s * s * fd, 4 * BATCH * h * s * fd * 2
        meta = dict(heads=h, tokens=s, head_dim=fd, per_pass=per_pass)
        bound_call = lambda: sa.flash_attention(q, k, v, scale=fscale, algo="bound")
        flash_rows.append(row(f"flash_bound H={h} S={s} d={fd}", bound_call,
                              lambda: sa.flash_attention_plain(q, k, v, scale=fscale),
                              lib, flops, nbytes + BATCH * h * 4,
                              **dict(meta, chunk=sa.flash_bound_chunk(s, s, fd))))
        if not torch.equal(bound_call(), bound_call()):
            raise AssertionError(f"flash_bound H={h} S={s} d={fd}: two launches differ")
        online = lambda: sa.flash_attention(q, k, v, scale=fscale, algo="online")
        fonline_rows.append(row(f"flash_online H={h} S={s} d={fd}", online,
                                lambda: sa.flash_online_plain(q, k, v, scale=fscale),
                                lib, flops, nbytes,
                                **dict(meta, chunk=sa.flash_online_chunk(s, fd))))
        if not torch.equal(online(), online()):
            raise AssertionError(f"flash_online H={h} S={s} d={fd}: two launches differ")
        del q, k, v
        torch.cuda.empty_cache()

    # rows 2 and 8 at the cold capture's batch of 64 at d=512
    b, h, s, fd = FLASH_CAPTURE_D512
    q, k, v = rnd(b, h, s, fd), rnd(b, h, s, fd), rnd(b, h, s, fd)
    lib = lambda: F.scaled_dot_product_attention(q, k, v, scale=fd ** -0.5)
    flops, nbytes = 4.0 * b * h * s * s * fd, 4 * b * h * s * fd * 2
    meta = dict(batch=b, heads=h, tokens=s, head_dim=fd, per_pass=0,
                route="the cold capture's VAE encode")
    bound_call = lambda: sa.flash_attention(q, k, v, scale=fd ** -0.5, algo="bound")
    flash_rows.append(row(
        f"flash_bound B={b} H={h} S={s} d={fd}", bound_call,
        lambda: sa.flash_attention_plain(q, k, v, scale=fd ** -0.5), lib, flops,
        nbytes + b * h * 4, **dict(meta, chunk=sa.flash_bound_chunk(s, s, fd))))
    if not torch.equal(bound_call(), bound_call()):
        raise AssertionError(f"flash_bound B={b} d={fd}: two launches differ")
    online = lambda: sa.flash_attention(q, k, v, scale=fd ** -0.5, algo="online")
    fonline_rows.append(row(
        f"flash_online B={b} H={h} S={s} d={fd}", online,
        lambda: sa.flash_online_plain(q, k, v, scale=fd ** -0.5), lib, flops, nbytes,
        **dict(meta, chunk=sa.flash_online_chunk(s, fd))))
    if not torch.equal(online(), online()):
        raise AssertionError(f"flash_online B={b} d={fd}: two launches differ")
    del q, k, v
    torch.cuda.empty_cache()

    # rows 2 and 8 on the wgmma tile's other tiles, against the plain versions
    # (row 8's on the kernel's chunk)
    for b, h, sq, skv in FLASH_VARIANT_SHAPES:
        q, k, v = rnd(b, h, sq, d), rnd(b, h, skv, d), rnd(b, h, skv, d)
        lib = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
        flops = 4.0 * b * h * sq * skv * d
        nbytes = (2 * b * h * sq * d + 2 * b * h * skv * d) * 2
        chunk = sa.flash_bound_chunk(sq, skv, d)
        bound_call = lambda: sa.flash_attention(q, k, v, scale=scale, algo="bound")
        flash_rows.append(row(
            f"flash_bound B={b} H={h} Sq={sq} Skv={skv}", bound_call,
            lambda: sa.flash_attention_plain(q, k, v, scale=scale), lib, flops,
            nbytes + b * h * 4, batch=b, heads=h, queries=sq, keys=skv, head_dim=d,
            per_pass=0, chunk=chunk,
            route=f"{128 if sq % 128 == 0 else 64} query rows a block, key chunk {chunk}"))
        if not torch.equal(bound_call(), bound_call()):
            raise AssertionError(f"flash_bound Sq={sq} Skv={skv}: two launches differ")
        chunk = sa.flash_online_chunk(skv, d)
        online = lambda: sa.flash_attention(q, k, v, scale=scale, algo="online")
        fonline_rows.append(row(
            f"flash_online B={b} H={h} Sq={sq} Skv={skv}", online,
            lambda: sa.flash_online_plain(q, k, v, scale=scale, block_k=chunk), lib, flops,
            nbytes, batch=b, heads=h, queries=sq, keys=skv, head_dim=d, per_pass=0, chunk=chunk,
            route=f"{128 if sq % 128 == 0 else 64} query rows a block, key chunk {chunk}"))
        if not torch.equal(online(), online()):
            raise AssertionError(f"flash_online Sq={sq} Skv={skv}: two launches differ")
        del q, k, v

    # row 8 at d=512 with Sq != Skv, against its plain version on the kernel's chunk
    b, h, sq, skv = FLASH_VARIANT_D512
    fd = 512
    q, k, v = rnd(b, h, sq, fd), rnd(b, h, skv, fd), rnd(b, h, skv, fd)
    chunk = sa.flash_online_chunk(skv, fd)
    online = lambda: sa.flash_attention(q, k, v, scale=fd ** -0.5, algo="online")
    fonline_rows.append(row(
        f"flash_online B={b} H={h} Sq={sq} Skv={skv} d={fd}", online,
        lambda: sa.flash_online_plain(q, k, v, scale=fd ** -0.5, block_k=chunk),
        lambda: F.scaled_dot_product_attention(q, k, v, scale=fd ** -0.5),
        4.0 * b * h * sq * skv * fd, (2 * b * h * sq * fd + 2 * b * h * skv * fd) * 2,
        batch=b, heads=h, queries=sq, keys=skv, head_dim=fd, per_pass=0, chunk=chunk,
        route=f"64 query rows a block, key chunk {chunk}"))
    if not torch.equal(online(), online()):
        raise AssertionError(f"flash_online Sq={sq} Skv={skv} d={fd}: two launches differ")
    del q, k, v

    # kernels 3, 7 and 10: shared attention over [input |] per-call references,
    # bound and online, on the same inputs; a cold restore launches the
    # refs-only rows, a train_input model the others
    for h, s, per_pass in SHARED_SHAPES:
        q, k_in, v_in = rnd(BATCH, h, s, d), rnd(BATCH, h, s, d), rnd(BATCH, h, s, d)
        rk, rv = rnd(BATCH, N_REFS, h, s, d), rnd(BATCH, N_REFS, h, s, d)
        rk[1, N_REFS - 1] = 0  # a masked reference: zeroed, still attended
        rv[1, N_REFS - 1] = 0
        vs, vh = sa.adain_affine(v_in, rv)
        aff = torch.stack([vs, vh], dim=3).contiguous()

        def shared(algo, inc):
            return sa.shared_flash_attention(q, k_in, v_in, rk, rv, scale=scale,
                                             v_affine=(vs, vh), include_input=inc, algo=algo)

        for inc in (False, True):
            kmax = sa.key_norm_max(rk, (1, 3))
            if inc:
                kmax = torch.maximum(kmax, sa.key_norm_max(k_in, 2))
            keys, vals = widened(rk, rv, aff, k_in, v_in, inc)
            lib = lambda: F.scaled_dot_product_attention(q, keys, vals, scale=scale)
            n_keys = (N_REFS + inc) * s
            flops = 4.0 * BATCH * h * s * n_keys * d
            nbytes = (2 * BATCH * h * s * d * 2 + inc * 2 * BATCH * h * s * d * 2
                      + 2 * BATCH * N_REFS * h * s * d * 2 + BATCH * h * N_REFS * 2 * d * 4)
            meta = dict(heads=h, tokens=s, keys=n_keys, input=inc,
                        per_pass=0 if inc else per_pass)
            bound_rows.append(row(
                f"shared_flash_bound H={h} S={s} input={inc}",
                lambda: shared("kv_outer_bound", inc),
                lambda: sa.shared_flash_bound_plain(q, k_in, v_in, rk, rv, aff, kmax, scale=scale,
                                                    include_input=inc),
                lib, flops, nbytes + BATCH * h * 4, **meta))
            online_plain = lambda: sa.shared_online_plain(q, k_in, v_in, rk, rv, aff, scale=scale,
                                                          include_input=inc)
            online_rows.append(row(f"shared_online H={h} S={s} input={inc}",
                                   lambda: shared("kv_outer", inc), online_plain, lib, flops,
                                   nbytes, **meta))
            one = shared("kv_outer", inc)
            if not torch.equal(one, shared("kv_outer", inc)):
                raise AssertionError(f"shared_online H={h} S={s} input={inc}: two launches differ")
            if h % 2 == 0:  # odd H falls through to shared_online, as in the JAX package
                if not torch.equal(one, shared("kv_outer_packed", inc)):
                    raise AssertionError(f"shared_online_pair H={h} S={s} input={inc}: not "
                                         "shared_online's bits")
                pair_rows.append(row(
                    f"shared_online_pair H={h} S={s} input={inc}",
                    lambda: shared("kv_outer_packed", inc),
                    lambda: sa.shared_online_pair_plain(q, k_in, v_in, rk, rv, aff, scale=scale,
                                                        include_input=inc),
                    lib, flops, nbytes, **meta))
            if (h, s) == ODD_SHAPE and not inc:
                # row 9: the Q-outer algorithm's name runs the same kernel
                online_rows.append(row(f"q_outer route H={h} S={s}",
                                       lambda: shared("q_outer", inc), online_plain, lib, flops,
                                       nbytes, **dict(meta, route="q_outer", per_pass=0)))
                # row 1b: the per-call paired route runs the identity kernel
                rows_b = torch.arange(BATCH, device=dev)
                ident_rows.append(row(
                    f"paired route H={h} S={s}",
                    lambda: shared("kv_outer_bound_paired", inc),
                    lambda: sa.shared_identity_plain(q, rk, rv, aff, kmax, rows_b, scale=scale),
                    lib, flops, nbytes + BATCH * h * 4 + BATCH * 8,
                    heads=h, tokens=s, keys=n_keys,
                    route="per-call paired (kv_outer_bound_paired)", per_pass=0))
            del keys, vals, one
        del q, k_in, v_in, rk, rv, aff
        torch.cuda.empty_cache()

    # rows 7, 10, 3 and 1b on the wgmma tile's other tiles, refs-only and with
    # the input segment
    for h, sq, s in ONLINE_VARIANT_SHAPES:
        q, k_in, v_in = rnd(BATCH, h, sq, d), rnd(BATCH, h, s, d), rnd(BATCH, h, s, d)
        rk, rv = rnd(BATCH, N_REFS, h, s, d), rnd(BATCH, N_REFS, h, s, d)
        vs, vh = sa.adain_affine(v_in, rv)
        aff = torch.stack([vs, vh], dim=3).contiguous()
        for inc in (False, True):
            def variant(algo):
                return sa.shared_flash_attention(q, k_in, v_in, rk, rv, scale=scale,
                                                 v_affine=(vs, vh), include_input=inc, algo=algo)

            keys, vals = widened(rk, rv, aff, k_in, v_in, inc)
            n_keys = (N_REFS + inc) * s
            args = (lambda: sa.shared_online_plain(q, k_in, v_in, rk, rv, aff, scale=scale,
                                                   include_input=inc),
                    lambda: F.scaled_dot_product_attention(q, keys, vals, scale=scale),
                    4.0 * BATCH * h * sq * n_keys * d,
                    (2 * BATCH * h * sq * d * 2 + inc * 2 * BATCH * h * s * d * 2
                     + 2 * BATCH * N_REFS * h * s * d * 2 + BATCH * h * N_REFS * 2 * d * 4))
            rows_per_block, chunk = sa.shared_online_tile(sq, s, h)
            meta = dict(heads=h, queries=sq, tokens=s, keys=n_keys, input=inc, per_pass=0,
                        route=f"{rows_per_block} query rows a block, key chunk {chunk}")
            online_rows.append(row(f"shared_online H={h} Sq={sq} S={s} input={inc}",
                                   lambda: variant("kv_outer"), *args, **meta))
            pair_rows.append(row(f"shared_online_pair H={h} Sq={sq} S={s} input={inc}",
                                 lambda: variant("kv_outer_packed"), *args,
                                 **dict(meta, route=f"64 query rows a head, key chunk {chunk}")))
            if not torch.equal(variant("kv_outer"), variant("kv_outer_packed")):
                raise AssertionError(f"shared_online_pair H={h} Sq={sq} S={s} input={inc}: not "
                                     "shared_online's bits")
            kmax = sa.key_norm_max(rk, (1, 3))
            if inc:
                kmax = torch.maximum(kmax, sa.key_norm_max(k_in, 2))
            bound_rows.append(row(
                f"shared_flash_bound H={h} Sq={sq} S={s} input={inc}",
                lambda: variant("kv_outer_bound"),
                lambda: sa.shared_flash_bound_plain(q, k_in, v_in, rk, rv, aff, kmax, scale=scale,
                                                    include_input=inc),
                *args[1:], **meta))
            if not inc:
                rows_b = torch.arange(BATCH, device=dev)
                ident_rows.append(row(
                    f"paired route H={h} Sq={sq} S={s}", lambda: variant("kv_outer_bound_paired"),
                    lambda: sa.shared_identity_plain(q, rk, rv, aff, kmax, rows_b, scale=scale),
                    *args[1:], **meta))
            del keys, vals
        del q, k_in, v_in, rk, rv, aff
        torch.cuda.empty_cache()

    # odd N: the identity cache read by id through the bound kernel
    h, s = ODD_SHAPE
    n_odd = N_REFS - 1
    q, v_in = rnd(BATCH, h, s, d), rnd(BATCH, h, s, d)
    (cache,) = sa.build_identity_kv_cache([(rnd(N_IDENT, n_odd, h, s, d),
                                            rnd(N_IDENT, n_odd, h, s, d))])
    vs, vh = sa.adain_affine_from_stats(v_in, cache.content_mean[ids], cache.content_std[ids])
    aff = torch.stack([vs, vh], dim=3).contiguous()
    kmax = cache.kmax[ids]
    keys, vals = widened(cache.rk[ids], cache.rv[ids], aff)
    bound_rows.append(row(
        f"shared_flash_bound odd N={n_odd} H={h} S={s}",
        lambda: sa.shared_attention_identity(q, None, v_in, cache, ids, scale=scale,
                                             use_adain=True),
        lambda: sa.shared_flash_bound_plain(q, None, None, cache.rk, cache.rv, aff, kmax, ids,
                                            scale=scale, include_input=False),
        lambda: F.scaled_dot_product_attention(q, keys, vals, scale=scale),
        4.0 * BATCH * h * s * n_odd * s * d,
        (2 * BATCH * h * s * d * 2 + 2 * uniq * n_odd * h * s * d * 2
         + BATCH * h * n_odd * 2 * d * 4 + BATCH * h * 4 + BATCH * 8),
        heads=h, tokens=s, keys=n_odd * s, route=f"identity cache, N={n_odd}", per_pass=0))
    del q, v_in, cache, keys, vals
    torch.cuda.empty_cache()

    # every serving kernel at ragged shapes: Sq or S off the tiles' 64 rows
    for b, h, sq, s in RAGGED_SHAPES:
        tag = f"ragged B={b} H={h} Sq={sq} S={s}"
        meta = dict(batch=b, heads=h, queries=sq, tokens=s, per_pass=0)
        q, k_in, v_in = rnd(b, h, sq, d), rnd(b, h, s, d), rnd(b, h, s, d)
        # rows 2 and 8: Sq queries against S keys
        lib = lambda: F.scaled_dot_product_attention(q, k_in, v_in, scale=scale)
        flops, nbytes = 4.0 * b * h * sq * s * d, (2 * b * h * sq * d + 2 * b * h * s * d) * 2
        for name, algo, plain, rows in (
                ("flash_bound", "bound", lambda: sa.flash_attention_plain(q, k_in, v_in,
                                                                          scale=scale),
                 flash_rows),
                ("flash_online", "online", lambda: sa.flash_online_plain(q, k_in, v_in,
                                                                         scale=scale),
                 fonline_rows)):
            call = lambda: sa.flash_attention(q, k_in, v_in, scale=scale, algo=algo)
            rows.append(row(f"{name} {tag}", call, plain, lib, flops, nbytes,
                            **dict(meta, keys=s, head_dim=d,
                                   chunk=sa.flash_online_chunk(s, d), route="ragged")))
            if not torch.equal(call(), call()):
                raise AssertionError(f"{name} {tag}: two launches differ")
        # rows 1 (the identity cache by id), 1b, 3, 7, 9 and 10 over N references
        # of S keys, refs-only and with the input segment. AdaIN's unbiased std
        # over one token is undefined (NaN, in JAX too): a one-token segment
        # takes a random affine instead
        rk, rv = rnd(b, N_REFS, h, s, d), rnd(b, N_REFS, h, s, d)
        if s > 1:
            vs, vh = sa.adain_affine(v_in, rv)
        else:
            vs = 1 + 0.1 * torch.randn((b, h, N_REFS, d), generator=g, device=dev)
            vh = 0.1 * torch.randn((b, h, N_REFS, d), generator=g, device=dev)
        aff = torch.stack([vs, vh], dim=3).contiguous()
        for inc in (False, True):
            def shared(algo):
                return sa.shared_flash_attention(q, k_in, v_in, rk, rv, scale=scale,
                                                 v_affine=(vs, vh), include_input=inc, algo=algo)

            keys, vals = widened(rk, rv, aff, k_in, v_in, inc)
            n_keys = (N_REFS + inc) * s
            lib = lambda: F.scaled_dot_product_attention(q, keys, vals, scale=scale)
            flops = 4.0 * b * h * sq * n_keys * d
            nbytes = (2 * b * h * sq * d * 2 + inc * 2 * b * h * s * d * 2
                      + 2 * b * N_REFS * h * s * d * 2 + b * h * N_REFS * 2 * d * 4)
            smeta = dict(meta, keys=n_keys, input=inc, route="ragged")
            kmax = sa.key_norm_max(rk, (1, 3))
            if inc:
                kmax = torch.maximum(kmax, sa.key_norm_max(k_in, 2))
            bound_rows.append(row(
                f"shared_flash_bound {tag} input={inc}", lambda: shared("kv_outer_bound"),
                lambda: sa.shared_flash_bound_plain(q, k_in, v_in, rk, rv, aff, kmax,
                                                    scale=scale, include_input=inc),
                lib, flops, nbytes + b * h * 4, **smeta))
            online_plain = lambda: sa.shared_online_plain(q, k_in, v_in, rk, rv, aff,
                                                          scale=scale, include_input=inc)
            online_rows.append(row(f"shared_online {tag} input={inc}",
                                   lambda: shared("kv_outer"), online_plain, lib, flops, nbytes,
                                   **smeta))
            one = shared("kv_outer")
            if not (torch.equal(one, shared("kv_outer")) and torch.equal(one, shared("q_outer"))):
                raise AssertionError(f"shared_online {tag} input={inc}: two launches differ")
            pair_rows.append(row(f"shared_online_pair {tag} input={inc}",
                                 lambda: shared("kv_outer_packed"),
                                 lambda: sa.shared_online_pair_plain(
                                     q, k_in, v_in, rk, rv, aff, scale=scale, include_input=inc),
                                 lib, flops, nbytes, **smeta))
            if not torch.equal(one, shared("kv_outer_packed")):
                raise AssertionError(f"shared_online_pair {tag} input={inc}: not shared_online's "
                                     "bits")
            for algo in ("kv_outer_bound", "kv_outer_bound_paired"):
                if not torch.equal(shared(algo), shared(algo)):
                    raise AssertionError(f"{algo} {tag} input={inc}: two launches differ")
            if not inc:
                rows_b = torch.arange(b, device=dev)
                ident_rows.append(row(
                    f"paired route {tag}", lambda: shared("kv_outer_bound_paired"),
                    lambda: sa.shared_identity_plain(q, rk, rv, aff, kmax, rows_b, scale=scale),
                    lib, flops, nbytes + b * h * 4 + b * 8, **smeta))
            del keys, vals, one
        # row 1: the identity cache of 3 identities read by id
        r_ids = torch.tensor([2, 0][:b], device=dev)
        crk, crv = rnd(3, N_REFS, h, s, d), rnd(3, N_REFS, h, s, d)
        (cache,) = sa.build_identity_kv_cache([(crk, crv)])
        adain = s > 1
        cs, ch = sa.adain_affine_from_stats(v_in, cache.content_mean[r_ids],
                                            cache.content_std[r_ids])
        caff = sa._affine((cs, ch) if adain else None, b, h, N_REFS, d, dev)
        keys, vals = widened(crk[r_ids], crv[r_ids], caff)
        ident = lambda: sa.shared_attention_identity(q, None, v_in, cache, r_ids, scale=scale,
                                                     use_adain=adain)
        ident_rows.append(row(
            f"shared_identity {tag}", ident,
            lambda: sa.shared_identity_plain(q, crk, crv, caff, cache.kmax, r_ids, scale=scale),
            lambda: F.scaled_dot_product_attention(q, keys, vals, scale=scale),
            4.0 * b * h * sq * N_REFS * s * d,
            (2 * b * h * sq * d * 2 + 2 * 2 * N_REFS * h * s * d * 2
             + b * h * N_REFS * 2 * d * 4 + 2 * h * 4 + b * 8),
            **dict(meta, keys=N_REFS * s, route="ragged, identity cache")))
        if not torch.equal(ident(), ident()):
            raise AssertionError(f"shared_identity {tag}: two launches differ")
        del q, k_in, v_in, rk, rv, aff, cache, keys, vals
    torch.cuda.empty_cache()

    src, jax_src = "instantrestore_tpu_torch/csrc/", "instantrestore_tpu/ops/shared_attention.py:"
    results = [
        ("shared_identity_attention", src + "shared_identity.cu", jax_src + "803", ident_rows),
        ("flash_attention_bound", src + "flash_bound.cu", jax_src + "174", flash_rows),
        ("shared_flash_bound", src + "shared_flash_bound.cu", jax_src + "429", bound_rows),
        ("flash_attention_online", src + "flash_online.cu", jax_src + "58", fonline_rows),
        ("shared_online", src + "shared_online.cu", jax_src + "339", online_rows),
        ("shared_online_pair", src + "shared_online_pair.cu", jax_src + "599", pair_rows),
    ]
    for name, _, _, rows in results:
        for r in rows:
            print(f"kernel {name} {json.dumps(r)} [{card}]")
    escape_hatch(card)
    out_of_cache_id(card)
    return results + [group_norm_rows(card)]


def group_norm_rows(card: str):
    """The GroupNorm kernel against its plain version at every GroupNorm
    shape of a warm restore (batch 16) and of the cold capture (batch 32):
    two launches bit for bit, then the kernel's, the plain version's and
    the library's (``F.group_norm`` + ``F.silu``, the bias terms added
    first) times beside the bound, one read of x for the statistics and one
    read and one write for the output at 3.35 TB/s. Returns the result
    entry of the warm restore's rows; prints the capture's sums."""
    import torch
    import torch.nn.functional as F

    from instantrestore_tpu_torch.ops import primitives as prims

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)

    def rows_at(batch, shapes, what):
        rows = []
        for h, w, c, act, terms, count in shapes:
            x = (torch.randn((batch, h, w, c), generator=g, device=dev) * 2 + 0.5).to(
                torch.bfloat16)
            p = {"weight": (torch.randn(c, generator=g, device=dev) + 1).to(torch.bfloat16),
                 "bias": (torch.randn(c, generator=g, device=dev) * 0.5).to(torch.bfloat16)}
            bias = ()
            if terms:
                bias = ((torch.randn(c, generator=g, device=dev) * 0.3).to(torch.bfloat16),)
            if terms == "c+bc":
                bias += ((torch.randn((batch, c), generator=g, device=dev) * 0.3).to(
                    torch.bfloat16),)
            call = lambda: prims.group_norm(p, x, in_bias=bias, act=act)
            plain = lambda: prims.group_norm_plain(p, x, in_bias=bias, act=act)

            def lib():
                xb = x
                for t in bias:
                    xb = xb + (t if t.ndim == 1 else t[:, None, None, :])
                y = F.group_norm(xb.permute(0, 3, 1, 2), 32, p["weight"], p["bias"], 1e-5)
                return F.silu(y) if act else y

            out = call()
            torch.cuda.synchronize()
            err, tol, rel_rms = compare(f"group_norm {what} {(batch, h, w, c, act, terms)}", out,
                                        plain())
            if not torch.equal(out, call()):
                raise AssertionError(f"group_norm {what} {(batch, h, w, c)}: two launches differ")
            b_ms, b_by = bound(0.0, 3.0 * x.numel() * 2)
            rows.append(dict(batch=batch, h=h, w=w, c=c, act=act or "none", terms=terms or "none",
                             per_pass=count, max_abs_err=err, tol=tol, rel_rms=rel_rms,
                             ms=cuda_ms(call, 10), plain_ms=cuda_ms(plain, 3),
                             library_ms=cuda_ms(lib, 10), bound_ms=b_ms, bound_by=b_by))
            del x, out
        torch.cuda.empty_cache()
        tot = {k: sum(r[k] * r["per_pass"] for r in rows)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        print(f"group_norm per {what}: kernel {tot['ms']:.2f} ms, bound {tot['bound_ms']:.2f} ms "
              f"({tot['ms'] / tot['bound_ms']:.2f}x), plain {tot['plain_ms']:.2f} ms, "
              f"F.group_norm + F.silu {tot['library_ms']:.2f} ms, "
              f"{sum(r['per_pass'] for r in rows)} calls [{card}]")
        return rows

    warm = rows_at(BATCH, GN_ENCODER + GN_UNET + GN_DECODER, f"warm restore (batch {BATCH})")
    rows_at(CAPTURE_BATCH, GN_ENCODER + GN_UNET, f"cold capture (batch {CAPTURE_BATCH})")
    for r in warm:
        print(f"kernel group_norm {json.dumps(r)} [{card}]")
    return ("group_norm", "instantrestore_tpu_torch/csrc/group_norm.cu",
            "none (the JAX package's GroupNorm is jnp, fused by XLA)", warm)


def vjp_kernel_phase(card: str):
    """The forward-with-LSE kernel and the two backward kernels against their
    plain versions at a train step's shapes, batch 2. The backward kernels
    and their plain versions take the forward kernel's out and lse."""
    import torch
    import torch.nn.functional as F

    from instantrestore_tpu_torch.models.attention import softmax_attention
    from instantrestore_tpu_torch.ops import flash_vjp as fv
    from instantrestore_tpu_torch.ops import shared_attention as sa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    bsz = TRAIN_BATCH
    fwd_rows, dq_rows, dkv_rows = [], [], []

    def fwd_row(q, k, v, scale, meta, label, got, block_k=None):
        """flash_fwd_lse's launch ``got`` = (out, lse) against its plain
        version on the kernel's chunk (``block_k``, default the rule's): out
        within the kernels' tolerance, the LSE within LSE_TOL, a second launch
        bit-identical; then the times and the bound."""
        out, lse = got
        b, h, sq, d = q.shape
        skv = k.shape[2]
        chunk = block_k or sa.flash_online_chunk(skv, d)
        ref_out, ref_lse = fv.flash_fwd_lse_plain(q, k, v, scale=scale, block_k=chunk)
        err, tol, rel = compare(f"flash_fwd_lse {label}", out, ref_out)
        lse_err = float((lse - ref_lse).abs().max())
        if not lse_err <= LSE_TOL:
            raise AssertionError(f"flash_fwd_lse {label}: LSE max-abs {lse_err} (tol {LSE_TOL})")
        out2, lse2 = fv.flash_fwd_lse(q, k, v, scale=scale)
        if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
            raise AssertionError(f"flash_fwd_lse {label}: two launches differ")
        del ref_out, ref_lse, out2, lse2
        b_ms, b_by = bound(4.0 * b * h * sq * skv * d,
                           (2 * b * h * sq * d + 2 * b * h * skv * d) * 2 + b * h * sq * 4)
        return dict(
            **meta, chunk=chunk, max_abs_err=err, tol=tol, rel_rms=rel, lse_max_abs_err=lse_err,
            ms=cuda_ms(lambda: fv.flash_fwd_lse(q, k, v, scale=scale), 5),
            plain_ms=cuda_ms(lambda: fv.flash_fwd_lse_plain(q, k, v, scale=scale), 1),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 5),
            bound_ms=b_ms, bound_by=b_by)

    def bwd_rows(q, k, v, do, out, lse, scale, meta, label):
        """flash_bwd_dq and flash_bwd_dkv on the forward kernel's out and lse
        against their plain versions on the same inputs, two launches of each
        bit-identical; then the times beside SDPA's joint backward (dQ, dK
        and dV in one autograd call) and the bounds. Returns the two rows and
        (dQ, dK, dV)."""
        b, h, sq, d = q.shape
        skv = k.shape[2]
        delta = (do.float() * out.float()).sum(dim=-1)
        args = (q, k, v, do, lse, delta)
        work = float(b) * h * sq * skv * d
        qb, kb, rb = b * h * sq * d * 2, b * h * skv * d * 2, b * h * sq * 4
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do,
                                                      retain_graph=True), 5)
        del lib_out, qg, kg, vg

        dq = fv.flash_bwd_dq(*args, scale=scale)
        torch.cuda.synchronize()
        err, tol, rel = compare(f"flash_bwd_dq {label}", dq,
                                fv.flash_bwd_dq_plain(*args, scale=scale))
        b_ms, b_by = bound(6 * work, 3 * qb + 2 * kb + 2 * rb)
        dq_row = dict(
            **meta, max_abs_err=err, tol=tol, rel_rms=rel,
            ms=cuda_ms(lambda: fv.flash_bwd_dq(*args, scale=scale), 5),
            plain_ms=cuda_ms(lambda: fv.flash_bwd_dq_plain(*args, scale=scale), 1),
            library_ms=lib_bwd, library="sdpa backward, dQ, dK and dV together",
            bound_ms=b_ms, bound_by=b_by)

        dk, dv = fv.flash_bwd_dkv(*args, scale=scale)
        torch.cuda.synchronize()
        ref_dk, ref_dv = fv.flash_bwd_dkv_plain(*args, scale=scale)
        err_k, tol_k, rel_k = compare(f"flash_bwd_dkv dK {label}", dk, ref_dk)
        err_v, tol_v, rel_v = compare(f"flash_bwd_dkv dV {label}", dv, ref_dv)
        del ref_dk, ref_dv
        dk2, dv2 = fv.flash_bwd_dkv(*args, scale=scale)
        if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)
                and torch.equal(dq, fv.flash_bwd_dq(*args, scale=scale))):
            raise AssertionError(f"backward kernels {label}: two launches differ")
        del dk2, dv2
        b_ms, b_by = bound(8 * work, 2 * qb + 4 * kb + 2 * rb)
        dkv_row = dict(
            **meta, max_abs_err=max(err_k, err_v), tol=min(tol_k, tol_v),
            rel_rms=max(rel_k, rel_v),
            ms=cuda_ms(lambda: fv.flash_bwd_dkv(*args, scale=scale), 5),
            plain_ms=cuda_ms(lambda: fv.flash_bwd_dkv_plain(*args, scale=scale), 1),
            library_ms=lib_bwd, library="sdpa backward, dQ, dK and dV together",
            bound_ms=b_ms, bound_by=b_by)
        return dq_row, dkv_row, (dq, dk, dv)

    for h, sq, skv, d, per_pass in VJP_SHAPES:
        q, k, v, do = (torch.randn((bsz, h, n, d), generator=g, device=dev).to(torch.bfloat16)
                       for n in (sq, skv, skv, sq))
        scale = d ** -0.5
        out, lse = fv.flash_fwd_lse(q, k, v, scale=scale)
        torch.cuda.synchronize()
        meta = dict(heads=h, queries=sq, keys=skv, head_dim=d, per_pass=per_pass)
        label = f"H={h} Sq={sq} Skv={skv} d={d}"

        fwd_rows.append(fwd_row(q, k, v, scale, meta, label, (out, lse)))
        dq_row, dkv_row, (dq, dk, dv) = bwd_rows(q, k, v, do, out, lse, scale, meta, label)
        dq_rows.append(dq_row)
        dkv_rows.append(dkv_row)

        if (h, sq, skv, d) in (VJP_AUTOGRAD_SHAPE, VJP_AUTOGRAD_D512):
            # the same gradients from fp32 autograd through the unfused attention
            qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
            ref = torch.autograd.grad(softmax_attention(qf, kf, vf, scale), (qf, kf, vf),
                                      do.float())
            rels = [float((a.float() - r).norm() / r.norm()) for a, r in zip((dq, dk, dv), ref)]
            print(f"backward kernels {label} against fp32 autograd through softmax_attention "
                  f"[{card}]: relative RMS dQ {rels[0]:.2e}, dK {rels[1]:.2e}, dV {rels[2]:.2e} "
                  f"(tol {VJP_AUTOGRAD_REL_RMS})")
            if max(rels) > VJP_AUTOGRAD_REL_RMS:
                raise AssertionError("backward kernels disagree with fp32 autograd")
            del qf, kf, vf, ref
        del q, k, v, do, out, lse, dq, dk, dv
        torch.cuda.empty_cache()

    # rows 4-6 at the capture's shapes under a gradient (train_reference_networks,
    # batch 8): not on the default train step, so per_pass 0; their time per
    # G step of that option is printed
    capture_ms = {"flash_fwd_lse": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for h, s_, d, fwds, bwds in VJP_CAPTURE_SHAPES:
        q, k, v, do = (torch.randn((VJP_CAPTURE_BATCH, h, s_, d), generator=g, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        scale = d ** -0.5
        out, lse = fv.flash_fwd_lse(q, k, v, scale=scale)
        torch.cuda.synchronize()
        meta = dict(batch=VJP_CAPTURE_BATCH, heads=h, queries=s_, keys=s_, head_dim=d,
                    per_pass=0, route="capture under a gradient",
                    per_capture_step=dict(forward=2 * fwds, backward=bwds))
        label = f"capture B={VJP_CAPTURE_BATCH} H={h} S={s_} d={d}"
        fwd_rows.append(fwd_row(q, k, v, scale, meta, label, (out, lse)))
        dq_row, dkv_row, _ = bwd_rows(q, k, v, do, out, lse, scale, meta, label)
        dq_rows.append(dq_row)
        dkv_rows.append(dkv_row)
        capture_ms["flash_fwd_lse"] += 2 * fwds * fwd_rows[-1]["ms"]  # remat: twice
        capture_ms["flash_bwd_dq"] += bwds * dq_row["ms"]
        capture_ms["flash_bwd_dkv"] += bwds * dkv_row["ms"]
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    print(f"rows 4-6 at the capture's shapes, per G step with train_reference_networks (batch "
          f"{VJP_CAPTURE_BATCH}, remat): {({k: round(v, 3) for k, v in capture_ms.items()})} ms "
          f"[{card}]")

    # rows 4-6 at d=512 with Sq != Skv (the backward's keys in a ragged last
    # block of 64: 96 keys)
    b, h, sq, skv = FLASH_VARIANT_D512
    q, k, v, do = (torch.randn((b, h, n, 512), generator=g, device=dev).to(torch.bfloat16)
                   for n in (sq, skv, skv, sq))
    chunk = sa.flash_online_chunk(skv, 512)
    tiles = fv.flash_bwd_tiles(sq, skv, 512)
    meta = dict(batch=b, heads=h, queries=sq, keys=skv, head_dim=512, per_pass=0)
    label = f"B={b} H={h} Sq={sq} Skv={skv} d=512"
    out, lse = fv.flash_fwd_lse(q, k, v, scale=512 ** -0.5)
    fwd_rows.append(fwd_row(
        q, k, v, 512 ** -0.5, dict(meta, route=f"64 query rows a block, key chunk {chunk}"),
        label, (out, lse), chunk))
    dq_row, dkv_row, _ = bwd_rows(q, k, v, do, out, lse, 512 ** -0.5, meta, label)
    dq_rows.append(dict(dq_row, route=f"{tiles.dq_rows} query rows a block, key chunk "
                                      f"{tiles.dq_chunk}"))
    dkv_rows.append(dict(dkv_row, route=f"{tiles.dkv_rows} keys a block, query chunk "
                                        f"{tiles.dkv_chunk}, dV and dK in two launches"))
    del q, k, v, do, out, lse

    # rows 4-6 at ragged shapes (d=64): Sq or Skv off the tiles' 64 rows
    for b, h, sq, skv in RAGGED_SHAPES:
        q, k, v, do = (torch.randn((b, h, n, 64), generator=g, device=dev).to(torch.bfloat16)
                       for n in (sq, skv, skv, sq))
        meta = dict(batch=b, heads=h, queries=sq, keys=skv, head_dim=64, per_pass=0,
                    route="ragged")
        label = f"ragged B={b} H={h} Sq={sq} Skv={skv}"
        out, lse = fv.flash_fwd_lse(q, k, v, scale=0.125)
        fwd_rows.append(fwd_row(q, k, v, 0.125, meta, label, (out, lse)))
        dq_row, dkv_row, _ = bwd_rows(q, k, v, do, out, lse, 0.125, meta, label)
        dq_rows.append(dq_row)
        dkv_rows.append(dkv_row)
        del q, k, v, do, out, lse

    # rows 4-6 on their tiles' other tiles: row 4 on the wgmma tile's 64 query
    # rows a block or 64-key chunk, rows 5 and 6 on the backward tile's 64 rows
    # a block of one kernel and 128 of the other
    for b, h, sq, skv in FLASH_VARIANT_SHAPES:
        q, k, v, do = (torch.randn((b, h, n, 64), generator=g, device=dev).to(torch.bfloat16)
                       for n in (sq, skv, skv, sq))
        chunk = sa.flash_online_chunk(skv, 64)
        tiles = fv.flash_bwd_tiles(sq, skv, 64)
        meta = dict(batch=b, heads=h, queries=sq, keys=skv, head_dim=64, per_pass=0)
        label = f"B={b} H={h} Sq={sq} Skv={skv}"
        out, lse = fv.flash_fwd_lse(q, k, v, scale=0.125)
        fwd_rows.append(fwd_row(
            q, k, v, 0.125,
            dict(meta, route=f"{128 if sq % 128 == 0 else 64} query rows a block, key chunk "
                             f"{chunk}"),
            label, (out, lse), chunk))
        dq_row, dkv_row, _ = bwd_rows(q, k, v, do, out, lse, 0.125, meta, label)
        dq_rows.append(dict(dq_row, route=f"{tiles.dq_rows} query rows a block, key chunk "
                                          f"{tiles.dq_chunk}"))
        dkv_rows.append(dict(dkv_row, route=f"{tiles.dkv_rows} keys a block, query chunk "
                                            f"{tiles.dkv_chunk}"))
        del q, k, v, do, out, lse

    src, jax_src = "instantrestore_tpu_torch/csrc/", "instantrestore_tpu/ops/flash_vjp.py:"
    results = [
        ("flash_fwd_lse", src + "flash_fwd_lse.cu", jax_src + "78", fwd_rows),
        ("flash_bwd_dq", src + "flash_bwd_dq.cu", jax_src + "169", dq_rows),
        ("flash_bwd_dkv", src + "flash_bwd_dkv.cu", jax_src + "203", dkv_rows),
    ]
    for name, _, _, rows in results:
        for r in rows:
            print(f"kernel {name} {json.dumps(r)} [{card}]")
    return results


def escape_hatch(card: str):
    """Bound slack beyond ~190 log2 units on the card: one large-norm key
    orthogonal to every query lifts every row's bound far above its scores.
    The bound kernels flush each p to 0 and return 0 / 0; the online kernels
    stay finite and equal their plain versions."""
    import torch

    from instantrestore_tpu_torch.ops import shared_attention as sa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(99)
    b, h, s, d, n = 2, 10, 1024, 64, N_REFS
    q = torch.randn((b, h, s, d), generator=g, device=dev)
    q[..., d // 2:] = 0
    q = q.to(torch.bfloat16)
    rk = torch.randn((b, n, h, s, d), generator=g, device=dev).to(torch.bfloat16)
    rv = torch.randn((b, n, h, s, d), generator=g, device=dev).to(torch.bfloat16)
    rk[:, 1, :, 5, :] = 0
    rk[:, 1, :, 5, d - 1] = 4096.0
    scale = d ** -0.5
    slack = _slack(q, rk.permute(0, 2, 1, 3, 4).reshape(b, h, n * s, d), scale)
    kw = dict(scale=scale, include_input=False)
    bound_out = sa.shared_flash_attention(q, None, None, rk, rv, algo="kv_outer_bound", **kw)
    paired_out = sa.shared_flash_attention(q, None, None, rk, rv, algo="kv_outer_bound_paired",
                                           **kw)
    online_out = sa.shared_flash_attention(q, None, None, rk, rv, algo="kv_outer", **kw)
    torch.cuda.synchronize()
    if not (torch.equal(online_out, sa.shared_flash_attention(q, None, None, rk, rv,
                                                              algo="kv_outer", **kw))
            and torch.equal(online_out, sa.shared_flash_attention(q, None, None, rk, rv,
                                                                  algo="kv_outer_packed", **kw))):
        raise AssertionError("escape hatch: a second launch of shared_online, or "
                             "shared_online_pair, gave other bits")
    plain = sa.shared_online_plain(q, None, None, rk, rv, sa._affine(None, b, h, n, d, dev), **kw)
    err, tol, rel_rms = compare("escape hatch, shared_online", online_out, plain)
    bad_rows = int((~torch.isfinite(bound_out).all(dim=-1)).sum())
    bad_paired = int((~torch.isfinite(paired_out).all(dim=-1)).sum())
    print(f"escape hatch [{card}]: slack {slack:.0f} log2 units; shared_flash_bound non-finite "
          f"rows {bad_rows} of {b * h * s}, shared_identity (paired route) {bad_paired}; "
          f"shared_online finite, max-abs {err:.5f} (tol {tol:.4f}), relative RMS {rel_rms:.2e} "
          f"against its plain version, a second launch and shared_online_pair bit-identical")
    if slack <= 190 or bad_rows != b * h * s or bad_paired != b * h * s:
        raise AssertionError("escape hatch: a bound kernel did not lose every row")

    # flash_bound at both widths: every odd query row scaled to a thousandth
    # keeps its bound within reach, the others lose it; the kernel loses
    # exactly the rows its plain version loses, agrees with it on the rest,
    # and flash_online is finite on the same inputs
    for fb, fh, fs, fd in ((2, 10, 1024, 64), (2, 1, 256, 512)):
        q = torch.randn((fb, fh, fs, fd), generator=g, device=dev)
        q[..., fd // 2:] = 0
        q[:, :, 1::2] *= 1e-3
        q = q.to(torch.bfloat16)
        k = torch.randn((fb, fh, fs, fd), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((fb, fh, fs, fd), generator=g, device=dev).to(torch.bfloat16)
        k[:, :, 5, :] = 0
        k[:, :, 5, fd - 1] = 4096.0
        fscale = fd ** -0.5
        slack = _slack(q, k, fscale)
        out = sa.flash_attention(q, k, v, scale=fscale, algo="bound")
        ref = sa.flash_attention_plain(q, k, v, scale=fscale)
        online = sa.flash_attention(q, k, v, scale=fscale, algo="online")
        torch.cuda.synchronize()
        lost, lost_ref = (~torch.isfinite(x).all(dim=-1) for x in (out, ref))
        n_lost = int(lost.sum())
        err, tol, _ = compare(f"escape hatch, flash_bound d={fd}, rows kept", out[~lost],
                              ref[~lost])
        o_err, o_tol, _ = compare(f"escape hatch, flash_online d={fd}", online,
                                  sa.flash_online_plain(q, k, v, scale=fscale))
        print(f"escape hatch [{card}]: flash_bound d={fd} slack {slack:.0f} log2 units; "
              f"non-finite rows {n_lost} of {fb * fh * fs}, the same rows as its plain "
              f"version: {torch.equal(lost, lost_ref)}; rows kept max-abs {err:.5f} (tol "
              f"{tol:.4f}); flash_online finite, max-abs {o_err:.5f} (tol {o_tol:.4f})")
        if slack <= 190 or n_lost != fb * fh * fs // 2 or not torch.equal(lost, lost_ref):
            raise AssertionError(f"escape hatch: flash_bound d={fd} did not lose exactly the "
                                 f"rows its plain version loses")


def out_of_cache_id(card: str):
    """An identity id outside the cache, given to the bound kernels that
    read the cache by id, makes exactly its sample's outputs NaN: the
    kernels check ids[b] themselves (the wrappers are called straight, as
    the engine's own gathers of the AdaIN statistics would index outside the
    cache first)."""
    import torch

    from instantrestore_tpu_torch.ops import shared_attention as sa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(98)
    b, h, s, d, scale = 4, 10, 1024, 64, 64 ** -0.5
    q = torch.randn((b, h, s, d), generator=g, device=dev).to(torch.bfloat16)
    for n in (N_REFS, N_REFS - 1):  # shared_identity, shared_flash_bound by id
        rk, rv = (torch.randn((3, n, h, s, d), generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        (cache,) = sa.build_identity_kv_cache([(rk, rv)])
        aff = sa._affine(None, b, h, n, d, dev)

        def launch(ids):
            ids = torch.tensor(ids, device=dev)
            if n % 2 == 0:
                return sa.shared_identity(q, cache.rk, cache.rv, aff, cache.kmax, ids, scale=scale)
            return sa.shared_flash_bound(q, None, None, cache.rk, cache.rv, aff,
                                         cache.kmax[ids.clamp(max=2)], ids, scale=scale,
                                         include_input=False)

        good, out = launch([2, 2, 1, 0]), launch([2, 3, 1, 0])
        poisoned = bool(torch.isnan(out[1]).all())
        others = bool(torch.equal(out[[0, 2, 3]], good[[0, 2, 3]]))
        name = "shared_identity" if n % 2 == 0 else "shared_flash_bound"
        print(f"out-of-cache id [{card}]: {name} (N={n}) sample with id 3 of a 3-identity cache "
              f"all NaN {poisoned}; the other samples bit-identical to a valid call {others}")
        if not (poisoned and others and bool(torch.isfinite(good).all())):
            raise AssertionError(f"{name}: an out-of-cache id did not poison exactly its sample")


def _slack(q, keys, scale: float) -> float:
    """Largest Cauchy-Schwarz slack of the bound softmax over the rows of q
    [B, H, Sq, d] against keys [B, H, Skv, d], in log2 units: a row flushes
    to zero (NaN out) only beyond ~190."""
    import torch

    from instantrestore_tpu_torch.ops.shared_attention import LOG2E

    c = scale * LOG2E
    kf = keys.float()
    kmax = kf.norm(dim=-1).amax(dim=2)[:, :, None]
    worst = 0.0
    for i in range(0, q.shape[2], 256):
        qf = q[:, :, i : i + 256].float()
        smax = (qf @ kf.transpose(-1, -2)).amax(dim=-1)
        worst = max(worst, float((c * (qf.norm(dim=-1) * kmax - smax)).max()))
        del qf, smax
    torch.cuda.empty_cache()
    return worst


def measure_slack(run, what: str):
    """``run()`` (one restore under the default algorithms) with every
    bound-softmax attention call recording its slack, printed per layer."""
    import torch

    from instantrestore_tpu_torch.models import attention as attn_mod
    from instantrestore_tpu_torch.models import vae as vae_mod

    flash, ident = attn_mod.flash_attention, attn_mod.shared_attention_identity
    shared = attn_mod.shared_flash_attention
    records = []

    def ref_keys(rk):
        b, n, h, s, d = rk.shape
        return rk.permute(0, 2, 1, 3, 4).reshape(b, h, n * s, d)

    def flash_rec(q, k, v, *, scale):
        records.append(("flash_attention_bound", tuple(q.shape), _slack(q, k, scale)))
        return flash(q, k, v, scale=scale)

    def ident_rec(q, k_in, v_in, cache, ids_, *, scale, use_adain):
        records.append(("shared_identity_attention", tuple(q.shape),
                        _slack(q, ref_keys(cache.rk[ids_]), scale)))
        return ident(q, k_in, v_in, cache, ids_, scale=scale, use_adain=use_adain)

    def shared_rec(q, k_in, v_in, rk, rv, *, scale, v_affine, include_input):
        keys = ref_keys(rk)
        if include_input:
            keys = torch.cat([k_in, keys], dim=2)
        records.append(("shared_flash_bound", tuple(q.shape), _slack(q, keys, scale)))
        return shared(q, k_in, v_in, rk, rv, scale=scale, v_affine=v_affine,
                      include_input=include_input)

    attn_mod.flash_attention, vae_mod.flash_attention = flash_rec, flash_rec
    attn_mod.shared_attention_identity = ident_rec
    attn_mod.shared_flash_attention = shared_rec
    try:
        run()
    finally:
        attn_mod.flash_attention, vae_mod.flash_attention = flash, flash
        attn_mod.shared_attention_identity = ident
        attn_mod.shared_flash_attention = shared
    by_layer = {}  # calls of one kernel at one shape, in call order
    for name, shape, slack in records:
        by_layer.setdefault((name, shape), []).append(round(slack, 2))
    for (name, shape), slacks in by_layer.items():
        print(f"bound slack, {what}, {name} q{list(shape)}: max {max(slacks):.2f} log2 units "
              f"over {len(slacks)} calls {slacks} (rows flush beyond ~190)")
    return records


# the host's launch calls the profiler records, by runtime API name
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
               "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def profile_run(fn, what: str, card: str, shares=None, top: int = 15, api_calls=None):
    """Device time of one call of ``fn`` by kernel, from torch.profiler;
    ``shares`` {label: name fragments} also prints those kernels' summed
    share; a dict ``api_calls`` receives the count of each LAUNCH_APIS call
    the host made. Returns the device-busy ms (None when nothing was
    recorded)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # device activity only (kernels and the runtime's launch calls): the
    # host's op events of a ~30k-launch step take the profiler half a
    # minute to read and nothing here uses them
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if api_calls is not None:
        api_calls.update({e.key: e.count for e in prof.key_averages() if e.key in LAUNCH_APIS})
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.device_time_total > 0:
            tot, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.device_time_total / 1e3, cnt + 1)
    busy = sum(t for t, _ in by_name.values())
    if busy == 0:
        print("profiler: no device time recorded")
        return None
    print(f"profile of {what} [{card}]: device busy {busy:.1f} ms of {wall_ms:.1f} ms wall "
          f"(profiler on); kernels by device time:")
    for name, (t, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {t:8.2f} ms {t / busy * 100:5.1f}%  x{cnt:<4d} {name[:110]}")
    for label, fragments in (shares or {}).items():
        hits = [(t, cnt) for name, (t, cnt) in by_name.items() if any(f in name for f in fragments)]
        t, cnt = sum(h[0] for h in hits), sum(h[1] for h in hits)
        print(f"  {label}: {t:.2f} ms in {cnt} launches, {t / busy * 100:.1f}% of device time")
    return busy


# kernel name -> the name of its wrapper in ``flash_vjp.KERNEL_WRAPPERS``
# (ops/shared_attention.py, ops/flash_vjp.py, ops/primitives.py for
# group_norm), which holds the launch count
KERNEL_WRAPPERS = {
    "shared_identity_attention": "shared_identity", "flash_attention_bound": "flash_attention",
    "shared_flash_bound": "shared_flash_bound", "flash_attention_online": "flash_online",
    "shared_online": "shared_online", "shared_online_pair": "shared_online_pair",
    "flash_fwd_lse": "flash_fwd_lse", "flash_bwd_dq": "flash_bwd_dq",
    "flash_bwd_dkv": "flash_bwd_dkv", "group_norm": "group_norm",
}
KERNEL_NAMES = tuple(KERNEL_WRAPPERS)


def reset_counts():
    """Zero every kernel wrapper's launch count."""
    from instantrestore_tpu_torch.ops.flash_vjp import reset_launch_counts

    reset_launch_counts()


def launch_counts():
    """Launches since the last reset, by kernel name."""
    from instantrestore_tpu_torch.ops import flash_vjp

    by_wrapper = flash_vjp.launch_counts()
    return {name: by_wrapper[wrapper] for name, wrapper in KERNEL_WRAPPERS.items()}


def algo_env(attn=None, flash=None):
    """INSTANTRESTORE_ATTN_ALGO / INSTANTRESTORE_FLASH_ALGO set for the block,
    and put back as they were after it."""
    return environ({"INSTANTRESTORE_ATTN_ALGO": attn, "INSTANTRESTORE_FLASH_ALGO": flash})


@contextlib.contextmanager
def environ(wanted: dict):
    """The environment variables of ``wanted`` (None: left as they are) set
    for the block, and put back as they were after it."""
    before = {k: os.environ.get(k) for k in wanted}
    try:
        for k, v in wanted.items():
            if v is not None:
                os.environ[k] = v
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_launches(failures, what: str, got: dict, runs: int, **per_run):
    """Each kernel launched ``per_run[kernel] * runs`` times (absent: 0)."""
    want = {k: per_run.get(k, 0) * runs for k in KERNEL_NAMES}
    print(f"launches, {what}: {got}")
    if got != want:
        failures.append(f"{what}: launches {got}, expected {want}")


# the profiles' share of the GroupNorm kernels
GN_SHARE = {"GroupNorm kernels": ("irt_group_norm_",)}


def add_counts(total: dict, got: dict):
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def mean_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().mean())


def warm_phase(card: str):
    """The warm-identity serving path at full width; returns its context
    (engine, inputs, outputs) and launch counts."""
    import torch

    from instantrestore_tpu_torch.inference.serving import ServingEngine
    from instantrestore_tpu_torch.models.restorer import (
        RestorerStatics,
        init_restorer_params,
        serving_bundle,
    )

    dev = torch.device("cuda")
    statics = RestorerStatics(use_adain=True, train_input=False)  # full SD-Turbo widths, bf16
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_restorer_params(gen, statics, lora_rank_unet=32, lora_rank_vae=32, device=dev)
    engine = ServingEngine(serving_bundle(params, statics), statics, device=dev)
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"init + serving_bundle: {time.perf_counter() - t0:.3f} s")

    host = torch.Generator().manual_seed(1)
    refs = torch.randint(0, 256, (N_IDENT, N_REFS, RES, RES, 3), dtype=torch.uint8, generator=host)
    images = torch.randint(0, 256, (BATCH, RES, RES, 3), dtype=torch.uint8, generator=host)
    ids = torch.tensor([3, 7, 7, 0, 15, 2, 3, 9, 12, 7, 1, 0, 5, 15, 8, 3])
    lat = RES // 8
    noise = {k: torch.randn((BATCH, lat, lat, 4), generator=host).to(dev)
             for k in ("latent", "diffusion")}
    # explicit onboarding noise, so that the cold phase can reuse it
    onboard_noise = {k: torch.randn((N_IDENT, N_REFS, lat, lat, 4), generator=host).to(dev)
                     for k in ("latent", "diffusion")}

    # warm-up: a one-identity onboarding takes cuDNN's first-call set-up, so
    # that the onboarding time below is a steady figure
    engine.onboard(refs[:1], generator=torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()

    # ---- main path: onboarding, then restores ----
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.onboard(refs, noise=onboard_noise)
    torch.cuda.synchronize()
    onboard_s = time.perf_counter() - t0
    onboard_counts = launch_counts()

    reset_counts()
    lat_s, out = [], None
    for _ in range(RESTORE_RUNS + 1):  # the first run includes cuDNN's first-call set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.restore(images, ids, noise=noise)
        torch.cuda.synchronize()
        lat_s.append(time.perf_counter() - t0)
    restore_counts = launch_counts()
    n_restores = RESTORE_RUNS + 1
    failures = []
    check_launches(failures, f"onboarding {N_IDENT} identities", onboard_counts, N_IDENT,
                   flash_attention_bound=17, group_norm=GN_CAPTURE)
    check_launches(failures, f"{n_restores} warm restores", restore_counts, n_restores,
                   shared_identity_attention=9, flash_attention_bound=9, group_norm=GN_WARM)
    total = dict(onboard_counts)
    add_counts(total, restore_counts)
    if tuple(out.shape) != (BATCH, RES, RES, 3):
        failures.append(f"output shape {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        failures.append("non-finite output")
    steady = statistics.median(lat_s[1:])
    print(f"onboarding {N_IDENT} identities x {N_REFS} refs (after a one-identity warm-up): "
          f"{onboard_s:.3f} s [{card}]")
    print(f"restore batch {BATCH}: first {lat_s[0] * 1e3:.1f} ms, steady median "
          f"{steady * 1e3:.1f} ms over {RESTORE_RUNS} runs {[round(x * 1e3, 1) for x in lat_s[1:]]} "
          f"[{card}]")
    print(f"faces/sec: {BATCH / steady:.2f} (batch {BATCH}, {N_REFS} refs, 512 px, warm "
          f"identity KV, bf16) [{card}]")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- the same restore through the unfused attention path, two samples ----
    engine.use_fused_attention = False
    few = slice(0, 2)
    ref = engine.restore(images[few], ids[few], noise={k: v[few] for k, v in noise.items()})
    engine.use_fused_attention = True
    diff = (out[few].float() - ref.float()).abs()
    print(f"fused vs unfused attention (2 samples): max-abs {float(diff.max()):.4f}, "
          f"mean-abs {float(diff.mean()):.5f}")
    if float(diff.mean()) > 2e-2:
        failures.append("fused path disagrees with the unfused path")

    measure_slack(lambda: engine.restore(images, ids, noise=noise), "warm restore")
    profile_run(lambda: engine.restore(images, ids, noise=noise), "one restore", card,
                shares=GN_SHARE)
    if failures:
        raise AssertionError("warm phase failed: " + "; ".join(failures))
    return dict(engine=engine, refs=refs, images=images, ids=ids, noise=noise,
                onboard_noise=onboard_noise, out=out, host=host), total


def _rows(noise, n: int):
    """The first n samples' entries of a restore's noise dict."""
    return {k: v[: n * N_REFS] if k.startswith("cond_") else v[:n] for k, v in noise.items()}


def cold_phase(card: str, w):
    """restore_cold of the warm phase's batch, each sample's identity
    references re-encoded in the call; returns the noise, output and counts."""
    import torch


    engine, ids, images = w["engine"], w["ids"], w["images"]
    dev_ids = ids.to(engine.device)
    cond = w["refs"][ids]  # [B, N, 512, 512, 3] uint8: the identities' own references
    lat = RES // 8
    # the onboarding noise of each sample's identity, so that cold equals warm
    noise = dict(w["noise"])
    for k, v in w["onboard_noise"].items():
        noise[f"cond_{k}"] = v[dev_ids].reshape(BATCH * N_REFS, lat, lat, 4)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    lat_s, out = [], None
    for _ in range(RESTORE_RUNS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.restore_cold(images, cond, noise=noise)
        torch.cuda.synchronize()
        lat_s.append(time.perf_counter() - t0)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    failures = []
    check_launches(failures, f"{RESTORE_RUNS + 1} cold restores", counts, RESTORE_RUNS + 1,
                   shared_flash_bound=9, flash_attention_bound=26, group_norm=GN_COLD)
    if tuple(out.shape) != (BATCH, RES, RES, 3):
        failures.append(f"cold output shape {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        failures.append("non-finite cold output")
    steady = statistics.median(lat_s[1:])
    print(f"cold restore batch {BATCH} x {N_REFS} refs re-encoded: first {lat_s[0] * 1e3:.1f} ms, "
          f"steady median {steady * 1e3:.1f} ms over {RESTORE_RUNS} runs "
          f"{[round(x * 1e3, 1) for x in lat_s[1:]]} [{card}]")
    print(f"cold faces/sec: {BATCH / steady:.2f} (batch {BATCH}, {N_REFS} refs, 512 px, bf16) "
          f"[{card}]")
    print(f"cold peak device memory: {peak:.2f} GiB")

    engine.use_fused_attention = False
    ref = engine.restore_cold(images[:2], cond[:2], noise=_rows(noise, 2))
    engine.use_fused_attention = True
    unfused = mean_abs(out[:2], ref)
    warm = mean_abs(out, w["out"])
    print(f"cold fused vs unfused attention (2 samples): max-abs "
          f"{float((out[:2].float() - ref.float()).abs().max()):.4f}, mean-abs {unfused:.5f}")
    print(f"cold vs warm restore of the same references and noise ({BATCH} samples): max-abs "
          f"{float((out.float() - w['out'].float()).abs().max()):.4f}, mean-abs {warm:.5f}")
    if unfused > 2e-2:
        failures.append("cold fused path disagrees with the unfused path")
    if warm > 2e-2:
        failures.append("cold restore disagrees with the warm restore")
    # the slack that decides whether an operator needs the online algorithms
    records = measure_slack(
        lambda: engine.restore_cold(images[:4], cond[:4], noise=_rows(noise, 4)),
        "cold restore, first 4 samples")
    worst = max(r[2] for r in records if r[0] == "shared_flash_bound")
    print(f"bound slack of shared_flash_bound over the cold restore's reference keys: max "
          f"{worst:.2f} log2 units over {sum(r[0] == 'shared_flash_bound' for r in records)} layers")
    profile_run(lambda: engine.restore_cold(images, cond, noise=noise), "one cold restore", card,
                shares=GN_SHARE)
    if failures:
        raise AssertionError("cold phase failed: " + "; ".join(failures))
    return dict(cond=cond, noise=noise, out=out), counts


# the profiles' share of the d=512 flash kernels (the VAE mid attention)
D512_SHARE = {"flash kernels at d=512": ("flash_d512_kernel",)}


def online_phase(card: str, w, cold):
    """The online-max path at full width: the cold phase's batch-16
    restore_cold under INSTANTRESTORE_ATTN_ALGO=kv_outer and
    INSTANTRESTORE_FLASH_ALGO=online, then a profile of one batch-16 warm
    restore under INSTANTRESTORE_FLASH_ALGO=online; returns the cold
    restores' launch counts."""
    import torch


    engine, images = w["engine"], w["images"]
    with algo_env(attn="kv_outer", flash="online"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        lat_s, out = [], None
        for _ in range(RESTORE_RUNS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = engine.restore_cold(images, cold["cond"], noise=cold["noise"])
            torch.cuda.synchronize()
            lat_s.append(time.perf_counter() - t0)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        profile_run(lambda: engine.restore_cold(images, cold["cond"], noise=cold["noise"]),
                    "one cold restore under kv_outer + online", card, shares=D512_SHARE)
    with algo_env(flash="online"):  # the identity cache takes no algorithm
        profile_run(lambda: engine.restore(images, w["ids"], noise=w["noise"]),
                    "one warm restore under FLASH_ALGO=online", card, shares=D512_SHARE)
    failures = []
    check_launches(failures, f"{RESTORE_RUNS + 1} cold restores under kv_outer + online", counts,
                   RESTORE_RUNS + 1, shared_online=9, flash_attention_online=26,
                   group_norm=GN_COLD)
    if tuple(out.shape) != (BATCH, RES, RES, 3):
        failures.append(f"online cold output shape {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        failures.append("non-finite online cold output")
    steady = statistics.median(lat_s[1:])
    print(f"cold restore under kv_outer + online, batch {BATCH} x {N_REFS} refs: first "
          f"{lat_s[0] * 1e3:.1f} ms, steady median {steady * 1e3:.1f} ms over {RESTORE_RUNS} runs "
          f"{[round(x * 1e3, 1) for x in lat_s[1:]]} [{card}]")
    print(f"online cold faces/sec: {BATCH / steady:.2f} (batch {BATCH}, {N_REFS} refs, 512 px, "
          f"bf16) [{card}]")
    print(f"online cold peak device memory: {peak:.2f} GiB")
    diff = mean_abs(out, cold["out"])
    print(f"kv_outer + online vs the default algorithms, cold restore ({BATCH} samples): max-abs "
          f"{float((out.float() - cold['out'].float()).abs().max()):.4f}, mean-abs {diff:.5f}")
    if diff > 2e-2:
        failures.append("the online algorithms disagree with the default ones")
    if failures:
        raise AssertionError("online phase failed: " + "; ".join(failures))
    return counts


def other_paths(card: str, w, cold):
    """The train_input engine, multistep, the paired algorithm and the
    Predictor at reduced batch; returns their summed launch counts."""
    import dataclasses

    import torch

    from instantrestore_tpu_torch.inference.predictor import Predictor
    from instantrestore_tpu_torch.inference.serving import ServingEngine
    from instantrestore_tpu_torch.models.restorer import restore_forward_multistep
    from instantrestore_tpu_torch.ops.image_ops import preprocess

    engine, images, refs = w["engine"], w["images"], w["refs"]
    dev = engine.device
    failures, total = [], {}

    def finite(what, out, shape):
        if tuple(out.shape) != shape or not torch.isfinite(torch.as_tensor(out)).all():
            failures.append(f"{what}: output of shape {tuple(out.shape)}, or not finite")

    # 1. a train_input model served warm: gather + the input segment
    statics = dataclasses.replace(engine.statics, train_input=True)
    ti = ServingEngine(engine.params, statics, device=dev)
    reset_counts()
    ti.onboard(refs[:4], generator=torch.Generator(device=dev).manual_seed(4))
    noise4 = {k: v[:4] for k, v in w["noise"].items()}
    out = ti.restore(images[:4], torch.arange(4), noise=noise4)
    counts = launch_counts()
    check_launches(failures, "train_input engine: onboard 4 + restore batch 4", counts, 1,
                   flash_attention_bound=17 * 4 + 9, shared_flash_bound=9,
                   group_norm=4 * GN_CAPTURE + GN_WARM)
    add_counts(total, counts)
    finite("train_input restore", out, (4, RES, RES, 3))
    ti.use_fused_attention = False
    ref = ti.restore(images[:2], torch.arange(2), noise={k: v[:2] for k, v in noise4.items()})
    diff = mean_abs(out[:2], ref)
    print(f"train_input restore, fused vs unfused (2 samples): mean-abs {diff:.5f}")
    if diff > 2e-2:
        failures.append("train_input fused path disagrees with the unfused path")
    ti.use_fused_attention = True
    ti_out = out

    # 2. multistep: one capture, three DDIM steps over the same references
    pre = preprocess(images[:4].to(dev).float() / 255.0, RES)
    conds = preprocess(cold["cond"][:4].to(dev).reshape(4 * N_REFS, RES, RES, 3).float() / 255.0,
                       RES).reshape(4, N_REFS, RES, RES, 3)
    reset_counts()
    with torch.no_grad():
        out = restore_forward_multistep(engine.params, pre, conds, statics=engine.statics,
                                        timesteps=(749, 499, 249),
                                        generator=torch.Generator(device=dev).manual_seed(5),
                                        use_fused_attention=True)["output_image"]
    counts = launch_counts()
    check_launches(failures, "multistep (749, 499, 249), batch 4", counts, 1,
                   shared_flash_bound=27, flash_attention_bound=17 + 1 + 3 * 7 + 1,
                   group_norm=GN_CAPTURE + GN_ENC + 3 * GN_UNET_PASS + GN_DEC)
    add_counts(total, counts)
    finite("multistep", out, (4, RES, RES, 3))

    # 3. the per-call paired algorithm (row 1b) on a cold restore
    def under(what, run, ref, attn=None, flash=None, **per_run):
        """``run()`` under the given algorithms: its launch counts, and its
        agreement with the default algorithms' output ``ref``."""
        with algo_env(attn=attn, flash=flash):
            reset_counts()
            out = run()
            counts = launch_counts()
        check_launches(failures, what, counts, 1, **per_run)
        add_counts(total, counts)
        diff = mean_abs(out, ref)
        print(f"{what} vs the default algorithms: mean-abs {diff:.5f}")
        if not torch.isfinite(out).all() or diff > 2e-2:
            failures.append(f"{what} disagrees with the default algorithms")

    cold2 = lambda: engine.restore_cold(images[:2], cold["cond"][:2], noise=_rows(cold["noise"], 2))
    under("cold restore batch 2, kv_outer_bound_paired", cold2, cold["out"][:2],
          attn="kv_outer_bound_paired", shared_identity_attention=9, flash_attention_bound=26,
          group_norm=GN_COLD)

    # 3b. the online-max family at reduced batch: a warm restore under
    # FLASH_ALGO=online (the identity cache takes no algorithm), the
    # train_input engine under kv_outer (the online kernel with its input
    # segment), cold restores under q_outer and kv_outer_packed (the H = 5
    # layers fall through to shared_online)
    under("warm restore batch 4, FLASH_ALGO=online",
          lambda: engine.restore(images[:4], w["ids"][:4], noise=noise4), w["out"][:4],
          attn="kv_outer", flash="online", shared_identity_attention=9, flash_attention_online=9,
          group_norm=GN_WARM)
    under("train_input restore batch 4, kv_outer",
          lambda: ti.restore(images[:4], torch.arange(4), noise=noise4), ti_out,
          attn="kv_outer", shared_online=9, flash_attention_bound=9, group_norm=GN_WARM)
    del ti
    under("cold restore batch 2, q_outer", cold2, cold["out"][:2], attn="q_outer",
          shared_online=9, flash_attention_bound=26, group_norm=GN_COLD)
    under("cold restore batch 2, kv_outer_packed", cold2, cold["out"][:2], attn="kv_outer_packed",
          shared_online_pair=6, shared_online=3, flash_attention_bound=26, group_norm=GN_COLD)

    # 4. the Predictor, array in and out
    pred = Predictor(params=engine.params, statics=engine.statics, device=dev, seed=6)
    reset_counts()
    arr = pred.predict_batch(pre[:2], conds[:2])
    counts = launch_counts()
    check_launches(failures, "Predictor.predict_batch, batch 2", counts, 1,
                   shared_flash_bound=9, flash_attention_bound=26, group_norm=GN_COLD)
    add_counts(total, counts)
    finite("Predictor.predict_batch", arr, (2, RES, RES, 3))
    if failures:
        raise AssertionError("other paths failed: " + "; ".join(failures))
    return total


# bench.py's quality gates of int8 serving against the bf16 engine's images
INT8_PSNR_DB, INT8_MS_SSIM, INT8_MAX_ABS = 30.0, 0.98, 0.5
INT8_MARGIN = 1.05  # calibrate_int8's default clipping headroom
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate


def int8_convs(tree) -> list:
    """The int8 conv dicts of a param tree, in tree-walk order."""
    from instantrestore_tpu_torch.ops.primitives import _map_int8_convs

    convs = []
    _map_int8_convs(tree, lambda p: convs.append(p) or p)
    return convs


def _synced(fn):
    """fn() between two synchronisations: (result, seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def int8_gates(out, ref) -> dict:
    """bench.py's three numbers of an int8 output against the bf16 one:
    PSNR (peak-to-peak 2), MS-SSIM on [0, 1] and max-abs."""
    import math

    from instantrestore_tpu_torch.training.losses.ssim import ms_ssim

    o, r = out.float(), ref.float()
    mse = float((o - r).square().mean())
    return {"psnr_db": 10 * math.log10(4.0 / max(mse, 1e-12)),
            "ms_ssim": float(ms_ssim((o + 1) / 2, (r + 1) / 2, data_range=1.0)),
            "max_abs": float((o - r).abs().max())}


def int8_conv_table(card: str, run):
    """Each distinct int8 conv of one ``run()`` (a warm restore): its count,
    the int8 route's ms (``ops/primitives.py``: quantize, im2col columns,
    ``torch._int_mm``, dequantize), the cuDNN bf16 conv's ms on the same
    shape (the upsamplers: nearest-2x then the 3x3 conv, the bf16 engine's
    route; timed here only) and the bound: int8 operations at 1,979 TOPS or
    the bf16 input and output bytes (and the int8 weight) at 3.35 TB/s.
    Returns the summed ms of both routes a restore."""
    import torch
    import torch.nn.functional as F

    from instantrestore_tpu_torch.ops import primitives as prims

    seen = {}
    orig_conv, orig_up = prims.conv2d_int8, prims.upsample2x_conv_int8

    def rec_conv(p, x, *, stride=1, padding=1):
        key = ("conv", tuple(x.shape), tuple(p["weight_int8"].shape), stride, padding)
        seen.setdefault(key, [p, 0])[1] += 1
        return orig_conv(p, x, stride=stride, padding=padding)

    def rec_up(p, x):
        key = ("up", tuple(x.shape), tuple(p["weight_int8"].shape), 1, 1)
        seen.setdefault(key, [p, 0])[1] += 1
        return orig_up(p, x)

    prims.conv2d_int8, prims.upsample2x_conv_int8 = rec_conv, rec_up
    try:
        run()
    finally:
        prims.conv2d_int8, prims.upsample2x_conv_int8 = orig_conv, orig_up
    gen = torch.Generator(device="cuda").manual_seed(7)
    tot8 = totb = 0.0
    print(f"int8 conv route against cuDNN bf16, per distinct shape of one warm restore "
          f"({len(seen)} shapes, {sum(c for _, c in seen.values())} calls) [{card}]:")
    for (kind, xs, ws, stride, pad), (p, count) in sorted(seen.items(), key=lambda kv: -kv[0][1][1]):
        b, h, w, cin = xs
        x = torch.randn(xs, generator=gen, device="cuda").to(torch.bfloat16)
        if kind == "up":
            cout = ws[1]
            k4 = prims.folded_kernel(p["weight_int8"])  # [4, 4, Cin, Cout]
            w3 = torch.randn((cout, cin, 3, 3), generator=gen, device="cuda").to(torch.bfloat16)
            ho, wo, kk, taps = 2 * h, 2 * w, 4 * cin, 16
            t8 = cuda_ms(lambda: orig_up(p, x), 3)
            tb = cuda_ms(lambda: F.conv2d(F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                                                        mode="nearest"),
                                          w3.contiguous(memory_format=torch.channels_last),
                                          None, 1, 1), 3)
            nweights = k4.numel()
        else:
            cout, kh = ws[0], ws[1]
            ho, wo = (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kh) // stride + 1
            kk, taps = kh * kh * cin, kh * kh
            wb = torch.randn((cout, cin, kh, kh), generator=gen, device="cuda").to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            t8 = cuda_ms(lambda: orig_conv(p, x, stride=stride, padding=pad), 3)
            tb = cuda_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), wb, None, stride, pad), 3)
            nweights = p["weight_int8"].numel()
        ops = 2.0 * b * ho * wo * kk * cout
        nbytes = 2.0 * (x.numel() + b * ho * wo * cout) + nweights
        t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        b_ms, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        tot8 += count * t8
        totb += count * tb
        print(f"  {kind:4s} x{list(xs)} -> [{b}, {ho}, {wo}, {cout}] k{taps} s{stride} x{count}: "
              f"int8 {t8:.3f} ms, cuDNN bf16 {tb:.3f} ms ({t8 / tb:.2f}x), bound {b_ms:.4f} ms "
              f"({by})")
    print(f"int8 convs of one warm restore: int8 route {tot8:.1f} ms, cuDNN bf16 on the same "
          f"shapes {totb:.1f} ms [{card}]")
    return tot8, totb


def int8_phase(card: str):
    """int8 serving at full width: the warm phase's seeded bundle served by a
    bf16 engine and by ServingEngine(int8_decoder=True, int8_unet=True),
    16 identities onboarded in each (the capture nets stay bf16: the caches
    must be bit-equal); warm batch-16 restores with dynamic scales, then
    calibrate_int8 on another batch at margin 1.05, then calibrated warm
    restores, each against the bf16 engine's images on the same inputs and
    noise under bench.py's gates (PSNR >= 30 dB, MS-SSIM >= 0.98, max-abs <=
    0.5: the calibrated run must pass), with faces/sec, device busy and peak
    memory of each, the table of the int8 conv shapes, and one cold int8
    restore. Returns the launch counts of its paths."""
    import torch

    from instantrestore_tpu_torch.inference.serving import ServingEngine
    from instantrestore_tpu_torch.models.restorer import (
        RestorerStatics,
        init_restorer_params,
        serving_bundle,
    )

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    statics = RestorerStatics(use_adain=True, train_input=False)
    bundle = serving_bundle(init_restorer_params(
        torch.Generator(device=dev).manual_seed(0), statics, lora_rank_unet=32,
        lora_rank_vae=32, device=dev), statics)
    (fp, q), t_build = _synced(lambda: (ServingEngine(bundle, statics, device=dev),
                                        ServingEngine(bundle, statics, device=dev,
                                                      int8_decoder=True, int8_unet=True)))
    del bundle
    torch.cuda.empty_cache()
    print(f"bf16 and int8 engines built (the int8 one quantized from the fp32 bundle): "
          f"{t_build:.2f} s")
    host = torch.Generator().manual_seed(1)  # the warm phase's inputs
    refs = torch.randint(0, 256, (N_IDENT, N_REFS, RES, RES, 3), dtype=torch.uint8, generator=host)
    images = torch.randint(0, 256, (BATCH, RES, RES, 3), dtype=torch.uint8, generator=host)
    ids = torch.tensor([3, 7, 7, 0, 15, 2, 3, 9, 12, 7, 1, 0, 5, 15, 8, 3])
    lat = RES // 8
    noise = {k: torch.randn((BATCH, lat, lat, 4), generator=host).to(dev)
             for k in ("latent", "diffusion")}
    onboard_noise = {k: torch.randn((N_IDENT, N_REFS, lat, lat, 4), generator=host).to(dev)
                     for k in ("latent", "diffusion")}
    cal_images = torch.randint(0, 256, (BATCH, RES, RES, 3), dtype=torch.uint8, generator=host)
    cal_ids = torch.arange(BATCH) % N_IDENT
    cal_noise = {k: torch.randn((BATCH, lat, lat, 4), generator=host).to(dev)
                 for k in ("latent", "diffusion")}
    failures, total = [], {}

    reset_counts()
    for eng in (fp, q):
        eng.onboard(refs, noise=onboard_noise)
    check_launches(failures, f"onboarding {N_IDENT} identities in the bf16 and int8 engines",
                   launch_counts(), 2 * N_IDENT, flash_attention_bound=17,
                   group_norm=GN_CAPTURE)
    add_counts(total, launch_counts())
    same = all(torch.equal(getattr(a, f), getattr(b, f)) for a, b in zip(fp.kv_cache, q.kv_cache)
               for f in ("rk", "rv", "content_mean", "content_std", "kmax"))
    print(f"int8 engine's identity cache {'bit-equal to' if same else 'DIFFERS from'} the bf16 "
          f"engine's (the capture networks are not quantized)")
    if not same:
        failures.append("the int8 engine's identity cache differs from the bf16 engine's")

    def timed(eng, what):
        """RESTORE_RUNS + 1 warm restores (the first sets up): the output,
        the steady median seconds, peak memory and launches."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        runs = [_synced(lambda: eng.restore(images, ids, noise=noise))
                for _ in range(RESTORE_RUNS + 1)]
        counts = launch_counts()
        check_launches(failures, f"{RESTORE_RUNS + 1} {what} warm restores", counts,
                       RESTORE_RUNS + 1, shared_identity_attention=9, flash_attention_bound=9,
                       group_norm=GN_WARM)
        add_counts(total, counts)
        steady = statistics.median(s for _, s in runs[1:])
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{what} warm restore batch {BATCH}: first {runs[0][1] * 1e3:.1f} ms, steady median "
              f"{steady * 1e3:.1f} ms over {RESTORE_RUNS} runs "
              f"{[round(s * 1e3, 1) for _, s in runs[1:]]}; {BATCH / steady:.2f} faces/sec; "
              f"peak device memory {peak:.2f} GiB [{card}]")
        return runs[-1][0], steady, peak

    ref, t_fp, _ = timed(fp, "bf16")
    busy_fp = profile_run(lambda: fp.restore(images, ids, noise=noise), "one bf16 warm restore",
                          card, top=8)
    out_dyn, t_dyn, _ = timed(q, "int8 (dynamic scales)")
    g = int8_gates(out_dyn, ref)
    print(f"int8 dynamic against bf16: PSNR {g['psnr_db']:.2f} dB, MS-SSIM {g['ms_ssim']:.4f}, "
          f"max-abs {g['max_abs']:.4f} (bench.py's gates apply to the calibrated engine)")
    busy_dyn = profile_run(lambda: q.restore(images, ids, noise=noise),
                           "one int8 warm restore, dynamic scales", card, top=8)
    tot8, totb = int8_conv_table(card, lambda: q.restore(images, ids, noise=noise))

    n_cal, t_cal = _synced(lambda: q.calibrate_int8([(cal_images, cal_ids, cal_noise)],
                                                    margin=INT8_MARGIN))
    print(f"calibrate_int8: {n_cal} convs given static scales from one batch of {BATCH} "
          f"(margin {INT8_MARGIN}) in {t_cal:.2f} s")
    convs = int8_convs(q.params)
    if n_cal != len(convs) or not all("a_scale" in p for p in convs):
        failures.append(f"calibrate_int8 gave {n_cal} of the {len(convs)} int8 convs a scale")
    out_cal, t_cal_run, peak_cal = timed(q, "int8 (calibrated)")
    gc = int8_gates(out_cal, ref)
    print(f"int8 calibrated against bf16: PSNR {gc['psnr_db']:.2f} dB (gate >= {INT8_PSNR_DB}), "
          f"MS-SSIM {gc['ms_ssim']:.4f} (>= {INT8_MS_SSIM}), max-abs {gc['max_abs']:.4f} "
          f"(<= {INT8_MAX_ABS}) [{card}]")
    if (gc["psnr_db"] < INT8_PSNR_DB or gc["ms_ssim"] < INT8_MS_SSIM
            or gc["max_abs"] > INT8_MAX_ABS or not torch.isfinite(out_cal).all()):
        failures.append(f"int8 calibrated output misses bench.py's gates: {gc}")
    busy_cal = profile_run(lambda: q.restore(images, ids, noise=noise),
                           "one int8 warm restore, calibrated scales", card, top=8)
    print(f"int8 serving summary (batch {BATCH}, 512 px, {N_REFS} refs, warm): faces/sec bf16 "
          f"{BATCH / t_fp:.2f}, int8 dynamic {BATCH / t_dyn:.2f}, int8 calibrated "
          f"{BATCH / t_cal_run:.2f}; device busy ms {busy_fp} / {busy_dyn} / {busy_cal}; int8 "
          f"convs {tot8:.1f} ms against cuDNN bf16 {totb:.1f} ms a restore; peak "
          f"{peak_cal:.2f} GiB [{card}]")

    # one cold int8 restore: the bf16 capture networks, the int8 restore nets
    dev_ids = ids.to(dev)
    cold_noise = dict(noise)
    for k, v in onboard_noise.items():
        cold_noise[f"cond_{k}"] = v[dev_ids].reshape(BATCH * N_REFS, lat, lat, 4)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    cold, t_cold = _synced(lambda: q.restore_cold(images, refs[ids], noise=cold_noise))
    counts = launch_counts()
    check_launches(failures, "one int8 cold restore", counts, 1, shared_flash_bound=9,
                   flash_attention_bound=26, group_norm=GN_COLD)
    add_counts(total, counts)
    d_warm = mean_abs(cold, out_cal)
    print(f"int8 cold restore batch {BATCH}: {t_cold * 1e3:.1f} ms (first call), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; mean-abs {d_warm:.5f} against "
          f"the int8 warm restore of the same references and noise [{card}]")
    if not torch.isfinite(cold).all() or tuple(cold.shape) != (BATCH, RES, RES, 3):
        failures.append("int8 cold restore not finite or of the wrong shape")
    print(f"int8 phase: {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("int8 phase failed: " + "; ".join(failures))
    return total

def replace_identity(w):
    """Replacing one identity's refs changes exactly its samples."""
    import torch

    engine, ids, images, out = w["engine"], w["ids"], w["images"], w["out"]
    slot = int(ids[0])
    new_refs = torch.randint(0, 256, (N_REFS, RES, RES, 3), dtype=torch.uint8, generator=w["host"])
    engine.onboard_one(new_refs, slot, generator=torch.Generator(device=engine.device).manual_seed(3))
    out2 = engine.restore(images, ids, noise=w["noise"])
    per_sample = (out2.float() - out.float()).abs().flatten(1).amax(dim=1).cpu()
    hit = ids == slot
    print(f"identity {slot} replaced: max-abs change on its samples "
          f"{per_sample[hit].tolist()}, on the others {float(per_sample[~hit].max()):.2e}")
    if float(per_sample[hit].min()) < 1e-2 or float(per_sample[~hit].max()) > 1e-3:
        raise AssertionError("replacing an identity did not change exactly its outputs")


def _tree_leaves(tree, prefix=""):
    """(dotted path, tensor) of every leaf of a param tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaves(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN held to its deterministic algorithms for the block (its default
    backward-filter algorithms may sum in an order that changes per call)."""
    import torch

    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


# fused against unfused attention in one bf16 train step: the loss, and each
# leaf group's gradient by relative RMS error
TRAIN_LOSS_REL_TOL = 1e-3
TRAIN_GRAD_REL_TOL = 0.1


def _grad_group(name: str) -> str:
    """A trainable leaf's group: its subtree's LoRA leaves, a UNet's conv_in,
    the VAE's skip convs."""
    parts = name.split(".")
    if parts[-1] in ("lora_A", "lora_B"):
        return f"{parts[0]} LoRA"
    if parts[1] == "conv_in" and parts[0] in ("unet", "original_unet"):
        return f"{parts[0]} conv_in"
    return f"{parts[0]} skip convs" if parts[-2].startswith("skip_conv_") else f"{parts[0]} LoRA"


def grad_rel_rms_by_group(names, got, ref) -> dict:
    """Relative RMS of the gradients ``got`` against ``ref`` (leaf names
    ``names``) by leaf group (``_grad_group``)."""
    groups = {}
    for name, a, r in zip(names, got, ref):
        key = _grad_group(name)
        num, den = groups.get(key, (0.0, 0.0))
        groups[key] = (num + float((a - r).square().sum()), den + float(r.square().sum()))
    return {k: (num / den) ** 0.5 for k, (num, den) in groups.items()}


def training_phase(card: str):
    """The generator training step at full width: batch 2, 4 references,
    512 px, bf16 compute over fp32 params, LoRA rank 32 unmerged, L2 + LPIPS,
    AdamW with global-norm clipping on the LoRA leaves and unet.conv_in,
    fused attention with its kernel backward, remat. Returns its launch
    counts over the timed steps."""
    import torch

    from instantrestore_tpu_torch.configs.config import OptimConfig, SchedulerType
    from instantrestore_tpu_torch.convert import tree_to
    from instantrestore_tpu_torch.models.lora import count_lora_params, trainable_mask
    from instantrestore_tpu_torch.models.restorer import RestorerStatics, init_restorer_params
    from instantrestore_tpu_torch.training.losses.composite import compute_generator_loss
    from instantrestore_tpu_torch.training.losses.lpips import init_lpips_params
    from instantrestore_tpu_torch.training.optim import make_optimizer, trainable_leaves
    from instantrestore_tpu_torch.training.train_step import make_train_step

    dev = torch.device("cuda")
    statics = RestorerStatics(use_adain=True, train_input=False)  # full SD-Turbo widths, bf16
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tree_to(init_restorer_params(gen, statics, lora_rank_unet=32, lora_rank_vae=32,
                                          device=dev), dev)
    lpips_params = tree_to(init_lpips_params(gen, device=dev), dev)
    mask = {
        "unet": trainable_mask(params["unet"], extra_trainable=("conv_in",)),
        "unet_orig_conv_in": trainable_mask(params["unet_orig_conv_in"]),
        "vae": trainable_mask(params["vae"]),
        "caption_enc": False,
    }
    leaves = trainable_leaves(params, mask)
    trainable_ids = {id(t) for t in leaves}
    n_train = sum(t.numel() for t in leaves)
    print(f"training params: {sum(t.numel() for _, t in _tree_leaves(params)) / 1e6:.1f} M leaves' "
          f"elements, {n_train / 1e6:.2f} M trainable in {len(leaves)} leaves "
          f"({(count_lora_params(params['unet']) + count_lora_params(params['vae'])) / 1e6:.2f} M LoRA)")
    start = {name: t.clone() for name, t in _tree_leaves(params)}

    host = torch.Generator().manual_seed(3)

    def images(*shape):
        return torch.rand(shape, generator=host) * 2.0 - 1.0

    bsz, lat = TRAIN_BATCH, RES // 8
    batch = {"image": images(bsz, RES, RES, 3), "gt": images(bsz, RES, RES, 3),
             "conditioning_images": images(bsz, N_REFS, RES, RES, 3),
             "valid_indices": torch.full((bsz,), N_REFS),
             "pos_reg_idx": torch.zeros(bsz, dtype=torch.long),
             "neg_reg_idx": torch.ones(bsz, dtype=torch.long)}
    batch = {k: v.to(dev) for k, v in batch.items()}
    noise = {k: torch.randn((n, lat, lat, 4), generator=host).to(dev)
             for k, n in (("latent", bsz), ("diffusion", bsz), ("cond_latent", bsz * N_REFS),
                          ("cond_diffusion", bsz * N_REFS))}

    def stepper(cfg, **kw):
        loss_fn = lambda out, b, c: compute_generator_loss(
            out, b, c, lpips_params=lpips_params, train_input=statics.train_input, generator=gen)
        return make_train_step(statics, cfg, make_optimizer(cfg, 1000, mask), mask, loss_fn,
                               use_fused_attention=kw.pop("fused", True),
                               remat=kw.pop("remat", True), device=dev, **kw)

    def timed(step, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics, _ = step(params, batch, **kw)
        torch.cuda.synchronize()
        return metrics, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30

    failures = []

    # ---- main path: a warm-up step, then the timed steps ----
    ocfg = OptimConfig(lambda_l2=1.0, lambda_lpips=1.0)
    step = stepper(ocfg)
    metrics, first_s, _ = timed(step, generator=gen)
    reset_counts()
    step_s, peaks, losses = [], [], []
    for _ in range(TRAIN_STEPS):
        metrics, dt, peak = timed(step, generator=gen)
        step_s.append(dt)
        peaks.append(peak)
        losses.append(float(metrics["loss"]))
    counts = launch_counts()
    # per step: 9 shared + 7 down/mid + 2 VAE attentions with a gradient, their
    # forward run a second time when remat rebuilds the stages in the backward;
    # the frozen capture (16 UNet self-attentions at batch 8 and a VAE encode)
    # wants no gradient, runs the bound kernel once and no backward kernel
    check_launches(failures, f"{TRAIN_STEPS} train steps", counts, TRAIN_STEPS,
                   flash_fwd_lse=2 * 18, flash_bwd_dq=18, flash_bwd_dkv=18,
                   flash_attention_bound=17, group_norm=GN_CAPTURE)
    grads_finite = all(bool(torch.isfinite(t.grad).all()) for t in leaves)
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)) or not grads_finite:
        failures.append(f"non-finite loss {losses} or gradient")
    steady = statistics.median(step_s)
    print(f"train step batch {bsz} x {N_REFS} refs, 512 px, bf16, fused attention, remat: first "
          f"{first_s * 1e3:.1f} ms, steady median {steady * 1e3:.1f} ms over {TRAIN_STEPS} steps "
          f"{[round(x * 1e3, 1) for x in step_s]} [{card}]")
    print(f"train faces/sec: {bsz / steady:.2f} (batch {bsz}, {N_REFS} refs, 512 px, L2 + LPIPS, "
          f"AdamW on {n_train / 1e6:.2f} M params) [{card}]")
    print(f"train peak device memory, remat=True: {max(peaks):.2f} GiB; losses {losses}; "
          f"grad norm {float(metrics['grad_norm']):.4f}")

    # only the trainable leaves moved, and every one of them under a non-zero rate
    moved = {name for name, t in _tree_leaves(params) if not torch.equal(t, start[name])}
    wanted = {name for name, t in _tree_leaves(params) if id(t) in trainable_ids}
    print(f"leaves changed after {TRAIN_STEPS + 1} steps: {len(moved)} of {len(start)}; "
          f"trainable {len(wanted)}")
    if moved - wanted:
        failures.append(f"frozen leaves changed: {sorted(moved - wanted)[:5]}")
    if len(moved) < 0.9 * len(wanted):
        failures.append(f"only {len(moved)} of {len(wanted)} trainable leaves changed")
    del start

    # ---- the same step again and again from one state: a rate of 0 ----
    still = OptimConfig(lambda_l2=1.0, lambda_lpips=1.0, learning_rate=0.0,
                        scheduler_type=SchedulerType.CONSTANT)
    fixed = dict(noise=noise, timestep=499)

    def grads_of(step_fn):
        metrics, dt, peak = timed(step_fn, **fixed)
        return float(metrics["loss"]), [t.grad for t in leaves], dt, peak

    with deterministic_cudnn():
        loss_a, g_a, _, _ = grads_of(stepper(still))
        loss_b, g_b, _, _ = grads_of(stepper(still))
        same = loss_a == loss_b and all(torch.equal(a, b) for a, b in zip(g_a, g_b))
        print(f"two runs of one step from one state: loss {loss_a} and {loss_b}, gradients "
              f"{'identical' if same else 'DIFFER'}")
        if not same:
            failures.append("two runs of the same step gave different gradients")
        del g_b

        try:
            loss_n, g_n, dt_n, peak_n = grads_of(stepper(still, remat=False))
        except torch.cuda.OutOfMemoryError:
            print(f"remat=False does not fit the card at batch {bsz} [{card}]")
        else:
            same = loss_n == loss_a and all(torch.equal(a, b) for a, b in zip(g_a, g_n))
            print(f"remat=False: {dt_n * 1e3:.1f} ms, peak device memory {peak_n:.2f} GiB; "
                  f"loss and gradients {'identical to' if same else 'DIFFER from'} remat=True "
                  f"[{card}]")
            if not same:
                failures.append("remat=True and remat=False disagree")
            del g_n
        torch.cuda.empty_cache()

        loss_u, g_u, dt_u, peak_u = grads_of(stepper(still, fused=False))
    names = [n for n, t in _tree_leaves(params) if id(t) in trainable_ids]
    rels = grad_rel_rms_by_group(names, g_a, g_u)
    loss_rel = abs(loss_a - loss_u) / abs(loss_u)
    print(f"fused vs unfused train step (same noise, timestep 499): loss {loss_a:.6f} vs "
          f"{loss_u:.6f} (relative {loss_rel:.2e}, tol {TRAIN_LOSS_REL_TOL}); gradient relative "
          f"RMS error by group {({k: round(v, 4) for k, v in rels.items()})} (tol "
          f"{TRAIN_GRAD_REL_TOL}); unfused step {dt_u * 1e3:.1f} ms, peak {peak_u:.2f} GiB [{card}]")
    if loss_rel > TRAIN_LOSS_REL_TOL or max(rels.values()) > TRAIN_GRAD_REL_TOL:
        failures.append("the fused train step disagrees with the unfused one")
    del g_a, g_u
    torch.cuda.empty_cache()

    # ---- the attention regularisers on streamed segment sums ----
    reg_cfg = OptimConfig(lambda_l2=1.0, lambda_lpips=1.0, lambda_attn_reg=0.01,
                          lambda_pos_reg=0.1, lambda_neg_reg=0.1, learning_rate=0.0,
                          scheduler_type=SchedulerType.CONSTANT)
    metrics, dt, peak = timed(stepper(reg_cfg, save_seg_sums=True), generator=gen)
    terms = {k: round(float(v), 5) for k, v in metrics.items()}
    print(f"train step with save_seg_sums and the attention regularisers: {dt * 1e3:.1f} ms, "
          f"peak {peak:.2f} GiB, {terms} [{card}]")
    missing = {"loss_attn_reg", "loss_attn_pos_reg", "loss_attn_neg_reg"} - set(terms)
    if missing or not all(v == v and abs(v) != float("inf") for v in terms.values()):
        failures.append(f"segment-sum step: missing terms {sorted(missing)} or non-finite {terms}")

    profile_run(lambda: step(params, batch, generator=gen), "one train step", card,
                shares={"rows 4-6 (flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv)":
                        ("(irt::Mode)1", "(irt::wg::Policy)0", "bwd_dq_kernel",
                         "bwd_dkv_kernel", "bwd_d512_kernel"),
                        "rows 5-6 (flash_bwd_dq, flash_bwd_dkv)":
                        ("bwd_dq_kernel", "bwd_dkv_kernel", "bwd_d512_kernel")})
    if failures:
        raise AssertionError("training phase failed: " + "; ".join(failures))
    return counts


# the options phase: the VAE's skip convs and LoRA on the capture networks in
# one G step, and FaceID conditioning in a cold restore and the Predictor
OPTIONS_STEPS = 2
FACEID_EMBEDS = 4  # face embeddings a sample: one per reference


def options_phase(card: str):
    """The three model options at full width. A G step with use_shortcuts
    and train_reference_networks (the training phase's batch, L2 + LPIPS,
    remat, the Coach's mask: the capture nets' LoRA and conv_in, the skip
    convs): launches per step, the capture LoRA's gradients finite and
    nonzero, fused against unfused, peak memory. Then a FaceID model: a
    batch-16 restore_forward(face_embeds=) and a 512 px Predictor restore
    with embeddings from a stub provider. Returns the launch counts."""
    import torch

    from instantrestore_tpu_torch.configs.config import OptimConfig, SchedulerType
    from instantrestore_tpu_torch.convert import tree_to
    from instantrestore_tpu_torch.inference.predictor import Predictor
    from instantrestore_tpu_torch.models.lora import trainable_mask
    from instantrestore_tpu_torch.models.restorer import (
        RestorerStatics,
        init_restorer_params,
        restore_forward,
        serving_bundle,
    )
    from instantrestore_tpu_torch.training.losses.composite import compute_generator_loss
    from instantrestore_tpu_torch.training.losses.lpips import init_lpips_params
    from instantrestore_tpu_torch.training.optim import make_optimizer, trainable_leaves
    from instantrestore_tpu_torch.training.train_step import make_train_step

    dev = torch.device("cuda")
    failures, total = [], {}
    t_phase = time.perf_counter()
    statics = RestorerStatics(use_adain=True, train_input=False, use_shortcuts=True,
                              train_reference_networks=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tree_to(init_restorer_params(gen, statics, lora_rank_unet=32, lora_rank_vae=32,
                                          device=dev), dev)
    lpips_params = tree_to(init_lpips_params(gen, device=dev), dev)
    skips = ("skip_conv_1", "skip_conv_2", "skip_conv_3", "skip_conv_4")
    mask = {  # the Coach's g_mask with both options
        "unet": trainable_mask(params["unet"], extra_trainable=("conv_in",)),
        "unet_orig_conv_in": trainable_mask(params["unet_orig_conv_in"]),
        "vae": trainable_mask(params["vae"], extra_trainable=skips),
        "caption_enc": False,
        "original_unet": trainable_mask(params["original_unet"], extra_trainable=("conv_in",)),
        "original_vae": trainable_mask(params["original_vae"]),
    }
    leaves = trainable_leaves(params, mask)
    trainable_ids = {id(t) for t in leaves}
    names = [n for n, t in _tree_leaves(params) if id(t) in trainable_ids]
    capture = [i for i, n in enumerate(names) if n.startswith("original_")]
    print(f"options step params: {sum(t.numel() for t in leaves) / 1e6:.2f} M trainable in "
          f"{len(leaves)} leaves, of them the capture nets' {len(capture)} leaves "
          f"({sum(leaves[i].numel() for i in capture) / 1e6:.2f} M)")

    host = torch.Generator().manual_seed(5)
    bsz, lat = TRAIN_BATCH, RES // 8
    batch = {"image": torch.rand((bsz, RES, RES, 3), generator=host) * 2 - 1,
             "gt": torch.rand((bsz, RES, RES, 3), generator=host) * 2 - 1,
             "conditioning_images": torch.rand((bsz, N_REFS, RES, RES, 3), generator=host) * 2 - 1,
             "valid_indices": torch.full((bsz,), N_REFS)}
    batch = {k: v.to(dev) for k, v in batch.items()}
    noise = {k: torch.randn((n, lat, lat, 4), generator=host).to(dev)
             for k, n in (("latent", bsz), ("diffusion", bsz), ("cond_latent", bsz * N_REFS),
                          ("cond_diffusion", bsz * N_REFS))}

    def stepper(cfg, fused=True):
        loss_fn = lambda out, b, c: compute_generator_loss(  # noqa: E731
            out, b, c, lpips_params=lpips_params, train_input=statics.train_input, generator=gen)
        return make_train_step(statics, cfg, make_optimizer(cfg, 1000, mask), mask, loss_fn,
                               use_fused_attention=fused, remat=True, device=dev)

    def timed(step, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics, _ = step(params, batch, **kw)
        torch.cuda.synchronize()
        return metrics, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30

    step = stepper(OptimConfig(lambda_l2=1.0, lambda_lpips=1.0))
    timed(step, generator=gen)  # warm-up
    reset_counts()
    step_s, peaks = [], []
    for _ in range(OPTIONS_STEPS):
        metrics, dt, peak = timed(step, generator=gen)
        step_s.append(dt)
        peaks.append(peak)
    counts = launch_counts()
    add_counts(total, counts)
    # per step with remat: the training phase's 18 attentions with a
    # gradient and the capture's 17 (16 UNet self-attentions and the VAE
    # encoder's at batch 8), each forward twice; one backward fewer than
    # forwards in the capture (the last up-block self-attention's output
    # reaches no captured K/V); no inference kernel
    # the capture nets train their LoRA here, so every GroupNorm of the step
    # wants a gradient and takes the plain path: no group_norm launch
    check_launches(failures, f"{OPTIONS_STEPS} G steps with use_shortcuts and "
                   "train_reference_networks", counts, OPTIONS_STEPS,
                   flash_fwd_lse=2 * 35, flash_bwd_dq=34, flash_bwd_dkv=34)
    norms = {k: 0.0 for k in ("original_unet LoRA", "original_unet conv_in", "original_vae LoRA")}
    finite = all(bool(torch.isfinite(t.grad).all()) for t in leaves)
    for i in capture:
        norms[_grad_group(names[i])] += float(leaves[i].grad.float().square().sum())
    print(f"G step with use_shortcuts and train_reference_networks, batch {bsz} x {N_REFS} refs, "
          f"512 px, L2 + LPIPS, remat: {[round(x * 1e3, 1) for x in step_s]} ms, peak device "
          f"memory {max(peaks):.2f} GiB; loss {float(metrics['loss']):.6f}; the capture nets' "
          f"gradient norms {({k: round(v ** 0.5, 6) for k, v in norms.items()})}; all gradients "
          f"{'finite' if finite else 'NOT finite'} [{card}]")
    if not finite or not all(v > 0 for v in norms.values()):
        failures.append(f"capture gradients: finite {finite}, norms {norms}")
    profile_run(lambda: step(params, batch, generator=gen),
                "one G step with use_shortcuts and train_reference_networks", card,
                shares={"rows 4-6 (flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv)":
                        ("(irt::Mode)1", "(irt::wg::Policy)0", "bwd_dq_kernel",
                         "bwd_dkv_kernel", "bwd_d512_kernel")})

    still = OptimConfig(lambda_l2=1.0, lambda_lpips=1.0, learning_rate=0.0,
                        scheduler_type=SchedulerType.CONSTANT)
    grads = []
    for fused in (True, False):
        metrics, dt, peak = timed(stepper(still, fused), noise=noise, timestep=499)
        grads.append((float(metrics["loss"]), [t.grad for t in leaves], dt, peak))
    (loss_f, g_f, _, _), (loss_u, g_u, dt_u, peak_u) = grads
    rels = grad_rel_rms_by_group(names, g_f, g_u)
    loss_rel = abs(loss_f - loss_u) / abs(loss_u)
    print(f"fused vs unfused G step with both options (same noise, timestep 499): loss "
          f"{loss_f:.6f} vs {loss_u:.6f} (relative {loss_rel:.2e}, tol {TRAIN_LOSS_REL_TOL}); "
          f"gradient relative RMS by group {({k: round(v, 4) for k, v in rels.items()})} (tol "
          f"{TRAIN_GRAD_REL_TOL}); unfused {dt_u * 1e3:.1f} ms, peak {peak_u:.2f} GiB [{card}]")
    if loss_rel > TRAIN_LOSS_REL_TOL or max(rels.values()) > TRAIN_GRAD_REL_TOL:
        failures.append("the fused G step with both options disagrees with the unfused one")
    del params, grads, g_f, g_u, leaves, lpips_params, batch
    torch.cuda.empty_cache()

    # ---- FaceID: a batch-16 cold restore and the Predictor ----
    fstatics = RestorerStatics(use_adain=True, train_input=False, condition_on_face_embeds=True)
    bundle = tree_to(serving_bundle(init_restorer_params(
        torch.Generator(device=dev).manual_seed(1), fstatics, lora_rank_unet=32,
        lora_rank_vae=32, device=dev), fstatics), dev, torch.bfloat16)
    images = (torch.rand((BATCH, RES, RES, 3), generator=host) * 2 - 1).to(dev)
    conds = (torch.rand((BATCH, N_REFS, RES, RES, 3), generator=host) * 2 - 1).to(dev)
    embeds = torch.randn((BATCH, FACEID_EMBEDS, 512), generator=host).to(dev)
    fnoise = {k: torch.randn((n, lat, lat, 4), generator=host).to(dev)
              for k, n in (("latent", BATCH), ("diffusion", BATCH),
                           ("cond_latent", BATCH * N_REFS), ("cond_diffusion", BATCH * N_REFS))}

    def face_restore(e, fused=True, rows=slice(None)):
        with torch.no_grad():
            return restore_forward(
                bundle, images[rows], conds[rows], statics=fstatics, face_embeds=e,
                noise={k: v[rows] if not k.startswith("cond_") else
                       v.reshape(BATCH, N_REFS, lat, lat, 4)[rows].reshape(-1, lat, lat, 4)
                       for k, v in fnoise.items()},
                use_fused_attention=fused)["output_image"]

    face_restore(embeds)  # cuDNN's set-up
    reset_counts()
    out, dt = _synced_all(lambda: face_restore(embeds))
    counts = launch_counts()
    add_counts(total, counts)
    check_launches(failures, "one batch-16 FaceID restore_forward", counts, 1,
                   shared_flash_bound=9, flash_attention_bound=26, group_norm=GN_COLD)
    prompt = face_restore(None)
    other = face_restore(-embeds)
    unfused = face_restore(embeds[:2], fused=False, rows=slice(0, 2))
    d_unfused = mean_abs(out[:2], unfused)
    print(f"FaceID restore_forward batch {BATCH}, 512 px, {FACEID_EMBEDS} embeddings a sample: "
          f"{dt * 1e3:.1f} ms ({BATCH / dt:.2f} faces/sec); mean-abs to the prompt's output "
          f"{mean_abs(out, prompt):.5f}, to other embeddings' {mean_abs(out, other):.5f}; fused vs "
          f"unfused on 2 samples {d_unfused:.5f} (tol {PAR_SERVE_MEAN_ABS}) [{card}]")
    if (tuple(out.shape) != (BATCH, RES, RES, 3) or not torch.isfinite(out).all()
            or d_unfused > PAR_SERVE_MEAN_ABS or mean_abs(out, prompt) == 0
            or mean_abs(out, other) == 0):
        failures.append("the FaceID restore_forward is wrong")
    del out, prompt, other, unfused

    def stub_provider(image):
        """A face embedder stand-in: a unit vector from the image's pixels."""
        import numpy as np

        a = np.asarray(image, np.float32).reshape(-1)[:8192]
        v = np.resize(a - a.mean(), 512)
        return v / max(float(np.linalg.norm(v)), 1e-6)

    pred = Predictor(params=bundle, statics=fstatics, device=dev, seed=0, deterministic=True,
                     face_embed_provider=stub_provider)
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        to_pil = lambda x: Image.fromarray(  # noqa: E731
            ((x.float().cpu().numpy() + 1) * 127.5).clip(0, 255).astype("uint8"))
        ref_imgs = [to_pil(conds[0, i]) for i in range(N_REFS)]
        pred.predict(to_pil(images[0]), ref_imgs)  # cuDNN's set-up
        reset_counts()
        (pil, _), dt = _synced_all(lambda: pred.predict(to_pil(images[0]), ref_imgs))
        counts = launch_counts()
        e = pred.compute_face_embeds(ref_imgs)
        ok = pil.size == (RES, RES) and e.shape == (N_REFS, 512) and bool(abs(e).sum() > 0)
        what = f"Predictor.predict on PIL images, embeddings from the stub provider: {dt * 1e3:.1f} ms"
    else:
        arrays = [conds[0, i].float().cpu().numpy() for i in range(N_REFS)]
        e = pred.compute_face_embeds(arrays)
        pred.predict_batch(images[:1], conds[:1], face_embeds=torch.as_tensor(e)[None])
        reset_counts()
        out, dt = _synced_all(lambda: pred.predict_batch(images[:1], conds[:1],
                                                         face_embeds=torch.as_tensor(e)[None]))
        counts = launch_counts()
        ok = out.shape == (1, RES, RES, 3) and all_finite(out)
        what = (f"Predictor.predict_batch (Pillow does not import), embeddings from the stub "
                f"provider: {dt * 1e3:.1f} ms")
    add_counts(total, counts)
    check_launches(failures, "one FaceID Predictor restore", counts, 1,
                   shared_flash_bound=9, flash_attention_bound=26, group_norm=GN_COLD)
    print(f"{what}; output {'right' if ok else 'WRONG'} [{card}]")
    if not ok:
        failures.append("the FaceID Predictor's restore is wrong")
    del pred, bundle
    torch.cuda.empty_cache()
    print(f"options phase: {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("options phase failed: " + "; ".join(failures))
    return total


# the recipe phase: the loss networks on the card against the same port code
# on the CPU (fp32, TF32 off), and the shipped recipe's train step
RECIPE_NET_REL_RMS = 1e-4
# the fused recipe step's gradients lie no further than this factor times the
# unfused step's from the same step in fp32: the two bf16 paths' gap is then
# rounding, not a fault of the fused one
RECIPE_FP32_FACTOR = 1.5
RECIPE_STEPS = 3
RECIPE_DISC = "dinov2"  # OptimConfig's "vagan_clip" falls back to it, as in the JAX Coach
RECIPE_LANDMARK_LAYER = 0  # the every-term step's landmark layer (16 x 16 tokens at 512 px)
RECIPE_TERMS = ("loss_l2", "loss_lpips", "loss_id", "sim_id", "loss_attn_reg", "loss_cycle",
                "loss_landmark", "loss_attn_pos_reg", "loss_attn_neg_reg", "loss_facial_comp_l2",
                "loss_facial_comp_lpips", "loss_g", "fc_loss_g", "loss")


@contextlib.contextmanager
def no_tf32():
    """TF32 off in cuBLAS and cuDNN for the block (cuDNN's is on by default)."""
    import torch

    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def rel_rms(got, ref) -> float:
    """||got - ref|| / ||ref||, in fp64 on the host."""
    g, r = got.detach().double().cpu(), ref.detach().double().cpu()
    return float((g - r).norm() / r.norm().clamp_min(1e-300))


def dinov2_taps(params, x224, cfg):
    """What discriminate reads from the ViT: the patch tokens of blocks 0 and
    n/2 of the last n = 8, and the last block's class token."""
    from instantrestore_tpu_torch.models.vit import vit_intermediate_layers

    n = min(8, cfg.depth)
    inter = vit_intermediate_layers(params, x224, n=n, cfg=cfg)
    return inter[0][0], inter[n // 2][0], inter[-1][1]


def recipe_networks(card: str, nets: dict, failures: list):
    """Each network and image op the recipe adds, on the card against the same
    port code on the CPU, fp32 with TF32 off: relative RMS within
    RECIPE_NET_REL_RMS and finite."""
    import numpy as np
    import torch

    from instantrestore_tpu_torch.convert import tree_to
    from instantrestore_tpu_torch.data import mtcnn
    from instantrestore_tpu_torch.models.vit import DINOV2_VITL14
    from instantrestore_tpu_torch.ops.dct_jpeg import jpeg_compress_dct
    from instantrestore_tpu_torch.ops.image_ops import cycle_noise_shapes, degrade_with_params
    from instantrestore_tpu_torch.training.losses.id_loss import arcface_apply

    res = RES
    host = torch.Generator().manual_seed(11)
    face = torch.rand((1, res, res, 3), generator=host)
    boxes = np.array([[0, 0, res // 4, res // 4], [res // 3, res // 5, res // 3 + res // 2,
                                                   res // 5 + res // 2],
                      [res - 40, res - 60, res + 40, res + 20], [-10, res // 2, res // 6, res]],
                     np.float32)
    u8 = face[0].numpy() * 255.0
    inputs = {
        "x224": torch.randn((2, 224, 224, 3), generator=host),
        "x112": torch.rand((2, 112, 112, 3), generator=host) * 2 - 1,
        "face": torch.from_numpy(mtcnn._normalize(u8))[None],
        "c24": torch.from_numpy(mtcnn._normalize(mtcnn._crop_resize(u8, boxes, 24))),
        "c48": torch.from_numpy(mtcnn._normalize(mtcnn._crop_resize(u8, boxes, 48))),
        "img": torch.rand((2, res, res, 3), generator=host),
        "noise": [torch.randn(s, generator=host) for s in cycle_noise_shapes(2, res, res)],
        "cycle": {"blur_sigma_x": torch.tensor([0.8, 2.5]), "blur_sigma_y": torch.tensor([1.6, 0.5]),
                  "blur_rotation": torch.tensor([0.4, -1.2]),
                  "downsample_factor": torch.tensor([2, 5]),
                  "noise_sigma": torch.tensor([6.0, 14.0]), "jpeg_quality": torch.tensor([35, 70])},
    }
    cases = [
        ("DINOv2 ViT-L/14, discriminate's three taps, batch 2 at 224 px",
         lambda n, i: dinov2_taps(n["vit"], i["x224"], DINOV2_VITL14)),
        ("IR-SE50 embeddings, batch 2 at 112 px", lambda n, i: (arcface_apply(n["arc"], i["x112"]),)),
        (f"P-net on a {res} px image", lambda n, i: mtcnn.pnet_apply(n["mtcnn"]["pnet"], i["face"])),
        (f"R-net on {len(boxes)} crops of it", lambda n, i: mtcnn.rnet_apply(n["mtcnn"]["rnet"], i["c24"])),
        (f"O-net on {len(boxes)} crops of it", lambda n, i: mtcnn.onet_apply(n["mtcnn"]["onet"], i["c48"])),
        (f"degrade_with_params, batch 2 at {res} px, the same noise",
         lambda n, i: (degrade_with_params(i["img"], i["cycle"], noise=i["noise"], resolution=res),)),
        (f"jpeg_compress_dct at quality 50, batch 2 at {res} px",
         lambda n, i: (jpeg_compress_dct(i["img"], 50),)),
    ]
    on_dev = tree_to(inputs, "cuda"), tree_to(nets, "cuda")
    on_cpu = inputs, tree_to(nets, "cpu")
    with no_tf32(), torch.no_grad():
        for what, run in cases:
            got = run(on_dev[1], on_dev[0])
            ref = run(on_cpu[1], on_cpu[0])
            errs = [rel_rms(g.float(), r.float()) for g, r in zip(got, ref)]
            worst = max(float((g.float().cpu() - r.float()).abs().max()) for g, r in zip(got, ref))
            print(f"recipe network {what}: card vs CPU, fp32, TF32 off: relative RMS "
                  f"{', '.join(f'{e:.2e}' for e in errs)} (tol {RECIPE_NET_REL_RMS}), max-abs "
                  f"{worst:.3e} [{card}]")
            if max(errs) > RECIPE_NET_REL_RMS or not all(all_finite(g) for g in got):
                failures.append(f"{what}: relative RMS {errs}")


def with_grads(heads):
    """A copy of a head tree whose weights and biases want a gradient (the u
    vectors are data), and those leaves in order."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            return {k: v if k == "u" else walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        leaf = node.detach().clone().requires_grad_()
        leaves.append(leaf)
        return leaf

    return walk(heads), leaves


def recipe_phase(card: str):
    """The reference's full generator loss at full width: the new networks
    held against the CPU; the shipped recipe's train step (OptimConfig()'s
    weights: L2 5, LPIPS 5, ID 1.0 on aligned crops, GAN 0.5 with the
    DINOv2 ViT-L/14 discriminator) at batch 2 x 4 refs, 512 px, bf16 over
    fp32 params, LoRA rank 32, fused attention, remat: launches, loss terms,
    fused vs unfused and both against the step in fp32, ms, busy, peak and
    the ViT's and IR-SE50's device time; one step with every term live; and
    the discriminator's side. Returns the launch counts of the timed steps."""
    import dataclasses

    import torch

    from instantrestore_tpu_torch.configs.config import OptimConfig, SchedulerType
    from instantrestore_tpu_torch.convert import tree_to
    from instantrestore_tpu_torch.data.mtcnn import init_mtcnn_params
    from instantrestore_tpu_torch.models.lora import trainable_mask
    from instantrestore_tpu_torch.models.restorer import RestorerStatics, init_restorer_params
    from instantrestore_tpu_torch.models.vit import DINOV2_VITL14, init_vit_params
    from instantrestore_tpu_torch.ops.image_ops import degrade_with_params
    from instantrestore_tpu_torch.training.losses import id_loss as id_mod
    from instantrestore_tpu_torch.training.losses.composite import (
        compute_generator_loss,
        facial_comp_sizes,
    )
    from instantrestore_tpu_torch.training.losses.gan import (
        diff_augment_draws,
        discriminate,
        init_discriminator_heads,
    )
    from instantrestore_tpu_torch.training.losses.lpips import init_lpips_params
    from instantrestore_tpu_torch.training.optim import make_optimizer, trainable_leaves
    from instantrestore_tpu_torch.training.train_step import make_train_step

    dev, res, vit_cfg = torch.device("cuda"), RES, DINOV2_VITL14
    statics = RestorerStatics(use_adain=True, train_input=False)
    failures = []

    gen = torch.Generator(device=dev).manual_seed(0)
    params = tree_to(init_restorer_params(gen, statics, lora_rank_unet=32, lora_rank_vae=32,
                                          device=dev), dev)
    lpips_params = tree_to(init_lpips_params(gen, device=dev), dev)
    nets = {"vit": init_vit_params(gen, vit_cfg, device=dev),
            "arc": id_mod.init_arcface_params(gen, device=dev),
            "mtcnn": init_mtcnn_params(gen, device=dev)}
    heads = init_discriminator_heads(gen, embed_dim=vit_cfg.embed_dim, out_ch=256, device=dev)
    print(f"recipe networks: ViT {sum(t.numel() for _, t in _tree_leaves(nets['vit'])) / 1e6:.1f} M, "
          f"IR-SE50 {sum(t.numel() for _, t in _tree_leaves(nets['arc']) if t is not None) / 1e6:.1f}"
          f" M, D heads {sum(t.numel() for _, t in _tree_leaves(heads)) / 1e6:.2f} M parameters")
    t0 = time.perf_counter()
    recipe_networks(card, nets, failures)
    print(f"recipe networks held against the CPU in {time.perf_counter() - t0:.1f} s")

    mask = {
        "unet": trainable_mask(params["unet"], extra_trainable=("conv_in",)),
        "unet_orig_conv_in": trainable_mask(params["unet_orig_conv_in"]),
        "vae": trainable_mask(params["vae"]),
        "caption_enc": False,
    }
    leaves = trainable_leaves(params, mask)
    trainable_ids = {id(t) for t in leaves}
    host = torch.Generator().manual_seed(5)
    bsz, lat = TRAIN_BATCH, res // 8

    def images(*shape):
        return torch.rand(shape, generator=host) * 2.0 - 1.0

    # aligned ID crops from landmarks near the template (the data pipeline's path)
    lms = [id_mod.ARCFACE_REFERENCE_POINTS * (res / 112) * s + o for s, o in ((0.85, 10.0),
                                                                            (0.95, -6.0))]
    mats, valid = id_mod.alignment_transforms(lms)
    batch = {"image": images(bsz, res, res, 3), "gt": images(bsz, res, res, 3),
             "conditioning_images": images(bsz, N_REFS, res, res, 3),
             "valid_indices": torch.full((bsz,), N_REFS),
             "id_mats_pred": torch.from_numpy(mats), "id_mats_target": torch.from_numpy(mats),
             "id_valid": torch.from_numpy(valid)}
    batch = {k: v.to(dev) for k, v in batch.items()}
    noise = {k: torch.randn((n, lat, lat, 4), generator=host).to(dev)
             for k, n in (("latent", bsz), ("diffusion", bsz), ("cond_latent", bsz * N_REFS),
                          ("cond_diffusion", bsz * N_REFS))}
    nets_kw = dict(lpips_params=lpips_params, arcface_params=nets["arc"],
                   disc_backbone=nets["vit"], disc_heads=heads, vit_cfg=vit_cfg,
                   disc_type=RECIPE_DISC, train_input=statics.train_input)

    def stepper(cfg, loss_kw=None, **kw):
        extra = dict(nets_kw, **(loss_kw or {}))
        loss_fn = lambda out, b, c: compute_generator_loss(out, b, c, generator=gen, **extra)
        return make_train_step(kw.pop("statics", statics), cfg, make_optimizer(cfg, 1000, mask),
                               mask, loss_fn, use_fused_attention=kw.pop("fused", True),
                               remat=kw.pop("remat", True), device=dev, **kw)

    def timed(step, batch=batch, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics, out = step(params, batch, **kw)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        return metrics, out, time.perf_counter() - t0, peak

    def finite_terms(metrics, wanted):
        terms = {k: float(v) for k, v in metrics.items() if k != "grad_norm"}
        bad = [k for k in wanted if k not in terms or not all_finite(torch.tensor(terms[k]))]
        return terms, bad

    # ---- fused against unfused from the seeded state (before any update,
    # so that the deterministic algorithms give the same bits on every call),
    # with the same draws; both against the same step in fp32; then fused
    # against unfused without the ID term, for its share ----
    still = OptimConfig(learning_rate=0.0, scheduler_type=SchedulerType.CONSTANT)
    draws = [diff_augment_draws(bsz, res, res, torch.Generator(device=dev).manual_seed(9), dev)]
    names = [n for n, t in _tree_leaves(params) if id(t) in trainable_ids]

    def seeded_step(cfg, fused=True, **kw):
        with deterministic_cudnn():
            metrics, _, dt, peak = timed(stepper(cfg, loss_kw=dict(gan_draws=draws), fused=fused,
                                                 **kw), noise=noise, timestep=499)
        terms = {k: float(v) for k, v in metrics.items() if k != "grad_norm"}
        return terms, [t.grad.clone() for t in leaves], dt, peak

    def grad_rels(got, ref):
        """Relative RMS of ``got`` against ``ref`` by leaf group."""
        return {k: round(v, 4) for k, v in grad_rel_rms_by_group(names, got, ref).items()}

    terms_a, g_a, _, _ = seeded_step(still)
    terms_u, g_u, dt_u, peak_u = seeded_step(still, fused=False)
    loss_a, loss_u = terms_a["loss"], terms_u["loss"]
    loss_rel, rels = abs(loss_a - loss_u) / abs(loss_u), grad_rels(g_a, g_u)
    print(f"recipe step fused vs unfused (seeded state, same noise, timestep 499, DiffAugment "
          f"draws): loss {loss_a:.6f} vs {loss_u:.6f} (relative {loss_rel:.2e}, tol "
          f"{TRAIN_LOSS_REL_TOL}); gradient relative RMS by group {rels} (tol "
          f"{TRAIN_GRAD_REL_TOL}); unfused {dt_u * 1e3:.1f} ms, peak {peak_u:.2f} GiB [{card}]")
    if loss_rel > TRAIN_LOSS_REL_TOL or max(rels.values()) > TRAIN_GRAD_REL_TOL:
        failures.append("the fused recipe step disagrees with the unfused one")
    with no_tf32():
        terms_r, g_r, dt_r, peak_r = seeded_step(
            still, fused=False, statics=dataclasses.replace(statics, compute_dtype=torch.float32))
    to_fp32 = {"fused": grad_rels(g_a, g_r), "unfused": grad_rels(g_u, g_r)}
    del g_a, g_u, g_r
    print(f"both against the same step in fp32 (unfused, TF32 off; loss {terms_r['loss']:.6f}, "
          f"{dt_r * 1e3:.1f} ms, peak {peak_r:.2f} GiB): gradient relative RMS by group, fused "
          f"{to_fp32['fused']}, unfused {to_fp32['unfused']} (the fused path within "
          f"{RECIPE_FP32_FACTOR}x of the unfused one's distance) [{card}]")
    if any(v > RECIPE_FP32_FACTOR * to_fp32["unfused"][k] for k, v in to_fp32["fused"].items()):
        failures.append("the fused recipe step lies further from the fp32 step than the unfused")
    three = {k: tuple(round(t[k], 6) for t in (terms_a, terms_u, terms_r)) for k in terms_r}
    print(f"the seeded steps' terms, fused / unfused / fp32: {three}")
    no_id = dataclasses.replace(still, lambda_id_loss=0.0)
    rels_no_id = grad_rels(seeded_step(no_id)[1], seeded_step(no_id, fused=False)[1])
    print(f"the same without the ID term: fused vs unfused gradient relative RMS by group "
          f"{rels_no_id} (not checked: what the ID term's share of the gap is) [{card}]")

    # ---- the shipped recipe: a warm-up step, then the timed steps ----
    ocfg = OptimConfig()
    print(f"recipe weights (OptimConfig()): L2 {ocfg.lambda_l2}, LPIPS {ocfg.lambda_lpips}, ID "
          f"{ocfg.lambda_id_loss}, GAN {ocfg.lambda_gan} (gan_disc_type {ocfg.gan_disc_type!r} -> "
          f"{RECIPE_DISC!r}), cycle {ocfg.lambda_cycle}")
    step = stepper(ocfg)
    metrics, out, first_s, _ = timed(step, generator=gen)
    reset_counts()
    step_s, peaks = [], []
    for _ in range(RECIPE_STEPS):
        metrics, out, dt, peak = timed(step, generator=gen)
        step_s.append(dt)
        peaks.append(peak)
    counts = launch_counts()
    # the loss networks add no attention kernel: the training phase's counts
    check_launches(failures, f"{RECIPE_STEPS} recipe steps", counts, RECIPE_STEPS,
                   flash_fwd_lse=2 * 18, flash_bwd_dq=18, flash_bwd_dkv=18,
                   flash_attention_bound=17, group_norm=GN_CAPTURE)
    terms, bad = finite_terms(metrics, ("loss_l2", "loss_lpips", "loss_id", "sim_id", "loss_g",
                                        "loss"))
    if bad or not all(bool(torch.isfinite(t.grad).all()) for t in leaves):
        failures.append(f"recipe step: missing or non-finite terms {bad} or gradients; {terms}")
    steady = statistics.median(step_s)
    print(f"recipe train step batch {bsz} x {N_REFS} refs, {res} px, bf16, fused, remat, "
          f"L2 + LPIPS + ID + GAN: first {first_s * 1e3:.1f} ms, steady median "
          f"{steady * 1e3:.1f} ms over {RECIPE_STEPS} steps {[round(x * 1e3, 1) for x in step_s]}, "
          f"peak device memory {max(peaks):.2f} GiB [{card}]")
    print(f"recipe step terms: { {k: round(v, 5) for k, v in terms.items()} }")

    # ---- device time: the recipe step, the L2 + LPIPS step, the G and ID terms alone ----
    busy = profile_run(lambda: step(params, batch, generator=gen), "one recipe train step",
                       card, top=25)
    # the training phase's loss (L2 + LPIPS), timed and profiled in this call
    plain = stepper(OptimConfig(lambda_l2=1.0, lambda_lpips=1.0, lambda_id_loss=0.0,
                                lambda_gan=0.0))
    timed(plain, generator=gen)
    runs = [timed(plain, generator=gen) for _ in range(RECIPE_STEPS)]
    print(f"L2 + LPIPS train step, same call: steady median "
          f"{statistics.median(r[2] for r in runs) * 1e3:.1f} ms "
          f"{[round(r[2] * 1e3, 1) for r in runs]}, peak {max(r[3] for r in runs):.2f} GiB, "
          f"terms {sorted(runs[-1][0])} [{card}]")
    if {"loss_id", "loss_g"} & set(runs[-1][0]):
        failures.append(f"the L2 + LPIPS step ran more terms: {sorted(runs[-1][0])}")
    busy_plain = profile_run(lambda: plain(params, batch, generator=gen),
                             "one L2 + LPIPS train step (the training phase's loss), same call",
                             card, top=5)
    img = out["output_image"].detach().requires_grad_()
    gt = batch["gt"]

    def g_term():
        loss, _ = discriminate(nets["vit"], heads, img, generator=gen, for_g=True,
                               update_sn=False, vit_cfg=vit_cfg, disc_type=RECIPE_DISC)
        torch.autograd.grad(loss.mean() * ocfg.lambda_gan, img)

    def id_term():
        loss, _ = id_mod.id_loss(nets["arc"], img.float(), gt, batch["id_mats_pred"],
                                 batch["id_mats_target"], batch["id_valid"])
        torch.autograd.grad(loss * ocfg.lambda_id_loss, img)

    g_term(), id_term()
    busy_g = profile_run(g_term, "the G term alone (DiffAugment, ViT-L/14 fp32 forward and "
                         "backward into the images, heads)", card, top=12)
    busy_id = profile_run(id_term, "the ID term alone (two warps, IR-SE50 fp32 on 2 x 2 "
                          "crops, backward into the prediction)", card, top=12)
    if None not in (busy, busy_plain, busy_g, busy_id):
        print(f"recipe step device busy {busy:.1f} ms against {busy_plain:.1f} ms for L2 + "
              f"LPIPS alone (+{busy - busy_plain:.1f} ms); the G term {busy_g:.1f} ms "
              f"({busy_g / busy * 100:.1f}% of the step), the ID term {busy_id:.1f} ms "
              f"({busy_id / busy * 100:.1f}%) [{card}]")

    # ---- every term live, correctness only ----
    ucfg = statics.unet_cfg
    heads_l0 = ucfg.attention_heads[len(ucfg.attention_heads) - 2]
    q = (ucfg.sample_size // 4) ** 2
    n_seg = N_REFS + int(statics.train_input)
    all_cfg = OptimConfig(lambda_l2=1.0, lambda_lpips=5.0, lambda_id_loss=1.0, lambda_gan=0.5,
                          lambda_attn_reg=0.1, lambda_cycle=1.0, lambda_landmark=5000.0,
                          lambda_pos_reg=0.1, lambda_neg_reg=0.1, lambda_facial_comp=0.5,
                          learning_rate=0.0, scheduler_type=SchedulerType.CONSTANT)
    cycle = {"blur_sigma_x": torch.tensor([0.6, 2.2]), "blur_sigma_y": torch.tensor([1.4, 0.7]),
             "blur_rotation": torch.tensor([0.2, 1.0]), "downsample_factor": torch.tensor([3, 8]),
             "noise_sigma": torch.tensor([8.0, 3.0]), "jpeg_quality": torch.tensor([30, 80])}
    cycle = {k: v.to(dev) for k, v in cycle.items()}
    sizes = facial_comp_sizes(res)
    extra = dict(batch)
    extra.update({
        "gt_attn_probs": torch.rand((bsz, heads_l0, q, q), generator=host).to(dev),
        "gt_attn_mask": (torch.rand((bsz, q), generator=host) > 0.5).to(dev),
        "gt_attn_cond": torch.tensor([1, n_seg - 1], device=dev),
        "pos_reg_idx": torch.tensor([0, 2], device=dev), "neg_reg_idx": torch.tensor([1, -1], device=dev),
        "facial_comps": [(torch.rand((bsz, res, res), generator=host) > 0.8).float().to(dev)
                         for _ in sizes],
        "facial_comp_boxes": torch.tensor([[[res // 3, res // 4], [res // 3, res // 2],
                                            [res // 2 + res // 8, res // 3]]] * bsz, device=dev),
    })

    def degrade_fn(x):
        return degrade_with_params((x + 1) * 0.5, cycle, generator=gen, resolution=res) * 2 - 1

    every = stepper(all_cfg, loss_kw=dict(degrade_fn=degrade_fn,
                                          landmark_layer=RECIPE_LANDMARK_LAYER),
                    save_seg_sums=True, save_attn_probs=True, probs_layers=(RECIPE_LANDMARK_LAYER,))
    metrics, out, dt, peak = timed(every, batch=extra, generator=gen)
    terms, bad = finite_terms(metrics, RECIPE_TERMS)
    print(f"every term live (cycle through degrade_with_params per sample, landmark, pos/neg, "
          f"facial-component L2, LPIPS and GAN terms): {dt * 1e3:.1f} ms, peak {peak:.2f} GiB, "
          f"{ {k: round(v, 5) for k, v in terms.items()} } [{card}]")
    if bad:
        failures.append(f"every-term step: missing or non-finite {bad}")

    # ---- the discriminator's side: its loss, its heads' gradients, new u ----
    pred = out["output_image"].detach()
    heads_g, head_leaves = with_grads(heads)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kw = dict(generator=gen, update_sn=True, vit_cfg=vit_cfg, disc_type=RECIPE_DISC)
    l_real, heads_1 = discriminate(nets["vit"], heads_g, batch["gt"], for_real=True, **kw)
    l_fake, heads_2 = discriminate(nets["vit"], heads_1, pred, for_real=False, **kw)
    d_loss = 0.5 * (l_real.mean() + l_fake.mean()) * ocfg.lambda_gan
    d_grads = torch.autograd.grad(d_loss, head_leaves)
    torch.cuda.synchronize()
    d_ms = (time.perf_counter() - t0) * 1e3
    moved_u = [name for (name, a), (_, b) in zip(_tree_leaves(heads), _tree_leaves(heads_2))
               if name.endswith(".u") and a.numel() > 1 and not torch.equal(a, b)]
    n_u = sum(1 for name, a in _tree_leaves(heads) if name.endswith(".u") and a.numel() > 1)
    grads_ok = all(all_finite(g) for g in d_grads) and any(float(g.abs().max()) > 0
                                                           for g in d_grads)
    print(f"discriminator side: D loss {float(d_loss.detach()):.5f} (real "
          f"{float(l_real.detach().mean()):.5f}, fake {float(l_fake.detach().mean()):.5f}), {len(d_grads)} head gradients finite and non-zero: "
          f"{grads_ok}, u vectors moved {len(moved_u)} of {n_u}, {d_ms:.1f} ms [{card}]")
    if not grads_ok or len(moved_u) != n_u or not all_finite(d_loss):
        failures.append("discriminator side: non-finite loss or gradient, or u unchanged")

    if failures:
        raise AssertionError("recipe phase failed: " + "; ".join(failures))
    return counts


def small_model_phase(card: str, serving_params):
    """The serving and training paths of the same seeded weights at each of
    SMALL_SAMPLE_SIZES, whose attention shapes are off the tiles' 64 rows: a
    warm restore (onboarding SMALL_IDENT identities), a cold restore, a cold
    restore under kv_outer + online and one train step, each holding its
    launch counts, finite outputs and the unfused path. ``serving_params``
    is the warm engine's merged bf16 bundle. Returns the summed launch
    counts."""
    import dataclasses

    import torch

    from instantrestore_tpu_torch.configs.config import OptimConfig, SchedulerType
    from instantrestore_tpu_torch.convert import tree_to
    from instantrestore_tpu_torch.inference.serving import ServingEngine
    from instantrestore_tpu_torch.models.lora import trainable_mask
    from instantrestore_tpu_torch.models.restorer import RestorerStatics, init_restorer_params
    from instantrestore_tpu_torch.training.losses.composite import compute_generator_loss
    from instantrestore_tpu_torch.training.losses.lpips import init_lpips_params
    from instantrestore_tpu_torch.training.optim import make_optimizer, trainable_leaves
    from instantrestore_tpu_torch.training.train_step import make_train_step

    dev = torch.device("cuda")
    base = RestorerStatics(use_adain=True, train_input=False)
    failures, total = [], {}
    host = torch.Generator().manual_seed(5)
    for size in SMALL_SAMPLE_SIZES:
        statics = dataclasses.replace(base, unet_cfg=dataclasses.replace(base.unet_cfg,
                                                                         sample_size=size))
        engine = ServingEngine(serving_params, statics, device=dev)
        res, lat, b = engine.resolution, size, SMALL_BATCH
        what = f"sample_size {size} ({res} px)"
        refs = torch.randint(0, 256, (SMALL_IDENT, N_REFS, res, res, 3), dtype=torch.uint8,
                             generator=host)
        images = torch.randint(0, 256, (b, res, res, 3), dtype=torch.uint8, generator=host)
        ids = torch.tensor([2, 0, 3, 2][:b])
        noise = {k: torch.randn((b, lat, lat, 4), generator=host).to(dev)
                 for k in ("latent", "diffusion")}
        onboard_noise = {k: torch.randn((SMALL_IDENT, N_REFS, lat, lat, 4), generator=host).to(dev)
                         for k in ("latent", "diffusion")}

        # warm: onboarding, then one restore
        reset_counts()
        engine.onboard(refs, noise=onboard_noise)
        warm = engine.restore(images, ids, noise=noise)
        counts = launch_counts()
        check_launches(failures, f"{what}: onboard {SMALL_IDENT} + warm restore", counts, 1,
                       flash_attention_bound=17 * SMALL_IDENT + 9, shared_identity_attention=9,
                       group_norm=SMALL_IDENT * GN_CAPTURE + GN_WARM)
        add_counts(total, counts)
        # cold: each sample's identity references re-encoded, with its onboarding noise
        cond = refs[ids]
        cold_noise = dict(noise)
        for k, v in onboard_noise.items():
            cold_noise[f"cond_{k}"] = v[ids.to(dev)].reshape(b * N_REFS, lat, lat, 4)
        reset_counts()
        cold = engine.restore_cold(images, cond, noise=cold_noise)
        counts = launch_counts()
        check_launches(failures, f"{what}: cold restore", counts, 1, shared_flash_bound=9,
                       flash_attention_bound=26, group_norm=GN_COLD)
        add_counts(total, counts)
        with algo_env(attn="kv_outer", flash="online"):
            reset_counts()
            online = engine.restore_cold(images, cond, noise=cold_noise)
            counts = launch_counts()
        check_launches(failures, f"{what}: cold restore under kv_outer + online", counts, 1,
                       shared_online=9, flash_attention_online=26, group_norm=GN_COLD)
        add_counts(total, counts)
        engine.use_fused_attention = False
        unfused_cold = engine.restore_cold(images, cond, noise=cold_noise)
        unfused_warm = engine.restore(images, ids, noise=noise)
        for name, out in (("warm", warm), ("cold", cold), ("online cold", online)):
            if tuple(out.shape) != (b, res, res, 3) or not torch.isfinite(out).all():
                failures.append(f"{what}: {name} output {tuple(out.shape)} or not finite")
        diffs = {"warm vs unfused": mean_abs(warm, unfused_warm),
                 "cold vs unfused": mean_abs(cold, unfused_cold),
                 "cold vs warm": mean_abs(cold, warm),
                 "kv_outer + online vs default, cold": mean_abs(online, cold)}
        print(f"{what}, batch {b}: mean-abs {({k: round(v, 5) for k, v in diffs.items()})} "
              f"[{card}]")
        for k, v in diffs.items():
            if v > 2e-2:
                failures.append(f"{what}: {k} mean-abs {v}")
        del engine, warm, cold, online, unfused_cold, unfused_warm
        torch.cuda.empty_cache()

        # one train step, and the same step unfused from the same state
        gen = torch.Generator(device=dev).manual_seed(0)
        params = tree_to(init_restorer_params(gen, statics, lora_rank_unet=32, lora_rank_vae=32,
                                              device=dev), dev)
        lpips_params = tree_to(init_lpips_params(gen, device=dev), dev)
        mask = {"unet": trainable_mask(params["unet"], extra_trainable=("conv_in",)),
                "unet_orig_conv_in": trainable_mask(params["unet_orig_conv_in"]),
                "vae": trainable_mask(params["vae"]), "caption_enc": False}
        leaves = trainable_leaves(params, mask)
        tb = TRAIN_BATCH
        batch = {"image": torch.rand((tb, res, res, 3), generator=host) * 2 - 1,
                 "gt": torch.rand((tb, res, res, 3), generator=host) * 2 - 1,
                 "conditioning_images": torch.rand((tb, N_REFS, res, res, 3),
                                                   generator=host) * 2 - 1,
                 "valid_indices": torch.full((tb,), N_REFS),
                 "pos_reg_idx": torch.zeros(tb, dtype=torch.long),
                 "neg_reg_idx": torch.ones(tb, dtype=torch.long)}
        batch = {k: v.to(dev) for k, v in batch.items()}
        step_noise = {k: torch.randn((n, lat, lat, 4), generator=host).to(dev)
                      for k, n in (("latent", tb), ("diffusion", tb),
                                   ("cond_latent", tb * N_REFS), ("cond_diffusion", tb * N_REFS))}
        still = OptimConfig(lambda_l2=1.0, lambda_lpips=1.0, learning_rate=0.0,
                            scheduler_type=SchedulerType.CONSTANT)

        def step_once(fused):
            loss_fn = lambda out, bt, c: compute_generator_loss(
                out, bt, c, lpips_params=lpips_params, train_input=False, generator=gen)
            step = make_train_step(statics, still, make_optimizer(still, 1000, mask), mask,
                                   loss_fn, use_fused_attention=fused, remat=True, device=dev)
            metrics, _ = step(params, batch, noise=step_noise, timestep=499)
            return float(metrics["loss"]), [t.grad.clone() for t in leaves]

        with deterministic_cudnn():
            reset_counts()
            loss_f, g_f = step_once(True)
            counts = launch_counts()
            loss_u, g_u = step_once(False)
        check_launches(failures, f"{what}: one train step", counts, 1, flash_fwd_lse=2 * 18,
                       flash_bwd_dq=18, flash_bwd_dkv=18, flash_attention_bound=17,
                       group_norm=GN_CAPTURE)
        add_counts(total, counts)
        finite = loss_f == loss_f and abs(loss_f) != float("inf") and all(
            bool(torch.isfinite(t).all()) for t in g_f)
        num = sum(float((a - u).square().sum()) for a, u in zip(g_f, g_u))
        den = sum(float(u.square().sum()) for u in g_u)
        loss_rel, grad_rel = abs(loss_f - loss_u) / abs(loss_u), (num / den) ** 0.5
        print(f"{what}: train step batch {tb}, fused vs unfused: loss {loss_f:.6f} vs "
              f"{loss_u:.6f} (relative {loss_rel:.2e}), gradient relative RMS {grad_rel:.4f} "
              f"[{card}]")
        if not finite or loss_rel > TRAIN_LOSS_REL_TOL or grad_rel > TRAIN_GRAD_REL_TOL:
            failures.append(f"{what}: train step non-finite or fused vs unfused loss {loss_rel}, "
                            f"gradients {grad_rel}")
        del params, lpips_params, leaves, g_f, g_u
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("small-model phase failed: " + "; ".join(failures))
    return total


# the two backward kernels compute together what one library call computes
BACKWARD_PAIR = ("flash_bwd_dq", "flash_bwd_dkv")


def write_tokenizer_files(directory) -> None:
    """vocab.json and merges.txt of a synthetic byte-level CLIP vocab
    (TOKENIZER_MERGES), as the tokenizer folder of an SD checkpoint holds them."""
    from instantrestore_tpu_torch.models.tokenizer import _bytes_to_unicode

    b2u = _bytes_to_unicode()
    words = ([b2u[b] for b in range(256)] + [b2u[b] + "</w>" for b in range(256)]
             + [a + b for a, b in TOKENIZER_MERGES] + ["<|startoftext|>", "<|endoftext|>"])
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "vocab.json").write_text(json.dumps({w: i for i, w in enumerate(words)}))
    (directory / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in TOKENIZER_MERGES))


def _gb(path) -> float:
    """Size of a file, or of every file under a folder, in GB."""
    from pathlib import Path

    path = Path(path)
    files = [path] if path.is_file() else [f for f in path.rglob("*") if f.is_file()]
    return sum(f.stat().st_size for f in files) / 1e9


def checkpoint_phase(card: str):
    """Serving from checkpoint files at full width: a FULL .pt through
    Predictor(checkpoint_path=...) and a LoRA-only .pt over a base folder
    through cli.serve.load_engine + run, each bit for bit against the same
    fp16 weights given in memory; then the PNG CLIs where Pillow imports.
    Returns the launch counts of its paths."""
    import dataclasses
    import importlib.util
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from instantrestore_tpu_torch.cli import infer, serve
    from instantrestore_tpu_torch.convert import state_dict, tree_to
    from instantrestore_tpu_torch.inference.predictor import Predictor
    from instantrestore_tpu_torch.inference.serving import ServingEngine
    from instantrestore_tpu_torch.models.restorer import (
        RestorerStatics,
        init_restorer_params,
        original_unet_view,
        original_vae_view,
        serving_bundle,
    )
    from instantrestore_tpu_torch.models.text_encoder import (
        PROMPT,
        CLIPTextConfig,
        init_text_encoder_params,
        text_encoder_apply,
    )
    from instantrestore_tpu_torch.models.tokenizer import load_tokenizer
    from instantrestore_tpu_torch.ops.image_ops import preprocess
    from instantrestore_tpu_torch.training.checkpoints import TOKENIZER_DIR_ENV, build_caption_enc
    from instantrestore_tpu_torch.utils import safetensors
    from instantrestore_tpu_torch.utils.torch_convert import (
        convert_full_checkpoint,
        export_full_checkpoint,
        export_lora_only_checkpoint,
        torch_load,
    )

    dev = torch.device("cuda")
    statics = RestorerStatics(use_adain=True, train_input=False)  # the shipped statics
    failures, total = [], {}
    scratch = Path(__file__).resolve().parent / "_scratch"
    scratch.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="checkpoint_phase_", dir=scratch))
    t_phase = time.perf_counter()

    def synced(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    try:
        free = shutil.disk_usage(tmp).free
        print(f"checkpoint phase: {free / 1e9:.1f} GB free under {tmp}")
        if free < CKPT_DISK_BYTES:
            raise RuntimeError(f"checkpoint phase needs {CKPT_DISK_BYTES / 1e9:.0f} GB free under "
                               f"{tmp}, has {free / 1e9:.1f}")

        # ---- a seeded full-width model in fp16 on the host, as the files hold it ----
        gen = torch.Generator(device=dev).manual_seed(11)
        params = init_restorer_params(gen, statics, lora_rank_unet=32, lora_rank_vae=32, device=dev)
        # training moves conv_in away from the frozen capture UNet's
        params["unet"]["conv_in"] = {k: v + 1e-2 * torch.randn(v.shape, generator=gen, device=dev)
                                     for k, v in params["unet"]["conv_in"].items()}
        text_cfg = CLIPTextConfig()  # sd-turbo's: 23 layers, 1024 wide
        nets = tree_to({"unet": params["unet"], "vae": params["vae"],
                        "original_unet": original_unet_view(params),
                        "original_vae": original_vae_view(params),
                        "text_encoder": init_text_encoder_params(gen, text_cfg, device=dev)},
                       "cpu", torch.float16)
        del params
        torch.cuda.empty_cache()
        tok_dir = tmp / "tokenizer"
        write_tokenizer_files(tok_dir)
        ids = load_tokenizer(str(tok_dir))(PROMPT)
        host = torch.Generator().manual_seed(12)
        images = preprocess(torch.randint(0, 256, (CKPT_BATCH, RES, RES, 3), dtype=torch.uint8,
                                          generator=host).to(dev).float() / 255.0, RES)
        conds = preprocess(torch.randint(0, 256, (CKPT_BATCH * N_REFS, RES, RES, 3),
                                         dtype=torch.uint8, generator=host).to(dev).float() / 255.0,
                           RES).reshape(CKPT_BATCH, N_REFS, RES, RES, 3)

        # ---- FULL .pt: the loader's steps timed one by one, then the Predictor ----
        full = tmp / "full.pt"
        cfg = {"model": {"use_adain": True, "train_input": False, "lora_rank_unet": 32,
                         "lora_rank_vae": 32}}
        _, write_s = synced(lambda: export_full_checkpoint(nets, full, cfg=cfg))
        raw, load_s = synced(lambda: torch_load(full))
        loaded, convert_s = synced(lambda: convert_full_checkpoint(raw["state_dict"]))
        caption, text_s = synced(lambda: build_caption_enc(loaded["text_encoder"],
                                                           tokenizer_dir=str(tok_dir), device=dev))
        _, move_s = synced(lambda: tree_to({k: v for k, v in loaded.items() if k != "text_encoder"},
                                           dev, torch.bfloat16))
        del raw, loaded
        torch.cuda.empty_cache()
        print(f"FULL .pt, fp16, {len(state_dict(nets))} tensors: {_gb(full):.3f} GB, written in "
              f"{write_s:.2f} s; torch.load (mmap) {load_s:.3f} s, convert {convert_s:.3f} s, "
              f"text encoder (fp32, {text_cfg.num_layers} layers) {text_s:.3f} s, to the card in "
              f"bf16 {move_s:.3f} s [{card}]")
        cpu_caption = text_encoder_apply(tree_to(nets["text_encoder"], "cpu", torch.float32),
                                         torch.tensor([ids]), cfg=text_cfg)
        rel = float((caption.cpu() - cpu_caption).norm() / cpu_caption.norm())
        print(f"caption_enc on the card vs the text tower in fp32 on the CPU: relative RMS "
              f"{rel:.2e}")
        if not rel <= CKPT_CAPTION_REL_RMS:
            failures.append(f"caption_enc: relative RMS {rel:.2e} against the CPU's")

        pred, pred_s = synced(lambda: Predictor(full, tokenizer_dir=str(tok_dir),
                                                deterministic=True, device=dev))
        print(f"Predictor(checkpoint_path=FULL .pt) ready in {pred_s:.2f} s [{card}]")
        if pred.statics != statics:
            failures.append(f"statics from the embedded cfg: {pred.statics}")
        if not torch.equal(pred.params["caption_enc"], caption.to(torch.bfloat16)):
            failures.append("the Predictor's caption_enc is not the loader's")
        ref = Predictor(params={"unet": nets["unet"], "vae": nets["vae"],
                                "original_unet": nets["original_unet"],
                                "original_vae": nets["original_vae"],
                                "unet_orig_conv_in": nets["original_unet"]["conv_in"],
                                "caption_enc": caption},
                        statics=statics, deterministic=True, device=dev)
        with deterministic_cudnn():
            reset_counts()
            lat_s, outs = [], []
            for _ in range(RESTORE_RUNS + 1):
                out, sec = synced(lambda: pred.predict_batch(images, conds))
                outs.append(out)
                lat_s.append(sec)
            counts = launch_counts()
            want = ref.predict_batch(images, conds)
        check_launches(failures, f"Predictor from a FULL .pt: {RESTORE_RUNS + 1} predict_batch "
                       f"of {CKPT_BATCH} x {N_REFS} refs", counts, RESTORE_RUNS + 1,
                       shared_flash_bound=9, flash_attention_bound=26, group_norm=GN_COLD)
        add_counts(total, counts)
        same = bool((outs[0] == want).all())
        print(f"Predictor from the FULL .pt vs Predictor(params=the same fp16 tree): "
              f"{'bit-identical' if same else 'DIFFERENT'}, max-abs "
              f"{abs(outs[0] - want).max():.3e}")
        if not same or outs[0].shape != (CKPT_BATCH, RES, RES, 3) or not all_finite(outs[0]):
            failures.append("the FULL checkpoint's Predictor is not the in-memory tree's")
        print(f"Predictor.predict_batch {CKPT_BATCH} x {N_REFS} refs: first "
              f"{lat_s[0] * 1e3:.1f} ms, steady median {statistics.median(lat_s[1:]) * 1e3:.1f} ms "
              f"over {RESTORE_RUNS} [{card}]")
        del pred, ref
        torch.cuda.empty_cache()

        # ---- LoRA-only .pt over a base folder, through the serve CLI's engine ----
        lora = tmp / "lora_only.pt"
        base = tmp / "base"
        _, write_s = synced(lambda: export_lora_only_checkpoint(
            {"unet": nets["unet"], "vae": nets["vae"]}, lora, rank_unet=32, rank_vae=32))
        t0 = time.perf_counter()
        for name, tree in (("unet", nets["original_unet"]), ("vae", nets["original_vae"]),
                           ("text_encoder", nets["text_encoder"])):
            (base / name).mkdir(parents=True)
            safetensors.save_file(state_dict(tree),
                                  base / name / "diffusion_pytorch_model.safetensors")
        shutil.copytree(tok_dir, base / "tokenizer")
        base_s = time.perf_counter() - t0
        # a LoRA-only file carries no cfg: the shipped statics are given, and
        # the file's ranks set the LoRA scalings
        engine, engine_s = synced(lambda: serve.load_engine(lora, statics=statics,
                                                            base_weights_dir=str(base), device=dev))
        print(f"LoRA-only .pt {_gb(lora):.3f} GB (written in {write_s:.2f} s) over a base "
              f"folder of fp16 .safetensors {_gb(base):.3f} GB (written in {base_s:.2f} s): "
              f"serve.load_engine {engine_s:.2f} s [{card}]")
        loaded_statics = dataclasses.replace(statics, unet_lora_scaling=8 / 32,
                                             vae_lora_scaling=8 / 32)
        if engine.statics != loaded_statics:
            failures.append(f"LoRA-only statics: {engine.statics}")
        ref = ServingEngine(serving_bundle(tree_to(
            {"unet": nets["unet"], "vae": nets["vae"],
             "unet_orig_conv_in": nets["original_unet"]["conv_in"], "caption_enc": caption}, dev),
            loaded_statics), loaded_statics, device=dev)
        refs = torch.randint(0, 256, (CKPT_SERVE_IDENT, N_REFS, RES, RES, 3), dtype=torch.uint8,
                             generator=host)
        imgs = torch.randint(0, 256, (CKPT_SERVE_IMAGES, RES, RES, 3), dtype=torch.uint8,
                             generator=host)
        slots = torch.tensor([2, 0, 3, 3, 1, 0, 2, 1])
        with deterministic_cudnn():
            reset_counts()
            out, run_s = synced(lambda: serve.run(engine, refs, imgs, slots,
                                                  batch=CKPT_SERVE_IMAGES, seed=0))
            counts = launch_counts()
            want = serve.run(ref, refs, imgs, slots, batch=CKPT_SERVE_IMAGES, seed=0)
        check_launches(failures, f"serve engine from a LoRA-only .pt: onboard {CKPT_SERVE_IDENT} + "
                       f"restore batch {CKPT_SERVE_IMAGES}", counts, 1,
                       flash_attention_bound=17 * CKPT_SERVE_IDENT + 9, shared_identity_attention=9,
                       group_norm=CKPT_SERVE_IDENT * GN_CAPTURE + GN_WARM)
        add_counts(total, counts)
        same = torch.equal(out, want)
        print(f"serve engine from the LoRA-only .pt vs ServingEngine(the same fp16 tree, LoRA "
              f"scaling 8/32): {'bit-identical' if same else 'DIFFERENT'}, max-abs "
              f"{float((out - want).abs().max()):.3e}")
        if not same or tuple(out.shape) != (CKPT_SERVE_IMAGES, RES, RES, 3) or not all_finite(out):
            failures.append("the LoRA-only checkpoint's engine is not the in-memory tree's")
        del ref
        ids8 = slots.to(dev)
        lat_s = [synced(lambda: engine.restore(imgs, ids8, generator=torch.Generator(
            device=dev).manual_seed(1)))[1] for _ in range(RESTORE_RUNS)]
        print(f"serve.run (onboard {CKPT_SERVE_IDENT} identities + first restore batch "
              f"{CKPT_SERVE_IMAGES}): {run_s:.3f} s; restore batch {CKPT_SERVE_IMAGES}: steady "
              f"median {statistics.median(lat_s) * 1e3:.1f} ms over {RESTORE_RUNS} [{card}]")
        del engine
        torch.cuda.empty_cache()

        # ---- the PNG CLIs, where Pillow imports ----
        if importlib.util.find_spec("PIL") is None:
            print("PNG CLIs: not run, Pillow does not import on this machine")
        else:
            from PIL import Image

            data = tmp / "pngs"
            for name in ("ann", "ben"):
                for rel in ("degraded.png", *(f"conditioning/{i}.png" for i in range(N_REFS))):
                    (data / name / rel).parent.mkdir(parents=True, exist_ok=True)
                    Image.fromarray(torch.randint(0, 256, (RES, RES, 3), dtype=torch.uint8,
                                                  generator=host).numpy()).save(data / name / rel)
            for what, main, argv, per_run in (
                    ("cli.infer.main on the FULL .pt", infer.main, ["--checkpoint", str(full)],
                     dict(shared_flash_bound=9 * 2, flash_attention_bound=26 * 2,
                          group_norm=GN_COLD * 2)),
                    # as a user runs it: without a cfg in the file, the
                    # default statics (train_input) serve it, as in JAX
                    ("cli.serve.main on the LoRA-only .pt", serve.main,
                     ["--checkpoint", str(lora), "--base_weights_dir", str(base), "--batch", "2"],
                     dict(flash_attention_bound=17 * 2 + 9, shared_flash_bound=9,
                          group_norm=2 * GN_CAPTURE + GN_WARM))):
                out_dir = tmp / what.split()[0]
                with environ({TOKENIZER_DIR_ENV: str(tok_dir)}):
                    reset_counts()
                    (rc, sec) = synced(lambda: main(argv + ["--data_root", str(data),
                                                            "--results_dir", str(out_dir)]))
                    counts = launch_counts()
                check_launches(failures, what, counts, 1, **per_run)
                add_counts(total, counts)
                written = sorted(p.name for p in out_dir.iterdir())
                sizes = {Image.open(out_dir / n).size for n in written}
                print(f"{what}: exit {rc}, wrote {written} {sorted(sizes)} in {sec:.2f} s")
                if rc != 0 or written != ["ann.png", "ben.png"] or sizes != {(RES, RES)}:
                    failures.append(f"{what}: exit {rc}, wrote {written}")
            # ---- cli.parity on the FULL .pt ----
            import numpy as np

            from instantrestore_tpu_torch.cli import parity

            ident = data / "ann"
            common = ["--checkpoint", str(full), "--tokenizer_dir", str(tok_dir), "--input",
                      str(ident / "degraded.png"), "--refs", str(ident / "conditioning"),
                      "--resolution", str(RES), "--device", "cuda"]
            reset_counts()
            (rc, sec) = synced(lambda: parity.main(["determinism", *common, "--dump",
                                                    str(tmp / "det.npz"), "--out",
                                                    str(tmp / "det.json")]))
            counts = launch_counts()
            # two predictions, then one more on the dumped noise
            check_launches(failures, "cli.parity determinism", counts, 3, shared_flash_bound=9,
                           flash_attention_bound=26, group_norm=GN_COLD)
            add_counts(total, counts)
            det = json.loads((tmp / "det.json").read_text())
            print(f"cli.parity determinism on the FULL .pt at {RES} px: exit {rc}, deterministic "
                  f"{det['deterministic']}, repeat max-abs {det['repeat_maxabs_uint8']}, dumped "
                  f"noise reproduces the output {det.get('dump_noise_reproduces_output')}; "
                  f"{sec:.2f} s with the load [{card}]")
            if rc != 0 or not det["deterministic"] or not det.get("dump_noise_reproduces_output"):
                failures.append(f"cli.parity determinism: exit {rc}, {det}")
            (rc, sec) = synced(lambda: parity.main(["dump-activations", *common, "--dump",
                                                    str(tmp / "act.npz"), "--out",
                                                    str(tmp / "act.json")]))
            act = json.loads((tmp / "act.json").read_text())
            finite = all(np.isfinite(v) for v in act["stage_absmax"].values())
            print(f"cli.parity dump-activations on the FULL .pt at {RES} px: exit {rc}, "
                  f"{len(act['stages'])} stages, forward {act['seconds']:.2f} s, {sec:.2f} s with "
                  f"the load and the .npz ({_gb(tmp / 'act.npz'):.3f} GB), every stage finite "
                  f"{finite} [{card}]")
            if rc != 0 or len(act["stages"]) < 20 or not finite:
                failures.append(f"cli.parity dump-activations: exit {rc}, {len(act['stages'])} "
                                "stages")
            import PIL

            print(f"PNG CLIs: ran, cli.infer.main and cli.serve.main on 2 identities of {RES} px "
                  f"PNGs, and cli.parity determinism and dump-activations (Pillow "
                  f"{PIL.__version__})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"checkpoint phase: {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("checkpoint phase failed: " + "; ".join(failures))
    return total


# the coach phase: the trainer at full width on in-memory data (and, where
# Pillow and OpenCV import, on PNG files through RestoreDataset and the CLI)
COACH_STEPS, COACH_SAVE_AT, COACH_VAL_ITEMS, COACH_TRAIN_ITEMS = 3, 2, 4, 8
COACH_TIMED = 3  # extra G and D steps timed after the run
COACH_DISK_BYTES = 25e9  # a few 3.8 GB fp32 checkpoints at once, and the PNGs


class SeededFaces:
    """An in-memory dataset of seeded RES x RES items with RestoreDataset's
    keys (``train``: pos/neg indices and aligned ID matrices) or
    RestoreDatasetTest's; each item a function of (seed, path index)."""

    def __init__(self, n: int, seed: int, train: bool):
        import numpy as np

        from instantrestore_tpu_torch.training.losses import id_loss as id_mod

        self.paths, self.seed, self.train = list(range(n)), seed, train
        lms = [id_mod.ARCFACE_REFERENCE_POINTS_3 * (RES / 112) * s + o
               for s, o in ((0.85, 10.0), (0.95, -6.0))]
        self.mats = id_mod.alignment_transforms(lms, ref_points=id_mod.ARCFACE_REFERENCE_POINTS_3)[0]
        self.np = np

    def __len__(self):
        return len(self.paths)

    def shuffle(self, seed=None):
        import random

        random.Random(seed).shuffle(self.paths)

    def __getitem__(self, idx):
        np, key = self.np, self.paths[idx]
        rng = np.random.default_rng([self.seed, key])

        def img(*shape):
            return rng.uniform(-1, 1, shape).astype(np.float32)

        item = {"image": img(RES, RES, 3), "gt": img(RES, RES, 3),
                "conditioning_images": img(N_REFS, RES, RES, 3),
                "valid_indices": np.int32(N_REFS - key % 2),
                "caption": "A high-quality photo of a person; professional, 8k"}
        if self.train:
            item.update(pos_reg_idx=np.int32(-1), neg_reg_idx=np.int32(-1),
                        id_mat=self.mats[key % 2], id_valid=True)
        else:
            item["identity"] = f"id{key}"
        return item


def coach_phase(card: str):
    """The trainer at full width (training/coach.py): seeded SD-Turbo widths
    with LoRA, batch 2 x 4 references, 512 px, bf16 compute over fp32
    params, OptimConfig()'s weights (L2 5, LPIPS 5, ID 1.0 on aligned crops,
    GAN 0.5 with the seeded DINOv2 ViT-L/14 and its heads), fused attention
    and remat, on an in-memory SeededFaces set. A run of COACH_STEPS G + D
    steps (metric interval 1, validation at the last step, a full save at
    COACH_SAVE_AT): launches per step, finite losses, every u vector of more
    than one element moved and no frozen leaf changed; validation launches
    per batch with and without attention overlays, best_model and
    timestep.txt; a fresh Coach resumed from the full save ends bit for bit
    where the run ended; accumulation over 2 micro-steps; the Predictor
    serving the run's final file; then, where Pillow and OpenCV import,
    cli.train.main for 2 steps on PNGs through RestoreDataset (the cycle term
    on). Prints ms per G and D step, the device-busy ms of one step and the
    D step's share, host data ms per batch, ms per validation batch, peak
    memory and checkpoint size and seconds. Returns the launch counts of its
    paths."""
    import copy
    import importlib.util
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from instantrestore_tpu_torch.configs.config import TrainConfig
    from instantrestore_tpu_torch.data.datasets import collate, to_torch_batch
    from instantrestore_tpu_torch.inference.predictor import Predictor
    from instantrestore_tpu_torch.training import checkpoints as ckpt_mod
    from instantrestore_tpu_torch.training import coach as coach_mod
    from instantrestore_tpu_torch.training.losses import id_loss as id_mod
    from instantrestore_tpu_torch.training.optim import trainable_leaves

    dev = torch.device("cuda")
    failures, total = [], {}
    t_phase = time.perf_counter()
    scratch = Path(__file__).resolve().parent / "_scratch"
    scratch.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="coach_phase_", dir=scratch))

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def config(name, **steps):
        cfg = TrainConfig()
        cfg.compute.batch_size = cfg.compute.test_batch_size = TRAIN_BATCH
        cfg.compute.workers, cfg.compute.test_workers, cfg.compute.seed = 2, 1, 0
        cfg.data.resolution, cfg.data.max_conditioning_images = RES, N_REFS
        cfg.log.exp_root, cfg.log.exp_name, cfg.log.log2wandb = str(tmp), name, False
        cfg.log.val_vis_count, cfg.log.vis_attention = 1, False
        cfg.steps.max_steps = COACH_STEPS
        cfg.steps.metric_interval, cfg.steps.image_interval = 1, COACH_STEPS
        cfg.steps.val_interval, cfg.steps.save_interval = COACH_STEPS, COACH_SAVE_AT
        for k, v in steps.items():
            section, field = k.split("__")
            setattr(getattr(cfg, section), field, v)
        return cfg

    arcface = id_mod.init_arcface_params(torch.Generator(device=dev).manual_seed(7), device=dev)
    data = (SeededFaces(COACH_TRAIN_ITEMS, 1, True), SeededFaces(COACH_VAL_ITEMS, 2, False))

    def make(cfg, datasets=data):
        return coach_mod.Coach(cfg, arcface_params=arcface, datasets=datasets, device=dev)

    def snapshot(tree):
        return {name: t.clone() for name, t in _tree_leaves(tree)}

    val_batches = -(-COACH_VAL_ITEMS // TRAIN_BATCH)
    try:
        free = shutil.disk_usage(tmp).free
        print(f"coach phase: {free / 1e9:.1f} GB free under {tmp}")
        if free < COACH_DISK_BYTES:
            raise RuntimeError(f"coach phase needs {COACH_DISK_BYTES / 1e9:.0f} GB free under "
                               f"{tmp}, has {free / 1e9:.1f}")

        # ---- the run: COACH_STEPS G + D steps, a full save, validation ----
        cfg = config("run")
        (coach, build_s) = synced(lambda: make(cfg))
        g_ids = {id(t) for t in trainable_leaves(coach.params, coach.g_mask)}
        n_leaves = len(list(_tree_leaves(coach.params)))
        n_heads = len(list(_tree_leaves(coach.disc_heads)))
        print(f"Coach built in {build_s:.1f} s: disc_type {coach.disc_type!r} (gan_disc_type "
              f"{cfg.optim.gan_disc_type!r}), {len(g_ids)} trainable G leaves of {n_leaves}, "
              f"{n_heads} head leaves; fused {coach._fused_attention}, remat {coach._remat}")
        start, heads0 = snapshot(coach.params), snapshot(coach.disc_heads)
        save_s, save = [], coach.save

        def timed_save(tag, full=False):
            save_s.append((tag, synced(lambda: save(tag, full=full))[1]))

        coach.save = timed_save
        with deterministic_cudnn():
            reset_counts()
            _, run_s = synced(coach.train)
            counts = launch_counts()
        coach.save = save
        # two validations: the val interval's at the last step, then train()'s own
        check_launches(failures, f"Coach.train: {COACH_STEPS} G + D steps and 2 validations of "
                       f"{val_batches} batches", counts, 1,
                       flash_fwd_lse=36 * COACH_STEPS, flash_bwd_dq=18 * COACH_STEPS,
                       flash_bwd_dkv=18 * COACH_STEPS,
                       flash_attention_bound=17 * COACH_STEPS + 26 * 2 * val_batches,
                       shared_flash_bound=9 * 2 * val_batches,
                       group_norm=GN_CAPTURE * COACH_STEPS + GN_COLD * 2 * val_batches)
        add_counts(total, counts)
        log = (Path(cfg.log.exp_dir) / "logs" / "log.txt").read_text()
        lines = [ln for ln in log.splitlines() if ": train: " in ln]
        print(f"Coach.train ({COACH_STEPS} steps, 2 validations, {len(save_s)} checkpoints): "
              f"{run_s:.1f} s [{card}]; last metric line: "
              f"{lines[-1].split(': train: ')[-1] if lines else None}")
        terms = dict(kv.split("=") for kv in lines[-1].split(": train: ")[-1].split(", ")) \
            if lines else {}
        want = {"loss_l2", "loss_lpips", "loss_id", "loss_g", "loss", "loss_d"}
        if len(lines) != COACH_STEPS or not want <= set(terms) or not all(
                np.isfinite(float(v)) for v in terms.values()):
            failures.append(f"Coach.train: {len(lines)} metric lines, last {terms}")
        moved = {n for n, t in _tree_leaves(coach.params) if not torch.equal(t, start[n])}
        wanted = {n for n, t in _tree_leaves(coach.params) if id(t) in g_ids}
        u_still = [n for n, t in _tree_leaves(coach.disc_heads)
                   if n.endswith(".u") and t.numel() > 1 and torch.equal(t, heads0[n])]
        heads_still = [n for n, t in _tree_leaves(coach.disc_heads)
                       if not n.endswith(".u") and torch.equal(t, heads0[n])]
        print(f"after the run: {len(moved)} of {len(wanted)} trainable G leaves moved, "
              f"{len(moved - wanted)} frozen ones; u vectors that did not move {u_still}, head "
              f"weights that did not move {heads_still}")
        if moved - wanted or len(moved) < 0.9 * len(wanted) or u_still or heads_still:
            failures.append("the run moved frozen leaves or left trainable ones")
        del start, heads0
        ck = Path(cfg.log.exp_dir) / "checkpoints"
        for name in (f"step_{COACH_SAVE_AT}", "best_model", "final", "timestep.txt"):
            if not (ck / name).exists():
                failures.append(f"Coach.train wrote no checkpoints/{name}")
        print(f"checkpoints/timestep.txt: {(ck / 'timestep.txt').read_text().strip()}")

        # ---- resume: a fresh Coach from the full save trains to the same end ----
        cfg_b = copy.deepcopy(cfg)
        cfg_b.log.exp_name, cfg_b.log.resume_from = "resumed", str(ck / f"step_{COACH_SAVE_AT}")
        # validation and saves do not touch the weights: only train()'s own at the end
        cfg_b.steps.val_interval = cfg_b.steps.save_interval = 10 * COACH_STEPS
        (resumed, resume_s) = synced(lambda: make(cfg_b))
        with deterministic_cudnn():
            reset_counts()
            synced(resumed.train)
            add_counts(total, launch_counts())
        pairs = list(zip(_tree_leaves(coach.params), _tree_leaves(resumed.params)))
        pairs_h = list(zip(_tree_leaves(coach.disc_heads), _tree_leaves(resumed.disc_heads)))
        same = [n for (n, a), (_, b) in pairs if torch.equal(a, b)]
        same_h = [n for (n, a), (_, b) in pairs_h if torch.equal(a, b)]
        with torch.no_grad():
            diff = max(float((a - b).abs().max()) for (_, a), (_, b) in pairs + pairs_h)
        n_p, n_h = len(pairs), len(pairs_h)
        file_gb = (ck / f"step_{COACH_SAVE_AT}").stat().st_size / 1e9
        print(f"resume from step_{COACH_SAVE_AT} ({file_gb:.2f} GB; a fresh Coach built and "
              f"restored in {resume_s:.1f} s) to step {resumed.train_step_num}: {len(same)} of "
              f"{n_p} params and {len(same_h)} of {n_h} head leaves bit-identical to the "
              f"uninterrupted run (max-abs {diff:.3e})")
        print(f"the run's checkpoints ({file_gb:.2f} GB full, weights only a little less): "
              f"written in {', '.join(f'{t} {x:.2f} s' for t, x in save_s)} [{card}]")
        if len(same) != n_p or len(same_h) != n_h or resumed.train_step_num != COACH_STEPS:
            failures.append("the resumed run does not end where the uninterrupted one ends")
        del resumed
        torch.cuda.empty_cache()

        # ---- the steps alone: G and D timed, one profiled, peak memory ----
        batch = collate([data[0][i] for i in range(TRAIN_BATCH)])
        (dev_batch, layer), data_s = synced(lambda: to_torch_batch(batch, dev))
        host_s = [synced(lambda: collate([data[0][i] for i in range(TRAIN_BATCH)]))[1]
                  for _ in range(3)]
        gen = torch.Generator(device=dev).manual_seed(5)
        g_s, d_s = [], []
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        for _ in range(COACH_TIMED):
            (_, pred), dt = synced(lambda: coach.g_step(dev_batch, layer,
                                                         coach.draw_g(dev_batch, gen)))
            g_s.append(dt)
            counts_g = launch_counts()
            _, dt = synced(lambda: coach.d_step(pred, dev_batch["gt"], None,
                                                draws=coach.draw_d(dev_batch, gen)))
            d_s.append(dt)
            if launch_counts() != counts_g:
                failures.append("the D step launched an attention kernel")
        counts = launch_counts()
        check_launches(failures, f"{COACH_TIMED} Coach G steps (the D steps launch nothing)",
                       counts, COACH_TIMED, flash_fwd_lse=36, flash_bwd_dq=18, flash_bwd_dkv=18,
                       flash_attention_bound=17, group_norm=GN_CAPTURE)
        add_counts(total, counts)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"Coach step batch {TRAIN_BATCH} x {N_REFS} refs, {RES} px, bf16, OptimConfig() "
              f"weights: G steady median {statistics.median(g_s) * 1e3:.1f} ms "
              f"{[round(x * 1e3, 1) for x in g_s]}, D steady median "
              f"{statistics.median(d_s) * 1e3:.1f} ms {[round(x * 1e3, 1) for x in d_s]}, peak "
              f"device memory {peak:.2f} GiB [{card}]")
        print(f"host data per batch of {TRAIN_BATCH} (in-memory items, collate): "
              f"{statistics.median(host_s) * 1e3:.1f} ms; to the card {data_s * 1e3:.1f} ms "
              f"[{card}]")

        def one_step():
            _, p = coach.g_step(dev_batch, layer, coach.draw_g(dev_batch, gen))
            coach.d_step(p, dev_batch["gt"], None, draws=coach.draw_d(dev_batch, gen))

        busy = profile_run(one_step, "one Coach step (G + D)", card, top=12)
        _, pred = coach.g_step(dev_batch, layer, coach.draw_g(dev_batch, gen))
        busy_d = profile_run(lambda: coach.d_step(pred, dev_batch["gt"], None,
                                                  draws=coach.draw_d(dev_batch, gen)),
                             "one Coach D step", card, top=5)
        if busy and busy_d:
            print(f"Coach step device busy {busy:.1f} ms, of which the D step {busy_d:.1f} ms "
                  f"({busy_d / busy * 100:.1f}%) [{card}]")

        # ---- validation: launches per batch with and without overlays ----
        val = collate([data[1][i] for i in range(TRAIN_BATCH)])
        vdev, _ = to_torch_batch(val, dev)
        eval_s = []
        reset_counts()
        for _ in range(3):
            eval_s.append(synced(lambda: coach.eval_step(
                vdev, coach.draw_eval(vdev, torch.Generator(device=dev).manual_seed(0))))[1])
        counts = launch_counts()
        check_launches(failures, "3 val batches (vis_attention off)", counts, 3,
                       shared_flash_bound=9, flash_attention_bound=26, group_norm=GN_COLD)
        add_counts(total, counts)
        coach.cfg.log.vis_attention = True
        reset_counts()
        coach.validate()
        counts = launch_counts()
        # the first six batches save probabilities: their shared layers run
        # unfused (models/attention.py), so no shared kernel launches
        check_launches(failures, f"validate() with vis_attention, {val_batches} batches saving "
                       "probabilities", counts, val_batches, flash_attention_bound=26,
                       group_norm=GN_COLD)
        add_counts(total, counts)
        overlays = sorted(p.name for p in (Path(cfg.log.exp_dir) / "logs" / "val_attention")
                          .glob("*")) if importlib.util.find_spec("PIL") else None
        print(f"validation batch of {TRAIN_BATCH} x {N_REFS} refs: steady median "
              f"{statistics.median(eval_s) * 1e3:.1f} ms {[round(x * 1e3, 1) for x in eval_s]} "
              f"[{card}]; with vis_attention the shared layers run unfused (0 shared_flash_bound "
              f"launches), overlays written: {overlays}")

        # ---- reading a checkpoint back ----
        _, load_s = synced(lambda: coach.restore(ck / f"step_{COACH_SAVE_AT}"))
        print(f"full checkpoint read and restored into the live Coach in {load_s:.2f} s [{card}]")

        # ---- the Predictor serves the run's final file ----
        final = ck / "final"
        pred_cls = Predictor(final, device=dev)
        lora = "unet.up_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q.lora_B"
        served = dict(_tree_leaves(pred_cls.params))[lora]
        kept = dict(_tree_leaves(ckpt_mod.load_checkpoint(final)["params"]))[lora]
        reset_counts()
        out = pred_cls.predict_batch(val["image"], val["conditioning_images"])
        counts = launch_counts()
        check_launches(failures, "Predictor(checkpoint_path=final).predict_batch", counts, 1,
                       shared_flash_bound=9, flash_attention_bound=26, group_norm=GN_COLD)
        add_counts(total, counts)
        ok = torch.equal(served.float().cpu(), kept.to(served.dtype).float())
        print(f"Predictor(checkpoint_path=<run>/checkpoints/final): statics train_input "
              f"{pred_cls.statics.train_input}, LoRA leaf as saved: {ok}, predict_batch "
              f"{tuple(out.shape)} finite {all_finite(out)}")
        if not ok or out.shape != (TRAIN_BATCH, RES, RES, 3) or not all_finite(out):
            failures.append("the Predictor does not serve the Coach's final file")
        del pred_cls, coach
        torch.cuda.empty_cache()

        # ---- accumulation: nothing moves until the second micro-step ----
        acc = make(config("accumulate", optim__gradient_accumulation_steps=2,
                          optim__lr_warmup_steps=0))
        lora_leaves = [t for n, t in _tree_leaves(acc.params) if "lora_" in n]
        before = [t.clone() for t in lora_leaves]
        gen = torch.Generator(device=dev).manual_seed(6)
        moved = []
        for _ in range(2):
            _, pred = acc.g_step(dev_batch, layer, acc.draw_g(dev_batch, gen))
            acc.d_step(pred, dev_batch["gt"], None, draws=acc.draw_d(dev_batch, gen))
            moved.append(sum(not torch.equal(a, b) for a, b in zip(lora_leaves, before)))
        print(f"gradient_accumulation_steps=2: LoRA leaves moved after micro-step 1: {moved[0]}, "
              f"after micro-step 2: {moved[1]} of {len(lora_leaves)}; G steps applied "
              f"{acc.g_opt.count}, D {acc.d_opt.count}")
        if moved[0] != 0 or moved[1] < 0.9 * len(lora_leaves) or acc.g_opt.count != 1:
            failures.append(f"accumulation: moved {moved}")
        del acc, lora_leaves, before
        torch.cuda.empty_cache()
        for name in ("run", "resumed", "accumulate"):
            shutil.rmtree(tmp / name, ignore_errors=True)

        # ---- files: the train CLI on PNGs through RestoreDataset ----
        missing = [m for m in ("PIL", "cv2") if importlib.util.find_spec(m) is None]
        if missing:
            print(f"PNG training: not run, {missing} do not import on this machine")
        else:
            import cv2
            import PIL
            from PIL import Image

            from instantrestore_tpu_torch.cli import train as cli_train
            from instantrestore_tpu_torch.data.datasets import RestoreDataset

            rng = np.random.default_rng(3)
            for name in ("ann", "ben"):
                d = tmp / "pngs" / "train" / name / "cropped_images"
                d.mkdir(parents=True)
                for i in range(3):
                    Image.fromarray(rng.integers(0, 256, (RES + 32, RES + 32, 3), np.uint8)).save(
                        d / f"{i}.png")
                v = tmp / "pngs" / "val" / name
                (v / "conditioning").mkdir(parents=True)
                for rel in ("degraded.png", "gt.png", "conditioning/0.png", "conditioning/1.png"):
                    Image.fromarray(rng.integers(0, 256, (RES, RES, 3), np.uint8)).save(v / rel)
            ds = RestoreDataset(tmp / "pngs" / "train", max_conditioning_images=N_REFS,
                                resolution=RES, get_id_mats=True, return_degradation_params=True)
            items_s = [synced(lambda: collate([ds[i] for i in range(TRAIN_BATCH)]))[1]
                       for _ in range(2)]
            print(f"RestoreDataset from PNGs: host data per batch of {TRAIN_BATCH} "
                  f"{statistics.median(items_s) * 1e3:.1f} ms in one thread (the degradation "
                  f"chain, {N_REFS} references, ID matrices) [{card}]")
            argv = ["--device", "cuda", f"log.exp_root={tmp}", "log.exp_name=cli",
                    "log.log2wandb=false", f"data.data_root={tmp / 'pngs' / 'train'}",
                    f"data.val_data_root={tmp / 'pngs' / 'val'}",
                    "data.dataset_type=face_restore", f"compute.batch_size={TRAIN_BATCH}",
                    "compute.workers=2", "steps.max_steps=2", "steps.metric_interval=1",
                    "optim.lambda_cycle=1.0", "log.val_vis_count=0"]
            how = "dotted overrides"
            if importlib.util.find_spec("yaml") is not None:
                import yaml

                (tmp / "train.yaml").write_text(yaml.safe_dump({"model": {"lora_rank_unet": 32}}))
                argv += ["--config_path", str(tmp / "train.yaml")]
                how += " and a --config_path"
            reset_counts()
            rc, cli_s = synced(lambda: cli_train.main(argv))
            counts = launch_counts()
            add_counts(total, counts)
            final = ckpt_mod.load_checkpoint(tmp / "cli" / "checkpoints" / "final")
            log = (tmp / "cli" / "logs" / "log.txt").read_text()
            print(f"cli.train.main with {how} on the PNGs (RestoreDataset, loader workers 2): exit "
                  f"{rc}, step {final['step']}, cycle term {'loss_cycle' in log}, {cli_s:.1f} s "
                  f"with the Coach's build, validation and two saves; launches {counts} [{card}]")
            if rc != 0 or final["step"] != 2 or counts["flash_fwd_lse"] != 2 * 36:
                failures.append("cli.train.main did not train its 2 steps")
            print(f"PNG training: ran (Pillow {PIL.__version__}, OpenCV {cv2.__version__})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"coach phase: {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("coach phase failed: " + "; ".join(failures))
    return total


# the dispatch phase: the Coach's multi-step dispatch (each step a replay of
# a captured CUDA graph of the G + D step) against its one-step run
DISPATCH_STEPS, DISPATCH_SPD, DISPATCH_SAVE_AT = 8, 4, 4


def pool_bytes(pool):
    """Bytes the caching allocator holds in a CUDA graph memory pool (None
    where the memory snapshot names no pools)."""
    import torch

    segs = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in seg for seg in segs):
        return None
    return sum(seg["total_size"] for seg in segs if tuple(seg["segment_pool_id"]) == tuple(pool))


def dispatch_phase(card: str):
    """The Coach's steps_per_dispatch at the coach phase's full width and
    data: the one-step run against the dispatch (DISPATCH_SPD steps a
    dispatch, each a graph replay) bit for bit over DISPATCH_STEPS steps, a
    resume of the dispatch run, accumulation under a dispatch, and both
    runs' per-step times, device busy, launch API calls, capture seconds,
    graph pool and peak memory. Returns the launch counts of its paths."""
    import gc
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from instantrestore_tpu_torch.configs.config import TrainConfig
    from instantrestore_tpu_torch.data.datasets import collate
    from instantrestore_tpu_torch.training import coach as coach_mod
    from instantrestore_tpu_torch.training.losses import id_loss as id_mod
    from instantrestore_tpu_torch.training.optim import trainable_leaves

    dev = torch.device("cuda")
    failures, total = [], {}
    t_phase = time.perf_counter()
    scratch = Path(__file__).resolve().parent / "_scratch"
    scratch.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="dispatch_phase_", dir=scratch))
    arcface = id_mod.init_arcface_params(torch.Generator(device=dev).manual_seed(7), device=dev)
    data = (SeededFaces(COACH_TRAIN_ITEMS, 1, True), SeededFaces(COACH_VAL_ITEMS, 2, False))
    val_batches = -(-COACH_VAL_ITEMS // TRAIN_BATCH)
    # the extra steps timed after a run: one dispatch's worth of the training set's batches
    timed = [collate([data[0][i] for i in range(k * TRAIN_BATCH, (k + 1) * TRAIN_BATCH)])
             for k in range(DISPATCH_SPD)]

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def config(name, spd, **over):
        cfg = TrainConfig()
        cfg.compute.batch_size = cfg.compute.test_batch_size = TRAIN_BATCH
        cfg.compute.workers, cfg.compute.test_workers, cfg.compute.seed = 2, 1, 0
        cfg.compute.steps_per_dispatch = spd
        cfg.data.resolution, cfg.data.max_conditioning_images = RES, N_REFS
        cfg.log.exp_root, cfg.log.exp_name, cfg.log.log2wandb = str(tmp), name, False
        cfg.log.val_vis_count, cfg.log.vis_attention = 0, False
        cfg.steps.max_steps, cfg.steps.metric_interval = DISPATCH_STEPS, DISPATCH_SPD
        never = 100 * DISPATCH_STEPS
        cfg.steps.image_interval = cfg.steps.val_interval = never
        cfg.steps.save_interval = DISPATCH_SAVE_AT if spd > 1 else never
        for k, v in over.items():
            section, field = k.split("__")
            setattr(getattr(cfg, section), field, v)
        return cfg

    def make(cfg):
        coach = coach_mod.Coach(cfg, arcface_params=arcface, datasets=data, device=dev)
        coach.logged = []
        log = coach.logger.log_metrics

        def keep(m, prefix="train"):
            coach.logged.append((coach.train_step_num, prefix, dict(m)))
            log(m, prefix)

        coach.logger.log_metrics = keep
        return coach

    def state(coach):
        """A CPU copy of everything a step moves: the trainable G leaves, the
        heads with their u vectors, both optimizers' moments and counts."""
        out = {f"g.{i}": t for i, t in enumerate(trainable_leaves(coach.params, coach.g_mask))}
        out.update({f"heads.{n}": t for n, t in _tree_leaves(coach.disc_heads)})
        for name in ("g_opt", "d_opt"):
            opt = getattr(coach, name)
            for k in ("exp_avg", "exp_avg_sq", "acc_grads"):
                out.update({f"{name}.{k}.{i}": t for i, t in enumerate(getattr(opt, k))})
            out[f"{name}.counts"] = torch.tensor([opt.count, opt.mini_step])
        return {k: v.detach().cpu().clone() for k, v in out.items()}

    def differ(got, want):
        return sorted(k for k in want if not torch.equal(got[k], want[k]))

    def train(coach):
        with deterministic_cudnn():
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            _, secs = synced(coach.train)
            return launch_counts(), secs, torch.cuda.max_memory_allocated() / 2**30

    def last_losses(coach):
        train_logs = [m for _, prefix, m in coach.logged if prefix == "train"]
        return {k: v for k, v in train_logs[-1].items() if k != "steps_per_sec"}

    def free():
        gc.collect()  # a Coach's logger hook holds it in a cycle
        torch.cuda.empty_cache()

    def measure(coach, spd):
        """Wall ms a step over a few more steps (one dispatch, or two steps
        one a call), then the device busy and launch API calls a step from
        the profiler over one dispatch or one step. No interval fires."""
        coach.cfg.steps.metric_interval = coach.cfg.steps.save_interval = 10**6
        coach._t0, coach._steps_since_metric = time.time(), 0
        gen = torch.Generator(device=dev)

        def steps(n):
            if spd == 1:
                for b in timed[:n]:
                    gen.manual_seed(coach._step_seed(coach.train_step_num))
                    coach._run_single_step(b, gen)
            else:
                coach._run_dispatch(timed[:n], gen)

        n_timed, n_profiled = (2, 1) if spd == 1 else (len(timed), len(timed))
        with deterministic_cudnn():
            _, secs = synced(lambda: steps(n_timed))
            api = {}
            busy = profile_run(lambda: steps(n_profiled), f"{n_profiled} Coach step(s), "
                               f"steps_per_dispatch {spd}", card, top=6, api_calls=api)
        return dict(ms=secs / n_timed * 1e3, n=n_timed,
                    busy=None if busy is None else round(busy / n_profiled, 2),
                    api={k: v / n_profiled for k, v in sorted(api.items())})

    try:
        free_bytes = shutil.disk_usage(tmp).free
        if free_bytes < COACH_DISK_BYTES:  # up to four 4.1 GB checkpoints at once
            raise RuntimeError(f"dispatch phase needs {COACH_DISK_BYTES / 1e9:.0f} GB free under "
                               f"{tmp}, has {free_bytes / 1e9:.1f}")
        # ---- the one-step run ----
        eager = make(config("eager", 1))
        counts_e, secs_e, peak_e = train(eager)
        want_state, want_losses = state(eager), last_losses(eager)
        steps_e = [s for s, prefix, _ in eager.logged if prefix == "train"]
        m_e = measure(eager, 1)
        del eager
        free()
        shutil.rmtree(tmp / "eager", ignore_errors=True)

        # ---- the dispatch run ----
        disp = make(config("dispatch", DISPATCH_SPD))
        counts_d, secs_d, peak_d = train(disp)
        got_state, got_losses = state(disp), last_losses(disp)
        steps_d = [s for s, prefix, _ in disp.logged if prefix == "train"]
        captured = list(disp._static_steps.values())
        capture_s = [round(s.capture_seconds, 3) for s in captured]
        pool = pool_bytes(disp.graph_pool)
        m_d = measure(disp, DISPATCH_SPD)
        n_static = len(disp._static_steps)
        del captured
        del disp
        free()

        per_step = dict(flash_fwd_lse=36, flash_bwd_dq=18, flash_bwd_dkv=18,
                        flash_attention_bound=17, group_norm=GN_CAPTURE)
        for what, counts in (("one-step run", counts_e), ("dispatch run", counts_d)):
            want = {k: n * DISPATCH_STEPS for k, n in per_step.items()}
            want["flash_attention_bound"] += 26 * val_batches  # train()'s own validation
            want["group_norm"] += GN_COLD * val_batches
            want["shared_flash_bound"] = 9 * val_batches
            check_launches(failures, f"Coach.train, {what}: {DISPATCH_STEPS} G + D steps and a "
                           f"validation of {val_batches} batches", counts, 1, **want)
            add_counts(total, counts)
        bad = differ(got_state, want_state)
        same_losses = got_losses == want_losses
        print(f"dispatch ({DISPATCH_SPD} steps a dispatch, {n_static} captured step) against "
              f"the one-step run after {DISPATCH_STEPS} steps: {len(want_state) - len(bad)} of "
              f"{len(want_state)} tensors bit-equal (trainable leaves, heads with u, both "
              f"optimizers' moments and counts){'; differ: ' + str(bad[:6]) if bad else ''}; "
              f"last losses {'bit-equal' if same_losses else 'DIFFER'} {got_losses}; metrics "
              f"logged at {steps_d} and {steps_e}")
        if bad or not same_losses or steps_d != steps_e or n_static != 1:
            failures.append(f"the dispatch run differs from the one-step run: {bad[:6]}, "
                            f"losses {got_losses} against {want_losses}")
        for what, secs, peak, m in (("steps_per_dispatch 1", secs_e, peak_e, m_e),
                                    (f"steps_per_dispatch {DISPATCH_SPD}", secs_d, peak_d, m_d)):
            print(f"Coach, {what}: train() {secs:.1f} s ({DISPATCH_STEPS} steps, a validation, "
                  f"its saves); {m['ms']:.1f} ms wall a step over {m['n']} more, device "
                  f"busy {m['busy']} ms a step, launch API calls a step {m['api']}; peak "
                  f"{peak:.2f} GiB [{card}]")
        print(f"dispatch capture: {capture_s} s; graph pool "
              f"{'not measured' if pool is None else f'{pool / 2**30:.2f} GiB'} [{card}]")

        # ---- a resume of the dispatch run from its step-4 file ----
        ck = tmp / "dispatch" / "checkpoints" / f"step_{DISPATCH_SAVE_AT}"
        resumed = make(config("resumed", DISPATCH_SPD, log__resume_from=str(ck),
                              steps__save_interval=100 * DISPATCH_STEPS))
        counts_r, _, _ = train(resumed)
        add_counts(total, counts_r)
        bad = differ(state(resumed), got_state)
        print(f"dispatch run resumed from step_{DISPATCH_SAVE_AT} to step "
              f"{resumed.train_step_num}: {len(got_state) - len(bad)} of {len(got_state)} "
              f"tensors bit-equal to the uninterrupted dispatch run")
        if bad or resumed.train_step_num != DISPATCH_STEPS:
            failures.append(f"the resumed dispatch run differs: {bad[:6]}")
        del resumed
        free()
        for name in ("dispatch", "resumed"):
            shutil.rmtree(tmp / name, ignore_errors=True)

        # ---- accumulation over 2 micro-steps under a dispatch of 4 ----
        ends = {}
        for spd in (1, DISPATCH_SPD):
            acc = make(config(f"accumulate{spd}", spd, optim__gradient_accumulation_steps=2,
                              optim__lr_warmup_steps=0,
                              steps__save_interval=100 * DISPATCH_STEPS))
            acc._t0, acc._steps_since_metric = time.time(), 0
            gen = torch.Generator(device=dev)
            with deterministic_cudnn():
                reset_counts()
                if spd == 1:
                    for b in timed:
                        gen.manual_seed(acc._step_seed(acc.train_step_num))
                        acc._run_single_step(b, gen)
                else:
                    acc._run_dispatch(timed, gen)
                torch.cuda.synchronize()
                counts = launch_counts()
            check_launches(failures, f"{len(timed)} accumulating steps, steps_per_dispatch {spd}",
                           counts, len(timed), **per_step)
            add_counts(total, counts)
            ends[spd] = (state(acc), acc.g_opt.count, len(acc._static_steps))
            del acc
            free()
        bad = differ(ends[DISPATCH_SPD][0], ends[1][0])
        print(f"gradient_accumulation_steps=2, {len(timed)} steps: dispatch ({ends[DISPATCH_SPD][2]}"
              f" captured steps, {ends[DISPATCH_SPD][1]} applied) against one step a call "
              f"({ends[1][1]} applied): {len(ends[1][0]) - len(bad)} of {len(ends[1][0])} "
              f"tensors bit-equal")
        if bad or ends[DISPATCH_SPD][1:] != (2, 2) or ends[1][1] != 2:
            failures.append(f"accumulation under a dispatch differs: {bad[:6]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"dispatch phase: {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("dispatch phase failed: " + "; ".join(failures))
    return total


# the parallel phase: DDP training over processes and cards, the
# multi-device engine, and the device guard of every kernel launch
DDP_STEPS = 2  # G + D steps compared across ranks; one more is profiled
DDP_LIMIT_S = 420  # wall clock of one group of worker processes, then they are killed
DDP_COLLECTIVE_S = 300  # a collective that waits longer raises in the worker
DDP_LOSS_REL_TOL = 1e-3
# the ranks' first-step gradient against the witness (one process summing
# the two halves' shares: the ranks' arithmetic without the collectives),
# by leaf group; and against the one process at batch 2, at most this times
# the witness's own distance from it (batch 1 and batch 2 take other
# cuDNN / cuBLAS algorithms)
DDP_WITNESS_REL_TOL = 1e-5
DDP_BATCH_FACTOR = 1.5
PAR_SERVE_MEAN_ABS = 2e-2  # the multi-device engine against the one-device engine


def ddp_coach(spec: dict, dev, tag: str, accumulation: int = 1, steps_per_dispatch: int = 1):
    """The parallel phase's Coach on ``dev`` (the coach phase's config and
    seeded data, the global batch TRAIN_BATCH) and its build seconds."""
    import torch

    from instantrestore_tpu_torch.configs.config import TrainConfig
    from instantrestore_tpu_torch.training import coach as coach_mod
    from instantrestore_tpu_torch.training.losses import id_loss as id_mod

    cfg = TrainConfig()
    cfg.compute.batch_size = cfg.compute.test_batch_size = TRAIN_BATCH
    cfg.compute.workers, cfg.compute.test_workers, cfg.compute.seed = 1, 1, 0
    cfg.data.resolution, cfg.data.max_conditioning_images = RES, N_REFS
    cfg.log.exp_root, cfg.log.exp_name, cfg.log.log2wandb = spec["tmp"], tag, False
    cfg.steps.max_steps = DDP_STEPS + 1
    cfg.steps.metric_interval = 1
    cfg.steps.image_interval = cfg.steps.val_interval = cfg.steps.save_interval = 1000
    cfg.optim.gradient_accumulation_steps = accumulation
    cfg.compute.steps_per_dispatch = steps_per_dispatch
    arcface = id_mod.init_arcface_params(torch.Generator(device=dev).manual_seed(7), device=dev)
    data = (SeededFaces(COACH_TRAIN_ITEMS, 1, True), SeededFaces(COACH_VAL_ITEMS, 2, False))
    t0 = time.perf_counter()
    coach = coach_mod.Coach(cfg, arcface_params=arcface, datasets=data, device=dev)
    torch.cuda.synchronize(dev)
    return coach, time.perf_counter() - t0


def split_witness_grads(coach, gen, ranks: int = 2) -> list:
    """The first G step's gradient as ``ranks`` ranks compute it, in one
    process without a process group: the global batch and its draws cut to
    each rank's rows (``local_rows``), each half's loss its share under the
    global batch's counts, and the halves' gradients summed in rank order
    (the all-reduce's sum). ``coach`` accumulates over ``ranks`` micro-steps,
    so no half moves the params before the next. Returns the gradient."""
    import torch

    from instantrestore_tpu_torch.data.datasets import to_torch_batch
    from instantrestore_tpu_torch.parallel.distributed import local_rows
    from instantrestore_tpu_torch.training.losses.composite import loss_counts
    from instantrestore_tpu_torch.training.optim import trainable_leaves

    if coach.cfg.optim.gradient_accumulation_steps != ranks or coach.group is not None:
        raise ValueError("the witness runs without a group and accumulates over the ranks")
    batch, layer = to_torch_batch(next(iter(coach.train_loader)), coach.device)
    gen.manual_seed(coach._step_seed(0))
    draws = coach.draw_g(batch, gen)
    b = batch["gt"].shape[0]
    counts = loss_counts(batch)
    g_loss = coach._g_loss
    coach._g_loss = lambda out, part, ocfg: g_loss(out, part, ocfg, counts=counts)
    leaves = trainable_leaves(coach.params, coach.g_mask)
    total = None
    for r in range(ranks):
        rows = {k: v for k, v in draws.items() if k in ("noise", "gan_draws", "cycle_noise")}
        coach.g_step(local_rows(batch, b, r, ranks), layer,
                     dict(draws, **local_rows(rows, b, r, ranks)))
        grads = [t.grad.detach().clone() for t in leaves]
        total = grads if total is None else [a + g for a, g in zip(total, grads)]
    return total


def ddp_run(spec: dict, dev, tag: str, card: str) -> dict:
    """DDP_STEPS G + D steps of the Coach at full width (the coach phase's
    config and seeded data, the global batch TRAIN_BATCH) on ``dev``, in the
    process group if one was joined, through Coach._run_single_step (the step
    train() takes), each G and D step timed; then one more step profiled and,
    in a group, the G gradient's all-reduce timed. Returns the record: global
    losses, ms, device busy, all-reduce ms and bytes, peak memory, launch
    counts and a SHA-256 of the trainable leaves and heads after the
    compared steps; the first step's gradient is saved where ``grads`` says."""
    import gc
    import hashlib

    import torch

    from instantrestore_tpu_torch.parallel import distributed as pdist
    from instantrestore_tpu_torch.training.optim import trainable_leaves

    coach, build_s = ddp_coach(spec, dev, tag)
    times = {"g_step": [], "d_step": []}

    def timed(name):
        fn = getattr(coach, name)

        def run(*a, **k):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize(dev)
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    coach.g_step, coach.d_step = timed("g_step"), timed("d_step")
    logged = []
    coach.logger.log_metrics = lambda m, prefix="train": logged.append(dict(m))
    ids = {id(t) for t in trainable_leaves(coach.params, coach.g_mask)}
    names = [n for n, t in _tree_leaves(coach.params) if id(t) in ids]
    leaves = trainable_leaves(coach.params, coach.g_mask)
    gen = torch.Generator(device=dev)
    batches = iter(coach.train_loader)
    coach._t0, coach._steps_since_metric = time.time(), 0  # what train() sets up
    torch.cuda.reset_peak_memory_stats(dev)
    with deterministic_cudnn():
        reset_counts()
        for step in range(DDP_STEPS):
            gen.manual_seed(coach._step_seed(step))
            coach._run_single_step(next(batches), gen)
            if step == 0 and spec.get("grads"):
                torch.save([t.grad.detach().cpu() for t in leaves], spec["grads"])
        counts = launch_counts()
        if coach.group is not None:
            coach.check_replicas_agree()
        digest = hashlib.sha256()  # the leaves that train: the G's and the heads
        for t in leaves + [t for _, t in _tree_leaves(coach.disc_heads)]:
            digest.update(t.detach().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
        gen.manual_seed(coach._step_seed(DDP_STEPS))
        busy = profile_run(lambda: coach._run_single_step(next(batches), gen),
                           f"{tag} rank {pdist.process_index()}: one G + D step", card, top=0)
    ar_ms, ar_bytes = None, None
    if coach.group is not None:
        grads = [t.grad.detach().clone() for t in leaves]
        pdist.all_reduce_sum_(grads, coach.group)
        ms = []
        for _ in range(3):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            ar_bytes = pdist.all_reduce_sum_(grads, coach.group)
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        ar_ms = statistics.median(ms)
    train = [m for m in logged if "loss" in m]
    rec = dict(tag=tag, rank=pdist.process_index(), world=pdist.process_count(),
               device=str(dev), build_s=build_s, loss=[m["loss"] for m in train[:DDP_STEPS]],
               loss_d=[m["loss_d"] for m in train[:DDP_STEPS]], g_ms=times["g_step"],
               d_ms=times["d_step"], busy_ms=busy, allreduce_ms=ar_ms,
               allreduce_bytes=ar_bytes,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30, counts=counts,
               digest=digest.hexdigest(), names=names if spec.get("grads") else None)
    if spec.get("dispatch"):
        del coach, leaves
        gc.collect()  # the timed steps hold the Coach in a cycle
        torch.cuda.empty_cache()
        rec.update(ddp_dispatch(spec, dev, tag))
    return rec


def ddp_dispatch(spec: dict, dev, tag: str) -> dict:
    """A fresh Coach of the same seed at steps_per_dispatch DDP_STEPS, in the
    same process group, runs the DDP_STEPS steps of ddp_run as one dispatch
    (a captured graph of the G + D step with its all-reduces, replayed).
    Returns its last losses, launches, SHA-256 of the trainable leaves and
    heads (ddp_run's digest), the dispatch's wall ms and capture seconds."""
    import gc
    import hashlib

    import torch

    from instantrestore_tpu_torch.training.optim import trainable_leaves

    coach, _ = ddp_coach(spec, dev, f"{tag}_dispatch", steps_per_dispatch=DDP_STEPS)
    logged = []
    coach.logger.log_metrics = lambda m, prefix="train": logged.append(dict(m))
    batches = iter(coach.train_loader)
    coach._t0, coach._steps_since_metric = time.time(), 0
    with deterministic_cudnn():
        reset_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        coach._run_dispatch([next(batches) for _ in range(DDP_STEPS)], torch.Generator(device=dev))
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
    if coach.group is not None:
        coach.check_replicas_agree()
    digest = hashlib.sha256()
    for t in (trainable_leaves(coach.params, coach.g_mask)
              + [t for _, t in _tree_leaves(coach.disc_heads)]):
        digest.update(t.detach().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    rec = dict(dispatch_loss=logged[-1]["loss"], dispatch_loss_d=logged[-1]["loss_d"],
               dispatch_counts=counts, dispatch_digest=digest.hexdigest(), dispatch_ms=ms,
               dispatch_capture_s=[s.capture_seconds for s in coach._static_steps.values()])
    # the graphs (and their collectives) go before the caller leaves the group
    coach._static_steps.clear()
    del coach
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def ddp_worker(path: str) -> int:
    """One process of the parallel phase (``--ddp-worker spec.json``): mode
    ``one`` runs ddp_run without a process group and then in an NCCL group
    of world size 1, then saves the split witness's gradient
    (``split_witness_grads``) where ``spec['witness']`` says; otherwise it joins the group of ``spec`` (gloo or NCCL,
    world, rank, card) and runs ddp_run there. Writes the records to
    ``spec['out']``."""
    import datetime
    import gc

    import torch

    from instantrestore_tpu_torch.parallel import distributed as pdist

    spec = json.loads(open(path).read())
    dev = torch.device(spec["device"])
    torch.cuda.set_device(dev)
    card = card_line()
    timeout = datetime.timedelta(seconds=DDP_COLLECTIVE_S)
    out = []
    if spec["mode"] == "one":
        out.append(ddp_run(dict(spec, dispatch=False), dev, "none", card))
        spec["grads"] = None
        gc.collect()  # the first Coach (its timed steps hold it in a cycle)
        torch.cuda.empty_cache()
        pdist.init_distributed(f"file://{spec['store']}", 1, 0, [dev.index], backend="nccl",
                               timeout=timeout)
        out.append(ddp_run(spec, dev, "nccl1", card))
        torch.distributed.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
        coach, _ = ddp_coach(spec, dev, "witness", accumulation=2)
        with deterministic_cudnn():
            grads = split_witness_grads(coach, torch.Generator(device=dev))
        torch.save([g.cpu() for g in grads], spec["witness"])
    else:
        pdist.init_distributed(f"file://{spec['store']}", spec["world"], spec["rank"],
                               [dev.index], backend=spec["backend"], timeout=timeout)
        out.append(ddp_run(spec, dev, spec["mode"], card))
        torch.distributed.destroy_process_group()
    with open(spec["out"], "w") as f:
        json.dump(out, f)
    return 0


def run_workers(specs: list, tmp, limit: float) -> list:
    """Start one ``--ddp-worker`` process per spec, all at once; wait for all
    of them within ``limit`` seconds of wall clock. A worker that exits
    non-zero, or any still running at the limit, has every worker killed and
    fails the phase. Prints each worker's output; returns their records."""
    import os as _os

    procs = []
    for spec in specs:
        spec.update(out=str(tmp / f"{spec['name']}.out.json"), tmp=str(tmp))
        path = tmp / f"{spec['name']}.json"
        path.write_text(json.dumps(spec))
        log = open(tmp / f"{spec['name']}.log", "w")
        procs.append((spec["name"], subprocess.Popen(
            [sys.executable, _os.path.abspath(__file__), "--ddp-worker", str(path)],
            stdout=log, stderr=subprocess.STDOUT, env=dict(_os.environ, PYTHONUNBUFFERED="1")),
            log))
    deadline, failed = time.monotonic() + limit, []
    try:
        while any(p.poll() is None for _, p, _ in procs):
            bad = [n for n, p, _ in procs if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed.append(f"workers {bad} failed" if bad else f"workers over {limit} s")
                break
            time.sleep(0.5)
    finally:
        for _, p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    for name, p, _ in procs:
        text = (tmp / f"{name}.log").read_text()
        lines = [ln for ln in text.splitlines() if "Warning" not in ln and ln.strip()]
        print(f"--- worker {name} (exit {p.returncode}):")
        for ln in lines[-40:]:
            print(f"  [{name}] {ln}")
        if p.returncode != 0 and not failed:
            failed.append(f"worker {name} exit {p.returncode}")
    if failed:
        raise AssertionError("parallel phase: " + "; ".join(failed))
    return [rec for spec in specs for rec in json.loads(open(spec["out"]).read())]


def device_guard_check(card: str, failures: list):
    """Every kernel at one 512 px shape (the (10 heads, 1024 tokens) shared
    layer, 4 references; d=64; GroupNorm at the UNet's 32 x 32 x 640 with
    a [B, C] bias term and SiLU) on cuda:1, launched from this thread at
    current device 0, against the same launch on cuda:0: bit for bit."""
    import torch

    from instantrestore_tpu_torch.ops import flash_vjp as fv
    from instantrestore_tpu_torch.ops import primitives as prims
    from instantrestore_tpu_torch.ops import shared_attention as sa

    if torch.cuda.device_count() < 2:
        print("device guard: this check needs a second card (1 visible): not run; the CPU "
              "test holds every launch site to its tensor's device")
        return
    torch.cuda.set_device(0)
    g = torch.Generator(device="cuda:0").manual_seed(11)
    b, h, s, d, n = 2, 10, 1024, 64, N_REFS

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda:0").to(dtype)

    q, k, v, do = rnd(b, h, s, d), rnd(b, h, s, d), rnd(b, h, s, d), rnd(b, h, s, d)
    rk, rv = rnd(b, n, h, s, d), rnd(b, n, h, s, d)
    aff = torch.stack([1 + 0.1 * rnd(b, h, n, d, dtype=torch.float32),
                       0.1 * rnd(b, h, n, d, dtype=torch.float32)], dim=3)
    kmax = sa.key_norm_max(rk, (1, 3))
    ids = torch.tensor([1, 0], device="cuda:0")
    sc = d ** -0.5
    out0, lse0 = fv.flash_fwd_lse(q, k, v, scale=sc)
    delta0 = (do.float() * out0.float()).sum(-1)
    calls = {
        "flash_attention_bound": lambda t: sa.flash_attention(t["q"], t["k"], t["v"], scale=sc,
                                                              algo="bound"),
        "flash_attention_online": lambda t: sa.flash_online(t["q"], t["k"], t["v"], scale=sc),
        "shared_identity_attention": lambda t: sa.shared_identity(
            t["q"], t["rk"], t["rv"], t["aff"], t["kmax"], t["ids"], scale=sc),
        "shared_flash_bound": lambda t: sa.shared_flash_bound(
            t["q"], t["k"], t["v"], t["rk"], t["rv"], t["aff"], t["kmax"], scale=sc,
            include_input=True),
        "shared_online": lambda t: sa.shared_online(
            t["q"], t["k"], t["v"], t["rk"], t["rv"], t["aff"], scale=sc, include_input=True),
        "shared_online_pair": lambda t: sa.shared_online_pair(
            t["q"], t["k"], t["v"], t["rk"], t["rv"], t["aff"], scale=sc, include_input=True),
        "flash_fwd_lse": lambda t: fv.flash_fwd_lse(t["q"], t["k"], t["v"], scale=sc),
        "flash_bwd_dq": lambda t: fv.flash_bwd_dq(t["q"], t["k"], t["v"], t["do"], t["lse"],
                                                  t["delta"], scale=sc),
        "flash_bwd_dkv": lambda t: fv.flash_bwd_dkv(t["q"], t["k"], t["v"], t["do"], t["lse"],
                                                    t["delta"], scale=sc),
        "group_norm": lambda t: prims.group_norm(
            {"weight": t["gn_w"], "bias": t["gn_b"]}, t["gn_x"], in_bias=(t["gn_t"],),
            act="silu"),
    }
    on0 = dict(q=q, k=k, v=v, do=do, rk=rk, rv=rv, aff=aff, kmax=kmax, ids=ids, lse=lse0,
               delta=delta0, gn_x=rnd(b, 32, 32, 640), gn_t=rnd(b, 640),
               gn_w=1 + 0.1 * rnd(640, dtype=torch.float32),
               gn_b=0.1 * rnd(640, dtype=torch.float32))
    on1 = {key: x.to("cuda:1") for key, x in on0.items()}
    same = []
    for name, call in calls.items():
        a = call(on0)
        assert torch.cuda.current_device() == 0
        c = call(on1)  # this thread's current device is still 0
        a = a if isinstance(a, tuple) else (a,)
        c = c if isinstance(c, tuple) else (c,)
        if all(y.device == torch.device("cuda:1") and torch.equal(x, y.to("cuda:0"))
               for x, y in zip(a, c)):
            same.append(name)
        else:
            failures.append(f"device guard: {name} on cuda:1 differs from cuda:0")
    print(f"device guard: {len(same)} of {len(calls)} kernels on cuda:1 from a thread at "
          f"device 0 equal their cuda:0 launch bit for bit [{card}]")


def parallel_serving(card: str, failures: list) -> dict:
    """ServingEngine(devices=) on every card (two shares of the one card
    when there is one; a worker process for each device after the first)
    against the one-device engine: onboarding 16 identities (seconds on
    both; every device's cache bit-equal to the one-device cache), warm and
    cold restores of batch 16 (mean-abs, launches summed over the processes,
    faces/sec) and, with two cards or more, of 16 rows a card; a batch that
    does not divide refused; no worker left after close(). Returns the
    launch counts."""
    import multiprocessing

    import torch

    from instantrestore_tpu_torch.inference.serving import ServingEngine
    from instantrestore_tpu_torch.models.restorer import (
        RestorerStatics,
        init_restorer_params,
        serving_bundle,
    )

    n_cards = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(n_cards)] if n_cards > 1 else ["cuda:0", "cuda:0"]
    statics = RestorerStatics(use_adain=True, train_input=False)
    params = serving_bundle(init_restorer_params(
        torch.Generator(device="cuda:0").manual_seed(0), statics, lora_rank_unet=32,
        lora_rank_vae=32, device="cuda:0"), statics)
    one = ServingEngine(params, statics, device="cuda:0")
    children = set(multiprocessing.active_children())
    t0 = time.perf_counter()
    multi = ServingEngine(params, statics, devices=devices)
    start_s = time.perf_counter() - t0
    n_dev, total = len(devices), {}
    host = torch.Generator().manual_seed(1)
    refs = torch.randint(0, 256, (N_IDENT, N_REFS, RES, RES, 3), dtype=torch.uint8, generator=host)
    # with two cards or more also 16 rows a card: the batch-16 inputs once a card
    big = BATCH * n_dev if n_cards > 1 else BATCH
    reps = big // BATCH
    images = torch.randint(0, 256, (BATCH, RES, RES, 3), dtype=torch.uint8,
                           generator=host).repeat(reps, 1, 1, 1)
    ids = torch.tensor([3, 7, 7, 0, 15, 2, 3, 9, 12, 7, 1, 0, 5, 15, 8, 3]).repeat(reps)
    lat = RES // 8
    onboard_noise = {k: torch.randn((N_IDENT, N_REFS, lat, lat, 4), generator=host)
                     for k in ("latent", "diffusion")}
    noise = {k: torch.randn((BATCH, lat, lat, 4), generator=host).repeat(reps, 1, 1, 1)
             for k in ("latent", "diffusion")}
    cold_noise = dict(noise)
    for k, v in onboard_noise.items():
        cold_noise[f"cond_{k}"] = v[ids].reshape(big * N_REFS, lat, lat, 4)
    cold_refs = refs[ids]
    print(f"multi-device engine on {devices}: {n_dev - 1} worker processes started and given "
          f"their replicas in {start_s:.1f} s [{card}]")

    c1, onboard_1 = _synced_all(lambda: one.onboard(refs, noise=onboard_noise))
    reset_counts()
    c2, onboard_s = _synced_all(lambda: multi.onboard(refs, noise=onboard_noise))
    check_launches(failures, f"multi-device onboarding of {N_IDENT} identities on {devices}",
                   launch_counts(), N_IDENT, flash_attention_bound=17, group_norm=GN_CAPTURE)
    add_counts(total, launch_counts())
    caches = multi.device_caches()
    same = [all(torch.equal(getattr(a, f), getattr(b, f).to(getattr(a, f).device))
                for a, b in zip(c1, c) for f in ("rk", "rv", "content_mean", "content_std", "kmax"))
            for c in caches]
    print(f"multi-device onboarding ({N_IDENT} identities split over {devices}): {onboard_s:.3f} s "
          f"beside one device's {onboard_1:.3f} s; the cache of each of the {len(caches)} devices "
          f"{'bit-equal to' if all(same) else 'DIFFERS from'} the one-device cache {same} [{card}]")
    if not all(same) or len(caches) != n_dev or caches[0] is not c2:
        failures.append("a multi-device onboarded cache differs from the one-device cache")
    del caches

    def rows(n):
        sel = slice(0, n)
        return (images[sel], ids[sel], {k: v[sel] for k, v in noise.items()},
                {k: v[:n * N_REFS] if k.startswith("cond_") else v[sel]
                 for k, v in cold_noise.items()}, cold_refs[sel])

    sizes = [BATCH] + ([big] if big != BATCH else [])
    ref = {}  # the one-device engine's output and time of each path
    for what in ("warm", "cold"):
        im, ii, nz, cnz, cr = rows(BATCH)
        run1 = ((lambda: one.restore(im, ii, noise=nz)) if what == "warm"
                else (lambda: one.restore_cold(im, cr, noise=cnz)))
        out1, _ = _synced_all(run1)  # first calls: cuDNN's set-up
        ref[what] = out1, statistics.median(_synced_all(run1)[1] for _ in range(RESTORE_RUNS))
    # its graphs keep each captured forward's activations (a cold batch of
    # 16: ~17 GB); dropped before the multi-device engine's processes fill
    # the card (one card holds both devices' shares)
    one.close()
    torch.cuda.empty_cache()
    for what in ("warm", "cold"):
        out1, t1 = ref[what]
        for n in sizes:
            im, ii, nz, cnz, cr = rows(n)
            runm = ((lambda: multi.restore(im, ii, noise=nz)) if what == "warm"
                    else (lambda: multi.restore_cold(im, cr, noise=cnz)))
            per = (dict(shared_identity_attention=9 * n_dev, flash_attention_bound=9 * n_dev,
                        group_norm=GN_WARM * n_dev)
                   if what == "warm" else
                   dict(shared_flash_bound=9 * n_dev, flash_attention_bound=26 * n_dev,
                        group_norm=GN_COLD * n_dev))
            _synced_all(runm)  # the workers' cuDNN set-up at this batch
            reset_counts()
            outm, _ = _synced_all(runm)
            counts = launch_counts()
            check_launches(failures, f"one multi-device {what} restore of batch {n} on {devices}",
                           counts, 1, **per)
            add_counts(total, counts)
            diff = float((outm[:BATCH].float() - out1.float()).abs().mean())
            if n > BATCH:  # each card's 16 rows are the batch-16 inputs
                diff = max(diff, float((outm.float().reshape(n // BATCH, BATCH, *outm.shape[1:])
                                        - out1.float()).abs().mean()))
            tm = statistics.median(_synced_all(runm)[1] for _ in range(RESTORE_RUNS))
            print(f"multi-device {what} restore batch {n} ({n // n_dev} rows a device) on "
                  f"{devices}: mean-abs {diff:.5f} against one device (tol {PAR_SERVE_MEAN_ABS}); "
                  f"{n / tm:.2f} faces/sec ({tm * 1e3:.1f} ms) beside one device's "
                  f"{BATCH / t1:.2f} at batch {BATCH} ({t1 * 1e3:.1f} ms): "
                  f"{(n / tm) / (BATCH / t1):.2f}x [{card}]")
            if outm.device != torch.device("cuda:0") or not torch.isfinite(outm).all() \
                    or diff > PAR_SERVE_MEAN_ABS or tuple(outm.shape) != (n, RES, RES, 3):
                failures.append(f"multi-device {what} restore of batch {n}: mean-abs {diff}, "
                                f"on {outm.device}")
            del outm
    try:
        multi.restore(images[:3], ids[:3], noise={k: v[:3] for k, v in noise.items()})
        failures.append("a batch that does not divide over the devices did not raise")
    except ValueError as e:
        print(f"batch 3 on {n_dev} devices raises: {e}")
    multi.close()
    left = set(multiprocessing.active_children()) - children
    print(f"after close(): {len(left)} worker processes left")
    if left:
        failures.append(f"worker processes outlive close(): {left}")
    del one, multi
    torch.cuda.empty_cache()
    add_counts(total, parallel_int8(card, failures, params, statics, devices, refs, onboard_noise,
                                    images[:BATCH], ids[:BATCH],
                                    {k: v[:BATCH] for k, v in noise.items()}))
    return total


def parallel_int8(card: str, failures: list, params, statics, devices, refs, onboard_noise,
                  images, ids, noise) -> dict:
    """An int8 engine on ``devices`` against the one-device int8 engine
    (both quantized from the same fp32 bundle): every device's cache
    bit-equal to the one-device cache, ``calibrate_int8`` on the same batch
    giving every conv the same scale (the workers get them through their
    calibrate command), and a calibrated warm restore whose rows on each
    device are held against the one-device engine's restore of those rows
    (mean-abs 2e-2; bit-equality printed). Returns the launch counts."""
    import multiprocessing

    import torch

    from instantrestore_tpu_torch.inference.serving import ServingEngine

    n_dev, total = len(devices), {}
    children = set(multiprocessing.active_children())
    one = ServingEngine(params, statics, device="cuda:0", int8_decoder=True, int8_unet=True)
    multi = ServingEngine(params, statics, devices=devices, int8_decoder=True, int8_unet=True)
    for eng in (one, multi):
        eng.onboard(refs, noise=onboard_noise)
    same = [all(torch.equal(getattr(a, f), getattr(b, f).to(getattr(a, f).device))
                for a, b in zip(one.kv_cache, c) for f in ("rk", "rv", "content_mean",
                                                          "content_std", "kmax"))
            for c in multi.device_caches()]
    cal = [(images, ids, noise)]
    n_one, n_multi = one.calibrate_int8(cal), multi.calibrate_int8(cal)
    scales = [[p["a_scale"] for p in int8_convs(e.params)] for e in (one, multi)]
    same_scales = len(scales[0]) == len(scales[1]) == n_one and all(
        torch.equal(a, b) for a, b in zip(*scales))
    reset_counts()
    outm, tm = _synced_all(lambda: multi.restore(images, ids, noise=noise))
    counts = launch_counts()
    check_launches(failures, f"one multi-device int8 warm restore on {devices}", counts, 1,
                   shared_identity_attention=9 * n_dev, flash_attention_bound=9 * n_dev,
                   group_norm=GN_WARM * n_dev)
    add_counts(total, counts)
    per = BATCH // n_dev
    rows = torch.cat([one.restore(images[j * per:(j + 1) * per], ids[j * per:(j + 1) * per],
                                  noise={k: v[j * per:(j + 1) * per] for k, v in noise.items()})
                      for j in range(n_dev)])
    diff = mean_abs(outm, rows)
    whole = mean_abs(outm, one.restore(images, ids, noise=noise))
    print(f"multi-device int8 engine on {devices}: caches bit-equal to one device's {same}; "
          f"{n_multi} convs calibrated ({n_one} on one device), scales "
          f"{'equal' if same_scales else 'DIFFERENT'}; calibrated warm restore batch {BATCH} "
          f"in {tm * 1e3:.1f} ms: each device's rows against one device's restore of those "
          f"rows mean-abs {diff:.6f} ({'bit-equal' if torch.equal(outm, rows) else 'not bit-equal'}"
          f"; tol {PAR_SERVE_MEAN_ABS}), against one device's batch-{BATCH} restore {whole:.5f} "
          f"[{card}]")
    if not all(same) or not same_scales or n_multi != n_one or diff > PAR_SERVE_MEAN_ABS \
            or not torch.isfinite(outm).all():
        failures.append(f"the multi-device int8 engine differs from one device: caches {same}, "
                        f"scales equal {same_scales}, mean-abs {diff}")
    multi.close()
    left = set(multiprocessing.active_children()) - children
    if left:
        failures.append(f"int8 worker processes outlive close(): {left}")
    return total


def _synced_all(fn):
    """fn() with every card synchronised before and after; (result, seconds)."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    t0 = time.perf_counter()
    out = fn()
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    return out, time.perf_counter() - t0


def parallel_phase(card: str):
    """Training and serving across processes and cards. The device guard
    (two cards or more). DDP at full width in worker processes, each with a
    wall-clock limit: one process without a group and then in an NCCL group
    of world size 1 (bit for bit the same), two ranks on the one card over
    gloo with CUDA tensors (NCCL refuses a card twice), and with two cards
    or more two NCCL ranks on cuda:0 and cuda:1; each against the one
    process on the same global batch and draws (loss, gradients by leaf
    group, ranks bit-identical). Then the multi-device engine. Returns the
    launch counts of its paths (the ranks' training steps among them)."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    failures, total = [], {}
    t_phase = time.perf_counter()
    device_guard_check(card, failures)
    scratch = Path(__file__).resolve().parent / "_scratch"
    scratch.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="parallel_phase_", dir=scratch))
    try:
        one = run_workers([dict(name="one", mode="one", device="cuda:0",
                                store=str(tmp / "store_one"), grads=str(tmp / "grads_one.pt"),
                                witness=str(tmp / "grads_witness.pt"), dispatch=True)],
                          tmp, DDP_LIMIT_S)
        groups = {"gloo_one_card": [dict(name=f"gloo{r}", mode="gloo_one_card", world=2, rank=r,
                                         backend="gloo", device="cuda:0",
                                         store=str(tmp / "store_gloo"),
                                         grads=str(tmp / "grads_gloo.pt") if r == 0 else None)
                                    for r in range(2)]}
        if torch.cuda.device_count() >= 2:
            groups["nccl_two_cards"] = [dict(name=f"nccl{r}", mode="nccl_two_cards", world=2,
                                             rank=r, backend="nccl", device=f"cuda:{r}",
                                             store=str(tmp / "store_nccl"),
                                             grads=str(tmp / "grads_nccl.pt") if r == 0 else None,
                                             dispatch=True)
                                        for r in range(2)]
        else:
            print("NCCL over two cards, and the DDP Coach's steps_per_dispatch 2 there: needs a "
                  "second card (1 visible): not run")
        ref, ws1 = one
        rank_counts = dict(ref["counts"])
        for what, rec in (("no group", ref), ("NCCL world size 1", ws1)):
            print(f"{what}: build {rec['build_s']:.1f} s; losses {rec['loss']}, loss_d "
                  f"{rec['loss_d']}; G ms {[round(x, 1) for x in rec['g_ms']]}, D ms "
                  f"{[round(x, 1) for x in rec['d_ms']]}; busy {rec['busy_ms']} ms; peak "
                  f"{rec['peak_gib']:.2f} GiB; all-reduce {rec['allreduce_ms']} ms of "
                  f"{rec['allreduce_bytes']} bytes [{card}]")
        same = (ws1["digest"] == ref["digest"] and ws1["loss"] == ref["loss"]
                and ws1["loss_d"] == ref["loss_d"])
        print(f"NCCL at world size 1 against no group after {DDP_STEPS} G + D steps: "
              f"{'bit for bit the same' if same else 'DIFFERENT'}")
        if not same:
            failures.append("the step in an NCCL group of world size 1 differs from no group")
        add_counts(rank_counts, ws1["counts"])
        check_launches(failures, f"NCCL world size 1: {DDP_STEPS} G + D steps as one dispatch",
                       {k: ws1["dispatch_counts"].get(k, 0) for k in KERNEL_NAMES}, DDP_STEPS,
                       flash_fwd_lse=36, flash_bwd_dq=18, flash_bwd_dkv=18,
                       flash_attention_bound=17, group_norm=GN_CAPTURE)
        add_counts(rank_counts, ws1["dispatch_counts"])
        same = (ws1["dispatch_digest"] == ws1["digest"] and ws1["dispatch_loss"] == ws1["loss"][-1]
                and ws1["dispatch_loss_d"] == ws1["loss_d"][-1])
        print(f"NCCL world size 1, steps_per_dispatch {DDP_STEPS} (a captured G + D step with its "
              f"all-reduces, replayed) against its eager steps: "
              f"{'bit for bit the same' if same else 'DIFFERENT'}; {DDP_STEPS} steps "
              f"{ws1['dispatch_ms']:.1f} ms with capture "
              f"{[round(c, 2) for c in ws1['dispatch_capture_s']]} s [{card}]")
        if not same:
            failures.append("the dispatch in an NCCL group of world size 1 differs from its eager "
                            "steps")
        want = dict(flash_fwd_lse=36, flash_bwd_dq=18, flash_bwd_dkv=18, flash_attention_bound=17,
                    group_norm=GN_CAPTURE)
        for what, rec in (("no group", ref), ("NCCL world size 1", ws1)):
            check_launches(failures, f"{what}: {DDP_STEPS} G + D steps",
                           {k: rec["counts"].get(k, 0) for k in KERNEL_NAMES}, DDP_STEPS, **want)
        grads_ref = torch.load(tmp / "grads_one.pt")
        grads_wit = torch.load(tmp / "grads_witness.pt")
        wit_gap = grad_rel_rms_by_group(ref["names"], grads_wit, grads_ref)
        print(f"split witness (one process, two halves of batch 1 under the global counts, "
              f"summed) against the one process at batch 2: first-step gradient relative RMS "
              f"by group {({k: round(v, 4) for k, v in wit_gap.items()})}")
        for mode, specs in groups.items():
            recs = run_workers(specs, tmp, DDP_LIMIT_S)
            for rec in recs:
                print(f"{mode} rank {rec['rank']} of {rec['world']} on {rec['device']}: build "
                      f"{rec['build_s']:.1f} s; G ms {[round(x, 1) for x in rec['g_ms']]}, D "
                      f"ms {[round(x, 1) for x in rec['d_ms']]}; one G + D step device busy "
                      f"{rec['busy_ms']} ms; G gradient all-reduce {rec['allreduce_ms']:.1f} ms "
                      f"of {rec['allreduce_bytes'] / 1e6:.1f} MB; peak {rec['peak_gib']:.2f} "
                      f"GiB [{card}]")
                check_launches(failures, f"{mode} rank {rec['rank']}: {DDP_STEPS} G + D steps",
                               {k: rec["counts"].get(k, 0) for k in KERNEL_NAMES}, DDP_STEPS,
                               **want)
                add_counts(rank_counts, rec["counts"])
            r0, r1 = recs
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["loss"], ref["loss"]))
            got = torch.load(specs[0]["grads"])
            rels = grad_rel_rms_by_group(ref["names"], got, grads_ref)
            to_wit = grad_rel_rms_by_group(ref["names"], got, grads_wit)
            ranks_same = r0["digest"] == r1["digest"] and r0["loss"] == r1["loss"]
            print(f"{mode}: global losses {r0['loss']} against one process's {ref['loss']} "
                  f"(relative {loss_rel:.2e}, tol {DDP_LOSS_REL_TOL}); first-step gradient "
                  f"relative RMS by group against the split witness "
                  f"{({k: float(f'{v:.3e}') for k, v in to_wit.items()})} (tol "
                  f"{DDP_WITNESS_REL_TOL}), against the one process at batch 2 "
                  f"{({k: round(v, 4) for k, v in rels.items()})} (tol {DDP_BATCH_FACTOR} x the "
                  f"witness's); the two ranks {'bit-identical' if ranks_same else 'DIFFER'} "
                  f"after {DDP_STEPS} steps")
            if loss_rel > DDP_LOSS_REL_TOL or max(to_wit.values()) > DDP_WITNESS_REL_TOL \
                    or any(rels[k] > DDP_BATCH_FACTOR * wit_gap[k] for k in rels) \
                    or not ranks_same:
                failures.append(f"{mode}: two ranks disagree with one process or each other")
            if specs[0].get("dispatch"):
                for rec in recs:
                    check_launches(failures, f"{mode} rank {rec['rank']}: {DDP_STEPS} G + D steps "
                                   "as one dispatch", {k: rec["dispatch_counts"].get(k, 0)
                                                       for k in KERNEL_NAMES}, DDP_STEPS, **want)
                    add_counts(rank_counts, rec["dispatch_counts"])
                same = [rec["dispatch_digest"] == rec["digest"]
                        and rec["dispatch_loss"] == rec["loss"][-1]
                        and rec["dispatch_loss_d"] == rec["loss_d"][-1] for rec in recs]
                print(f"{mode}, steps_per_dispatch {DDP_STEPS} (one captured G + D step with its "
                      f"all-reduces, replayed): ranks "
                      f"{'bit-identical' if r0['dispatch_digest'] == r1['dispatch_digest'] else 'DIFFER'}"
                      f"; each rank against its eager DDP steps {same}; {DDP_STEPS} steps "
                      f"{[round(r['dispatch_ms'], 1) for r in recs]} ms with capture "
                      f"{[[round(c, 2) for c in r['dispatch_capture_s']] for r in recs]} s [{card}]")
                if not all(same) or r0["dispatch_digest"] != r1["dispatch_digest"]:
                    failures.append(f"{mode}: the dispatch differs from the eager DDP steps")
        add_counts(total, rank_counts)
        torch.cuda.empty_cache()
        add_counts(total, parallel_serving(card, failures))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"parallel phase: {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("parallel phase failed: " + "; ".join(failures))
    return total


def all_finite(a) -> bool:
    """Every value finite (a numpy array or a tensor)."""
    import torch

    return bool(torch.isfinite(torch.as_tensor(a)).all())


def ranking(kernels) -> list:
    """The order in which to redesign the kernels: the factor over the library
    call per pass of the kernel's path, largest first, with the d = 64 and
    d = 512 parts of each kernel its path runs at both widths. The two
    backward kernels are ranked as one pair against SDPA's joint backward
    (dQ, dK and dV in one call, each half's library_ms); each half's own
    line follows the pair's, not ranked."""
    def width_parts(k):
        """'; d=64 a vs b ms (x), d=512 ...' where the kernel's path runs it at
        both widths: each width's time and library time per pass."""
        widths = sorted({r["head_dim"] for r in k["shapes"] if r["per_pass"] and "head_dim" in r})
        if len(widths) < 2:
            return ""

        def part(key, w):
            return sum(r[key] * r["per_pass"] for r in k["shapes"] if r.get("head_dim") == w)

        return "; " + ", ".join(f"d={w} {part('ms', w):.2f} vs {part('library_ms', w):.2f} ms "
                                f"({part('ms', w) / part('library_ms', w):.2f}x)" for w in widths)

    def line(k):
        exp2 = "" if k.get("exp2_ms") is None else f", exp2 alone {k['exp2_ms']:.2f} ms"
        return (f"kernel {k['name']}: {k['ms'] / k['library_ms']:.2f}x its library call per pass "
                f"({k['ms']:.2f} vs {k['library_ms']:.2f} ms{width_parts(k)}), "
                f"{k['ms'] - k['bound_ms']:.2f} ms above its bound of {k['bound_ms']:.2f} ms{exp2}")

    entries = [(k["ms"] / k["library_ms"], [line(k)]) for k in kernels
               if k["name"] not in BACKWARD_PAIR]
    halves = [k for k in kernels if k["name"] in BACKWARD_PAIR]
    if len(halves) == 2:
        def per_step(key, width=None):
            return sum(r[key] * r["per_pass"] for k in halves for r in k["shapes"]
                       if width is None or r["head_dim"] == width)

        def lib(width=None):  # one joint call per shape: the first half's rows
            return sum(r["library_ms"] * r["per_pass"] for r in halves[0]["shapes"]
                       if width is None or r["head_dim"] == width)

        ms, lib_ms, b_ms = per_step("ms"), lib(), per_step("bound_ms")
        parts = ", ".join(f"d={w} {per_step('ms', w):.2f} vs {lib(w):.2f} ms "
                          f"({per_step('ms', w) / lib(w):.2f}x)" for w in (64, 512))
        pair = (f"kernel pair {' + '.join(BACKWARD_PAIR)}: {ms / lib_ms:.2f}x its library call "
                f"(sdpa backward, dQ, dK and dV together) per step ({ms:.2f} vs {lib_ms:.2f} "
                f"ms; {parts}), {ms - b_ms:.2f} ms above its bound of {b_ms:.2f} ms")
        entries.append((ms / lib_ms, [pair] + [f"  half of the pair: {line(k)}"
                                               for k in halves]))
    return [text for _, lines in sorted(entries, key=lambda e: -e[0]) for text in lines]


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="", help="comma-separated phases to run instead of all of "
                    "them (kernels, vjp, serving, int8, training, options, recipe, small, "
                    "checkpoint, coach, dispatch, parallel); a partial run prints no result "
                    "line")
    ap.add_argument("--ddp-worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    only = set(filter(None, args.only.split(",")))
    unknown = only - {"kernels", "vjp", "serving", "int8", "training", "options", "recipe",
                      "small", "checkpoint", "coach", "dispatch", "parallel"}
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    def wanted(phase):
        return not only or phase in only

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.ddp_worker:  # one process of the parallel phase
        return ddp_worker(args.ddp_worker)
    from instantrestore_tpu_torch.ops import _build

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line or "error" in line.lower()
                    or "Compiling entry function" in line):
                print(f"  ptxas {name}: {line.strip()[:150]}")

    results, counts = [], {}
    if wanted("kernels"):
        results += kernel_phase(card)
    if wanted("vjp"):
        results += vjp_kernel_phase(card)
    if wanted("serving"):
        warm, counts = warm_phase(card)
        cold, cold_counts = cold_phase(card, warm)
        add_counts(counts, cold_counts)
        add_counts(counts, online_phase(card, warm, cold))
        add_counts(counts, other_paths(card, warm, cold))
        replace_identity(warm)
        serving_params = warm["engine"].params
        del warm, cold
        torch.cuda.empty_cache()
    if wanted("int8"):
        add_counts(counts, int8_phase(card))
        torch.cuda.empty_cache()
    if wanted("training"):
        add_counts(counts, training_phase(card))
    if wanted("options"):
        torch.cuda.empty_cache()
        add_counts(counts, options_phase(card))
    if wanted("recipe"):
        add_counts(counts, recipe_phase(card))
        torch.cuda.empty_cache()
    if wanted("small"):
        if not wanted("serving"):  # the same seeded weights as the warm phase's
            from instantrestore_tpu_torch.models.restorer import (
                RestorerStatics,
                init_restorer_params,
                serving_bundle,
            )

            statics = RestorerStatics(use_adain=True, train_input=False)
            serving_params = serving_bundle(init_restorer_params(
                torch.Generator(device="cuda").manual_seed(0), statics, lora_rank_unet=32,
                lora_rank_vae=32, device="cuda"), statics)
        add_counts(counts, small_model_phase(card, serving_params))
        del serving_params
        torch.cuda.empty_cache()
    if wanted("checkpoint"):
        add_counts(counts, checkpoint_phase(card))
    if wanted("coach"):
        torch.cuda.empty_cache()
        add_counts(counts, coach_phase(card))
    if wanted("dispatch"):
        torch.cuda.empty_cache()
        add_counts(counts, dispatch_phase(card))
    if wanted("parallel"):
        torch.cuda.empty_cache()
        add_counts(counts, parallel_phase(card))
    print(f"launches over the paths: {counts}")
    if only:
        print(f"partial run ({sorted(only)}): no result line")
        return 0
    missing = [name for name in KERNEL_NAMES if counts.get(name, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on a path: {missing}")
    kernels = []
    for name, source, replaces, rows in results:
        b_ms = sum(r["bound_ms"] * r["per_pass"] for r in rows)
        ops_ms = sum(r["bound_ms"] * r["per_pass"] for r in rows if r["bound_by"] == "operations")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            # times are per pass of the kernel's path (a warm restore for
            # shared_identity_attention and the two flash kernels, a cold
            # one for shared_flash_bound and shared_online, cold under
            # kv_outer_packed for shared_online_pair, a train step for the
            # three flash-VJP kernels): each shape's time times its launches
            # per pass
            "ms": sum(r["ms"] * r["per_pass"] for r in rows),
            "plain_ms": sum(r["plain_ms"] * r["per_pass"] for r in rows),
            "bound_ms": b_ms,
            "bound_by": "operations" if ops_ms >= b_ms / 2 else "bytes",
            "library_ms": sum(r["library_ms"] * r["per_pass"] for r in rows),
            # the shared kernels' other bound, beside bound_ms: one exp2 a score
            "exp2_ms": (sum(r["exp2_ms"] * r["per_pass"] for r in rows)
                        if all("exp2_ms" in r for r in rows) else None),
            "shapes": rows,
        })
    for line in ranking(kernels):
        print(f"{line} [{card}]")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
