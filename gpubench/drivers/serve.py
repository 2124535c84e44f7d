"""A serving cell: ``ServingEngine.restore`` (warm) or ``restore_cold``
(cold) of ``instantrestore_tpu_torch`` in a closed loop for the window,
then the restored faces of a seeded sample of its batches against the plain
reference.

Set-up (counted in ``setup_s``): the weights drawn on the device from the
seed (``gpubench/weights.py``), the program's serving bundle (its LoRA merge)
and engine, the identities onboarded (warm), the photo pool staged in pinned
memory, ``warmup_batches`` restores of the cell's own shape, and with
``--trace 1`` one profiled restore that starts the profiler.

Window: batch ``i`` is made by ``gpubench/traffic.py``; its latency is the
host clock from the call to the output being complete on the card (an event
synchronised on the host), while the next batch's photos are staged. With
``--trace 1`` the window runs ``profile_batches`` more batches past its
length under the profiler (its trace is read after the window). A seeded
reservoir keeps ``sample_batches`` of the window's outputs on the card.

A mix may give ``env``: variables the program reads at every call (its
attention algorithms), set for the program's part of the run.

After the window: the peak memory is read, the engine freed, the weights
drawn again and the kept batches restored by the reference in fp32 (TF32
off), ``reference_block`` faces at a time, each face twice: with its own
references (``ref``) and with another face's (``swap``: warm, the next
identity's; cold, the next face's in the block). Two numbers are compared,
each the worst over the faces:

- ``worst_face_rel_rms``: the relative RMS error ||out - ref|| / ||ref||;
- ``worst_face_refs_effect_err``: |1 - c| with c = <out - swap, ref - swap>
  / ||ref - swap||^2, the share of the references' own effect on the face
  that the program's output carries. It is 1 where the program read the
  face's own references and near 0 or 1/2 where it read another face's,
  which moves the output by only a few per cent and hides in the first
  number's rounding.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import statistics
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from gpubench import flops
from gpubench.reference.layout import restorer_layout
from gpubench.reference.model import Restorer
from gpubench.trace import Profile
from gpubench.traffic import ServeTraffic
from gpubench.weights import materialize
from instantrestore_tpu_torch.inference.serving import ServingEngine
from instantrestore_tpu_torch.models.restorer import RestorerStatics, serving_bundle
from instantrestore_tpu_torch.models.unet import UNetConfig
from instantrestore_tpu_torch.models.vae import VAEConfig


@dataclasses.dataclass
class RunContext:
    config: Dict[str, Any]
    mix: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    chips: int
    t_start: float  # host clock at the process's start
    limits: Dict[str, Optional[float]]


def statics_for(cfg: Dict[str, Any]) -> RestorerStatics:
    """The program's statics for a configuration file."""
    u, v, m = cfg["unet"], cfg["vae"], cfg["model"]
    unet_cfg = UNetConfig(
        sample_size=u["sample_size"], in_channels=u["in_channels"],
        out_channels=u["out_channels"], block_out_channels=tuple(u["block_out_channels"]),
        down_block_types=tuple(u["down_block_types"]), up_block_types=tuple(u["up_block_types"]),
        layers_per_block=u["layers_per_block"], attention_heads=tuple(u["attention_head_dim"]),
        cross_attention_dim=u["cross_attention_dim"], norm_num_groups=u["norm_num_groups"],
        norm_eps=u["norm_eps"], transformer_norm_eps=u["transformer_norm_eps"],
        flip_sin_to_cos=u["flip_sin_to_cos"], freq_shift=float(u["freq_shift"]))
    vae_cfg = VAEConfig(
        in_channels=v["in_channels"], out_channels=v["out_channels"],
        latent_channels=v["latent_channels"], block_out_channels=tuple(v["block_out_channels"]),
        layers_per_block=v["layers_per_block"], norm_num_groups=v["norm_num_groups"],
        norm_eps=v["norm_eps"], scaling_factor=v["scaling_factor"])
    return RestorerStatics(
        unet_cfg=unet_cfg, vae_cfg=vae_cfg, use_shared_attention=m["use_shared_attention"],
        use_adain=m["use_adain"], train_input=m["train_input"],
        unet_lora_scaling=lora_scaling(m["lora_rank_unet"]),
        vae_lora_scaling=lora_scaling(m["lora_rank_vae"]),
        compute_dtype=getattr(torch, m["dtype"]))


def lora_scaling(rank: int) -> float:
    """alpha / rank with alpha = rank // 2, the reference's training setting."""
    return (rank // 2) / rank


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


class Reservoir:
    """A uniform sample of ``k`` of the window's batches, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, np.random.default_rng([int(seed) % 2**63, 21])
        self.kept: List[Tuple[int, torch.Tensor]] = []

    def offer(self, i: int, out: torch.Tensor) -> None:
        if len(self.kept) < self.k:
            self.kept.append((i, out.clone()))
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.kept[j] = (i, out.clone())


def _restore_call(engine: ServingEngine, warm: bool):
    if warm:
        return lambda b: engine.restore(b["images"], b["ids"], noise=b["noise"])
    return lambda b: engine.restore_cold(b["images"], b["refs"], noise=b["noise"])


@contextlib.contextmanager
def program_env(env: Dict[str, Any]):
    """``env`` set in the process's environment, then restored."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run(ctx: RunContext) -> Dict[str, Any]:
    with program_env(ctx.mix.get("env", {})):
        result = _serve(ctx)
    layout, traffic, kept = result.pop("_for_reference")
    t_ref = time.perf_counter()
    result["checks"] = compare_with_reference(ctx.config, layout, traffic, kept, ctx)
    result["reference_s"] = time.perf_counter() - t_ref
    result["correct"] = all(c["limit"] is not None and c["value"] <= c["limit"]
                            for c in result["checks"].values())
    return result


def _serve(ctx: RunContext) -> Dict[str, Any]:
    """Set-up and the window; the engine is freed before it returns."""
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    statics = statics_for(cfg)
    layout = restorer_layout(cfg)
    scaling = lora_scaling(cfg["model"]["lora_rank_unet"])
    with torch.no_grad():
        params = materialize(layout, ctx.seed, dev, lora_scaling=scaling)
        engine = ServingEngine(serving_bundle(params, statics), statics, device=dev,
                               **mix.get("engine", {}))
        del params
    _free(dev)
    traffic = ServeTraffic(mix, cfg, ctx.seed, dev)
    if traffic.warm:
        refs = traffic.identity_refs()
        engine.onboard(refs, noise=traffic.onboard_noise())
        del refs
    call = _restore_call(engine, traffic.warm)
    for i in range(-mix["warmup_batches"], 0):  # negative indices: never a window batch
        call(traffic.batch(i))
    profile = Profile() if ctx.trace else None
    if profile is not None:  # the profiler's own start-up stays out of the window
        _sync(dev)
        profile.start()
        call(traffic.batch(-1))
        _sync(dev)
        profile.stop()
    _sync(dev)

    # ------------------------------------------------------------ the window
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    deadline = t0 + ctx.seconds
    latencies: List[float] = []
    reservoir = Reservoir(mix["sample_batches"], ctx.seed)
    prof_ids: List[int] = []
    profiling = False
    done = cuda_event(dev)
    nxt = traffic.batch(0)
    i, t_end = 0, t0
    while True:
        cur = nxt
        if profile is not None and not profiling and time.perf_counter() >= deadline:
            profile.start()
            profiling = True
        ts = time.perf_counter()
        out = call(cur)
        done.record()
        nxt = traffic.batch(i + 1)
        done.synchronize()
        t_end = time.perf_counter()
        latencies.append(t_end - ts)
        if profiling:
            prof_ids.append(i)
        reservoir.offer(i, out)
        del out
        i += 1
        if t_end >= deadline and (profile is None or len(prof_ids) >= mix["profile_batches"]):
            break
    window_s = t_end - t0
    batch = traffic.batch_size
    faces = batch * len(latencies)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    result: Dict[str, Any] = {
        "attempted": faces, "failed": 0,
        "end_to_end": {
            "faces_per_s": faces / window_s,
            "latency_p90_ms": 1e3 * p90(latencies),
            "setup_s": setup_s,
        },
        "memory_peak_bytes": memory_peak,
        "batches": len(latencies),
    }
    if profile is not None:
        profile.stop()
        result["layer"] = _layer_inputs(cfg, traffic, profile, prof_ids, window_s, faces,
                                        memory_peak, ctx)
    del engine, call, nxt, cur
    _free(dev)
    result["_for_reference"] = (layout, traffic, reservoir.kept)
    return result


def p90(values: List[float]) -> float:
    """The 90th percentile over all values (statistics' inclusive method)."""
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def cuda_event(dev: torch.device):
    """An event to wait for the batch on (a no-op off the card)."""
    if dev.type == "cuda":
        return torch.cuda.Event()

    class _Host:
        def record(self):
            pass

        def synchronize(self):
            pass

    return _Host()


def _layer_inputs(cfg, traffic: ServeTraffic, profile: Profile, prof_ids, window_s: float,
                  faces: int, memory_peak: int, ctx: RunContext) -> Dict[str, Any]:
    """What the per-layer readers read (``gpubench/metrics/``)."""
    kind = torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu"
    peaks = flops.peaks_for(kind)
    mode = "warm" if traffic.warm else "cold"
    least = 0.0
    if peaks:
        calls = [c for c in flops.attention_calls(cfg, mode, traffic.batch_size)
                 if c[0] != "cross"]  # cross-attention over the prompt runs no attention kernel
        for i in prof_ids:
            rows = len(torch.unique(traffic.ids(i))) if traffic.warm else None
            least += sum(flops.least_seconds(c, peaks, rows if c[0] == "shared" else None)[0]
                         for c in calls)
    return {
        "trace": profile.summary, "profiled_faces": traffic.batch_size * len(prof_ids),
        "window_s": window_s, "window_faces": faces, "chips": ctx.chips,
        "flops_per_face": flops.model_flops(cfg, mode), "peaks": peaks,
        "attention_least_s": least, "memory_peak_bytes": memory_peak,
    }


def compare_with_reference(cfg, layout, traffic: ServeTraffic, kept, ctx: RunContext
                           ) -> Dict[str, Dict[str, Any]]:
    """The kept batches' faces against the fp32 reference: each number's
    worst face, beside its limit (see the module's docstring)."""
    dev, block = ctx.device, ctx.mix["reference_block"]
    n = cfg["model"]["n_refs"]
    if not traffic.warm and block < 2:
        raise ValueError("a cold mix's reference_block must hold 2 faces or more to swap them")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    worst = {"worst_face_rel_rms": 0.0, "worst_face_refs_effect_err": 0.0}
    compared = 0
    try:
        with torch.no_grad():
            scaling = lora_scaling(cfg["model"]["lora_rank_unet"])
            ref = Restorer(materialize(layout, ctx.seed, dev, lora_scaling=scaling), cfg)
            captured: Dict[int, List] = {}
            if traffic.warm:
                id_refs, id_noise = traffic.identity_refs(), traffic.onboard_noise()

            def identities(ids: List[int]) -> List:
                for j in ids:
                    if j not in captured:
                        captured[j] = ref.capture(id_refs[j][None], id_noise["latent"][j],
                                                  id_noise["diffusion"][j])
                return [tuple(torch.cat([captured[j][layer][x] for j in ids]) for x in (0, 1))
                        for layer in range(len(captured[ids[0]]))]

            for i, out in sorted(kept, key=lambda x: x[0]):
                b = traffic.batch(i, fresh=True)
                for f0 in range(0, traffic.batch_size, block):
                    rows = slice(f0, f0 + block)
                    if traffic.warm:
                        ids = b["ids"][rows].tolist()
                        shared = identities(ids)
                        swapped = identities([(j + 1) % traffic.mix["identities"] for j in ids])
                    else:
                        nz = b["noise"]
                        cond = slice(f0 * n, (f0 + block) * n)
                        shared = ref.capture(b["refs"][rows].to(dev), nz["cond_latent"][cond],
                                             nz["cond_diffusion"][cond])
                        swapped = [(k.roll(-1, 0), v.roll(-1, 0)) for k, v in shared]
                    images = b["images"][rows].to(dev)
                    lat, dif = b["noise"]["latent"][rows], b["noise"]["diffusion"][rows]
                    r = ref.restore(images, shared, lat, dif).flatten(1)
                    r_swap = ref.restore(images, swapped, lat, dif).flatten(1)
                    o = out[rows].float().flatten(1)
                    d = r - r_swap
                    share = ((o - r_swap) * d).sum(dim=1) / (d * d).sum(dim=1)
                    for name, err in (
                            ("worst_face_rel_rms", (o - r).norm(dim=1) / r.norm(dim=1)),
                            ("worst_face_refs_effect_err", (1.0 - share).abs())):
                        # a non-finite face reads as infinitely wrong
                        err = torch.where(torch.isfinite(err), err, torch.full_like(err, np.inf))
                        worst[name] = max(worst[name], float(err.max()))
                    compared += o.shape[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return {name: {"value": value, "limit": ctx.limits.get(name), "faces": compared}
            for name, value in worst.items()}
