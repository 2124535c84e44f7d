"""Batched serving on one GPU or several (counterpart of
``instantrestore_tpu/inference/serving.py``).

Warm path: identities are onboarded once; their reference images go through
the frozen VAE and UNet, and the reference K/V of the UNet's shared layers
(``UNetConfig.num_shared_attn_layers``: 9 for SD-Turbo, 36 for SDXL-Turbo)
land in a cache. A restore then runs one VAE encode, one UNet whose shared
attentions read that cache, and one VAE decode. With ``identity_cache`` (by default on
for the fused attention of a refs-only model, ``train_input=False``, unless
``INSTANTRESTORE_IDENT_CACHE`` is set to anything but ``1``, as in the JAX
engine) the cache holds each layer's AdaIN statistics and key-norm bounds
too and is read by identity id (the ``shared_identity`` kernel, no gather
copy). Otherwise it is a plain ``[(k, v)]`` list, a pair of ``[I, N, H, S,
d]`` leaves a shared layer: each restore gathers its rows and takes the
per-call shared attention (``shared_flash_bound``, with its input segment for
``train_input`` models, which attend to the input image's own K/V as well,
what the identity cache does not model).

Cold path: ``restore_cold`` re-encodes each request's references in the call
(the reference implementation's own flow).

Spans (``utils/profiling.py``, on only under a profiler or ``tracing()``):
the rows a restore runs in this process (all of them on one device, the
first device's otherwise) are a call ``restore`` or ``restore_cold`` with
``faces`` those rows. Its stage ``inputs`` is the copies to the device and
the resize and normalise; ``restore_forward`` opens the others.

Several cards (``devices=``, the counterpart of JAX's ``mesh=``): the
calling process serves the first device, and each further device gets a
worker process of its own (``inference/workers.py``) holding its own
replica of the bundle and of the cache. Every draw is made once for the
whole batch, from the caller's generator on its own device in the order a
one-device restore draws (or taken through ``noise``), and each device gets
its contiguous rows of images, identity ids and noise (``local_rows``); so
the output does not depend on the number of devices beyond the order of fp
sums. A batch must divide by the device count (``ValueError``
"...divisible..." as in JAX). The workers run their rows while the calling
process runs its own, and the outputs are gathered on the first device.
Onboarding splits the identities over the devices when their count divides
by the number of devices (each identity's encode is the one-device one, so
the cache is bit-equal), else it onboards on the first device; the cache is
then copied to every worker. ``close()`` (or a ``with`` block) stops the
workers.

int8 serving (``int8_decoder``, ``int8_unet``, as in the JAX engine): the
frozen capture networks are materialised first from the unmerged tree, then
the restoration decoder's and UNet's conv mass is quantized
(``models/vae.py::quantize_decoder_int8``,
``models/unet.py::quantize_unet_int8``) from the tree the caller passed, in
fp32, before the engine's cast to the compute dtype, and each int8 conv gets
a calibration slot. Restores then quantize each conv's input with a
per-sample dynamic scale until ``calibrate_int8`` bakes static scales
observed on representative batches (every worker receives them too).

Graphs (a restore's rows on one device; each worker of ``devices=`` keeps
its own): a call is keyed on what its launches depend on that the engine
can observe: warm or cold; the inputs' shapes and dtypes (images,
references, ids); the noise entries given; the ``INSTANTRESTORE_*``
variables; whether spans are on; the int8 calibration; the engine's own
settings, the backends' TF32 and cuDNN switches, and the params and cache
it reads. The first call of a forward (a key but for the span state) runs
eagerly, as a plain forward. On a CUDA device the next call of each key runs
once on a side stream over static input buffers and is then captured into
``torch.cuda.CUDAGraph`` (every key's into one pool of the engine); every
later call copies its inputs into the buffers (from pinned memory without
blocking: a pinned input is not to be written again before the output is
ready) and replays. Noise a call draws from ``generator`` is drawn into the
buffers first, in the one-device forward's order, so a replay is bit for bit
the eager call. The preprocess and the identity lookup run inside the graph.
A call returns a fresh tensor, never a graph's buffer. Every engine of the
process captures on one side stream and into one graph pool a device, so a
capture reuses the blocks earlier captures freed and the graphs hold about
the largest forward's activations, not their sum; the engines' calls are
therefore not to run at the same time from several threads (nor is one
engine's). ``onboard`` (a new
cache), ``calibrate_int8`` (new params) and ``close()`` drop every graph;
``onboard_one`` writes rows in place, which a replay reads. A call inside
``int8_records`` (calibration) or inside another capture runs a plain
forward; off CUDA the static-buffer call runs eagerly. A capture error
raises. A replay adds the capture's kernel launches to the wrappers'
counters. With spans on, the graph is captured in pieces, cut at every stage
and nested span (``profiling.cuts``), and a replay opens those spans between
the pieces, so each call's record holds its own times; the outer
``restore`` / ``restore_cold`` span stays around the replay. Each call's
record has ``graph`` ("eager", "capture" or "replay"), and ``graph_stats()``
counts the calls of each kind.

Differences from the JAX engine: onboarding is a Python loop over
identities (no ``lax.map``), and a restore draws its batch noise from one
``torch.Generator`` (or takes it through ``noise``) instead of per-row PRNG
keys.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import os
import sys
import warnings
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from instantrestore_tpu_torch import resolve_device
from instantrestore_tpu_torch.convert import tree_to
from instantrestore_tpu_torch.inference.workers import ENV_PREFIX, WorkerPool
from instantrestore_tpu_torch.models import scheduler as sched
from instantrestore_tpu_torch.models.lora import merge_lora
from instantrestore_tpu_torch.models.restorer import (
    RestorerStatics,
    get_conditioning_kv,
    original_unet_view,
    original_vae_view,
    restore_forward,
)
from instantrestore_tpu_torch.models.unet import quantize_unet_int8
from instantrestore_tpu_torch.models.vae import quantize_decoder_int8
from instantrestore_tpu_torch.ops.flash_vjp import add_launch_counts, launch_counts
from instantrestore_tpu_torch.ops.image_ops import preprocess
from instantrestore_tpu_torch.ops.primitives import (
    apply_int8_calibration,
    assign_calib_slots,
    int8_recording,
    int8_records,
    stack_records,
)
from instantrestore_tpu_torch.ops.shared_attention import IdentityRef, build_identity_kv_cache
from instantrestore_tpu_torch.parallel.distributed import local_rows
from instantrestore_tpu_torch.utils import profiling


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


_logger = logging.getLogger(__name__)


def _on(device: torch.device):
    """``device`` the calling thread's current CUDA device (no-op off CUDA)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


# a device's capture stream, graph pool and live static calls holding graphs,
# for every engine of the process (the module's docstring)
_CAPTURES: Dict[torch.device, list] = {}


def _capture_slot(device: torch.device):
    """(stream, pool) for one more static call's captures on ``device``; a
    new pool once no graph holds the last (the allocator takes a pool no
    graph holds as ended). ``_release_slot`` when the call is gone."""
    if device not in _CAPTURES:
        _CAPTURES[device] = [torch.cuda.Stream(device=device), None, 0]
    slot = _CAPTURES[device]
    if slot[2] == 0:
        slot[1] = torch.cuda.graph_pool_handle()
    slot[2] += 1
    return slot[0], slot[1]


def _release_slot(device: torch.device) -> None:
    _CAPTURES[device][2] -= 1


def _draw_rows(cold: bool, b: int, n: int) -> List[Tuple[str, int]]:
    """A one-device forward's draws in order: (noise key, rows), for ``b``
    faces with ``n`` references each (cold)."""
    if not cold:
        return [("latent", b), ("diffusion", b)]
    return [("latent", b), ("cond_latent", b * n), ("cond_diffusion", b * n), ("diffusion", b)]


class _StaticCall:
    """One key's restore over static device buffers (the module's
    docstring), made by the key's first call after its forward ran
    eagerly, which it serves. ``forward(engine, load, generator)`` is the
    engine's warm or cold forward; ``load()``, called inside its ``inputs``
    stage, gives the inputs and the noise on the device. It holds no
    reference to the engine, so that an engine nothing else holds is freed
    at once, with its graphs."""

    def __init__(self, engine: "ServingEngine", forward, inputs: Dict[str, torch.Tensor],
                 draws: List[Tuple[str, int]]):
        dev = engine.device
        self.forward, self.draws = forward, draws
        self.reads = (engine.params, engine.kv_cache)  # held: a graph reads their memory
        self.inputs = {k: torch.empty(v.shape, dtype=torch.long if k == "ids" else v.dtype,
                                      device=dev) for k, v in inputs.items()}
        side, c = engine._latent_side(), engine.statics.vae_cfg.latent_channels
        self.noise = {k: torch.empty((rows, side, side, c), device=dev) for k, rows in draws}
        self.graphs: List[Any] = []
        self.events: List[tuple] = []  # ("graph", i), ("load",), ("enter", name, count), ("exit",)
        self.launches: Dict[str, int] = {}
        self.output: Optional[torch.Tensor] = None

    def fill(self, engine: "ServingEngine", inputs, noise, generator) -> None:
        """The call's inputs and noise copied into the buffers; the noise it
        does not give drawn from ``generator`` first, in the forward's order."""
        for k, t in inputs.items():
            self.inputs[k].copy_(t, non_blocking=True)
        given = noise or {}
        missing = [(k, rows) for k, rows in self.draws if k not in given]
        drawn = engine._draw(missing, generator) if missing else {}
        for k, buf in self.noise.items():
            buf.copy_(given[k] if k in given else drawn[k], non_blocking=True)

    def _buffers(self) -> Dict[str, Any]:
        return dict(self.inputs, noise=self.noise)

    def __call__(self, engine: "ServingEngine", inputs, noise,
                 generator) -> Tuple[torch.Tensor, str]:
        """(the call's output, "eager" / "capture" / "replay")."""
        fill = functools.partial(self.fill, engine, inputs, noise, generator)
        if self.graphs:
            return self._replay(fill), "replay"
        load = lambda: (fill(), self._buffers())[1]  # noqa: E731
        if engine.device.type != "cuda":
            return self.forward(engine, load, None), "eager"
        dev = torch.device("cuda", torch.cuda.current_device())  # the engine's (``_on``)
        side, pool = _capture_slot(dev)
        weakref.finalize(self, _release_slot, dev)
        main = torch.cuda.current_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):  # the call itself, and every lazy set-up of the stream
            out = self.forward(engine, load, None)
        torch.cuda.synchronize(dev)
        # as torch.cuda.graph does: a capture cannot free cached blocks to
        # make room, so they are freed before it
        torch.cuda.empty_cache()
        before = launch_counts()
        self._capture(engine, side, pool)
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        add_launch_counts({k: -n for k, n in self.launches.items()})  # nothing ran yet
        main.wait_stream(side)
        out.record_stream(main)
        return out, "capture"

    def _capture(self, engine: "ServingEngine", side, pool) -> None:
        """The forward over the buffers captured on ``side`` into ``pool``:
        one graph, cut where ``load`` runs and, with spans on, at every
        span's boundary."""

        def begin():
            self.events.append(("graph", len(self.graphs)))
            self.graphs.append(torch.cuda.CUDAGraph())
            self.graphs[-1].capture_begin(pool=pool, capture_error_mode="thread_local")

        def cut(event):
            self.graphs[-1].capture_end()
            self.events.append(event)
            begin()

        def load():
            cut(("load",))
            return self._buffers()

        with torch.cuda.stream(side), warnings.catch_warnings():
            # a piece between two boundaries may hold no work
            warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
            begin()
            try:
                with profiling.cuts(cut):
                    self.output = self.forward(engine, load, None)
            except BaseException:
                with contextlib.suppress(RuntimeError):  # the capture's own error is raised
                    self.graphs[-1].capture_end()
                raise
            self.graphs[-1].capture_end()

    def _replay(self, fill) -> torch.Tensor:
        """The pieces replayed in order, the buffers filled where ``load``
        ran and the spans opened between the pieces: a copy of the output."""
        opened = []
        try:
            for event in self.events:
                if event[0] == "graph":
                    self.graphs[event[1]].replay()
                elif event[0] == "load":
                    fill()
                elif event[0] == "enter":
                    opened.append(profiling.span(event[1], count=event[2]))
                    opened[-1].__enter__()
                else:
                    opened.pop().__exit__(None, None, None)
        except BaseException:
            exc = sys.exc_info()
            while opened:
                opened.pop().__exit__(*exc)
            raise
        add_launch_counts(self.launches)
        return self.output.clone()


def quantize_bundle(params: Dict[str, Any], statics: RestorerStatics, *, decoder: bool,
                    unet: bool) -> Dict[str, Any]:
    """The int8 serving bundle (the JAX engine's order): ``original_vae`` and
    ``original_unet`` materialised from the unmerged tree first, then the
    restoration decoder and/or UNet LoRA-merged and quantized in fp32, then
    a calibration slot for every int8 conv."""
    params = dict(params)
    params.setdefault("original_vae", original_vae_view(params))
    params.setdefault("original_unet", original_unet_view(params))
    if decoder:
        params["vae"] = quantize_decoder_int8(merge_lora(params["vae"], statics.vae_lora_scaling))
    if unet:
        params["unet"] = quantize_unet_int8(merge_lora(params["unet"], statics.unet_lora_scaling))
    return assign_calib_slots(params)


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
    of ``device``): serve on each of them, a worker process for each after
    the first (the module's docstring); ``close()`` or a ``with`` block
    stops them.

    On a CUDA device, once a restore's forward has run eagerly, the next
    call of each key (shapes, noise keys, algorithm variables, span and
    calibration state; the module's docstring) is captured into a CUDA
    graph, and every later call of the key replays it; ``onboard``,
    ``calibrate_int8`` and ``close()`` drop the graphs. Every call returns
    a fresh tensor. ``graph_stats()`` counts the calls that ran eagerly,
    captured and replayed.
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
        int8_decoder: bool = False,
        int8_unet: bool = False,
    ):
        if devices is not None and device is not None:
            raise ValueError("pass device= or devices=, not both")
        self.devices = [resolve_device(d) for d in (devices if devices is not None else [device])]
        if not self.devices:
            raise ValueError("devices= is empty")
        self.device = self.devices[0]
        self.statics = statics
        if int8_decoder or int8_unet:
            params = quantize_bundle(params, statics, decoder=int8_decoder, unet=int8_unet)
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
        self._pool: Optional[WorkerPool] = None
        self._static: Dict[tuple, _StaticCall] = {}  # by key (the module's docstring)
        self._warmed: set = set()  # keys but for the span state whose forward ran eagerly
        self._calibrations = 0
        self._graph_counts = {"eager": 0, "captures": 0, "replays": 0}
        if len(self.devices) > 1:
            self._pool = WorkerPool(
                self.devices[1:], self.params, statics,
                dict(use_fused_attention=use_fused_attention, timestep=timestep,
                     resolution=resolution, identity_cache=identity_cache))
        quant = {(True, True): "int8-unet+decoder", (True, False): "int8-decoder",
                 (False, True): "int8-unet"}.get((int8_decoder, int8_unet), "fp")
        _logger.info("ServingEngine paths: attention=%s, warm-kv=%s, quant=%s, res=%d, devices=%s",
                     "fused kernels" if use_fused_attention else "unfused",
                     "identity-kv-cache" if identity_cache else "per-call KV gather", quant,
                     resolution, [str(d) for d in self.devices])

    def close(self) -> None:
        """Drop the graphs and stop the worker processes."""
        self._drop_graphs()
        if self._pool is not None:
            self._pool.close()

    def graph_stats(self) -> Dict[str, int]:
        """This process's restore calls so far: ``eager`` (a plain forward,
        or the static-buffer call off CUDA), ``captures``, ``replays``."""
        return dict(self._graph_counts)

    def _drop_graphs(self) -> None:
        """Forget every static call and its graphs (once the card has done
        with their buffers)."""
        if self._static and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._static.clear()
        self._warmed.clear()

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _run(self, cmd: str, args: List[tuple], own: Callable[[], Any]) -> List[Any]:
        """``own()`` on the first device while each worker runs
        ``cmd(*args[i])``: [own's value, worker 0's, ...]."""
        def here():
            with torch.no_grad(), _on(self.device):
                return own()

        return self._pool.run(cmd, args, here)

    def device_caches(self) -> List[List[Any]]:
        """The warm cache as each device holds it (the workers' copied to the
        calling process): the first device's is ``kv_cache``."""
        if self._pool is None:
            return [self.kv_cache]
        return self._run("cache", [()] * len(self._pool.workers), lambda: self.kv_cache)

    def _set_cache(self, cache: List[Any]) -> None:
        self._drop_graphs()
        self.kv_cache = cache
        if self._pool is not None:
            self._pool.run("set_cache", [(cache,)] * len(self._pool.workers))

    def _latent_side(self) -> int:
        return self.resolution // 2 ** (len(self.statics.vae_cfg.block_out_channels) - 1)

    def _draw(self, rows: List[Tuple[str, int]], generator) -> Dict[str, torch.Tensor]:
        """Standard-normal latents [rows, l, l, c] from ``generator`` on its
        device, one per (name, rows) in order (a one-device forward's draws)."""
        if generator is None:
            raise ValueError("pass noise= or a torch.Generator")
        side, c = self._latent_side(), self.statics.vae_cfg.latent_channels
        return {k: torch.randn((r, side, side, c), generator=generator, device=generator.device)
                for k, r in rows}

    def _key(self, path: str, inputs: Dict[str, torch.Tensor], noise) -> tuple:
        """A call's key but for the span state (the module's docstring)."""
        bk = torch.backends
        return (path, tuple((k, tuple(t.shape), t.dtype) for k, t in inputs.items()),
                tuple(sorted((k, tuple(t.shape), t.dtype) for k, t in (noise or {}).items())),
                tuple(sorted((k, v) for k, v in os.environ.items() if k.startswith(ENV_PREFIX))),
                self._calibrations, self.use_fused_attention, self.identity_cache, self.timestep,
                self.resolution, id(self.params), id(self.kv_cache), bk.cuda.matmul.allow_tf32,
                bk.cudnn.allow_tf32, bk.cudnn.benchmark, bk.cudnn.deterministic)

    def _call(self, path: str, forward, inputs: Dict[str, torch.Tensor], generator,
              noise) -> torch.Tensor:
        """``forward(self, load, generator)`` for one call: a plain forward,
        or the key's static call (the module's docstring). ``inputs`` are
        the caller's tensors, by name."""
        dev = self.device
        if int8_recording() or (dev.type == "cuda" and torch.cuda.is_current_stream_capturing()):
            out, mode = self._plain(forward, inputs, generator, noise), "eager"
        else:
            base = self._key(path, inputs, noise)
            key = (base, profiling.on())
            static = self._static.get(key)
            if static is None and base not in self._warmed:
                out, mode = self._plain(forward, inputs, generator, noise), "eager"
                self._warmed.add(base)
            else:
                if static is None:
                    b = inputs["images"].shape[0]
                    n = inputs["conds"].shape[1] if "conds" in inputs else 0
                    static = _StaticCall(self, forward, inputs, _draw_rows("conds" in inputs, b, n))
                with _on(dev):
                    out, mode = static(self, inputs, noise, generator)
                self._static[key] = static
        self._graph_counts[{"eager": "eager", "capture": "captures",
                            "replay": "replays"}[mode]] += 1
        profiling.note(graph=mode)
        return out

    def _plain(self, forward, inputs: Dict[str, torch.Tensor], generator, noise) -> torch.Tensor:
        """The forward of the caller's tensors copied to the device, drawing
        from ``generator`` where it draws."""
        dev = self.device

        def load():
            x = {k: v.to(device=dev, dtype=torch.long) if k == "ids" else v.to(dev)
                 for k, v in inputs.items()}
            return dict(x, noise=noise)

        return forward(self, load, generator)

    def _split_batch(self, b: int, noise, cmd: str, inputs: Callable[[slice], tuple],
                     own: Callable[[slice, Any], Any]) -> List[Any]:
        """The first device's contiguous rows of a batch of ``b`` by
        ``own(rows, noise rows)`` here, each worker's by ``cmd(*inputs(rows),
        noise rows)``: [the first device's result, each worker's]."""
        n_dev = len(self.devices)
        if b % n_dev:
            raise ValueError(f"batch {b} must be divisible by the {n_dev} serving devices")
        per = b // n_dev
        rows = [slice(j * per, (j + 1) * per) for j in range(n_dev)]
        return self._run(cmd, [(*inputs(rows[j]), local_rows(noise, b, j, n_dev))
                               for j in range(1, n_dev)],
                         lambda: own(rows[0], local_rows(noise, b, 0, n_dev)))

    def _gather(self, outs: List[torch.Tensor]) -> torch.Tensor:
        return torch.cat([o.to(self.device) for o in outs])

    def _refs_kv(self, refs: torch.Tensor, generator, noise):
        """One identity's references [N, H, W, 3] -> (k, v) [N, H, S, d] a
        shared layer."""
        n, dev = refs.shape[0], self.device
        refs = _maybe_preprocess(refs.to(dev), self.resolution)
        kv, _ = get_conditioning_kv(
            self.params, refs[None], torch.full((1,), n, device=dev),
            statics=self.statics, alphas_cumprod=self.abar, generator=generator,
            noise=noise, use_fused_attention=self.use_fused_attention,
        )
        return [(k[0], v[0]) for k, v in kv]

    def _onboard_rows(self, identity_refs: torch.Tensor, noise, generator):
        """identity_refs [I, N, H, W, 3] -> per layer [k, v] [I, N, H, S, d]
        (``noise`` entries [I, N, h, w, 4], else draws from ``generator``)."""
        rows: Optional[List[List[torch.Tensor]]] = None
        for i in range(identity_refs.shape[0]):
            kv = self._refs_kv(identity_refs[i], generator,
                               None if noise is None else {k: v[i] for k, v in noise.items()})
            if rows is None:
                rows = [[k.new_empty((identity_refs.shape[0], *k.shape)),
                         v.new_empty((identity_refs.shape[0], *v.shape))] for k, v in kv]
            for (rk, rv), (k, v) in zip(rows, kv):
                rk[i], rv[i] = k, v
        return rows

    @torch.no_grad()
    def onboard(self, identity_refs: torch.Tensor, *, generator: Optional[torch.Generator] = None,
                noise: Optional[Dict[str, torch.Tensor]] = None) -> List[Any]:
        """identity_refs [I, N, H, W, 3] (uint8, or float in [-1, 1]) -> the
        warm cache: an ``IdentityKVCache`` a shared layer, or (k, v) [I, N, H,
        S, d] pairs without ``identity_cache``. I fixes the capacity; ``onboard_one``
        replaces rows. ``noise`` may give ``latent``/``diffusion``
        [I, N, h, w, 4]."""
        n_ident, n_dev = identity_refs.shape[0], len(self.devices)
        if n_dev > 1 and noise is None:  # each identity's draws, in the one-device order
            n_refs = identity_refs.shape[1]
            draws = [self._draw([("latent", n_refs), ("diffusion", n_refs)], generator)
                     for _ in range(n_ident)]
            noise = {k: torch.stack([d[k] for d in draws]) for k in ("latent", "diffusion")}
        if n_dev > 1 and n_ident % n_dev == 0:  # identities split over the devices
            parts = self._split_batch(
                n_ident, noise, "onboard_rows", lambda sel: (identity_refs[sel],),
                lambda sel, nz: self._onboard_rows(identity_refs[sel], nz, None))
            rows = [[self._gather([p[l][x] for p in parts]) for x in (0, 1)]
                    for l in range(len(parts[0]))]
        else:
            rows = self._onboard_rows(identity_refs, noise, generator)
        self._set_cache(build_identity_kv_cache(rows) if self.identity_cache
                        else [(k, v) for k, v in rows])
        return self.kv_cache

    def _write_row(self, slot: int, row: List[List[torch.Tensor]]) -> None:
        """Row ``slot`` of each layer of the cache set to ``row``'s tensors."""
        for cur, new in zip(self.kv_cache, row):
            for t, r in zip(_fields(cur) if self.identity_cache else cur, new):
                t[slot].copy_(r)

    @torch.no_grad()
    def onboard_one(self, identity_refs: torch.Tensor, slot: int, *,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[Dict[str, torch.Tensor]] = None) -> List[Any]:
        """Onboard or replace one identity ([N, H, W, 3]) in row ``slot`` of
        the cache on every device, in place; other rows are untouched."""
        if self.kv_cache is None:
            raise RuntimeError("call onboard() first")
        capacity = self._capacity()
        if not 0 <= int(slot) < capacity:
            raise ValueError(f"slot {slot} out of range for a cache of {capacity} identities")
        kv = self._refs_kv(identity_refs, generator, noise)
        if self.identity_cache:
            kv = [[t[0] for t in _fields(one)]
                  for one in build_identity_kv_cache([(k[None], v[None]) for k, v in kv])]
        self._write_row(slot, kv)
        if self._pool is not None:
            self._pool.run("write_row", [(slot, kv)] * len(self._pool.workers))
        return self.kv_cache

    def _capacity(self) -> int:
        first = self.kv_cache[0]
        return (first.rk if self.identity_cache else first[0]).shape[0]

    def _warm_forward(self, load, generator) -> torch.Tensor:
        """The warm forward: ``load()`` gives {ids, images, noise} on the
        device."""
        with profiling.span("inputs"):
            x = load()
            ids = x["ids"]
            images = _maybe_preprocess(x["images"], self.resolution)
        if self.identity_cache:
            ref_kv = [IdentityRef(c, ids) for c in self.kv_cache]
        else:  # gather each sample's identity K/V: [I, N, H, S, d] -> [B, N, H, S, d]
            ref_kv = [(k[ids], v[ids]) for k, v in self.kv_cache]
        out = restore_forward(
            self.params, images, statics=self.statics, timestep=self.timestep,
            precomputed_ref_kv=ref_kv, generator=generator, noise=x["noise"],
            use_fused_attention=self.use_fused_attention,
        )
        return out["output_image"]

    def _restore_rows(self, images, ids, generator, noise) -> torch.Tensor:
        """The warm restore of ``images`` of identities ``ids`` here."""
        with profiling.span("restore", faces=images.shape[0], device=self.device):
            return self._call("restore", ServingEngine._warm_forward,
                              {"ids": ids, "images": images}, generator, noise)

    @torch.no_grad()
    def restore(self, images: torch.Tensor, identity_ids, *,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Warm restore: images [B, H, W, 3] (uint8, or float in [-1, 1]) of
        identities ``identity_ids`` [B] -> a new [B, res, res, 3] tensor in
        [-1, 1]. ``noise`` may give ``latent``/``diffusion`` [B, h, w, 4].
        Once its key is captured, a call on a CUDA device replays a graph
        (the module's docstring)."""
        if self.kv_cache is None:
            raise RuntimeError("call onboard() first")
        ids = torch.as_tensor(identity_ids)
        if ids.device.type == "cpu":
            capacity = self._capacity()
            if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= capacity):
                raise ValueError(f"identity ids outside [0, {capacity})")
        b = images.shape[0]
        if len(self.devices) == 1:
            return self._restore_rows(images, ids, generator, noise)
        if noise is None and b % len(self.devices) == 0:
            noise = self._draw(_draw_rows(False, b, 0), generator)
        return self._gather(self._split_batch(
            b, noise, "restore", lambda sel: (images[sel], ids[sel]),
            lambda sel, nz: self._restore_rows(images[sel], ids[sel], None, nz)))

    def _calibrate(self, slots: torch.Tensor, scales: torch.Tensor, margin: float) -> None:
        self._drop_graphs()
        self.params = apply_int8_calibration(self.params, slots, scales, margin=margin)
        self._calibrations += 1

    @torch.no_grad()
    def calibrate_int8(self, batches, *, margin: float = 1.05) -> int:
        """Bake static int8 activation scales from representative batches.
        ``batches``: ``(images, identity_ids, generator or noise dict)``
        tuples. Each is restored on the first device with every conv's
        per-sample dynamic scale recorded; each conv keeps its max over the
        batches, times ``margin``, as its static ``a_scale`` (on every
        device). Returns the number of convs calibrated. The batches run
        eagerly, and the new params drop every graph."""
        if self.kv_cache is None:
            raise RuntimeError("call onboard() first")
        slots, scales = [torch.zeros(0, dtype=torch.int32)], [torch.zeros(0)]
        for images, ids, draws in batches:
            gen, noise = (draws, None) if isinstance(draws, torch.Generator) else (None, draws)
            with _on(self.device), int8_records() as records:
                self._restore_rows(images, torch.as_tensor(ids), gen, noise)
            s, v = stack_records(records)
            slots.append(s)
            scales.append(v)
        slots, scales = torch.cat(slots), torch.cat(scales)
        self._calibrate(slots, scales, margin)
        if self._pool is not None:
            self._pool.run("calibrate", [(slots, scales, margin)] * len(self._pool.workers))
        return int(torch.unique(slots).numel())

    def _cold_forward(self, load, generator) -> torch.Tensor:
        """The cold forward: ``load()`` gives {conds, images, noise} on the
        device."""
        res = self.resolution
        with profiling.span("inputs"):
            x = load()
            b, n = x["conds"].shape[:2]
            conds = _maybe_preprocess(x["conds"].reshape(b * n, *x["conds"].shape[2:]), res)
            images = _maybe_preprocess(x["images"], res)
        out = restore_forward(
            self.params, images, conds.reshape(b, n, res, res, 3), statics=self.statics,
            timestep=self.timestep, generator=generator, noise=x["noise"],
            use_fused_attention=self.use_fused_attention,
        )
        return out["output_image"]

    def _restore_cold_rows(self, images, cond_images, generator, noise) -> torch.Tensor:
        """The cold restore of ``images`` against ``cond_images`` here."""
        with profiling.span("restore_cold", faces=cond_images.shape[0], device=self.device):
            return self._call("restore_cold", ServingEngine._cold_forward,
                              {"conds": cond_images, "images": images}, generator, noise)

    @torch.no_grad()
    def restore_cold(self, images: torch.Tensor, cond_images: torch.Tensor, *,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Cold restore: images [B, H, W, 3] with their references
        cond_images [B, N, H, W, 3] (each uint8, or float in [-1, 1]),
        re-encoded in this call -> a new [B, res, res, 3] tensor in [-1, 1].
        ``noise`` may give ``latent``/``diffusion`` [B, h, w, 4] and
        ``cond_latent``/``cond_diffusion`` [B*N, h, w, 4]. Once its key is
        captured, a call on a CUDA device replays a graph (the module's
        docstring)."""
        b, n = cond_images.shape[:2]
        if len(self.devices) == 1:
            return self._restore_cold_rows(images, cond_images, generator, noise)
        if noise is None and b % len(self.devices) == 0:  # in a one-device forward's order
            noise = self._draw(_draw_rows(True, b, n), generator)
        return self._gather(self._split_batch(
            b, noise, "restore_cold", lambda sel: (images[sel], cond_images[sel]),
            lambda sel, nz: self._restore_cold_rows(images[sel], cond_images[sel], None, nz)))
