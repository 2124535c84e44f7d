"""NN primitives over param dicts: NHWC convolutions, linears, norms,
activations, LoRA, timestep embedding, and random initialisers.

Counterpart of ``instantrestore_tpu/ops/primitives.py``. Activations keep the
JAX package's NHWC layout at every function boundary; a convolution views its
NHWC input as a channels-last NCHW tensor (a free permute), so cuDNN runs it
without a relayout copy. Only the functions are ported, not the TPU conv
formulations (im2col, space-to-depth, tap matmul, sub-pixel upsampling):
those are layout choices for the TPU's matrix unit with the same results.

The int8 serving block (``quantize_conv_int8`` ... ``apply_int8_calibration``
and the int8 branches of ``conv2d`` and ``upsample2x_conv``) is ported with
its numerics: an int8 conv dict holds ``weight_int8`` (OHWI, or the folded
upsampler's phase kernel, below), a per-output-channel ``kernel_scale`` and,
once calibrated, a static activation scale ``a_scale``. ``F.conv2d`` has no
int8 path, so the product is an im2col matmul of int8 columns by the int8
weight on ``torch._int_mm`` (int32 accumulation), in chunks that keep the
column buffer and the int32 output at or under ``INT8_CHUNK_BYTES`` each.

LoRA is data: a param dict may carry ``lora_A``/``lora_B`` (peft layouts)
and the delta ``scaling * B(A(x))`` is added by the caller-given scaling.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from instantrestore_tpu_torch import device_constant


def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


# ---------------------------------------------------------------------------
# linear / conv with optional LoRA
# ---------------------------------------------------------------------------


def dense(p: dict, x: torch.Tensor, *, lora_scaling: float = 1.0) -> torch.Tensor:
    """y = x @ W^T + b (+ scaling * (x @ A^T) @ B^T); ``weight`` [out, in]."""
    dtype = x.dtype
    y = F.linear(x, p["weight"].to(dtype), _cast(p.get("bias"), dtype))
    if "lora_A" in p:
        y = y + F.linear(F.linear(x, p["lora_A"].to(dtype)), p["lora_B"].to(dtype)) * lora_scaling
    return y


def conv2d(
    p: dict,
    x: torch.Tensor,
    *,
    stride: int = 1,
    padding: int = 1,
    lora_scaling: float = 1.0,
) -> torch.Tensor:
    """NHWC conv with an OIHW ``weight`` and optional peft conv-LoRA (a kxk
    conv in->r with the base conv's stride/padding, then a 1x1 conv r->out)."""
    if "weight_int8" in p:
        return conv2d_int8(p, x, stride=stride, padding=padding)
    dtype = x.dtype
    xc = x.permute(0, 3, 1, 2)
    y = F.conv2d(xc, p["weight"].to(dtype), _cast(p.get("bias"), dtype), stride, padding)
    if "lora_A" in p:
        a = F.conv2d(xc, p["lora_A"].to(dtype), None, stride, padding)
        y = y + F.conv2d(a, p["lora_B"].to(dtype)) * lora_scaling
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# normalisation (fp32 statistics)
# ---------------------------------------------------------------------------


def group_norm(p: dict, x: torch.Tensor, *, num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC input with fp32 statistics.

    fp32 inputs use the exact two-pass formula. Reduced-precision inputs take
    the JAX package's memory-light form: fp32 mean and mean-square reduced
    straight from the NHWC activation (no fp32 copy, no NCHW relayout), then
    one ``x * a + b`` pass with per-(batch, channel) coefficients in x's dtype.
    """
    if x.dtype == torch.float32:
        y = F.group_norm(x.permute(0, 3, 1, 2), num_groups, p["weight"].float(),
                         p["bias"].float(), eps)
        return y.permute(0, 2, 3, 1)
    b, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    xg = x.reshape(b, -1, num_groups, cg)
    n = xg.shape[1] * cg
    mean = xg.mean(dim=(1, 3), dtype=torch.float32)  # [B, G]
    m2 = torch.linalg.vector_norm(xg, dim=(1, 3), dtype=torch.float32).square() / n
    inv = torch.rsqrt((m2 - mean * mean).clamp_min(0.0) + eps)
    a = inv.repeat_interleave(cg, dim=1) * p["weight"].float()  # [B, C]
    shift = p["bias"].float() - mean.repeat_interleave(cg, dim=1) * a
    shape = (b,) + (1,) * (x.ndim - 2) + (c,)
    return torch.addcmul(shift.to(x.dtype).view(shape), x, a.to(x.dtype).view(shape))


def layer_norm(p: dict, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in fp32 and cast back."""
    y = F.layer_norm(
        x.float(), (x.shape[-1],), p["weight"].float(), p["bias"].float(), eps
    )
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# activations and resampling
# ---------------------------------------------------------------------------


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as diffusers' GEGLU uses."""
    return F.gelu(x, approximate="none")


def geglu(p: dict, x: torch.Tensor, *, lora_scaling: float = 1.0) -> torch.Tensor:
    """diffusers GEGLU: project to 2*d_ff, gate with exact GELU."""
    h, gate = dense(p, x, lora_scaling=lora_scaling).chunk(2, dim=-1)
    return h * gelu(gate)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of [B, H, W, C]."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    return y.permute(0, 2, 3, 1)


def upsample2x_conv(p: dict, x: torch.Tensor, *, lora_scaling: float = 1.0) -> torch.Tensor:
    """Nearest-2x upsample followed by a 3x3 'same' conv (an int8 dict with
    a folded kernel runs on the low-resolution grid: ``upsample2x_conv_int8``)."""
    if "weight_int8" in p and p["weight_int8"].ndim == 5:
        return upsample2x_conv_int8(p, x)
    return conv2d(p, nearest_upsample_2x(x), lora_scaling=lora_scaling)


# ---------------------------------------------------------------------------
# int8 serving convolutions (counterpart of the JAX package's int8 block)
#
# Flow, as in the JAX package:
#     q = quantize_unet_int8(merge_lora(params, s))    # int8 weights
#     q = assign_calib_slots(q)                        # unique slot ids
#     _, (slots, scales) = with_int8_records(forward)(q, batch, ...)
#     q = apply_int8_calibration(q, slots, scales)     # static a_scale
#
# Layouts: ``weight_int8`` of a k x k conv is [Cout, kh, kw, Cin] (OHWI), so
# ``reshape(Cout, -1).t()`` is the [K, Cout] operand of the product with no
# copy, column-major: on an H100 cuBLASLt refuses a row-major int8 operand
# at some M and ran it 4-7x slower where it took it. A folded upsampler's is
# the phase kernel [4, Cout, 3, 3, Cin] (below).
# ---------------------------------------------------------------------------

INT8_CHUNK_BYTES = 1 << 30  # column buffer and int32 output of one product, each
# while ``int8_records`` is open, the dynamic branch appends (calib_slot, max
# observed activation scale) of every conv that has a slot
_CALIB_RECORDS: contextvars.ContextVar = contextvars.ContextVar("int8_calib_records",
                                                                default=None)
# the folded 4x4 kernel K4 on the low-resolution grid padded by 1: output
# phase a reads window rows r with K4 rows u, (r, u) in _FOLD_TAPS[a] (the
# same for columns); the other window taps of a phase are zero
_FOLD_TAPS = {0: ((0, 0), (1, 2)), 1: ((1, 1), (2, 3))}


def phase_kernel(k4: torch.Tensor) -> torch.Tensor:
    """Folded kernel K4 [4, 4, Cin, Cout] (HWIO) -> the phase kernel
    [4 (phase 2a + b), Cout, 3, 3, Cin] of the 3x3 windows of the padded
    low-resolution input, zero at the taps a phase does not read."""
    cin, cout = k4.shape[2:]
    w = k4.new_zeros((4, cout, 3, 3, cin))
    for a in (0, 1):
        for b in (0, 1):
            for r, u in _FOLD_TAPS[a]:
                for s, v in _FOLD_TAPS[b]:
                    w[2 * a + b, :, r, s, :] = k4[u, v].t()
    return w


def folded_kernel(w: torch.Tensor) -> torch.Tensor:
    """Inverse of ``phase_kernel``: [4, Cout, 3, 3, Cin] -> K4 [4, 4, Cin, Cout]."""
    cout, cin = w.shape[1], w.shape[4]
    k4 = w.new_empty((4, 4, cin, cout))
    for a in (0, 1):
        for b in (0, 1):
            for r, u in _FOLD_TAPS[a]:
                for s, v in _FOLD_TAPS[b]:
                    k4[u, v] = w[2 * a + b, :, r, s, :].t()
    return k4


def _quantize_act_int8(p: dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x as int8, its fp32 scale): the static ``a_scale`` (0-d) when the
    conv is calibrated, else a per-sample dynamic scale [B, 1, 1, 1], max
    |x| over (H, W, C) / 127 floored at 1e-12, recorded when
    ``int8_records`` is open and the conv has a slot. Round half to even,
    clip to +-127. The fp32 copy is made a few samples at a time."""
    if "a_scale" in p:
        a_scale = p["a_scale"].float()
    else:
        amax = x.abs().amax(dim=(1, 2, 3), keepdim=True).float()
        a_scale = torch.clamp_min(amax / 127.0, 1e-12)
        records = _CALIB_RECORDS.get()
        if records is not None and "calib_slot" in p:
            records.append((p["calib_slot"], a_scale.max()))
    x8 = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    step = max(1, INT8_CHUNK_BYTES // (4 * max(1, x[0].numel())))
    for b0 in range(0, x.shape[0], step):
        s = a_scale if a_scale.ndim == 0 else a_scale[b0:b0 + step]
        x8[b0:b0 + step] = (x[b0:b0 + step].float() / s).round_().clamp_(-127, 127)
    return x8, a_scale


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 a [M, K] times int8 b [K, N] -> int32 [M, N] (``torch._int_mm``).
    On CUDA it takes only M > 16 and K, N multiples of 8; other shapes raise
    here, before the call."""
    m, k = a.shape
    n = b.shape[1]
    if a.is_cuda and (m <= 16 or k % 8 or n % 8):
        raise ValueError(f"torch._int_mm on CUDA takes M > 16 and K, N multiples of 8; "
                         f"got M={m}, K={k}, N={n}")
    return torch._int_mm(a, b)


def _packed(x8: torch.Tensor) -> torch.Tensor:
    """A contiguous int8 NHWC tensor viewed with its channels packed into
    the widest integer type whose width divides Cin: the column copies then
    move 8 bytes an element instead of 1 (the same bytes)."""
    for dtype, width in ((torch.int64, 8), (torch.int32, 4), (torch.int16, 2)):
        if x8.shape[-1] % width == 0:
            return x8.view(dtype)
    return x8


def _int8_product(x8p: torch.Tensor, taps: List[Tuple[int, int]], stride: int, ho: int,
                  wo: int, wmat: torch.Tensor, emit: Callable[..., None]) -> None:
    """The im2col product of the padded int8 NHWC activation ``x8p``: for
    each chunk of samples and output rows, the columns [rows, len(taps) *
    Cin] (the taps' strided views concatenated on the channel axis in
    (kh, kw, Cin) order) times ``wmat`` [K, N], handed to ``emit(b0, b1, i0,
    i1, acc [b1 - b0, i1 - i0, wo, N] int32)``."""
    bsz = x8p.shape[0]
    xp = _packed(x8p.contiguous())
    k, n = wmat.shape
    cap = max(1, min(INT8_CHUNK_BYTES // k, INT8_CHUNK_BYTES // (4 * n)))
    if cap >= ho * wo:
        nb, hc = min(bsz, cap // (ho * wo)), ho
    else:
        nb, hc = 1, max(1, cap // wo)
    for b0 in range(0, bsz, nb):
        b1 = min(bsz, b0 + nb)
        for i0 in range(0, ho, hc):
            i1 = min(ho, i0 + hc)
            views = [xp[b0:b1, di + stride * i0: di + stride * (i1 - 1) + 1: stride,
                        dj: dj + stride * (wo - 1) + 1: stride] for di, dj in taps]
            cols = views[0] if len(views) == 1 else torch.cat(views, dim=-1)
            acc = int8_matmul(cols.contiguous().view(torch.int8).reshape(-1, k), wmat)
            emit(b0, b1, i0, i1, acc.view(b1 - b0, i1 - i0, wo, n))


def _epilogue(acc: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
              out: torch.Tensor) -> None:
    """``out = (acc.float() * scale).to(out.dtype) + bias``, the bias added
    in ``out.dtype``, as the JAX package's int8 branches do (the int32 by
    fp32 product promotes to fp32 in one pass)."""
    y = torch.mul(acc, scale).to(out.dtype)
    if bias is None:
        out.copy_(y)
    else:
        torch.add(y, bias.to(out.dtype), out=out)


def conv2d_int8(p: dict, x: torch.Tensor, *, stride: int = 1, padding: int = 1) -> torch.Tensor:
    """int8 x int8 NHWC conv of an int8 conv dict (``quantize_conv_int8``):
    the activation quantized (``_quantize_act_int8``), the im2col product
    accumulated in int32, dequantized by ``a_scale * kernel_scale`` and the
    bias added in x's dtype. A 1x1 conv's columns are the activation itself;
    a stride-2 conv's are strided views."""
    w8 = p["weight_int8"]
    cout, kh, kw, _ = w8.shape
    x8, a_scale = _quantize_act_int8(p, x)
    if padding:
        x8 = F.pad(x8, (0, 0, padding, padding, padding, padding))
    ho = (x8.shape[1] - kh) // stride + 1
    wo = (x8.shape[2] - kw) // stride + 1
    scale = a_scale * p["kernel_scale"].float()  # [Cout] or [B, 1, 1, Cout]
    out = torch.empty((x.shape[0], ho, wo, cout), dtype=x.dtype, device=x.device)

    def emit(b0, b1, i0, i1, acc):
        _epilogue(acc, scale if scale.ndim == 1 else scale[b0:b1], p.get("bias"),
                  out[b0:b1, i0:i1])

    _int8_product(x8, [(i, j) for i in range(kh) for j in range(kw)], stride, ho, wo,
                  w8.reshape(cout, -1).t(), emit)
    return out


def upsample2x_conv_int8(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Nearest-2x upsample + 3x3 conv of an int8 dict whose kernel was folded
    (``quantize_conv_int8(fold_upsample=True)``), on the low-resolution
    grid: one product of the 3x3 windows of x padded by 1 with the phase
    kernel [9 Cin, 4 Cout] gives the four output phases of each input
    pixel, interleaved into the 2x grid as they are written. The same
    integers as the JAX package's lhs-dilated 4x4 conv; the zero-inserted
    grid is never built. An unfolded int8 kernel runs on the materialised
    grid (``upsample2x_conv``)."""
    w8 = p["weight_int8"]
    cout = w8.shape[1]
    bsz, h, w = x.shape[:3]
    x8, a_scale = _quantize_act_int8(p, x)
    x8 = F.pad(x8, (0, 0, 1, 1, 1, 1))
    scale = a_scale * p["kernel_scale"].float()
    out = torch.empty((bsz, 2 * h, 2 * w, cout), dtype=x.dtype, device=x.device)
    out6 = out.view(bsz, h, 2, w, 2, cout)

    def emit(b0, b1, i0, i1, acc):  # acc [.., w, (a, b, Cout)] -> out rows (i, a, j, b)
        s = scale if scale.ndim == 1 else scale[b0:b1].view(-1, 1, 1, 1, 1, cout)
        _epilogue(acc.view(b1 - b0, i1 - i0, w, 2, 2, cout), s, p.get("bias"),
                  out6[b0:b1, i0:i1].permute(0, 1, 3, 2, 4, 5))

    _int8_product(x8, [(i, j) for i in range(3) for j in range(3)], 1, h, w,
                  w8.reshape(4 * cout, -1).t(), emit)
    return out


def quantize_conv_int8(p: dict, *, fold_upsample: bool = False) -> dict:
    """Conv dict -> int8 conv dict: symmetric per-output-channel
    quantization of the fp32 kernel (``weight_int8``, ``kernel_scale``).
    ``fold_upsample``: for a 3x3 conv only ever applied through
    ``upsample2x_conv``, quantize the folded 4x4 subpixel kernel, summed
    in fp32 in the JAX package's order before it is rounded. LoRA must be
    merged first."""
    if "lora_A" in p:
        raise ValueError("merge LoRA before int8 quantization")
    k = p["weight"].float().permute(2, 3, 1, 0)  # HWIO, as the JAX package quantizes it
    fold = fold_upsample and k.shape[0] == 3 and k.shape[1] == 3
    if fold:
        kp = F.pad(k, (0, 0, 0, 0, 1, 1, 1, 1))
        k = kp[:-1, :-1] + kp[1:, :-1] + kp[:-1, 1:] + kp[1:, 1:]  # [4, 4, Cin, Cout]
    scale = torch.clamp_min(k.abs().amax(dim=(0, 1, 2)) / 127.0, 1e-12)
    k8 = torch.round(k / scale).clamp_(-127, 127).to(torch.int8)
    q = {kk: v for kk, v in p.items() if kk != "weight"}
    q["weight_int8"] = phase_kernel(k8) if fold else k8.permute(3, 0, 1, 2).contiguous()
    q["kernel_scale"] = scale
    return q


def quantize_block_convs_int8(bp: dict) -> dict:
    """int8 the conv mass of one block dict: the resnets' conv1, conv2 and
    conv_shortcut and the down/upsampler convs; every other leaf stays.
    Upsampler kernels are always folded (the JAX package folds them under
    its accelerators' default subpixel mode "3")."""

    def q_res(rp):
        rp = dict(rp)
        for name in ("conv1", "conv2", "conv_shortcut"):
            if name in rp:
                rp[name] = quantize_conv_int8(rp[name])
        return rp

    nb = dict(bp)
    if "resnets" in nb:
        nb["resnets"] = [q_res(r) for r in nb["resnets"]]
    for samplers in ("downsamplers", "upsamplers"):
        if samplers in nb:
            nb[samplers] = [{**s, "conv": quantize_conv_int8(
                s["conv"], fold_upsample=samplers == "upsamplers")} for s in nb[samplers]]
    return nb


def _map_int8_convs(tree: Any, fn: Callable[[dict], dict]) -> Any:
    """``tree`` rebuilt with ``fn`` applied to every int8 conv dict
    (post-order; the given dicts are not mutated)."""
    if isinstance(tree, dict):
        new = {k: _map_int8_convs(v, fn) for k, v in tree.items()}
        return fn(new) if "weight_int8" in new else new
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_int8_convs(v, fn) for v in tree)
    return tree


def assign_calib_slots(tree: Any) -> Any:
    """Give every int8 conv dict a unique ``calib_slot`` (an int32 0-d
    tensor, in tree-walk order) that keys its records back to it."""
    counter = [0]

    def tag(p):
        p = dict(p)
        p["calib_slot"] = torch.tensor(counter[0], dtype=torch.int32,
                                       device=p["weight_int8"].device)
        counter[0] += 1
        return p

    return _map_int8_convs(tree, tag)


@contextlib.contextmanager
def int8_records():
    """Collect the calibration records of the block's forwards: yields a
    list that fills with (calib_slot, observed scale) tensors, one per
    dynamic int8 conv call of a conv that has a slot."""
    records: list = []
    token = _CALIB_RECORDS.set(records)
    try:
        yield records
    finally:
        _CALIB_RECORDS.reset(token)


def stack_records(records: list) -> Tuple[torch.Tensor, torch.Tensor]:
    """Records -> (slots int32 [R], scales fp32 [R]) on the CPU."""
    if not records:
        return torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.float32)
    return (torch.stack([torch.as_tensor(s).to("cpu", torch.int32) for s, _ in records]),
            torch.stack([v.to("cpu", torch.float32) for _, v in records]))


def with_int8_records(fn: Callable) -> Callable:
    """``wrapped(*a, **k) -> (fn(*a, **k), (slots [R], scales [R]))``: the
    call's calibration records (``int8_records``). Convs that already
    carry a static ``a_scale`` record nothing."""

    def wrapped(*args, **kwargs):
        with int8_records() as records:
            out = fn(*args, **kwargs)
        return out, stack_records(records)

    return wrapped


def apply_int8_calibration(tree: Any, slots, scales, *, margin: float = 1.0) -> Any:
    """Bake observed activation scales into ``tree`` as static per-conv
    ``a_scale`` leaves (fp32 0-d, on the conv's device): a conv observed
    several times keeps its max, times ``margin``, floored at 1e-12, and
    loses its slot. A conv never observed keeps its slot and stays
    dynamic."""
    by_slot: dict = {}
    for s, v in zip(np.asarray(torch.as_tensor(slots).cpu()).tolist(),
                    np.asarray(torch.as_tensor(scales).cpu(), np.float32).tolist()):
        by_slot[s] = max(by_slot.get(s, 0.0), float(v))

    def bake(p):
        slot = p.get("calib_slot")
        if slot is None or int(slot) not in by_slot:
            return p
        p = {k: v for k, v in p.items() if k != "calib_slot"}
        p["a_scale"] = torch.tensor(max(by_slot[int(slot)] * margin, 1e-12), dtype=torch.float32,
                                    device=p["weight_int8"].device)
        return p

    return _map_int8_convs(tree, bake)


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    *,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: int = 10000,
) -> torch.Tensor:
    """Sinusoidal embedding [B] -> [B, dim] fp32 (diffusers
    get_timestep_embedding), with the same explicit mod-2pi range reduction
    as the JAX package."""
    half = dim // 2
    freqs = device_constant(
        ("timestep_freqs", half, downscale_freq_shift, max_period), timesteps.device,
        lambda: np.exp(-np.log(max_period) * np.arange(half)
                       / (half - downscale_freq_shift)).astype(np.float32))
    args = timesteps.float()[:, None] * freqs[None, :]
    two_pi = 2.0 * math.pi
    args = args - two_pi * torch.floor(args / two_pi)
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


# ---------------------------------------------------------------------------
# random initialisers (random weights for smoke runs; real weights arrive
# through convert.py). Same distributions as the JAX package's initialisers.
# ---------------------------------------------------------------------------


def _uniform(gen: torch.Generator, shape, bound: float, device) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0) * bound


def init_dense(gen, in_dim: int, out_dim: int, *, bias: bool = True, device=None) -> dict:
    p = {"weight": _uniform(gen, (out_dim, in_dim), 1.0 / math.sqrt(in_dim), device)}
    if bias:
        p["bias"] = torch.zeros(out_dim, device=device)
    return p


def init_conv2d(gen, in_ch: int, out_ch: int, kernel_size: int = 3, *, device=None) -> dict:
    bound = 1.0 / math.sqrt(in_ch * kernel_size * kernel_size)
    return {
        "weight": _uniform(gen, (out_ch, in_ch, kernel_size, kernel_size), bound, device),
        "bias": torch.zeros(out_ch, device=device),
    }


def init_norm(dim: int, *, device=None) -> dict:
    return {"weight": torch.ones(dim, device=device), "bias": torch.zeros(dim, device=device)}


def add_lora(p: dict, gen, rank: int, *, b_std: float, device=None) -> dict:
    """Attach peft-layout LoRA factors: A ~ N(0, 1/rank) (peft "gaussian"),
    B ~ N(0, b_std) (peft starts B at zero; a nonzero ``b_std`` gives random
    smoke weights a LoRA delta that merging actually changes)."""
    w = p["weight"]
    out_ch, in_ch = w.shape[:2]
    a_shape = (rank, in_ch) + tuple(w.shape[2:])
    b_shape = (out_ch, rank) + ((1, 1) if w.ndim == 4 else ())
    p = dict(p)
    p["lora_A"] = torch.randn(a_shape, generator=gen, device=device) / rank
    p["lora_B"] = torch.randn(b_shape, generator=gen, device=device) * b_std
    return p
