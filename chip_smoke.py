#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit);
2. builds the CUDA kernels of instantrestore_tpu_torch/csrc (one nvcc each,
   in parallel) and prints the build seconds;
3. kernel phase: each kernel at the shapes a batch-16 restore gives it,
   bf16, held against its plain PyTorch version (max-abs error within a
   stated tolerance) and timed beside the plain version, one PyTorch
   library call on the same inputs (scaled_dot_product_attention, timed
   here only) and the card's bound for the same work;
4. slice phase: random full-width SD-Turbo weights (seeded), LoRA rank 32
   merged by serving_bundle, bf16; onboards 16 identities x 4 uint8 512^2
   references and restores batch 16 a few times. Checks the output
   ([16, 512, 512, 3] and finite; restore clamps it to [-1, 1], so the
   range holds by construction and is not checked), the kernel launch counts of the
   main path (9 + 9 per restore, 17 flash launches per onboarded identity),
   agreement with the unfused path on two samples, and that replacing one
   identity's references changes exactly that identity's outputs;
5. prints {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result.
It needs a CUDA device and the repository beside it.
"""

from __future__ import annotations

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
# (heads, tokens, launches per restore) of the main path at 512 px, head dim 64
SHARED_SHAPES = [(20, 256, 3), (10, 1024, 3), (5, 4096, 3)]
FLASH_SHAPES = [(5, 4096, 64, 2), (10, 1024, 64, 2), (20, 256, 64, 2), (20, 64, 64, 1),
                (1, 4096, 512, 2)]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


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
    output against its plain version; raises when either is exceeded."""
    import torch

    o, r = out.float(), ref.float()
    err, tol = float((o - r).abs().max()), tolerance(r)
    rel_rms = float((o - r).norm() / r.norm())
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

    results = []

    # kernel 1: identity-cached shared attention (ids shuffled, with repeats)
    ids = torch.tensor([3, 7, 7, 0, 15, 2, 3, 9, 12, 7, 1, 0, 5, 15, 8, 3], device=dev)
    rows = []
    for h, s, per_restore in SHARED_SHAPES:
        d = 64
        q, v_in = rnd(BATCH, h, s, d), rnd(BATCH, h, s, d)
        rk, rv = rnd(N_IDENT, N_REFS, h, s, d), rnd(N_IDENT, N_REFS, h, s, d)
        (cache,) = sa.build_identity_kv_cache([(rk, rv)])
        scale = d ** -0.5
        call = lambda: sa.shared_attention_identity(q, None, v_in, cache, ids, scale=scale,
                                                    use_adain=True)
        out = call()
        torch.cuda.synchronize()
        vs, vh = sa.adain_affine_from_stats(v_in, cache.content_mean[ids], cache.content_std[ids])
        aff = torch.stack([vs, vh], dim=3).contiguous()
        plain = lambda: sa.shared_identity_plain(q, rk, rv, aff, cache.kmax, ids, scale=scale)
        ref = plain()
        err, tol, rel_rms = compare(f"shared_identity H={h} S={s}", out, ref)
        keys = rk[ids].permute(0, 2, 1, 3, 4).reshape(BATCH, h, N_REFS * s, d).contiguous()
        vals = (rv[ids].permute(0, 2, 1, 3, 4).float() * vs[:, :, :, None]
                + vh[:, :, :, None]).to(bf).reshape(BATCH, h, N_REFS * s, d).contiguous()
        lib = lambda: F.scaled_dot_product_attention(q, keys, vals, scale=scale)
        n_keys = N_REFS * s
        uniq = int(torch.unique(ids).numel())
        nbytes = (2 * BATCH * h * s * d * 2 + 2 * uniq * N_REFS * h * s * d * 2
                  + BATCH * h * N_REFS * 2 * d * 4 + uniq * h * 4 + BATCH * 8)
        b_ms, b_by = bound(4.0 * BATCH * h * s * n_keys * d, nbytes)
        rows.append(dict(heads=h, tokens=s, keys=n_keys, per_restore=per_restore,
                         max_abs_err=err, tol=tol, rel_rms=rel_rms,
                         ms=cuda_ms(call, 10), plain_ms=cuda_ms(plain, 2),
                         library_ms=cuda_ms(lib, 10), bound_ms=b_ms, bound_by=b_by))
        del q, v_in, rk, rv, cache, keys, vals, aff, out, ref
        torch.cuda.empty_cache()
    results.append(("shared_identity_attention", "instantrestore_tpu_torch/csrc/shared_identity.cu",
                    "instantrestore_tpu/ops/shared_attention.py:803", rows))

    # kernel 2: plain bound-softmax flash attention
    rows = []
    for h, s, d, per_restore in FLASH_SHAPES:
        q, k, v = rnd(BATCH, h, s, d), rnd(BATCH, h, s, d), rnd(BATCH, h, s, d)
        scale = d ** -0.5
        call = lambda: sa.flash_attention(q, k, v, scale=scale)
        out = call()
        torch.cuda.synchronize()
        plain = lambda: sa.flash_attention_plain(q, k, v, scale=scale)
        ref = plain()
        err, tol, rel_rms = compare(f"flash_bound H={h} S={s} d={d}", out, ref)
        lib = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
        b_ms, b_by = bound(4.0 * BATCH * h * s * s * d, 4 * BATCH * h * s * d * 2 + BATCH * h * 4)
        rows.append(dict(heads=h, tokens=s, head_dim=d, per_restore=per_restore,
                         max_abs_err=err, tol=tol, rel_rms=rel_rms,
                         ms=cuda_ms(call, 10), plain_ms=cuda_ms(plain, 2),
                         library_ms=cuda_ms(lib, 10), bound_ms=b_ms, bound_by=b_by))
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    results.append(("flash_attention_bound", "instantrestore_tpu_torch/csrc/flash_bound.cu",
                    "instantrestore_tpu/ops/shared_attention.py:174", rows))

    for name, _, _, rows in results:
        for r in rows:
            print(f"kernel {name} {json.dumps(r)} [{card}]")
    return results


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


def measure_slack(engine, images, ids, noise):
    """One restore with every attention call recording its bound slack."""
    from instantrestore_tpu_torch.models import attention as attn_mod
    from instantrestore_tpu_torch.models import vae as vae_mod

    flash, ident = attn_mod.flash_attention, attn_mod.shared_attention_identity
    records = []

    def flash_rec(q, k, v, *, scale):
        records.append(("flash_attention_bound", tuple(q.shape), _slack(q, k, scale)))
        return flash(q, k, v, scale=scale)

    def ident_rec(q, k_in, v_in, cache, ids_, *, scale, use_adain):
        b, h, _, d = q.shape
        n, s = cache.rk.shape[1], cache.rk.shape[3]
        keys = cache.rk[ids_].permute(0, 2, 1, 3, 4).reshape(b, h, n * s, d)
        records.append(("shared_identity_attention", tuple(q.shape), _slack(q, keys, scale)))
        return ident(q, k_in, v_in, cache, ids_, scale=scale, use_adain=use_adain)

    attn_mod.flash_attention, vae_mod.flash_attention = flash_rec, flash_rec
    attn_mod.shared_attention_identity = ident_rec
    try:
        engine.restore(images, ids, noise=noise)
    finally:
        attn_mod.flash_attention, vae_mod.flash_attention = flash, flash
        attn_mod.shared_attention_identity = ident
    for name, shape, slack in records:
        print(f"bound slack {name} q{list(shape)}: max {slack:.2f} log2 units (rows flush beyond ~190)")
    return max(r[2] for r in records)


def profile_restore(engine, images, ids, noise, card: str):
    """Device time of one restore by kernel, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.restore(images, ids, noise=noise)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.device_time_total > 0:
            tot, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.device_time_total / 1e3, cnt + 1)
    busy = sum(t for t, _ in by_name.values())
    if busy == 0:
        print("profiler: no device time recorded")
        return
    print(f"profile of one restore [{card}]: device busy {busy:.1f} ms of {wall_ms:.1f} ms wall "
          f"(profiler on); kernels by device time:")
    for name, (t, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {t:8.2f} ms {t / busy * 100:5.1f}%  x{cnt:<4d} {name[:110]}")


def slice_phase(card: str):
    """The warm-identity serving path at full width; returns launch counts."""
    import torch

    from instantrestore_tpu_torch.inference.serving import ServingEngine
    from instantrestore_tpu_torch.models.restorer import (
        RestorerStatics,
        init_restorer_params,
        serving_bundle,
    )
    from instantrestore_tpu_torch.ops import shared_attention as sa

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

    # warm-up: a one-identity onboarding takes cuDNN's first-call set-up, so
    # that the onboarding time below is a steady figure
    engine.onboard(refs[:1], generator=torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()

    # ---- main path: onboarding, then restores ----
    sa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.onboard(refs, generator=torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    onboard_s = time.perf_counter() - t0
    onboard_counts = (sa.shared_attention_identity.launches, sa.flash_attention.launches)

    lat_s, out = [], None
    for _ in range(RESTORE_RUNS + 1):  # the first run includes cuDNN's first-call set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.restore(images, ids, noise=noise)
        torch.cuda.synchronize()
        lat_s.append(time.perf_counter() - t0)
    restore_counts = (sa.shared_attention_identity.launches - onboard_counts[0],
                      sa.flash_attention.launches - onboard_counts[1])
    total_counts = (sa.shared_attention_identity.launches, sa.flash_attention.launches)
    n_restores = RESTORE_RUNS + 1
    failures = []
    print(f"launches: onboarding {onboard_counts}, {n_restores} restores {restore_counts} "
          "(shared_identity, flash_bound)")
    if onboard_counts != (0, 17 * N_IDENT):
        failures.append(f"onboarding launches {onboard_counts}, expected (0, {17 * N_IDENT})")
    if restore_counts != (9 * n_restores, 9 * n_restores):
        failures.append(f"restore launches {restore_counts}, expected 9 + 9 per restore")
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

    measure_slack(engine, images, ids, noise)
    profile_restore(engine, images, ids, noise, card)

    # ---- replacing one identity's refs changes exactly its samples ----
    slot = int(ids[0])
    new_refs = torch.randint(0, 256, (N_REFS, RES, RES, 3), dtype=torch.uint8, generator=host)
    engine.onboard_one(new_refs, slot, generator=torch.Generator(device=dev).manual_seed(3))
    out2 = engine.restore(images, ids, noise=noise)
    per_sample = (out2.float() - out.float()).abs().flatten(1).amax(dim=1).cpu()
    hit = ids == slot
    print(f"identity {slot} replaced: max-abs change on its samples "
          f"{per_sample[hit].tolist()}, on the others {float(per_sample[~hit].max()):.2e}")
    if float(per_sample[hit].min()) < 1e-2 or float(per_sample[~hit].max()) > 1e-3:
        failures.append("replacing an identity did not change exactly its outputs")
    if failures:
        raise AssertionError("slice phase failed: " + "; ".join(failures))
    return total_counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from instantrestore_tpu_torch.ops import _build

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  ptxas {name}: {line.strip()}")

    results = kernel_phase(card)
    launches = slice_phase(card)
    counts = {"shared_identity_attention": launches[0], "flash_attention_bound": launches[1]}
    kernels = []
    for name, source, replaces, rows in results:
        b_ms = sum(r["bound_ms"] * r["per_restore"] for r in rows)
        ops_ms = sum(r["bound_ms"] * r["per_restore"] for r in rows if r["bound_by"] == "operations")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            # times are per restore: each shape's time times its launches per restore
            "ms": sum(r["ms"] * r["per_restore"] for r in rows),
            "plain_ms": sum(r["plain_ms"] * r["per_restore"] for r in rows),
            "bound_ms": b_ms,
            "bound_by": "operations" if ops_ms >= b_ms / 2 else "bytes",
            "library_ms": sum(r["library_ms"] * r["per_restore"] for r in rows),
            "shapes": rows,
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
