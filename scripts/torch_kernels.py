#!/usr/bin/env python3
"""The hand-written attention kernels of the PyTorch port on one NVIDIA GPU:
a quick check against their plain versions, and a comparison of two trees.

    python3 scripts/torch_kernels.py --check [--kernels NAMES]
    python3 scripts/torch_kernels.py --run DIR [--tree PATH] [--kernels NAMES]
    python3 scripts/torch_kernels.py --compare DIR_A DIR_B

``--kernels`` names sources of ``instantrestore_tpu_torch/csrc`` (comma
separated, any of the nine; default: shared_identity and shared_flash_bound,
rows 1, 1b and 3 of PERF.md's table).

``--check`` builds the named sources, prints ptxas's registers, spills and
every ``C75xx`` note that wgmma batches were serialised, for each kernel
instantiation, then launches each named kernel through its wrapper at the
shapes of a batch-16 restore at 512 px and at small shapes that take its
other tiles and its ragged ends (Sq or Skv off the 64-row tile, d = 64), and
prints for each the max-abs and relative RMS error against
its plain version, whether two launches agree bit for bit, and the time per
launch; for flash_fwd_lse also the LSE's max-abs error (at most 1e-3 log2
units). For the bound shared kernels it also checks that an id outside the
identity cache makes exactly its sample's outputs NaN, and that a call whose
bound slack passes 190 log2 units comes out non-finite. It exits 1 if a
shape is outside max-abs 1e-3 + 1e-2 max|ref|, relative RMS 1e-2, or a
check fails.

``--run DIR`` imports the port from ``--tree`` (default: the tree this script
lies in), runs the named kernels at the 512 px shapes, writes their outputs
to DIR and prints their times (CUDA events over 10 calls, and the device
time alone from torch.profiler: the smallest shapes are paced by the host)
and what one tiny call of each costs the host, and
prints a SHA-256 over the outputs of every other kernel on fixed seeded
inputs (the backward kernels take their residuals from the plain forward on
a fixed chunk, so the hash does not see the forward kernel). ``--compare``
reads two such directories and prints, per output, max-abs, relative RMS and
max-abs in bf16 ulps at max |A| of B against A (and whether the two are
bit-identical), the times side by side, and whether the hashes agree (exit 1
if not).
Run the old tree and the new one in turns on one card (old, new, new, old)
to compare times.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import time

BATCH, N_IDENT, N_REFS, D = 16, 16, 4, 64
SHARED_SHAPES = [(20, 256), (10, 1024), (5, 4096)]  # (heads, tokens) of the 9 shared layers
# (batch, heads, Sq, S) of the shared kernels' other tiles: one consumer
# warpgroup a block; a 64-key chunk; both; the smallest call
SMALL_SHAPES = [(2, 4, 192, 256), (2, 4, 256, 64), (2, 2, 64, 192), (3, 2, 64, 64)]
# (batch, heads, Sq, S) of the shared kernels at ragged shapes (Sq or S off
# 64, as a UNet at sample_size 8, 16, 24 or 32 gives them): a 128-key tile
# cut at 144 and at 100 keys, one masked 64-key tile of 36, 16, 9, 4 and 1
RAGGED_SHAPES = [(2, 4, 144, 144), (2, 4, 200, 100), (2, 4, 36, 36), (2, 2, 16, 16),
                 (2, 2, 9, 9), (2, 4, 4, 4), (2, 2, 1, 1)]
FLASH_SHAPES = [(5, 4096, 64), (10, 1024, 64), (20, 256, 64), (20, 64, 64), (1, 4096, 512)]
# flash_bound and flash_online at d=512 also at the cold capture's batch of 64
# (the VAE mid attention of 64 references' encode); (batch, heads, tokens,
# head dim)
FLASH_CAPTURE_D512 = (64, 1, 4096, 512)
# (heads, queries, keys, head dim) of the flash-VJP kernels at batch 2
VJP_SHAPES = [(5, 4096, 16384, 64), (10, 1024, 4096, 64), (20, 64, 64, 64), (1, 4096, 4096, 512)]
# (batch, heads, Sq, Skv, head dim) of the plain kernels' other tiles: the
# smallest call; one consumer warpgroup a block (Sq % 128 == 64) on 128-key
# chunks; the 64-key chunk (128 does not divide Skv); d = 512. The backward
# tile (ops/flash_vjp.py: flash_bwd_tiles) takes 64 query rows a block of
# flash_bwd_dq in the second and 64 keys a block of flash_bwd_dkv in the third
# (chip_smoke.py's FLASH_VARIANT_SHAPES).
FLASH_SMALL_SHAPES = [(2, 2, 64, 128, 64), (2, 4, 192, 256, 64), (2, 4, 256, 320, 64),
                      (2, 1, 64, 64, 512)]
# the d = 512 tiles also at Sq != Skv with three 32-key tiles, the
# backward's with a ragged last block of 64 keys (chip_smoke.py's
# FLASH_VARIANT_D512)
FLASH_SMALL_D512 = [(2, 2, 192, 96, 512)]
# the plain and backward kernels at ragged shapes (d = 64): (batch, heads, Sq,
# Skv, head dim)
FLASH_RAGGED_SHAPES = [(2, 4, 144, 144, 64), (2, 4, 100, 200, 64), (2, 4, 200, 100, 64),
                       (2, 2, 36, 36, 64), (2, 2, 16, 16, 64), (2, 2, 9, 9, 64),
                       (2, 4, 4, 4, 64), (2, 2, 1, 1, 64)]
LSE_TOL = 1e-3  # max-abs of the LSE against the plain version, log2 units
IDS = [3, 7, 7, 0, 15, 2, 3, 9, 12, 7, 1, 0, 5, 15, 8, 3]
SOURCES = ("shared_identity", "flash_bound", "shared_flash_bound", "flash_fwd_lse",
           "flash_bwd_dq", "flash_bwd_dkv", "shared_online", "flash_online", "shared_online_pair")
DEFAULT_KERNELS = ("shared_identity", "shared_flash_bound")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 10) -> float:
    """Device time of one call: every kernel, copy and fill it launches, from
    torch.profiler over ``reps`` calls. Unlike ``cuda_ms`` it does not read
    the host's time where the host, not the device, paces the calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.device_time_total > 0)
    if total_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total_us / 1e3 / reps


def host_us(fn, reps: int = 300) -> float:
    """Host time to enqueue one call (the wrapper's checks, the C entry point
    with whatever it prepares on the host, the launch), with the device kept
    behind: microseconds per call over ``reps`` calls, one synchronise at the
    end."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def outputs(result) -> tuple:
    """A kernel's outputs as a tuple: (out,), or flash_fwd_lse's (out, lse)."""
    return result if isinstance(result, tuple) else (result,)


def errors(out, ref):
    """(max-abs, its tolerance, relative RMS). A reference that is zero up
    to rounding (|ref| <= 1e-5 everywhere: dQ over a single key) has no
    relative error; its relative RMS is reported as 0 and max-abs judges."""
    o, r = out.float(), ref.float()
    top = float(r.abs().max())
    rel = float((o - r).norm() / r.norm()) if top > 1e-5 else 0.0
    return float((o - r).abs().max()), 1e-3 + 1e-2 * top, rel


def cases(source: str, g, small: bool = False):
    """(label, run, plain) of ``source``'s kernel at the 512 px shapes (or,
    ``small``, at the small shapes of its other tiles): ``run()`` launches it
    through its wrapper, ``plain()`` is its plain version on the same
    inputs. Inputs are drawn from ``g`` as the cases are reached."""
    import torch

    from instantrestore_tpu_torch.ops import flash_vjp as fv
    from instantrestore_tpu_torch.ops import shared_attention as sa

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    scale = D ** -0.5
    shapes = SMALL_SHAPES + RAGGED_SHAPES if small else [(BATCH, h, s, s)
                                                         for h, s in SHARED_SHAPES]
    if source in ("shared_identity", "shared_flash_bound", "shared_online", "shared_online_pair"):
        for b, h, sq, s in shapes:
            tag = f"B={b} H={h} Sq={sq} S={s}"
            q, k_in, v_in = rnd(b, h, sq, D), rnd(b, h, s, D), rnd(b, h, s, D)
            rk, rv = rnd(b, N_REFS, h, s, D), rnd(b, N_REFS, h, s, D)
            rk[1, N_REFS - 1] = 0  # a masked reference: zeroed, still attended
            rv[1, N_REFS - 1] = 0
            # AdaIN's unbiased std over one token is undefined (NaN, in JAX
            # too): a one-token segment takes a random affine instead
            adain = s > 1
            vs, vh = sa.adain_affine(v_in, rv) if adain else (
                1 + 0.1 * rnd(b, h, N_REFS, D).float(), 0.1 * rnd(b, h, N_REFS, D).float())
            aff = torch.stack([vs, vh], dim=3).contiguous()

            def per_call(algo, inc, q=q, k_in=k_in, v_in=v_in, rk=rk, rv=rv, vs=vs, vh=vh):
                return lambda: sa.shared_flash_attention(q, k_in, v_in, rk, rv, scale=scale,
                                                         v_affine=(vs, vh), include_input=inc,
                                                         algo=algo)

            if source == "shared_identity":
                # row 1: the identity cache by id; row 1b: per-call, rows arange(B)
                n_ident = max(IDS[:b]) + 1
                crk, crv = rnd(n_ident, N_REFS, h, s, D), rnd(n_ident, N_REFS, h, s, D)
                (cache,) = sa.build_identity_kv_cache([(crk, crv)])
                ids = torch.tensor(IDS[:b], device="cuda")
                cs, ch = sa.adain_affine_from_stats(v_in, cache.content_mean[ids],
                                                    cache.content_std[ids])
                caff = sa._affine((cs, ch) if adain else None, b, h, N_REFS, D, "cuda")
                yield (f"row 1 identity cache {tag}",
                       lambda q=q, v_in=v_in, cache=cache, ids=ids, adain=adain:
                       sa.shared_attention_identity(q, None, v_in, cache, ids, scale=scale,
                                                    use_adain=adain),
                       lambda q=q, crk=crk, crv=crv, caff=caff, cache=cache, ids=ids:
                       sa.shared_identity_plain(q, crk, crv, caff, cache.kmax, ids, scale=scale))
                kmax = sa.key_norm_max(rk, (1, 3))
                rows = torch.arange(b, device="cuda")
                yield (f"row 1b paired route {tag}", per_call("kv_outer_bound_paired", False),
                       lambda q=q, rk=rk, rv=rv, aff=aff, kmax=kmax, rows=rows:
                       sa.shared_identity_plain(q, rk, rv, aff, kmax, rows, scale=scale))
            elif source == "shared_flash_bound":
                for inc in (False, True):
                    kmax = sa.key_norm_max(rk, (1, 3))
                    if inc:
                        kmax = torch.maximum(kmax, sa.key_norm_max(k_in, 2))
                    yield (f"row 3 input={inc} {tag}", per_call("kv_outer_bound", inc),
                           lambda q=q, k_in=k_in, v_in=v_in, rk=rk, rv=rv, aff=aff, kmax=kmax,
                           inc=inc: sa.shared_flash_bound_plain(q, k_in, v_in, rk, rv, aff, kmax,
                                                                scale=scale, include_input=inc))
                # odd N from the identity cache, by id
                n_odd = N_REFS - 1
                n_ident = max(IDS[:b]) + 1
                crk, crv = rnd(n_ident, n_odd, h, s, D), rnd(n_ident, n_odd, h, s, D)
                (cache,) = sa.build_identity_kv_cache([(crk, crv)])
                ids = torch.tensor(IDS[:b], device="cuda")
                cs, ch = sa.adain_affine_from_stats(v_in, cache.content_mean[ids],
                                                    cache.content_std[ids])
                caff = sa._affine((cs, ch) if adain else None, b, h, n_odd, D, "cuda")
                yield (f"row 3 odd N={n_odd} by id {tag}",
                       lambda q=q, v_in=v_in, cache=cache, ids=ids, adain=adain:
                       sa.shared_attention_identity(q, None, v_in, cache, ids, scale=scale,
                                                    use_adain=adain),
                       lambda q=q, crk=crk, crv=crv, caff=caff, cache=cache, ids=ids:
                       sa.shared_flash_bound_plain(q, None, None, crk, crv, caff, cache.kmax[ids],
                                                   ids, scale=scale, include_input=False))
            else:
                if source == "shared_online_pair" and h % 2:
                    continue
                algo = "kv_outer" if source == "shared_online" else "kv_outer_packed"
                plain = sa.shared_online_plain if algo == "kv_outer" else sa.shared_online_pair_plain
                for inc in (False, True):
                    yield (f"{source} input={inc} {tag}", per_call(algo, inc),
                           lambda q=q, k_in=k_in, v_in=v_in, rk=rk, rv=rv, aff=aff, inc=inc,
                           plain=plain: plain(q, k_in, v_in, rk, rv, aff, scale=scale,
                                              include_input=inc))
    elif source in ("flash_bound", "flash_online"):
        algo = source.split("_")[1]
        plain = sa.flash_attention_plain if algo == "bound" else sa.flash_online_plain
        shapes = FLASH_SMALL_SHAPES + FLASH_SMALL_D512 + FLASH_RAGGED_SHAPES if small else [
            (4 if d == 512 else BATCH, h, s, s, d) for h, s, d in FLASH_SHAPES]
        if not small:
            b, h, s, d = FLASH_CAPTURE_D512
            shapes = shapes + [(b, h, s, s, d)]
        for b, h, sq, skv, d in shapes:
            q, k, v = rnd(b, h, sq, d), rnd(b, h, skv, d), rnd(b, h, skv, d)
            tag = f"S={sq}" if sq == skv else f"Sq={sq} Skv={skv}"
            yield (f"{source} B={b} H={h} {tag} d={d}",
                   lambda q=q, k=k, v=v, d=d: sa.flash_attention(q, k, v, scale=d ** -0.5,
                                                                 algo=algo),
                   lambda q=q, k=k, v=v, d=d: plain(q, k, v, scale=d ** -0.5))
    else:  # the flash-VJP kernels, batch 2
        shapes = (FLASH_SMALL_SHAPES + FLASH_SMALL_D512 + FLASH_RAGGED_SHAPES if small
                  else [(2, *shape) for shape in VJP_SHAPES])
        for b, h, sq, skv, d in shapes:
            q, k, v, do = (rnd(b, h, n, d) for n in (sq, skv, skv, sq))
            sc = d ** -0.5
            tag = f"B={b} H={h} Sq={sq} Skv={skv} d={d}"
            if source == "flash_fwd_lse":  # out and LSE
                yield (f"{source} {tag}",
                       lambda q=q, k=k, v=v, sc=sc: fv.flash_fwd_lse(q, k, v, scale=sc),
                       lambda q=q, k=k, v=v, sc=sc: fv.flash_fwd_lse_plain(q, k, v, scale=sc))
                continue
            # the backward kernels' residuals from the plain forward on a fixed
            # chunk: the same in every tree, whatever its forward kernel does
            out, lse = fv.flash_fwd_lse_plain(q, k, v, scale=sc, block_k=64)
            delta = (do.float() * out.float()).sum(dim=-1)
            args = (q, k, v, do, lse, delta)
            if source == "flash_bwd_dq":
                yield (f"{source} {tag}", lambda args=args, sc=sc: fv.flash_bwd_dq(*args, scale=sc),
                       lambda args=args, sc=sc: fv.flash_bwd_dq_plain(*args, scale=sc))
            else:
                yield (f"{source} dK,dV {tag}",
                       lambda args=args, sc=sc: torch.cat(fv.flash_bwd_dkv(*args, scale=sc), -1),
                       lambda args=args, sc=sc: torch.cat(fv.flash_bwd_dkv_plain(*args, scale=sc),
                                                          -1))


def ptxas_lines(reports, names):
    """The ptxas lines that matter for the named sources: each entry
    function, its registers and spills, and every C75xx note (wgmma batches
    serialised). Returns the number of C75xx notes."""
    notes = 0
    for name in names:
        for line in reports.get(name, "").splitlines():
            line = line.strip()
            if "Compiling entry" in line:
                m = re.search(r"'(\S+)'", line)
                print(f"  ptxas {name}: entry {m.group(1) if m else line}")
            elif "C75" in line:
                notes += 1
                print(f"  ptxas {name}: {line}")
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name}:   {line}")
    return notes


def special_checks(card: str) -> int:
    """The bound shared kernels on what they must refuse to make finite: an
    id outside the identity cache poisons exactly its sample, and bound
    slack beyond 190 log2 units leaves no finite row. Returns the number of
    failed checks."""
    import torch

    from instantrestore_tpu_torch.ops import shared_attention as sa

    g = torch.Generator(device="cuda").manual_seed(7)
    bad = 0
    b, h, s, scale = 4, 10, 1024, D ** -0.5

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    # the wrappers straight: the engine's own gathers (AdaIN statistics,
    # kmax[ids]) would index outside the cache first
    q = rnd(b, h, s, D)
    for n, wrapper in ((N_REFS, "shared_identity"), (N_REFS - 1, "shared_flash_bound")):
        (cache,) = sa.build_identity_kv_cache([(rnd(3, n, h, s, D), rnd(3, n, h, s, D))])
        aff = torch.stack([1 + 0.1 * torch.randn((b, h, n, D), generator=g, device="cuda"),
                           0.1 * torch.randn((b, h, n, D), generator=g, device="cuda")],
                          dim=3).contiguous()

        def launch(ids):
            ids = torch.tensor(ids, device="cuda")
            if wrapper == "shared_identity":
                return sa.shared_identity(q, cache.rk, cache.rv, aff, cache.kmax, ids, scale=scale)
            kmax = cache.kmax[ids.clamp(max=2)]
            return sa.shared_flash_bound(q, None, None, cache.rk, cache.rv, aff, kmax, ids,
                                         scale=scale, include_input=False)

        good, out = launch([2, 2, 1, 0]), launch([2, 3, 1, 0])
        poisoned = bool(torch.isnan(out[1]).all())
        others = bool(torch.equal(out[[0, 2, 3]], good[[0, 2, 3]]))
        ok = poisoned and others and bool(torch.isfinite(good).all())
        bad += not ok
        rec = dict(check="out-of-cache id", kernel=wrapper, N=n, poisoned=poisoned,
                   others_equal=others, ok=ok)
        print(f"special {json.dumps(rec)} [{card}]")
    # one large-norm key orthogonal to every query lifts every row's bound
    q = torch.randn((2, h, s, D), generator=g, device="cuda")
    q[..., D // 2:] = 0
    q = q.to(torch.bfloat16)
    rk, rv = rnd(2, N_REFS, h, s, D), rnd(2, N_REFS, h, s, D)
    rk[:, 1, :, 5, :] = 0
    rk[:, 1, :, 5, D - 1] = 4096.0
    for algo in ("kv_outer_bound", "kv_outer_bound_paired"):
        out = sa.shared_flash_attention(q, None, None, rk, rv, scale=scale, include_input=False,
                                        algo=algo)
        lost = int((~torch.isfinite(out).all(dim=-1)).sum())
        ok = lost == out.shape[0] * h * s
        bad += not ok
        rec = dict(check="escape hatch", algo=algo, rows_lost=lost, rows=out.shape[0] * h * s,
                   ok=ok)
        print(f"special {json.dumps(rec)} [{card}]")
    return bad


def check(names) -> int:
    import torch

    from instantrestore_tpu_torch.ops import _build
    from instantrestore_tpu_torch.ops import shared_attention as sa

    card = card_line()
    print(card)
    t0 = time.perf_counter()
    reports = _build.build(names)
    print(f"build: {time.perf_counter() - t0:.1f} s")
    notes = ptxas_lines(reports, names)
    print(f"ptxas C75xx notes (wgmma serialised) over {list(names)}: {notes}")
    g = torch.Generator(device="cuda").manual_seed(1234)
    bad = 0
    for name in names:
        for small in (True, False):  # the small shapes first
            for label, run, plain in cases(name, g, small):
                one = outputs(run())
                torch.cuda.synchronize()
                ref = outputs(plain())
                err, tol, rel = errors(one[0], ref[0])
                again = all(torch.equal(a, b) for a, b in zip(one, outputs(run())))
                rec = dict(kernel=name, case=label, max_abs=err, tol=tol, rel_rms=rel,
                           finite=all(bool(torch.isfinite(t).all()) for t in one),
                           repeatable=again, ms=cuda_ms(run))
                rec["ok"] = rec["finite"] and err <= tol and rel <= 1e-2 and again
                if len(one) == 2:  # flash_fwd_lse: the LSE too
                    rec["lse_max_abs"] = float((one[1] - ref[1]).abs().max())
                    rec["ok"] = rec["ok"] and rec["lse_max_abs"] <= LSE_TOL
                bad += not rec["ok"]
                print(f"check {json.dumps(rec)} [{card}]")
                del one, ref
            torch.cuda.empty_cache()
    if {"shared_identity", "shared_flash_bound"} & set(names):
        bad += special_checks(card)
    print("launches: " + ", ".join(f"{fn.__name__} {fn.launches}" for fn in sa.KERNEL_WRAPPERS))
    print("check passed" if not bad and not notes else
          f"check FAILED: {bad} rows, {notes} ptxas serialisation notes")
    return 1 if bad or notes else 0


def run_tree(out_dir: str, names) -> int:
    import torch

    from instantrestore_tpu_torch.ops import _build
    from instantrestore_tpu_torch.ops import shared_attention as sa

    os.makedirs(out_dir, exist_ok=True)
    card = card_line()
    t0 = time.perf_counter()
    _build.build()
    print(f"tree {os.path.dirname(os.path.dirname(_build.__file__))}: built in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    g = torch.Generator(device="cuda").manual_seed(1234)
    times, digest, hashed = {}, hashlib.sha256(), []
    for name in SOURCES:
        for label, run, _ in cases(name, g):
            outs = outputs(run())
            if name in names:
                key = re.sub(r"[^A-Za-z0-9=_.]+", "_", label)
                for suffix, out in zip(("", "_lse"), outs):
                    torch.save(out.cpu(), os.path.join(out_dir, f"{key}{suffix}.pt"))
                times[label] = cuda_ms(run)
                times[f"device {label}"] = device_ms(run)
            else:
                for out in outs:
                    digest.update(out.contiguous().view(torch.uint8).cpu().numpy().tobytes())
                hashed.append(label)
            del outs
        torch.cuda.empty_cache()
    # what a launch costs the host, on a call too small to keep the device busy
    for name in names:
        label, run, _ = next(iter(cases(name, g, small=True)))
        times[f"host us per call, {label}"] = host_us(run)
    torch.cuda.synchronize()
    result = dict(times_ms=times, hash=digest.hexdigest(), hashed_outputs=hashed, card=card)
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(result, f)
    print(f"run {json.dumps(result)}")
    return 0


def bf16_ulps(a, b) -> float:
    """Largest |b - a| in units of the bf16 spacing at max |a| (the output's
    scale: an element near 0 that cancels carries an absolute error of the
    output's scale, not of its own)."""
    import math

    ulp = 2.0 ** (math.floor(math.log2(float(a.abs().max()))) - 7)
    return float((b - a).abs().max()) / ulp


def compare(dir_a: str, dir_b: str) -> int:
    import torch

    res = [json.load(open(os.path.join(d, "result.json"))) for d in (dir_a, dir_b)]
    same = res[0]["hash"] == res[1]["hash"] and res[0]["hashed_outputs"] == res[1]["hashed_outputs"]
    print(f"other kernels, {len(res[0]['hashed_outputs'])} outputs: hash "
          f"{'identical' if same else 'DIFFERS'} ({res[0]['hash'][:16]} / {res[1]['hash'][:16]})")
    for name in sorted(f for f in os.listdir(dir_a) if f.endswith(".pt")):
        a = torch.load(os.path.join(dir_a, name)).float()
        b = torch.load(os.path.join(dir_b, name)).float()
        same_bits = " (bit-identical)" if torch.equal(a, b) else ""
        print(f"{name[:-3]}: B against A max-abs {float((b - a).abs().max()):.5f}, relative RMS "
              f"{float((b - a).norm() / a.norm()):.3e}, {bf16_ulps(a, b):.2f} bf16 ulps at max|A| "
              f"{float(a.abs().max()):.3f}{same_bits}")
    for key, ms_a in res[0]["times_ms"].items():
        ms_b = res[1]["times_ms"].get(key)
        if ms_b is not None:
            unit = "us" if key.startswith("host us") else "ms"
            print(f"{key}: A {ms_a:.3f} {unit}, B {ms_b:.3f} {unit}, A / B {ms_a / ms_b:.2f}x "
                  f"[{res[0]['card']}]")
    return 0 if same else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--check", action="store_true")
    mode.add_argument("--run", metavar="DIR")
    mode.add_argument("--compare", nargs=2, metavar=("DIR_A", "DIR_B"))
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="root of the tree whose instantrestore_tpu_torch is imported")
    ap.add_argument("--kernels", default=",".join(DEFAULT_KERNELS),
                    help=f"comma-separated sources, of {', '.join(SOURCES)}")
    args = ap.parse_args()
    names = tuple(filter(None, args.kernels.split(",")))
    unknown = set(names) - set(SOURCES)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}")
    if args.compare:
        return compare(*args.compare)
    import torch

    if not torch.cuda.is_available():
        print("torch_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    return check(names) if args.check else run_tree(args.run, names)


if __name__ == "__main__":
    sys.exit(main())
