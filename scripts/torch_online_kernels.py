#!/usr/bin/env python3
"""The online shared attention kernels of the PyTorch port on one NVIDIA GPU:
a quick check against their plain versions, and a comparison of two trees.

    python3 scripts/torch_online_kernels.py --check
    python3 scripts/torch_online_kernels.py --run DIR [--tree PATH]
    python3 scripts/torch_online_kernels.py --compare DIR_A DIR_B

``--check`` builds csrc/shared_online.cu and csrc/shared_online_pair.cu of the
tree, launches them at the shapes of a batch-16 cold restore (with and
without the input segment), at a 64-row shape (Sq % 128 == 64) and a 64-key
segment, and prints for each the max-abs and relative RMS error against
``shared_online_plain``, whether two launches agree bit for bit, whether the
pair kernel equals the single-head kernel bit for bit, and the time per
launch. It exits 1 if a shape is outside max-abs 1e-3 + 1e-2 max|ref|,
relative RMS 1e-2, or a bit-for-bit check fails.

``--run DIR`` imports the port from ``--tree`` (default: the tree this script
lies in), runs rows 7 and 10 (shared_online, shared_online_pair) at the cold
restore's shapes, writes their outputs to DIR and prints their times, and
prints a SHA-256 over the outputs of the kernels on the mma.sync tile
(shared_identity, flash_bound, shared_flash_bound, flash_online,
flash_fwd_lse) on fixed seeded inputs. ``--compare`` reads two such
directories and prints, per output, max-abs and relative RMS of B against A
and whether the hashes agree. ``--run`` also times what one call costs the
host (microseconds to enqueue a tiny call: the new kernels encode four TMA
tensor maps per launch). Run the old tree and the new one in turns on
one card (old, new, new, old) to compare times.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

BATCH, N_REFS, D = 16, 4, 64
SHARED_SHAPES = [(20, 256), (10, 1024), (5, 4096)]  # (heads, tokens) of the 9 shared layers
# (batch, heads, Sq, S): one consumer warpgroup a block; a 64-key chunk; both
VARIANT_SHAPES = [(2, 4, 192, 256), (2, 4, 256, 64), (2, 2, 64, 192)]


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


def shared_inputs(g, b, h, sq, s, n=N_REFS):
    """q, k_in, v_in, rk, rv (one reference zeroed) and the AdaIN affine."""
    import torch

    from instantrestore_tpu_torch.ops import shared_attention as sa

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    q, k_in, v_in = rnd(b, h, sq, D), rnd(b, h, s, D), rnd(b, h, s, D)
    rk, rv = rnd(b, n, h, s, D), rnd(b, n, h, s, D)
    rk[1, n - 1] = 0
    rv[1, n - 1] = 0
    return q, k_in, v_in, rk, rv, sa.adain_affine(v_in, rv)


def errors(out, ref):
    o, r = out.float(), ref.float()
    return float((o - r).abs().max()), 1e-3 + 1e-2 * float(r.abs().max()), float(
        (o - r).norm() / r.norm())


def check() -> int:
    import torch

    from instantrestore_tpu_torch.ops import _build
    from instantrestore_tpu_torch.ops import shared_attention as sa

    card = card_line()
    print(card)
    t0 = time.perf_counter()
    reports = _build.build(["shared_online", "shared_online_pair"])
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()[:160]}")
            elif "ptxas" in line or "spill" in line or "warning" in line.lower():
                print(f"  ptxas {name}: {line.strip()}")
    g = torch.Generator(device="cuda").manual_seed(1234)
    scale = D ** -0.5
    bad = 0
    shapes = [(BATCH, h, s, s) for h, s in SHARED_SHAPES] + VARIANT_SHAPES
    for b, h, sq, s in shapes[::-1]:  # the small ones first
        q, k_in, v_in, rk, rv, (vs, vh) = shared_inputs(g, b, h, sq, s)
        aff = torch.stack([vs, vh], dim=3).contiguous()
        for inc in (False, True):
            def run(algo):
                return sa.shared_flash_attention(q, k_in, v_in, rk, rv, scale=scale,
                                                 v_affine=(vs, vh), include_input=inc, algo=algo)

            one = run("kv_outer")
            torch.cuda.synchronize()
            ref = sa.shared_online_plain(q, k_in, v_in, rk, rv, aff, scale=scale,
                                         include_input=inc)
            err, tol, rel = errors(one, ref)
            again = bool(torch.equal(one, run("kv_outer")))
            rec = dict(B=b, H=h, Sq=sq, S=s, input=inc, tile=sa.shared_online_tile(sq, s, h),
                       max_abs=err, tol=tol, rel_rms=rel, finite=bool(torch.isfinite(one).all()),
                       repeatable=again, ms=cuda_ms(lambda: run("kv_outer")))
            ok = rec["finite"] and err <= tol and rel <= 1e-2 and again
            if h % 2 == 0:
                pair = run("kv_outer_packed")
                torch.cuda.synchronize()
                rec["pair_equal"] = bool(torch.equal(pair, one))
                rec["pair_max_abs"] = float((pair.float() - one.float()).abs().max())
                rec["pair_ms"] = cuda_ms(lambda: run("kv_outer_packed"))
                # the pair kernel always takes 64 rows a block: its bits equal the
                # single-head kernel's whatever tile that one took
                ok = ok and rec["pair_equal"]
            rec["ok"] = ok
            bad += not ok
            print(f"check {json.dumps(rec)} [{card}]")
        del q, k_in, v_in, rk, rv, aff
        torch.cuda.empty_cache()
    print(f"launches: shared_online {sa.shared_online.launches}, shared_online_pair "
          f"{sa.shared_online_pair.launches}")
    print("check passed" if not bad else f"check FAILED on {bad} rows")
    return 1 if bad else 0


def run_tree(out_dir: str) -> int:
    import torch

    from instantrestore_tpu_torch.ops import _build
    from instantrestore_tpu_torch.ops import flash_vjp as fv
    from instantrestore_tpu_torch.ops import shared_attention as sa

    os.makedirs(out_dir, exist_ok=True)
    card = card_line()
    t0 = time.perf_counter()
    _build.build()
    print(f"tree {os.path.dirname(os.path.dirname(_build.__file__))}: built in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    scale = D ** -0.5
    g = torch.Generator(device="cuda").manual_seed(1234)
    times, digest, n_hashed = {}, hashlib.sha256(), 0

    def add(t):
        nonlocal n_hashed
        digest.update(t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                                          else torch.int32).cpu().numpy().tobytes())
        n_hashed += 1

    for h, s in SHARED_SHAPES:
        q, k_in, v_in, rk, rv, aff = shared_inputs(g, BATCH, h, s, s)
        for inc in (False, True):
            def run(algo):
                return sa.shared_flash_attention(q, k_in, v_in, rk, rv, scale=scale, v_affine=aff,
                                                 include_input=inc, algo=algo)

            key = f"H{h}_S{s}_in{int(inc)}"
            torch.save(run("kv_outer").cpu(), os.path.join(out_dir, f"shared_online_{key}.pt"))
            times[f"shared_online {key}"] = cuda_ms(lambda: run("kv_outer"))
            times[f"q_outer {key}"] = cuda_ms(lambda: run("q_outer"))
            if h % 2 == 0:
                torch.save(run("kv_outer_packed").cpu(),
                           os.path.join(out_dir, f"shared_online_pair_{key}.pt"))
                times[f"shared_online_pair {key}"] = cuda_ms(lambda: run("kv_outer_packed"))
            # the kernels on the mma.sync tile, hashed
            add(run("kv_outer_bound"))
            if not inc:
                add(run("kv_outer_bound_paired"))
        add(sa.flash_attention(q, k_in, v_in, scale=scale, algo="bound"))
        add(sa.flash_attention(q, k_in, v_in, scale=scale, algo="online"))
        out, lse = fv.flash_fwd_lse(q[:2], k_in[:2], v_in[:2], scale=scale)
        add(out)
        add(lse)
        (cache,) = sa.build_identity_kv_cache([(rk, rv)])
        ids = torch.arange(BATCH, device="cuda").flip(0)
        add(sa.shared_attention_identity(q, None, v_in, cache, ids, scale=scale, use_adain=True))
        del q, k_in, v_in, rk, rv, aff, cache
        torch.cuda.empty_cache()
    # what a launch costs the host, on a call too small to keep the device busy
    q, k_in, v_in, rk, rv, aff = shared_inputs(g, 2, 2, 64, 64, n=2)
    for algo in ("kv_outer", "kv_outer_packed", "kv_outer_bound"):
        times[f"host us per call, {algo}, tiny"] = host_us(
            lambda: sa.shared_flash_attention(q, k_in, v_in, rk, rv, scale=scale, v_affine=aff,
                                              include_input=False, algo=algo))
    x = torch.randn((4, 1, 4096, 512), generator=g, device="cuda").to(torch.bfloat16)
    add(sa.flash_attention(x, x, x, scale=512 ** -0.5, algo="bound"))
    add(sa.flash_attention(x, x, x, scale=512 ** -0.5, algo="online"))
    torch.cuda.synchronize()
    result = dict(times_ms=times, hash=digest.hexdigest(), hashed_outputs=n_hashed, card=card)
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(result, f)
    print(f"run {json.dumps(result)}")
    return 0


def compare(dir_a: str, dir_b: str) -> int:
    import torch

    res = [json.load(open(os.path.join(d, "result.json"))) for d in (dir_a, dir_b)]
    same = res[0]["hash"] == res[1]["hash"]
    print(f"mma.sync-tile kernels, {res[0]['hashed_outputs']} outputs: hash "
          f"{'identical' if same else 'DIFFERS'} ({res[0]['hash'][:16]} / {res[1]['hash'][:16]})")
    for name in sorted(f for f in os.listdir(dir_a) if f.endswith(".pt")):
        a = torch.load(os.path.join(dir_a, name)).float()
        b = torch.load(os.path.join(dir_b, name)).float()
        print(f"{name[:-3]}: B against A max-abs {float((b - a).abs().max()):.5f}, relative RMS "
              f"{float((b - a).norm() / a.norm()):.3e}, max|A| {float(a.abs().max()):.3f}")
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
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    import torch

    if not torch.cuda.is_available():
        print("torch_online_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    return check() if args.check else run_tree(args.run)


if __name__ == "__main__":
    sys.exit(main())
