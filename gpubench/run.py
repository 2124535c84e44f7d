"""Run one cell of the benchmark once.

    python3 -m gpubench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration (``gpubench/configs/<config>.json``) and traffic mix
(``gpubench/traffic/<mix>.json``); the mix names the driver
(``gpubench/drivers/<driver>.py``) that builds the program, runs the window
and checks the outputs against the plain reference with the cell's limits
(``gpubench/limits/<workload>.json``). With ``--trace 0`` the last line of
standard output holds the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics, each read by ``gpubench/metrics/<metric>.py``, and a
``breakdown`` of the trace. Each number compared is printed beside its limit
as the last lines of standard error and under ``checks``, the line's last
key.

It exits non-zero with no result where no CUDA card is visible, where fewer
cards are visible than the cell asks for, and where the process has loaded
JAX or the JAX package.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# fixed build and kernel caches inside the checkout: only a checkout's first
# run builds (the program's nvcc cache is its own _build/ beside its sources)
CACHES = {"TRITON_CACHE_DIR": HERE / ".cache" / "triton",
          "TORCH_EXTENSIONS_DIR": HERE / ".cache" / "torch_extensions"}
FORBIDDEN = ("jax", "jaxlib", "flax", "instantrestore_tpu")


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, or "not read"."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return "; ".join(out.splitlines())


def kernel_families() -> dict:
    return {p.stem: json.loads(p.read_text()) for p in sorted((HERE / "kernels").glob("*.json"))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, path in CACHES.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((REPO / conf["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits_file = HERE / "limits" / f"{args.workload}.json"
    limits = json.loads(limits_file.read_text())["limits"] if limits_file.exists() else {}

    import torch

    # one host thread: the harness's own host work (staging the next batch)
    # then takes no core from the thread that launches the program's kernels
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this machine shows "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    driver = importlib.import_module(f"gpubench.drivers.{mix['driver']}")
    ctx = driver.RunContext(config=config, mix=mix, seed=args.seed, seconds=args.seconds,
                            trace=bool(args.trace), device=torch.device("cuda:0"),
                            chips=cell["chips"], t_start=T_START, limits=limits)
    result = driver.run(ctx)

    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: no result", file=sys.stderr)
        return 3

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": result["memory_peak_bytes"], "power": power_limit()}
    metrics, breakdown = {}, None
    if args.trace:
        layer = dict(result["layer"], kernel_families=kernel_families())
        for m in spec["per_layer"]:
            if _applies(m, args.workload):
                value = _metric_reader(m["name"])(layer)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        summary = layer["trace"]
        device["busy_s"], device["window_s"] = summary.busy_s(), summary.window_s
        ops = sorted(summary.device_seconds_by_name().items(), key=lambda kv: -kv[1])[:10]
        breakdown = {"device_ops": [list(kv) for kv in ops],
                     "idle_gaps": [list(g) for g in summary.idle_gaps(10)]}
    else:
        for m in spec["end_to_end"]:
            if _applies(m, args.workload) and m["name"] in result["end_to_end"]:
                metrics[m["name"]] = {"value": result["end_to_end"][m["name"]], "unit": m["unit"]}

    line = {"correct": bool(result["correct"]), "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = result["checks"]
    print(f"{args.workload} seed {args.seed}: {result['batches']} batches in the window, "
          f"reference {result['reference_s']:.1f} s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
