"""On the card, at each serving cell's own size and load, every number
that decides ``correct``: the program's readings on a dozen seeds (each
number's lower reading), the control's on three and each fault's on three
(the upper readings). The control is the program's own next precision
down, its int8 engine (``int8_decoder`` and ``int8_unet``, per-sample
dynamic activation scales). The fault serves each face with the previous
face's references (warm: the identity ids rolled by one; cold: the
reference photos rolled by one). Each reading is printed as a JSON line;
each limit lies above the program's readings, and the control and the fault
each fail at least one number on every seed.

    python3 -m pytest gpubench/tests -m card -s
"""

import gc
import json
import time
from pathlib import Path

import pytest
import torch

from gpubench.drivers import serve
from gpubench.traffic import load_mix
from instantrestore_tpu_torch.inference.serving import ServingEngine

HERE = Path(__file__).resolve().parent.parent
WORKLOADS = ["serve-warm-b16-online", "serve-cold-b8-online"]
PROGRAM_SEEDS = [2**31 + 101 + 7 * i for i in range(12)]
CONTROL_SEEDS = [2**31 + 901 + 7 * i for i in range(3)]
FAULT_SEEDS = [2**31 + 1901 + 7 * i for i in range(3)]
WINDOW_S = 3.0  # long enough for the sampled batches; the check compares as many faces as a run
INT8 = {"int8_decoder": True, "int8_unet": True}


def _cell(workload: str):
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"] if w["name"] == workload)
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())["limits"]
    return (json.loads((HERE.parent / conf["file"]).read_text()), load_mix(cell["traffic"]),
            limits)


def readings(workload: str, seed: int, engine: dict, device) -> dict:
    """Every compared number of one short run at the cell's size."""
    cfg, mix, limits = _cell(workload)
    ctx = serve.RunContext(config=cfg, mix=dict(mix, engine=engine), seed=seed,
                           seconds=WINDOW_S, trace=False, device=device, chips=1,
                           t_start=time.perf_counter(), limits=limits)
    values = {k: c["value"] for k, c in serve.run(ctx)["checks"].items()}
    gc.collect()
    torch.cuda.empty_cache()
    return values


def _other_references(fn):
    def broken(self, images, other, *, noise):
        return fn(self, images, other.roll(1, 0), noise=noise)
    return broken


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_limits_separate_program_from_control_and_fault(workload, card, monkeypatch):
    limits = _cell(workload)[2]
    runs = {}
    for kind, seeds, engine in (("program", PROGRAM_SEEDS, {}), ("control", CONTROL_SEEDS, INT8)):
        runs[kind] = []
        for s in seeds:
            runs[kind].append(readings(workload, s, engine, card))
            print(json.dumps({"workload": workload, kind: runs[kind][-1], "seed": s}), flush=True)
    name = "restore" if workload.startswith("serve-warm") else "restore_cold"
    monkeypatch.setattr(ServingEngine, name, _other_references(getattr(ServingEngine, name)))
    runs["fault"] = []
    for s in FAULT_SEEDS:
        runs["fault"].append(readings(workload, s, {}, card))
        print(json.dumps({"workload": workload, "fault": runs["fault"][-1], "seed": s}), flush=True)
    print(json.dumps({"workload": workload, "card": torch.cuda.get_device_name(card),
                      "limits": limits, **runs}))
    for number, limit in limits.items():
        assert max(r[number] for r in runs["program"]) <= limit, number
    for kind in ("control", "fault"):
        for r in runs[kind]:
            assert any(r[number] > limit for number, limit in limits.items()), (kind, r)
