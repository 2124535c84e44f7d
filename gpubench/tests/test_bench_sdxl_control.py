"""On the card, the numbers that decide ``correct`` in the SDXL cell,
``serve-sdxl-cold-b8-online``, read as ``test_bench_control.py`` reads the
SD-Turbo cells': the program on a dozen seeds (each number's lower reading),
its int8 engine (``int8_decoder`` and ``int8_unet``, the control) and the
fault (each face served with the previous face's reference photos) on three
each. Each reading is printed as a JSON line; each limit lies above the
program's readings, and the control and the fault each fail at least one
number on every seed.

    python3 -m pytest gpubench/tests/test_bench_sdxl_control.py -m card -s
"""

import gc
import json
import time

import pytest
import torch

from gpubench.drivers import serve_sdxl
from gpubench.tests.test_bench_control import (
    CONTROL_SEEDS,
    FAULT_SEEDS,
    INT8,
    PROGRAM_SEEDS,
    WINDOW_S,
    _cell,
    _other_references,
)
from instantrestore_tpu_torch.inference.serving import ServingEngine

WORKLOAD = "serve-sdxl-cold-b8-online"


def readings(seed: int, engine: dict, device) -> dict:
    """Every compared number of one short run at the cell's size."""
    cfg, mix, limits = _cell(WORKLOAD)
    ctx = serve_sdxl.RunContext(config=cfg, mix=dict(mix, engine={**mix["engine"], **engine}),
                                seed=seed, seconds=WINDOW_S, trace=False, device=device, chips=1,
                                t_start=time.perf_counter(), limits=limits)
    values = {k: c["value"] for k, c in serve_sdxl.run(ctx)["checks"].items()}
    gc.collect()
    torch.cuda.empty_cache()
    return values


@pytest.mark.card
def test_limits_separate_program_from_control_and_fault(card, monkeypatch):
    limits = _cell(WORKLOAD)[2]
    runs = {}
    for kind, seeds, engine in (("program", PROGRAM_SEEDS, {}), ("control", CONTROL_SEEDS, INT8)):
        runs[kind] = []
        for s in seeds:
            runs[kind].append(readings(s, engine, card))
            print(json.dumps({"workload": WORKLOAD, kind: runs[kind][-1], "seed": s}), flush=True)
    monkeypatch.setattr(ServingEngine, "restore_cold",
                        _other_references(ServingEngine.restore_cold))
    runs["fault"] = []
    for s in FAULT_SEEDS:
        runs["fault"].append(readings(s, {}, card))
        print(json.dumps({"workload": WORKLOAD, "fault": runs["fault"][-1], "seed": s}), flush=True)
    print(json.dumps({"workload": WORKLOAD, "card": torch.cuda.get_device_name(card),
                      "limits": limits, **runs}))
    for number, limit in limits.items():
        assert max(r[number] for r in runs["program"]) <= limit, number
    for kind in ("control", "fault"):
        for r in runs[kind]:
            assert any(r[number] > limit for number, limit in limits.items()), (kind, r)
