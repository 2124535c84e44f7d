"""The attention calls' least time (each call's FLOPs at the bf16 peak or
its bytes at the HBM peak, whichever is longer; ``gpubench/flops.py``) over
the device time of the kernels of every ``attention`` family
(``gpubench/kernels/*.json``), over the profiled batches, in %."""

import re


def read(run):
    trace, least = run.get("trace"), run.get("attention_least_s")
    if trace is None or not least:
        return None
    patterns = [re.compile(p) for fam in run["kernel_families"].values()
                if fam["role"] == "attention" for p in fam["patterns"]]
    spent = sum(sec for name, sec in trace.device_seconds_by_name().items()
                if any(p.search(name) for p in patterns))
    if spent <= 0:
        return None
    return 100.0 * least / spent
