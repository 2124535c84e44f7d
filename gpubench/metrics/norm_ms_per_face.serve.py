"""Device ms a face of the kernels of every ``norm`` family
(``gpubench/kernels/*.json``: the port's GroupNorm kernels) over the
profiled batches' faces. Nothing where no such kernel ran."""

import re


def read(run):
    trace, faces = run.get("trace"), run.get("profiled_faces")
    if trace is None or not faces:
        return None
    patterns = [re.compile(p) for fam in run.get("kernel_families", {}).values()
                if fam["role"] == "norm" for p in fam["patterns"]]
    spent = sum(sec for name, sec in trace.device_seconds_by_name().items()
                if any(p.search(name) for p in patterns))
    if spent <= 0:
        return None
    return 1e3 * spent / faces
