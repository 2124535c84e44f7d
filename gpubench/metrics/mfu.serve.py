"""Model FLOPs of the faces restored in the window (counted on the plain
reference's shapes, ``gpubench/flops.py``) over the window's wall seconds
times the cards' published bf16 peak, in %."""


def read(run):
    peaks, flops = run.get("peaks"), run.get("flops_per_face")
    if not peaks or not flops or not run.get("window_s"):
        return None
    done = flops * run["window_faces"]
    return 100.0 * done / (run["window_s"] * peaks["bf16_flops"] * run["chips"])
