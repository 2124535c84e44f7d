"""CUDA runtime and driver calls that put work on the card (kernel and graph
launches, copies, memsets), per face of the profiled batches."""


def read(run):
    trace, faces = run.get("trace"), run.get("profiled_faces")
    if trace is None or not faces:
        return None
    return sum(trace.launches.values()) / faces
