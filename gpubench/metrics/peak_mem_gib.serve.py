"""``torch.cuda.max_memory_allocated()`` over set-up and window, in GiB."""


def read(run):
    peak = run.get("memory_peak_bytes")
    return peak / 2**30 if peak else None
