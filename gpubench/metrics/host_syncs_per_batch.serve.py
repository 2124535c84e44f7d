"""The host's stream, device and event synchronisations that start inside
a restore call of the program (an ``ir/restore`` or ``ir/restore_cold``
range), per such call."""

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def read(run):
    trace = run.get("trace")
    if trace is None:
        return None
    spans = [(s, e) for s, e, n in trace.host_ops if n.startswith("ir/restore")]
    if not spans:
        return None
    syncs = sum(1 for t, _, n in trace.host_ops
                if n in SYNCS and any(s <= t <= e for s, e in spans))
    return syncs / len(spans)
