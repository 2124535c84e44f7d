"""Device ms a face inside the program's ``transformer`` spans (each
Transformer2DModel of the capture's and the restore's UNets: its norm,
``proj_in``, blocks and ``proj_out``) over the profiled batches: the
program's records (``utils/profiling.py::records``, their ``nested`` spans)
of its last k restore calls, k the ``ir/restore*`` ranges in the trace,
each span event to event on the card's stream, its idle included. Nothing
where the program keeps no such records or opens no such span."""

SPAN = "transformer"


def read(run):
    trace = run.get("trace")
    try:
        from instantrestore_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    k = 0 if trace is None else sum(1 for _, _, n in trace.host_ops if n.startswith("ir/restore"))
    calls = records()[-k:] if k else []
    if not calls or len(calls) < k or any(SPAN not in c.get("nested", {}) for c in calls):
        return None
    faces = sum(c["faces"] for c in calls)
    return sum(c["nested"][SPAN] for c in calls) / faces if faces else None
