"""Device ms a face of the program's ``decode`` stage (the VAE decode) over the
profiled batches: the program's records (``utils/profiling.py::records``) of
its last k restore calls, k the ``ir/restore*`` ranges in the trace, each
stage event to event on the card's stream, its idle included. Nothing where
the program keeps no such records."""

STAGE = "decode"


def read(run):
    trace = run.get("trace")
    try:
        from instantrestore_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    k = 0 if trace is None else sum(1 for _, _, n in trace.host_ops if n.startswith("ir/restore"))
    calls = records()[-k:] if k else []
    if not calls or len(calls) < k or any(STAGE not in c["stages"] for c in calls):
        return None
    faces = sum(c["faces"] for c in calls)
    return sum(c["stages"][STAGE] for c in calls) / faces if faces else None
