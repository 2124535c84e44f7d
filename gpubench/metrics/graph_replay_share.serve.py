"""Share of the profiled restore calls that replayed a captured CUDA graph,
in %: the program's records (``utils/profiling.py::records``) of its last k
restore calls, k the ``ir/restore*`` ranges in the trace, each with its
``graph`` field ("eager", "capture" or "replay"). Nothing where the program
keeps no such records or notes no such field."""


def read(run):
    trace = run.get("trace")
    try:
        from instantrestore_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    k = 0 if trace is None else sum(1 for _, _, n in trace.host_ops if n.startswith("ir/restore"))
    calls = records()[-k:] if k else []
    if not calls or len(calls) < k or any("graph" not in c for c in calls):
        return None
    return 100.0 * sum(c["graph"] == "replay" for c in calls) / len(calls)
