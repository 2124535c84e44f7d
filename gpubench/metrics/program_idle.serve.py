"""Share of the profiled span in which the card ran nothing while a restore
call of the program (an ``ir/restore`` or ``ir/restore_cold`` range) was
open on the host, in %. ``device_idle.serve`` less this is the idle between
calls: the caller's loop."""


def read(run):
    trace = run.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    spans = [(s, e) for s, e, n in trace.host_ops if n.startswith("ir/restore")]
    if not spans:
        return None
    busy = trace.busy_intervals()
    idle_us = sum((e - s) - sum(max(0.0, min(e, be) - max(s, bs)) for bs, be in busy)
                  for s, e in spans)
    return 100.0 * idle_us * 1e-6 / trace.window_s
