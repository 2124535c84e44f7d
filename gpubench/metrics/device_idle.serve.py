"""Share of the profiled span in which no kernel, copy or memset ran on the
card, in %."""


def read(run):
    trace = run.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
