"""Tracing and profiling hooks (counterpart of
``instantrestore_tpu/utils/profiling.py``).

The reference's observability is wall-clock prints and a ``@nameit``
decorator. Here: ``nameit`` for host-side phases, ``stage`` for a named
range that shows in ``torch.profiler`` traces and is timed on the host
(``stage_report``), and ``trace``, a ``torch.profiler`` capture exported as
a Chrome trace (viewable in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch

_STAGE_TIMES: dict = {}


def nameit(fn):
    """Wall-clock decorator: prints ``[qualname] took N.NNNs`` after each call."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        print(f"[{fn.__qualname__}] took {time.perf_counter() - t0:.3f}s")
        return out

    return wrapper


@contextlib.contextmanager
def stage(name: str):
    """A named range in profiler traces (``torch.profiler.record_function``)
    whose host time is added to ``stage_report``. The host time of CUDA
    work is its launch unless the block synchronises."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    _STAGE_TIMES.setdefault(name, []).append(time.perf_counter() - t0)


def stage_report() -> dict:
    """{stage name: {"mean_s", "count"}} over every ``stage`` block so far."""
    return {k: {"mean_s": sum(v) / len(v), "count": len(v)} for k, v in _STAGE_TIMES.items()}


@contextlib.contextmanager
def trace(log_dir: str = "traces", host: bool = False):
    """Capture a profiler trace of the block: ``with trace("logs/trace"):
    step(...)`` writes ``<log_dir>/trace.json``. The card's kernels are
    recorded when CUDA is available, host (CPU) operators when ``host`` is
    set or there is no card. Yields the profiler."""
    activities = []
    if host or not torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CPU)
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
