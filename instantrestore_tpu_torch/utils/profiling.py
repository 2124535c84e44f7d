"""Tracing and profiling hooks (counterpart of
``instantrestore_tpu/utils/profiling.py``, whose observability is wall-clock
prints, a timing decorator and ``jax.named_scope`` on the stages).

- ``span(name, faces=None, device=None)``: a named stage of the program.
  Off, it costs one check and records nothing. It is on while a
  ``torch.profiler`` records, or inside ``with tracing():``; then it opens a
  ``record_function`` range ``ir/<name>`` (a ``user_annotation`` in the
  Kineto trace, on the clock of the card's kernels) and, inside a call,
  marks its start and end: timing events on ``device``'s current stream on
  a CUDA device (none while the stream is captured into a graph), else the
  host clock. A span given ``faces`` while no call is open on the thread
  opens a call (the serving engine's restores, on ``device``); the spans
  inside it are its stages. A span with no call open (a training forward
  under the profiler) is a range only.
- ``records()``: the newest calls, oldest first, at most ``RING`` of them:
  ``{"name", "faces", "device_ms", "stages": {stage: device_ms}}``. A
  ``device_ms`` is event to event, so it includes the card's idle time in
  the stage. The events are read here, outside the calls: a span never
  synchronises. ``reset()`` empties the ring.
- ``trace``: a ``torch.profiler`` capture of a block exported as a Chrome
  trace (viewable in Perfetto or chrome://tracing), the spans included.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

RING = 64  # calls kept by ``records()``

_lock = threading.Lock()
_calls: collections.deque = collections.deque(maxlen=RING)
_open = threading.local()  # ``.call``: the call open on this thread
_tracing = 0  # depth of ``tracing()`` blocks


def _mark(device: Optional[torch.device]):
    """A timing event recorded on ``device``'s current stream (None while
    that stream is captured), or the host clock off CUDA."""
    if device is not None and device.type == "cuda":
        if torch.cuda.is_current_stream_capturing():
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev
    return time.perf_counter()


def _ms(start, end) -> Optional[float]:
    if start is None or end is None:
        return None
    if isinstance(start, float):
        return 1e3 * (end - start)
    end.synchronize()
    return start.elapsed_time(end)


class _Call:
    """One outermost span with ``faces``: its marks and its stages' marks."""

    def __init__(self, name: str, faces: int, device: Optional[torch.device]):
        self.name, self.faces, self.device = name, faces, device
        self.start = self.end = None
        self.stages: List[tuple] = []  # (name, start mark, end mark)

    def resolve(self) -> Dict[str, Any]:
        stages: Dict[str, float] = {}
        for name, start, end in self.stages:
            ms = _ms(start, end)
            if ms is not None:
                stages[name] = stages.get(name, 0.0) + ms
        return {"name": self.name, "faces": self.faces, "device_ms": _ms(self.start, self.end),
                "stages": stages}


@contextlib.contextmanager
def span(name: str, faces: Optional[int] = None, device=None):
    """The block as stage ``name`` (the module's docstring)."""
    if not (_tracing or torch.autograd._profiler_enabled()):
        yield
        return
    call = getattr(_open, "call", None)
    opened = call is None and faces is not None
    if opened:
        call = _open.call = _Call(name, int(faces),
                                  None if device is None else torch.device(device))
    try:
        with torch.profiler.record_function("ir/" + name):
            start = None if call is None else _mark(call.device)
            yield
            if call is not None:
                end = _mark(call.device)
                if not opened:
                    call.stages.append((name, start, end))
                elif start is not None:  # a call inside a graph capture is not recorded
                    call.start, call.end = start, end
                    with _lock:
                        _calls.append(call)
    finally:
        if opened:
            _open.call = None


@contextlib.contextmanager
def tracing():
    """Spans on (and calls recorded) for the block, without a profiler."""
    global _tracing
    with _lock:
        _tracing += 1
    try:
        yield
    finally:
        with _lock:
            _tracing -= 1


def records() -> List[Dict[str, Any]]:
    """The newest calls' records, oldest first (the module's docstring).
    Waits for the card to reach the events of calls not yet read."""
    with _lock:
        for i in range(len(_calls)):
            if isinstance(_calls[i], _Call):
                _calls[i] = _calls[i].resolve()
        return [dict(r, stages=dict(r["stages"])) for r in _calls]


def reset() -> None:
    """Forget every recorded call."""
    with _lock:
        _calls.clear()


@contextlib.contextmanager
def trace(log_dir: str = "traces"):
    """Capture a profiler trace of the block: ``with trace("logs/trace"):
    step(...)`` writes ``<log_dir>/trace.json``: the host's operators and
    spans, and the card's kernels when CUDA is available. Yields the
    profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
