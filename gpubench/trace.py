"""The device trace of a few steady batches, read from ``torch.profiler``.

``Profile`` wraps ``torch.profiler.profile`` (CPU and CUDA activities); on
``stop`` it exports the Kineto trace to a temporary file under ``TMPDIR``,
reads it and deletes it. ``Summary`` keeps what the per-layer readers need:

- ``device``: (start us, end us, name, category) of every kernel, memcpy and
  memset on the card;
- ``launches``: the host's CUDA runtime and driver calls that put work on
  the card (kernel and graph launches, copies, memsets), by name;
- ``host_ops``: (start us, end us, name) of the host's operator events, to
  name what the host did while the card idled;
- ``window_s``: the host-clock span of the profiled batches.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch",
                   "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")
HOST_CATS = ("cpu_op", "python_function", "user_annotation", "cuda_runtime", "cuda_driver")


class Summary:
    def __init__(self, events: List[dict], window_s: float):
        self.window_s = window_s
        self.device: List[Tuple[float, float, str, str]] = []
        self.launches: Counter = Counter()
        self.host_ops: List[Tuple[float, float, str]] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, name, cat))
            elif cat in HOST_CATS:
                if cat in ("cuda_runtime", "cuda_driver") and name.startswith(LAUNCH_PREFIXES):
                    self.launches[name] += 1
                self.host_ops.append((ts, ts + dur, name))
        self.device.sort()

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device intervals, in us."""
        out: List[List[float]] = []
        for s, e, _, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def device_seconds_by_name(self) -> Dict[str, float]:
        acc: Counter = Counter()
        for s, e, name, _ in self.device:
            acc[name] += (e - s) * 1e-6
        return dict(acc)

    def _host_op_at(self, t: float) -> str:
        """The innermost host event open at time ``t`` (us)."""
        best: Optional[Tuple[float, str]] = None
        for s, e, name in self.host_ops:
            if s <= t <= e and (best is None or e - s < best[0]):
                best = (e - s, name)
        return best[1] if best else "host idle"

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The ``top`` longest gaps between device work, each named by the
        host event running at its start."""
        busy = self.busy_intervals()
        gaps = [(busy[i + 1][0] - busy[i][1], busy[i][1]) for i in range(len(busy) - 1)]
        gaps.sort(reverse=True)
        return [(self._host_op_at(start + 0.5 * length), length * 1e-6)
                for length, start in gaps[:top] if length > 0]


class Profile:
    """Profile the batches run between ``start`` and ``stop``."""

    def __init__(self):
        self._prof: Optional[torch.profiler.profile] = None
        self._t0 = 0.0
        self.summary: Optional[Summary] = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        """Call after the profiled work has been synchronised."""
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._prof = None
        self.summary = Summary(events, window_s)
