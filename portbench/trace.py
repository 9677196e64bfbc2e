"""
The traced window: a `torch.profiler` trace of a short stretch of the
cell's own work, reduced to kernel intervals on one timeline.

Busy time is the union of the kernels' intervals inside the window, so
kernels that overlap on two streams count once. Idle gaps are the parts
of the window no kernel covers, each named by the benchmark span the host
was in when the gap opened. The trace opens with a few hundred empty
kernels and a quarter second's wait (a trace on the card loses the first
kernels it should hold, the more the older the process), which fall
before the window.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import torch

WARM_LAUNCHES = 512
WARM_WAIT_S = 0.25
WINDOW = "portbench.window"
SPAN_PREFIX = "portbench."
PORT_KERNEL = "coot::"  # the namespace of the program's own kernels


class Trace:
    """Kernels (name, start s, end s) and host spans (name, start s, end
    s) inside the window [t0, t1], on the profiler's clock."""

    def __init__(self, kernels, spans, t0: float, t1: float) -> None:
        self.kernels = kernels
        self.spans = spans
        self.t0, self.t1 = t0, t1

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_s(self, port: bool) -> float:
        """Summed device seconds of the program's own kernels (port) or of
        all others (library kernels)."""
        return sum(e - s for name, s, e in self.kernels
                   if (PORT_KERNEL in name) == port)

    def gaps(self) -> List[Tuple[str, float]]:
        """(host span at the gap's opening, seconds) of every idle gap."""
        out, cursor = [], self.t0
        for s, e in self.busy_intervals() + [(self.t1, self.t1)]:
            if s > cursor:
                out.append((self._host_at(cursor), s - cursor))
            cursor = max(cursor, e)
        return out

    def _host_at(self, t: float) -> str:
        inner = [(e - s, name) for name, s, e in self.spans
                 if s <= t < e and name != WINDOW]
        return min(inner)[1] if inner else "outside the benchmark's spans"

    def breakdown(self) -> Dict[str, list]:
        by_name: Dict[str, float] = {}
        for name, s, e in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]
        gaps = sorted(self.gaps(), key=lambda x: -x[1])[:10]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


@contextlib.contextmanager
def span(name: str):
    """A benchmark span: a host range in a trace (free when untraced)."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


def traced(run) -> Trace:
    """Runs `run()` inside a profiler trace and returns its window (on a
    machine without a card the trace holds host spans only)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    sync()
    with profile(activities=activities) as prof:
        if cuda:
            for _ in range(WARM_LAUNCHES):
                torch.cuda._sleep(0)
            sync()
            time.sleep(WARM_WAIT_S)
        with torch.profiler.record_function(WINDOW):
            run()
            sync()
    kernels, spans, window = [], [], None
    for e in prof.events():
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if str(e.device_type).endswith("CUDA"):
            # the device side of a host range is no operation
            if end > start and not e.name.startswith(SPAN_PREFIX):
                kernels.append((e.name, start, end))
        elif e.name == WINDOW:
            window = (start, end)
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((e.name[len(SPAN_PREFIX):], start, end))
    if window is None:
        raise RuntimeError("the trace holds no window range")
    t0, t1 = window
    inside = [(n, max(s, t0), min(e, t1)) for n, s, e in kernels
              if e > t0 and s < t1]
    return Trace(inside, spans, t0, t1)
