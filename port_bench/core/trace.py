"""A short stretch of the window under ``torch.profiler``, reduced in memory.

No chrome trace is written.  ``Trace`` keeps the device's events (kernels,
copies and fills) and the host's ops, and answers what the per-layer
readers ask: time per kernel name, the union of device intervals (busy),
the idle gaps and what the host was doing in each.  ``device_events`` and
``busy_us`` are chip_smoke.py's (the union of device intervals)."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import List, Optional, Tuple

import torch

Event = Tuple[str, float, float]  # (name, start µs, end µs)
_LOOK_BACK = 64


def device_events(prof) -> List[Event]:
    """(name, start_us, end_us) of every device-side event in a trace."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def host_events(prof) -> List[Event]:
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]


def busy_us(events) -> float:
    """Length of the union of the events' intervals."""
    return sum(e - s for s, e in _union(events))


def _union(events) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for _, s, e in sorted(events, key=lambda t: t[1]):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Trace:
    """The reduced trace of one profiled stretch of ``wall_s`` seconds."""

    def __init__(self, device: List[Event], host: List[Event], wall_s: float):
        self.device = device
        self.host = host
        self.wall_s = wall_s

    @property
    def busy_s(self) -> float:
        return busy_us(self.device) / 1e6

    def durations_s(self, match: str) -> List[float]:
        """Seconds of each device event whose name contains ``match``."""
        return [(e - s) / 1e6 for name, s, e in self.device if match in name]

    def time_s(self, match: str) -> float:
        return sum(self.durations_s(match))

    def count(self, match: str) -> int:
        return len(self.durations_s(match))

    def device_ops(self, top: int = 10) -> List[list]:
        """[[name, seconds], ...]: the device operations that took most time."""
        by_name = defaultdict(float)
        for name, s, e in self.device:
            by_name[name] += (e - s) / 1e6
        return [[n, v] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """[[what the host was doing, seconds], ...]: the device's idle time
        inside the stretch, summed by the innermost host op running at the
        middle of each gap ("host: no op traced" where none was); of the
        host ops that start before the middle, the last ``_LOOK_BACK`` are
        searched."""
        spans = _union(self.device)
        host = sorted(self.host, key=lambda t: t[1])
        starts = [s for _, s, _ in host]
        by_name = defaultdict(float)
        for (_, end), (start, _) in zip(spans, spans[1:]):
            mid = (end + start) / 2
            inner = None
            hi = bisect.bisect_right(starts, mid)
            for name, s, e in host[max(0, hi - _LOOK_BACK):hi]:
                if e >= mid and (inner is None or e - s < inner[2] - inner[1]):
                    inner = (name, s, e)
            by_name[inner[0] if inner else "host: no op traced"] += (start - end) / 1e6
        return [[n, v] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops(), "idle_gaps": self.idle_gaps()}


class Profiler:
    """``torch.profiler`` over a stretch of the window: ``start``, ``stop``,
    and once the window has closed ``reduce`` (the events are read then,
    not while the window runs).  ``interval`` spans the profiler's own
    start and stop; ``wall_s`` the recorded stretch between them."""

    def __init__(self):
        self._prof = None
        self._begin: Optional[float] = None
        self._t0: Optional[float] = None
        self._wall: Optional[float] = None
        #: (start, end) perf_counter seconds, the profiler's start and stop included
        self.interval: Optional[Tuple[float, float]] = None

    @property
    def waiting(self) -> bool:
        """Not started yet."""
        return self._begin is None

    @property
    def running(self) -> bool:
        return self._t0 is not None and self.interval is None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._begin = time.perf_counter()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts, acc_events=True)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._wall = time.perf_counter() - self._t0
        self._prof.stop()
        self.interval = (self._begin, time.perf_counter())

    def reduce(self) -> Trace:
        trace = Trace(device_events(self._prof), host_events(self._prof), self._wall)
        self._prof = None
        return trace


def warm_profiler() -> None:
    """Start and stop the profiler once on this thread, so that the device
    tracer's one-time start-up does not fall into the window."""
    prof = Profiler()
    prof.start()
    prof.stop()
    prof.reduce()
