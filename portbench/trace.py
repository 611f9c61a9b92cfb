"""The traced sub-window: `torch.profiler` (CPU + CUDA) around a few
calls, kept in memory and reduced to what the per-layer readers take:
device busy time, the device time of each operation by name, and the
idle gaps labelled by what the host was doing.

Pure arithmetic (`union_length`, `gaps`) takes plain (start, end)
pairs, so the tests can hold it to hand counts.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

WINDOW_NAME = "portbench.window"
#: host events of the profiler itself, never what the program was doing
PROFILER_NAMES = frozenset({"Activity Buffer Request"})


def merge(intervals: Iterable[tuple]) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out: list = []
    for s, e in sorted((float(s), float(e)) for s, e in intervals if e > s):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def union_length(intervals) -> float:
    """Length of the union: overlapping operations count once."""
    return sum(e - s for s, e in merge(intervals))


def gaps(intervals, lo: float, hi: float) -> list:
    """The idle (start, end) stretches of [lo, hi] outside the union."""
    out, t = [], lo
    for s, e in merge(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


@dataclasses.dataclass
class Trace:
    """One profiled sub-window, in seconds on the profiler's clock."""

    window: tuple  # (start, end)
    device: list  # (start, end, name) of every device operation
    host: list  # (start, end, name) of every host operation
    calls: int  # units of work the sub-window ran (calls, or plan steps)
    wall_s: float  # host clock around them
    runs: int = 0  # calls of the driver (episodes, where a call is one)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return union_length(clip([(s, e) for s, e, _ in self.device], *self.window))

    def device_time(self, match: Callable[[str], bool]) -> float:
        """Summed device time of the operations whose name matches."""
        return sum(min(e, self.window[1]) - max(s, self.window[0])
                   for s, e, n in self.device
                   if match(n) and e > self.window[0] and s < self.window[1])

    def top_ops(self, k: int = 10) -> list:
        acc: dict = {}
        for s, e, n in self.device:
            acc[n] = acc.get(n, 0.0) + (e - s)
        return sorted(([n, t] for n, t in acc.items()), key=lambda v: -v[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The k longest idle gaps, each named by the innermost host
        operation open at its middle (or the last one to end before it)."""
        out = []
        for s, e in sorted(gaps([(a, b) for a, b, _ in self.device], *self.window),
                           key=lambda g: g[0] - g[1])[:k]:
            mid = 0.5 * (s + e)
            open_ = [h for h in self.host if h[0] <= mid <= h[1] and h[2] != WINDOW_NAME]
            if open_:
                name = min(open_, key=lambda h: h[1] - h[0])[2]
            else:
                before = [h for h in self.host if h[1] <= mid and h[2] != WINDOW_NAME]
                name = ("after " + max(before, key=lambda h: h[1])[2]) if before else "host"
            out.append([name, e - s])
        return out


def profile(run_call: Callable[[int], object], first: int, calls: int, sync) -> Trace:
    """Run calls first … first + calls − 1 under the profiler; a call
    returns its units of work (None: one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_NAME):
            t0 = time.perf_counter()
            units = 0
            for i in range(first, first + calls):
                u = run_call(i)
                units += 1 if u is None else u
            sync()
            wall = time.perf_counter() - t0
    device, host, window = [], [], None
    for ev in prof.events():
        s, e = ev.time_range.start / 1e6, ev.time_range.end / 1e6
        if ev.name == WINDOW_NAME:
            if ev.device_type != DeviceType.CUDA:
                window = (s, e)
        elif getattr(ev, "is_user_annotation", False) or ev.name in PROFILER_NAMES:
            continue  # a span's image on the device timeline, or the profiler's own
        elif ev.device_type == DeviceType.CUDA:
            device.append((s, e, ev.name))
        else:
            host.append((s, e, ev.name))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    return Trace(window=window, device=device, host=host, calls=units, wall_s=wall, runs=calls)
