"""A traced segment, from ``torch.profiler``.

The segment runs inside a ``bench.window`` span.  From the trace it keeps
every device operation (kernel, copy, set; not the device-side copies of
the host's annotations) that overlaps the span: the seconds by name and
the union of their intervals (busy), the span's length (window), and the
longest idle gaps, each named by the innermost host event that was running
at its middle.  On the host it keeps the seconds inside the drivers'
``bench.call`` spans (the program's calls) that the CUDA runtime's calls
leave: the host's own work of dispatching a step, without the time it
waits in the runtime for room in the launch queue or for the device.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, List, NamedTuple, Tuple

WINDOW_SPAN = "bench.window"
CALL_SPAN = "bench.call"
TOP = 10


class Trace(NamedTuple):
    steps: int                                # steps inside the segment
    window_s: float
    busy_s: float
    by_name: Dict[str, Tuple[float, int]]     # device seconds and count by name
    gaps: List[Tuple[str, float]]             # longest idle gaps, by host event
    host_s: float                             # in the calls, outside the CUDA runtime

    def top_ops(self, n: int = TOP) -> List[Tuple[str, float]]:
        rows = sorted(((s, k) for k, (s, _) in self.by_name.items()), reverse=True)[:n]
        return [[k, s] for s, k in rows]


def _union(intervals: List[Tuple[float, float]], lo: float, hi: float):
    """Busy length of ``intervals`` clipped to ``[lo, hi]``, and the idle
    gaps ``(start, end)`` between them."""
    busy, gaps, cur = 0.0, [], lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def summarize(events, steps: int) -> Trace:
    """A :class:`Trace` of the profiler's ``events()`` (times in µs)."""
    from torch.autograd import DeviceType

    span = [e for e in events if e.name == WINDOW_SPAN and e.device_type == DeviceType.CPU]
    if len(span) != 1:
        raise RuntimeError(f"{len(span)} {WINDOW_SPAN} spans in the trace")
    lo, hi = span[0].time_range.start, span[0].time_range.end
    dev, host = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name.startswith("bench."):
                continue
            if e.time_range.end > lo and e.time_range.start < hi:
                dev.append(e)
        elif e.name != WINDOW_SPAN:
            host.append(e)
    calls = sorted((e.time_range.start, e.time_range.end) for e in host if e.name == CALL_SPAN)
    starts = [a for a, _ in calls]
    runtime = 0.0
    for e in host:
        if e.name.startswith("cuda"):
            i = bisect.bisect_right(starts, e.time_range.start) - 1
            if i >= 0 and e.time_range.end <= calls[i][1]:
                runtime += e.time_range.end - e.time_range.start
    host_s = (sum(b - a for a, b in calls) - runtime) * 1e-6
    by_name: Dict[str, Tuple[float, int]] = {}
    for e in dev:
        s, n = by_name.get(e.name, (0.0, 0))
        a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
        by_name[e.name] = (s + (b - a) * 1e-6, n + 1)
    busy, gaps = _union([(e.time_range.start, e.time_range.end) for e in dev], lo, hi)
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = 0.5 * (a + b)
        inside = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        name = min(inside, key=lambda e: e.time_range.end - e.time_range.start).name \
            if inside else "no host event"
        named.append([name, (b - a) * 1e-6])
    return Trace(steps, (hi - lo) * 1e-6, busy * 1e-6, by_name, named, host_s)


def traced(segment: Callable[[], int], sync: Callable[[], None]) -> Trace:
    """``segment()`` (which returns the steps it ran) under the profiler,
    inside the window span, ended by ``sync()``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            steps = segment()
            sync()
    return summarize(prof.events(), steps)
