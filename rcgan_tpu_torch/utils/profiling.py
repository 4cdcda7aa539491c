"""Profiling hooks, ported from ``rcgan_tpu/utils/profiling.py``: ``trace``
(a ``torch.profiler`` trace of a block, written as a Chrome trace),
:class:`StepTimer` (a rolling steps/s meter), ``annotate`` (a named region
in the profiler's trace, ``torch.profiler.record_function`` where JAX has
``jax.profiler.TraceAnnotation``), and :class:`PhaseClock`, the apps' host
seconds by phase."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed block on the host and, where there is one, the
    card; writes ``trace.json`` (Chrome trace format) into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling steps/s meter over the last ``window`` ticks; call
    :meth:`tick` once per step (host clock)."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []

    def tick(self):
        self._times.append(time.perf_counter())
        if len(self._times) > self.window:
            self._times.pop(0)

    @property
    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        return (len(self._times) - 1) / (self._times[-1] - self._times[0])


def annotate(name: str):
    """Named region for profile traces: a context manager (and decorator)
    that the profiler records as ``name``."""
    return torch.profiler.record_function(name)


class PhaseClock:
    """Host seconds by name (each block ends in a host fetch or a device
    synchronise), kept in ``stats`` as ``(seconds, count)`` when the caller
    passes a dict."""

    def __init__(self, stats: Optional[dict], device: torch.device):
        self.stats = stats
        self.device = device

    def add(self, name: str, seconds: float, count: int = 1):
        if self.stats is not None:
            s, n = self.stats.get(name, (0.0, 0))
            self.stats[name] = (s + seconds, n + count)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
