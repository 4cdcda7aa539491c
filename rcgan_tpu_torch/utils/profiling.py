"""Profiling hooks: ``trace``, the counterpart of
``rcgan_tpu/utils/profiling.py::trace`` (a ``torch.profiler`` trace of a
block, written as a Chrome trace), and :class:`PhaseClock`, the apps'
host seconds by phase."""

from __future__ import annotations

import contextlib
import os
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
