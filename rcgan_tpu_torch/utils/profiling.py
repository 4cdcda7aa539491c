"""Profiling hook, the counterpart of ``rcgan_tpu/utils/profiling.py::trace``:
a ``torch.profiler`` trace of a block, written as a Chrome trace."""

from __future__ import annotations

import contextlib
import os

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
