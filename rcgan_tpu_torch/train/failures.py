"""Failure handling, copied from ``rcgan_tpu/train/failures.py``: a
preemption hook that checkpoints on SIGTERM/SIGINT, and a deterministic
fault injection for testing the resume path.

The reference's recovery is "restart the script and resume from the latest
checkpoint" (``cifar10/gan_resnet.py:910-914``); the app keeps that
(``Checkpointer.restore``), and these two pieces let a run stop cleanly and
let a test kill one at a chosen step.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
from typing import Callable, Optional

log = logging.getLogger(__name__)


class PreemptionGuard:
    """Install SIGTERM/SIGINT handlers that set a flag; the training loop
    polls :meth:`should_stop` at iteration boundaries and saves and exits
    cleanly.  ``save_fn`` is invoked at most once, from the main thread."""

    def __init__(self, save_fn: Optional[Callable[[], None]] = None, install: bool = True):
        self._stop = threading.Event()
        self._save_fn = save_fn
        self._saved = False
        self._prev = {}
        if install and threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except (ValueError, OSError):  # non-main thread or a restricted environment
                    pass

    def _handler(self, signum, frame):
        log.warning("received signal %s — will checkpoint and stop at the next step", signum)
        self._stop.set()

    def request_stop(self):
        self._stop.set()

    def should_stop(self) -> bool:
        return self._stop.is_set()

    def finalize(self):
        """Run the save hook (idempotent); call when the loop exits early."""
        if self._stop.is_set() and not self._saved and self._save_fn is not None:
            self._saved = True
            self._save_fn()

    def uninstall(self):
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass


def fault_injection_step() -> Optional[int]:
    """Deterministic fault injection for testing resume:
    ``RCGAN_FAULT_AT_STEP=<n>`` makes the loop raise at step n."""
    v = os.environ.get("RCGAN_FAULT_AT_STEP")
    return int(v) if v else None


def maybe_inject_fault(step: int):
    at = fault_injection_step()
    if at is not None and step == at:
        raise RuntimeError(f"injected fault at step {step} (RCGAN_FAULT_AT_STEP)")
