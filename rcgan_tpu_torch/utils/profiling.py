"""Profiling hooks, ported from ``rcgan_tpu/utils/profiling.py``: ``trace``
(a ``torch.profiler`` trace of a block, written as a Chrome trace),
``annotate`` (a named region in the profiler's trace, ``torch.profiler.
record_function`` where JAX has ``jax.profiler.TraceAnnotation``),
:class:`Spans` (a program's spans: the host parts of its calls and the
device phases of its steps) and :class:`PhaseClock`, the apps' host seconds
by phase.

**Spans.**  Each compiled program (``train/graphs.py::CapturedStep``) owns
one :class:`Spans`, as it owns its graph and pool; ``CapturedStep.stats()``
returns its totals beside the capture counters:

- host spans, ``with spans.host(name, steps=k):`` around a part of a call
  that prepares or reads ``k`` steps: ``host_s.<name>`` (host seconds) and
  ``host_steps.<name>`` (the steps they covered), always; while a profiler
  runs the part is also a ``record_function`` region named ``rcgan.<name>``,
  on the profiler's clock with its device trace;
- device spans, marked in a step's body by :func:`mark`: each mark closes
  the span that the previous mark opened and opens its own.  On a card a
  mark launches a one-thread stamp kernel (``csrc/spans.cu``) on the
  current stream, so that a CUDA graph captures it and every replay runs
  it: the kernel reads ``%globaltimer`` and adds the nanoseconds since the
  previous stamp to the closing span's total in a device buffer.  Off a
  card the host clock stands in (the CPU runs a step's ops as they are
  called).  ``device_s.<name>`` are the totals in seconds, over
  ``device_steps`` steps.  The span from a step's last mark to the next
  step's first is ``between``: the device's wait for the host between
  steps.  The totals start again at each capture, so that they cover the
  steps of the graph that runs and not the eager steps and capture before
  it; and a start or stop of the profiler drops the one ``between`` it
  falls in;
- nested device spans, ``with span(name):`` inside a phase: a mark that
  opens ``name`` and, at the block's end, a mark that opens the enclosing
  phase again, so that the phase's total leaves out the nested span's and
  the two add up to what the phase alone reads.  An op calls it in its
  forward and its backward (``ops/attention.py``); autograd runs a card's
  backward on a thread of its own, on the step's stream, so a thread
  outside any body takes the spans of the body that the process runs.
  Nested spans take their slots from the same ``_SLOTS``.

The device marks are on by default; :data:`device_marks` turns them off (it
is read as a body runs, so a graph keeps what its capture found).  The
marks read and write no tensor of the step.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
import time
from typing import Dict, Iterator, Optional

import torch

from rcgan_tpu_torch.ops.kernels import runtime

device_marks = True  # False: a step's body marks no device span

SPAN_PREFIX = "rcgan."  # a host span's region name in the profiler's trace
BETWEEN = "between"     # the device span from a step's last mark to the next step's first
_SLOTS = 31             # device spans a program may name (slot 0 of the buffer: the last stamp)

_running = threading.local()  # .spans: the Spans of the body this thread runs
_process: Optional["Spans"] = None  # the Spans of the body the process runs, for other threads


def _profiling() -> bool:
    """True while a ``torch.profiler`` (or autograd profiler) records."""
    return torch.autograd.profiler._is_profiler_enabled


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


def annotate(name: str):
    """Named region for profile traces: a context manager that the profiler
    records as ``name``; nothing while no profiler runs."""
    return torch.profiler.record_function(name) if _profiling() else contextlib.nullcontext()


def mark(name: str) -> None:
    """Close the device span open in the running program's step and open
    ``name`` (:meth:`Spans.mark`); nothing outside a program's body."""
    spans = getattr(_running, "spans", None)
    if spans is not None:
        spans.mark(name)


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """A device span ``name`` nested in the phase open when the block
    starts, which opens again when it ends (module doc); nothing outside a
    program's body."""
    spans = getattr(_running, "spans", None) or _process
    if spans is None or not device_marks:
        yield
        return
    outer = spans._open
    spans.mark(name)
    try:
        yield
    finally:
        spans.mark(outer)


class _HostSpan:
    __slots__ = ("spans", "name", "steps", "region", "t")

    def __init__(self, spans: "Spans", name: str, steps: int):
        self.spans, self.name, self.steps = spans, name, steps

    def __enter__(self):
        self.region = None
        if self.spans._profiled_now():
            self.region = torch.profiler.record_function(SPAN_PREFIX + self.name)
            self.region.__enter__()
        self.t = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t
        spans = self.spans
        s, n = spans._host.get(self.name, (0.0, 0))
        spans._host[self.name] = (s + dt, n + self.steps)
        if self.region is not None:
            self.region.__exit__(*exc)


class Spans:
    """The host and device spans of one program on ``device`` (module
    doc)."""

    def __init__(self, device):
        self.device = torch.device(device)
        # a card is there (the tests' stand-in capture names a CUDA device on the CPU)
        self.on_card = self.device.type == "cuda" and torch.cuda.is_available()
        self.steps = 0                    # steps the device totals cover
        self._host: Dict[str, tuple] = {}  # name -> (seconds, steps)
        self._slot: Dict[str, int] = {BETWEEN: 0}
        self._open = BETWEEN
        self._buf: Optional[torch.Tensor] = None  # card: [1 + slots] int64 ns
        self._ns = [0] * (1 + _SLOTS)     # off a card: the same, on the host clock
        self._profiled = False

    # ------------------------------------------------------------- host
    def host(self, name: str, steps: int = 1) -> _HostSpan:
        """A context manager that adds its host seconds and ``steps`` to
        ``host_s.<name>`` and ``host_steps.<name>``."""
        return _HostSpan(self, name, steps)

    def _profiled_now(self) -> bool:
        """Whether a profiler runs; a change since the last host span
        restarts the device clock, so that the profiler's own start or stop
        falls in no span."""
        on = _profiling()
        if on != self._profiled:
            self._profiled = on
            self.restart()
        return on

    # ----------------------------------------------------------- device
    @contextlib.contextmanager
    def active(self):
        """Inside the block this thread's :func:`mark` calls go to these
        spans (a step's body runs there), its first closing ``between``."""
        global _process
        prev, prev_process = getattr(_running, "spans", None), _process
        _running.spans = _process = self
        self._open = BETWEEN
        try:
            yield
        finally:
            _running.spans, _process = prev, prev_process

    def mark(self, name: str) -> None:
        """Close the span the previous mark opened and open ``name``: on a
        card a stamp kernel on the current stream (recorded by a capture),
        else the host clock.  Nothing while :data:`device_marks` is off."""
        if not device_marks:
            return
        slot = self._slot.get(name)
        if slot is None:
            if len(self._slot) == _SLOTS:
                raise ValueError(f"more than {_SLOTS} device spans in one program")
            slot = self._slot[name] = len(self._slot)
        closing, self._open = self._slot[self._open], name
        self._stamp(closing)

    def restart(self) -> None:
        """Drop the span now open: its time so far is added nowhere."""
        if self._buf is not None or any(self._ns):
            self._stamp(-1)

    def reset(self) -> None:
        """Every device total and :attr:`steps` to zero, and no stamp yet."""
        self.steps = 0
        self._ns = [0] * (1 + _SLOTS)
        if self._buf is not None:
            self._buf.zero_()

    def _stamp(self, closing: int) -> None:
        """Add the time since the last stamp to span ``closing`` (if >= 0,
        and if there was a stamp), and stamp now."""
        if not self.on_card:
            now, last = time.perf_counter_ns(), self._ns[0]
            if closing >= 0 and last:
                self._ns[1 + closing] += now - last
            self._ns[0] = now
            return
        if self._buf is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a program's first device mark must run outside a capture")
            self._buf = torch.zeros(1 + _SLOTS, dtype=torch.int64, device=self.device)
        lib = runtime.cuda_library("spans")
        fn = lib.spans_stamp
        if fn.argtypes is None:  # first use of this entry point
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        code = runtime.on_device(self._buf, fn, self._buf.data_ptr(), closing)
        runtime.check_cuda_status(lib, "spans_error_string", code, "span stamp")

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, float]:
        """``host_s.<name>``, ``host_steps.<name>`` of every host span and,
        once a step has marked, ``device_s.<name>`` of every device span
        and ``device_steps`` (one copy from the card)."""
        out: Dict[str, float] = {}
        for name, (s, n) in self._host.items():
            out[f"host_s.{name}"], out[f"host_steps.{name}"] = s, n
        if len(self._slot) > 1:
            ns = self._buf.tolist() if self._buf is not None else self._ns
            for name, slot in self._slot.items():
                out[f"device_s.{name}"] = ns[1 + slot] * 1e-9
            out["device_steps"] = self.steps
        return out


def timer_tick_ns(device) -> int:
    """The smallest nonzero step of the card's ``%globaltimer`` (the device
    spans' clock), over consecutive reads by one thread."""
    out = torch.zeros(1, dtype=torch.int64, device=device)
    lib = runtime.cuda_library("spans")
    fn = lib.spans_timer_tick
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = runtime.on_device(out, fn, out.data_ptr(), 1 << 16)
    runtime.check_cuda_status(lib, "spans_error_string", code, "timer tick")
    return int(out.item())


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
