"""Kernel runtime: device checks, the CUDA build, and launch counters.

Counterpart of ``rcgan_tpu/ops/pallas/runtime.py``.  The JAX package routes
each Pallas kernel by environment switches (``RCGAN_PALLAS_*``); the port
has none.  Routing is decided by where the tensor lives:

- a CPU tensor goes to the kernel's plain PyTorch version;
- a CUDA tensor goes to the hand-written kernel, or the call raises.

Launches are counted on the host, where a wrapper launches; a launch
recorded into a CUDA graph is counted by each replay instead
(:func:`recorded_launches`, :func:`add_launches`).  There is no fallback
from a failed build or launch to the plain version.

CUDA sources under ``rcgan_tpu_torch/csrc`` are compiled with ``nvcc`` at
first use into ``rcgan_tpu_torch/_build`` (listed in ``.gitignore``), as
shared libraries with a plain C interface loaded through ``ctypes``.  A
library's file name carries a hash of its source, so an edited source is
rebuilt and a stale library is never loaded.  ``ptxas`` reports each
kernel's registers, shared memory and spills (``-Xptxas=-v``); the report of
a build made by this process is kept in :data:`build_logs`.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# Launch counters, one per hand-written kernel.  A wrapper adds one where it
# launches its kernel and nowhere else, so a run can show that its main path
# went through the kernels.
KERNELS = ("cond_bn", "conv3x3", "sn", "projection", "dequant")
# A kernel with several implementations also counts each call under its
# variant.  A variant in LIBRARY_VARIANTS is a call routed by shape to a
# library (cuDNN), not a launch of a hand-written kernel: it is counted by
# variant, so that a run shows where every call went, and left out of the
# kernel's own count, which is the total of the other variants.
VARIANTS = {"conv3x3": ("wgmma", "ffma", "cudnn")}
LIBRARY_VARIANTS = {"conv3x3": ("cudnn",)}
_counts: Dict[str, int] = {k: 0 for k in KERNELS}
_variant_counts: Dict[str, Dict[str, int]] = {k: dict.fromkeys(v, 0) for k, v in VARIANTS.items()}
_count_lock = threading.Lock()

_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # library -> nvcc's output, for builds made here
_build_locks: Dict[str, threading.Lock] = {}  # one per library: builds run in parallel
_locks_lock = threading.Lock()


class LaunchRecord:
    """Launches counted inside :func:`recorded_launches`: ``counts`` by
    kernel, ``variants`` by kernel and variant (the shape of
    :func:`launch_counts` and :func:`variant_counts`)."""

    def __init__(self):
        self.counts: Dict[str, int] = {k: 0 for k in KERNELS}
        self.variants: Dict[str, Dict[str, int]] = {k: dict.fromkeys(v, 0)
                                                    for k, v in VARIANTS.items()}


_records: Dict[int, LaunchRecord] = {}  # capture stream's raw handle -> its record


def _capturing_stream() -> Optional[int]:
    """The raw handle of this thread's current CUDA stream while a CUDA
    graph captures it, else None."""
    if not torch.cuda.is_current_stream_capturing():
        return None
    return torch.cuda.current_stream().cuda_stream


def count_launch(name: str, variant: Optional[str] = None) -> None:
    """One launch of kernel ``name`` (of ``variant``), added to the totals,
    or, when it is recorded into a CUDA graph (:func:`recorded_launches`),
    to the capture's record."""
    if (variant is None) != (name not in VARIANTS) \
            or (variant is not None and variant not in VARIANTS[name]):
        raise ValueError(f"{name}: variant {variant!r} (want one of {VARIANTS.get(name)})")
    rec = _records.get(_capturing_stream()) if _records else None
    with _count_lock:
        counts = _counts if rec is None else rec.counts
        variants = _variant_counts if rec is None else rec.variants
        if variant not in LIBRARY_VARIANTS.get(name, ()):
            counts[name] += 1
        if variant is not None:
            variants[name][variant] += 1


@contextlib.contextmanager
def recorded_launches(stream: int) -> Iterator[LaunchRecord]:
    """Inside the block, the launches that the wrappers count on ``stream``
    (a raw stream handle) while a CUDA graph captures it go to the yielded
    :class:`LaunchRecord` and not to the totals, from whichever thread
    launches them (autograd runs a backward on a thread of its own, on the
    stream of its forward).  Nothing runs at a capture, and every replay
    then adds the record once (:func:`add_launches`), so that the totals
    read after N replays as after N eager calls."""
    rec = LaunchRecord()
    with _count_lock:
        if stream in _records:
            raise RuntimeError(f"stream {stream:#x} is already being recorded")
        _records[stream] = rec
    try:
        yield rec
    finally:
        with _count_lock:
            del _records[stream]


def add_launches(rec: LaunchRecord, times: int = 1) -> None:
    """Add ``times`` runs of what ``rec`` recorded to the totals (one replay
    of a captured graph per run)."""
    with _count_lock:
        for k, n in rec.counts.items():
            _counts[k] += times * n
        for k, d in rec.variants.items():
            for v, n in d.items():
                _variant_counts[k][v] += times * n


def launch_counts() -> Dict[str, int]:
    with _count_lock:
        return dict(_counts)


def variant_counts(name: str) -> Dict[str, int]:
    """Launches of kernel ``name`` by variant since the last reset."""
    with _count_lock:
        return dict(_variant_counts[name])


def reset_launch_counts() -> None:
    with _count_lock:
        for k in _counts:
            _counts[k] = 0
        for d in _variant_counts.values():
            for v in d:
                d[v] = 0


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device that is absent raises
    rather than letting the caller carry on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return dev


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device, False when every tensor
    is on the CPU; raises on a mix or on any other device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev} (cpu or cuda)")


def on_device(t: torch.Tensor, fn, *args):
    """``fn(*args, stream)``: a kernel's C entry point called with the raw
    handle of the current stream of CUDA tensor ``t``'s device, with that
    device current.  The raw lookups (the ones Triton's launcher makes)
    cost under a microsecond; ``torch.cuda.current_stream()`` builds a
    Python stream object and ``torch.cuda.device`` switches devices twice,
    about 10 us of host time a call on an H100's host (``PERF.md``), so the
    device is switched only when it is not already the current one."""
    index = t.device.index
    if index == torch._C._cuda_getDevice():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(t: torch.Tensor) -> int:
    """Streaming multiprocessors of the CUDA device ``t`` lies on."""
    return _sm_count(t.device.index if t.device.index is not None
                     else torch.cuda.current_device())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; it is needed to "
                           "build the CUDA kernels")
    return path


def cuda_library(name: str) -> ctypes.CDLL:
    """Build (once per source version) and load ``csrc/<name>.cu``.  Calls
    for different libraries may run in parallel threads, one nvcc each."""
    with _locks_lock:
        lock = _build_locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC_DIR / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src} ({' '.join(cmd)}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)
            build_logs[name] = proc.stdout + proc.stderr
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib


def check_cuda_status(lib: ctypes.CDLL, error_string_fn: str, code: int, what: str) -> None:
    if code != 0:
        fn = getattr(lib, error_string_fn)
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {code} ({fn(code).decode()})")
