"""ctypes bindings for the native host-data engine (``data_engine.cpp``), the
counterpart of ``rcgan_tpu/native/__init__.py``.

The library is built with g++ at first use into ``rcgan_tpu_torch/_build/``
(listed in ``.gitignore``), its file name keyed by a digest of the source,
so an edited source is rebuilt and a stale library is never loaded.  There
is no NumPy fallback: the JAX binding's fallbacks draw another stream than
the engine, so a run without the library would not give the JAX package's
labels.  A failed build or load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().with_name("data_engine.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libdata_engine-{digest}.so"


def get_lib() -> ctypes.CDLL:
    """Load the shared library, building it first if this source version
    has none; raises if g++ fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"building the data engine ({' '.join(cmd)}) failed: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {_SRC} ({' '.join(cmd)}):\n{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        u64, i64, i32 = ctypes.c_uint64, ctypes.c_int64, ctypes.c_int32
        pi32 = np.ctypeslib.ndpointer(np.int32, flags="C")
        pi64 = np.ctypeslib.ndpointer(np.int64, flags="C")
        pf64 = np.ctypeslib.ndpointer(np.float64, flags="C")
        pf32 = np.ctypeslib.ndpointer(np.float32, flags="C")
        lib.corrupt_labels.argtypes = [u64, i64, i32, pi32, pf64, pi32]
        lib.make_label_tuple.argtypes = [u64, i64, i32, i32, pi32, pf64, pf64, pi32, pi32, pi32,
                                         pf32]
        lib.shuffle_indices.argtypes = [u64, i64, pi64]
        lib.abi_version.restype = i32
        if lib.abi_version() != 1:
            raise RuntimeError(f"{out}: data engine ABI {lib.abi_version()}, want 1")
        _lib = lib
        return _lib


def corrupt_labels(seed: int, labels: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Each label ``y`` replaced by a draw from row ``c[y]``."""
    labels = np.ascontiguousarray(labels, np.int32)
    c = np.ascontiguousarray(c, np.float64)
    out = np.empty(len(labels), np.int32)
    get_lib().corrupt_labels(seed, len(labels), c.shape[0], labels, c, out)
    return out


def make_label_tuple(seed: int, y_actual: np.ndarray, c: np.ndarray, c_inv: np.ndarray,
                     real_match: bool = False):
    """``(labels, labels_random, labels_biased, labels_inv_weights)`` of a
    split from its true labels, drawn by one engine stream from ``seed``."""
    y_actual = np.ascontiguousarray(y_actual, np.int32)
    c = np.ascontiguousarray(c, np.float64)
    c_inv = np.ascontiguousarray(c_inv, np.float64)
    n, k = len(y_actual), c.shape[0]
    y_real = np.empty(n, np.int32)
    y_gen = np.empty(n, np.int32)
    y_fake = np.empty(n, np.int32)
    weights = np.empty((n, k), np.float32)
    get_lib().make_label_tuple(seed, n, k, int(real_match), y_actual, c, c_inv, y_real, y_gen,
                               y_fake, weights)
    return y_real, y_gen, y_fake, weights


def shuffle_indices(seed: int, n: int) -> np.ndarray:
    """A permutation of ``range(n)`` (int64) from ``seed``."""
    out = np.empty(n, np.int64)
    get_lib().shuffle_indices(seed, n, out)
    return out
