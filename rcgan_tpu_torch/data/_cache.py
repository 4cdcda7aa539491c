"""On-disk memoization for the deterministic synthetic dataset renderer,
copied from ``rcgan_tpu/data/_cache.py``.

``cifar10.synthetic_cifar`` is a pure function of its arguments, but
rendering is host-side numpy work that runs at the start of every
experiment (about half a minute for 50k 32px images).  This module caches
the rendered arrays as uncompressed ``.npz`` files (bit-exact round trip)
keyed by every argument that affects the output (``chunk`` included: the
per-chunk RNG draws make the image stream chunk-dependent) and by a digest
of the renderer's compiled code, so an edited renderer never reads a stale
entry.

Location: ``$RCGAN_SYNTH_CACHE`` (``0``/``off``/``none``/empty disables),
default ``~/.cache/rcgan_tpu_torch/synth``.  Writes are atomic (temp file +
``os.replace``), so concurrent runs at worst render twice.
"""

from __future__ import annotations

import hashlib
import marshal
import os
import tempfile

import numpy as np

_DISABLED = ("", "0", "off", "none")


def cache_dir() -> str | None:
    d = os.environ.get("RCGAN_SYNTH_CACHE")
    if d is None:
        d = os.path.join(os.path.expanduser("~"), ".cache", "rcgan_tpu_torch", "synth")
    return None if d.strip().lower() in _DISABLED else d


def _code_digest(fn) -> str:
    return hashlib.sha1(marshal.dumps(fn.__code__)).hexdigest()[:10]


def memoize_render(name: str, key: dict, render, code_of=None):
    """Return ``render()``'s tuple of numpy arrays, served from or saved to
    the cache when it is enabled.  ``render`` must be a deterministic
    function of ``key``; the code object of ``code_of`` (default:
    ``render``; pass the underlying renderer when ``render`` is a closure
    over it) is part of the cache key."""
    d = cache_dir()
    if d is None:
        return render()
    parts = "_".join(f"{k}{key[k]}" for k in sorted(key))
    path = os.path.join(d, f"{name}_{parts}_{_code_digest(code_of or render)}.npz")
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                return tuple(z[f"arr_{i}"] for i in range(len(z.files)))
        except Exception:
            pass  # a truncated or corrupt entry: render again
    arrays = tuple(render())
    try:
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
        os.close(fd)
        np.savez(tmp, *arrays)
        os.replace(tmp, path)
    except OSError:
        pass  # a read-only or full cache volume: caching is best-effort
    return arrays
