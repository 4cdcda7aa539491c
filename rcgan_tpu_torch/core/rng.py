"""Seeds of a training cycle, derived on the host, the counterpart of
``rcgan_tpu/core/rng.py``.

JAX splits and folds PRNG keys inside its compiled cycle.  The port derives
every seed of a cycle from ``(seed, step)`` on the host with a 64-bit
integer hash (splitmix64), so nothing waits on the device:

- one seed for the G step's ``z``;
- for each critic step ``k``, one seed for its ``z`` and a ``[B]`` int32
  vector of per-row dequantisation seeds keyed by the row's **global**
  batch index, as JAX's ``example_keys`` keys them: an example's
  dequantisation noise does not depend on how the batch is laid out.

``z`` is drawn from one device ``torch.Generator`` per draw
(:func:`normal`), so its rows are not yet keyed per example: that waits for
parallel training (ROADMAP.md, Queue 1).  The streams differ from JAX's
threefry; tests hand both frameworks the same noise instead.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

_SEED_MASK = (1 << 63) - 1


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64 on a uint64 array (wrapping arithmetic)."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _fold(seed: int, data: np.ndarray) -> np.ndarray:
    base = _mix(np.array([seed & ((1 << 64) - 1)], np.uint64))
    return _mix(base ^ _mix(np.asarray(data, np.uint64)))


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``(seed, data)`` (JAX ``fold_in``)."""
    return int(_fold(seed, np.array([data]))[0]) & _SEED_MASK


def example_seeds(seed: int, n: int, start: int = 0) -> np.ndarray:
    """``[n]`` int32 seeds in ``[0, 2³¹ − 1)``, one per example, keyed by
    the global index ``start + i`` (JAX ``example_keys``)."""
    h = _fold(seed, np.arange(start, start + n, dtype=np.uint64))
    return (h % np.uint64(2**31 - 1)).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class CycleSeeds:
    g_z: int                # the G step's z
    d_z: List[int]          # each critic step's z
    dequant: np.ndarray     # [n_critic, B] int32 per-row dequantisation seeds


def cycle_seeds(seed: int, n_critic: int, batch: int) -> CycleSeeds:
    """Every seed of one cycle from the cycle's ``seed``, laid out as JAX's
    ``_cycle`` splits its key: ``fold_in(seed, 1)`` for the G step and
    ``fold_in(seed, 2)`` split over the critic steps."""
    d_key = fold_in(seed, 2)
    keys = [fold_in(d_key, k) for k in range(n_critic)]
    return CycleSeeds(g_z=fold_in(seed, 1), d_z=[fold_in(k, 0) for k in keys],
                      dequant=np.stack([example_seeds(fold_in(k, 1), batch) for k in keys]))


def normal(seed: int, shape: Sequence[int], device) -> torch.Tensor:
    """float32 standard normals of ``shape`` on ``device`` from a generator
    on that device seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & _SEED_MASK)
    return torch.randn(tuple(shape), generator=gen, device=device)
