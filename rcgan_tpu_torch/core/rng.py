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

``z`` is drawn by :func:`example_normal`, the counterpart of JAX's
``example_normal``: a counter-based draw on the device (splitmix64 of the
seed, the row's **global** example index and the column, then Box-Muller),
so a row does not depend on the batch it is drawn in, and no host
generator is involved; :func:`example_uniform` (the MNIST stack's
U[-1, 1) latents, JAX ``example_uniform``) is keyed the same way.  Each has
a form keyed by a device scalar, the seed's :func:`seed_base`, for steps
replayed from a CUDA graph (``train/graphs.py``).  The
streams differ from JAX's threefry; tests hand both frameworks the same
noise instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

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


def cycle_seeds(seed: int, n_critic: int, batch: int, start: int = 0) -> CycleSeeds:
    """Every seed of one cycle from the cycle's ``seed``, laid out as JAX's
    ``_cycle`` splits its key: ``fold_in(seed, 1)`` for the G step and
    ``fold_in(seed, 2)`` split over the critic steps.  The dequantisation
    seeds are those of the global rows ``[start, start + batch)``: a
    data-parallel rank's rows."""
    d_key = fold_in(seed, 2)
    keys = [fold_in(d_key, k) for k in range(n_critic)]
    return CycleSeeds(g_z=fold_in(seed, 1), d_z=[fold_in(k, 0) for k in keys],
                      dequant=np.stack([example_seeds(fold_in(k, 1), batch, start)
                                        for k in keys]))


def _mix_device(x: torch.Tensor) -> torch.Tensor:
    """:func:`_mix` on an int64 tensor holding the same 64 bits: the adds
    and multiplies wrap as uint64's do, and each logical right shift is an
    arithmetic one with the copied sign bits masked off."""
    def shr(v, k):
        return (v >> k) & ((1 << (64 - k)) - 1)

    x = x + _signed(0x9E3779B97F4A7C15)
    x = (x ^ shr(x, 30)) * _signed(0xBF58476D1CE4E5B9)
    x = (x ^ shr(x, 27)) * _signed(0x94D049BB133111EB)
    return x ^ shr(x, 31)


def _signed(x: int) -> int:
    """The int64 with the bits of uint64 ``x``."""
    return x - (1 << 64) if x >= 1 << 63 else x


def seed_base(seed: int) -> int:
    """``mix(seed)`` as the int64 with its 64 bits: what :func:`example_bits`
    folds every row with.  A step captured in a CUDA graph cannot take a
    Python seed (the graph would keep the value it was captured with for
    ever), so its host part writes this value into a device buffer and the
    step draws with :func:`example_normal_from` / :func:`example_uniform_from`."""
    return _signed(int(_mix(np.array([seed & ((1 << 64) - 1)], np.uint64))[0]))


def _bits(base, n: int, dim: int, device, first_index: int) -> torch.Tensor:
    index = torch.arange(first_index, first_index + n, dtype=torch.int64, device=device)
    column = torch.arange(dim, dtype=torch.int64, device=device)
    rows = _mix_device(_mix_device(index) ^ base)
    return _mix_device(rows[:, None] ^ _mix_device(column)[None, :])


def example_bits(seed: int, n: int, dim: int, device, first_index: int = 0) -> torch.Tensor:
    """``[n, dim]`` int64 hashes, one per (example, column):
    ``mix(mix(mix(seed) ^ mix(index)) ^ mix(column))`` with the example's
    global index ``first_index + i``; computed on ``device``."""
    return _bits(seed_base(seed), n, dim, device, first_index)


def example_bits_from(base: torch.Tensor, n: int, dim: int, first_index: int = 0
                      ) -> torch.Tensor:
    """:func:`example_bits` of the seed whose :func:`seed_base` is ``base``,
    an int64 scalar tensor (shape ``()`` or ``[1]``) on the device where the
    hashes are computed: the same bits."""
    return _bits(base.reshape(()), n, dim, base.device, first_index)


def _normal(bits: torch.Tensor) -> torch.Tensor:
    hi = (bits >> 32) & 0xFFFFFFFF
    lo = bits & 0xFFFFFFFF
    u1 = (hi.to(torch.float32) + 1.0) * 2.0 ** -32
    u2 = lo.to(torch.float32) * 2.0 ** -32
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def _uniform(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    u = ((bits >> 40) & 0xFFFFFF).to(torch.float32) * 2.0 ** -24
    return minval + (maxval - minval) * u


def example_normal(seed: int, n: int, dim: int, device, first_index: int = 0) -> torch.Tensor:
    """``[n, dim]`` float32 standard normals on ``device`` whose row ``i``
    depends only on ``(seed, first_index + i)`` (JAX ``example_normal``):
    rows ``[k, k + m)`` of a draw of ``n`` equal a draw of ``m`` with
    ``first_index=k``.  Each element's 64-bit hash gives two uniforms, its
    high 32 bits ``u1`` in (0, 1] and its low 32 bits ``u2`` in [0, 1), and
    Box-Muller's ``sqrt(-2 ln u1) cos(2 pi u2)`` the normal (|z| < 6.7)."""
    return _normal(example_bits(seed, n, dim, device, first_index))


def example_normal_from(base: torch.Tensor, n: int, dim: int, first_index: int = 0
                        ) -> torch.Tensor:
    """:func:`example_normal` keyed by a device ``base`` (:func:`seed_base`
    of the seed) instead of the seed: the same values, on ``base``'s
    device."""
    return _normal(example_bits_from(base, n, dim, first_index))


def example_uniform(seed: int, n: int, dim: int, device, minval: float = 0.0,
                    maxval: float = 1.0, first_index: int = 0) -> torch.Tensor:
    """``[n, dim]`` float32 uniforms in ``[minval, maxval)`` on ``device``,
    keyed per example as :func:`example_normal` (JAX ``example_uniform``):
    the top 24 bits of each element's hash give ``u`` in [0, 1) exactly in
    float32, and ``minval + (maxval - minval) u`` the value."""
    return _uniform(example_bits(seed, n, dim, device, first_index), minval, maxval)


def example_uniform_from(base: torch.Tensor, n: int, dim: int, minval: float = 0.0,
                         maxval: float = 1.0, first_index: int = 0) -> torch.Tensor:
    """:func:`example_uniform` keyed by a device ``base`` (:func:`seed_base`
    of the seed): the same values, on ``base``'s device."""
    return _uniform(example_bits_from(base, n, dim, first_index), minval, maxval)
