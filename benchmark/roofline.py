"""Peaks of one NVIDIA H100 SXM and the roofline arithmetic.

The peaks are NVIDIA's published data-sheet rates for the H100 SXM5, dense
(no sparsity), at its full 700 W power limit: 989 TFLOP/s in bf16 and fp16
on the tensor cores, 67 TFLOP/s in float32 outside them, and 3.35 TB/s of
HBM3.  A card set below 700 W runs slower under load; every result states
the card's power limit beside the shares taken against these peaks.

A piece of work's least time is the larger of its operations over the peak
for their type and its bytes over the memory rate, counting each input
read once and each output written once.
"""

from __future__ import annotations

from typing import NamedTuple

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


class Work(NamedTuple):
    """One operation of a step: ``kind`` (``conv`` or ``mm``), ``phase``
    (``fwd``, ``dgrad``, ``wgrad``), its operations and its bytes."""
    kind: str
    phase: str
    flops: float
    nbytes: float


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time of work of ``flops`` operations in ``dtype`` moving
    ``nbytes``: whichever of the two bounds is larger."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def conv(phase: str, n: int, h: int, w: int, cin: int, cout: int, k: int,
         itemsize: int) -> Work:
    """A stride-1 SAME ``k x k`` convolution ``[n, h, w, cin] → [n, h, w,
    cout]`` or one of its gradients: ``2 n h w cin cout k²`` operations
    each; bytes of the two operands read and the result written (forward:
    x, w → y; input grad: dy, w → dx; weight grad: x, dy → dw)."""
    flops = 2.0 * n * h * w * cin * cout * k * k
    x, y, wt = n * h * w * cin, n * h * w * cout, k * k * cin * cout
    elems = {"fwd": x + wt + y, "dgrad": y + wt + x, "wgrad": x + y + wt}[phase]
    return Work("conv", phase, flops, float(itemsize * elems))


def mm(phase: str, m: int, k: int, n: int, itemsize: int) -> Work:
    """The product ``[m, k] @ [k, n]`` of a linear layer, or one of its
    gradients (each another product of the same ``2 m k n`` operations)."""
    return Work("mm", phase, 2.0 * m * k * n, float(itemsize * (m * k + k * n + m * n)))
