"""Conditional batch-norm, ported from ``rcgan_tpu/ops/norm.py::cond_batchnorm``.

Batch statistics always, even when sampling, and no running statistics:
that is the reference's semantics (``normalization.py:47-58``), and an
``nn.BatchNorm2d`` in eval mode would diverge from it.  Per-class
``scale``/``offset`` come from ``[n_labels, C]`` tables.  The computation
is the hand-written kernel's
(:func:`rcgan_tpu_torch.ops.kernels.norm_kernel.cond_batchnorm`).
The unconditional ``batch_norm`` and ``layer_norm`` are not ported yet.
"""

from __future__ import annotations

import torch

from rcgan_tpu_torch.core import initializers as inits
from rcgan_tpu_torch.core.module import Scoped
from rcgan_tpu_torch.ops.kernels import norm_kernel


def cond_batchnorm(x: torch.Tensor, labels: torch.Tensor, scale_table: torch.Tensor,
                   offset_table: torch.Tensor, epsilon: float = 1e-5,
                   relu: bool = False) -> torch.Tensor:
    """``x [B,H,W,C]``, ``labels [B]`` int → ``[B,H,W,C]`` in ``x.dtype``;
    with ``relu`` the kernel applies a ReLU before it stores."""
    if x.dim() != 4:
        raise ValueError(f"cond_batchnorm expects BHWC; got {tuple(x.shape)}")
    b, h, w, c = x.shape
    out = norm_kernel.cond_batchnorm(x.reshape(b, h * w, c), labels, scale_table,
                                     offset_table, epsilon, relu)
    return out.reshape(b, h, w, c)


class CondBatchNorm(Scoped):
    """Per-class affine tables ``offset`` (zeros) and ``scale`` (ones),
    ``[n_labels, C]``."""

    def __init__(self, n_labels: int, channels: int, scope: str, seed: int = 0):
        super().__init__(scope, seed)
        self.add_param("offset", (n_labels, channels), inits.zeros)
        self.add_param("scale", (n_labels, channels), inits.ones)

    def forward(self, x: torch.Tensor, labels: torch.Tensor, relu: bool = False) -> torch.Tensor:
        return cond_batchnorm(x, labels, self.scale, self.offset, relu=relu)
