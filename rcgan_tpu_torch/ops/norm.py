"""Normalizations, ported from ``rcgan_tpu/ops/norm.py``: the conditional
batch-norm of the CIFAR and PGGAN generators (``cond_batchnorm``), the
``batch_norm`` with moving statistics (:class:`BatchNorm`) of the MNIST
stack and of the PGGAN critic, and PGGAN's ``pixel_norm``.

``cond_batchnorm``:

Batch statistics always, even when sampling, and no running statistics:
that is the reference's semantics (``normalization.py:47-58``), and an
``nn.BatchNorm2d`` in eval mode would diverge from it.  Per-class
``scale``/``offset`` come from ``[n_labels, C]`` tables.  The computation
is the hand-written kernel's
(:func:`rcgan_tpu_torch.ops.kernels.norm_kernel.cond_batchnorm`).
``layer_norm`` is not ported yet.
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


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """PGGAN's pixelwise feature normalization over the channels of NHWC
    ``x``, computed in float32 and cast back to ``x.dtype``."""
    x32 = x.float()
    alpha = torch.rsqrt(torch.mean(x32 * x32, dim=3, keepdim=True) + eps)
    return (x32 * alpha).to(x.dtype)


class CondBatchNorm(Scoped):
    """Per-class affine tables ``offset`` (zeros) and ``scale`` (ones),
    ``[n_labels, C]``."""

    def __init__(self, n_labels: int, channels: int, scope: str, seed: int = 0):
        super().__init__(scope, seed)
        self.add_param("offset", (n_labels, channels), inits.zeros)
        self.add_param("scale", (n_labels, channels), inits.ones)

    def forward(self, x: torch.Tensor, labels: torch.Tensor, relu: bool = False) -> torch.Tensor:
        return cond_batchnorm(x, labels, self.scale, self.offset, relu=relu)


class BatchNorm(Scoped):
    """JAX ``batch_norm``: BN over every axis but the last, with ``gamma``
    (ones) and ``beta`` (zeros), and the moving statistics as float32
    buffers (state), ``moving_mean`` (zeros) and ``moving_variance`` (ones).

    In train mode the moments are the batch's, in float32, and the buffers
    move by ``decay``: ``m <- decay m + (1 - decay) batch``, with the
    *biased* batch variance, as JAX writes it (``F.batch_norm``'s running
    variance is the unbiased one).  Each call rebinds the buffers, never
    writes them in place, so calls chain: the next call reads what this one
    wrote, as ``Ctx.stat`` chains them in JAX.  In eval mode the buffers
    are read and left alone.  ``zero_debias`` is TF's
    ``zero_debias_moving_mean``: the moving mean is a biased accumulator
    (``biased_mean``) over ``1 - decay^t`` with ``t`` its update count
    (``local_step``).  The output is in ``x``'s dtype."""

    def __init__(self, channels: int, scope: str, decay: float = 0.9, epsilon: float = 1e-5,
                 zero_debias: bool = False, seed: int = 0):
        super().__init__(scope, seed)
        self.decay, self.epsilon, self.zero_debias = decay, epsilon, zero_debias
        self.add_param("gamma", (channels,), inits.ones)
        self.add_param("beta", (channels,), inits.zeros)
        self.add_stat("moving_mean", (channels,), inits.zeros)
        self.add_stat("moving_variance", (channels,), inits.ones)
        if zero_debias:
            self.add_stat("biased_mean", (channels,), inits.zeros)
            self.add_stat("local_step", (1,), inits.zeros)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        axes = tuple(range(x.dim() - 1))
        x32 = x.float()
        if train:
            mean = x32.mean(dim=axes, keepdim=True)
            var = torch.square(x32 - mean).mean(dim=axes, keepdim=True)
            self._update(mean.detach().reshape(-1), var.detach().reshape(-1))
        else:
            mean, var = self.moving_mean, self.moving_variance
        inv = torch.rsqrt(var + self.epsilon) * self.gamma
        return ((x32 - mean) * inv + self.beta).to(x.dtype)

    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        d = self.decay
        if self.zero_debias:
            self.biased_mean = d * self.biased_mean + (1.0 - d) * mean
            self.local_step = self.local_step + 1.0
            debias = 1.0 - torch.pow(torch.tensor(d, dtype=torch.float32), self.local_step[0])
            self.moving_mean = self.biased_mean / torch.clamp(debias, min=1e-12)
        else:
            self.moving_mean = d * self.moving_mean + (1.0 - d) * mean
        self.moving_variance = d * self.moving_variance + (1.0 - d) * var
