"""Convolutions (NHWC activations, HWIO filters), ported from
``rcgan_tpu/ops/conv.py`` (``_conv``, ``conv2d_lib`` with
``conv_type="conv2d"`` and optional spectral norm, ``mean_pool``,
``upsample_depth_to_space``).

Every 3x3 / stride 1 / SAME call goes to
:func:`rcgan_tpu_torch.ops.kernels.conv_kernel.conv3x3`, which routes it by
shape (the hand-written kernels for C and O multiples of 64, cuDNN for the
3-channel convs).  The other shapes on the ported paths (the 1x1 shortcut
convs) stay with ``F.conv2d`` on permuted views, as the JAX package leaves
them to XLA.
``x`` and the filter are cast to the layer's ``compute_dtype`` at the conv,
and the bias to the conv's output dtype, as in JAX.  Weight norm, PixelCNN
masks and the depthwise/separable variants are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rcgan_tpu_torch.core import initializers as inits
from rcgan_tpu_torch.core.module import Scoped
from rcgan_tpu_torch.ops.kernels.conv_kernel import conv3x3
from rcgan_tpu_torch.ops.sn import add_sn_state, spectral_normed_weight


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride 1, SAME: ``x [B,H,W,C]`` (*) ``w [k,k,C,O]`` → ``[B,H,W,O]``."""
    kh, kw = w.shape[:2]
    if (kh, kw) == (3, 3):
        return conv3x3(x.contiguous(), w.contiguous())
    if kh % 2 == 0 or kw % 2 == 0:
        # TF pads even kernels asymmetrically; no caller of this slice has one
        raise NotImplementedError("SAME padding is ported for odd kernels only")
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=(kh // 2, kw // 2))
    return out.permute(0, 2, 3, 1).contiguous()


class Conv2dLib(Scoped):
    """GAN_Lib Conv2D (``conv_type="conv2d"``, stride 1, SAME padding — the
    only form any ``conv2d_lib`` caller uses): he/Glorot-uniform HWIO
    ``Filters``, optionally spectral-normed (with its ``u`` buffer), and an
    optional ``Biases`` added after the conv."""

    def __init__(self, input_dim: int, output_dim: int, filter_size: int, scope: str,
                 he_init: bool = True, biases: bool = True, gain: float = 1.0,
                 seed: int = 0, spectral_normed: bool = False):
        super().__init__(scope, seed)
        self.add_param("Filters", (filter_size, filter_size, input_dim, output_dim),
                       inits.conv_uniform(he=he_init, gain=gain))
        self.spectral_normed = spectral_normed
        if spectral_normed:
            add_sn_state(self, output_dim, "Filters")
        if biases:
            self.add_param("Biases", (output_dim,), inits.zeros)
        else:
            self.register_parameter("Biases", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.Filters
        if self.spectral_normed:
            w = spectral_normed_weight(self, w)
        out = _conv(x.to(self.compute_dtype), w.to(self.compute_dtype))
        if self.Biases is not None:
            out = out + self.Biases.to(out.dtype)
        return out


def mean_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool of NHWC ``x`` by the reference's 4-phase slicing
    (JAX ``ops/conv.py::mean_pool``), summed in the same order."""
    return (x[:, ::2, ::2, :] + x[:, 1::2, ::2, :] + x[:, ::2, 1::2, :]
            + x[:, 1::2, 1::2, :]) / 4.0


def upsample_depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of NHWC ``x``: channel-concat x4 then
    depth_to_space, exactly as the JAX function writes it.  (``F.pixel_shuffle``
    on NCHW groups channels as ``c*4+k`` and would mix channels.)"""
    b, h, w, c = x.shape
    y = torch.cat([x, x, x, x], dim=3)
    y = y.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, h * 2, w * 2, c)
