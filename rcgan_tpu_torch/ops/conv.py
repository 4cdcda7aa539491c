"""Convolutions (NHWC activations, HWIO filters), ported from
``rcgan_tpu/ops/conv.py``: ``_conv``, ``conv2d_lib`` with
``conv_type="conv2d"`` and optional spectral norm, ``mean_pool``,
``upsample_depth_to_space``, and the MNIST stack's DCGAN ops ``conv2d``
(5x5, stride 2, optional spectral norm), ``deconv2d``,
``conv_cond_concat`` and ``lrelu``.

Every 3x3 / stride 1 / SAME call goes to
:func:`rcgan_tpu_torch.ops.kernels.conv_kernel.conv3x3`, which routes it by
shape (the hand-written kernels for C and O multiples of 64, cuDNN for the
3-channel convs).  The other shapes (the 1x1 shortcut convs, the DCGAN's
5x5 convs at stride 2, the MNIST eval classifier's 5x5 at stride 1) stay
with ``F.conv2d`` and ``F.conv_transpose2d`` on permuted views, as the JAX
package leaves them to XLA.  SAME padding is TensorFlow's: ``total =
max((out - 1) * stride + k - in, 0)`` with ``total // 2`` before and the
rest after, which is asymmetric for a 5x5 conv at stride 2 on 28, 14 and 4
(one before, two after).  ``deconv2d`` is the transpose of such a conv:
padded by the forward conv's leading pad, then cropped to ``stride`` times
the input.
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


def same_padding(size: int, k: int, stride: int):
    """TensorFlow's SAME padding ``(before, after)`` of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME conv: ``x [B,H,W,C]`` (*) ``w [kh,kw,C,O]`` at ``stride`` →
    ``[B,ceil(H/stride),ceil(W/stride),O]``."""
    kh, kw = w.shape[:2]
    if (kh, kw, stride) == (3, 3, 1):
        return conv3x3(x.contiguous(), w.contiguous())
    (ht, hb), (wl, wr) = same_padding(x.shape[1], kh, stride), same_padding(x.shape[2], kw, stride)
    xc = x.permute(0, 3, 1, 2)
    if (ht, wl) == (hb, wr):
        pad = (ht, wl)
    else:  # TF's asymmetric SAME: pad first, then an unpadded conv
        xc, pad = F.pad(xc, (wl, wr, ht, hb)), (0, 0)
    out = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=pad)
    return out.permute(0, 2, 3, 1).contiguous()


def conv_transpose_same(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """TF's SAME ``conv2d_transpose`` (JAX ``conv_transpose`` with
    ``transpose_kernel=True``): ``x [B,H,W,C]``, ``w [k,k,O,C]`` →
    ``[B,stride*H,stride*W,O]``, the adjoint of a SAME conv from that size
    back to ``[H, W]``."""
    kh, kw = w.shape[:2]
    h, wd = x.shape[1:3]
    # the forward conv's leading pads; F.conv_transpose2d pads symmetrically,
    # so the trailing side is cropped (or, for k < stride, filled) below
    ph, pw = max(kh - stride, 0) // 2, max(kw - stride, 0) // 2
    extra = (max(h * stride - ((h - 1) * stride + kh - 2 * ph), 0),
             max(wd * stride - ((wd - 1) * stride + kw - 2 * pw), 0))
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride,
                             padding=(ph, pw), output_padding=extra)
    return out[:, :, :h * stride, :wd * stride].permute(0, 2, 3, 1).contiguous()


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


class Conv2d(Scoped):
    """DCGAN conv (JAX ``conv2d``): ``k x k`` at ``stride``, TF SAME,
    truncated-normal(``stddev``) HWIO ``w``, optionally spectral-normed
    (with its ``u`` buffer), zero ``biases``."""

    def __init__(self, input_dim: int, output_dim: int, scope: str, k: int = 5,
                 stride: int = 2, stddev: float = 0.02, spectral_norm: bool = False,
                 seed: int = 0):
        super().__init__(scope, seed)
        self.stride = stride
        self.add_param("w", (k, k, input_dim, output_dim), inits.truncated_normal(stddev))
        self.spectral_normed = spectral_norm
        if spectral_norm:
            add_sn_state(self, output_dim, "w")
        self.add_param("biases", (output_dim,), inits.zeros)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.w
        if self.spectral_normed:
            w = spectral_normed_weight(self, w)
        out = _conv(x.to(self.compute_dtype), w.to(self.compute_dtype), self.stride)
        return out + self.biases.to(out.dtype)


class Deconv2d(Scoped):
    """DCGAN ``conv2d_transpose`` (JAX ``deconv2d``): SAME, ``stride`` 2,
    normal(``stddev``) ``w`` in TF's layout ``[k, k, cout, cin]``, zero
    ``biases``."""

    def __init__(self, input_dim: int, output_dim: int, scope: str, k: int = 5,
                 stride: int = 2, stddev: float = 0.02, seed: int = 0):
        super().__init__(scope, seed)
        self.stride = stride
        self.add_param("w", (k, k, output_dim, input_dim), inits.normal(stddev))
        self.add_param("biases", (output_dim,), inits.zeros)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv_transpose_same(x.to(self.compute_dtype), self.w.to(self.compute_dtype),
                                  self.stride)
        return out + self.biases.to(out.dtype)


def conv_cond_concat(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``y`` (``[B, y_dim]`` or ``[B, 1, 1, y_dim]``) broadcast over every
    spatial position of NHWC ``x`` and concatenated on the channels, in
    ``x``'s dtype (JAX ``conv_cond_concat``)."""
    if y.dim() == 2:
        y = y[:, None, None, :]
    b, h, w, _ = x.shape
    return torch.cat([x, y.expand(b, h, w, y.shape[-1]).to(x.dtype)], dim=3)


def lrelu(x: torch.Tensor, leak: float = 0.2) -> torch.Tensor:
    return torch.maximum(x, leak * x)
