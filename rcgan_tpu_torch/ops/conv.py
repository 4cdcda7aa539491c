"""Convolutions (NHWC activations, HWIO filters), ported from
``rcgan_tpu/ops/conv.py``: ``_conv``, ``conv2d_lib`` (:class:`Conv2dLib`:
``conv_type`` "conv2d", "depthwise_conv2d" and "separable_conv2d", any
stride, SAME or VALID padding, optional spectral norm, weight norm and
PixelCNN masks), ``conv1d_lib`` (:class:`Conv1dLib`, with its causal mask),
and the MNIST stack's DCGAN ops ``conv2d`` (5x5, stride 2, optional
spectral norm), ``deconv2d``, ``conv_cond_concat`` and ``lrelu``.
``mean_pool`` and ``upsample_depth_to_space`` live beside their CUDA
kernels (``ops/kernels/resample_kernel.py``) and are imported here, where
the models find them.

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
and the bias to the conv's output dtype, as in JAX.  A depthwise filter
``[k, k, C, M]`` is applied as JAX applies it: transposed to ``[k, k, M,
C]``, reshaped to ``[k, k, 1, M*C]`` and run with C groups, so that output
channel ``m*C + c`` belongs to group ``(m*C + c) // M``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from rcgan_tpu_torch.core import initializers as inits
from rcgan_tpu_torch.core.module import Scoped
from rcgan_tpu_torch.ops.kernels import runtime
from rcgan_tpu_torch.ops.kernels.conv_kernel import conv3x3
from rcgan_tpu_torch.ops.kernels.resample_kernel import (  # noqa: F401  (the models' import)
    mean_pool, upsample_depth_to_space)
from rcgan_tpu_torch.ops.sn import add_sn_state, spectral_normed_weight


def same_padding(size: int, k: int, stride: int):
    """TensorFlow's SAME padding ``(before, after)`` of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pads(sizes, kernel, stride: int, padding: str):
    """``[(before, after), ...]`` per spatial dim: TF's SAME, or none for
    VALID."""
    if padding == "VALID":
        return [(0, 0)] * len(sizes)
    if padding != "SAME":
        raise ValueError(f"padding must be SAME or VALID; got {padding!r}")
    return [same_padding(n, k, stride) for n, k in zip(sizes, kernel)]


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: str = "SAME",
          groups: int = 1) -> torch.Tensor:
    """Conv of ``x [B,H,W,C]`` with ``w [kh,kw,C/groups,O]`` at ``stride``
    (TF's SAME, or VALID) → ``[B,H',W',O]``.  3x3, stride 1, SAME, ungrouped
    calls go to :func:`conv3x3`; the rest to ``F.conv2d``, on DTensors on
    each rank's rows (``runtime.rows_local``)."""
    kh, kw = w.shape[:2]
    if (kh, kw, stride, padding, groups) == (3, 3, 1, "SAME", 1):
        return conv3x3(x.contiguous(), w.contiguous())
    return runtime.rows_local(lambda x_, w_: _conv2d(x_, w_, stride, padding, groups), x, w)


def _conv2d(x: torch.Tensor, w: torch.Tensor, stride: int, padding: str,
            groups: int) -> torch.Tensor:
    """:func:`_conv` by ``F.conv2d`` on NCHW views."""
    kh, kw = w.shape[:2]
    (ht, hb), (wl, wr) = _pads(x.shape[1:3], (kh, kw), stride, padding)
    xc = x.permute(0, 3, 1, 2)
    if (ht, wl) == (hb, wr):
        pad = (ht, wl)
    else:  # TF's asymmetric SAME: pad first, then an unpadded conv
        xc, pad = F.pad(xc, (wl, wr, ht, hb)), (0, 0)
    out = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=pad, groups=groups)
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


def pixelcnn_mask(mask_type, filter_size: int, input_dim: int, output_dim: int,
                  spatial_dims: int = 2) -> np.ndarray:
    """PixelCNN causal mask (``conv2d.py:63-81``, ``conv1d.py``), float32 in
    the filter's shape: taps after the centre are cut, and at the centre
    ``mask_type = ("a" | "b", n)`` cuts input group i to output group j
    where i >= j ("a") or i > j ("b"), groups interleaved with stride n."""
    kind, n = mask_type
    shape = (filter_size,) * spatial_dims + (input_dim, output_dim)
    mask = np.ones(shape, np.float32)
    c = filter_size // 2
    mask[c + 1:] = 0.0
    centre = (c,) * spatial_dims
    if spatial_dims == 2:
        mask[c, c + 1:] = 0.0
    for i in range(n):
        for j in range(n):
            if (kind == "a" and i >= j) or (kind == "b" and i > j):
                mask[centre + (slice(i, None, n), slice(j, None, n))] = 0.0
    return mask


def weight_normed(w: torch.Tensor, g: torch.Tensor, dims) -> torch.Tensor:
    """``W * g / ||W||``, the norm over ``dims`` per output channel
    (``conv2d.py:152-162``, ``linear.py:143-155``)."""
    return w * (g / torch.sqrt(torch.sum(torch.square(w), dim=dims)))


def add_weight_norm(layer: Scoped, weight: str, dims) -> None:
    """The trainable per-output-channel ``g`` of ``layer.<weight>``,
    initialised to the norms of the weight's initial value over ``dims``,
    so that the layer starts as it would without weight norm."""
    w = getattr(layer, weight).detach()
    layer.add_param("g", (w.shape[-1],),
                    lambda gen, shape, dtype: torch.sqrt(torch.sum(torch.square(w), dim=dims))
                    .to(dtype))


class _SNState(Scoped):
    """The spectral-norm ``u`` of one filter of a depthwise or separable
    conv, under JAX's scope for it (``<name>.dw``, ``<name>.pw``)."""

    def __init__(self, scope: str, cout: int, seed: int):
        super().__init__(scope, seed)
        self.add_stat("u", (1, cout), inits.truncated_normal(1.0))


class Conv2dLib(Scoped):
    """GAN_Lib Conv2D (JAX ``conv2d_lib``): he/Glorot-uniform filters,
    ``Biases`` added after the conv when ``biases``.

    - ``conv_type="conv2d"``: HWIO ``Filters``, through weight norm
      (``weightnorm``: ``g``), then the PixelCNN mask (``mask_type``), then
      spectral norm (its ``u``), the reference's order;
    - ``"depthwise_conv2d"``: ``depthwise_filters [k, k, C, M]``, output
      ``C * M`` channels (``output_dim`` is not read);
    - ``"separable_conv2d"``: the depthwise conv, then a 1x1 conv by
      ``pointwise_filters [1, 1, C * M, output_dim]``.

    With ``spectral_normed`` the depthwise and pointwise filters each have
    their own ``u`` under the scopes ``<scope>.dw`` and ``<scope>.pw``, as in
    JAX."""

    def __init__(self, input_dim: int, output_dim: int, filter_size: int, scope: str,
                 he_init: bool = True, biases: bool = True, gain: float = 1.0,
                 seed: int = 0, spectral_normed: bool = False, stride: int = 1,
                 padding: str = "SAME", conv_type: str = "conv2d", channel_multiplier: int = 0,
                 mask_type=None, weightnorm: bool = False):
        super().__init__(scope, seed)
        init = inits.conv_uniform(stride=stride, he=he_init, gain=gain)
        self.stride, self.padding, self.conv_type = stride, padding, conv_type
        self.spectral_normed = spectral_normed and conv_type == "conv2d"
        self.weightnorm = weightnorm and conv_type == "conv2d"
        self.mask = None
        k = filter_size
        if conv_type == "conv2d":
            self.add_param("Filters", (k, k, input_dim, output_dim), init)
            if self.weightnorm:
                add_weight_norm(self, "Filters", (0, 1, 2))
            if mask_type is not None:  # a constant, not state: kept out of the trees
                self.mask = torch.from_numpy(pixelcnn_mask(mask_type, k, input_dim, output_dim))
            if self.spectral_normed:
                add_sn_state(self, output_dim, "Filters")
        elif conv_type in ("depthwise_conv2d", "separable_conv2d"):
            if channel_multiplier <= 0:
                raise ValueError(f"{conv_type} needs channel_multiplier > 0")
            self.add_param("depthwise_filters", (k, k, input_dim, channel_multiplier), init)
            self.sn_dw = _SNState(scope + ".dw", channel_multiplier, seed) \
                if spectral_normed else None
            self.sn_pw = None
            if conv_type == "separable_conv2d":
                self.add_param("pointwise_filters",
                               (1, 1, input_dim * channel_multiplier, output_dim), init)
                if spectral_normed:
                    self.sn_pw = _SNState(scope + ".pw", output_dim, seed)
            else:
                output_dim = input_dim * channel_multiplier
        else:
            raise NotImplementedError(conv_type)
        if biases:
            self.add_param("Biases", (output_dim,), inits.zeros)
        else:
            self.register_parameter("Biases", None)

    def _depthwise(self, x: torch.Tensor) -> torch.Tensor:
        dw = self.depthwise_filters
        if self.sn_dw is not None:
            dw = spectral_normed_weight(self.sn_dw, dw)
        k, _, cin, mult = dw.shape
        w = dw.permute(0, 1, 3, 2).reshape(k, k, 1, cin * mult)
        return _conv(x.to(self.compute_dtype), w.to(self.compute_dtype), self.stride,
                     self.padding, groups=cin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv_type == "conv2d":
            w = self.Filters
            if self.weightnorm:
                w = weight_normed(w, self.g, (0, 1, 2))
            if self.mask is not None:
                w = w * self.mask.to(w.device)
            if self.spectral_normed:
                w = spectral_normed_weight(self, w)
            out = _conv(x.to(self.compute_dtype), w.to(self.compute_dtype), self.stride,
                        self.padding)
        else:
            out = self._depthwise(x)
            if self.conv_type == "separable_conv2d":
                pw = self.pointwise_filters
                if self.sn_pw is not None:
                    pw = spectral_normed_weight(self.sn_pw, pw)
                out = _conv(out, pw.to(self.compute_dtype), 1, "SAME")
        if self.Biases is not None:
            out = out + self.Biases.to(out.dtype)
        return out


class Conv1dLib(Scoped):
    """GAN_Lib Conv1D (JAX ``conv1d_lib``): ``x [B, W, C]``, ``Filters [k,
    C, O]`` (he/Glorot uniform, drawn as a ``[1, k, C, O]`` conv filter),
    optional PixelCNN causal mask and spectral norm, TF's SAME or VALID
    padding at ``stride``, optional ``Biases``."""

    def __init__(self, input_dim: int, output_dim: int, filter_size: int, scope: str,
                 stride: int = 1, padding: str = "SAME", mask_type=None,
                 spectral_normed: bool = False, he_init: bool = True, biases: bool = True,
                 gain: float = 1.0, seed: int = 0):
        super().__init__(scope, seed)
        init = inits.conv_uniform(stride=stride, he=he_init, gain=gain)
        self.stride, self.padding = stride, padding
        self.add_param("Filters", (filter_size, input_dim, output_dim),
                       lambda gen, shape, dtype: init(gen, (1, *shape), dtype)[0])
        self.mask = None
        if mask_type is not None:  # a constant, not state: kept out of the trees
            self.mask = torch.from_numpy(
                pixelcnn_mask(mask_type, filter_size, input_dim, output_dim, spatial_dims=1))
        self.spectral_normed = spectral_normed
        if spectral_normed:
            add_sn_state(self, output_dim, "Filters")
        if biases:
            self.add_param("Biases", (output_dim,), inits.zeros)
        else:
            self.register_parameter("Biases", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.Filters
        if self.mask is not None:
            w = w * self.mask.to(w.device)
        if self.spectral_normed:
            w = spectral_normed_weight(self, w)
        ((left, right),) = _pads(x.shape[1:2], w.shape[:1], self.stride, self.padding)
        xc = F.pad(x.to(self.compute_dtype).permute(0, 2, 1), (left, right))
        out = F.conv1d(xc, w.to(self.compute_dtype).permute(2, 1, 0), stride=self.stride)
        out = out.permute(0, 2, 1)
        if self.Biases is not None:
            out = out + self.Biases.to(out.dtype)
        return out


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
