"""MNIST conditional DCGAN, ported from ``rcgan_tpu/models/dcgan.py``
(reference: ``mnist/model.py:644-768``).

- :class:`Generator`: ``z‖y`` → FC(gfc) + BN → FC(gf·2·7·7) + BN → deconv
  14x14 + BN → deconv 28x28 → sigmoid, with the one-hot label concatenated
  at every stage.  ``train=False`` is the reference's ``gen_sampler``: BN
  reads its moving statistics and leaves them alone.
- :class:`Discriminator`: ``projection`` (four strided 5x5 convs,
  spectral-normed by default, BN and lrelu, a global mean pool, and the
  projection logit ``h4 + Σ h3·linear(y)`` with max-norm linears and the
  optional one-hot concatenation at ``concat_y_layers``) or ``vanilla``
  (the conv-cond-concat DCGAN head, no spectral norm).
  :meth:`Discriminator.all_labels` is JAX's ``discriminator_all_labels``.
- :class:`Classifier`: the permutation regularizer's linear classifier,
  ``d_classifier_h1``, which trains with D.

Activations are NHWC and the layers keep the JAX scope and variable names
(``g_h0_lin/Matrix``, ``d_bn1/moving_mean``, ``d_h0_conv/u``), so the JAX
trees load by name (``rcgan_tpu_torch/bridge.py``).  The BN moving
statistics and the spectral-norm ``u`` are buffers that each call rebinds
(``ops/norm.py``, ``ops/sn.py``): calls chain as JAX chains them through
``Ctx.stat``.  Every layer casts to its ``compute_dtype`` at a conv or
matmul; parameters and state stay float32.

A projection D pass normalizes its spectral-normed convs as one group
(``ops/sn.py::prepare_spectral_norms``): one launch of the sn kernel on the
card.  A D evaluated per label (vanilla, or ``concat_y``) runs one pass,
hence one group, per label, each from the ``u`` the previous one wrote.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rcgan_tpu_torch.ops.conv import Conv2d, Deconv2d, conv_cond_concat, lrelu
from rcgan_tpu_torch.ops.linear import Linear
from rcgan_tpu_torch.ops.norm import BatchNorm
from rcgan_tpu_torch.ops.sn import clear_prepared, prepare_spectral_norms, sn_layers


@dataclasses.dataclass(frozen=True)
class DCGANConfig:
    batch_size: int = 100
    output_height: int = 28
    output_width: int = 28
    c_dim: int = 1
    y_dim: int = 10
    z_dim: int = 100
    gf_dim: int = 64
    df_dim: int = 64
    gfc_dim: int = 1024
    dfc_dim: int = 1024
    disc_type: str = "vanilla"  # vanilla | projection
    spectral_norm: bool = True
    max_norm: bool = True
    concat_y: bool = False
    concat_y_layers: Sequence[int] = (1,)


class Generator(nn.Module):
    """JAX ``generator``: ``z [B, z_dim]``, one-hot ``y [B, y_dim]`` →
    images ``[B, H, W, c_dim]`` in (0, 1), in the compute dtype."""

    def __init__(self, cfg: DCGANConfig = DCGANConfig(), seed: int = 0):
        super().__init__()
        self.cfg = cfg
        y, gf = cfg.y_dim, cfg.gf_dim
        s_h4, s_w4 = cfg.output_height // 4, cfg.output_width // 4
        self.h0 = Linear(cfg.z_dim + y, cfg.gfc_dim, "g_h0_lin", seed=seed)
        self.bn0 = BatchNorm(cfg.gfc_dim, "g_bn0", seed=seed)
        self.h1 = Linear(cfg.gfc_dim + y, gf * 2 * s_h4 * s_w4, "g_h1_lin", seed=seed)
        self.bn1 = BatchNorm(gf * 2 * s_h4 * s_w4, "g_bn1", seed=seed)
        self.h2 = Deconv2d(gf * 2 + y, gf * 2, "g_h2", seed=seed)
        self.bn2 = BatchNorm(gf * 2, "g_bn2", seed=seed)
        self.h3 = Deconv2d(gf * 2 + y, cfg.c_dim, "g_h3", seed=seed)

    def forward(self, z: torch.Tensor, y: torch.Tensor, train: bool = True) -> torch.Tensor:
        cfg = self.cfg
        b = z.shape[0]
        yb = y.reshape(b, 1, 1, cfg.y_dim)
        h0 = F.relu(self.bn0(self.h0(torch.cat([z, y], dim=1)), train))
        h0 = torch.cat([h0, y], dim=1)  # promotes, as jnp.concatenate
        h1 = F.relu(self.bn1(self.h1(h0), train))
        h1 = h1.reshape(b, cfg.output_height // 4, cfg.output_width // 4, cfg.gf_dim * 2)
        h1 = conv_cond_concat(h1, yb)
        h2 = F.relu(self.bn2(self.h2(h1), train))
        h2 = conv_cond_concat(h2, yb)
        return torch.sigmoid(self.h3(h2))


class Discriminator(nn.Module):
    """JAX ``discriminator`` (``projection`` or ``vanilla``, by
    ``cfg.disc_type``): ``(image [B, H, W, c_dim], one-hot y [B, y_dim])`` →
    ``(sigmoid(logits), logits [B, 1])``."""

    def __init__(self, cfg: DCGANConfig = DCGANConfig(), seed: int = 0):
        super().__init__()
        self.cfg = cfg
        y, df = cfg.y_dim, cfg.df_dim
        kw = dict(seed=seed)
        if cfg.disc_type == "projection":
            def cin(layer, c):  # the width with the one-hot concatenated at ``layer``
                return c + y if cfg.concat_y and layer in cfg.concat_y_layers else c

            sn = dict(spectral_norm=cfg.spectral_norm, **kw)
            self.h0 = Conv2d(cin(1, cfg.c_dim), df, "d_h0_conv", **sn)
            self.h1 = Conv2d(cin(2, df), df, "d_h1_conv", **sn)
            self.bn1 = BatchNorm(df, "d_bn1", **kw)
            self.h2 = Conv2d(cin(3, df), df, "d_h2_conv", **sn)
            self.bn2 = BatchNorm(df, "d_bn2", **kw)
            self.h3 = Conv2d(cin(4, df), df, "d_h3_conv", **sn)
            self.bn3 = BatchNorm(df, "d_bn3", **kw)
            self.h4 = Linear(df, 1, "d_h4_lin", max_norm=cfg.max_norm, **kw)
            self.h5 = Linear(y, df, "d_h5_y_lin", max_norm=cfg.max_norm, **kw)
        elif cfg.disc_type == "vanilla":
            s_h4, s_w4 = -(-cfg.output_height // 4), -(-cfg.output_width // 4)
            self.h0 = Conv2d(cfg.c_dim + y, cfg.c_dim + y, "d_h0_conv", **kw)
            self.h1 = Conv2d(cfg.c_dim + 2 * y, df + y, "d_h1_conv", **kw)
            self.bn1 = BatchNorm(df + y, "d_bn1", **kw)
            self.h3 = Linear(s_h4 * s_w4 * (df + y) + y, cfg.dfc_dim, "d_h3_lin", **kw)
            self.bn2 = BatchNorm(cfg.dfc_dim, "d_bn2", **kw)
            self.h4 = Linear(cfg.dfc_dim + y, 1, "d_h4_lin", **kw)
        else:
            raise ValueError(f"unknown disc_type {cfg.disc_type!r}")
        self._sn_layers = sn_layers(self)  # a plain list: the layers are registered above

    def trunk(self, image: torch.Tensor, yb: Optional[torch.Tensor]) -> torch.Tensor:
        """JAX ``_projection_trunk`` → pooled features ``[B, df]``; ``yb``
        None skips the ``concat_y`` injections.  One D pass: its
        spectral-normed convs are normalized as one group first."""
        cfg = self.cfg

        def maybe_concat(h, layer):
            if yb is not None and cfg.concat_y and layer in cfg.concat_y_layers:
                return conv_cond_concat(h, yb)
            return h

        prepare_spectral_norms(self._sn_layers)
        try:
            h0 = lrelu(self.h0(maybe_concat(image, 1)))
            h1 = lrelu(self.bn1(self.h1(maybe_concat(h0, 2))))
            h2 = lrelu(self.bn2(self.h2(maybe_concat(h1, 3))))
            h3 = lrelu(self.bn3(self.h3(maybe_concat(h2, 4))))
        finally:
            clear_prepared(self._sn_layers)
        return h3.mean(dim=(1, 2))

    def forward(self, image: torch.Tensor, y: torch.Tensor):
        cfg = self.cfg
        b = image.shape[0]
        yb = y.reshape(b, 1, 1, cfg.y_dim)
        if cfg.disc_type == "projection":
            h3 = self.trunk(image, yb if cfg.concat_y else None)
            h4 = self.h4(h3.reshape(b, -1))
            h5 = self.h5(y.reshape(b, cfg.y_dim))
            h6 = h4 + torch.sum(h3 * h5, dim=1, keepdim=True)
            return torch.sigmoid(h6), h6
        x = conv_cond_concat(image, yb)
        h0 = conv_cond_concat(lrelu(self.h0(x)), yb)
        h1 = lrelu(self.bn1(self.h1(h0))).reshape(b, -1)
        h1 = torch.cat([h1, y], dim=1)
        h3 = torch.cat([lrelu(self.bn2(self.h3(h1))), y], dim=1)
        h4 = self.h4(h3)
        return torch.sigmoid(h4), h4

    def all_labels(self, image: torch.Tensor) -> torch.Tensor:
        """JAX ``discriminator_all_labels``: logits at every one-hot label,
        ``[B, y_dim]``.  The projection D without ``concat_y`` has a
        label-free trunk and factorises: one trunk pass and the
        ``[y_dim, df]`` label matrix.  Otherwise one D pass per label, as
        the reference's ten towers: BN takes each tower's own batch moments
        and the ``u`` of each spectral norm advances once per tower, in
        order, so the towers are not batched."""
        cfg = self.cfg
        b = image.shape[0]
        eye = torch.eye(cfg.y_dim, dtype=image.dtype, device=image.device)
        if cfg.disc_type == "projection" and not cfg.concat_y:
            h3 = self.trunk(image, None)
            h4 = self.h4(h3)
            h5_all = self.h5(eye)
            return h4 + h3 @ h5_all.T
        cols = [self(image, eye[i].expand(b, cfg.y_dim))[1][:, 0] for i in range(cfg.y_dim)]
        return torch.stack(cols, dim=1)


class Classifier(nn.Module):
    """JAX ``classifier``: the permutation regularizer's one linear layer on
    the flat image, named ``d_classifier_h1`` so that it trains with D."""

    def __init__(self, cfg: DCGANConfig = DCGANConfig(), seed: int = 0):
        super().__init__()
        self.cfg = cfg
        flat = cfg.output_height * cfg.output_width * cfg.c_dim
        self.h1 = Linear(flat, cfg.y_dim, "d_classifier_h1", seed=seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.h1(x.reshape(x.shape[0], -1))


def sample(generator: Generator, z: torch.Tensor, y_onehot: torch.Tensor) -> torch.Tensor:
    """The reference's ``gen_sampler`` (JAX ``MnistTrainer.sample``): the
    generator with BN in inference mode, under ``torch.no_grad``, as
    float32 ``[B, H, W, c_dim]``."""
    with torch.no_grad():
        return generator(z, y_onehot, train=False).float()
