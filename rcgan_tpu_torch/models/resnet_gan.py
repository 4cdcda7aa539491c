"""CIFAR-10 SNGAN, ported from ``rcgan_tpu/models/resnet_gan.py``.

- The generator: the ResNet with conditional batch-norm (``generator``,
  ``residual_block`` with ``resample`` "up" or None, ``upsample_conv``,
  ``normalize``'s cond-BN branch).
- The discriminator: the spectral-normed ResNet (``discriminator``,
  ``optimized_resblock_disc1``, ``residual_block`` "down" and None,
  ``conv_mean_pool``, ``mean_pool_conv``) that returns features and the
  wgan logit; its projection head (``discriminator_projection``,
  ``projection_logits``, ``all_label_logits`` through the projection
  kernel); and the permutation-regularizer classifier (``perm_classifier``).

Activations are NHWC and parameters keep the JAX layouts and scope names
(``rcgan_tpu_torch/core/module.py``), so the JAX parameter and state trees
load by name (``rcgan_tpu_torch/bridge.py``).  Every layer casts to its
``compute_dtype`` at a conv or matmul (``set_compute_dtype``); parameters
and SN state stay float32.

``normalize``'s routes: ``layer_norm`` for a ``D.`` scope with
``normalization_d`` (off in ``ResnetGANConfig()``), cond-BN, or the
zero-debiased ``batch_norm`` where a ``G.`` scope sees no labels (an
unconditional generator, and the PGGAN critic, whose ``PG.D.*`` scopes hold
``G.``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rcgan_tpu_torch.core.module import sn_updates
from rcgan_tpu_torch.ops.conv import Conv2dLib, mean_pool, upsample_depth_to_space
from rcgan_tpu_torch.ops.kernels.projection_kernel import all_label_projection_logits
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device
from rcgan_tpu_torch.ops.linear import Embedding, LinearLib
from rcgan_tpu_torch.ops.norm import BatchNorm, CondBatchNorm, LayerNorm
from rcgan_tpu_torch.ops.sn import clear_prepared, prepare_spectral_norms, sn_layers


@dataclasses.dataclass(frozen=True)
class ResnetGANConfig:
    img_size: int = 32
    img_dim: int = 3
    z_dim: int = 128
    dim_g: int = 128
    dim_d: int = 128
    vocab_size: int = 10
    embedding_dim: int = 300
    normalization_g: bool = True
    normalization_d: bool = False
    conditional: bool = True
    acgan: bool = False
    algorithm: str = "rcgan"  # biased | unbiased | rcgan | rcgan-u
    perm_type: str = "linear"  # linear | 2layer
    nonlinearity: str = "relu"

    @property
    def output_dim(self) -> int:
        return self.img_size * self.img_size * self.img_dim


def nonlinearity(x: torch.Tensor, kind: str = "relu", leakiness: float = 0.2) -> torch.Tensor:
    if kind == "relu":
        return F.relu(x)
    if kind == "lrelu":
        return torch.maximum(x, leakiness * x)
    raise ValueError(kind)


class Normalize(nn.Module):
    """The layer that JAX's ``normalize(ctx, cfg, name, x, labels)`` routes
    scope ``name`` to.  JAX decides at call time, by whether labels reach
    it; the port decides at construction, so the caller says whether the
    layer will be called with labels (``labeled``):

    - a ``D.`` scope with ``normalization_d``: :class:`LayerNorm` (``ln``),
      whether or not labels reach it, as JAX checks it first;
    - a ``G.`` scope with ``normalization_g``: conditional BN (``cbn``)
      where labels reach it (``labeled``, a conditional config, and not an
      acgan ``D.`` scope), else the zero-debiased :class:`BatchNorm`
      (``bn``), which runs in train mode while the module is in training
      mode (JAX's ``ctx.train``);
    - identity where normalization is off (the CIFAR discriminator in
      ``ResnetGANConfig()``)."""

    def __init__(self, cfg: ResnetGANConfig, name: str, channels: int, seed: int = 0,
                 labeled: bool = True):
        super().__init__()
        self.cbn: Optional[CondBatchNorm] = None
        self.bn: Optional[BatchNorm] = None
        self.ln: Optional[LayerNorm] = None
        if "D." in name and cfg.normalization_d:
            self.ln = LayerNorm(channels, name, seed=seed)
        elif "G." in name and cfg.normalization_g:
            labeled = labeled and cfg.conditional and not (cfg.acgan and "D." in name)
            if labeled:
                self.cbn = CondBatchNorm(cfg.vocab_size, channels, name, seed)
            else:
                self.bn = BatchNorm(channels, name, zero_debias=True, seed=seed)

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor]) -> torch.Tensor:
        if self.ln is not None:
            return self.ln(x)
        if self.cbn is not None:
            return self.cbn(x, labels)
        if self.bn is not None:
            return self.bn(x, self.training)
        return x

    def activated(self, x: torch.Tensor, labels: Optional[torch.Tensor],
                  kind: str) -> torch.Tensor:
        """``nonlinearity(self(x, labels), kind)``; a ReLU after a cond-BN
        runs inside the cond-BN kernel (XLA fuses it on the JAX side)."""
        if self.cbn is not None and kind == "relu":
            return self.cbn(x, labels, relu=True)
        return nonlinearity(self(x, labels), kind)


def upsample_conv(conv: Conv2dLib, x: torch.Tensor) -> torch.Tensor:
    return conv(upsample_depth_to_space(x))


def conv_mean_pool(conv: Conv2dLib, x: torch.Tensor) -> torch.Tensor:
    return mean_pool(conv(x))


def mean_pool_conv(conv: Conv2dLib, x: torch.Tensor) -> torch.Tensor:
    return conv(mean_pool(x))


class ResidualBlock(nn.Module):
    """(norm → relu → conv) x2 + shortcut, with "up", "down" or no
    resampling (JAX ``residual_block``).  ``labeled``: whether the block is
    called with labels, which picks its normalization (:class:`Normalize`)."""

    def __init__(self, cfg: ResnetGANConfig, input_dim: int, output_dim: int,
                 filter_size: int, name: str, resample: Optional[str] = None,
                 seed: int = 0, spectral_normed: bool = False, labeled: bool = True):
        super().__init__()
        if resample not in ("up", "down", None):
            raise ValueError(f"invalid resample {resample!r}")
        self.cfg = cfg
        self.resample = resample
        sn = dict(seed=seed, spectral_normed=spectral_normed)
        # "down" keeps the width through Conv1 and changes it in Conv2
        mid = input_dim if resample == "down" else output_dim
        self.shortcut = None
        if not (output_dim == input_dim and resample is None):
            self.shortcut = Conv2dLib(input_dim, output_dim, 1, name + ".Shortcut",
                                      he_init=False, **sn)
        self.n1 = Normalize(cfg, name + ".N1", input_dim, seed, labeled)
        self.conv1 = Conv2dLib(input_dim, mid, filter_size, name + ".Conv1", **sn)
        self.n2 = Normalize(cfg, name + ".N2", mid, seed, labeled)
        self.conv2 = Conv2dLib(mid, output_dim, filter_size, name + ".Conv2", **sn)

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor]) -> torch.Tensor:
        up, down = self.resample == "up", self.resample == "down"
        if self.shortcut is None:
            shortcut = x
        elif up:
            shortcut = upsample_conv(self.shortcut, x)
        elif down:
            shortcut = conv_mean_pool(self.shortcut, x)
        else:
            shortcut = self.shortcut(x)
        out = self.n1.activated(x, labels, self.cfg.nonlinearity)
        out = upsample_conv(self.conv1, out) if up else self.conv1(out)
        out = self.n2.activated(out, labels, self.cfg.nonlinearity)
        out = conv_mean_pool(self.conv2, out) if down else self.conv2(out)
        return shortcut + out


class Generator(nn.Module):
    """JAX ``generator``: z ``[B, z_dim]``, labels int ``[B]`` → flat image
    ``[B, output_dim]`` in [-1, 1].  Parameters are drawn from ``seed``
    (``rcgan_tpu_torch/core/initializers.py``) and placed on ``device``; a
    CUDA device that is absent raises."""

    def __init__(self, cfg: ResnetGANConfig = ResnetGANConfig(), seed: int = 0,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        g = cfg.dim_g
        self.input = LinearLib(cfg.z_dim, 4 * 4 * g * 8, "G.Input", seed=seed)
        self.block1 = ResidualBlock(cfg, g * 8, g * 2, 3, "G.Block.1", "up", seed)
        self.block2 = ResidualBlock(cfg, g * 2, g * 2, 3, "G.Block.2", "up", seed)
        self.block3 = ResidualBlock(cfg, g * 2, g * 2, 3, "G.Block.3", "up", seed)
        self.output_norm = Normalize(cfg, "G.OutputNorm", g * 2, seed)
        self.output = Conv2dLib(g * 2, cfg.img_dim, 3, "G.Output", he_init=False, seed=seed)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.input.W.device

    def forward(self, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        out = self.input(z).reshape(-1, 4, 4, cfg.dim_g * 8)
        for block in (self.block1, self.block2, self.block3):
            out = block(out, labels)
        out = self.output_norm.activated(out, labels, cfg.nonlinearity)
        out = torch.tanh(self.output(out))
        return out.reshape(-1, cfg.output_dim)


class OptimizedResBlockDisc1(nn.Module):
    """First D block (JAX ``optimized_resblock_disc1``): conv → relu →
    conv-mean-pool, with a mean-pool-conv shortcut, all spectral-normed."""

    def __init__(self, cfg: ResnetGANConfig, seed: int = 0, biases: bool = True):
        super().__init__()
        self.cfg = cfg
        kw = dict(seed=seed, spectral_normed=True, biases=biases)
        d = cfg.dim_d
        self.shortcut = Conv2dLib(cfg.img_dim, d, 1, "D.Block.1.Shortcut", he_init=False, **kw)
        self.conv1 = Conv2dLib(cfg.img_dim, d, 3, "D.Block.1.Conv1", **kw)
        self.conv2 = Conv2dLib(d, d, 3, "D.Block.1.Conv2", **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = mean_pool_conv(self.shortcut, x)
        out = nonlinearity(self.conv1(x), self.cfg.nonlinearity)
        return shortcut + conv_mean_pool(self.conv2, out)


class Discriminator(nn.Module):
    """JAX ``discriminator``: flat image ``[B, output_dim]`` → (features
    ``[B, dim_d]``, wgan logit ``[B]``).  For ``unbiased``/``rcgan-u`` the
    labels inside D are dropped (``labels_disc``), as in JAX; that is moot
    while D has no normalization, and kept for parity."""

    def __init__(self, cfg: ResnetGANConfig = ResnetGANConfig(), seed: int = 0):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim_d
        self.block1 = OptimizedResBlockDisc1(cfg, seed)
        self.blocks = nn.ModuleList(
            [ResidualBlock(cfg, d, d, 3, "D.Block.2", "down", seed, spectral_normed=True)]
            + [ResidualBlock(cfg, d, d, 3, f"D.Block.{i}", None, seed, spectral_normed=True)
               for i in (3, 4, 5, 6)])
        self.output = LinearLib(d, 1, "D.Output", seed=seed, spectral_normed=True)
        self._sn_layers = sn_layers(self)  # a plain list: the layers are registered above

    def forward(self, inputs: torch.Tensor, labels: Optional[torch.Tensor]):
        cfg = self.cfg
        labels_disc = None if cfg.algorithm in ("unbiased", "rcgan-u") else labels
        out = inputs.reshape(-1, cfg.img_size, cfg.img_size, cfg.img_dim)
        # the power-iteration step of all 15 layers in one group (one kernel
        # launch on the card); each layer below takes its prepared W / sigma
        prepare_spectral_norms(self._sn_layers)
        try:
            out = self.block1(out)
            for block in self.blocks:
                out = block(out, labels_disc)
            out = nonlinearity(out, cfg.nonlinearity)
            out = out.mean(dim=(1, 2))  # [B, dim_d]
            return out, self.output(out).reshape(-1)
        finally:
            clear_prepared(self._sn_layers)


class DiscriminatorProjection(nn.Module):
    """JAX ``discriminator_projection``: label → ``D.Embedding.Label`` table
    → spectral-normed ``D.Embedding_y`` linear → ``[B, dim_d]``."""

    def __init__(self, cfg: ResnetGANConfig = ResnetGANConfig(), seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.embedding = Embedding(cfg.vocab_size, cfg.embedding_dim, "D.Embedding.Label", seed)
        self.linear = LinearLib(cfg.embedding_dim, cfg.dim_d, "D.Embedding_y", seed=seed,
                                spectral_normed=True)

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        return self.linear(self.embedding(labels))

    def all_label_logits(self, features: torch.Tensor, wgan: torch.Tensor) -> torch.Tensor:
        """JAX ``all_label_logits``: float32 logits against every label's
        embedding, ``[B, vocab]``, through the projection kernel."""
        emb = self.linear(self.embedding.table())  # every label's row, in label order
        return all_label_projection_logits(features.contiguous(), emb.contiguous(),
                                           wgan.reshape(-1, 1).contiguous())


def projection_logits(features: torch.Tensor, wgan: torch.Tensor,
                      embedding_y: torch.Tensor) -> torch.Tensor:
    """``wgan + Σ features·embedding_y`` — the projection-discriminator
    logit (JAX ``projection_logits``)."""
    return wgan + torch.sum(features * embedding_y, dim=1)


class PermClassifier(nn.Module):
    """JAX ``perm_classifier``: spectral-normed linear (or 2-layer) on the
    flat image, named ``D.*`` so it trains with the discriminator."""

    def __init__(self, cfg: ResnetGANConfig = ResnetGANConfig(), seed: int = 0):
        super().__init__()
        self.cfg = cfg
        kw = dict(seed=seed, spectral_normed=True)
        if cfg.perm_type == "linear":
            self.layers = nn.ModuleList([LinearLib(cfg.output_dim, cfg.vocab_size,
                                                   "D.d_perm_classifier_h1", **kw)])
        elif cfg.perm_type == "2layer":
            self.layers = nn.ModuleList([
                LinearLib(cfg.output_dim, 128, "D.d_perm_classifier_h1", **kw),
                LinearLib(128, cfg.vocab_size, "D.d_perm_classifier_h2", **kw)])
        else:
            raise ValueError(f"Unknown perm_type {cfg.perm_type}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x.reshape(-1, self.cfg.output_dim)
        for layer in self.layers:  # no nonlinearity between the two, as in JAX
            out = layer(out)
        return out


def sample(generator: Generator, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Counterpart of ``CifarTrainer.sample``: the generator forward with
    batch statistics in cond-BN (``train=True`` in JAX; there is no other
    mode), under ``torch.inference_mode``, returned as float32
    ``[B, output_dim]``.  A spectral-normed generator (BigGAN's) keeps its
    ``u``: a sample is no training step."""
    with torch.inference_mode(), sn_updates(generator, False):
        return generator(z, labels).float()
