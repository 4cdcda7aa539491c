"""CIFAR-10 SNGAN generator, ported from ``rcgan_tpu/models/resnet_gan.py``.

The generator is the ResNet with conditional batch-norm
(``generator``, ``residual_block`` with ``resample`` "up" or None,
``upsample_conv``, ``normalize``'s cond-BN branch).  Activations are NHWC
and parameters keep the JAX layouts and scope names
(``rcgan_tpu_torch/core/module.py``), so the JAX parameter tree loads by
name (``rcgan_tpu_torch/bridge.py``).

Not ported yet (ROADMAP.md, Queue 1): the discriminator and its
projection head, ``layer_norm`` and the unconditional ``batch_norm``
branches of ``normalize``, and the ``"down"`` residual block.  Asking for
any of them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rcgan_tpu_torch.ops.conv import Conv2dLib, upsample_depth_to_space
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device
from rcgan_tpu_torch.ops.linear import LinearLib
from rcgan_tpu_torch.ops.norm import CondBatchNorm

_NOT_PORTED = "not ported yet: see ROADMAP.md, Queue 1 (the discriminator forward)"


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
    scope ``name`` to: conditional BN for a conditional generator, identity
    where normalization is off."""

    def __init__(self, cfg: ResnetGANConfig, name: str, channels: int, seed: int = 0):
        super().__init__()
        self.cbn: Optional[CondBatchNorm] = None
        if "D." in name and cfg.normalization_d:
            raise NotImplementedError(f"layer_norm for {name}: {_NOT_PORTED}")
        if "G." in name and cfg.normalization_g:
            if not cfg.conditional:
                raise NotImplementedError(f"unconditional batch_norm for {name}: {_NOT_PORTED}")
            self.cbn = CondBatchNorm(cfg.vocab_size, channels, name, seed)

    def forward(self, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return x if self.cbn is None else self.cbn(x, labels)


def upsample_conv(conv: Conv2dLib, x: torch.Tensor) -> torch.Tensor:
    return conv(upsample_depth_to_space(x))


class ResidualBlock(nn.Module):
    """(norm → relu → conv) x2 + shortcut, with "up" or no resampling
    (JAX ``residual_block``)."""

    def __init__(self, cfg: ResnetGANConfig, input_dim: int, output_dim: int,
                 filter_size: int, name: str, resample: Optional[str] = None,
                 seed: int = 0):
        super().__init__()
        if name.startswith("D.") or resample == "down":
            raise NotImplementedError(f"residual block {name} ({resample}): {_NOT_PORTED}")
        if resample not in ("up", None):
            raise ValueError(f"invalid resample {resample!r}")
        self.cfg = cfg
        self.up = resample == "up"
        self.shortcut = None
        if not (output_dim == input_dim and resample is None):
            self.shortcut = Conv2dLib(input_dim, output_dim, 1, name + ".Shortcut",
                                      he_init=False, seed=seed)
        self.n1 = Normalize(cfg, name + ".N1", input_dim, seed)
        self.conv1 = Conv2dLib(input_dim, output_dim, filter_size, name + ".Conv1", seed=seed)
        self.n2 = Normalize(cfg, name + ".N2", output_dim, seed)
        self.conv2 = Conv2dLib(output_dim, output_dim, filter_size, name + ".Conv2", seed=seed)

    def _conv(self, conv: Conv2dLib, x: torch.Tensor) -> torch.Tensor:
        return upsample_conv(conv, x) if self.up else conv(x)

    def forward(self, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self._conv(self.shortcut, x)
        out = nonlinearity(self.n1(x, labels), self.cfg.nonlinearity)
        out = self._conv(self.conv1, out)
        out = nonlinearity(self.n2(out, labels), self.cfg.nonlinearity)
        out = self.conv2(out)
        return shortcut + out


class Generator(nn.Module):
    """JAX ``generator``: z ``[B, z_dim]``, labels int ``[B]`` → flat image
    ``[B, output_dim]`` in [-1, 1].  Parameters are drawn from ``seed``
    (``rcgan_tpu_torch/core/initializers.py``) and placed on ``device``; a
    CUDA device that is absent raises."""

    def __init__(self, cfg: ResnetGANConfig = ResnetGANConfig(), seed: int = 0,
                 device="cpu"):
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
        out = nonlinearity(self.output_norm(out, labels), cfg.nonlinearity)
        out = torch.tanh(self.output(out))
        return out.reshape(-1, cfg.output_dim)


def sample(generator: Generator, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Counterpart of ``CifarTrainer.sample``: the generator forward with
    batch statistics in cond-BN (``train=True`` in JAX; there is no other
    mode), under ``torch.inference_mode``, returned as float32
    ``[B, output_dim]``."""
    with torch.inference_mode():
        return generator(z, labels).float()
