"""The progressive-growing GAN family, ported from ``rcgan_tpu/models/pggan.py``:
ResNet G and D that double the resolution of a 4x4 base grid per stage,
with PGGAN's fade-in between stages (reference surface:
``cifar10/common/resnet_block.py:192-349``).

- :class:`Generator` holds every stage's layers (``PG.G.Input``,
  ``PG.G.Block.{s}``, ``PG.G.ToRGB.{s}``); ``forward(z, labels, stage,
  trans, alpha)`` runs only that phase's: the input linear, pixel norm, the
  blocks 1..stage (cond-BN, "up") with pixel norm after each, ReLU, ToRGB
  and tanh; in a transition, ``alpha * new + (1 - alpha) * up(low)``, with
  ``low`` the previous stage's RGB through ``ToRGB.{stage-1}`` (``alpha`` a
  host float or a float32 scalar tensor, :func:`_blend`).
- :class:`Discriminator` holds ``PG.D.FromRGB.{s}``, ``PG.D.Block.{s}``
  ("down", spectral-normed), ``PG.D.Output`` and the projection head
  (``PG.D.Embedding.Label``, the spectral-normed ``PG.D.Embedding_y``);
  ``forward(x, stage, trans, alpha, labels)`` returns the pooled features
  and the logit, ``Σ feat·emb`` added where labels are given.

The critic's blocks see no labels, so their ``PG.D.Block.{s}.N{1,2}``
scopes, which hold ``G.``, take JAX's zero-debiased ``batch_norm`` with
moving statistics (``models/resnet_gan.py::Normalize``): the statistics
are buffers that every D call in train mode moves, the G step's D pass
included, as JAX's ``ctx.train`` is True there.

A D pass normalizes its spectral-normed layers as one group (one launch of
the sn kernel on the card): exactly the layers that the phase calls, in
call order (:meth:`Discriminator.sn_group`), so the ``u`` of an inactive
stage stays as it was, as JAX writes only the state a forward touches.

The fade-in blends in float32: JAX's trainer passes ``alpha`` as a float32
array, which promotes a bf16 image to float32 there.  Activations are NHWC;
scopes and layouts are JAX's, so the trees load by name
(``rcgan_tpu_torch/bridge.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rcgan_tpu_torch.core.module import Scoped, set_compute_dtype
from rcgan_tpu_torch.models.resnet_gan import ResidualBlock, ResnetGANConfig
from rcgan_tpu_torch.ops.conv import Conv2dLib, mean_pool, upsample_depth_to_space
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device
from rcgan_tpu_torch.ops.linear import Embedding, LinearLib
from rcgan_tpu_torch.ops.norm import pixel_norm
from rcgan_tpu_torch.ops.sn import clear_prepared, prepare_spectral_norms, sn_layers


@dataclasses.dataclass(frozen=True)
class PGGANConfig:
    z_dim: int = 128
    dim: int = 128
    img_dim: int = 3
    base_size: int = 4
    max_stage: int = 3  # 4 -> 8 -> 16 -> 32
    use_pixel_norm: bool = True
    # the critic's projection head; without it the label-conditioned
    # generator gets no conditioning signal
    conditional: bool = True

    def resolution(self, stage: int) -> int:
        return self.base_size * 2 ** stage


def _check_phase(cfg: PGGANConfig, stage: int, trans: bool) -> None:
    if not 1 <= stage <= cfg.max_stage or (trans and stage < 2):
        raise ValueError(f"no phase (stage {stage}, trans {trans}) in a schedule of "
                         f"{cfg.max_stage} stages (a transition needs stage >= 2)")


def _blend(alpha, new: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """``alpha * new + (1 - alpha) * low`` in float32, both weights rounded
    to float32 as JAX computes them from its float32 ``alpha``.  ``alpha``
    is a host float, or a float32 scalar tensor on the maps' device (a
    captured step's, which reads it from its block): ``1 - alpha`` is then
    taken there, in float32, and each product and the sum round as with the
    host floats."""
    if torch.is_tensor(alpha):
        a = alpha.to(torch.float32)
        return a * new.float() + (1.0 - a) * low.float()
    a = np.float32(alpha)
    return float(a) * new.float() + float(np.float32(1.0) - a) * low.float()


class Generator(nn.Module):
    """JAX ``generator`` over every stage: z ``[B, z_dim]``, labels int
    ``[B]`` → NHWC images in [-1, 1] at ``base_size * 2**stage``."""

    def __init__(self, cfg: PGGANConfig, base: ResnetGANConfig, seed: int = 0):
        super().__init__()
        self.cfg, self.base = cfg, base
        g = cfg.dim
        stages = range(1, cfg.max_stage + 1)
        self.input = LinearLib(cfg.z_dim, cfg.base_size * cfg.base_size * g, "PG.G.Input",
                               seed=seed)
        self.blocks = nn.ModuleList([ResidualBlock(base, g, g, 3, f"PG.G.Block.{s}", "up", seed)
                                     for s in stages])
        self.to_rgb = nn.ModuleList([Conv2dLib(g, cfg.img_dim, 1, f"PG.G.ToRGB.{s}",
                                               he_init=False, seed=seed) for s in stages])

    def forward(self, z: torch.Tensor, labels: torch.Tensor, stage: int, trans: bool = False,
                alpha: Union[float, torch.Tensor] = 1.0) -> torch.Tensor:
        cfg = self.cfg
        _check_phase(cfg, stage, trans)
        out = self.input(z).reshape(-1, cfg.base_size, cfg.base_size, cfg.dim)
        if cfg.use_pixel_norm:
            out = pixel_norm(out)
        prev = out
        for s in range(1, stage + 1):
            prev = out
            out = self.blocks[s - 1](out, labels)
            # after every block: the residual sum's variance would grow with
            # depth and saturate the new stage's tanh otherwise
            if cfg.use_pixel_norm:
                out = pixel_norm(out)
        rgb = torch.tanh(self.to_rgb[stage - 1](F.relu(out)))
        if trans:
            low = torch.tanh(self.to_rgb[stage - 2](F.relu(prev)))
            rgb = _blend(alpha, rgb, upsample_depth_to_space(low))
        return rgb


class Discriminator(nn.Module):
    """JAX ``discriminator`` over every stage: NHWC images at the stage's
    resolution → (pooled features ``[B, dim]``, logit ``[B]``)."""

    def __init__(self, cfg: PGGANConfig, base: ResnetGANConfig, seed: int = 0):
        super().__init__()
        self.cfg, self.base = cfg, base
        g = cfg.dim
        stages = range(1, cfg.max_stage + 1)
        # spectral-normed like every critic layer: an unconstrained input
        # conv would break the Lipschitz chain
        self.from_rgb = nn.ModuleList([Conv2dLib(cfg.img_dim, g, 1, f"PG.D.FromRGB.{s}",
                                                 seed=seed, spectral_normed=True)
                                       for s in stages])
        self.blocks = nn.ModuleList([ResidualBlock(base, g, g, 3, f"PG.D.Block.{s}", "down",
                                                   seed, spectral_normed=True, labeled=False)
                                     for s in stages])
        self.output = LinearLib(g, 1, "PG.D.Output", seed=seed, spectral_normed=True)
        self.embedding = self.embedding_y = None
        if cfg.conditional:
            self.embedding = Embedding(base.vocab_size, base.embedding_dim,
                                       "PG.D.Embedding.Label", seed)
            self.embedding_y = LinearLib(base.embedding_dim, g, "PG.D.Embedding_y", seed=seed,
                                         spectral_normed=True)
        self._groups: Dict[Tuple[int, bool, bool], List[Scoped]] = {}

    def sn_group(self, stage: int, trans: bool, labeled: bool) -> List[Scoped]:
        """The spectral-normed layers that a D pass of the phase calls, in
        call order: ``FromRGB.{stage}``, each block's Shortcut, Conv1 and
        Conv2 from ``stage`` down (``FromRGB.{stage-1}`` after the first in
        a transition), ``Output``, and ``Embedding_y`` with labels."""
        key = (stage, trans, labeled)
        if key not in self._groups:
            layers = [self.from_rgb[stage - 1]]
            for s in range(stage, 0, -1):
                layers += sn_layers(self.blocks[s - 1])
                if trans and s == stage:
                    layers.append(self.from_rgb[stage - 2])
            layers.append(self.output)
            if labeled:
                layers.append(self.embedding_y)
            self._groups[key] = layers
        return self._groups[key]

    def forward(self, x: torch.Tensor, stage: int, trans: bool = False,
                alpha: Union[float, torch.Tensor] = 1.0,
                labels: Optional[torch.Tensor] = None):
        _check_phase(self.cfg, stage, trans)
        if labels is not None and not self.cfg.conditional:
            raise ValueError("labels given to an unconditional critic")
        layers = self.sn_group(stage, trans, labels is not None)
        prepare_spectral_norms(layers)
        try:
            out = self.from_rgb[stage - 1](x)
            for s in range(stage, 0, -1):
                out = self.blocks[s - 1](out, None)
                if trans and s == stage:
                    out = _blend(alpha, out, self.from_rgb[stage - 2](mean_pool(x)))
            feat = F.relu(out).mean(dim=(1, 2))
            logit = self.output(feat).reshape(-1)
            if labels is not None:
                emb = self.embedding_y(self.embedding(labels))
                logit = logit + torch.sum(feat * emb, dim=1)
            return feat, logit
        finally:
            clear_prepared(layers)


class PGGAN(nn.Module):
    """G and D together, drawn from ``seed`` on ``device`` (a CUDA device
    that is absent raises), every layer computing in ``compute_dtype``."""

    def __init__(self, cfg: PGGANConfig, base: ResnetGANConfig, seed: int = 0, device="cuda",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.base = cfg, base
        self.G = Generator(cfg, base, seed)
        self.D = Discriminator(cfg, base, seed)
        set_compute_dtype(self, compute_dtype)
        self.to(resolve_device(device))


def sample(generator: Generator, z: torch.Tensor, labels: torch.Tensor,
           stage: Optional[int] = None) -> torch.Tensor:
    """JAX ``PGGANTrainer.sample``: the generator at ``stage`` (default the
    last), no transition, cond-BN on batch statistics, under
    ``torch.inference_mode``, as float32 NHWC."""
    stage = generator.cfg.max_stage if stage is None else stage
    with torch.inference_mode():
        return generator(z, labels, stage).float()
