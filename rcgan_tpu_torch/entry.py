"""The discriminator forward entry point, the counterpart of the JAX
package's ``__graft_entry__.entry()``: the flagship CIFAR-10 SNGAN
(``ResnetGANConfig()``: dim_g 128, dim_d 128, embedding 300) run
generator → discriminator → projection head → ``projection_logits`` at
batch 64, with spectral-norm ``u`` frozen (``update_sn=False``) and bf16 at
the convs and matmuls by default.

    fwd, (z, labels) = entry("cuda")
    logits = fwd(z, labels)          # float [64], in compute_dtype

Weights are random, drawn from ``seed``.  The JAX function's TPU-probe
plumbing (the backend reachability check and the CPU fallback) has no
counterpart: ``device`` says where to run, and an absent CUDA device raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from rcgan_tpu_torch.core.module import set_compute_dtype, sn_updates
from rcgan_tpu_torch.models.resnet_gan import (Discriminator, DiscriminatorProjection,
                                               Generator, ResnetGANConfig, projection_logits)
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device


class EntryForward(nn.Module):
    """G → D → projection → logits under ``torch.inference_mode``, with every
    SN ``u`` frozen, as JAX's ``fwd`` runs with ``update_sn=False``.  Holds
    the ``G.*`` and ``D.*`` layers of the JAX function's trees (no perm
    classifier, no confusion matrix), so they load by name."""

    def __init__(self, cfg: ResnetGANConfig = ResnetGANConfig(), seed: int = 0,
                 device="cuda", compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.G = Generator(cfg, seed, device="cpu")  # built on the CPU, moved below
        self.D = Discriminator(cfg, seed)
        self.projection = DiscriminatorProjection(cfg, seed)
        set_compute_dtype(self, compute_dtype)
        self.to(resolve_device(device))

    def forward(self, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), sn_updates(self, False):
            fake = self.G(z, labels)
            feat, wgan = self.D(fake, labels)
            return projection_logits(feat, wgan, self.projection(labels))


def entry(device="cuda", compute_dtype: torch.dtype = torch.bfloat16,
          cfg: ResnetGANConfig = ResnetGANConfig(), batch: int = 64, seed: int = 0):
    """``(fwd, (z, labels))``: the forward module on ``device`` and its inputs,
    ``z [batch, z_dim]`` float32 standard normal from ``seed + 1`` and labels
    ``arange(batch) % 10``, as ``__graft_entry__.entry()`` builds them."""
    dev = resolve_device(device)
    fwd = EntryForward(cfg, seed, dev, compute_dtype)
    z = np.random.default_rng(seed + 1).standard_normal((batch, cfg.z_dim), np.float32)
    labels = torch.arange(batch, dtype=torch.int64) % cfg.vocab_size
    return fwd, (torch.from_numpy(z).to(dev), labels.to(dev))
