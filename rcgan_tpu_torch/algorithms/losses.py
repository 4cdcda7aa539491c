"""GAN loss zoo in elementwise form, ported from
``rcgan_tpu/algorithms/losses.py`` (``sigmoid_ce``, ``d_real_loss``,
``d_fake_loss``, ``g_loss``): 'HINGE', 'Goodfellow'/'ce'/'minimax',
'WGAN'/'WGAN-GP' and 'LSGAN', each with its soft-plus flavour.  Logits are
cast to float32 first, as in JAX.  ``get_loss`` and ``wgan_gp_penalty``
come with the training slice (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + e^x) without F.softplus's linear cut-off above 20, as jax.nn.softplus
    return torch.logaddexp(x, torch.zeros_like(x))


def sigmoid_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """tf.nn.sigmoid_cross_entropy_with_logits, in float32."""
    logits = logits.float()
    targets = targets.float()
    return torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def d_real_loss(logits: torch.Tensor, loss_type: str, soft_plus: bool = False) -> torch.Tensor:
    """Per-element discriminator loss on real-data logits."""
    logits = logits.float()
    lt = loss_type.lower()
    if lt == "hinge":
        if soft_plus:
            return _softplus(-torch.clamp(-1.0 + logits, max=0.0))
        return F.relu(1.0 - logits)
    if lt in ("ce", "goodfellow", "minimax"):
        if soft_plus:
            return _softplus(F.logsigmoid(logits)) * -1.0
        return -F.logsigmoid(logits)
    if lt in ("wgan", "wgan-gp"):
        return _softplus(-logits) if soft_plus else -logits
    if lt == "lsgan":
        return torch.square(logits - 1.0)
    raise ValueError(f"Unknown loss_type {loss_type!r}")


def d_fake_loss(logits: torch.Tensor, loss_type: str, soft_plus: bool = False) -> torch.Tensor:
    """Per-element discriminator loss on fake-data logits."""
    logits = logits.float()
    lt = loss_type.lower()
    if lt == "hinge":
        if soft_plus:
            return _softplus(-torch.clamp(-1.0 - logits, max=0.0))
        return F.relu(1.0 + logits)
    if lt in ("ce", "goodfellow", "minimax"):
        base = _softplus(logits)  # -log(1 - sigmoid(x))
        return -_softplus(-base) if soft_plus else base
    if lt in ("wgan", "wgan-gp"):
        return _softplus(logits) if soft_plus else logits
    if lt == "lsgan":
        return torch.square(logits)
    raise ValueError(f"Unknown loss_type {loss_type!r}")


def g_loss(logits: torch.Tensor, loss_type: str, soft_plus: bool = False) -> torch.Tensor:
    """Per-element generator loss on fake-data logits."""
    logits = logits.float()
    lt = loss_type.lower()
    if lt == "hinge":
        return _softplus(-logits) if soft_plus else -logits
    if lt in ("ce", "goodfellow", "minimax"):
        base = -F.logsigmoid(logits)
        return _softplus(base) if soft_plus else base
    if lt in ("wgan", "wgan-gp"):
        return _softplus(-logits) if soft_plus else -logits
    if lt == "lsgan":
        return torch.square(logits - 1.0)
    raise ValueError(f"Unknown loss_type {loss_type!r}")
