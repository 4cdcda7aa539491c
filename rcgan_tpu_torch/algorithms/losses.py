"""GAN loss zoo in elementwise form, ported from
``rcgan_tpu/algorithms/losses.py`` (``sigmoid_ce``, ``d_real_loss``,
``d_fake_loss``, ``g_loss``): 'HINGE', 'Goodfellow'/'ce'/'minimax',
'WGAN'/'WGAN-GP' and 'LSGAN', each with its soft-plus flavour.  Logits are
cast to float32 first, as in JAX.  ``get_loss`` pairs them into
``(gen_cost, disc_cost)`` for the vendored loss zoo (the PGGAN trainer's
HINGE among them), and ``wgan_gp_penalty`` is WGAN-GP's gradient penalty.
"""

from __future__ import annotations

from typing import Callable, Optional

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


def get_loss(disc_real: torch.Tensor, disc_fake: torch.Tensor, loss_type: str = "HINGE",
             soft_plus: bool = False, d_apply: Optional[Callable] = None,
             real: Optional[torch.Tensor] = None, fake: Optional[torch.Tensor] = None,
             eps: Optional[torch.Tensor] = None):
    """``(gen_cost, disc_cost)``, float32 scalars, for 'HINGE', 'WGAN',
    'WGAN-GP', 'LSGAN', 'CGAN' (the Goodfellow objective), 'Goodfellow' and
    'MiniMax', each with its soft-plus flavour.  'WGAN-GP' adds
    :func:`wgan_gp_penalty`, for which it needs ``d_apply``, ``real``,
    ``fake`` and ``eps``."""
    lt = loss_type.lower()
    if lt == "cgan":
        lt = "goodfellow"
    gen_cost = torch.mean(g_loss(disc_fake, lt, soft_plus))
    disc_cost = torch.mean(d_real_loss(disc_real, lt, soft_plus)) + torch.mean(
        d_fake_loss(disc_fake, lt, soft_plus))
    if loss_type.upper() == "WGAN-GP":
        if d_apply is None or real is None or fake is None or eps is None:
            raise ValueError("WGAN-GP needs d_apply, real, fake and eps")
        disc_cost = disc_cost + wgan_gp_penalty(d_apply, real, fake, eps)
    return gen_cost, disc_cost


def wgan_gp_penalty(d_apply: Callable, real: torch.Tensor, fake: torch.Tensor,
                    eps: torch.Tensor, lamb: float = 10.0) -> torch.Tensor:
    """``lamb * E[(||grad D(x_hat)||_2 - 1)^2]`` at the interpolates
    ``x_hat = eps * real + (1 - eps) * fake``, one ``eps`` in [0, 1) per
    example (``[B]``).  JAX draws ``eps`` from a key inside; here the caller
    passes it.  The gradient keeps its graph (``create_graph``), so the
    penalty trains D."""
    eps = eps.reshape((real.shape[0],) + (1,) * (real.dim() - 1)).to(real.dtype)
    x_hat = eps * real + (1.0 - eps) * fake
    if not x_hat.requires_grad:
        x_hat = x_hat.detach().requires_grad_(True)
    grads, = torch.autograd.grad(torch.sum(d_apply(x_hat)), x_hat, create_graph=True)
    norms = torch.sqrt(torch.sum(torch.square(grads).reshape(grads.shape[0], -1), dim=-1)
                       + 1e-12)
    return lamb * torch.mean(torch.square(norms - 1.0))
