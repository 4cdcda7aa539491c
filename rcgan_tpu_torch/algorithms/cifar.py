"""CIFAR-10 loss graphs for the four algorithms (biased, unbiased, rcgan,
rcgan-u), ported from ``rcgan_tpu/algorithms/cifar.py`` (``CifarAlgoConfig``,
``confusion_init_values``, ``confusion_matrix``, ``disc_loss``,
``gen_loss``, ``partition_predicates``, ``lr_decay``).

:class:`CifarGAN` holds every layer of a trainer's tree under the JAX scope
names: ``G.*``, ``D.*`` (the discriminator, its projection head and the
perm classifier) and, for rcgan-u, ``confusion_logits``.  Its
``disc_loss``/``gen_loss`` are the forward of one tower of the reference's
loops, with the spectral-norm ``u`` state written as in JAX: every SN layer
advances its ``u`` in ``disc_loss`` (rcgan-u runs D twice, and the second
pass reads what the first wrote); ``gen_loss`` freezes D's ``u`` but still
advances the projection embedding's and the perm classifier's.  Both are
differentiable on both devices (every kernel on their path has an
autograd function); the training cycle is ``rcgan_tpu_torch/train/cifar_loop.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rcgan_tpu_torch.algorithms.losses import d_fake_loss, d_real_loss, g_loss, sigmoid_ce
from rcgan_tpu_torch.core import initializers as inits
from rcgan_tpu_torch.core.module import (Scoped, float32_policy, set_compute_dtype,
                                          sn_updates)
from rcgan_tpu_torch.models import biggan, resnet_gan
from rcgan_tpu_torch.models.resnet_gan import PermClassifier, ResnetGANConfig, projection_logits
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device
from rcgan_tpu_torch.ops.linear import take_rows


@dataclasses.dataclass(frozen=True)
class CifarAlgoConfig:
    algorithm: str = "rcgan"  # biased | unbiased | rcgan | rcgan-u
    loss_type: str = "HINGE"  # HINGE | Goodfellow | WGAN
    soft_plus: bool = False
    perm_classifier: bool = False
    perm_multiplier: float = 1.0
    confuse_init: bool = False
    confuse_init_diag: float = 0.2
    vocab_size: int = 10


def confusion_init_values(acfg) -> np.ndarray:
    """Diagonal-dominant logits init (JAX ``confusion_init_values``)."""
    v = getattr(acfg, "vocab_size", None) or acfg.y_dim
    d = acfg.confuse_init_diag
    if d > 0.99 and v == 10:
        aa = 7.0
    else:
        aa = np.log(v * d / (1.0 - d))
    aa = min(7.0, aa)
    out = (0.0 - aa / v) * np.ones((v, v), np.float32)
    np.fill_diagonal(out, aa - aa / v)
    return out


class ConfusionLogits(Scoped):
    """rcgan-u's learned confusion matrix: ``confusion_logits/logits``
    ``[V, V]``, Glorot-uniform or the diagonal-dominant ``confuse_init``."""

    def __init__(self, acfg: CifarAlgoConfig, seed: int = 0):
        super().__init__("confusion_logits", seed)
        if acfg.confuse_init:
            vals = torch.from_numpy(confusion_init_values(acfg))
            init_fn = lambda gen, shape, dtype: vals.to(dtype)  # noqa: E731
        else:
            init_fn = inits.glorot_uniform()
        self.add_param("logits", (acfg.vocab_size, acfg.vocab_size), init_fn)


class CifarGAN(nn.Module):
    """The trainer's layers and the CIFAR loss forwards.  The architecture
    is the config's: the paper's SNGAN (``ResnetGANConfig``) or BigGAN
    (``models.biggan.BigGANConfig``), whose modules have the same
    interfaces.  Parameters are drawn from ``seed`` and placed on
    ``device``; every layer computes in ``compute_dtype`` (float32 or
    bfloat16) at its conv or matmul."""

    def __init__(self, cfg: ResnetGANConfig = ResnetGANConfig(),
                 acfg: CifarAlgoConfig = CifarAlgoConfig(), seed: int = 0, device="cuda",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.acfg = cfg, acfg
        arch = biggan if isinstance(cfg, biggan.BigGANConfig) else resnet_gan
        self.G = arch.Generator(cfg, seed, device="cpu")  # built on the CPU, moved below
        self.D = arch.Discriminator(cfg, seed)
        self.projection = arch.DiscriminatorProjection(cfg, seed)
        self.perm = PermClassifier(cfg, seed) if acfg.perm_classifier else None
        self.confusion = ConfusionLogits(acfg, seed) if acfg.algorithm == "rcgan-u" else None
        set_compute_dtype(self, compute_dtype)
        float32_policy(compute_dtype)
        self.to(resolve_device(device))

    def confusion_matrix(self, c_actual: Optional[torch.Tensor]) -> torch.Tensor:
        if self.confusion is not None:
            return torch.softmax(self.confusion.logits, dim=-1)
        if c_actual is None:
            raise ValueError(f"{self.acfg.algorithm} needs the actual confusion matrix")
        return c_actual

    def _perm_cost(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        logits = self.perm(images)
        return torch.mean(sigmoid_ce(logits, F.one_hot(labels, self.acfg.vocab_size)))

    def disc_loss(self, batch: dict, z: torch.Tensor,
                  c_actual: Optional[torch.Tensor] = None) -> dict:
        """Discriminator cost (JAX ``disc_loss``).  ``batch``: real_data
        ``[b, output_dim]`` float, int labels / labels_random /
        labels_biased ``[b]``, labels_inv_weights ``[b, V]``."""
        alg = self.acfg.algorithm
        lt, sp = self.acfg.loss_type, self.acfg.soft_plus
        real = batch["real_data"]
        b = real.shape[0]
        cmat = self.confusion_matrix(c_actual)

        fake = self.G(z, batch["labels_random"])

        if alg == "rcgan-u":
            # real pass alone, then the fake pass against all labels
            feat_r, wgan_r = self.D(real, batch["labels"])
            disc_real = projection_logits(feat_r, wgan_r, self.projection(batch["labels"]))
            real_l = torch.mean(d_real_loss(disc_real, lt, sp))

            feat_f, wgan_f = self.D(fake, batch["labels_random"])
            logits_all = self.projection.all_label_logits(feat_f, wgan_f)  # [b, V]
            w = take_rows(cmat, batch["labels_random"])  # C[y_gen]
            cost = torch.mean(torch.sum(d_fake_loss(logits_all, lt, sp) * w, dim=1)) + real_l
            disc_fake = torch.sum(logits_all * w, dim=1)
        else:
            data = torch.cat([real, fake], dim=0)  # promotes, as jnp.concatenate
            if alg in ("biased", "unbiased"):
                rf_labels = torch.cat([batch["labels"], batch["labels_random"]], dim=0)
            elif alg == "rcgan":
                rf_labels = torch.cat([batch["labels"], batch["labels_biased"]], dim=0)
            else:
                raise ValueError(alg)
            feat, wgan = self.D(data, rf_labels)

            if alg in ("biased", "rcgan"):
                disc_all = projection_logits(feat, wgan, self.projection(rf_labels))
                disc_real, disc_fake = disc_all[:b], disc_all[b:]
                cost = (torch.mean(d_real_loss(disc_real, lt, sp))
                        + torch.mean(d_fake_loss(disc_fake, lt, sp)))
            else:  # unbiased: the real term at ALL labels, C^-1-weighted
                logits_all_r = self.projection.all_label_logits(feat[:b], wgan[:b])
                inv_w = batch["labels_inv_weights"]
                real_l = torch.mean(torch.sum(d_real_loss(logits_all_r, lt, sp) * inv_w, dim=1))
                emb_f = self.projection(batch["labels_random"])
                disc_fake = projection_logits(feat[b:], wgan[b:], emb_f)
                cost = real_l + torch.mean(d_fake_loss(disc_fake, lt, sp))
                disc_real = torch.sum(logits_all_r * inv_w, dim=1)

        if self.perm is not None:
            perm_real = self._perm_cost(real, batch["labels"])
            cost = cost + 1.0 * perm_real
        else:
            perm_real = torch.zeros((), device=cost.device)

        return {"disc_cost": cost, "disc_real": disc_real, "disc_fake": disc_fake,
                "perm_real": perm_real, "confusion": cmat}

    def gen_loss(self, labels_random_g: torch.Tensor, labels_biased_g: torch.Tensor,
                 z: torch.Tensor, c_actual: Optional[torch.Tensor] = None) -> dict:
        """Generator cost (JAX ``gen_loss``).  D's ``u`` stays frozen; the
        projection embedding's and the perm classifier's advance."""
        alg = self.acfg.algorithm
        lt, sp = self.acfg.loss_type, self.acfg.soft_plus
        cmat = self.confusion_matrix(c_actual)

        fake = self.G(z, labels_random_g)

        d_labels = labels_random_g if alg in ("biased", "unbiased") else labels_biased_g
        with sn_updates(self.D, False):
            feat, wgan = self.D(fake, d_labels)

        if alg == "rcgan-u":
            logits_all = self.projection.all_label_logits(feat, wgan)  # [b, V]
            w = take_rows(cmat, labels_random_g)
            cost = torch.mean(torch.sum(g_loss(logits_all, lt, sp) * w, dim=1))
        else:
            disc_fake = projection_logits(feat, wgan, self.projection(d_labels))
            cost = torch.mean(g_loss(disc_fake, lt, sp))

        if self.perm is not None:
            perm_fake = self._perm_cost(fake, labels_random_g)
            cost = cost + self.acfg.perm_multiplier * perm_fake
        else:
            perm_fake = torch.zeros((), device=cost.device)

        return {"gen_cost": cost, "perm_fake": perm_fake, "confusion": cmat, "G": fake}


def partition_predicates():
    """Optimizer partition (JAX ``partition_predicates``): scope prefixes."""
    return {
        "confusion": lambda n: n == "confusion_logits",
        "gen": lambda n: n.startswith("G."),
        "disc": lambda n: n.startswith("D."),
    }


def lr_decay(iteration, decay: bool = True) -> float:
    """Linear LR decay to 0.5 at iteration 50k, then 0.5 flat (JAX ``lr_decay``),
    in float32 on the host: the cycle's host part runs no tensor op."""
    if not decay:
        return 1.0
    it = np.float32(iteration)
    if it < np.float32(50000.0):
        return float(max(np.float32(1.0) - it / np.float32(100000.0), np.float32(0.0)))
    return 0.5
