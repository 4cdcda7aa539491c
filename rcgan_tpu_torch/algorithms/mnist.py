"""MNIST loss graphs for the six training modes, ported from
``rcgan_tpu/algorithms/mnist.py`` (``MnistAlgoConfig``,
``confusion_matrix``, ``mnist_losses``, ``partition_predicates``;
reference: ``DCGAN.build_model``, ``mnist/model.py:96-247``).

The modes lie on two axes, as in the reference: ``algorithm`` (biased,
unbiased, rcgan, ambient) chooses the wiring, and flags the variants:
``estimate_confuse`` makes rcgan RCGAN-U (a learned C and the expected
fake loss over its row), ``perm_regularizer`` adds the permutation
classifier, ``concat_y`` (with the app's ``add_noise``) makes rcgan
RCGAN+y.

:class:`MnistGAN` holds every layer of a trainer's tree under the JAX
names: ``g_*``, ``d_*`` (D and, with ``perm_regularizer``,
``d_classifier_h1``) and, with ``estimate_confuse``, ``confusion_logits``.
:func:`mnist_losses` is one forward of all the losses; it advances the
state as JAX's does, in the same order: G's BN moving statistics (G runs
in train mode), then D's BN statistics and spectral-norm ``u`` on the real
pass, then on the fake pass.  Every call updates ``u`` (the MNIST stack
has no ``NO_OPS`` gating).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rcgan_tpu_torch.algorithms.cifar import ConfusionLogits
from rcgan_tpu_torch.algorithms.losses import d_fake_loss, d_real_loss, g_loss, sigmoid_ce
from rcgan_tpu_torch.core.module import float32_policy, set_compute_dtype
from rcgan_tpu_torch.models.dcgan import Classifier, DCGANConfig, Discriminator, Generator
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device


@dataclasses.dataclass(frozen=True)
class MnistAlgoConfig:
    algorithm: str = "biased"  # biased | unbiased | rcgan | ambient
    estimate_confuse: bool = False
    perm_regularizer: bool = False
    loss_fn: str = "hinge"  # hinge | ce
    perm_multiplier: float = 10.0
    confuse_multiplier: float = 10.0
    # the CIFAR stack's diagonal-dominant C-logits init, ported to MNIST by
    # the JAX package; the reference's MNIST stack uses the default init
    confuse_init: bool = False
    confuse_init_diag: float = 0.2
    y_dim: int = 10

    @property
    def vocab_size(self) -> int:
        """The label count under the CIFAR stack's name, which
        :class:`~rcgan_tpu_torch.algorithms.cifar.ConfusionLogits` reads."""
        return self.y_dim


class MnistGAN(nn.Module):
    """The trainer's layers: ``G``, ``D``, the perm classifier
    (``perm_regularizer``) and the learned confusion logits
    (``estimate_confuse``; Glorot-uniform, or the diagonal-dominant
    ``confuse_init``).  Parameters are drawn from ``seed`` and placed on
    ``device``; every layer computes in ``compute_dtype`` at its conv or
    matmul."""

    def __init__(self, cfg: DCGANConfig = DCGANConfig(),
                 acfg: MnistAlgoConfig = MnistAlgoConfig(), seed: int = 0, device="cuda",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.acfg = cfg, acfg
        self.G = Generator(cfg, seed)
        self.D = Discriminator(cfg, seed)
        self.classifier = Classifier(cfg, seed) if acfg.perm_regularizer else None
        self.confusion = ConfusionLogits(acfg, seed) if acfg.estimate_confuse else None
        set_compute_dtype(self, compute_dtype)
        float32_policy(compute_dtype)
        self.to(resolve_device(device))

    def confusion_matrix(self, confusion_actual: Optional[torch.Tensor]) -> torch.Tensor:
        """JAX ``confusion_matrix``: ``softmax(confusion_logits)`` when C is
        learned, else the true C."""
        if self.confusion is not None:
            return torch.softmax(self.confusion.logits, dim=-1)
        if confusion_actual is None:
            raise ValueError("a known-C mode needs the actual confusion matrix")
        return confusion_actual


def mnist_losses(gan: MnistGAN, batch: dict, z: torch.Tensor,
                 confusion_actual: Optional[torch.Tensor] = None,
                 g_step_only: bool = False) -> dict:
    """Every loss of ``mnist/model.py:149-224`` in one forward (JAX
    ``mnist_losses``).  ``batch``: ``images [B, H, W, 1]`` float, int
    ``y_real``/``y_gen``/``y_fake`` ``[B]`` and float ``y_real_weights [B,
    y]``.  ``g_step_only`` skips the real-data passes and their state
    updates, as the reference's G and C steps never run them.  Returns the
    scalars, the D probabilities ``D``/``D_`` ``[B]``, ``confusion`` and the
    fakes ``G``."""
    cfg, acfg = gan.cfg, gan.acfg
    alg, lt, y = acfg.algorithm, acfg.loss_fn, acfg.y_dim
    inputs = batch["images"]
    y_real_oh = F.one_hot(batch["y_real"].long(), y).to(inputs.dtype)
    y_gen_oh = F.one_hot(batch["y_gen"].long(), y).to(inputs.dtype)
    y_fake_oh = F.one_hot(batch["y_fake"].long(), y).to(inputs.dtype)
    y_real_w = batch["y_real_weights"]

    cmat = gan.confusion_matrix(confusion_actual)
    fake = gan.G(z, y_gen_oh, train=True)
    zero = torch.zeros((), device=inputs.device)

    # ----- the real-data term (mnist/model.py:150-174)
    if g_step_only:
        d_prob = torch.zeros((inputs.shape[0],), device=inputs.device)
        d_loss_real = zero
    elif alg in ("biased", "rcgan", "ambient"):
        d_prob, d_logits = gan.D(inputs, y_real_oh)
        d_prob = d_prob[:, 0]
        d_loss_real = torch.mean(d_real_loss(d_logits[:, 0], lt))
    elif alg == "unbiased":
        logits_all = gan.D.all_labels(inputs)  # [B, y]
        d_prob = torch.sum(torch.sigmoid(logits_all) * y_real_w, dim=1)
        d_loss_real = torch.mean(torch.sum(d_real_loss(logits_all, lt) * y_real_w, dim=1))
    else:
        raise ValueError(f"unknown algorithm {alg!r}")

    # ----- the fake-data terms (mnist/model.py:176-212)
    d_loss_fake = gen_loss = None
    if alg in ("rcgan", "ambient") and acfg.estimate_confuse:
        # RCGAN-U: the expected loss over the learned C's row of y_gen
        logits_all_ = gan.D.all_labels(fake)  # [B, y]
        w = y_gen_oh @ cmat
        d_prob_ = torch.sum(torch.sigmoid(logits_all_) * w, dim=1)
        d_loss_fake = torch.mean(torch.sum(d_fake_loss(logits_all_, lt) * w, dim=1))
        gen_loss = torch.mean(torch.sum(g_loss(logits_all_, lt) * w, dim=1))
    else:
        d_label = y_fake_oh if alg in ("rcgan", "ambient") else y_gen_oh
        d_prob_, d_logits_ = gan.D(fake, d_label)
        d_prob_, d_logits_ = d_prob_[:, 0], d_logits_[:, 0]
        d_loss_fake = torch.mean(d_fake_loss(d_logits_, lt))
        gen_loss = torch.mean(g_loss(d_logits_, lt))

    # ----- the permutation-regularizer classifier (mnist/model.py:214-224)
    class_loss_real = class_loss_fake = zero
    if acfg.perm_regularizer:
        if not g_step_only:
            class_loss_real = torch.mean(sigmoid_ce(gan.classifier(inputs), y_real_oh))
        class_loss_fake = torch.mean(sigmoid_ce(gan.classifier(fake), y_gen_oh))

    return {
        "d_loss_real": d_loss_real,
        "d_loss_fake": d_loss_fake,
        "d_loss": d_loss_real + d_loss_fake,
        "g_loss": gen_loss,
        "class_loss_real": class_loss_real,
        "class_loss_fake": class_loss_fake,
        "D": d_prob,
        "D_": d_prob_,
        "confusion": cmat,
        "G": fake,
    }


def partition_predicates():
    """The optimiser partition of ``mnist/model.py:244-245`` (JAX
    ``partition_predicates``), first match wins: ``confusion_logits``, then
    ``'d_' in name`` (D and the perm classifier), then ``'g_' in name``."""
    return {
        "confusion": lambda n: n == "confusion_logits",
        "disc": lambda n: "d_" in n,
        "gen": lambda n: "g_" in n,
    }
