"""Inception score, the counterpart of ``rcgan_tpu/evals/inception.py``
(``preds_to_score``, ``inception_score``, ``real_data_score``).

The estimator is ``exp(E KL(p(y|x) || p(y)))`` over splits
(``cifar10/common/inception/inception_score_.py:61-68``); the classifier is
pluggable: the CIFAR app scores with Inception-v3
(:mod:`rcgan_tpu_torch.evals.inception_v3`) where its weights lie in the
data dir, else with the compact stand-in classifier of
:mod:`rcgan_tpu_torch.evals.classifier`, as the archived runs did, whose
scores are self-consistent across runs but not on the Inception-v3 scale.
Samples and their class probabilities stay on the device until one fetch
at the end.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from rcgan_tpu_torch.core import rng as trng


def preds_to_score(preds: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """``exp(E KL(p(y|x) || p(y)))`` per split; returns (mean, std).
    Probabilities are floored at 1e-20, so that an underflowed 0 cannot
    turn ``0 * log(0)`` into NaN (the floor moves the score by ~1e-19)."""
    preds = np.clip(np.asarray(preds, np.float64), 1e-20, 1.0)
    scores = []
    n = preds.shape[0]
    for i in range(splits):
        part = preds[i * n // splits: (i + 1) * n // splits]
        kl = part * (np.log(part) - np.log(np.mean(part, axis=0, keepdims=True)))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores)), float(np.std(scores))


def inception_score(sample_fn: Callable[[int, int], torch.Tensor],
                    logits_fn: Callable[[torch.Tensor], torch.Tensor], n: int = 50000,
                    batch: int = 500, splits: int = 10, seed: int = 0) -> Tuple[float, float]:
    """Generate ``n`` samples with ``sample_fn(seed_i, batch)``, batch ``i``
    keyed by ``fold_in(seed, i)``, and score them with ``logits_fn``."""
    probs = []
    with torch.no_grad():
        for i in range(n // batch):
            imgs = sample_fn(trng.fold_in(seed, i), batch)
            probs.append(torch.softmax(logits_fn(imgs).float(), dim=-1))
    return preds_to_score(torch.cat(probs).cpu().numpy(), splits)


def real_data_score(images: np.ndarray, logits_fn: Callable[[torch.Tensor], torch.Tensor],
                    batch: int = 500, splits: int = 10) -> Tuple[float, float]:
    """The score of real images under the same estimator, whole batches
    only: the anchor the reference records (11.31 ± 0.08 for the CIFAR-10
    train set under Inception-v3, ``inception_score_.py:82``)."""
    probs = []
    with torch.no_grad():
        for i in range(0, len(images) - batch + 1, batch):
            probs.append(torch.softmax(logits_fn(images[i: i + batch]).float(), dim=-1))
    return preds_to_score(torch.cat(probs).cpu().numpy(), splits)
