"""Inception score, the counterpart of ``rcgan_tpu/evals/inception.py``
(``preds_to_score``; ``inception_score`` as :class:`InceptionScore`;
``real_data_score``).

The estimator is ``exp(E KL(p(y|x) || p(y)))`` over splits
(``cifar10/common/inception/inception_score_.py:61-68``); the classifier is
pluggable: the CIFAR app scores with Inception-v3
(:mod:`rcgan_tpu_torch.evals.inception_v3`) where its weights lie in the
data dir, else with the compact stand-in classifier of
:mod:`rcgan_tpu_torch.evals.classifier`, as the archived runs did, whose
scores are self-consistent across runs but not on the Inception-v3 scale.
Samples and their class probabilities stay on the device until one fetch
at the end.

JAX scans all ``n // batch`` sample-and-classify batches as one jitted
program and jits the real-data step.  The port runs each as one body over
the rows of a block (``train/graphs.py``): eagerly on the CPU, and on a
card captured in a CUDA graph and replayed per batch.  A batch's seeds
are rows of the block (device seed bases), never host values baked into
the graph.  :class:`InceptionScore` keeps its program across calls, as
the CIFAR app scores the same generator every ``inception_freq``
iterations, so that the capture is paid once a run.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from rcgan_tpu_torch.core import rng as trng
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device
from rcgan_tpu_torch.train.graphs import Program, StepBlock, capture_on
from rcgan_tpu_torch.train.state import train_state_key


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


def batch_seeds(seed: int, i: int) -> np.ndarray:
    """``[2]`` int64: the :func:`~rcgan_tpu_torch.core.rng.seed_base` of
    batch ``i``'s seed ``fold_in(seed, i)`` and of ``fold_in(that, 1)``, as
    ``sample_fn`` reads them from the device (JAX's per-batch key and the
    labels' key folded from it)."""
    s = trng.fold_in(seed, i)
    return np.array([trng.seed_base(s), trng.seed_base(trng.fold_in(s, 1))], np.int64)


class InceptionScore:
    """The Inception score of ``sample_fn``'s images under ``logits_fn``, as
    one program kept across calls: ``sample_fn(seeds, batch)`` draws a
    batch from ``seeds``, an int64 ``[2]`` tensor on the device (batch
    ``i``'s :func:`batch_seeds`: ``fold_in(seed, i)``'s base and its labels'
    base), and ``logits_fn`` classifies it; both run inside the program's
    body on device tensors, with no host work.  ``graphs``: the body is
    captured on a card by default, once, and replayed for every batch of
    every later call whose ``state`` lies where it lay (``False`` runs it
    eagerly)."""

    def __init__(self, sample_fn: Callable[[torch.Tensor, int], torch.Tensor],
                 logits_fn: Callable[[torch.Tensor], torch.Tensor], batch: int = 500,
                 device="cuda", graphs: Optional[bool] = None):
        dev = resolve_device(device)
        self.sample_fn, self.logits_fn, self.batch = sample_fn, logits_fn, batch
        self.program = Program(self._body, {"seeds": torch.int64}, dev, capture_on(dev, graphs))

    def _body(self, blk: StepBlock, state) -> None:
        with torch.no_grad():
            imgs = self.sample_fn(blk.row("seeds"), self.batch)
            blk.write("probs", torch.softmax(self.logits_fn(imgs).float(), dim=-1))
        blk.advance()

    def __call__(self, state: Sequence[torch.Tensor], n: int = 50000, splits: int = 10,
                 seed: int = 0) -> Tuple[float, float]:
        """The score of ``n // batch`` batches: every batch's probabilities
        stay on the device until one fetch at the end, then the estimator.
        ``state`` is every tensor the two functions read (the generator's
        state, the classifier's weights): a graph is captured again when
        one of them has moved."""
        k = n // self.batch
        state = tuple(state)
        self.program.run([{"seeds": batch_seeds(seed, i)} for i in range(k)], state,
                         lambda: train_state_key(None, state))
        probs = self.program.block.outputs["probs"][:k]
        return preds_to_score(probs.reshape(-1, probs.shape[-1]).cpu().numpy(), splits)


def real_data_score(images: np.ndarray, logits_fn: Callable[[torch.Tensor], torch.Tensor],
                    batch: int = 500, splits: int = 10, device="cuda",
                    graphs: Optional[bool] = None) -> Tuple[float, float]:
    """The score of real images under the same estimator, whole batches
    only: the anchor the reference records (11.31 ± 0.08 for the CIFAR-10
    train set under Inception-v3, ``inception_score_.py:82``).  Each batch
    goes to ``device`` through the block's staging copy, and its
    probabilities stay there until one fetch at the end."""
    dev = resolve_device(device)

    def body(blk: StepBlock, state) -> torch.Tensor:
        with torch.no_grad():
            return torch.softmax(logits_fn(blk.row("x")).float(), dim=-1)

    prog = Program(body, {"x": torch.float32}, dev, capture_on(dev, graphs))
    probs = [prog.run([{"x": images[i: i + batch]}]).clone()
             for i in range(0, len(images) - batch + 1, batch)]
    prog.captured.reset()
    return preds_to_score(torch.cat(probs).cpu().numpy(), splits)
