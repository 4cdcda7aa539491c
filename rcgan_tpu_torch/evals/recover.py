"""cGAN label recovery, ported from ``rcgan_tpu/evals/recover.py``
(``RecoverConfig``, ``recover_labels``, ``render_wrong_image_diagnostics``;
reference: ``DCGAN.recover_labels``, ``mnist/model.py:494-640``).

Given a trained generator and real images whose labels are unknown, plain
gradient descent on per-example ``(z, y_logits)`` minimises the
softmax-weighted squared error between each image and ``G(z_ik, e_k)``
over every class ``k``:

    loss = mean_i Σ_k softmax(y_logits_i)_k · mean((x_i − G(z_ik, e_k))²)

The reference takes 1000 steps at lr 5e2 on a batch of 500.  JAX runs the
loop as one ``lax.scan``; the port runs one step's body (G forward, the
gradients in ``z`` and ``y_logits``, the update) once per row of a block
(``train/graphs.py``): eagerly by default, or on a card (``graphs=True``)
captured once in a CUDA graph and replayed ``epochs`` times.  The step is
device-bound at the reference's batch (5 000 rows through G), so the
replays save about what the capture costs (``PERF.md`` §5), and eager is
the default.  ``z`` and ``y_logits`` are leaves at fixed addresses,
updated in place; the per-step losses go to the block's outputs and are
fetched once at the end.  The initial
``(z, y_logits)`` are TF's default Glorot-uniform, drawn per example on the
device (:func:`rcgan_tpu_torch.core.rng.example_uniform`); a test hands in
JAX's instead (``init``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from rcgan_tpu_torch.core import rng as trng
from rcgan_tpu_torch.train.graphs import Program, StepBlock, capture_on
from rcgan_tpu_torch.utils.images import encode_png


@dataclasses.dataclass(frozen=True)
class RecoverConfig:
    batch_size: int = 500
    epochs: int = 1000
    learning_rate: float = 5.0e2
    y_dim: int = 10
    z_dim: int = 100


def initial_values(cfg: RecoverConfig, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(z [B*y, z_dim], y_logits [B, y])``, Glorot-uniform as TF's
    default initializer (``mnist/model.py:518-531``)."""
    b, y, zd = cfg.batch_size, cfg.y_dim, cfg.z_dim
    lim_y = math.sqrt(6.0 / (b + y))
    lim_z = math.sqrt(6.0 / (b * y + zd))
    y_logits = trng.example_uniform(trng.fold_in(seed, 1), b, y, device, -lim_y, lim_y)
    z = trng.example_uniform(trng.fold_in(seed, 2), b * y, zd, device, -lim_z, lim_z)
    return z, y_logits


def recover_labels(sampler: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                   images: torch.Tensor, y_actual: torch.Tensor, cfg: RecoverConfig,
                   seed: int = 7, init: Optional[Tuple] = None,
                   graphs: bool = False) -> Tuple[np.ndarray, dict]:
    """``sampler(z, y_onehot)`` is the frozen generator (BN in inference
    mode), differentiable in ``z``, run eagerly inside the step's body.
    ``images [B, H, W, C]`` and ``y_actual [B]`` (evals only) lie on the
    device the recovery runs on; ``init``, when given, is the initial ``(z,
    y_logits)``.  ``graphs``: capture the step (a card only; module doc).
    Returns the recovered labels ``[B]`` and the metrics: the ``mse`` and
    ``zero_one`` trajectories (one value per step), ``accuracy``,
    ``y_recover`` (the final softmax), ``z_recover`` and ``program``, the
    step's :meth:`~rcgan_tpu_torch.train.graphs.CapturedStep.stats`."""
    b, y_dim = cfg.batch_size, cfg.y_dim
    if images.shape[0] != b:
        raise ValueError(f"recover_labels wants {b} images; got {images.shape[0]}")
    dev = images.device
    capture = capture_on(dev, graphs)
    if init is None:
        z, y_logits = initial_values(cfg, seed, dev)
    else:
        z, y_logits = (torch.as_tensor(np.asarray(t), dtype=torch.float32).to(dev) for t in init)
    z, y_logits = z.clone().requires_grad_(True), y_logits.clone().requires_grad_(True)
    hard_y = torch.eye(y_dim, dtype=torch.float32, device=dev).repeat(b, 1)  # [B*y, y]
    imgs = images.float()[:, None]
    y_actual = y_actual.to(dev)

    def step(blk: StepBlock, state) -> None:
        gen = sampler(z, hard_y).float().reshape((b, y_dim) + tuple(imgs.shape[2:]))
        sq = torch.mean((imgs - gen) ** 2, dim=(-1, -2, -3))  # [B, y]
        loss = torch.mean(torch.sum(sq * torch.softmax(y_logits, dim=-1), dim=-1))
        gz, gy = torch.autograd.grad(loss, (z, y_logits))
        with torch.no_grad():
            z.copy_(z - cfg.learning_rate * gz)
            y_logits.copy_(y_logits - cfg.learning_rate * gy)
            blk.write("mse", loss.detach())
            blk.write("zero_one", (y_logits.argmax(-1) != y_actual).float().mean())
        blk.advance()

    prog = Program(step, {}, dev, capture,
                   {"mse": (torch.float32, ()), "zero_one": (torch.float32, ())})
    prog.run([{}] * cfg.epochs)
    out = prog.read(cfg.epochs)
    prog.captured.reset()  # the graph and its pool go; its counts and times stay
    z, y_logits = z.detach(), y_logits.detach()
    recovered = y_logits.argmax(-1).cpu().numpy()
    metrics = {
        "mse": out["mse"].cpu().numpy(),
        "zero_one": out["zero_one"].cpu().numpy(),
        "accuracy": float((recovered == y_actual.cpu().numpy()).mean()),
        "y_recover": torch.softmax(y_logits, dim=-1).cpu().numpy(),
        "z_recover": z.cpu().numpy(),
        "program": prog.captured.stats(),
    }
    return recovered, metrics


def render_wrong_image_diagnostics(sampler: Callable[[np.ndarray, np.ndarray], np.ndarray],
                                   images: np.ndarray, y_actual: np.ndarray,
                                   y_recover: np.ndarray, z_recover: np.ndarray,
                                   out_path: str, n_wrong: int = 15) -> np.ndarray:
    """The reference's wrong-image panel (``mnist/model.py:550-596``): for
    the ``n_wrong`` examples farthest from their true label in
    ``|softmax(y_recover) − onehot(y_actual)|``, one row of [true-label bar |
    real image | best reconstruction | recovered bar], written as a grey
    PNG.  ``sampler(z, y_onehot)`` takes and returns numpy.  Returns the
    panel in [0, 1]."""
    b, y_dim = y_recover.shape
    gap = np.abs(y_recover - np.eye(y_dim)[y_actual]).sum(axis=-1)
    idx = np.argsort(-gap)[:n_wrong]
    h = images.shape[1]

    def bar(probs):  # one band per class, filled in proportion to its probability
        img = np.zeros((h, 50), np.float32)
        band = max(1, h // y_dim)
        for k, p in enumerate(probs):
            img[k * band:(k + 1) * band, :int(round(p * 50))] = 1.0
        return img

    rows = []
    for i in idx:
        best_k = int(np.argmax(y_recover[i]))
        z = z_recover.reshape(b, y_dim, -1)[i, best_k][None]
        y = np.eye(y_dim, dtype=np.float32)[best_k][None]
        recon = np.asarray(sampler(z, y))[0, ..., 0]
        rows.append(np.concatenate([bar(np.eye(y_dim)[y_actual[i]]), images[i, ..., 0], recon,
                                    bar(y_recover[i])], axis=1))
    panel = np.concatenate(rows, axis=0)
    with open(out_path, "wb") as f:
        f.write(encode_png((np.clip(panel, 0, 1) * 255).astype(np.uint8)))
    return panel
