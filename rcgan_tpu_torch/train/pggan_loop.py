"""The progressive-growing GAN trainer, the counterpart of
``rcgan_tpu/train/pggan_loop.py`` (``PGGANTrainConfig``, ``pool_to_stage``,
``PGGANTrainer``).

- Every stage's parameters exist from the start (:class:`~rcgan_tpu_torch.
  models.pggan.PGGAN` builds them all), so the optimiser state keeps one
  shape through the schedule.  A layer that the phase does not call gets a
  zero gradient (``grads_of``); Adam's ``count`` is the group's, so a block
  that turns on at step N takes its first update with the bias corrections
  of N, as in JAX.
- The schedule per stage ``s``: a transition (``alpha`` from ``1/n`` to 1
  over ``trans_iters``) for ``s > 1``, then stabilization (``stab_iters``,
  ``alpha`` 1).  The full-resolution batch is average-pooled to the stage's
  resolution.
- One iteration is one D step then one G step with one ``z``, drawn from
  ``fold_in(seed, 0)`` by ``example_normal`` on the device.  The D step runs
  D on the fakes and then on the reals, each pass advancing the
  spectral-norm ``u`` and the critic's BN statistics; the G step's D pass
  runs the sn group without storing ``u`` (``update_sn`` off) and moves the
  BN statistics, as JAX's ``ctx.train`` is True there.
- ``train_progressive`` saves a checkpoint at every phase boundary and
  resumes mid-schedule from ``ts.step``: iteration ``it`` takes the seed
  ``fold_in(seed, it)`` and ``data_fn(it)``, so a resumed run repeats the
  uninterrupted one bit for bit.

JAX compiles each phase into one program; the port runs the step eagerly,
with no host sync inside it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from rcgan_tpu_torch.algorithms.losses import get_loss
from rcgan_tpu_torch.core import rng
from rcgan_tpu_torch.core.module import float32_policy, sn_updates
from rcgan_tpu_torch.models.pggan import PGGAN, PGGANConfig, sample
from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device
from rcgan_tpu_torch.train.state import (ScalelessAdam, TrainState, grads_of, init_train_state,
                                         trainable)


@dataclasses.dataclass(frozen=True)
class PGGANTrainConfig:
    lr: float = 2e-4
    beta1: float = 0.0
    beta2: float = 0.99
    trans_iters: int = 600
    stab_iters: int = 600
    loss_type: str = "HINGE"


def pool_to_stage(x: torch.Tensor, cfg: PGGANConfig, stage: int) -> torch.Tensor:
    """``[B, H, W, C]`` at full resolution → the stage's resolution by
    average pooling (H = ``base_size * 2**max_stage``)."""
    target = cfg.resolution(stage)
    factor = x.shape[1] // target
    if factor <= 1:
        return x
    b, _, _, c = x.shape
    return x.reshape(b, target, factor, target, factor, c).mean(dim=(2, 4))


def partition_predicates() -> Dict[str, Callable[[str], bool]]:
    return {"gen": lambda n: n.startswith("PG.G."), "disc": lambda n: n.startswith("PG.D.")}


class PGGANTrainer:
    """The progressive schedule over a model that holds every stage, on
    ``device``."""

    def __init__(self, cfg: PGGANConfig, base: ResnetGANConfig, tcfg: PGGANTrainConfig,
                 device="cuda", compute_dtype: torch.dtype = torch.float32):
        self.cfg, self.base, self.tcfg = cfg, base, tcfg
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        float32_policy(compute_dtype)
        self.optimizers = {g: ScalelessAdam(tcfg.beta1, tcfg.beta2) for g in ("gen", "disc")}

    def init(self, seed: int = 0) -> TrainState:
        """A train state over every stage's parameters drawn from ``seed``,
        zero Adam moments.  (JAX's ``init(rng, batch)`` traces every phase
        to create them; the port's modules create them when built.)"""
        gan = PGGAN(self.cfg, self.base, seed, self.device, self.compute_dtype)
        return init_train_state(gan, partition_predicates(), self.optimizers)

    def _to_device(self, x, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(
            self.device, dtype, non_blocking=True)

    # -------------------------------------------------------------- step
    def step(self, ts: TrainState, images: Mapping, seed: int, alpha: float, stage: int,
             trans: bool, z: Optional[torch.Tensor] = None):
        """One D and one G update at ``(stage, trans, alpha)``, in place on
        ``ts``; returns ``(ts, {"d_cost", "g_cost"})`` as device scalars.
        ``images``: ``{"x": [B, H, W, C] full-resolution float in [-1, 1],
        "labels": [B] int}``; ``z`` is drawn from ``fold_in(seed, 0)``
        unless given."""
        cfg, tcfg = self.cfg, self.tcfg
        gan = ts.gan
        x = self._to_device(images["x"], torch.float32)
        x = pool_to_stage(x, cfg, stage).to(self.compute_dtype)
        labels = self._to_device(images["labels"], torch.int64)
        d_labels = labels if cfg.conditional else None
        if z is None:
            z = rng.example_normal(rng.fold_in(seed, 0), x.shape[0], cfg.z_dim, self.device)
        else:
            z = self._to_device(z, torch.float32)

        params = ts.group_params("disc")
        with trainable(ts, ["disc"]):
            fake = gan.G(z, labels, stage, trans, alpha)
            _, d_fake = gan.D(fake, stage, trans, alpha, d_labels)
            _, d_real = gan.D(x, stage, trans, alpha, d_labels)
            _, d_cost = get_loss(d_real, d_fake, tcfg.loss_type)
            grads = grads_of(d_cost, params)
        self.optimizers["disc"].update_(params, grads, ts.opt_states["disc"], tcfg.lr)

        params = ts.group_params("gen")
        with trainable(ts, ["gen"]), sn_updates(gan.D, False):
            fake = gan.G(z, labels, stage, trans, alpha)
            _, d_fake = gan.D(fake, stage, trans, alpha, d_labels)
            g_cost, _ = get_loss(torch.zeros_like(d_fake), d_fake, tcfg.loss_type)
            grads = grads_of(g_cost, params)
        self.optimizers["gen"].update_(params, grads, ts.opt_states["gen"], tcfg.lr)
        ts.step += 1
        return ts, {"d_cost": d_cost.detach(), "g_cost": g_cost.detach()}

    # ---------------------------------------------------------- schedule
    def phases(self):
        """``(stage, trans, n_iters)`` in PGGAN order."""
        for stage in range(1, self.cfg.max_stage + 1):
            if stage > 1:
                yield stage, True, self.tcfg.trans_iters
            yield stage, False, self.tcfg.stab_iters

    def train_progressive(self, ts: TrainState, data_fn, seed: int, log_fn=None,
                          iters_scale: float = 1.0, progress_every: int = 0,
                          progress_fn=None, ckpt=None, clock=None) -> TrainState:
        """Run the schedule from ``ts.step``.  ``data_fn(it)`` gives
        iteration ``it``'s batch (``step``'s ``images``); ``log_fn(stage,
        trans, it, metrics, ts)`` is called at the end of each phase that
        stepped, ``progress_fn(stage, trans, it, alpha, metrics, ts)`` every
        ``progress_every`` iterations within a phase (both read the metrics
        back to the host).  ``ckpt`` (a :class:`~rcgan_tpu_torch.train.
        checkpoint.Checkpointer`) saves ``ts`` at every phase boundary and
        waits for the write; ``clock`` (a :class:`~rcgan_tpu_torch.utils.
        profiling.PhaseClock`) gets each save's host seconds as
        ``"checkpoint_save"``."""
        start = int(ts.step)
        it = 0
        for stage, trans, n in self.phases():
            n = max(1, int(n * iters_scale))
            if it + n <= start:  # a phase the restored state has done
                it += n
                continue
            stepped = False
            m = None
            for i in range(n):
                if it < start:  # a partial phase: on to the next iteration
                    it += 1
                    continue
                alpha = (i + 1) / n if trans else 1.0
                ts, m = self.step(ts, data_fn(it), rng.fold_in(seed, it), alpha, stage, trans)
                it += 1
                stepped = True
                if progress_every and progress_fn is not None and i % progress_every == 0:
                    progress_fn(stage, trans, it, alpha, {k: float(v) for k, v in m.items()}, ts)
            if log_fn is not None and stepped:
                log_fn(stage, trans, it, {k: float(v) for k, v in m.items()}, ts)
            if ckpt is not None and stepped:
                t = time.perf_counter()
                ckpt.save(it, ts, wait=True)
                if clock is not None:
                    clock.add("checkpoint_save", time.perf_counter() - t)
        return ts

    # ------------------------------------------------------------ sample
    def sample(self, ts: TrainState, z, labels, stage: Optional[int] = None) -> torch.Tensor:
        """Images at ``stage`` (default the last), float32 NHWC on the
        device; no state moves."""
        return sample(ts.gan.G, self._to_device(z, torch.float32),
                      self._to_device(labels, torch.int64), stage)
