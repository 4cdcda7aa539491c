"""The MNIST training step, the counterpart of
``rcgan_tpu/train/mnist_loop.py`` (``MnistTrainConfig``, ``MnistTrainer``;
reference hot loop ``mnist/model.py:335-467``).

One iteration is one D update, then ``g_steps`` (2) G updates, each with
the C update of RCGAN-U, all with the same ``z``:

- the D step minimises ``d_loss + class_loss_real`` over the ``disc``
  group (D and the perm classifier), then clips the max-norm linears
  (``apply_constraints`` with the constraints the layers register, after
  the D update only);
- each G step runs the losses with ``g_step_only`` and minimises
  ``g_loss + perm_multiplier * class_loss_fake`` over ``gen``; the
  confusion logits take the same gradient (``class_loss_fake`` does not
  reach them), at ``lr * confuse_multiplier``.

The state moves as JAX moves it: G's BN statistics in the D step and in
each G step (G runs in train mode inside the losses), D's BN statistics
and spectral-norm ``u`` on every D pass.  The real and fake D passes are
never concatenated: each must see its own batch moments.

JAX compiles the iteration (and ``step_scan``'s blocks) into one program;
the port runs it eagerly with no host sync inside a step (no ``.item()``,
no branch on a device value; ``z`` drawn on the device by
:func:`rcgan_tpu_torch.core.rng.example_uniform`).  Each step takes
gradients with ``torch.autograd.grad`` with respect to the groups it
updates, the others frozen (``train/state.py::trainable``): the D step runs
no backward through G.

Data parallelism (JAX's ``mesh``) is a
:class:`~rcgan_tpu_torch.parallel.mesh.DataGroup` (``group=``), one process
per rank, as ``rcgan_tpu/train/mnist_loop.py:83-202`` under ``shard_map``:
every rank takes the global batch and runs on its contiguous rows, ``z`` is
drawn for those rows by their **global** index, the gradients and the
state (BN moving statistics, SN ``u``) are meaned over the ranks after the
D step's backward and after each G step's, before the update, and the
max-norm clip after the D update runs on every rank.  The scalar metrics
are meaned; ``prob_real`` and ``prob_fake`` are gathered to the global
batch in rank order.  Batch norms take their moments per rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from rcgan_tpu_torch.algorithms.mnist import (MnistAlgoConfig, MnistGAN, mnist_losses,
                                              partition_predicates)
from rcgan_tpu_torch.core import rng
from rcgan_tpu_torch.core.module import float32_policy
from rcgan_tpu_torch.models.dcgan import DCGANConfig, sample
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device
from rcgan_tpu_torch.parallel.mesh import DataGroup, check_group
from rcgan_tpu_torch.train.state import (ScalelessAdam, TrainState, apply_constraints,
                                         constraints_of, grads_of, init_train_state,
                                         mean_over_ranks, trainable)

BATCH_KEYS = ("images", "y_real", "y_gen", "y_fake", "y_real_weights")
PER_EXAMPLE = ("prob_real", "prob_fake")  # metrics gathered over the ranks, not meaned


@dataclasses.dataclass(frozen=True)
class MnistTrainConfig:
    learning_rate: float = 2e-4
    beta1: float = 0.5
    confuse_multiplier: float = 10.0
    perm_multiplier: float = 10.0
    g_steps: int = 2  # mnist/model.py:359-372: 1 D step then 2 G steps


def optimizers(tcfg: MnistTrainConfig) -> Dict[str, ScalelessAdam]:
    """One scaleless Adam (β = (beta1, 0.999)) per group, as JAX's
    ``MnistTrainer`` builds them."""
    return {g: ScalelessAdam(tcfg.beta1, 0.999) for g in ("disc", "gen", "confusion")}


def new_train_state(cfg: DCGANConfig, acfg: MnistAlgoConfig, tcfg: MnistTrainConfig,
                    seed: int = 0, device="cuda",
                    compute_dtype: torch.dtype = torch.float32) -> TrainState:
    """An :class:`MnistGAN` drawn from ``seed`` on ``device``, its
    parameters split into the optimiser groups as JAX's ``init`` splits
    them (``confusion`` only for a learned C), with zero Adam moments."""
    preds = partition_predicates()
    if not acfg.estimate_confuse:
        preds.pop("confusion")
    gan = MnistGAN(cfg, acfg, seed, device, compute_dtype)
    return init_train_state(gan, preds, optimizers(tcfg))


class MnistTrainer:
    """Builds the train state and runs the iteration on ``device``, or on
    the device of ``group``, the data-parallel group this rank belongs to
    (JAX's ``mesh``)."""

    def __init__(self, cfg: DCGANConfig, acfg: MnistAlgoConfig, tcfg: MnistTrainConfig,
                 confusion_actual: np.ndarray, group: Optional[DataGroup] = None,
                 device="cuda", compute_dtype: torch.dtype = torch.float32):
        self.cfg, self.acfg, self.tcfg = cfg, acfg, tcfg
        self.group = check_group(group, device)
        self.device = group.device if group is not None else resolve_device(device)
        self.compute_dtype = compute_dtype
        float32_policy(compute_dtype)
        self.confusion_actual = torch.as_tensor(np.asarray(confusion_actual, np.float32),
                                                device=self.device)
        self.optimizers = optimizers(tcfg)

    def init(self, seed: int = 0) -> TrainState:
        """A fresh train state with parameters drawn from ``seed``.  (JAX's
        ``init(rng, sample_batch)`` traces the losses to create the
        parameters; the port's modules create them when built.)"""
        return new_train_state(self.cfg, self.acfg, self.tcfg, seed, self.device,
                               self.compute_dtype)

    # ------------------------------------------------------------ inputs
    def _to_device(self, x, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(
            self.device, dtype, non_blocking=True)

    def batch_to_device(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """A batch as the losses take it: float32 images and weights, int64
        labels."""
        out = {k: self._to_device(batch[k], torch.int64) for k in ("y_real", "y_gen", "y_fake")}
        for k in ("images", "y_real_weights"):
            out[k] = self._to_device(batch[k], torch.float32)
        return out

    # -------------------------------------------------------------- step
    def step(self, ts: TrainState, batch: Mapping, seed: int,
             z: Optional[torch.Tensor] = None):
        """One reference iteration in place on ``ts``; returns ``(ts,
        metrics)``.  ``z [B, z_dim]`` in U[-1, 1), shared by the D step and
        the G steps, is drawn from ``fold_in(seed, 0)`` unless given.
        Metrics are device tensors: the D step's ``d_loss``, ``d_loss_real``,
        ``d_loss_fake``, ``class_loss_real`` and ``prob_real [B]``; the last
        G step's ``g_loss``, ``class_loss_fake``, ``prob_fake [B]`` and
        ``confusion``.  With a group, ``batch`` and ``z`` are the global ones
        (every rank is given the same) and the rank runs on its rows; the
        metrics are meaned over the ranks, the ``[B]`` ones gathered."""
        cfg, tcfg = self.cfg, self.tcfg
        lr = tcfg.learning_rate
        batch = self.batch_to_device({k: self._rows(batch[k]) for k in BATCH_KEYS})
        b = batch["images"].shape[0]  # this rank's rows
        rank = 0 if self.group is None else self.group.rank
        if z is None:
            z = rng.example_uniform(rng.fold_in(seed, 0), b, cfg.z_dim, self.device, -1.0, 1.0,
                                    first_index=rank * b)
        else:
            z = self._to_device(self._rows(z), torch.float32)

        # ---- D update: d_loss + 1 * class_loss_real over the d_ variables
        params = ts.group_params("disc")
        with trainable(ts, ["disc"]):
            d_out = mnist_losses(ts.gan, batch, z, self.confusion_actual)
            grads = grads_of(d_out["d_loss"] + 1.0 * d_out["class_loss_real"], params)
        mean_over_ranks(self.group, grads, ts)
        self.optimizers["disc"].update_(params, grads, ts.opt_states["disc"], lr)
        apply_constraints(ts.groups["disc"], constraints_of(ts.gan))

        # ---- G (+C) updates: g_loss + perm_multiplier * class_loss_fake
        names = [g for g in ("gen", "confusion") if g in ts.groups]
        params = [p for g in names for p in ts.group_params(g)]
        g_out = None
        for _ in range(tcfg.g_steps):
            with trainable(ts, names):
                g_out = mnist_losses(ts.gan, batch, z, self.confusion_actual, g_step_only=True)
                grads = grads_of(g_out["g_loss"] + tcfg.perm_multiplier
                                 * g_out["class_loss_fake"], params)
            mean_over_ranks(self.group, grads, ts)
            n = 0
            for g in names:
                ps = ts.group_params(g)
                self.optimizers[g].update_(ps, grads[n:n + len(ps)], ts.opt_states[g],
                                           lr if g == "gen" else lr * tcfg.confuse_multiplier)
                n += len(ps)
        ts.step += 1

        metrics = {k: d_out[k].detach() for k in ("d_loss", "d_loss_real", "d_loss_fake",
                                                  "class_loss_real")}
        metrics.update({k: g_out[k].detach() for k in ("g_loss", "class_loss_fake",
                                                       "confusion")})
        metrics["prob_real"] = d_out["D"].detach().float()
        metrics["prob_fake"] = g_out["D_"].detach().float()
        if self.group is not None:
            # pmean of the scalars (and C), out_specs P('data') of the probs
            metrics = {k: v.clone() for k, v in metrics.items()}
            self.group.mean_([v for k, v in metrics.items() if k not in PER_EXAMPLE])
            for k in PER_EXAMPLE:
                metrics[k] = self.group.gather_rows(metrics[k])
        return ts, metrics

    def _rows(self, x):
        """This rank's rows of a global batch (all of them without a group)."""
        return x if self.group is None else x[self.group.local_rows(x.shape[0])]

    def step_scan(self, ts: TrainState, dataset: Mapping[str, torch.Tensor], idx, seed: int):
        """``len(idx)`` iterations over ``dataset`` (device tensors keyed by
        :data:`BATCH_KEYS`, the whole split resident on the device), batch
        ``j`` gathered on the device from ``idx [K, B]``; iteration ``j``
        takes the seed ``fold_in(seed, ts.step)``, as JAX's ``step_scan``
        keys it.  Metrics come back stacked ``[K, ...]``.  One device only:
        a group steps iteration by iteration (:meth:`step`), as JAX's mesh
        path does."""
        if self.group is not None:
            raise ValueError("step_scan runs on one device; with a group, call step per "
                             "iteration")
        if set(dataset) != set(BATCH_KEYS):
            raise ValueError(f"dataset must hold {BATCH_KEYS}; got {sorted(dataset)}")
        idx = self._to_device(idx, torch.int64)
        ms = []
        for j in range(idx.shape[0]):
            ts, m = self.step(ts, {k: v[idx[j]] for k, v in dataset.items()},
                              rng.fold_in(seed, ts.step))
            ms.append(m)
        return ts, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    # ------------------------------------------------------------ sample
    def sample(self, ts: TrainState, z, y_onehot) -> torch.Tensor:
        """The reference's ``gen_sampler``: G with BN in inference mode,
        float32 ``[B, H, W, c_dim]`` on the device."""
        return sample(ts.gan.G, self._to_device(z, torch.float32),
                      self._to_device(y_onehot, torch.float32))


def dataset_to_device(data, n: int, device) -> Dict[str, torch.Tensor]:
    """The first ``n`` examples of an ``MnistData`` as device tensors keyed
    by :data:`BATCH_KEYS` (float32 images and weights, int64 labels), for
    :meth:`MnistTrainer.step_scan`."""
    dev = resolve_device(device)
    out = {k: torch.as_tensor(np.asarray(getattr(data, k)[:n])).to(dev, torch.int64)
           for k in ("y_real", "y_gen", "y_fake")}
    out["images"] = torch.as_tensor(np.asarray(data.x[:n], np.float32)).to(dev)
    out["y_real_weights"] = torch.as_tensor(
        np.asarray(data.y_real_weights[:n], np.float32)).to(dev)
    return out
