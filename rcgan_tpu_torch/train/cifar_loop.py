"""The CIFAR-10 training cycle, the counterpart of
``rcgan_tpu/train/cifar_loop.py`` (``CifarTrainConfig``, ``CifarTrainer``).

One cycle is one G step (plus the C step of rcgan-u), skipped at iteration
0, then ``n_critic`` D steps, each on its own micro-batch, as JAX's
``_cycle``.  JAX compiles the cycle into one program; the port runs it
eagerly, with no host sync inside :meth:`CifarTrainer.step` (no ``.item()``,
no Python branch on a device value, seeds derived on the host by
:mod:`rcgan_tpu_torch.core.rng`), so that a later change can capture it in
a CUDA graph.

Each step takes gradients with ``torch.autograd.grad`` with respect to the
groups it updates, with every other group frozen
(:func:`~rcgan_tpu_torch.train.state.trainable`): the G step backpropagates
through D without D's weight grads, and a D step runs no backward through
G, as XLA drops both as dead code in JAX's cycle.

Data parallelism (JAX's ``mesh``) is a
:class:`~rcgan_tpu_torch.parallel.mesh.DataGroup` (``group=``), one process
per rank.  Every rank builds the same parameters from the same seed and
takes the global batches; it runs the cycle on its contiguous rows of the
index batches ``[n_critic, B]`` and of the generator labels, and draws
``z``, ``zg`` and the dequantisation noise for those rows by their
**global** index, so the layout does not change the noise.  Each step means
its gradients and the state (SN ``u``) over the ranks in one
``all_reduce`` before its update, as ``pavg`` does at
``rcgan_tpu/train/cifar_loop.py:167-168,236-237``; the cycle's costs are
meaned at its end.  Batch norms take their moments per rank, as under
``shard_map``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from rcgan_tpu_torch.algorithms.cifar import (CifarAlgoConfig, CifarGAN, lr_decay,
                                              partition_predicates)
from rcgan_tpu_torch.core import rng
from rcgan_tpu_torch.core.module import float32_policy, sn_updates
from rcgan_tpu_torch.data.cifar10 import (DATASET_KEYS, dequantize_chw_to_hwc,
                                          dequantize_chw_to_hwc_seeded)
from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig, sample
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device
from rcgan_tpu_torch.parallel.mesh import DataGroup, check_group
from rcgan_tpu_torch.train.state import (ScalelessAdam, TrainState, grads_of,
                                         init_train_state, mean_over_ranks, trainable)


@dataclasses.dataclass(frozen=True)
class CifarTrainConfig:
    lr: float = 2e-4
    beta1: float = 0.0
    beta2: float = 0.9
    n_critic: int = 5
    gen_bs_multiple: int = 2
    decay: bool = True
    confuse_multiplier: float = 1.0
    confuse_lr_decay: bool = False
    # Adam moments stored in a narrower dtype ("bfloat16"); None: float32
    moment_dtype: Optional[str] = None


def optimizers(tcfg: CifarTrainConfig) -> Dict[str, ScalelessAdam]:
    """One scaleless Adam per group, as JAX's ``CifarTrainer`` builds them."""
    return {g: ScalelessAdam(tcfg.beta1, tcfg.beta2, moment_dtype=tcfg.moment_dtype)
            for g in ("disc", "gen", "confusion")}


def new_train_state(cfg: ResnetGANConfig, acfg: CifarAlgoConfig, tcfg: CifarTrainConfig,
                    seed: int = 0, device="cuda",
                    compute_dtype: torch.dtype = torch.float32) -> TrainState:
    """A :class:`CifarGAN` drawn from ``seed`` on ``device``, its parameters
    split into the optimiser groups (``confusion`` for rcgan-u only) with
    zero Adam moments."""
    preds = partition_predicates()
    if acfg.algorithm != "rcgan-u":
        preds.pop("confusion")
    gan = CifarGAN(cfg, acfg, seed, device, compute_dtype)
    return init_train_state(gan, preds, optimizers(tcfg))


class CifarTrainer:
    """Builds the train state and runs the cycle on ``device``.

    ``device_dataset``: the dataset resident on the device, as
    :func:`rcgan_tpu_torch.data.cifar10.device_dataset_of` returns it; the
    cycle then takes index batches and gathers on the device.  ``group``:
    the data-parallel group this rank belongs to (JAX's ``mesh``); the
    trainer then runs on the group's device."""

    def __init__(self, cfg: ResnetGANConfig, acfg: CifarAlgoConfig, tcfg: CifarTrainConfig,
                 confusion_actual: np.ndarray, device="cuda",
                 compute_dtype: torch.dtype = torch.float32,
                 device_dataset: Optional[Dict[str, torch.Tensor]] = None,
                 group: Optional[DataGroup] = None):
        self.cfg, self.acfg, self.tcfg = cfg, acfg, tcfg
        self.group = check_group(group, device)
        self.device = group.device if group is not None else resolve_device(device)
        self.compute_dtype = compute_dtype
        float32_policy(compute_dtype)
        self.confusion_actual = torch.as_tensor(np.asarray(confusion_actual, np.float32),
                                                device=self.device)
        if device_dataset is not None and (
                set(device_dataset) != set(DATASET_KEYS)
                or any(v.device.type != self.device.type for v in device_dataset.values())):
            raise ValueError(f"device_dataset must hold {DATASET_KEYS} on {self.device}")
        self.device_dataset = device_dataset
        self.optimizers = optimizers(tcfg)

    def init(self, seed: int = 0) -> TrainState:
        """A fresh train state with parameters drawn from ``seed``.  (JAX's
        ``init(rng, batch_size)`` traces the losses at a batch size to create
        the parameters; the port's modules create them when built.)"""
        return new_train_state(self.cfg, self.acfg, self.tcfg, seed, self.device,
                               self.compute_dtype)

    # ------------------------------------------------------------ inputs
    def _to_device(self, x, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(
            self.device, dtype, non_blocking=True)

    def _batch_to_device(self, src: Mapping) -> Dict[str, torch.Tensor]:
        """The dataset's arrays as device tensors: uint8 images, int64 labels
        (as the loss and the cond-BN backward index with them), float32
        inverse weights."""
        out = {"images": self._to_device(src["images"], torch.uint8),
               "labels_inv_weights": self._to_device(src["labels_inv_weights"], torch.float32)}
        for k in ("labels", "labels_random", "labels_biased"):
            out[k] = self._to_device(src[k], torch.int64)
        return out

    def _rows(self, x, dim: int):
        """This rank's rows of a global batch along ``dim`` (all of them
        without a group)."""
        if self.group is None:
            return x
        sl = self.group.local_rows(x.shape[dim])
        return x[sl] if dim == 0 else x[:, sl]

    def _d_batches(self, d_batches: Mapping) -> Dict[str, torch.Tensor]:
        """``[n_critic, B, ...]`` device tensors of this rank's rows:
        gathered from the resident dataset for ``{"index": ...}``, else moved
        from the host."""
        d_batches = {k: self._rows(v, 1) for k, v in d_batches.items()}
        if "index" in d_batches:
            if self.device_dataset is None:
                raise ValueError("index batches need the trainer's device_dataset")
            idx = self._to_device(d_batches["index"], torch.int64)
            d_batches = {k: v[idx] for k, v in self.device_dataset.items()}
        out = self._batch_to_device(d_batches)
        if out["images"].shape[0] != self.tcfg.n_critic:
            raise ValueError(f"d_batches need a leading dim of n_critic={self.tcfg.n_critic}; "
                             f"got {tuple(out['images'].shape)}")
        return out

    # ------------------------------------------------------------- steps
    def _g_step(self, ts: TrainState, g_random, g_biased, zg, lr: float,
                confuse_lr: float) -> torch.Tensor:
        names = [g for g in ("gen", "confusion") if g in ts.groups]
        params = [p for g in names for p in ts.group_params(g)]
        with trainable(ts, names):
            out = ts.gan.gen_loss(g_random, g_biased, zg, self.confusion_actual)
            grads = grads_of(out["gen_cost"], params)
        mean_over_ranks(self.group, grads, ts)
        n = 0
        for g in names:
            ps = ts.group_params(g)
            self.optimizers[g].update_(ps, grads[n:n + len(ps)], ts.opt_states[g],
                                       lr if g == "gen" else confuse_lr)
            n += len(ps)
        return out["gen_cost"].detach()

    def _d_step(self, ts: TrainState, batch: dict, real: torch.Tensor, z: torch.Tensor,
                lr: float) -> torch.Tensor:
        sb = {"real_data": real, "labels": batch["labels"],
              "labels_random": batch["labels_random"], "labels_biased": batch["labels_biased"],
              "labels_inv_weights": batch["labels_inv_weights"]}
        params = ts.group_params("disc")
        with trainable(ts, ["disc"]):
            out = ts.gan.disc_loss(sb, z, self.confusion_actual)
            grads = grads_of(out["disc_cost"], params)
        mean_over_ranks(self.group, grads, ts)
        self.optimizers["disc"].update_(params, grads, ts.opt_states["disc"], lr)
        return out["disc_cost"].detach()

    def step(self, ts: TrainState, d_batches: Mapping, g_labels: Mapping, iteration: int,
             seed: int, noise: Optional[Mapping] = None):
        """One cycle, in place on ``ts``; returns ``(ts, metrics)``.

        ``d_batches``: ``[n_critic, B, ...]`` arrays (``images`` uint8
        CHW-flat, ``labels``, ``labels_random``, ``labels_biased``,
        ``labels_inv_weights``), or ``{"index": [n_critic, B]}`` into the
        device dataset.  ``g_labels``: ``{"random", "biased"}``
        ``[gen_bs_multiple * B]``.  ``iteration`` is a host int (0 skips the
        G and C steps); ``seed`` keys the cycle's noise.  ``noise``, when
        given, replaces that noise: ``zg [gen_bs_multiple*B, z_dim]``,
        ``z [n_critic, B, z_dim]`` and the dequantisation ``u
        [n_critic, B, 3072]`` (CHW order).  Metrics are device tensors:
        ``d_cost`` (the last critic step's), ``d_cost_mean``, ``g_cost``,
        ``lr``.  With a group, the batches, labels and ``noise`` are the
        global ones (every rank is given the same), the rank runs on its
        rows, and the costs are meaned over the ranks."""
        cfg, tcfg = self.cfg, self.tcfg
        decay = float(lr_decay(iteration, tcfg.decay))
        lr = tcfg.lr * decay
        confuse_lr = tcfg.lr * tcfg.confuse_multiplier * (decay if tcfg.confuse_lr_decay else 1.0)
        batches = self._d_batches(d_batches)
        b = batches["labels"].shape[1]  # this rank's rows
        world, rank = (1, 0) if self.group is None else (self.group.world_size, self.group.rank)
        gb = tcfg.gen_bs_multiple * b
        if tuple(np.shape(g_labels["random"])) != (gb * world,):
            raise ValueError(f"g_labels must be [gen_bs_multiple * B] = [{gb * world}]; got "
                             f"{tuple(np.shape(g_labels['random']))}")
        g_random = self._to_device(self._rows(g_labels["random"], 0), torch.int64)
        g_biased = self._to_device(self._rows(g_labels["biased"], 0), torch.int64)
        seeds = rng.cycle_seeds(seed, tcfg.n_critic, b, start=rank * b)
        if noise is not None:
            noise = {k: self._to_device(self._rows(noise[k], 0 if k == "zg" else 1),
                                        torch.float32) for k in ("zg", "z", "u")}
        else:
            q_seeds = torch.from_numpy(seeds.dequant).to(self.device, non_blocking=True)

        if iteration > 0:
            zg = noise["zg"] if noise else rng.example_normal(seeds.g_z, gb, cfg.z_dim,
                                                              self.device, rank * gb)
            g_cost = self._g_step(ts, g_random, g_biased, zg, lr, confuse_lr)
        else:  # the reference skips the G step at iteration 0
            g_cost = torch.zeros((), device=self.device)

        d_costs = []
        for k in range(tcfg.n_critic):
            batch = {key: v[k] for key, v in batches.items()}
            if noise:
                real = dequantize_chw_to_hwc(batch["images"], noise["u"][k], cfg.img_size,
                                             cfg.img_dim)
                z = noise["z"][k]
            else:
                real = dequantize_chw_to_hwc_seeded(batch["images"], q_seeds[k], cfg.img_size,
                                                    cfg.img_dim)
                z = rng.example_normal(seeds.d_z[k], b, cfg.z_dim, self.device, rank * b)
            d_costs.append(self._d_step(ts, batch, real, z, lr))
        ts.step += 1
        d_costs = torch.stack(d_costs)
        costs = torch.stack([d_costs[-1], d_costs.mean(), g_cost])
        if self.group is not None:
            self.group.mean_([costs])
        metrics = {"d_cost": costs[0], "d_cost_mean": costs[1], "g_cost": costs[2],
                   "lr": torch.full((), lr, device=self.device)}
        return ts, metrics

    def step_scan(self, ts: TrainState, idx, g_random, g_biased, seed: int):
        """``len(idx)`` cycles over the device dataset: ``idx [K, n_critic,
        B]``, ``g_random``/``g_biased`` ``[K, gen_bs_multiple * B]``.  Cycle
        ``j`` runs at iteration ``ts.step`` with the seed
        ``fold_in(seed, ts.step)``, as JAX's ``step_scan`` keys it.  Metrics
        come back stacked ``[K]``.  One device only: a group steps cycle by
        cycle (:meth:`step`), as JAX's mesh path does."""
        if self.group is not None:
            raise ValueError("step_scan runs on one device; with a group, call step per cycle")
        if self.device_dataset is None:
            raise ValueError("step_scan needs the trainer's device_dataset")
        ms = []
        for j in range(len(idx)):
            ts, m = self.step(ts, {"index": idx[j]},
                              {"random": g_random[j], "biased": g_biased[j]},
                              ts.step, rng.fold_in(seed, ts.step))
            ms.append(m)
        return ts, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    @torch.no_grad()
    def eval_disc_cost(self, ts: TrainState, batch: Mapping, seed: int,
                       noise: Optional[Mapping] = None) -> torch.Tensor:
        """The discriminator cost on a held-out ``batch`` (``images`` uint8
        ``[B, 3072]`` and the labels), with no SN update and no parameter
        update (the dev cost of ``gan_resnet.py:976-989``).  ``noise``, when
        given, supplies ``z [B, z_dim]`` and ``u [B, 3072]``."""
        return self._disc_cost(ts, self._batch_to_device(batch), seed, noise)

    def _disc_cost(self, ts: TrainState, sb: Dict[str, torch.Tensor], seed: int,
                   noise: Optional[Mapping]) -> torch.Tensor:
        cfg = self.cfg
        b = sb["labels"].shape[0]
        if noise is not None:
            real = dequantize_chw_to_hwc(sb["images"], self._to_device(noise["u"], torch.float32),
                                         cfg.img_size, cfg.img_dim)
            z = self._to_device(noise["z"], torch.float32)
        else:
            seeds = torch.from_numpy(rng.example_seeds(rng.fold_in(seed, 1), b)).to(self.device)
            real = dequantize_chw_to_hwc_seeded(sb["images"], seeds, cfg.img_size, cfg.img_dim)
            z = rng.example_normal(rng.fold_in(seed, 0), b, cfg.z_dim, self.device)
        sb = dict(sb, real_data=real)
        with sn_updates(ts.gan, False):
            return ts.gan.disc_loss(sb, z, self.confusion_actual)["disc_cost"]

    @torch.no_grad()
    def eval_disc_cost_scan(self, ts: TrainState, dataset: Mapping[str, torch.Tensor], idx,
                            seed: int, noise: Optional[Mapping] = None) -> torch.Tensor:
        """The mean discriminator cost over ``idx [K, B]`` index batches of a
        split resident on the device (``dataset`` as
        :func:`~rcgan_tpu_torch.data.cifar10.device_dataset_of` returns it),
        each batch gathered on the device and keyed by
        ``fold_in(seed, k)``; no SN or parameter update (JAX's
        ``eval_disc_cost_scan``).  ``noise``, when given, supplies ``z [K,
        B, z_dim]`` and ``u [K, B, 3072]``.  Returns a device scalar."""
        idx = self._to_device(idx, torch.int64)
        costs = []
        for k in range(idx.shape[0]):
            sb = self._batch_to_device({key: v[idx[k]] for key, v in dataset.items()})
            nk = None if noise is None else {"z": noise["z"][k], "u": noise["u"][k]}
            costs.append(self._disc_cost(ts, sb, rng.fold_in(seed, k), nk))
        return torch.stack(costs).mean()

    def sample(self, ts: TrainState, z, labels) -> torch.Tensor:
        """The generator forward for evals and sample grids, float32 ``[B,
        output_dim]`` on the device: cond-BN with batch statistics, as the
        reference (``normalization.py:47-58``), in the trainer's compute
        dtype."""
        return sample(ts.gan.G, self._to_device(z, torch.float32),
                      self._to_device(labels, torch.int64))

