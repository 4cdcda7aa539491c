"""The CIFAR-10 training cycle, the counterpart of
``rcgan_tpu/train/cifar_loop.py`` (``CifarTrainConfig``, ``CifarTrainer``).

One cycle is one G step (plus the C step of rcgan-u), skipped at iteration
0, then ``n_critic`` D steps, each on its own micro-batch, as JAX's
``_cycle``.  JAX compiles the cycle into one program; the port runs it
eagerly on the CPU and with a gloo group; on a card, alone or in an NCCL
group, it captures the cycle into a CUDA graph once and replays it
(``train/graphs.py``), the counterpart of ``_jitted_cycle`` (with a group,
of its ``shard_map`` branch), and :meth:`CifarTrainer.step_scan` replays
it once per row of a block, the counterpart of ``_jitted_scan``.  Both paths run one
body, :meth:`CifarTrainer._cycle`, which reads only device tensors: a host
part (:meth:`CifarTrainer._cycle_row`) derives the learning rates, Adam's
bias corrections and every seed (by :mod:`rcgan_tpu_torch.core.rng`) and
packs them with the batch into the cycle's row of a
:class:`~rcgan_tpu_torch.train.graphs.StepBlock`; the cycle at iteration 0,
which has no G step, runs eagerly.  The dev cost (``eval_disc_cost``,
``eval_disc_cost_scan``: JAX's jitted cost and its ``lax.scan``) is one
body over rows of a block of its own, :meth:`CifarTrainer._dev_cost`, and
``sample`` one pass per batch size, each captured on a card in a graph and
pool of its own, so that an eval leaves the cycle's graph in place.

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
``shard_map``.  In an NCCL group each rank captures its own graph of the
same collectives in the same order.

GSPMD (JAX's ``gspmd_cycle``: the single-program cycle partitioned over a
``('data', 'model')`` mesh) runs the same body on DTensors with no group:
:func:`rcgan_tpu_torch.parallel.gspmd.gspmd_cycle` sets :attr:`CifarTrainer.mesh`
while its step runs, and the noise of the global batch is then drawn by
each rank for its rows of the mesh's data axis, by global row, and sharded
there.

Spans (:mod:`rcgan_tpu_torch.utils.profiling`, in the cycle program's
``captured.spans``): the host part of :meth:`CifarTrainer.step_scan` and
:meth:`CifarTrainer.step` is timed as ``rows`` (the cycles' rows), then by
the program (``train/graphs.py::Program``) as ``key`` (the state's
addresses), ``load`` (the block's copy), ``launch`` (the cycles run or
replayed) and ``read`` (the metrics); the cycle marks its
device phases: ``d.input`` (the rows read, the index gather, each critic
step's dequantisation and ``z``), ``g.input`` (``zg``), ``g.forward`` and
``d.forward`` (up to the gradients), ``g.backward`` and ``d.backward``
(autograd), ``g.update`` and ``d.update`` (the mean over the ranks, Adam,
and after the last critic step the state copies and the metrics), then
``between`` until the next cycle.  rcgan-u's confusion step is inside the
G step's spans.
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
from rcgan_tpu_torch.parallel.gspmd import data_rows
from rcgan_tpu_torch.parallel.mesh import DataGroup, check_group
from rcgan_tpu_torch.train.graphs import Passes, Program, StepBlock, capture_on
from rcgan_tpu_torch.train.state import (ScalelessAdam, TrainState, grads_of,
                                         init_train_state, mean_over_ranks, state_in_place,
                                         train_state_key, trainable)
from rcgan_tpu_torch.utils.profiling import mark


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
    # the critic's learning rate where it differs from ``lr`` (G's), as
    # BigGAN's two time-scales; decayed as ``lr`` is
    d_lr: Optional[float] = None


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
    trainer then runs on the group's device.  ``graphs``: capture the cycle
    into a CUDA graph and replay it (``train/graphs.py``); by default on a
    CUDA device, alone or in an NCCL group, as JAX always jits its cycle.
    ``False`` runs the same body eagerly there (to compare); the CPU and a
    gloo group run it eagerly, and asking them for graphs raises."""

    def __init__(self, cfg: ResnetGANConfig, acfg: CifarAlgoConfig, tcfg: CifarTrainConfig,
                 confusion_actual: np.ndarray, device="cuda",
                 compute_dtype: torch.dtype = torch.float32,
                 device_dataset: Optional[Dict[str, torch.Tensor]] = None,
                 group: Optional[DataGroup] = None, graphs: Optional[bool] = None):
        self.cfg, self.acfg, self.tcfg = cfg, acfg, tcfg
        self.group = check_group(group, device)
        self.device = group.device if group is not None else resolve_device(device)
        self.graphs = capture_on(self.device, graphs, self.group)
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
        # the DeviceMesh of a GSPMD step while it runs (parallel/gspmd.py),
        # with confusion_actual a replicated DTensor on it
        self.mesh = None
        # the cycle over the rows of its block, and the evals' programs, each in
        # a graph and pool of its own (one device: with a group the evals run
        # on the main rank, and have no collective)
        self.program = Program(lambda blk, ts: self._cycle(blk, ts, not self.program.eager_row),
                               self._DTYPES, self.device, self.graphs,
                               {m: (torch.float32, ()) for m in self.METRICS}, self.group)
        self.dev_program = Program(self._dev_cost, self._DTYPES, self.device, self.graphs,
                                   {"cost": (torch.float32, ())})
        self._samples = Passes(self._sample_pass, {"z": torch.float32, "labels": torch.int64},
                               self.device, self.graphs)

    @property
    def captured(self):
        """The cycle program's step: its graph, its counters and its spans."""
        return self.program.captured

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

    def _host(self, x) -> np.ndarray:
        return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    def _cycle_row(self, ts: TrainState, d_batches: Mapping, g_labels: Mapping,
                   iteration: int, seed: int, noise: Optional[Mapping]) -> Dict[str, np.ndarray]:
        """The host part of one cycle: checks the shapes, derives the
        learning rates and the seeds, advances the Adam counts the cycle's
        updates take, and returns the cycle's row of the block (this rank's
        rows of the batches): ``adam [2 + n_critic, 5]`` (:meth:`ScalelessAdam.scalars`
        of the G step, the C step and each critic step), ``z_base [1 +
        n_critic]`` (:func:`rng.seed_base` of the G step's and each critic
        step's ``z`` seed), ``q_seeds [n_critic, B]`` (the dequantisation
        seeds), ``g_labels [2, gen_bs_multiple * B]``, the batches
        (``index``, or the dataset's arrays) and, when given, ``noise``."""
        tcfg = self.tcfg
        decay = float(lr_decay(iteration, tcfg.decay))
        lr = tcfg.lr * decay
        confuse_lr = tcfg.lr * tcfg.confuse_multiplier * (decay if tcfg.confuse_lr_decay else 1.0)
        d_batches = {k: self._rows(self._host(v), 1) for k, v in d_batches.items()}
        if "index" in d_batches:
            if self.device_dataset is None:
                raise ValueError("index batches need the trainer's device_dataset")
            batches = {"index": d_batches["index"].astype(np.int64)}
        else:
            batches = {k: d_batches[k] for k in DATASET_KEYS}
        lead = next(iter(batches.values())).shape
        if lead[0] != tcfg.n_critic:
            raise ValueError(f"d_batches need a leading dim of n_critic={tcfg.n_critic}; "
                             f"got {tuple(lead)}")
        b = lead[1]  # this rank's rows
        world, rank = (1, 0) if self.group is None else (self.group.world_size, self.group.rank)
        gb = tcfg.gen_bs_multiple * b
        if tuple(np.shape(g_labels["random"])) != (gb * world,):
            raise ValueError(f"g_labels must be [gen_bs_multiple * B] = [{gb * world}]; got "
                             f"{tuple(np.shape(g_labels['random']))}")
        seeds = rng.cycle_seeds(seed, tcfg.n_critic, b, start=rank * b)
        row = dict(batches, g_labels=np.stack([self._rows(self._host(g_labels[k]), 0)
                                               for k in ("random", "biased")]),
                   z_base=np.array([rng.seed_base(s) for s in [seeds.g_z, *seeds.d_z]]),
                   q_seeds=seeds.dequant)
        if noise is not None:
            row.update({k: self._rows(self._host(noise[k]), 0 if k == "zg" else 1)
                        for k in ("zg", "z", "u")})
        d_lr = lr if tcfg.d_lr is None else tcfg.d_lr * decay
        adam = np.zeros((2 + tcfg.n_critic, 5), np.float32)
        if iteration > 0:  # the reference skips the G step at iteration 0
            for i, (g, g_lr) in enumerate((("gen", lr), ("confusion", confuse_lr))):
                if g in ts.groups:
                    st = ts.opt_states[g]
                    st.count += 1
                    adam[i] = self.optimizers[g].scalars(st.count, g_lr)
        st = ts.opt_states["disc"]
        for k in range(tcfg.n_critic):
            st.count += 1
            adam[2 + k] = self.optimizers["disc"].scalars(st.count, d_lr)
        row["adam"] = adam
        return row

    _DTYPES = {"index": torch.int64, "images": torch.uint8, "labels": torch.int64,
               "labels_random": torch.int64, "labels_biased": torch.int64,
               "labels_inv_weights": torch.float32, "g_labels": torch.int64,
               "z_base": torch.int64, "q_seeds": torch.int32, "adam": torch.float32,
               "zg": torch.float32, "z": torch.float32, "u": torch.float32}
    METRICS = ("d_cost", "d_cost_mean", "g_cost", "lr")

    # ------------------------------------------------------------- steps
    def _g_step_update(self, ts: TrainState, g_random, g_biased, zg, adam) -> torch.Tensor:
        names = [g for g in ("gen", "confusion") if g in ts.groups]
        params = [p for g in names for p in ts.group_params(g)]
        mark("g.forward")
        with trainable(ts, names):
            out = ts.gan.gen_loss(g_random, g_biased, zg, self.confusion_actual)
            mark("g.backward")
            grads = grads_of(out["gen_cost"], params)
        mark("g.update")
        mean_over_ranks(self.group, grads, ts)
        n = 0
        for g in names:
            ps = ts.group_params(g)
            self.optimizers[g].apply_(ps, grads[n:n + len(ps)], ts.opt_states[g],
                                      adam[0 if g == "gen" else 1])
            n += len(ps)
        return out["gen_cost"].detach()

    def _d_step(self, ts: TrainState, batch: dict, real: torch.Tensor, z: torch.Tensor,
                scalars: torch.Tensor) -> torch.Tensor:
        sb = {"real_data": real, "labels": batch["labels"],
              "labels_random": batch["labels_random"], "labels_biased": batch["labels_biased"],
              "labels_inv_weights": batch["labels_inv_weights"]}
        params = ts.group_params("disc")
        mark("d.forward")
        with trainable(ts, ["disc"]):
            out = ts.gan.disc_loss(sb, z, self.confusion_actual)
            mark("d.backward")
            grads = grads_of(out["disc_cost"], params)
        mark("d.update")
        mean_over_ranks(self.group, grads, ts)
        self.optimizers["disc"].apply_(params, grads, ts.opt_states["disc"], scalars)
        return out["disc_cost"].detach()

    def _cycle(self, blk, ts: TrainState, g_step: bool) -> None:
        """The body of one cycle (JAX's ``_cycle``) on ``ts``, on the row
        ``counter`` of ``blk``, a :class:`StepBlock` or a GSPMD step's row of
        DTensors; it reads only device tensors, so that one body runs eagerly
        and in a CUDA graph: the G step (unless ``g_step`` is off: the row
        :attr:`program` runs eagerly at iteration 0), then the ``n_critic`` D
        steps, the state kept at its addresses (:func:`state_in_place`); the
        metrics go to the row; the phases are marked as device spans (module
        doc)."""
        cfg, tcfg = self.cfg, self.tcfg
        mark("d.input")
        f = {k: blk.row(k) for k in blk.fields}
        if "index" in f:
            batches = self._batch_to_device({k: v[f["index"]]
                                             for k, v in self.device_dataset.items()})
        else:
            batches = {k: f[k] for k in DATASET_KEYS}
        b = batches["labels"].shape[1]
        gb = tcfg.gen_bs_multiple * b
        noise = "zg" in f
        adam, z_base = f["adam"], f["z_base"]
        with state_in_place(ts.gan):
            if g_step:
                mark("g.input")
                zg = f["zg"] if noise else self._normal_rows(z_base[0], gb)
                g_cost = self._g_step_update(ts, f["g_labels"][0], f["g_labels"][1], zg, adam)
            else:  # the reference skips the G step at iteration 0
                g_cost = torch.zeros((), device=self.device)
            d_costs = []
            for k in range(tcfg.n_critic):
                mark("d.input")
                batch = {key: v[k] for key, v in batches.items()}
                if noise:
                    real = dequantize_chw_to_hwc(batch["images"], f["u"][k], cfg.img_size,
                                                 cfg.img_dim)
                    z = f["z"][k]
                else:
                    real = dequantize_chw_to_hwc_seeded(batch["images"], f["q_seeds"][k],
                                                        cfg.img_size, cfg.img_dim)
                    z = self._normal_rows(z_base[1 + k], b)
                d_costs.append(self._d_step(ts, batch, real, z, adam[2 + k]))
        d_costs = torch.stack(d_costs)
        costs = [d_costs[-1], d_costs.mean(), g_cost]
        if self.group is not None:
            self.group.mean_(costs)
        for name, value in zip(self.METRICS, (*costs, adam[2, 0])):
            blk.write(name, value)
        blk.advance()
        mark("between")

    def _normal_rows(self, base: torch.Tensor, n: int) -> torch.Tensor:
        """``[n, z_dim]`` normals of a global batch of ``n`` rows keyed by
        ``base`` and the global row: with a group this rank's rows (``n`` is
        then the rank's count); under GSPMD each rank draws its rows of the
        mesh's data axis, sharded there."""
        z_dim = self.cfg.z_dim
        if self.mesh is not None:
            return data_rows(self.mesh, n, lambda rows, start: rng.example_normal_from(
                base, rows, z_dim, start))
        rank = 0 if self.group is None else self.group.rank
        return rng.example_normal_from(base, n, z_dim, rank * n)

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
        [n_critic, B, 3072]`` (CHW order).  Metrics are device tensors of
        their own: ``d_cost`` (the last critic step's), ``d_cost_mean``,
        ``g_cost``, ``lr``.  With a group, the batches, labels and ``noise``
        are the global ones (every rank is given the same), the rank runs on
        its rows, and the costs are meaned over the ranks."""
        with self.program.captured.spans.host("rows"):
            row = self._cycle_row(ts, d_batches, g_labels, iteration, seed, noise)
        # the addresses the graph reads: a new state or dataset captures again
        self.program.run([row], ts, lambda: train_state_key(
            ts, (self.device_dataset or {}).values()), eager=int(iteration == 0))
        ts.step += 1
        return ts, {k: v[0] for k, v in self.program.read(1).items()}

    def step_scan(self, ts: TrainState, idx, g_random, g_biased, seed: int,
                  noise: Optional[Mapping] = None):
        """``len(idx)`` cycles over the device dataset: ``idx [K, n_critic,
        B]``, ``g_random``/``g_biased`` ``[K, gen_bs_multiple * B]``.  Cycle
        ``j`` runs at iteration ``ts.step`` with the seed
        ``fold_in(seed, ts.step)``, as JAX's ``step_scan`` keys it, or, when
        ``noise`` is given, with its row ``j`` (:meth:`step`'s ``noise``
        stacked ``[K, ...]``).  The
        block's inputs go to the device in one copy; on a card the captured
        cycle is replayed K times, each replay reading the next row (JAX's
        ``lax.scan``).  Metrics come back stacked ``[K]``.  One device only:
        a group steps cycle by cycle (:meth:`step`), as JAX's mesh path
        does."""
        if self.group is not None:
            raise ValueError("step_scan runs on one device; with a group, call step per cycle")
        if self.device_dataset is None:
            raise ValueError("step_scan needs the trainer's device_dataset")
        idx, g_random, g_biased = (self._host(x) for x in (idx, g_random, g_biased))
        first = ts.step
        with self.program.captured.spans.host("rows", len(idx)):
            rows = [self._cycle_row(ts, {"index": idx[j]},
                                    {"random": g_random[j], "biased": g_biased[j]},
                                    first + j, rng.fold_in(seed, first + j),
                                    None if noise is None else
                                    {k: v[j] for k, v in noise.items()})
                    for j in range(len(idx))]
        self.program.run(rows, ts, lambda: train_state_key(ts, self.device_dataset.values()),
                         eager=int(first == 0))
        ts.step += len(rows)
        return ts, self.program.read(len(rows))

    def eval_disc_cost(self, ts: TrainState, batch: Mapping, seed: int,
                       noise: Optional[Mapping] = None) -> torch.Tensor:
        """The discriminator cost on a held-out ``batch`` (``images`` uint8
        ``[B, 3072]`` and the labels), with no SN update and no parameter
        update (the dev cost of ``gan_resnet.py:976-989``), keyed by
        ``seed``: ``z`` from ``fold_in(seed, 0)``, the dequantisation from
        ``fold_in(seed, 1)``.  ``noise``, when given, supplies ``z [B,
        z_dim]`` and ``u [B, 3072]``.  A device scalar of its own."""
        row = self._dev_cost_row({k: self._host(batch[k]) for k in DATASET_KEYS}, seed, noise)
        self.dev_program.run([row], (ts, None), lambda: train_state_key(ts))
        return self.dev_program.read(1)["cost"][0]

    def eval_disc_cost_scan(self, ts: TrainState, dataset: Mapping[str, torch.Tensor], idx,
                            seed: int, noise: Optional[Mapping] = None) -> torch.Tensor:
        """The mean discriminator cost over ``idx [K, B]`` index batches of a
        split resident on the device (``dataset`` as
        :func:`~rcgan_tpu_torch.data.cifar10.device_dataset_of` returns it),
        each batch gathered on the device and keyed by
        ``fold_in(seed, k)``; no SN or parameter update (JAX's
        ``eval_disc_cost_scan``).  ``noise``, when given, supplies ``z [K,
        B, z_dim]`` and ``u [K, B, 3072]``.  The K index rows go to the
        device in one copy and the body runs once a row (a replay each on a
        card); the mean is taken on the device.  Returns a device scalar."""
        idx = self._host(idx).astype(np.int64)
        rows = [self._dev_cost_row({"index": idx[k]}, rng.fold_in(seed, k),
                                   None if noise is None else
                                   {"z": noise["z"][k], "u": noise["u"][k]})
                for k in range(len(idx))]
        self.dev_program.run(rows, (ts, dataset), lambda: train_state_key(ts, dataset.values()))
        return self.dev_program.read(len(rows))["cost"].mean()

    def _dev_cost_row(self, batch: Mapping, seed: int,
                      noise: Optional[Mapping]) -> Dict[str, np.ndarray]:
        """One dev-cost batch's row: the batch (``index`` or the dataset's
        arrays) and ``z`` and ``u`` when given, else ``z_base``
        (:func:`rng.seed_base` of ``fold_in(seed, 0)``) and ``q_seeds [B]``
        (the dequantisation seeds of ``fold_in(seed, 1)``)."""
        row = dict(batch)
        b = len(next(iter(batch.values())))
        if noise is not None:
            row.update(z=self._host(noise["z"]), u=self._host(noise["u"]))
        else:
            row.update(z_base=np.array(rng.seed_base(rng.fold_in(seed, 0))),
                       q_seeds=rng.example_seeds(rng.fold_in(seed, 1), b))
        return row

    def _dev_cost(self, blk: StepBlock, state) -> None:
        """The body of one dev-cost batch on the block's row ``counter``, on
        ``state``, the train state and the split resident on the device (or
        None): the batch gathered on the device (or read from the row), the
        real images dequantised, ``z`` drawn, and D's cost on them with SN
        frozen, into the row's ``cost``."""
        (ts, dataset), cfg = state, self.cfg
        f = {k: blk.row(k) for k in blk.fields}
        with torch.no_grad():
            if "index" in f:
                sb = self._batch_to_device({k: v[f["index"]]
                                            for k, v in dataset.items()})
            else:
                sb = {k: f[k] for k in DATASET_KEYS}
            b = sb["labels"].shape[0]
            if "u" in f:
                real = dequantize_chw_to_hwc(sb["images"], f["u"], cfg.img_size, cfg.img_dim)
                z = f["z"]
            else:
                real = dequantize_chw_to_hwc_seeded(sb["images"], f["q_seeds"], cfg.img_size,
                                                    cfg.img_dim)
                z = rng.example_normal_from(f["z_base"], b, cfg.z_dim)
            sb = dict(sb, real_data=real)
            with sn_updates(ts.gan, False):
                cost = ts.gan.disc_loss(sb, z, self.confusion_actual)["disc_cost"]
        blk.write("cost", cost)
        blk.advance()

    def sample(self, ts: TrainState, z, labels) -> torch.Tensor:
        """The generator forward for evals and sample grids, float32 ``[B,
        output_dim]`` on the device, a tensor of its own: cond-BN with batch
        statistics, as the reference (``normalization.py:47-58``), in the
        trainer's compute dtype.  On a card the pass is captured once per
        batch size."""
        return self._samples({"z": z, "labels": labels}, ts.gan.G)

    @staticmethod
    def _sample_pass(inputs: Dict[str, torch.Tensor], gen) -> torch.Tensor:
        return sample(gen, inputs["z"], inputs["labels"])
