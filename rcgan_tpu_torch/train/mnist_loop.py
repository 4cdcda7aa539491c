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

JAX compiles the iteration (``_jitted_step``), ``step_scan``'s blocks
(``_jitted_scan``) and ``sample`` into one program each; the port runs one body,
:meth:`MnistTrainer._iteration`, eagerly on the CPU and with a gloo group,
and on a card, alone or in an NCCL group, captures it into a CUDA graph
once and replays it, once per row of a block for ``step_scan``
(``train/graphs.py``).  The body reads only device
tensors: a host part (:meth:`MnistTrainer._iteration_row`) packs Adam's
scalars, the seed's base for ``z`` (drawn on the device by
:func:`rcgan_tpu_torch.core.rng.example_uniform_from`) and the batch or its
indices into the iteration's row of a
:class:`~rcgan_tpu_torch.train.graphs.StepBlock`.  Each step takes
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
batch in rank order.  Batch norms take their moments per rank.  In an NCCL
group each rank captures its own graph of the same collectives in the same
order.

Spans (:mod:`rcgan_tpu_torch.utils.profiling`, in the program's
``captured.spans``): the host part of :meth:`MnistTrainer.step` and
:meth:`MnistTrainer.step_scan` is timed as ``rows`` (the iterations' rows),
then by the program (``train/graphs.py::Program``) as ``key``, ``load``,
``launch`` and ``read``; the iteration marks no device phases.
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
from rcgan_tpu_torch.train.graphs import Passes, Program, StepBlock, capture_on
from rcgan_tpu_torch.train.state import (ScalelessAdam, TrainState, apply_constraints,
                                         constraints_of, grads_of, init_train_state,
                                         mean_over_ranks, state_in_place, train_state_key,
                                         trainable)

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
    (JAX's ``mesh``).  ``graphs``: capture the iteration into a CUDA graph
    and replay it (``train/graphs.py``); by default on a CUDA device, alone
    or in an NCCL group, as JAX always jits its step.  ``False`` runs the
    same body eagerly there (to compare); the CPU and a gloo group run it
    eagerly, and asking them for graphs raises."""

    def __init__(self, cfg: DCGANConfig, acfg: MnistAlgoConfig, tcfg: MnistTrainConfig,
                 confusion_actual: np.ndarray, group: Optional[DataGroup] = None,
                 device="cuda", compute_dtype: torch.dtype = torch.float32,
                 graphs: Optional[bool] = None):
        self.cfg, self.acfg, self.tcfg = cfg, acfg, tcfg
        self.group = check_group(group, device)
        self.device = group.device if group is not None else resolve_device(device)
        self.graphs = capture_on(self.device, graphs, self.group)
        self.compute_dtype = compute_dtype
        float32_policy(compute_dtype)
        self.confusion_actual = torch.as_tensor(np.asarray(confusion_actual, np.float32),
                                                device=self.device)
        self.optimizers = optimizers(tcfg)
        # the metrics: prob_real and prob_fake, [B] of the global batch, are
        # made at their first write (StepBlock)
        v = acfg.y_dim
        self.program = Program(self._iteration, self._DTYPES, self.device, self.graphs,
                               {**{name: (torch.float32, ()) for name in self.SCALARS},
                                "confusion": (torch.float32, (v, v))}, self.group)
        # sample: one pass per batch size, in a graph and pool of its own
        self._samples = Passes(self._sample_pass, {"z": torch.float32, "y": torch.float32},
                               self.device, self.graphs)

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

    def _rows(self, x):
        """This rank's rows of a global batch (all of them without a group)."""
        return x if self.group is None else x[self.group.local_rows(x.shape[0])]

    @staticmethod
    def _host(x) -> np.ndarray:
        return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    _DTYPES = {"index": torch.int64, "images": torch.float32, "y_real": torch.int64,
               "y_gen": torch.int64, "y_fake": torch.int64, "y_real_weights": torch.float32,
               "z": torch.float32, "z_base": torch.int64, "adam": torch.float32}
    SCALARS = ("d_loss", "d_loss_real", "d_loss_fake", "class_loss_real", "g_loss",
               "class_loss_fake")

    def _iteration_row(self, ts: TrainState, batch: Mapping, seed: int,
                       z: Optional[np.ndarray]) -> Dict[str, np.ndarray]:
        """The host part of one iteration: this rank's rows of ``batch``
        (the arrays of :data:`BATCH_KEYS`, or ``{"index": [B]}`` into
        ``step_scan``'s dataset), ``z`` or ``z_base`` (:func:`rng.seed_base`
        of ``fold_in(seed, 0)``), and ``adam [1 + 2 g_steps, 5]``
        (:meth:`ScalelessAdam.scalars` of the D step, then of each G step's
        gen and confusion updates), advancing the Adam counts."""
        tcfg = self.tcfg
        lr = tcfg.learning_rate
        row = {k: self._rows(self._host(v)) for k, v in batch.items()}
        if z is not None:
            row["z"] = self._rows(self._host(z))
        else:
            row["z_base"] = np.array(rng.seed_base(rng.fold_in(seed, 0)))
        adam = np.zeros((1 + 2 * tcfg.g_steps, 5), np.float32)
        st = ts.opt_states["disc"]
        st.count += 1
        adam[0] = self.optimizers["disc"].scalars(st.count, lr)
        for i in range(tcfg.g_steps):
            for j, (g, g_lr) in enumerate((("gen", lr),
                                           ("confusion", lr * tcfg.confuse_multiplier))):
                if g in ts.groups:
                    st = ts.opt_states[g]
                    st.count += 1
                    adam[1 + 2 * i + j] = self.optimizers[g].scalars(st.count, g_lr)
        row["adam"] = adam
        return row

    # -------------------------------------------------------------- step
    def _iteration(self, blk: StepBlock, state) -> None:
        """The body of one reference iteration on the block's row
        ``counter``, on ``state``, the train state and ``step_scan``'s
        dataset (or None); it reads only device tensors, so that one body
        runs eagerly and in a CUDA graph: the D update, the max-norm clip,
        the ``g_steps`` G (+C) updates, the state kept at its addresses
        (:func:`state_in_place`); the metrics go to the block's row."""
        (ts, dataset), cfg, tcfg = state, self.cfg, self.tcfg
        f = {k: blk.row(k) for k in blk.fields}
        if "index" in f:
            batch = self.batch_to_device({k: v[f["index"]] for k, v in dataset.items()})
        else:
            batch = {k: f[k] for k in BATCH_KEYS}
        b = batch["images"].shape[0]  # this rank's rows
        rank = 0 if self.group is None else self.group.rank
        z = f["z"] if "z" in f else rng.example_uniform_from(f["z_base"], b, cfg.z_dim, -1.0,
                                                             1.0, first_index=rank * b)
        adam = f["adam"]
        with state_in_place(ts.gan):
            # ---- D update: d_loss + 1 * class_loss_real over the d_ variables
            params = ts.group_params("disc")
            with trainable(ts, ["disc"]):
                d_out = mnist_losses(ts.gan, batch, z, self.confusion_actual)
                grads = grads_of(d_out["d_loss"] + 1.0 * d_out["class_loss_real"], params)
            mean_over_ranks(self.group, grads, ts)
            self.optimizers["disc"].apply_(params, grads, ts.opt_states["disc"], adam[0])
            apply_constraints(ts.groups["disc"], constraints_of(ts.gan))

            # ---- G (+C) updates: g_loss + perm_multiplier * class_loss_fake
            names = [g for g in ("gen", "confusion") if g in ts.groups]
            params = [p for g in names for p in ts.group_params(g)]
            g_out = None
            for i in range(tcfg.g_steps):
                with trainable(ts, names):
                    g_out = mnist_losses(ts.gan, batch, z, self.confusion_actual,
                                         g_step_only=True)
                    grads = grads_of(g_out["g_loss"] + tcfg.perm_multiplier
                                     * g_out["class_loss_fake"], params)
                mean_over_ranks(self.group, grads, ts)
                n = 0
                for g in names:
                    ps = ts.group_params(g)
                    self.optimizers[g].apply_(ps, grads[n:n + len(ps)], ts.opt_states[g],
                                              adam[1 + 2 * i + (g == "confusion")])
                    n += len(ps)

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
        for k, v in metrics.items():
            blk.write(k, v)
        blk.advance()

    def step(self, ts: TrainState, batch: Mapping, seed: int,
             z: Optional[torch.Tensor] = None):
        """One reference iteration in place on ``ts``; returns ``(ts,
        metrics)``.  ``z [B, z_dim]`` in U[-1, 1), shared by the D step and
        the G steps, is drawn from ``fold_in(seed, 0)`` unless given.
        Metrics are device tensors of their own: the D step's ``d_loss``,
        ``d_loss_real``, ``d_loss_fake``, ``class_loss_real`` and
        ``prob_real [B]``; the last G step's ``g_loss``,
        ``class_loss_fake``, ``prob_fake [B]`` and ``confusion``.  With a
        group, ``batch`` and ``z`` are the global ones (every rank is given
        the same) and the rank runs on its rows; the metrics are meaned over
        the ranks, the ``[B]`` ones gathered."""
        with self.program.captured.spans.host("rows"):
            row = self._iteration_row(ts, {k: batch[k] for k in BATCH_KEYS}, seed, z)
        self.program.run([row], (ts, None), lambda: train_state_key(ts))
        ts.step += 1
        return ts, {k: v[0] for k, v in self.program.read(1).items()}

    def step_scan(self, ts: TrainState, dataset: Mapping[str, torch.Tensor], idx, seed: int,
                  z=None):
        """``len(idx)`` iterations over ``dataset`` (device tensors keyed by
        :data:`BATCH_KEYS`, the whole split resident on the device), batch
        ``j`` gathered on the device from ``idx [K, B]``; iteration ``j``
        takes the seed ``fold_in(seed, ts.step)``, as JAX's ``step_scan``
        keys it, or, when ``z [K, B, z_dim]`` is given, its row ``j``.  The
        block's indices go to the device in one copy; on a card the captured
        iteration is replayed K times, each replay reading the next row
        (JAX's ``lax.scan``).  Metrics come back stacked ``[K,
        ...]``.  One device only: a group steps iteration by iteration
        (:meth:`step`), as JAX's mesh path does."""
        if self.group is not None:
            raise ValueError("step_scan runs on one device; with a group, call step per "
                             "iteration")
        if set(dataset) != set(BATCH_KEYS):
            raise ValueError(f"dataset must hold {BATCH_KEYS}; got {sorted(dataset)}")
        dataset = dict(dataset)
        idx = self._host(idx)
        first = ts.step
        with self.program.captured.spans.host("rows", len(idx)):
            rows = [self._iteration_row(ts, {"index": idx[j]}, rng.fold_in(seed, first + j),
                                        None if z is None else self._host(z)[j])
                    for j in range(len(idx))]
        # the addresses the graph reads: a new state or dataset captures again
        self.program.run(rows, (ts, dataset), lambda: train_state_key(ts, dataset.values()))
        ts.step += len(rows)
        return ts, self.program.read(len(rows))

    # ------------------------------------------------------------ sample
    def sample(self, ts: TrainState, z, y_onehot) -> torch.Tensor:
        """The reference's ``gen_sampler``: G with BN in inference mode,
        float32 ``[B, H, W, c_dim]`` on the device, a tensor of its own.  On
        a card the pass is captured once per batch size; it reads BN's
        moving statistics where they live, which the steps keep in place."""
        return self._samples({"z": z, "y": y_onehot}, ts.gan.G)

    @staticmethod
    def _sample_pass(inputs: Dict[str, torch.Tensor], gen) -> torch.Tensor:
        return sample(gen, inputs["z"], inputs["y"])


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
