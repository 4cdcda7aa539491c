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

JAX compiles each phase into one program (``jax.jit`` per ``(stage,
trans)``, ``alpha`` traced as float32).  The port runs one body,
:meth:`PGGANTrainer._iteration`, eagerly on the CPU, and on a card captures
it into a CUDA graph per phase and replays it (``train/graphs.py``): a new
phase, or a state at other addresses, frees the graph and captures again.
The body reads only device tensors: a host part
(:meth:`PGGANTrainer._iteration_row`) packs the full-resolution batch and
its labels, the seed's base for ``z``, ``alpha`` as float32 and Adam's
scalars for both groups into the iteration's row of a
:class:`~rcgan_tpu_torch.train.graphs.StepBlock`, advancing the Adam counts
there.  The state (parameters, moments, SN ``u``, the critic's BN
statistics) keeps its addresses (``train/state.py::state_in_place``).
``sample`` is captured per ``(stage, batch)`` (:class:`~rcgan_tpu_torch.
train.graphs.Passes`).

Spans (:mod:`rcgan_tpu_torch.utils.profiling`, in the program's
``captured.spans``): :meth:`PGGANTrainer.step`'s host part is timed as
``rows`` (:meth:`PGGANTrainer._iteration_row`), then by the program
(``train/graphs.py::Program``) as ``key`` (the state's addresses),
``load``, ``launch`` and ``read``; the
iteration marks its device phases: ``d.input`` (the row read,
``pool_to_stage``, ``z``), ``d.forward`` (G's fakes and D on both),
``d.backward``, ``d.update`` (Adam), ``g.forward``, ``g.backward``,
``g.update`` (Adam, the state copies and the costs), then ``between``
until the next iteration.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from rcgan_tpu_torch.algorithms.losses import get_loss
from rcgan_tpu_torch.core import rng
from rcgan_tpu_torch.core.module import float32_policy, sn_updates
from rcgan_tpu_torch.models.pggan import PGGAN, PGGANConfig, sample
from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device
from rcgan_tpu_torch.train.graphs import Passes, Program, StepBlock, capture_on
from rcgan_tpu_torch.train.state import (ScalelessAdam, TrainState, grads_of, init_train_state,
                                         state_in_place, train_state_key, trainable)
from rcgan_tpu_torch.utils.profiling import mark


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
    ``device``.  ``graphs``: capture the step (per phase) and ``sample``
    (per stage and batch) into CUDA graphs and replay them
    (``train/graphs.py``); by default on a CUDA device, as JAX always jits
    them.  ``False`` runs the same bodies eagerly there; the CPU runs them
    eagerly, and asking it for graphs raises."""

    _DTYPES = {"x": torch.float32, "labels": torch.int64, "z": torch.float32,
               "z_base": torch.int64, "alpha": torch.float32, "adam": torch.float32}
    METRICS = ("d_cost", "g_cost")

    def __init__(self, cfg: PGGANConfig, base: ResnetGANConfig, tcfg: PGGANTrainConfig,
                 device="cuda", compute_dtype: torch.dtype = torch.float32,
                 graphs: Optional[bool] = None):
        self.cfg, self.base, self.tcfg = cfg, base, tcfg
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        float32_policy(compute_dtype)
        self.optimizers = {g: ScalelessAdam(tcfg.beta1, tcfg.beta2) for g in ("gen", "disc")}
        self.graphs = capture_on(self.device, graphs)
        self.program = Program(self._iteration, self._DTYPES, self.device, self.graphs,
                               {k: (torch.float32, ()) for k in self.METRICS})
        self._samples = Passes(self._sample_pass, {"z": torch.float32, "labels": torch.int64},
                               self.device, self.graphs)

    def init(self, seed: int = 0) -> TrainState:
        """A train state over every stage's parameters drawn from ``seed``,
        zero Adam moments.  (JAX's ``init(rng, batch)`` traces every phase
        to create them; the port's modules create them when built.)"""
        gan = PGGAN(self.cfg, self.base, seed, self.device, self.compute_dtype)
        return init_train_state(gan, partition_predicates(), self.optimizers)

    # -------------------------------------------------------------- step
    def _iteration_row(self, ts: TrainState, images: Mapping, seed: int, alpha: float,
                       z=None) -> Dict[str, Any]:
        """The host part of one iteration: the iteration's row of the block,
        ``x`` (the full-resolution batch), ``labels``, ``z`` or ``z_base``
        (:func:`rng.seed_base` of ``fold_in(seed, 0)``), ``alpha`` (float32)
        and ``adam [2, 5]`` (:meth:`ScalelessAdam.scalars` of the D step and
        the G step), advancing both Adam counts.  The batch stays where it
        is given: a tensor on the device is copied there on the device."""
        row = {"x": images["x"], "labels": images["labels"],
               "alpha": np.array(alpha, np.float32)}
        if z is None:
            row["z_base"] = np.array(rng.seed_base(rng.fold_in(seed, 0)))
        else:
            row["z"] = z
        adam = np.zeros((2, 5), np.float32)
        for i, g in enumerate(("disc", "gen")):
            st = ts.opt_states[g]
            st.count += 1
            adam[i] = self.optimizers[g].scalars(st.count, self.tcfg.lr)
        row["adam"] = adam
        return row

    def _iteration(self, blk: StepBlock, state) -> None:
        """The body of one iteration on the block's row ``counter``, on
        ``state``, the train state and the phase ``(ts, stage, trans)``; it
        reads only device tensors, so that one body runs eagerly and in a
        CUDA graph: ``pool_to_stage``, the D step, the G step, the state kept
        at its addresses (:func:`state_in_place`); the costs go to the
        block's row; the phases are marked as device spans (module doc)."""
        (ts, stage, trans), cfg, tcfg = state, self.cfg, self.tcfg
        gan = ts.gan
        mark("d.input")
        f = {k: blk.row(k) for k in blk.fields}
        x = pool_to_stage(f["x"], cfg, stage).to(self.compute_dtype)
        labels = f["labels"]
        d_labels = labels if cfg.conditional else None
        z = f["z"] if "z" in f else rng.example_normal_from(f["z_base"], x.shape[0], cfg.z_dim)
        alpha, adam = f["alpha"], f["adam"]
        with state_in_place(gan):
            params = ts.group_params("disc")
            mark("d.forward")
            with trainable(ts, ["disc"]):
                fake = gan.G(z, labels, stage, trans, alpha)
                _, d_fake = gan.D(fake, stage, trans, alpha, d_labels)
                _, d_real = gan.D(x, stage, trans, alpha, d_labels)
                _, d_cost = get_loss(d_real, d_fake, tcfg.loss_type)
                mark("d.backward")
                grads = grads_of(d_cost, params)
            mark("d.update")
            self.optimizers["disc"].apply_(params, grads, ts.opt_states["disc"], adam[0])

            params = ts.group_params("gen")
            mark("g.forward")
            with trainable(ts, ["gen"]), sn_updates(gan.D, False):
                fake = gan.G(z, labels, stage, trans, alpha)
                _, d_fake = gan.D(fake, stage, trans, alpha, d_labels)
                g_cost, _ = get_loss(torch.zeros_like(d_fake), d_fake, tcfg.loss_type)
                mark("g.backward")
                grads = grads_of(g_cost, params)
            mark("g.update")
            self.optimizers["gen"].apply_(params, grads, ts.opt_states["gen"], adam[1])
        blk.write("d_cost", d_cost.detach())
        blk.write("g_cost", g_cost.detach())
        blk.advance()
        mark("between")

    def step(self, ts: TrainState, images: Mapping, seed: int, alpha: float, stage: int,
             trans: bool, z=None):
        """One D and one G update at ``(stage, trans, alpha)``, in place on
        ``ts``; returns ``(ts, {"d_cost", "g_cost"})`` as device scalars of
        their own.  ``images``: ``{"x": [B, H, W, C] full-resolution float
        in [-1, 1], "labels": [B] int}`` (arrays, or tensors on the
        device); ``z`` is drawn from ``fold_in(seed, 0)`` unless given.  On
        a card the first iteration of a phase is the warm-up before the
        capture, and every later one replays."""
        with self.program.captured.spans.host("rows"):
            row = self._iteration_row(ts, images, seed, alpha, z)
        # the phase's layers, its sn group, and the addresses of the state
        self.program.run([row], (ts, stage, trans),
                         lambda: (stage, trans) + train_state_key(ts))
        ts.step += 1
        return ts, {k: v[0] for k, v in self.program.read(1).items()}

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
        device, a tensor of their own; no state moves.  On a card the pass
        is captured once per stage and batch size."""
        stage = self.cfg.max_stage if stage is None else stage
        return self._samples({"z": z, "labels": labels}, ts.gan.G, extra=(stage,))

    @staticmethod
    def _sample_pass(inputs: Dict[str, torch.Tensor], gen, stage: int) -> torch.Tensor:
        return sample(gen, inputs["z"], inputs["labels"], stage)
