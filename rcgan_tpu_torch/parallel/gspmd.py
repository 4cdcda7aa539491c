"""GSPMD over DTensor: the CIFAR cycle as one program partitioned over a
2-D ``('data', 'model')`` device mesh, the counterpart of
``rcgan_tpu/parallel/gspmd.py``.

JAX jits the single-program cycle (``_cycle(..., axis=None)``) with
sharding annotations and lets XLA insert the collectives.  The port runs
the same body, :meth:`CifarTrainer._cycle`, on
``torch.distributed.tensor`` DTensors, one process per mesh device, and
DTensor's dispatch inserts the collectives:

- the batch is sharded on ``data``: the critic batches ``[n_critic, B,
  ...]`` on dim 1, the generator labels and every per-row draw on dim 0.
  Each rank draws ``z``, ``zg`` and the dequantisation noise for its own
  rows by their global index (:func:`data_rows`), so the layout does not
  change the noise;
- the parameters are replicated except the wide layers of
  :data:`DEFAULT_TP_RULES`, sharded on ``model``: ``G.Input`` column-parallel
  (``W`` on dim 1, ``b`` on dim 0), ``D.Output``'s ``W`` row-parallel,
  ``D.Embedding_y``'s ``W`` on dim 1 and ``b`` on dim 0.  The SN ``u``
  state and the Adam moments are replicated (JAX replicates them too);
- the five kernels are ``torch.library`` ops with DTensor sharding rules
  (``ops/kernels``): conv3x3, the projection and the dequantisation keep
  the batch sharded; sn and cond-BN take whole tensors, so a weight
  sharded on ``model`` is gathered before the sn launch and G's activations
  are gathered on ``data`` before each cond-BN launch.  The body is the
  single-program cycle: cond-BN's moments, the losses and SN are over the
  global batch and whole weights, so the step equals the one-process cycle
  at the global batch (not the ``DataGroup`` path, whose batch norms take
  their moments per rank);
- each gradient reaches Adam as a partial sum on ``data`` and is
  all-reduced once, explicitly, to its parameter's placements
  (``train/state.py::ScalelessAdam.apply_``).

JAX jits the cycle (``jax.jit(body, donate_argnums=0)``); on a CUDA mesh
the port captures it into a CUDA graph and replays it (``train/graphs.py``),
the collectives DTensor inserts included (NCCL).  The host part of a
cycle (:func:`_check_placed`, ``CifarTrainer._cycle_row``) stays outside
the graph and loads this rank's rows of the cycle's inputs into a
:class:`~rcgan_tpu_torch.train.graphs.StepBlock` at fixed addresses; the
body wraps them as DTensors, gathers the index batch from the resident
dataset and writes the metrics whole to the block, all on the device, so
that a replay does the same with no DTensor dispatch.  A CPU mesh (gloo)
runs the same body eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

from rcgan_tpu_torch.core.module import scoped_modules
from rcgan_tpu_torch.data.cifar10 import DATASET_KEYS
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device
from rcgan_tpu_torch.train.graphs import Program, StepBlock, capture_on
from rcgan_tpu_torch.train.state import ParamKey, TrainState, train_state_key

Placements = Tuple[Placement, ...]  # one per mesh dimension: (data, model)

REPLICATED: Placements = (Replicate(), Replicate())
DATA_ROWS: Placements = (Shard(0), Replicate())

# layer -> {var: [placement on data, placement on model]}
DEFAULT_TP_RULES: Dict[str, Dict[str, Placements]] = {
    "G.Input": {"W": (Replicate(), Shard(1)), "b": (Replicate(), Shard(0))},
    "D.Output": {"W": (Replicate(), Shard(0))},
    "D.Embedding_y": {"W": (Replicate(), Shard(1)), "b": (Replicate(), Shard(0))},
}


def make_dp_tp_mesh(n_data: int, n_model: int, device_type: str = "cuda") -> DeviceMesh:
    """The ``(n_data, n_model)`` mesh named ``('data', 'model')`` over the
    ranks of the default process group, which must number ``n_data *
    n_model``; rank ``r`` sits at ``(r // n_model, r % n_model)``."""
    resolve_device(device_type)
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=("data", "model"))


@dataclasses.dataclass
class TrainStateShardings:
    """The placements of every leaf of a :class:`TrainState` on ``mesh``:
    ``groups`` per parameter, ``state`` per buffer ``(scope, var)``,
    ``opt_states`` per group and parameter (both moments alike)."""

    mesh: DeviceMesh
    groups: Dict[str, Dict[ParamKey, Placements]]
    state: Dict[ParamKey, Placements]
    opt_states: Dict[str, Dict[ParamKey, Placements]]


def _placements_for(x: torch.Tensor, placements: Optional[Placements]) -> Placements:
    """``placements``, or replicated where there are none or the tensor's
    rank is too low for them (JAX's guard: more sharded mesh dimensions than
    tensor dimensions, or a sharded dimension the tensor lacks)."""
    if placements is None:
        return REPLICATED
    dims = [p.dim for p in placements if isinstance(p, Shard)]
    if len(dims) > x.dim() or any(d >= x.dim() for d in dims):
        return REPLICATED
    return tuple(placements)


def train_state_shardings(mesh: DeviceMesh, ts: TrainState,
                          rules: Optional[Mapping[str, Mapping[str, Placements]]] = None
                          ) -> TrainStateShardings:
    """The placements of ``ts`` on ``mesh``: the parameters by ``rules``
    (default :data:`DEFAULT_TP_RULES`), everything else replicated."""
    rules = DEFAULT_TP_RULES if rules is None else rules
    groups = {g: {(layer, var): _placements_for(p, rules.get(layer, {}).get(var))
                  for (layer, var), p in ps.items()}
              for g, ps in ts.groups.items()}
    state = {(scope, name): REPLICATED for scope, m in scoped_modules(ts.gan).items()
             for name, _ in m.named_buffers(recurse=False)}
    opt_states = {g: {k: REPLICATED for k in ts.groups[g]} for g in ts.opt_states}
    return TrainStateShardings(mesh, groups, state, opt_states)


def apply_shardings(ts: TrainState, shardings: TrainStateShardings) -> TrainState:
    """Place ``ts`` on the mesh in place and return it: each parameter
    becomes an ``nn.Parameter`` of a DTensor (``distribute_tensor`` from rank
    0) in its module and its group, each state buffer and Adam moment a
    DTensor with its placements."""
    mesh, modules = shardings.mesh, scoped_modules(ts.gan)
    for g, ps in ts.groups.items():
        for key, p in ps.items():
            placed = nn.Parameter(distribute_tensor(p.detach(), mesh, shardings.groups[g][key]),
                                  requires_grad=p.requires_grad)
            setattr(modules[key[0]], key[1], placed)
            ps[key] = placed
    for (scope, name), placements in shardings.state.items():
        m = modules[scope]
        setattr(m, name, distribute_tensor(getattr(m, name), mesh, placements))
    for g, st in ts.opt_states.items():
        want = list(shardings.opt_states[g].values())
        st.mu = [distribute_tensor(t, mesh, pl) for t, pl in zip(st.mu, want)]
        st.nu = [distribute_tensor(t, mesh, pl) for t, pl in zip(st.nu, want)]
    return ts


def data_rows(mesh: DeviceMesh, n: int, draw: Callable[[int, int], torch.Tensor]) -> DTensor:
    """Rows ``[0, n)`` of a global batch, sharded on the mesh's ``data``
    dimension and replicated on ``model``: this rank's rows are
    ``draw(rows, first_row)``."""
    lo, hi = _local_rows(mesh, n)
    return DTensor.from_local(draw(hi - lo, lo), mesh, DATA_ROWS)


# the fields of a cycle's row by the dim that holds the batch's rows
# (CifarTrainer._cycle_row; "index" as "images"); z_base and adam are the
# same on every rank
_ROWS_DIM = {"images": 1, "labels": 1, "labels_random": 1, "labels_biased": 1,
             "labels_inv_weights": 1, "q_seeds": 1, "z": 1, "u": 1, "g_labels": 1, "zg": 0}


def _local_row(row: Mapping[str, np.ndarray], mesh: DeviceMesh) -> Dict[str, np.ndarray]:
    """This rank's rows of a cycle's row (the fields of :data:`_ROWS_DIM`
    cut to its rows of the mesh's ``data`` dimension; the rest whole)."""
    out = {}
    for k, v in row.items():
        dim = _ROWS_DIM.get("images" if k == "index" else k)
        if dim is not None:
            lo, hi = _local_rows(mesh, v.shape[dim])
            v = np.take(v, np.arange(lo, hi), axis=dim)
        out[k] = v
    return out


class _MeshRow:
    """The row ``counter`` of a cycle's block (this rank's rows,
    :func:`_local_row`) as the body reads it (the :class:`StepBlock` calls
    it makes), on the device: the batch's fields as DTensors sharded on
    ``data``, each rank holding only its rows (an index batch gathered by
    each rank from the resident dataset), the seeds and Adam's scalars as
    plain device tensors; the metrics are written whole to the block."""

    def __init__(self, block: StepBlock, trainer, mesh: DeviceMesh):
        self.block, self.trainer, self.mesh = block, trainer, mesh
        names = list(block.fields)
        if "index" in names:  # the body reads the dataset's fields
            i = names.index("index")
            names[i:i + 1] = DATASET_KEYS
        self.fields = names

    def row(self, k: str) -> torch.Tensor:
        dim = _ROWS_DIM.get(k)
        if dim is None:
            return self.block.row(k)
        if k in DATASET_KEYS and "index" in self.block.fields:
            local = self.trainer.device_dataset[k][self.block.row("index")]
        else:
            local = self.block.row(k)
        local = local.to(self.trainer._DTYPES[k]).contiguous()
        return DTensor.from_local(local, self.mesh, (Shard(dim), Replicate()))

    def write(self, name: str, value: torch.Tensor) -> None:
        self.block.write(name, value.full_tensor() if isinstance(value, DTensor) else value)

    def advance(self) -> None:
        self.block.advance()


def _local_rows(mesh: DeviceMesh, n: int) -> Tuple[int, int]:
    """This rank's rows ``[lo, hi)`` of ``n`` on the mesh's ``data``
    dimension."""
    n_data = mesh.size(0)
    if n % n_data:
        raise ValueError(f"a batch of {n} rows does not split over {n_data} data ranks")
    rows = n // n_data
    lo = mesh.get_local_rank("data") * rows
    return lo, lo + rows


@contextlib.contextmanager
def _on_mesh(trainer, mesh: DeviceMesh) -> Iterator[None]:
    """``trainer``'s body on ``mesh`` inside the block: :attr:`mesh` set and
    the confusion matrix a replicated DTensor."""
    held = trainer.confusion_actual
    trainer.mesh = mesh
    trainer.confusion_actual = DTensor.from_local(held, mesh, REPLICATED)
    try:
        yield
    finally:
        trainer.mesh, trainer.confusion_actual = None, held


def _check_placed(ts: TrainState, want: TrainStateShardings) -> None:
    for g, ps in ts.groups.items():
        for key, p in ps.items():
            if not isinstance(p, DTensor) or p.device_mesh != want.mesh \
                    or tuple(p.placements) != want.groups[g][key]:
                raise ValueError(f"{g} {key}: not placed as the rules ask (apply_shardings "
                                 f"first); got {type(p).__name__} "
                                 f"{getattr(p, 'placements', None)}")


class _MeshCycle:
    """:func:`gspmd_cycle`'s step: the cycle as a :class:`Program`
    (``program``) over this rank's rows, which captures the body at the
    first cycle of a state (after iteration 0, which has no G step and runs
    eagerly) and replays it for the next."""

    def __init__(self, trainer, mesh: DeviceMesh, rules, capture: bool):
        self.trainer, self.mesh, self.rules = trainer, mesh, rules
        self.program = Program(self._body, trainer._DTYPES, trainer.device, capture,
                               {k: (torch.float32, ()) for k in trainer.METRICS})

    def _body(self, blk: StepBlock, ts: TrainState) -> None:
        with _on_mesh(self.trainer, self.mesh):
            self.trainer._cycle(_MeshRow(blk, self.trainer, self.mesh), ts,
                                not self.program.eager_row)

    def __call__(self, ts: TrainState, d_batches: Mapping, g_labels: Mapping, iteration: int,
                 seed: int, noise: Optional[Mapping] = None):
        tr = self.trainer
        _check_placed(ts, train_state_shardings(self.mesh, ts, self.rules))
        row = _local_row(tr._cycle_row(ts, d_batches, g_labels, iteration, seed, noise),
                         self.mesh)
        # the addresses of the local tensors the cycle reads and writes
        self.program.run([row], ts, lambda: (id(self.mesh),) + train_state_key(
            ts, (tr.device_dataset or {}).values(), [tr.confusion_actual]),
            eager=int(iteration == 0))
        ts.step += 1
        return ts, {k: v[0] for k, v in self.program.read(1).items()}


def gspmd_cycle(trainer, mesh: DeviceMesh,
                rules: Optional[Mapping[str, Mapping[str, Placements]]] = None,
                graphs: Optional[bool] = None) -> Callable:
    """A training cycle of ``trainer`` (a ``CifarTrainer`` with no group)
    over ``mesh``; returns ``step(ts, d_batches, g_labels, iteration, seed,
    noise=None) -> (ts, metrics)`` with :meth:`CifarTrainer.step`'s
    arguments, the global ones on every rank.  ``ts`` must be placed by
    :func:`apply_shardings` with ``rules``' shardings; it is updated in
    place.  The batch leaves are sharded on ``data`` (dim 1 of the critic
    batches, dim 0 of the generator labels); the metrics come back whole
    on every rank.  ``graphs``: capture the cycle into a CUDA graph and
    replay it; by default on a CUDA mesh, never on a CPU mesh
    (``graphs=True`` there raises).  The step's ``program.captured`` holds
    the graph and its stats."""
    if trainer.group is not None:
        raise ValueError("gspmd_cycle runs the single-program cycle; the trainer has a group")
    if trainer.device.type != mesh.device_type:
        raise ValueError(f"trainer on {trainer.device}, mesh on {mesh.device_type}")
    return _MeshCycle(trainer, mesh, rules, capture_on(trainer.device, graphs))
