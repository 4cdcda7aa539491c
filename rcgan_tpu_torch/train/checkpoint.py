"""Checkpoint and resume, the counterpart of ``rcgan_tpu/train/checkpoint.py``
(reference: ``tf.train.Saver``, ``cifar10/gan_resnet.py:905-914``, with
``max_to_keep=5`` and auto-resume from the latest checkpoint).

The whole train state is saved: every group's parameters (confusion logits
included), the SN ``u`` state, each group's Adam ``count``, ``mu`` and
``nu`` (in their stored dtype), and ``step``.  One checkpoint is one
directory ``<directory>/<step>/`` holding ``train_state.pt``
(``torch.save`` of CPU tensors keyed ``"<layer>/<var>"``), written under a
temporary name and renamed, so a killed writer never leaves a checkpoint
that looks whole.  Saves are asynchronous: the state is copied to the host
at once (the only part that waits on the device) and written by a
background thread; :meth:`Checkpointer.close` and every read wait for it.

``optimistic_restore`` loads what matches by name and shape
(``common/misc.py:275-307``).

Under data parallelism (``group=``, a
:class:`~rcgan_tpu_torch.parallel.mesh.DataGroup`) the state is replicated:
rank 0 alone copies it to the host and writes it, every rank calls
``save``, ``restore`` and ``close`` at the same points, and
:meth:`Checkpointer.wait` ends at a barrier of all ranks, so that no rank
reads a step while rank 0 still writes it; every rank restores the same
whole state.

Under GSPMD (``parallel/gspmd.py``) the state is DTensors on a device mesh:
every rank calls ``save`` and gathers each leaf whole (``full_tensor()``, a
collective), and global rank 0 writes the same ``train_state.pt``, so both
paths share one format; :meth:`Checkpointer.wait` then ends at a barrier of
the process group.  :meth:`Checkpointer.restore_sharded` reads that file on
every rank into an unplaced template and places each leaf on the requested
mesh and placements (``apply_shardings``), so a state saved from one mesh
shape restores onto any other.  JAX's orbax reads only each device's shards
(OCDBT/zarr); the port reads the whole file on every rank, because the
whole CIFAR train state is a few tens of MB (65.262 MB all-reduced per
rcgan cycle at full width, ``PERF.md``), which a rank holds at once anyway
before it places it.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import TYPE_CHECKING, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from rcgan_tpu_torch.core.module import state_tree
from rcgan_tpu_torch.parallel.gspmd import TrainStateShardings, apply_shardings
from rcgan_tpu_torch.train.state import TrainState, train_state_tensors

if TYPE_CHECKING:
    from rcgan_tpu_torch.parallel.mesh import DataGroup

FILE = "train_state.pt"


def _key(layer: str, var: str) -> str:
    return f"{layer}/{var}"


def state_payload(ts: TrainState) -> dict:
    """``ts`` as nested dicts of CPU tensor copies and ints; a DTensor leaf
    is gathered whole first (a collective: every rank of its mesh calls
    this)."""
    def cpu(t):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        return t.detach().to("cpu", copy=True)

    return {
        "groups": {g: {_key(*k): cpu(p) for k, p in ps.items()} for g, ps in ts.groups.items()},
        "state": {_key(layer, var): cpu(t) for layer, d in state_tree(ts.gan).items()
                  for var, t in d.items()},
        "opt_states": {g: {"count": st.count,
                           "mu": {_key(*k): cpu(t) for k, t in zip(ts.groups[g], st.mu)},
                           "nu": {_key(*k): cpu(t) for k, t in zip(ts.groups[g], st.nu)}}
                       for g, st in ts.opt_states.items()},
        "step": int(ts.step),
    }


def _copy_into(dst: torch.Tensor, src: torch.Tensor, what: str) -> None:
    if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
        raise ValueError(f"{what}: checkpoint holds {src.dtype} {tuple(src.shape)}, the train "
                         f"state {dst.dtype} {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src)


def load_payload(ts: TrainState, payload: dict, strict: bool = True) -> int:
    """Copy ``payload`` into ``ts`` in place: every parameter, moment and
    state buffer (SN ``u``, BN statistics) is written into the live tensor,
    which keeps its address (a captured step reads it there); then counts
    and step.  ``strict``: every leaf must be there with its shape
    and dtype, else raise; otherwise only leaves that match by name and
    shape are loaded.  Returns the number of leaves loaded."""
    loaded = 0

    def take(tree: dict, key: str, dst: torch.Tensor, what: str) -> Optional[torch.Tensor]:
        src = tree.get(key)
        if src is None or tuple(src.shape) != tuple(dst.shape) \
                or (strict and src.dtype != dst.dtype):
            if strict:
                raise KeyError(f"{what} {key}: missing or of another shape or dtype in the "
                               f"checkpoint")
            return None
        return src

    groups = payload.get("groups", {})
    if strict and set(groups) != set(ts.groups):
        raise KeyError(f"checkpoint groups {sorted(groups)}, train state {sorted(ts.groups)}")
    for g, ps in ts.groups.items():
        for k, p in ps.items():
            src = take(groups.get(g, {}), _key(*k), p, f"param of {g}")
            if src is not None:
                _copy_into(p, src.to(p.dtype), f"{g} {_key(*k)}")
                loaded += 1
    for layer, d in state_tree(ts.gan).items():
        for var, t in d.items():
            src = take(payload.get("state", {}), _key(layer, var), t, "state")
            if src is not None:
                _copy_into(t, src.to(t.dtype), f"state {_key(layer, var)}")
                loaded += 1
    for g, st in ts.opt_states.items():
        saved = payload.get("opt_states", {}).get(g)
        if saved is None:
            if strict:
                raise KeyError(f"checkpoint has no optimiser state of {g}")
            continue
        keys = list(ts.groups[g])
        for mom in ("mu", "nu"):
            for k, t in zip(keys, getattr(st, mom)):
                src = take(saved[mom], _key(*k), t, f"Adam {mom} of {g}")
                if src is not None:
                    _copy_into(t, src.to(t.dtype), f"{g} {mom} {_key(*k)}")
                    loaded += 1
        st.count = int(saved["count"])
        loaded += 1
    if "step" in payload:
        ts.step = int(payload["step"])
        loaded += 1
    elif strict:
        raise KeyError("checkpoint has no step")
    return loaded


class Checkpointer:
    """``save``/``restore``/``latest_step``/``close`` over ``directory``,
    keeping the newest ``max_to_keep`` checkpoints.  With ``group``, rank 0
    writes and every rank waits for it (module doc)."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 group: Optional["DataGroup"] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.group = group
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._on_mesh = False  # a DTensor state was saved: waits end at a barrier

    def steps(self):
        """The steps of the whole checkpoints on disk, ascending."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(os.path.join(self.directory, n, FILE)))

    def _write(self, step: int, payload: dict) -> None:
        try:
            tmp = os.path.join(self.directory, f".{step}.tmp-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(payload, os.path.join(tmp, FILE))
            final = os.path.join(self.directory, str(step))
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self.steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        except BaseException as e:  # raised to the caller by the next wait
            self._error = e

    def wait(self) -> None:
        """Finish the save in flight, then, with a group, wait for every
        rank; raise what the save raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.group is not None:
            self.group.barrier()
        elif self._on_mesh:
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint write to {self.directory} failed") from err

    def save(self, step: int, ts: TrainState, wait: bool = False) -> None:
        """Save ``ts`` as checkpoint ``step``: the device-to-host copy now,
        the write in the background (``wait=True`` or :meth:`close`
        finishes it).  With a group, only rank 0 copies and writes; a DTensor
        state is gathered by every rank and written by global rank 0."""
        self.wait()
        self._on_mesh = any(isinstance(t, DTensor) for t in train_state_tensors(ts))
        if self._on_mesh:
            payload = state_payload(ts)
            main = dist.get_rank() == 0
        else:
            main = self.group is None or self.group.is_main
            payload = state_payload(ts) if main else None
        if main:
            self._thread = threading.Thread(target=self._write, args=(step, payload),
                                            daemon=True)
            self._thread.start()
        if wait:
            self.wait()

    def close(self) -> None:
        self.wait()

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self.steps()
        return steps[-1] if steps else None

    def read(self, step: Optional[int] = None) -> Optional[Tuple[int, dict]]:
        """``(step, payload)`` of checkpoint ``step`` (default the latest);
        None when there is none."""
        if step is None:
            step = self.latest_step()
        else:
            self.wait()
        if step is None:
            return None
        payload = torch.load(os.path.join(self.directory, str(step), FILE), map_location="cpu",
                             weights_only=True)
        return step, payload

    def restore(self, ts_template: TrainState, step: Optional[int] = None
                ) -> Optional[TrainState]:
        """Load checkpoint ``step`` (default the latest) into
        ``ts_template`` in place and return it; None when there is no
        checkpoint (the template is then untouched).  The checkpoint must
        match the template leaf for leaf, in name, shape and dtype."""
        got = self.read(step)
        if got is None:
            return None
        load_payload(ts_template, got[1], strict=True)
        return ts_template


    def restore_sharded(self, ts_template: TrainState, shardings: TrainStateShardings,
                        step: Optional[int] = None) -> Optional[TrainState]:
        """Load checkpoint ``step`` (default the latest), saved from any
        mesh or none, into the unplaced ``ts_template`` (plain tensors, the
        same model), then place every leaf on ``shardings.mesh`` with the
        placements ``shardings`` gives (``parallel.gspmd.apply_shardings``)
        and return it; None when there is no checkpoint.  Every rank of the
        mesh calls it."""
        if any(isinstance(t, DTensor) for t in train_state_tensors(ts_template)):
            raise ValueError("restore_sharded takes an unplaced template; it places the "
                             "state itself")
        got = self.read(step)
        if got is None:
            return None
        load_payload(ts_template, got[1], strict=True)
        return apply_shardings(ts_template, shardings)


def optimistic_restore(ts_template: TrainState, directory: str) -> Tuple[TrainState, int]:
    """Shape-tolerant partial restore from the latest checkpoint under
    ``directory``: loads, in place, only the leaves whose name and shape
    match the template.  Returns ``(ts_template, n_loaded)``."""
    got = Checkpointer(directory).read()
    if got is None:
        return ts_template, 0
    return ts_template, load_payload(ts_template, got[1], strict=False)
