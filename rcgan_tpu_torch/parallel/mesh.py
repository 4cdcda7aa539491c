"""Data parallelism over ``torch.distributed``, the counterpart of
``rcgan_tpu/parallel/mesh.py``.

JAX's data parallelism is ``shard_map`` over a 1-D ``('data',)`` mesh:
every device runs the same cycle on its contiguous rows of the global
batch, and ``pmean`` averages the gradients, then the state, then the
metrics over the axis.  The port runs one process per rank over
``torch.distributed`` (NCCL between cards, gloo on the CPU), and a
:class:`DataGroup` takes the place of the ``Mesh``:

- rank ``r`` of ``n`` holds rows ``[r·m, (r+1)·m)`` of a global batch of
  ``n·m`` rows (:meth:`DataGroup.local_rows`), as ``shard_batch`` places
  them;
- :meth:`DataGroup.mean_` is ``pmean``: a list of tensors is flattened, per
  dtype, into one buffer, reduced by one ``all_reduce(SUM)`` and divided by
  the world size, then written back in place.  SUM then divide, because
  gloo has no ``ReduceOp.AVG``, and one rule on both backends keeps the CPU
  tests and the card alike.  Every rank receives the same sum, so ranks
  that start equal stay bit-equal;
- :meth:`DataGroup.gather_rows` is an ``out_specs`` of ``P('data')``: each
  rank's per-example rows, concatenated in rank order;
- :meth:`DataGroup.barrier`.

The trainers call these explicitly.  An NCCL group's
:meth:`DataGroup.mean_` and :meth:`DataGroup.gather_rows` are device work
and one collective each, so a CUDA graph captures them inside a trainer's
step (``train/graphs.py``): each rank captures its own graph of the same
collectives in the same order, and a replay runs them again.  gloo stages
CUDA tensors through the host, which a graph cannot capture
(:attr:`DataGroup.capturable`).  :meth:`DataGroup.any`,
:meth:`DataGroup.barrier` and :meth:`DataGroup.broadcast_object` wait on
the host and stay out of every captured step.

PyTorch's ``DistributedDataParallel``
is not used: its reducer hooks fire on ``.backward()``, while the port's
steps take gradients with ``torch.autograd.grad``, and it broadcasts
buffers from rank 0 where JAX means the state.  Nor ``SyncBatchNorm``:
under ``shard_map`` every batch norm takes its moments per shard, so a
2-rank run equals JAX's 2-device mesh.

Ranks come from a launcher (``torchrun`` sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, and
:func:`maybe_initialize_distributed` joins its group), or from
:func:`launch`, which spawns them itself.  A group that is asked for and
fails to initialise raises; there is no single-device fallback.  NCCL
refuses two ranks on one card; gloo does not, and :func:`launch` with
``backend="gloo"`` and one device for every rank checks correctness on a
one-card machine (its times say nothing of scaling).  gloo reduces CUDA
tensors through host copies.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import io
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from rcgan_tpu_torch.ops.kernels.runtime import resolve_device

DEFAULT_TIMEOUT = 600.0  # seconds: a rendezvous or a collective that hangs


@dataclasses.dataclass
class DataGroup:
    """One rank's view of the data-parallel group, the process's default
    ``torch.distributed`` group.  ``device`` is where the rank's tensors
    live; ``bytes_reduced`` counts what :meth:`mean_` sent through the
    collective since the last :meth:`reset_counts` (a host counter, no
    device sync).  A captured step's reductions are counted once per
    replay, as its kernel launches are (:meth:`recorded_bytes`), so the
    counter reads the same after N replays as after N eager steps."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    local_rank: int = 0
    bytes_reduced: int = 0
    # the record of a capture in progress: [bytes] (recorded_bytes)
    _recording: Optional[List[int]] = dataclasses.field(default=None, repr=False,
                                                        compare=False)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this group's :meth:`mean_` and
        :meth:`gather_rows`: NCCL's collectives run on the device, gloo's
        copy CUDA tensors to the host and back."""
        return self.backend == "nccl"

    @contextlib.contextmanager
    def recorded_bytes(self) -> Iterator[List[int]]:
        """Inside the block (a step's capture, which reduces nothing) the
        bytes that :meth:`mean_` would send go to the yielded ``[bytes]``
        and not to :attr:`bytes_reduced`; the owner adds them once per
        replay."""
        if self._recording is not None:
            raise RuntimeError("the group's reductions are already being recorded")
        self._recording = rec = [0]
        try:
            yield rec
        finally:
            self._recording = None

    def local_rows(self, global_rows: int) -> slice:
        """This rank's contiguous rows of a batch of ``global_rows``, which
        the world size must divide."""
        if global_rows % self.world_size:
            raise ValueError(f"a batch of {global_rows} rows does not split over "
                             f"{self.world_size} ranks")
        n = global_rows // self.world_size
        return slice(self.rank * n, (self.rank + 1) * n)

    def reset_counts(self) -> None:
        self.bytes_reduced = 0

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend reduces it: gloo takes host tensors."""
        return t.cpu() if self.backend == "gloo" and t.device.type != "cpu" else t

    @torch.no_grad()
    def mean_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Replace every tensor of ``tensors`` in place by its mean over the
        ranks (JAX ``pmean``): one flat buffer and one ``all_reduce(SUM)``
        per dtype, then a division by the world size."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            buf = self._staged(flat)
            dist.all_reduce(buf, op=dist.ReduceOp.SUM)
            buf.div_(self.world_size)
            if buf is not flat:
                flat.copy_(buf)
            n = flat.numel() * flat.element_size()
            if self._recording is None:
                self.bytes_reduced += n
            else:
                self._recording[0] += n
            torch._foreach_copy_(ts, [v.view_as(t) for v, t in
                                      zip(flat.split([t.numel() for t in ts]), ts)])

    @torch.no_grad()
    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated along dim 0 in rank
        order, on this rank's device of ``t``."""
        src = self._staged(t.contiguous())
        parts = [torch.empty_like(src) for _ in range(self.world_size)]
        dist.all_gather(parts, src)
        return torch.cat(parts).to(t.device)

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's ``obj`` (any picklable value) on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0,
                                   device=self.device if self.backend == "nccl" else None)
        return box[0]

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any (a host sync)."""
        t = self._staged(torch.tensor([float(flag)], device=self.device))
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return bool(t.item() > 0)

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def check_group(group: Optional[DataGroup], device) -> Optional[DataGroup]:
    """``group`` when it is a :class:`DataGroup` on a device of the kind
    ``device`` names (a trainer runs on its group's device)."""
    if group is None:
        return None
    if not isinstance(group, DataGroup):
        raise TypeError(f"group must be a rcgan_tpu_torch.parallel.DataGroup; got "
                        f"{type(group).__name__}")
    if torch.device(device).type != group.device.type:
        raise ValueError(f"device {device!r} and the group's {group.device} differ")
    return group


def rank_device(device, local_rank: int) -> torch.device:
    """The device of the rank with ``local_rank``: a CUDA device without an
    index becomes ``cuda:local_rank``, which must exist; an explicit index
    (every rank on one card) and the CPU are kept."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        if local_rank >= torch.cuda.device_count():
            raise ValueError(f"local rank {local_rank} needs cuda:{local_rank}; "
                             f"{torch.cuda.device_count()} card(s) present")
        dev = torch.device("cuda", local_rank)
    return dev


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _current_group(device) -> DataGroup:
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    dev = rank_device(device, local)
    return DataGroup(rank=dist.get_rank(), world_size=dist.get_world_size(), device=dev,
                     backend=dist.get_backend(), local_rank=local)


def maybe_initialize_distributed(device="cuda", backend: Optional[str] = None,
                                 timeout: float = DEFAULT_TIMEOUT) -> Optional[DataGroup]:
    """The group this process belongs to, or None when it runs alone (JAX
    ``maybe_initialize_distributed``).  A process group that is already
    initialised (by :func:`launch` or the caller) is taken as it is;
    otherwise ``RANK`` and ``WORLD_SIZE`` in the environment (a launcher
    such as ``torchrun``) join its group through ``MASTER_ADDR`` and
    ``MASTER_PORT``, with ``backend`` (NCCL for CUDA, gloo for the CPU by
    default).  A failed initialisation raises."""
    if dist.is_initialized():
        return _current_group(device)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    dev = rank_device(device, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or default_backend(dev), init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=datetime.timedelta(seconds=timeout))
    return _current_group(dev)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world_size: int, backend: str, device: str, port: int,
               args: tuple, cpu_threads: int, collective_timeout: float, results) -> None:
    """A spawned rank: join the group, run ``fn(group, *args)``, send back
    its return value (serialised by ``torch.save``) or its traceback."""
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        dev = rank_device(device, rank)
        if dev.type == "cpu":
            torch.set_num_threads(cpu_threads)
        else:
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=collective_timeout))
        try:
            group = DataGroup(rank=rank, world_size=world_size, device=dev, backend=backend,
                              local_rank=rank)
            out = fn(group, *args)
        finally:
            dist.destroy_process_group()
        buf = io.BytesIO()
        torch.save(out, buf)
        results.put((rank, "ok", buf.getvalue()))
    except BaseException:  # noqa: BLE001 -- the parent raises it
        results.put((rank, "error", traceback.format_exc()))


def _failures(world_size: int, errors: Dict[int, str], results, grace: float = 5.0) -> str:
    """The tracebacks of every rank that fails within ``grace`` seconds of
    the first: a rank that raised takes its peers' collectives down with
    it, and the first report to arrive need not be the cause."""
    end = time.monotonic() + grace
    while len(errors) < world_size and time.monotonic() < end:
        try:
            rank, status, payload = results.get(timeout=max(0.0, end - time.monotonic()))
        except queue.Empty:
            break
        if status == "error":
            errors[rank] = payload
    return f"rank(s) {sorted(errors)} of {world_size} failed:\n" + "\n".join(
        f"rank {r}: {errors[r]}" for r in sorted(errors))


def launch(fn: Callable, world_size: int, backend: Optional[str] = None,
           devices: Optional[Sequence] = None, args: tuple = (),
           timeout: Optional[float] = DEFAULT_TIMEOUT, cpu_threads: int = 1,
           collective_timeout: float = DEFAULT_TIMEOUT) -> List[Any]:
    """Run ``fn(group, *args)`` in ``world_size`` spawned processes, one per
    rank, over a group on a free local port; returns each rank's return
    value, in rank order.

    ``devices``: one per rank (default ``cuda:r`` for NCCL, the CPU for
    gloo); ``backend`` defaults to NCCL for CUDA devices and gloo for the
    CPU.  ``fn`` and ``args`` must pickle (``fn`` a module-level function),
    and return values travel through ``torch.save``.  A rank that raises,
    or a run that outlasts ``timeout`` seconds, kills every rank and raises
    (``RuntimeError`` with the rank's traceback, ``TimeoutError``);
    ``timeout=None`` waits as long as the ranks run.  A collective that
    waits longer than ``collective_timeout`` seconds fails its rank.  CPU
    ranks run ``cpu_threads`` threads each."""
    if devices is None:
        kind = resolve_device("cuda" if backend in (None, "nccl") else "cpu").type
        devices = [f"cuda:{r}" if kind == "cuda" else "cpu" for r in range(world_size)]
    devices = [str(resolve_device(d)) for d in devices]
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    backend = backend or default_backend(devices[0])
    if backend == "nccl" and len(set(devices)) < world_size:
        raise ValueError("NCCL takes one card per rank; use gloo for ranks that share one")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend, devices[r], port, args, cpu_threads,
                               collective_timeout, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got: Dict[int, Any] = {}
    deadline = time.monotonic() + (float("inf") if timeout is None else timeout)
    try:
        while len(got) < world_size:
            try:
                rank, status, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None}
                if dead:  # a result sent just before the exit is still in the pipe
                    try:
                        rank, status, payload = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(f"rank(s) exited without a result (exit codes "
                                           f"{dead})") from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks did not finish within "
                                       f"{timeout} s (finished: {sorted(got)})") from None
                else:
                    continue
            if status == "error":
                raise RuntimeError(_failures(world_size, {rank: payload}, results))
            got[rank] = torch.load(io.BytesIO(payload), weights_only=False)
        for p in procs:
            p.join(timeout=60.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [got[r] for r in range(world_size)]


# ------------------------------------------------------------------ the apps
APP_COLLECTIVE_TIMEOUT = 3600.0  # rank 0's evals and checkpoints hold the others


def join_app_group(n_devices: int, device) -> Optional[DataGroup]:
    """An app's group: the launcher's (``torchrun``) or the caller's
    (:func:`launch`), whose world size must be ``n_devices``; None when the
    process runs alone, after checking that the app can place
    ``n_devices`` ranks itself (:func:`spawn_app`): on as many cards,
    ``cuda:0`` to ``cuda:n-1``, or as gloo ranks on the CPU."""
    if dist.is_initialized() or ("RANK" in os.environ and "WORLD_SIZE" in os.environ):
        group = maybe_initialize_distributed(device, timeout=APP_COLLECTIVE_TIMEOUT)
        if group.world_size != n_devices:
            raise ValueError(f"the group has {group.world_size} ranks; the flags ask for "
                             f"{n_devices} devices")
        return group
    dev = resolve_device(device)
    if n_devices > 1 and dev.type == "cuda":
        if dev.index is not None:
            raise ValueError(f"{n_devices} ranks on {dev}: an app places one rank per card; "
                             "ranks that share a card are launched by parallel.launch with "
                             "backend='gloo'")
        if n_devices > torch.cuda.device_count():
            raise ValueError(f"{n_devices} devices asked for; {torch.cuda.device_count()} "
                             f"card(s) present")
    return None


def _app_rank(group: DataGroup, main: Callable, argv: List[str], want_stats: bool):
    """One rank of :func:`spawn_app`: the app's ``main`` in the group;
    rank 0 returns its train state (as a checkpoint payload), its result
    and its stats."""
    from rcgan_tpu_torch.train.checkpoint import state_payload

    stats = {} if want_stats else None
    ts, result = main(argv, device=str(group.device), stats=stats)
    return (state_payload(ts), result, stats) if group.is_main else None


def spawn_app(main: Callable, argv: List[str], n_devices: int, device,
              want_stats: bool = False):
    """Run ``main(argv, device=..., stats=...)`` (an app's entry point, a
    module-level function) in ``n_devices`` spawned ranks, NCCL on cards
    ``cuda:0``..., gloo on the CPU, with no deadline; returns rank 0's
    ``(state payload, result, stats)``."""
    dev = resolve_device(device)
    devices = [f"cuda:{r}" if dev.type == "cuda" else "cpu" for r in range(n_devices)]
    return launch(_app_rank, n_devices, devices=devices, args=(main, list(argv), want_stats),
                  timeout=None, cpu_threads=max(1, torch.get_num_threads() // n_devices),
                  collective_timeout=APP_COLLECTIVE_TIMEOUT)[0]
