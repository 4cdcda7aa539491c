"""Steps captured in CUDA graphs: the port's stand-in for ``jax.jit`` over a
training step or a sampler pass.

The JAX package compiles each training program (``_jitted_cycle`` and
``_jitted_scan`` of ``rcgan_tpu/train/cifar_loop.py``, ``_jitted_step``
and ``_jitted_scan`` of ``rcgan_tpu/train/mnist_loop.py``, PGGAN's step
per phase), its evals (the dev cost's scan, the trainers' ``sample``, the
classifier's logits and train step, the Inception score's scan, label
recovery's scan) and its sampler once per bucket size into one XLA program
each that runs with no host work between its ops.  This module has no
counterpart file there.  The port
runs the same step eagerly (the CPU, a gloo group) or, on a card, records
it once into a CUDA graph and replays it, with a data-parallel NCCL group
too: its collectives are captured into each rank's graph
(``parallel/mesh.py``), as are a DTensor step's
(``parallel/gspmd.py``):

- :class:`StepBlock` holds a step's inputs at fixed addresses: up to
  ``capacity`` rows of named fields (one row per step, so that a block of
  K steps is K rows), filled by one host-to-device copy from a pinned
  staging buffer, and a row counter on the device.  The step reads row
  ``counter`` of every field (:meth:`StepBlock.row`), writes its outputs to
  that row (:meth:`StepBlock.write`) and advances the counter
  (:meth:`StepBlock.advance`), so one captured step replayed K times walks
  a block of K rows with no host copy between them;
- :class:`CapturedStep` runs a step's body: eagerly when it does not
  capture; else, for a new ``key`` (an input shape, a train state at other
  addresses: what makes ``jax.jit`` trace again), once eagerly on a side
  stream (the warm-up, which is the step itself: every one-time piece of
  work, such as ``cudaFuncSetAttribute``, cuDNN's plans and autograd's
  first build, happens there), then captured into a CUDA graph in a
  private memory pool, and replayed for every later call with that key.  A
  capture that fails raises; nothing carries on eagerly;
- :class:`Program` is a body over the rows of a block of its own, run once
  per row by a :class:`CapturedStep` of its own (JAX's ``lax.scan`` of one
  jitted body), so that an owner holds one graph, and one pool, per
  program: a trainer's cycle graph outlives its evals'.  It is the one
  runner of a block of steps: it loads the block, keys the state, binds the
  state to the body for the call, runs any leading rows eagerly (the CIFAR
  cycle at iteration 0, which has no G step) and the rest through its
  step, and reads the outputs;
- :class:`Passes` is a forward pass captured once per input layout (JAX's
  jit per shape), one :class:`Program` each, returning a copy of the
  output.  Called inside another program's warm-up or capture, a pass runs
  its body on the given device tensors (:func:`inside_program`), so that
  one program's body may call another's pass.

A graph reads and writes every tensor at the address it had at capture, so
the state a step updates (parameters, Adam moments, SN ``u``, BN
statistics) must stay where it is: the trainers update in place and end
every step with :func:`rcgan_tpu_torch.train.state.state_in_place`, and
``train/checkpoint.py`` restores into the live tensors.  A host value
baked into a graph stays as it was captured, so every value that changes
from step to step (learning rates, Adam's bias corrections, the seeds'
bases) is a field of the block.

Launch counts: the kernel wrappers count on the host, so a replay counts
nothing.  The capture runs inside
:func:`~rcgan_tpu_torch.ops.kernels.runtime.recorded_launches`, and every
replay adds that record once, so that the counts read after N replays as
after N eager steps.  A group's ``bytes_reduced`` is recorded and added
the same way (``DataGroup.recorded_bytes``).

Spans: each :class:`CapturedStep` owns a
:class:`~rcgan_tpu_torch.utils.profiling.Spans` (``spans``), whose totals
its ``stats()`` returns: a body's device marks go there, eagerly and in its
graph, and :class:`Program` times the host part of its calls, in this order
for every program: ``key``, ``load``, ``launch``, ``read`` (the caller
times ``rows``, the host part that builds them, before).
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Any, Callable, Dict, Hashable, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from rcgan_tpu_torch.ops.kernels import runtime
from rcgan_tpu_torch.utils.profiling import Spans

Field = Tuple[torch.dtype, Tuple[int, ...]]  # dtype and the shape of one row
_ALIGN = 16  # bytes: every field of a row, and every row, starts on it
_NUMPY = {torch.float32: np.float32, torch.int64: np.int64, torch.int32: np.int32,
          torch.uint8: np.uint8}


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


_program = threading.local()  # .depth: programs warming up or capturing on this thread


def inside_program() -> bool:
    """True while this thread runs a program's warm-up or capture."""
    return getattr(_program, "depth", 0) > 0


@contextlib.contextmanager
def _in_program() -> Iterator[None]:
    _program.depth = getattr(_program, "depth", 0) + 1
    try:
        yield
    finally:
        _program.depth -= 1


def capture_on(device: torch.device, graphs: Optional[bool], group=None) -> bool:
    """Whether an owner on ``device``, in the data-parallel ``group`` (a
    ``parallel.DataGroup``) if any, captures: by default on a CUDA device
    whose group can capture its collectives (NCCL), as JAX always jits;
    ``graphs=True`` off a card, or with a gloo group, raises."""
    on_card = device.type == "cuda"
    if graphs and not on_card:
        raise ValueError(f"CUDA graphs need a CUDA device; got {device}")
    if graphs and group is not None and not group.capturable:
        raise ValueError(f"CUDA graphs cannot capture a {group.backend} group's collectives, "
                         "which stage through the host; use NCCL, or graphs=False")
    able = on_card and (group is None or group.capturable)
    return able if graphs is None else bool(graphs)


class StepBlock:
    """Up to ``capacity`` rows of the ``fields`` (``{name: (dtype, row
    shape)}``) and of the ``outputs`` on ``device``, and a row counter.

    The inputs lie in one device buffer, a header holding the counter and
    then one record per row, so that :meth:`load` fills the counter and the
    first K rows with one copy of the buffer's first bytes; on a CUDA device
    the copy comes from one of two pinned staging buffers, used in turn,
    each written only after its last copy ended.  A field whose rows are
    given as a tensor on the block's device is copied there on the device
    instead.  An output that ``outputs`` does not declare is made at its
    first :meth:`write` (a capture's warm-up, eagerly), with that value's
    shape and dtype."""

    def __init__(self, fields: Mapping[str, Field], capacity: int, device,
                 outputs: Optional[Mapping[str, Field]] = None):
        self.spec = tuple((k, dt, tuple(shape)) for k, (dt, shape) in fields.items())
        self.capacity = int(capacity)
        self.device = torch.device(device)
        offsets, rec = {}, 0
        for name, dt, shape in self.spec:
            if dt not in _NUMPY:
                raise TypeError(f"{name}: a block field's dtype must be one of {list(_NUMPY)}")
            offsets[name] = rec
            rec += _aligned(int(np.prod(shape, dtype=np.int64)) * dt.itemsize)
        self._offsets, self._record, self._header = offsets, max(rec, _ALIGN), _ALIGN
        nbytes = self._header + self.capacity * self._record
        self._buffer = torch.zeros(nbytes, dtype=torch.uint8, device=self.device)
        self.counter = self._buffer[:8].view(torch.int64)  # [1]
        self.fields = {name: self._view(self._buffer, name) for name, _, _ in self.spec}
        self.outputs = {name: torch.zeros((self.capacity, *shape), dtype=dt, device=self.device)
                        for name, (dt, shape) in (outputs or {}).items()}
        cuda = self.device.type == "cuda"
        self._staging = [torch.zeros(nbytes, dtype=torch.uint8, pin_memory=True)
                         for _ in range(2)] if cuda else [self._buffer]
        self._copied = [None, None]  # the CUDA event after each staging buffer's last copy
        self._turn = 0

    def _view(self, buf: torch.Tensor, name: str) -> torch.Tensor:
        dt, shape = next((d, s) for k, d, s in self.spec if k == name)
        off, n = self._offsets[name], int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        rows = buf[self._header:].view(self.capacity, self._record)[:, off:off + n]
        return rows.view(dt).view(self.capacity, *shape)

    def load(self, rows: Mapping[str, Any], k: Optional[int] = None) -> int:
        """Write ``rows`` (``{name: [K, *row shape]}``, every field: arrays,
        or tensors on the block's device) to rows ``0..K-1`` and set the
        counter to 0, with one host-to-device copy (and one device copy per
        tensor field); returns K (``k`` for a block with no fields)."""
        if set(rows) != set(self.fields):
            raise ValueError(f"block fields {sorted(self.fields)}; got {sorted(rows)}")
        k = len(next(iter(rows.values()))) if rows else k
        if k is None or not 1 <= k <= self.capacity:
            raise ValueError(f"{k} rows for a block of {self.capacity}")
        i = self._turn
        self._turn ^= self.device.type == "cuda"
        if self._copied[i] is not None:
            self._copied[i].synchronize()  # its last copy has ended
        host = self._staging[i]
        on_device = []
        with torch.no_grad():
            host[:8].view(torch.int64).zero_()
            for name, dt, shape in self.spec:
                arr = rows[name]
                if tuple(np.shape(arr)) != (k, *shape):
                    raise ValueError(f"{name}: rows of {(k, *shape)} expected; got "
                                     f"{tuple(np.shape(arr))}")
                if torch.is_tensor(arr) and arr.device == self._buffer.device:
                    on_device.append((name, arr))
                    continue
                arr = np.asarray(arr.detach().cpu() if torch.is_tensor(arr) else arr)
                self._view(host, name)[:k].numpy()[...] = arr.astype(_NUMPY[dt], copy=False)
            if host is not self._buffer:
                n = self._header + k * self._record
                self._buffer[:n].copy_(host[:n], non_blocking=True)
                self._copied[i] = torch.cuda.Event()
                self._copied[i].record(torch.cuda.current_stream(self.device))
            for name, arr in on_device:
                self.fields[name][:k].copy_(arr)
        return k

    def row(self, name: str) -> torch.Tensor:
        """Row ``counter`` of field ``name`` (a copy, read on the device)."""
        return self.fields[name].index_select(0, self.counter)[0]

    def write(self, name: str, value: torch.Tensor) -> None:
        """``value`` into row ``counter`` of output ``name``."""
        if name not in self.outputs:
            self.outputs[name] = torch.zeros((self.capacity, *value.shape), dtype=value.dtype,
                                             device=self.device)
        out = self.outputs[name]
        out.index_copy_(0, self.counter, value.reshape(1, *out.shape[1:]).to(out.dtype))

    def advance(self) -> None:
        self.counter.add_(1)

    def read(self, k: int) -> Dict[str, torch.Tensor]:
        """The first ``k`` rows of every output, as new tensors (the next
        step writes the block's own)."""
        return {name: out[:k].clone() for name, out in self.outputs.items()}


def state_key(tensors: Sequence[torch.Tensor]) -> Tuple[int, ...]:
    """The addresses of ``tensors``: a graph captured over them replays
    only while each still lies there."""
    return tuple(t.data_ptr() for t in tensors)


class CapturedStep:
    """``body()`` run eagerly (``capture=False``), or captured into a CUDA
    graph on ``device`` and replayed (module doc).  Each call passes the
    ``key`` of what the body reads (its inputs' shapes and the addresses of
    its state); ``held`` is kept alive while the graph is, so that the
    memory it captured is never given to another tensor.  The graph lives
    in a private memory pool of its own, freed with it: one graph, and one
    pool, at a time.  ``group``: the data-parallel group whose collectives
    the body runs; its ``bytes_reduced`` is recorded at the capture and
    added once per replay.  ``spans``: the program's host and device spans
    (module doc); the device totals start again at each capture."""

    def __init__(self, body: Callable[[], Any], device, capture: bool, group=None):
        self.body = body
        self.device = torch.device(device)
        self.capture = capture
        self.group = group
        if capture and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device; got {self.device}")
        self._graph = None
        self._key: Optional[Hashable] = None
        self._held: Any = None
        self._static: Any = None
        self.launches: Optional[runtime.LaunchRecord] = None  # one replay's
        self.bytes_reduced = 0  # what one replay reduces over the group
        self.captures = 0
        self.replays = 0
        # host seconds of the last warm-up (the eager step, to its end), of
        # the full collection and of emptying the allocator's cache after
        # it, and of the capture
        self.warm_up_s = self.gc_s = self.empty_cache_s = self.capture_s = 0.0
        self.pool_bytes = 0      # device memory the last capture reserved
        self.spans = Spans(self.device)

    def stats(self) -> Dict[str, float]:
        """``captures``, ``replays``, the host seconds of the last warm-up,
        collection, cache emptying and capture (``warm_up_s``, ``gc_s``,
        ``empty_cache_s``, ``capture_s``), the device memory the capture
        reserved (``pool_bytes``) and the totals of :attr:`spans`
        (:meth:`~rcgan_tpu_torch.utils.profiling.Spans.stats`)."""
        return {"captures": self.captures, "replays": self.replays,
                "warm_up_s": self.warm_up_s, "gc_s": self.gc_s,
                "empty_cache_s": self.empty_cache_s, "capture_s": self.capture_s,
                "pool_bytes": self.pool_bytes, **self.spans.stats()}

    def reset(self) -> None:
        """Free the graph and what it holds (the pool's memory returns to
        the allocator once nothing else refers to it)."""
        self._graph = self._static = self._held = self._key = self.launches = None

    def __call__(self, key: Hashable = None, held: Any = None) -> Any:
        """One step; returns the body's result (for a replay, the tensors the
        capture returned, which the next replay overwrites)."""
        if not self.capture:
            return self.eager()
        if self._graph is None or key != self._key:
            return self._warm_up_and_capture(key, held)
        self._graph.replay()
        runtime.add_launches(self.launches)
        if self.group is not None:
            self.group.bytes_reduced += self.bytes_reduced
        self.replays += 1
        self.spans.steps += 1
        return self._static

    def eager(self) -> Any:
        """The body once, eagerly, outside any graph (a step that no graph
        holds, such as a cycle with no G step), its marks in :attr:`spans`."""
        with self.spans.active():
            out = self.body()
        self.spans.steps += 1
        return out

    def _warm_up_and_capture(self, key: Hashable, held: Any) -> Any:
        self.reset()
        t = time.perf_counter()
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side), _in_program(), self.spans.active():
            out = self.body()  # the step itself, eagerly
        stream.wait_stream(side)
        torch.cuda.synchronize(self.device)
        self.warm_up_s = time.perf_counter() - t
        # a full collection first: a graph that only a reference cycle still
        # holds (a dropped owner's) would otherwise be freed by a collection
        # during the capture, which invalidates it; then what torch.cuda.graph
        # does on entering, so that the reserved memory read before the
        # capture is what it starts from
        t = time.perf_counter()
        gc.collect()
        self.gc_s = time.perf_counter() - t
        torch.cuda.empty_cache()
        self.empty_cache_s = time.perf_counter() - t - self.gc_s
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.Stream(self.device)
        t = time.perf_counter()
        reduced = contextlib.nullcontext([0]) if self.group is None \
            else self.group.recorded_bytes()
        # a private pool of the graph's own: a pool outlives no graph, so a
        # new key's capture takes a new one once the old graph is freed;
        # thread_local: other threads (autograd's backward, NCCL's proxy)
        # make CUDA calls while the capture runs
        with runtime.recorded_launches(capture.cuda_stream) as rec, reduced as nbytes, \
                torch.cuda.device(self.device), _in_program(), self.spans.active(), \
                torch.cuda.graph(graph, stream=capture, capture_error_mode="thread_local"):
            static = self.body()
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t
        self.spans.reset()  # the device totals cover this graph's replays
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self._graph, self._static, self._key, self._held = graph, static, key, held
        self.launches, self.bytes_reduced = rec, nbytes[0]
        self.captures += 1
        return out


class Program:
    """``body(block, state)`` over the rows of a :class:`StepBlock` of its
    own (its fields' dtypes ``dtypes``, its declared ``outputs``), run once
    per row by a :class:`CapturedStep` of its own (in ``group``, whose
    collectives the body runs): eagerly, or captured at the first row of a
    new key and replayed for the rest (JAX's ``lax.scan`` of one jitted
    body).  The body reads row ``counter`` of the fields, writes its outputs
    there and advances the counter.  The only runner of a block of steps:
    every trainer's programs, the evals' and :class:`Passes` run here."""

    def __init__(self, body: Callable[[StepBlock, Any], Any], dtypes: Mapping[str, torch.dtype],
                 device, capture: bool, outputs: Optional[Mapping[str, Field]] = None,
                 group=None):
        self.dtypes = dict(dtypes)
        self.outputs = dict(outputs or {})
        self.device = torch.device(device)
        self.block: Optional[StepBlock] = None
        self.eager_row = False  # whether the row running is one of run's leading eager rows
        self._state: Any = None
        self.captured = CapturedStep(lambda: body(self.block, self._state), self.device,
                                     capture, group)

    def run(self, rows: Sequence[Mapping[str, Any]], state: Any = None,
            key: Optional[Callable[[], Hashable]] = None, eager: int = 0) -> Any:
        """``rows`` (one dict of arrays, or of tensors on the device, a
        step) into the block, then the body once a row on ``state``, which
        the graph holds while it lives; returns the last call's result.
        ``key()`` is what the body reads (module doc): a new key captures
        again, and so does a new block (its fields' layout changed, or the
        rows outnumber it).  The first ``eager`` rows run eagerly, outside
        any graph (:attr:`eager_row` tells the body).  The host spans
        ``key``, ``load`` (the rows into the block) and ``launch`` (the
        steps run or replayed), then ``read`` of :meth:`read`, go to the
        step's ``spans``."""
        spans, k = self.captured.spans, len(rows)
        with spans.host("key", k):
            key = None if key is None else key()
        with spans.host("load", k):
            self._load(rows)
        out = None
        self._state = state
        try:
            with spans.host("launch", k):
                for i in range(k):
                    self.eager_row = i < eager
                    out = self.captured.eager() if self.eager_row else self.captured(key, state)
        finally:
            self._state, self.eager_row = None, False
        return out

    def _load(self, rows: Sequence[Mapping[str, Any]]) -> None:
        fields = {k: (self.dtypes[k], tuple(np.shape(v))) for k, v in rows[0].items()}
        spec = tuple((k, dt, shape) for k, (dt, shape) in fields.items())
        if self.block is None or self.block.spec != spec or self.block.capacity < len(rows):
            self.captured.reset()  # its graph read the old block
            self.block = StepBlock(fields, len(rows), self.device, outputs=self.outputs)

        def stacked(k):
            vs = [r[k] for r in rows]
            return torch.stack(vs) if torch.is_tensor(vs[0]) else np.stack(vs)

        self.block.load({k: stacked(k) for k in rows[0]}, k=len(rows))

    def read(self, k: int) -> Dict[str, torch.Tensor]:
        with self.captured.spans.host("read", k):
            return self.block.read(k)


class Passes:
    """``body(inputs, held, *extra)`` (``inputs``: ``{name: device
    tensor}``) captured once per ``extra`` and input shapes, one
    :class:`Program` each: JAX's jit of a forward pass per shape.  Each call
    returns a copy of the pass's output, since a replay overwrites its own.
    ``held`` is the module the pass reads: a graph replays while it, its
    parameters and its buffers lie where they lay at the capture."""

    def __init__(self, body: Callable[..., torch.Tensor], dtypes: Mapping[str, torch.dtype],
                 device, capture: bool):
        self.body, self.dtypes = body, dict(dtypes)
        self.device, self.capture = torch.device(device), capture
        self.programs: Dict[Hashable, Program] = {}

    def __call__(self, inputs: Mapping[str, Any], held: torch.nn.Module,
                 extra: Tuple = ()) -> torch.Tensor:
        if inside_program():  # the calling program's body: no block, no capture of its own
            return self.body({k: torch.as_tensor(v).to(self.device, self.dtypes[k])
                              for k, v in inputs.items()}, held, *extra).clone()
        sig = (tuple(extra), tuple((k, tuple(np.shape(v))) for k, v in inputs.items()))
        prog = self.programs.get(sig)
        if prog is None:
            prog = self.programs[sig] = Program(
                lambda blk, module: self.body({k: blk.row(k) for k in blk.fields}, module,
                                              *extra),
                self.dtypes, self.device, self.capture)
        return prog.run([dict(inputs)], held, lambda: (id(held), state_key(
            list(held.parameters()) + list(held.buffers())))).clone()
