"""Steps captured in CUDA graphs: the port's stand-in for ``jax.jit`` over a
training step or a sampler pass.

The JAX package compiles each training program (``_jitted_cycle`` and
``_jitted_scan`` of ``rcgan_tpu/train/cifar_loop.py``, ``_jitted_step``
and ``_jitted_scan`` of ``rcgan_tpu/train/mnist_loop.py``) and its sampler
once per bucket size into one XLA program that runs with no host work
between its ops.  This module has no counterpart file there.  The port
runs the same step eagerly (the CPU, a data-parallel group) or, on a card,
records it once into a CUDA graph and replays it:

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
  capture that fails raises; nothing carries on eagerly.

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
after N eager steps.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, Hashable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from rcgan_tpu_torch.ops.kernels import runtime

Field = Tuple[torch.dtype, Tuple[int, ...]]  # dtype and the shape of one row
_ALIGN = 16  # bytes: every field of a row, and every row, starts on it
_NUMPY = {torch.float32: np.float32, torch.int64: np.int64, torch.int32: np.int32,
          torch.uint8: np.uint8}


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


class StepBlock:
    """Up to ``capacity`` rows of the ``fields`` (``{name: (dtype, row
    shape)}``) and of the ``outputs`` on ``device``, and a row counter.

    The inputs lie in one device buffer, a header holding the counter and
    then one record per row, so that :meth:`load` fills the counter and the
    first K rows with one copy of the buffer's first bytes; on a CUDA device
    the copy comes from one of two pinned staging buffers, used in turn,
    each written only after its last copy ended."""

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

    def load(self, rows: Mapping[str, np.ndarray]) -> int:
        """Write ``rows`` (``{name: [K, *row shape]}``, every field) to rows
        ``0..K-1`` and set the counter to 0, with one host-to-device copy;
        returns K."""
        if set(rows) != set(self.fields):
            raise ValueError(f"block fields {sorted(self.fields)}; got {sorted(rows)}")
        k = len(next(iter(rows.values())))
        if not 1 <= k <= self.capacity:
            raise ValueError(f"{k} rows for a block of {self.capacity}")
        i = self._turn
        self._turn ^= self.device.type == "cuda"
        if self._copied[i] is not None:
            self._copied[i].synchronize()  # its last copy has ended
        host = self._staging[i]
        with torch.no_grad():
            host[:8].view(torch.int64).zero_()
            for name, dt, shape in self.spec:
                arr = np.asarray(rows[name])
                if arr.shape != (k, *shape):
                    raise ValueError(f"{name}: rows of {(k, *shape)} expected; got {arr.shape}")
                self._view(host, name)[:k].numpy()[...] = arr.astype(_NUMPY[dt], copy=False)
            if host is not self._buffer:
                n = self._header + k * self._record
                self._buffer[:n].copy_(host[:n], non_blocking=True)
                self._copied[i] = torch.cuda.Event()
                self._copied[i].record(torch.cuda.current_stream(self.device))
        return k

    def row(self, name: str) -> torch.Tensor:
        """Row ``counter`` of field ``name`` (a copy, read on the device)."""
        return self.fields[name].index_select(0, self.counter)[0]

    def write(self, name: str, value: torch.Tensor) -> None:
        """``value`` into row ``counter`` of output ``name``."""
        out = self.outputs[name]
        out.index_copy_(0, self.counter, value.reshape(1, *out.shape[1:]).to(out.dtype))

    def advance(self) -> None:
        self.counter.add_(1)

    def read(self, k: int) -> Dict[str, torch.Tensor]:
        """The first ``k`` rows of every output, as new tensors (the next
        step writes the block's own)."""
        return {name: out[:k].clone() for name, out in self.outputs.items()}


def load_block(block: Optional[StepBlock], rows: Sequence[Mapping[str, np.ndarray]],
               dtypes: Mapping[str, torch.dtype], device,
               outputs: Mapping[str, Field], captured: "CapturedStep") -> StepBlock:
    """``rows`` (one dict of arrays a step) loaded into ``block``, or into a
    new block of ``len(rows)`` rows when the fields' layout changed or the
    rows outnumber it; a new block frees ``captured``'s graph, which read
    the old one.  Returns the block loaded."""
    fields = {k: (dtypes[k], np.shape(v)) for k, v in rows[0].items()}
    spec = tuple((k, dt, tuple(shape)) for k, (dt, shape) in fields.items())
    if block is None or block.spec != spec or block.capacity < len(rows):
        captured.reset()
        block = StepBlock(fields, len(rows), device, outputs=outputs)
    block.load({k: np.stack([r[k] for r in rows]) for k in rows[0]})
    return block


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
    pool, at a time."""

    def __init__(self, body: Callable[[], Any], device, capture: bool):
        self.body = body
        self.device = torch.device(device)
        self.capture = capture
        if capture and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device; got {self.device}")
        self._graph = None
        self._key: Optional[Hashable] = None
        self._held: Any = None
        self._static: Any = None
        self.launches: Optional[runtime.LaunchRecord] = None  # one replay's
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0     # host seconds of the last capture
        self.pool_bytes = 0      # device memory the last capture reserved

    def reset(self) -> None:
        """Free the graph and what it holds (the pool's memory returns to
        the allocator once nothing else refers to it)."""
        self._graph = self._static = self._held = self._key = self.launches = None

    def __call__(self, key: Hashable = None, held: Any = None) -> Any:
        """One step; returns the body's result (for a replay, the tensors the
        capture returned, which the next replay overwrites)."""
        if not self.capture:
            return self.body()
        if self._graph is None or key != self._key:
            return self._warm_up_and_capture(key, held)
        self._graph.replay()
        runtime.add_launches(self.launches)
        self.replays += 1
        return self._static

    def _warm_up_and_capture(self, key: Hashable, held: Any) -> Any:
        self.reset()
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            out = self.body()  # the step itself, eagerly
        stream.wait_stream(side)
        # what torch.cuda.graph does on entering, done first, so that the
        # reserved memory read before the capture is what it starts from
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.Stream(self.device)
        t = time.perf_counter()
        # a private pool of the graph's own: a pool outlives no graph, so a
        # new key's capture takes a new one once the old graph is freed
        with runtime.recorded_launches(capture.cuda_stream) as rec, \
                torch.cuda.device(self.device), \
                torch.cuda.graph(graph, stream=capture, capture_error_mode="thread_local"):
            static = self.body()
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self._graph, self._static, self._key, self._held = graph, static, key, held
        self.launches = rec
        self.captures += 1
        return out
