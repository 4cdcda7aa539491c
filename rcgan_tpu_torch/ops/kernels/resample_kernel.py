"""The 2x2 mean pool and the 2x nearest upsample of NHWC maps: two CUDA
kernels, their plain versions, and their gradients.

``rcgan_tpu_torch/csrc/resample.cu`` holds ``pool2x2_kernel`` (the mean of
each 2x2 window, its four phases added in JAX's order (0,0), (1,0), (0,1),
(1,1) and rounded to the dtype after each add, as the separate tensor adds
round) and ``up2x2_kernel`` (each pixel of phase (a, b)'s map written to its
place in the 2x2 window, times ``s``).  They replace no TPU kernel: the JAX
package leaves ``mean_pool`` and ``upsample_depth_to_space`` to XLA, which
fuses them; under PyTorch's autograd the same slicing and concatenation cost
zero-fills, strided copies and full-size adds, about 17 times the bytes the
work needs.

Two ``torch.library`` ops, each with a CPU implementation (the plain
versions), a CUDA one (the launch, counted under ``pool2x2`` or ``up2x2``)
and a fake one, and two DTensor sharding rules (rows sharded on dim 0, or
everything replicated), with their gradients registered
(``register_autograd``), the same on both devices:

- ``rcgan::mean_pool(x)`` is ``mean_pool``.  Its gradient is the upsample
  at 1/4 (``up2x2``): each input position gets one term, ``g/4``, so it is
  value-equal to autograd's of the plain form (a zero's sign aside);
- ``rcgan::upsample2x(x00, x01, x10, x11, scale)`` writes phase (a, b) from
  map ``x_ab``; ``upsample_depth_to_space`` passes its input as all four
  maps at scale 1 (the kernel then reads it once), as the plain form's
  channel concat x4 passes it four times.  Its gradient is the cotangent's
  four strided phases, one per map, which autograd adds into the input's
  gradient in the concat's order, after or before the input's other
  gradients as the graph orders them: bit-equal to autograd of the plain
  form, where a summed 2x2 kernel would round the phases' sum before the
  other gradients join it.

A CUDA input must be contiguous, float32 or bf16, under 2^31 elements on
either side, and, for the pool, of even height and width; anything else
raises, and nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from rcgan_tpu_torch.ops.kernels import runtime

_INT32_MAX = 2**31 - 1
_DTYPES = (torch.float32, torch.bfloat16)
_PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))  # the upsample's maps, in the concat's order


def mean_pool_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version, JAX's ``ops/conv.py::mean_pool``: the four strided
    phases of NHWC ``x`` added in the order (0,0), (1,0), (0,1), (1,1), then
    divided by 4."""
    return (x[:, ::2, ::2, :] + x[:, 1::2, ::2, :] + x[:, ::2, 1::2, :]
            + x[:, 1::2, 1::2, :]) / 4.0


def upsample_plain(x00: torch.Tensor, x01: torch.Tensor, x10: torch.Tensor,
                   x11: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Plain version: NHWC maps ``[B, H, W, C]`` interleaved into ``[B, 2H,
    2W, C]``, phase (a, b) from ``x_ab`` (times ``scale``), by JAX's
    ``upsample_depth_to_space`` with its four channel blocks the four maps:
    one map four times is the 2x nearest-neighbour upsample.
    (``F.pixel_shuffle`` on NCHW groups channels as ``c*4+k`` and would mix
    channels.)"""
    b, h, w, c = x00.shape
    y = torch.cat([x00, x01, x10, x11], dim=3)
    y = y.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h * 2, w * 2, c)
    return y if scale == 1.0 else y * scale


def _check_pool(x: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"mean_pool wants x [B, H, W, C] with H and W even; got "
                         f"{tuple(x.shape)}")


def _check_up(maps) -> None:
    if maps[0].dim() != 4 or any(m.shape != maps[0].shape or m.dtype != maps[0].dtype
                                 for m in maps):
        raise ValueError(f"upsample2x wants four maps [B, H, W, C] of one shape and dtype; got "
                         f"{[(tuple(m.shape), m.dtype) for m in maps]}")


# C entry point and its arguments after the pointers, by kernel: bf16, rows
# (the smaller map's pixels), its width, C, (the upsample's scale,) SMs, stream
_ENTRIES = {
    "pool2x2": ("resample_pool2x2", 2, []),
    "up2x2": ("resample_up2x2", 5, [ctypes.c_float]),
}


def _launch(kernel: str, ins, out: torch.Tensor, rows: int, w: int, *args) -> torch.Tensor:
    """Launch ``kernel`` (:data:`_ENTRIES`) on the current stream of the
    inputs ``ins`` into ``out``, ``rows`` and ``w`` the smaller map's pixels
    and width; one count a launch, and no launch for an empty map."""
    x = ins[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f"{kernel} takes float32 or bfloat16; got {x.dtype}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError(f"{kernel} wants contiguous NHWC maps")
    if max(x.numel(), out.numel()) > _INT32_MAX:
        raise ValueError(f"{kernel} indexes with 32-bit ints; tensor too large")
    if not out.numel():
        return out
    name, pointers, extra = _ENTRIES[kernel]
    lib = runtime.cuda_library("resample")
    fn = getattr(lib, name)
    if fn.argtypes is None:  # first use of this entry point
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_int] * 2 + extra + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    code = runtime.on_device(x, fn, *(t.data_ptr() for t in ins), out.data_ptr(),
                             int(x.dtype == torch.bfloat16), rows, w, x.shape[3], *args,
                             runtime.sm_count(x))
    runtime.check_cuda_status(lib, "resample_error_string", code, f"{kernel} launch")
    runtime.count_launch(kernel)
    return out


def mean_pool_cuda(x: torch.Tensor) -> torch.Tensor:
    """The pool op's CUDA implementation: ``pool2x2_kernel`` on the current
    stream, or an error."""
    if not runtime.on_cuda(x):
        raise ValueError("mean_pool's CUDA implementation takes CUDA tensors")
    _check_pool(x)
    b, h, w, c = x.shape
    out = x.new_empty((b, h // 2, w // 2, c))
    return _launch("pool2x2", (x,), out, b * (h // 2) * (w // 2), w // 2)


def upsample2x_cuda(x00: torch.Tensor, x01: torch.Tensor, x10: torch.Tensor,
                    x11: torch.Tensor, scale: float) -> torch.Tensor:
    """The upsample op's CUDA implementation: ``up2x2_kernel`` on the
    current stream, or an error."""
    maps = (x00, x01, x10, x11)
    if not runtime.on_cuda(*maps):
        raise ValueError("upsample2x's CUDA implementation takes CUDA tensors")
    _check_up(maps)
    b, h, w, c = x00.shape
    out = x00.new_empty((b, 2 * h, 2 * w, c))
    return _launch("up2x2", maps, out, b * h * w, w, scale)


def _mean_pool_cpu(x):
    _check_pool(x)
    return mean_pool_plain(x)


def _upsample2x_cpu(x00, x01, x10, x11, scale):
    _check_up((x00, x01, x10, x11))
    return upsample_plain(x00, x01, x10, x11, scale)


def _mean_pool_fake(x):
    _check_pool(x)
    b, h, w, c = x.shape
    return x.new_empty((b, h // 2, w // 2, c))


def _upsample2x_fake(x00, x01, x10, x11, scale):
    _check_up((x00, x01, x10, x11))
    b, h, w, c = x00.shape
    return x00.new_empty((b, 2 * h, 2 * w, c))


_lib = torch.library.Library("rcgan", "FRAGMENT")
_lib.define("mean_pool(Tensor x) -> Tensor")
_lib.define("upsample2x(Tensor x00, Tensor x01, Tensor x10, Tensor x11, float scale) -> Tensor")
_lib.impl("mean_pool", _mean_pool_cpu, "CPU")
_lib.impl("mean_pool", mean_pool_cuda, "CUDA")
_lib.impl("upsample2x", _upsample2x_cpu, "CPU")
_lib.impl("upsample2x", upsample2x_cuda, "CUDA")
torch.library.register_fake("rcgan::mean_pool", _mean_pool_fake, lib=_lib)
torch.library.register_fake("rcgan::upsample2x", _upsample2x_fake, lib=_lib)
mean_pool_op = torch.ops.rcgan.mean_pool.default
upsample2x_op = torch.ops.rcgan.upsample2x.default


def _pool_backward(ctx, g):
    """The pool's gradient: ``g/4`` to each of its window's four inputs."""
    g = g.contiguous()
    return upsample2x_op(g, g, g, g, 0.25)


def _upsample_setup(ctx, inputs, output):
    ctx.scale = inputs[4]


def _upsample_backward(ctx, g):
    """Each map's gradient: its phase of ``g`` (times the scale), a strided
    view, for autograd to add up as the module doc says."""
    grads = tuple(g[:, a::2, b::2, :] for a, b in _PHASES)
    if ctx.scale != 1.0:
        grads = tuple(t * ctx.scale for t in grads)
    return (*grads, None)


torch.library.register_autograd("rcgan::mean_pool", _pool_backward,
                                setup_context=lambda ctx, inputs, output: None, lib=_lib)
torch.library.register_autograd("rcgan::upsample2x", _upsample_backward,
                                setup_context=_upsample_setup, lib=_lib)


@register_sharding(mean_pool_op)
def _mean_pool_sharding(x):
    """Rows sharded (each image pools on its own), or all replicated."""
    return [([Shard(0)], [Shard(0)]), ([Replicate()], [Replicate()])]


@register_sharding(upsample2x_op)
def _upsample2x_sharding(x00, x01, x10, x11, scale):
    return [([Shard(0)], [Shard(0)] * 4 + [None]), ([Replicate()], [Replicate()] * 4 + [None])]


def mean_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool of NHWC ``x``, JAX's ``mean_pool`` bit for bit: the CUDA
    kernel on the card, :func:`mean_pool_plain` on the CPU; differentiable."""
    return mean_pool_op(x.contiguous())


def upsample_depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of NHWC ``x``, JAX's
    ``upsample_depth_to_space`` bit for bit, forward and gradient: the CUDA
    kernel on the card, :func:`upsample_plain` on the CPU; differentiable."""
    x = x.contiguous()
    return upsample2x_op(x, x, x, x, 1.0)
