"""CIFAR dequantisation: CUDA kernel and plain version.

Replaces the Pallas TPU kernel ``_kernel`` of ``dequantize_chw_flat`` /
``dequantize_fused`` (``rcgan_tpu/ops/pallas/dequant_kernel.py``): uint8
CHW-flat rows → ``2(x/256 − 0.5) + u`` with ``u`` in ``[0, 1/128)``, written
in HWC order as float32 ``[B, H*W*C]``.  The noise of a row comes from that
row's own seed, so a row's output is the same in any batch it sits in (the
TPU kernel's layout invariance; the trainer keys the seeds by global
example index, ``rcgan_tpu_torch/core/rng.py``).

The kernel is ``rcgan_tpu_torch/csrc/dequant.cu``: one thread per 4 pixels
of a row, ``uchar4`` loads of the channel planes and ``float4`` stores of
the HWC run, a 2-D grid (row, chunk).  Its noise is a counter-based hash,
splitmix64 as in :mod:`rcgan_tpu_torch.core.rng`:
``h = mix(mix(seed_row) ^ mix(chw))``, ``u = (h >> 40) · 2⁻²⁴ / 128``.
:func:`row_noise` computes the same hash in int64 tensor ops, so the kernel
and :func:`dequantize_plain` with :func:`row_noise` agree bit for bit, on
the card and on the CPU.  :func:`dequantize_plain` also takes any noise
``u`` as an argument (a test hands in the JAX package's).

The call is the ``torch.library`` op ``rcgan::dequantize(x, seeds,
img_size, img_dim)``: a CPU implementation (:func:`dequantize_plain` with
:func:`row_noise`), a CUDA one (the launch, counted there:
:func:`dequantize_cuda`) and a fake one, with two DTensor sharding rules:
rows sharded on dim 0, or everything replicated.
"""

from __future__ import annotations

import ctypes

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from rcgan_tpu_torch.core.rng import _mix_device
from rcgan_tpu_torch.ops.kernels import runtime

_U_SCALE = 2.0 ** -31  # the top 24 bits of the hash, times 2^-24 / 128


def dequantize_plain(x: torch.Tensor, u: torch.Tensor, img_size: int = 32,
                     img_dim: int = 3) -> torch.Tensor:
    """``x [B, C*H*W]`` integer (uint8 values), ``u [B, C*H*W]`` float32
    noise, both CHW order → float32 ``[B, H*W*C]`` in HWC order."""
    out = 2.0 * (x.float() / 256.0 - 0.5) + u
    b = x.shape[0]
    out = out.reshape(b, img_dim, img_size, img_size).permute(0, 2, 3, 1)
    return out.reshape(b, img_size * img_size * img_dim)


def row_noise(seeds: torch.Tensor, dim: int) -> torch.Tensor:
    """``[B, dim]`` float32 noise in ``[0, 1/128)`` on ``seeds``' device, in
    CHW order: element ``(i, chw)`` is the top 24 bits of
    ``mix(mix(seeds[i]) ^ mix(chw))`` times ``2⁻²⁴ / 128``, the bits the
    kernel draws."""
    base = _mix_device(seeds.to(torch.int64))
    col = _mix_device(torch.arange(dim, dtype=torch.int64, device=seeds.device))
    h = _mix_device(base[:, None] ^ col[None, :])
    return ((h >> 40) & 0xFFFFFF).to(torch.float32) * _U_SCALE


def _check(x: torch.Tensor, seeds: torch.Tensor, img_size: int, img_dim: int) -> None:
    d = img_size * img_size * img_dim
    if x.dim() != 2 or x.shape[1] != d or x.dtype != torch.uint8:
        raise ValueError(f"dequantize wants uint8 x [B, {d}]; got {x.dtype} {tuple(x.shape)}")
    if seeds.shape != (x.shape[0],) or seeds.dtype != torch.int32:
        raise ValueError(f"dequantize wants int32 seeds [{x.shape[0]}]; got {seeds.dtype} "
                         f"{tuple(seeds.shape)}")
    if not (x.is_contiguous() and seeds.is_contiguous()):
        raise ValueError("dequantize wants contiguous x and seeds")


def _launch(x: torch.Tensor, seeds: torch.Tensor, img_size: int, img_dim: int) -> torch.Tensor:
    _check(x, seeds, img_size, img_dim)
    hw = img_size * img_size
    # the kernel's uchar4 loads and float4 stores
    if hw % 4 or not 1 <= img_dim <= 4 or x.data_ptr() % 4 or x.shape[0] == 0:
        raise ValueError(f"the dequantisation kernel wants H*W a multiple of 4, 1 <= C <= 4, x "
                         f"4-byte aligned and B >= 1; got H*W {hw}, C {img_dim}, x at "
                         f"{x.data_ptr() % 4} bytes past 4, B {x.shape[0]}")
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    lib = runtime.cuda_library("dequant")
    fn = lib.dequant_chw_to_hwc
    if fn.argtypes is None:  # first use of this entry point
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    code = runtime.on_device(x, fn, x.data_ptr(), seeds.data_ptr(), out.data_ptr(), x.shape[0],
                             hw, img_dim)
    runtime.check_cuda_status(lib, "dequant_error_string", code, "dequant launch")
    runtime.count_launch("dequant")
    return out


def _dequantize_cpu(x, seeds, img_size, img_dim):
    """The op's CPU implementation: :func:`dequantize_plain` with
    :func:`row_noise`, the kernel's bits."""
    _check(x, seeds, img_size, img_dim)
    return dequantize_plain(x, row_noise(seeds, x.shape[1]), img_size, img_dim)


def dequantize_cuda(x, seeds, img_size, img_dim):
    """The op's CUDA implementation: the launch on the current stream, or an
    error; tensors that are not all on one CUDA device raise
    (``runtime.on_cuda``)."""
    if not runtime.on_cuda(x, seeds):
        raise ValueError("dequantize's CUDA implementation takes CUDA tensors")
    return _launch(x, seeds, img_size, img_dim)


def _dequantize_fake(x, seeds, img_size, img_dim):
    _check(x, seeds, img_size, img_dim)
    return x.new_empty(x.shape, dtype=torch.float32)


_lib = torch.library.Library("rcgan", "FRAGMENT")
_lib.define("dequantize(Tensor x, Tensor seeds, int img_size, int img_dim) -> Tensor")
_lib.impl("dequantize", _dequantize_cpu, "CPU")
_lib.impl("dequantize", dequantize_cuda, "CUDA")
torch.library.register_fake("rcgan::dequantize", _dequantize_fake, lib=_lib)
dequantize_op = torch.ops.rcgan.dequantize.default


@register_sharding(dequantize_op)
def _dequantize_sharding(x, seeds, img_size, img_dim):
    """Rows sharded (a row's noise comes from its own seed, so a shard's
    rows are those of the whole batch), or all replicated."""
    return [([Shard(0)], [Shard(0), Shard(0), None, None]),
            ([Replicate()], [Replicate(), Replicate(), None, None])]


def dequantize(x: torch.Tensor, seeds: torch.Tensor, img_size: int = 32,
               img_dim: int = 3) -> torch.Tensor:
    """uint8 ``x [B, C*H*W]`` (CHW order), int32 per-row ``seeds [B]`` →
    float32 ``[B, H*W*C]`` in ``[-1, 1)``, HWC order, through
    :data:`dequantize_op`.  CUDA tensors launch the CUDA kernel on the
    current stream (or raise); CPU tensors take :func:`dequantize_plain`
    with :func:`row_noise`, the same bits."""
    return dequantize_op(x, seeds, img_size, img_dim)
