"""Conditional batch-norm forward (with an optional fused ReLU): CUDA kernel
and plain version.

Replaces the Pallas TPU kernels ``_moments_kernel`` + ``_apply_kernel``
(``rcgan_tpu/ops/pallas/norm_kernel.py``, reached through
``cond_batchnorm_fused`` / ``cond_batchnorm_bhwc``).  Same arithmetic:
per-channel f32 sums of x and x² over (batch, spatial), then
``var = max(E[x²] − mean², 0)`` and
``(x − mean) · rsqrt(var + eps) · scale[label[b]] + offset[label[b]]``,
written in ``x.dtype``; with ``relu`` the result passes through
``max(·, 0)`` before it is stored (the generator follows every cond-BN
with a ReLU, which XLA fuses on the JAX side).

The kernel is ``rcgan_tpu_torch/csrc/cond_bn.cu``: one cooperative launch
of at most one block per SM.  Each block sums its rows into per-block
partials while it keeps as many of them as fit in shared memory, the grid
meets at a barrier, every block folds the partials in block order (no
atomics: the same bits on every run), and the apply pass gathers
``scale``/``offset`` by label itself and reads what it can from shared
memory, the rest backwards out of L2.  It is bound by bytes; the source
note says more.  :func:`geometry` is the launch's shape, computed here.

The TPU's VMEM tiling rules (``_tiles``, ``_MIN_FUSED_BYTES``) have no
counterpart here: every generator map goes through the kernel.

Autograd: :class:`CondBatchNormFn` is the route on both devices, the
counterpart of ``cond_batchnorm_fused``'s ``custom_vjp`` together with the
autodiff of the table gather in ``cond_batchnorm_bhwc``.  The forward keeps
the ``mean`` and ``rsqrt(var + eps)`` it computed (and, with ``relu``, its
output, whose sign masks the incoming gradient first); the backward is the
TPU kernel's ``_bwd``, in PyTorch ops as JAX's is in jnp, all in float32:
the batch-norm VJP for ``dx`` (in ``x.dtype``) and the per-example
``Σ_S g·x̂`` and ``Σ_S g`` scattered into the float32 ``[n_labels, C]``
tables by label.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from rcgan_tpu_torch.ops.kernels import runtime

# The kernel's geometry (``csrc/cond_bn.cu``).
THREADS = 1024             # one block
_MAX_TX = 256              # 16-byte vectors across a channel block
_SMEM_BYTES = 224 * 1024   # dynamic shared memory per block, of the SM's 227 KB
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1


def _moments_plain(x: torch.Tensor, eps: float):
    """float32 ``(mean, rsqrt(var + eps))`` over (batch, spatial), with
    ``var = max(E[x²] − mean², 0)`` as the kernel computes it."""
    x32 = x.float()
    n = x.shape[0] * x.shape[1]
    mean = x32.sum(dim=(0, 1)) / n
    var = torch.clamp(x32.square().sum(dim=(0, 1)) / n - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def _apply_plain(x, labels, scale_table, offset_table, mean, inv, relu=False):
    scale = scale_table.float()[labels][:, None, :]
    offset = offset_table.float()[labels][:, None, :]
    out = (x.float() - mean) * inv * scale + offset
    return (torch.relu(out) if relu else out).to(x.dtype)


def cond_batchnorm_plain(x: torch.Tensor, labels: torch.Tensor, scale_table: torch.Tensor,
                         offset_table: torch.Tensor, eps: float = 1e-5,
                         relu: bool = False) -> torch.Tensor:
    """Plain version.  ``x [B,S,C]``; ``labels [B]`` int; tables
    ``[n_labels, C]``.  Same formula as the kernel (f32 sums, var from
    ``E[x²] − mean²`` clamped at 0, the optional ReLU), output in
    ``x.dtype``."""
    mean, inv = _moments_plain(x, eps)
    return _apply_plain(x, labels, scale_table, offset_table, mean, inv, relu)


class Geometry(NamedTuple):
    vec: int             # elements per thread per row: 16 bytes' worth, or 1
    tx: int              # vectors across a channel block (a power of two)
    cb: int              # channel blocks
    rb: int              # row blocks; the grid is cb * rb
    rows_per_block: int  # a multiple of THREADS // tx
    keep_rows: int       # rows of a block that stay in shared memory
    smem_bytes: int


def vector_width(c: int, itemsize: int, aligned: bool) -> int:
    """Elements a thread takes per row: 16 bytes' worth when every row is a
    whole number of such vectors and the tensors are ``aligned`` to 16
    bytes, else one."""
    vec = 16 // itemsize
    return vec if aligned and c % vec == 0 else 1


@functools.lru_cache(maxsize=None)
def geometry(n_rows: int, c: int, itemsize: int, vec: int, max_blocks: int) -> Geometry:
    """The launch for ``[n_rows, c]`` of ``itemsize``-byte elements, ``vec``
    to a thread, on a device that holds ``max_blocks`` blocks at once: a
    block is ``tx`` vectors wide and ``THREADS // tx`` rows tall; the rows
    are split evenly over as many row blocks as fit, and each block keeps as
    many of its rows in shared memory as there is room for."""
    cv = c // vec
    tx = 1
    while tx * 2 <= min(cv, _MAX_TX):
        tx *= 2
    ty = THREADS // tx
    cb = -(-cv // tx)
    if cb > max_blocks:
        raise ValueError(f"cond_batchnorm: {c} channels need {cb} channel blocks, more than "
                         f"the {max_blocks} blocks the device holds at once")
    per_block = -(-n_rows // (max_blocks // cb))
    rows_per_block = -(-per_block // ty) * ty
    rb = -(-n_rows // rows_per_block)
    fixed = 4 * (THREADS * vec + 2 * tx * vec)   # the fold's buffer, mean and inv
    row_bytes = tx * vec * itemsize
    keep_rows = min(rows_per_block, (_SMEM_BYTES - fixed) // row_bytes)
    return Geometry(vec, tx, cb, rb, rows_per_block, keep_rows, fixed + keep_rows * row_bytes)


def _check(x, labels, scale_table, offset_table):
    if x.dim() != 3:
        raise ValueError(f"cond_batchnorm wants x [B,S,C]; got {tuple(x.shape)}")
    b, _, c = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"cond_batchnorm takes float32 or bfloat16 x; got {x.dtype}")
    if labels.shape != (b,) or labels.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"labels must be int32/int64 [{b}]; got {labels.dtype} "
                         f"{tuple(labels.shape)}")
    for t in (scale_table, offset_table):
        if t.dim() != 2 or t.shape[1] != c or t.dtype != torch.float32:
            raise ValueError(f"affine tables must be float32 [n_labels, {c}]; got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in (x, labels, scale_table, offset_table)):
        raise ValueError("cond_batchnorm wants contiguous tensors")
    if x.numel() == 0 or x.numel() > _INT32_MAX:
        raise ValueError(f"cond_batchnorm: x of {x.numel()} elements is out of range")


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index: int, dtype_code: int, vec: int) -> int:
    """Blocks of the (dtype, vec) kernel that a cooperative launch may have
    on the device, at the largest shared memory a launch asks for."""
    fn = runtime.cuda_library("cond_bn").cond_bn_max_blocks
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    with torch.cuda.device(device_index):
        n = fn(dtype_code, vec, _SMEM_BYTES)
    if n < 1:
        raise RuntimeError(f"cond_bn: no block of the (dtype {dtype_code}, vec {vec}) kernel "
                           f"fits an SM with {_SMEM_BYTES} bytes of shared memory")
    return n


def _launch(x, labels, scale_table, offset_table, eps, relu=False):
    """The one cooperative launch; returns ``(out, mean, inv)``."""
    _check(x, labels, scale_table, offset_table)
    b, s, c = x.shape
    out = torch.empty_like(x)
    aligned = not any(t.data_ptr() % 16 for t in (x, out, scale_table, offset_table))
    code = _DTYPE_CODES[x.dtype]
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    vec = vector_width(c, x.element_size(), aligned)
    geo = geometry(b * s, c, x.element_size(), vec, _max_blocks(index, code, vec))
    # mean, inv, then the row blocks' partial sums and partial squares
    stats = torch.empty((2 + 2 * geo.rb, c), dtype=torch.float32, device=x.device)
    lib = runtime.cuda_library("cond_bn")
    fn = lib.cond_bn_forward
    if fn.argtypes is None:  # first use of this entry point
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    status = runtime.on_device(
        x, fn, x.data_ptr(), labels.data_ptr(), int(labels.dtype == torch.int64),
        scale_table.data_ptr(), offset_table.data_ptr(), out.data_ptr(), stats.data_ptr(),
        b * s, s, c, code, geo.vec, geo.tx, geo.cb, geo.rb, geo.rows_per_block, geo.keep_rows,
        geo.smem_bytes, float(eps), int(relu))
    runtime.check_cuda_status(lib, "cond_bn_error_string", status, "cond_bn launch")
    runtime.count_launch("cond_bn")
    return out, stats[0], stats[1]


class CondBatchNormFn(torch.autograd.Function):
    """``(x, labels, scale_table, offset_table, eps, relu) → out``: the CUDA
    kernel on the card, the plain version on the CPU.  Backward as the
    module note says."""

    @staticmethod
    def forward(ctx, x, labels, scale_table, offset_table, eps, relu=False):
        if runtime.on_cuda(x, labels, scale_table, offset_table):
            out, mean, inv = _launch(x, labels, scale_table, offset_table, eps, relu)
        else:
            mean, inv = _moments_plain(x, eps)
            out = _apply_plain(x, labels, scale_table, offset_table, mean, inv, relu)
        ctx.relu = relu
        ctx.save_for_backward(x, labels, scale_table, mean, inv, *((out,) if relu else ()))
        return out

    @staticmethod
    def backward(ctx, g):
        x, labels, scale_table, mean, inv = ctx.saved_tensors[:5]
        g = g.float()
        if ctx.relu:
            g = g * (ctx.saved_tensors[5] > 0)
        xhat = (x.float() - mean) * inv
        dx = dscale = doffset = None
        if ctx.needs_input_grad[0]:
            dxhat = g * scale_table.float()[labels][:, None, :]
            m1 = dxhat.mean(dim=(0, 1))
            m2 = (dxhat * xhat).mean(dim=(0, 1))
            dx = (inv * (dxhat - m1 - xhat * m2)).to(x.dtype)
        idx = labels.long()
        if ctx.needs_input_grad[2]:
            dscale = torch.zeros(scale_table.shape, dtype=torch.float32, device=g.device)
            dscale.index_add_(0, idx, (g * xhat).sum(dim=1))
        if ctx.needs_input_grad[3]:
            doffset = torch.zeros(scale_table.shape, dtype=torch.float32, device=g.device)
            doffset.index_add_(0, idx, g.sum(dim=1))
        return dx, None, dscale, doffset, None, None


def cond_batchnorm(x: torch.Tensor, labels: torch.Tensor, scale_table: torch.Tensor,
                   offset_table: torch.Tensor, eps: float = 1e-5,
                   relu: bool = False) -> torch.Tensor:
    """``x [B,S,C]``, ``labels [B]``, tables ``[n_labels, C]`` → ``[B,S,C]`` in
    ``x.dtype``, through a ReLU when ``relu``.  CPU tensors take
    :func:`cond_batchnorm_plain`; CUDA tensors launch the kernel on the
    current stream (or raise).  Differentiable on both
    (:class:`CondBatchNormFn`).  Labels must lie in ``[0, n_labels)``: the
    kernel does not check them (callers validate on the host)."""
    return CondBatchNormFn.apply(x, labels, scale_table, offset_table, eps, relu)
