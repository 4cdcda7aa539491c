"""Conditional batch-norm forward: Triton kernel and plain version.

Replaces the Pallas TPU kernels ``_moments_kernel`` + ``_apply_kernel``
(``rcgan_tpu/ops/pallas/norm_kernel.py``, reached through
``cond_batchnorm_fused`` / ``cond_batchnorm_bhwc``).  Same arithmetic:
per-channel f32 sums of x and x² over (batch, spatial), then
``var = max(E[x²] − mean², 0)`` and
``(x − mean) · rsqrt(var + eps) · scale[label[b]] + offset[label[b]]``,
written in ``x.dtype``.

On the H100 this is bound by memory: it reads x twice and writes it once,
and does no tensor-core work.  The design moves no byte it need not:

1. **moments** — a grid of (row chunk, channel block) programs; each sums
   its rows in registers and writes one partial per channel into
   ``[n_chunks, C]`` buffers.  The TPU's sequential grid carried the sums in
   scratch from step to step; blocks on the card run in no order, so the
   partials take its place.  No atomics: the result is the same every run.
2. **finalize** — one program per channel block folds the partials into
   ``mean`` and ``rsqrt(var + eps)`` (the jnp lines between the TPU
   kernel's two ``pallas_call``\\ s).
3. **apply** — one pass over x that gathers ``scale``/``offset`` by label
   itself, so the ``[B, C]`` per-example tables are never materialised.

The TPU's VMEM tiling rules (``_tiles``, ``_MIN_FUSED_BYTES``) have no
counterpart here: every generator map goes through the kernel.

Autograd: :class:`CondBatchNormFn` is the route on both devices, the
counterpart of ``cond_batchnorm_fused``'s ``custom_vjp`` together with the
autodiff of the table gather in ``cond_batchnorm_bhwc``.  The forward keeps
the ``mean`` and ``rsqrt(var + eps)`` it computed; the backward is the TPU
kernel's ``_bwd``, in PyTorch ops as JAX's is in jnp, all in float32: the
batch-norm VJP for ``dx`` (in ``x.dtype``) and the per-example
``Σ_S g·x̂`` and ``Σ_S g`` scattered into the float32 ``[n_labels, C]``
tables by label.
"""

from __future__ import annotations

import torch

from rcgan_tpu_torch.ops.kernels import runtime

_BLOCK_C = 128      # channels per program (C rides the fast axis)
_BLOCK_R = 32       # rows per moments step
_APPLY_ROWS = 32    # rows per apply program
_TARGET_PROGRAMS = 512  # moments grid size to aim for: ~4 per SM on 132 SMs

_kernels = None


def _moments_plain(x: torch.Tensor, eps: float):
    """float32 ``(mean, rsqrt(var + eps))`` over (batch, spatial), with
    ``var = max(E[x²] − mean², 0)`` as the kernel computes it."""
    x32 = x.float()
    n = x.shape[0] * x.shape[1]
    mean = x32.sum(dim=(0, 1)) / n
    var = torch.clamp(x32.square().sum(dim=(0, 1)) / n - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def _apply_plain(x, labels, scale_table, offset_table, mean, inv):
    scale = scale_table.float()[labels][:, None, :]
    offset = offset_table.float()[labels][:, None, :]
    return ((x.float() - mean) * inv * scale + offset).to(x.dtype)


def cond_batchnorm_plain(x: torch.Tensor, labels: torch.Tensor, scale_table: torch.Tensor,
                         offset_table: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain version.  ``x [B,S,C]``; ``labels [B]`` int; tables
    ``[n_labels, C]``.  Same formula as the kernel (f32 sums, var from
    ``E[x²] − mean²`` clamped at 0), output in ``x.dtype``."""
    mean, inv = _moments_plain(x, eps)
    return _apply_plain(x, labels, scale_table, offset_table, mean, inv)


def _build():
    """Compile-on-first-use Triton kernels.  ``triton`` is imported here, never
    at module import, so the CPU test suite (which has no triton) imports
    this module.  ``tl`` is bound as a module global because Triton resolves
    the names in a kernel's body through the module's globals."""
    global _kernels, tl
    if _kernels is not None:
        return _kernels
    import triton
    import triton.language as tl

    @triton.jit
    def moments(x_ptr, psum_ptr, psq_ptr, n_rows, n_cols, rows_per_chunk,
                BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        chunk = tl.program_id(0)
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < n_cols
        acc = tl.zeros([BLOCK_R, BLOCK_C], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK_R, BLOCK_C], dtype=tl.float32)
        r0 = chunk * rows_per_chunk
        for r in range(r0, r0 + rows_per_chunk, BLOCK_R):
            rows = r + tl.arange(0, BLOCK_R)
            mask = (rows < n_rows)[:, None] & cmask[None, :]
            offs = rows.to(tl.int64)[:, None] * n_cols + cols[None, :]
            v = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            acc += v
            acc2 += v * v
        tl.store(psum_ptr + chunk * n_cols + cols, tl.sum(acc, axis=0), mask=cmask)
        tl.store(psq_ptr + chunk * n_cols + cols, tl.sum(acc2, axis=0), mask=cmask)

    @triton.jit
    def finalize(psum_ptr, psq_ptr, mean_ptr, inv_ptr, n_chunks, n_cols, n, eps,
                 BLOCK_C: tl.constexpr):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < n_cols
        s = tl.zeros([BLOCK_C], dtype=tl.float32)
        q = tl.zeros([BLOCK_C], dtype=tl.float32)
        for i in range(0, n_chunks):
            s += tl.load(psum_ptr + i * n_cols + cols, mask=cmask, other=0.0)
            q += tl.load(psq_ptr + i * n_cols + cols, mask=cmask, other=0.0)
        mean = s / n
        var = tl.maximum(q / n - mean * mean, 0.0)
        tl.store(mean_ptr + cols, mean, mask=cmask)
        tl.store(inv_ptr + cols, 1.0 / tl.sqrt(var + eps), mask=cmask)

    @triton.jit
    def apply(x_ptr, labels_ptr, scale_ptr, offset_ptr, mean_ptr, inv_ptr, out_ptr,
              n_rows, rows_per_example, n_cols,
              BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        rmask = rows < n_rows
        cmask = cols < n_cols
        mask = rmask[:, None] & cmask[None, :]
        lab = tl.load(labels_ptr + rows // rows_per_example, mask=rmask, other=0)
        offs = rows.to(tl.int64)[:, None] * n_cols + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        mean = tl.load(mean_ptr + cols, mask=cmask, other=0.0)
        inv = tl.load(inv_ptr + cols, mask=cmask, other=0.0)
        toffs = lab.to(tl.int64)[:, None] * n_cols + cols[None, :]
        scale = tl.load(scale_ptr + toffs, mask=mask, other=0.0)
        offset = tl.load(offset_ptr + toffs, mask=mask, other=0.0)
        xhat = (x - mean[None, :]) * inv[None, :]
        out = xhat * scale + offset
        tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty), mask=mask)

    _kernels = (triton, moments, finalize, apply)
    return _kernels


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


def _launch(x, labels, scale_table, offset_table, eps):
    """The three Triton launches; returns ``(out, mean, inv)``."""
    _check(x, labels, scale_table, offset_table)
    triton, moments, finalize, apply = _build()
    b, s, c = x.shape
    n = b * s
    c_blocks = triton.cdiv(c, _BLOCK_C)
    n_chunks = max(1, min(triton.cdiv(n, _BLOCK_R), _TARGET_PROGRAMS // c_blocks))
    rows_per_chunk = triton.cdiv(triton.cdiv(n, n_chunks), _BLOCK_R) * _BLOCK_R
    n_chunks = triton.cdiv(n, rows_per_chunk)

    dev = x.device
    psum = torch.empty((n_chunks, c), dtype=torch.float32, device=dev)
    psq = torch.empty((n_chunks, c), dtype=torch.float32, device=dev)
    mean = torch.empty((c,), dtype=torch.float32, device=dev)
    inv = torch.empty((c,), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        moments[(n_chunks, c_blocks)](x, psum, psq, n, c, rows_per_chunk,
                                      BLOCK_R=_BLOCK_R, BLOCK_C=_BLOCK_C, num_warps=4)
        finalize[(c_blocks,)](psum, psq, mean, inv, n_chunks, c, float(n), float(eps),
                              BLOCK_C=_BLOCK_C, num_warps=4)
        apply[(triton.cdiv(n, _APPLY_ROWS), c_blocks)](
            x, labels, scale_table, offset_table, mean, inv, out, n, s, c,
            BLOCK_R=_APPLY_ROWS, BLOCK_C=_BLOCK_C, num_warps=4)
    runtime.count_launch("cond_bn")
    return out, mean, inv


class CondBatchNormFn(torch.autograd.Function):
    """``(x, labels, scale_table, offset_table, eps) → out``: the Triton
    kernels on the card, the plain version on the CPU.  Backward as the
    module note says."""

    @staticmethod
    def forward(ctx, x, labels, scale_table, offset_table, eps):
        if runtime.on_cuda(x, labels, scale_table, offset_table):
            out, mean, inv = _launch(x, labels, scale_table, offset_table, eps)
        else:
            mean, inv = _moments_plain(x, eps)
            out = _apply_plain(x, labels, scale_table, offset_table, mean, inv)
        ctx.save_for_backward(x, labels, scale_table, mean, inv)
        return out

    @staticmethod
    def backward(ctx, g):
        x, labels, scale_table, mean, inv = ctx.saved_tensors
        g = g.float()
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
        return dx, None, dscale, doffset, None


def cond_batchnorm(x: torch.Tensor, labels: torch.Tensor, scale_table: torch.Tensor,
                   offset_table: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x [B,S,C]``, ``labels [B]``, tables ``[n_labels, C]`` → ``[B,S,C]`` in
    ``x.dtype``.  CPU tensors take :func:`cond_batchnorm_plain`; CUDA
    tensors launch the Triton kernels on the current stream (or raise).
    Differentiable on both (:class:`CondBatchNormFn`).  Labels must lie in
    ``[0, n_labels)``: the kernel does not check them (callers validate on
    the host)."""
    return CondBatchNormFn.apply(x, labels, scale_table, offset_table, eps)
