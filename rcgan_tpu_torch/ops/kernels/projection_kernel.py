"""All-label projection logits: Triton kernel and plain version.

Replaces the Pallas TPU kernel ``_kernel`` of
``all_label_projection_logits`` (``rcgan_tpu/ops/pallas/projection_kernel.py``):
``logits[b, l] = wgan[b] + feat[b] · emb[l]``, inputs cast to float32 and a
float32 ``[B, V]`` out, as in the TPU kernel.  The rcgan-u and unbiased
losses take it against every label's embedding.

On the CIFAR path it is tiny (``feat [64, 128]``, ``emb [10, 128]``: under
40 KB in, 2.5 KB out), so what bounds it is the launch, not bytes or FLOPs.
The design is one launch and nothing else: each program takes 16 rows of
``feat`` and a 16-wide block of labels (V = 10 pads to it), accumulates the
dot products in float32 registers over 32-wide slices of D by
broadcast-multiply-and-sum (exact float32 FMAs; no TF32 rounding as a
``tl.dot`` on float32 could bring), and adds ``wgan`` in the epilogue.

Autograd: :class:`ProjectionLogitsFn` on both devices.  Its backward is the
TPU kernel's ``_bwd``: ``dfeat = g·emb``, ``demb = gᵀ·feat``,
``dwgan = Σ_l g``, each cast to its primal's dtype (a float32 ``dwgan``
against a bfloat16 ``wgan`` was the bf16 regression of the JAX package).
"""

from __future__ import annotations

import torch

from rcgan_tpu_torch.ops.kernels import runtime

_BLOCK_B = 16
_BLOCK_V = 16
_BLOCK_D = 32
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)

_kernel = None


def projection_plain(feat: torch.Tensor, emb: torch.Tensor, wgan: torch.Tensor) -> torch.Tensor:
    """Plain version: ``feat [B, D]``, ``emb [V, D]``, ``wgan [B, 1]`` →
    float32 ``[B, V]``."""
    return feat.float() @ emb.float().T + wgan.float()


def _build():
    """Compile-on-first-use Triton kernel (``triton`` is imported here, never
    at module import; ``tl`` is bound as a module global because Triton
    resolves a kernel's names through its module's globals)."""
    global _kernel, tl
    if _kernel is not None:
        return _kernel
    import triton
    import triton.language as tl

    @triton.jit
    def projection(feat_ptr, emb_ptr, wgan_ptr, out_ptr, n_rows, n_labels, dim,
                   BLOCK_B: tl.constexpr, BLOCK_V: tl.constexpr, BLOCK_D: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_B + tl.arange(0, BLOCK_B)
        labs = tl.program_id(1) * BLOCK_V + tl.arange(0, BLOCK_V)
        rmask = rows < n_rows
        lmask = labs < n_labels
        acc = tl.zeros([BLOCK_B, BLOCK_V], dtype=tl.float32)
        for d0 in range(0, dim, BLOCK_D):
            ds = d0 + tl.arange(0, BLOCK_D)
            dmask = ds < dim
            f = tl.load(feat_ptr + rows[:, None] * dim + ds[None, :],
                        mask=rmask[:, None] & dmask[None, :], other=0.0).to(tl.float32)
            e = tl.load(emb_ptr + labs[:, None] * dim + ds[None, :],
                        mask=lmask[:, None] & dmask[None, :], other=0.0).to(tl.float32)
            acc += tl.sum(f[:, None, :] * e[None, :, :], axis=2)
        wg = tl.load(wgan_ptr + rows, mask=rmask, other=0.0).to(tl.float32)
        out = acc + wg[:, None]
        tl.store(out_ptr + rows[:, None] * n_labels + labs[None, :], out,
                 mask=rmask[:, None] & lmask[None, :])

    _kernel = (triton, projection)
    return _kernel


def _check(feat, emb, wgan):
    if feat.dim() != 2 or emb.dim() != 2 or emb.shape[1] != feat.shape[1] \
            or wgan.shape != (feat.shape[0], 1):
        raise ValueError(f"projection wants feat [B, D], emb [V, D], wgan [B, 1]; got "
                         f"{tuple(feat.shape)}, {tuple(emb.shape)}, {tuple(wgan.shape)}")
    if any(t.dtype not in _FLOATS for t in (feat, emb, wgan)):
        raise TypeError(f"projection takes float tensors; got {feat.dtype}, {emb.dtype}, "
                        f"{wgan.dtype}")
    if not all(t.is_contiguous() for t in (feat, emb, wgan)):
        raise ValueError("projection wants contiguous tensors")


def _launch(feat, emb, wgan):
    _check(feat, emb, wgan)
    triton, projection = _build()
    b, d = feat.shape
    v = emb.shape[0]
    out = torch.empty((b, v), dtype=torch.float32, device=feat.device)
    with torch.cuda.device(feat.device):
        projection[(triton.cdiv(b, _BLOCK_B), triton.cdiv(v, _BLOCK_V))](
            feat, emb, wgan, out, b, v, d,
            BLOCK_B=_BLOCK_B, BLOCK_V=_BLOCK_V, BLOCK_D=_BLOCK_D, num_warps=4)
    runtime.count_launch("projection")
    return out


class ProjectionLogitsFn(torch.autograd.Function):
    """``(feat, emb, wgan) → wgan + feat · embᵀ`` in float32: the Triton
    kernel on CUDA, :func:`projection_plain` on the CPU."""

    @staticmethod
    def forward(ctx, feat, emb, wgan):
        on_card = runtime.on_cuda(feat, emb, wgan)
        out = _launch(feat, emb, wgan) if on_card else projection_plain(feat, emb, wgan)
        ctx.save_for_backward(feat, emb, wgan)
        return out

    @staticmethod
    def backward(ctx, g):
        feat, emb, wgan = ctx.saved_tensors
        g = g.float()
        dfeat = g @ emb.float()
        demb = g.T @ feat.float()
        dwgan = g.sum(dim=1, keepdim=True)
        return dfeat.to(feat.dtype), demb.to(emb.dtype), dwgan.to(wgan.dtype)


def all_label_projection_logits(feat: torch.Tensor, emb: torch.Tensor,
                                wgan: torch.Tensor) -> torch.Tensor:
    """``feat [B, D]``, ``emb [V, D]``, ``wgan [B, 1]`` → float32 ``[B, V]``.
    CPU tensors take :func:`projection_plain`; CUDA tensors launch the
    Triton kernel on the current stream (or raise)."""
    return ProjectionLogitsFn.apply(feat, emb, wgan)
