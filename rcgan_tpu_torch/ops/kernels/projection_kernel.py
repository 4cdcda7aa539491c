"""All-label projection logits: CUDA kernel and plain version.

Replaces the Pallas TPU kernel ``_kernel`` of
``all_label_projection_logits`` (``rcgan_tpu/ops/pallas/projection_kernel.py``):
``logits[b, l] = wgan[b] + feat[b] · emb[l]``, inputs cast to float32 and a
float32 ``[B, V]`` out, as in the TPU kernel.  The rcgan-u and unbiased
losses take it against every label's embedding.

The kernel is ``rcgan_tpu_torch/csrc/projection.cu``.  On the CIFAR path it
is tiny (``feat [64, 128]``, ``emb [10, 128]``: under 40 KB in, 2.5 KB out),
so what bounds it is the launch, not bytes or FLOPs: one launch, ``emb``
staged in shared memory, one warp per row of ``feat`` read as 16-byte
vectors and widened on load (float32, bf16 or fp16, each input its own),
exact float32 FMAs reduced by warp shuffles, ``wgan`` added in the
epilogue.  The wrapper keeps the host's cost of a call small: the entry
point's ``argtypes`` are set once, the checks are the kernel's needs, and
the stream is found by ``runtime.on_device``'s raw lookups.

The kernel stages ``emb`` whole in shared memory, so a CUDA call takes it
only where V·D is at most 12,288 (:func:`projection_route`, a rule of shape
as conv3x3's is): a wider table (BigGAN's 1000 x 1536) goes to cuBLAS, one
``torch.addmm`` in float32, counted under its variant ``addmm`` and left out
of the kernel's own count (``runtime.LIBRARY_VARIANTS``).

The call is the ``torch.library`` op ``rcgan::projection_logits(feat, emb,
wgan)``: a CPU implementation (the plain version), a CUDA one (the route,
counted there: :func:`projection_logits_cuda`) and a fake one, with two
DTensor sharding rules: rows sharded on dim 0 with ``emb`` replicated, or
everything replicated.

Autograd: :class:`ProjectionLogitsFn` calls the op on both devices.  Its backward is the
TPU kernel's ``_bwd``: ``dfeat = g·emb``, ``demb = gᵀ·feat``,
``dwgan = Σ_l g``, each cast to its primal's dtype (a float32 ``dwgan``
against a bfloat16 ``wgan`` was the bf16 regression of the JAX package).
"""

from __future__ import annotations

import ctypes

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from rcgan_tpu_torch.ops.kernels import runtime

# the kernel's type codes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# emb is staged whole in 48 KB of shared memory as float32
_MAX_EMB = 12288
_INT32_MAX = 2**31 - 1


def projection_plain(feat: torch.Tensor, emb: torch.Tensor, wgan: torch.Tensor) -> torch.Tensor:
    """Plain version: ``feat [B, D]``, ``emb [V, D]``, ``wgan [B, 1]`` →
    float32 ``[B, V]``."""
    return feat.float() @ emb.float().T + wgan.float()


def _check(feat, emb, wgan):
    if feat.dim() != 2 or emb.dim() != 2 or emb.shape[1] != feat.shape[1] \
            or wgan.shape != (feat.shape[0], 1):
        raise ValueError(f"projection wants feat [B, D], emb [V, D], wgan [B, 1]; got "
                         f"{tuple(feat.shape)}, {tuple(emb.shape)}, {tuple(wgan.shape)}")
    if any(t.dtype not in DTYPE_CODES for t in (feat, emb, wgan)):
        raise TypeError(f"projection takes float32, bfloat16 or float16; got {feat.dtype}, "
                        f"{emb.dtype}, {wgan.dtype}")
    if not (feat.is_contiguous() and emb.is_contiguous() and wgan.is_contiguous()):
        raise ValueError("projection wants contiguous tensors")


def projection_route(v: int, d: int) -> str:
    """The route of a CUDA call against ``emb [v, d]``: ``"cuda"`` (the
    kernel) where the table fits its shared memory, else ``"addmm"``."""
    return "cuda" if v * d <= _MAX_EMB else "addmm"


def _addmm(feat, emb, wgan):
    """The ``"addmm"`` route: ``wgan + feat · embᵀ`` in float32 by cuBLAS."""
    _check(feat, emb, wgan)
    out = torch.addmm(wgan.float(), feat.float(), emb.float().T)
    runtime.count_launch("projection", variant="addmm")
    return out


def _launch(feat, emb, wgan):
    _check(feat, emb, wgan)
    b, d = feat.shape
    # 16-byte vector loads of feat's rows; emb whole in shared memory
    if d % 8 or feat.data_ptr() % 16 or emb.numel() > _MAX_EMB or b * d > _INT32_MAX \
            or b == 0:
        raise ValueError(f"projection wants D a multiple of 8, feat 16-byte aligned, "
                         f"V*D <= {_MAX_EMB} and 0 < B*D < 2^31; got feat {tuple(feat.shape)} "
                         f"at {feat.data_ptr() % 16} bytes past 16, emb {tuple(emb.shape)}")
    v = emb.shape[0]
    out = torch.empty((b, v), dtype=torch.float32, device=feat.device)
    lib = runtime.cuda_library("projection")
    fn = lib.projection_logits
    if fn.argtypes is None:  # first use of this entry point
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] * 3 + [ctypes.c_void_p] \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    code = runtime.on_device(feat, fn, feat.data_ptr(), DTYPE_CODES[feat.dtype], emb.data_ptr(),
                             DTYPE_CODES[emb.dtype], wgan.data_ptr(), DTYPE_CODES[wgan.dtype],
                             out.data_ptr(), b, v, d)
    runtime.check_cuda_status(lib, "projection_error_string", code, "projection launch")
    runtime.count_launch("projection", variant="cuda")
    return out


def projection_logits_cuda(feat, emb, wgan):
    """The op's CUDA implementation: the route of ``emb``'s shape
    (:func:`projection_route`) on the current stream, or an error; tensors
    that are not all on one CUDA device raise (``runtime.on_cuda``)."""
    if not runtime.on_cuda(feat, emb, wgan):
        raise ValueError("projection_logits' CUDA implementation takes CUDA tensors")
    if emb.dim() == 2 and projection_route(*emb.shape) == "addmm":
        return _addmm(feat, emb, wgan)
    return _launch(feat, emb, wgan)


def _projection_fake(feat, emb, wgan):
    _check(feat, emb, wgan)
    return feat.new_empty((feat.shape[0], emb.shape[0]), dtype=torch.float32)


_lib = torch.library.Library("rcgan", "FRAGMENT")
_lib.define("projection_logits(Tensor feat, Tensor emb, Tensor wgan) -> Tensor")
_lib.impl("projection_logits", projection_plain, "CPU")
_lib.impl("projection_logits", projection_logits_cuda, "CUDA")
torch.library.register_fake("rcgan::projection_logits", _projection_fake, lib=_lib)
projection_logits_op = torch.ops.rcgan.projection_logits.default


@register_sharding(projection_logits_op)
def _projection_sharding(feat, emb, wgan):
    """Rows sharded (``feat`` and ``wgan`` on dim 0, ``emb`` whole), or all
    replicated."""
    return [([Shard(0)], [Shard(0), Replicate(), Shard(0)]),
            ([Replicate()], [Replicate(), Replicate(), Replicate()])]


class ProjectionLogitsFn(torch.autograd.Function):
    """``(feat, emb, wgan) → wgan + feat · embᵀ`` in float32 through
    :data:`projection_logits_op`: the CUDA kernel on the card,
    :func:`projection_plain` on the CPU."""

    @staticmethod
    def forward(ctx, feat, emb, wgan):
        out = projection_logits_op(feat, emb, wgan)
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
    CPU tensors take :func:`projection_plain`; CUDA tensors take the route
    of ``emb``'s shape on the current stream (or raise)."""
    return ProjectionLogitsFn.apply(feat, emb, wgan)
