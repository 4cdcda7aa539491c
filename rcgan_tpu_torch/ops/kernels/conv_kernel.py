"""3x3, stride 1, SAME convolution (NHWC x HWIO): two CUDA kernels, the
cuDNN route for ragged channel counts, and the plain version.

Replaces the Pallas TPU kernel ``_conv3x3_kernel`` / ``conv3x3_fused``
(``rcgan_tpu/ops/pallas/conv_kernel.py``).  Both kernels are an implicit
GEMM with M = B*H*W, N = O, K = 9*C, float32 accumulation and the output in
the input dtype.  Which route a CUDA call takes is a pure function of its
shape and dtype, :func:`conv3x3_variant`:

- ``"wgmma"``, ``rcgan_tpu_torch/csrc/conv3x3_wgmma.cu``: bf16 on the
  tensor cores, operands brought by TMA (SAME padding by the TMA's zero
  fill), for bf16 calls with C and O multiples of 64 whose maps split into
  whole rows or whole images per 128-pixel tile (:func:`wgmma_geometry`);
- ``"ffma"``, ``rcgan_tpu_torch/csrc/conv3x3.cu``: the other calls with C
  and O multiples of 64, on the CUDA cores: float32 (serving, with TF32
  off) and bf16 calls whose maps do not tile.  Its tile, and its split of
  K where no tile fills the card, come from :func:`ffma_geometry`;
- ``"cudnn"``: every other shape (on the main path G's 256 -> 3 output
  conv, D's 3 -> 128 first conv and their input grads) goes to ``F.conv2d``
  on channels-last views, under the caller's TF32 setting.  The TPU kernel
  takes only C and O multiples of 128 (its ``supported``) and hands every
  other 3x3 conv to XLA; the hand-written class here, multiples of 64, is a
  superset of that.  The route is a rule of shape, not a fallback.

A failure in either kernel raises; nothing falls back to another route or
to the plain version.  Each kernel launch counts under ``conv3x3`` and under
its variant; a ``"cudnn"`` call counts under its variant only
(``runtime.variant_counts("conv3x3")``).  Both kernels are bound by
arithmetic on the H100; the source notes say how each answers it.

The forward is the ``torch.library`` op ``rcgan::conv3x3(x, w) -> Tensor``
(:data:`conv3x3_op`), so that the dispatcher routes it by device and
``torch.export`` keeps it as one node: its ``CPU`` implementation is
:func:`conv3x3_plain`, its ``CUDA`` implementation :func:`conv3x3_cuda`
(the route above, counted where it launches), and its fake implementation
gives the output's shape and dtype only, so that tracing runs no kernel
and counts nothing.  Its DTensor sharding rules (``register_sharding``,
for ``parallel/gspmd.py``): the batch sharded on dim 0 with the filter
replicated, or everything replicated.

Autograd: :class:`Conv3x3Fn` is the route on both devices, the counterpart
of ``conv3x3_fused``'s ``custom_vjp``.  Its backward is the TPU kernel's
``_bwd``: the input grad is another 3x3/s1/SAME conv, of the cotangent with
the spatially flipped, io-transposed filter, so it goes through
:func:`conv3x3` and takes the route of its own shape (a ragged conv's input
grad is ragged too); the weight grad is the batch-reducing conv that JAX
leaves to XLA, here cuDNN's (or the CPU's) ``convolution_backward``.  Each
runs only when its input takes a gradient, and each cotangent is in its
primal's dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from rcgan_tpu_torch.ops.kernels import runtime

_FFMA_ENTRY = {torch.float32: "conv3x3_ffma_f32", torch.bfloat16: "conv3x3_ffma_bf16"}
_INT32_MAX = 2**31 - 1
# The hand-written class: C and O multiples of 64.
CHANNEL_MULTIPLE = 64
# The FFMA kernel's square tiles, largest first, and the channels per K step
# of each.
FFMA_TILES = (128, 64, 32, 16)
FFMA_BK = {128: 32, 64: 16, 32: 16, 16: 16}


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x [B,H,W,C]``, ``w [3,3,C,O]`` → ``[B,H,W,O]`` in
    ``x.dtype``, computed in float32.  Runs ``F.conv2d`` on permuted views."""
    out = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3 wants x [B,H,W,C] and w [3,3,C,O]; got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _FFMA_ENTRY or w.dtype != x.dtype:
        raise TypeError(f"conv3x3 takes float32 or bfloat16, x and w alike; got "
                        f"{x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3 wants contiguous NHWC x and HWIO w")
    b, h, wd, _ = x.shape
    if max(x.numel(), b * h * wd * w.shape[3], w.numel()) > _INT32_MAX:
        raise ValueError("conv3x3 indexes with 32-bit ints; tensor too large")


def _box(h: int, w: int, bm: int):
    """``(rows, imgs)`` of the TMA box ``[64, W, rows, imgs]`` that covers a
    tile of ``bm`` output pixels (``imgs * rows * W == bm``): whole rows of
    one image where ``bm`` divides H*W, whole images where H*W divides
    ``bm``; else None."""
    if w > bm or bm % w:
        return None
    if h * w >= bm:
        return (bm // w, 1) if (h * w) % bm == 0 else None
    return (h, bm // (h * w)) if bm % (h * w) == 0 else None


def conv3x3_variant(x_shape, o: int, dtype: torch.dtype) -> str:
    """The route of a CUDA call with input shape ``[B,H,W,C]``, ``o`` output
    channels and ``dtype``: ``"cudnn"`` unless C and O are multiples of 64;
    then ``"wgmma"`` (tensor cores) for bf16 with a map that tiles by 128
    pixels, else ``"ffma"``.  A function of shape and dtype only."""
    _, h, w, c = x_shape
    if c % CHANNEL_MULTIPLE or o % CHANNEL_MULTIPLE:
        return "cudnn"
    if dtype == torch.bfloat16 and _box(h, w, 128) is not None:
        return "wgmma"
    return "ffma"


def _blocks(m: int, o: int, bm: int, bn: int) -> int:
    return -(-m // bm) * -(-o // bn)


def wgmma_geometry(x_shape, o: int, sms: int):
    """``(bm, bn, rows, imgs)`` of a tensor-core launch on a card with
    ``sms`` SMs: the tile is 128 x 256 where O is a multiple of 256 and that
    tile still gives three quarters of a wave of blocks, else 64 x 128 where
    128 x 128 would leave fewer blocks than the card has SMs (and the map
    tiles by 64), else 128 x 128; the x box is ``[64, W, rows, imgs]``."""
    b, h, w, _ = x_shape
    m = b * h * w
    if o % 256 == 0 and _blocks(m, o, 128, 256) >= sms * 3 // 4:
        bm, bn = 128, 256
    elif _blocks(m, o, 128, 128) < sms and _box(h, w, 64) is not None:
        bm, bn = 64, 128
    else:
        bm, bn = 128, 128
    rows, imgs = _box(h, w, bm)
    return bm, bn, rows, imgs


def ffma_geometry(x_shape, o: int, sms: int):
    """``(bm, bn, splits)`` of an FFMA launch on a card with ``sms`` SMs:
    the largest of the square tiles ``FFMA_TILES`` that gives at least one
    block per SM, unsplit.  Each tile sums every output as one chain of FMAs
    over K in order, so the choice of tile changes no result.  Where even
    16 x 16 tiles are fewer than the SMs, 64 x 64 tiles with K split into
    ``splits`` slices (whole K steps, at most one slice per step) so that
    blocks times splits reach the SM count; splitting reorders the sum."""
    b, h, w, c = x_shape
    m = b * h * w
    for t in FFMA_TILES:
        if _blocks(m, o, t, t) >= sms:
            return t, t, 1
    blocks = _blocks(m, o, 64, 64)
    return 64, 64, min(-(-sms // blocks), 9 * c // FFMA_BK[64])


def ffma_k_ranges(c: int, bm: int, splits: int):
    """``[(k_begin, k_end), ...]``: the slice of K = 9*C (tap-major,
    channel-minor) that each split of an FFMA launch with tile ``bm``
    sums, as the kernel computes it: split ``z`` takes K steps
    ``z*S//splits`` to ``(z+1)*S//splits`` of the ``S = 9*C/BK``."""
    bk = FFMA_BK[bm]
    steps = 9 * c // bk
    return [(z * steps // splits * bk, (z + 1) * steps // splits * bk) for z in range(splits)]


def _launch_ffma(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    b, h, wd, c = x.shape
    o = w.shape[3]
    bm, bn, splits = ffma_geometry(x.shape, o, runtime.sm_count(x))
    y = torch.empty((b, h, wd, o), dtype=x.dtype, device=x.device)
    # split-K partial sums, float32, one [M, O] slice per split
    ws = (torch.empty((splits, b * h * wd, o), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    # 16-byte cp.async copies and stores
    if any(t.data_ptr() % 16 for t in (x, w, y, ws) if t is not None):
        raise ValueError("conv3x3 ffma wants 16-byte aligned x, w, y and workspace")
    lib = runtime.cuda_library("conv3x3")
    fn = getattr(lib, _FFMA_ENTRY[x.dtype])
    if fn.argtypes is None:  # first use of this entry point
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    code = runtime.on_device(x, fn, x.data_ptr(), w.data_ptr(), y.data_ptr(),
                             ws.data_ptr() if ws is not None else None, b, h, wd, c, o, bm, bn,
                             splits)
    runtime.check_cuda_status(lib, "conv3x3_error_string", code, "conv3x3 ffma launch")
    runtime.count_launch("conv3x3", variant="ffma")
    return y


def _launch_wgmma(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    b, h, wd, c = x.shape
    o = w.shape[3]
    bm, bn, rows, imgs = wgmma_geometry(x.shape, o, runtime.sm_count(x))
    y = torch.empty((b, h, wd, o), dtype=x.dtype, device=x.device)
    # TMA reads from 16-byte aligned addresses with 16-byte multiple strides
    if any(t.data_ptr() % 16 for t in (x, w, y)) or (c * 2) % 16 or (o * 2) % 16:
        raise ValueError("conv3x3 wgmma wants 16-byte aligned x, w, y and C, O multiples of 8")
    lib = runtime.cuda_library("conv3x3_wgmma")
    fn = lib.conv3x3_wgmma_bf16
    if fn.argtypes is None:  # first use of this entry point
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    code = runtime.on_device(x, fn, x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, c, o, bm,
                             bn, rows, imgs)
    runtime.check_cuda_status(lib, "conv3x3_wgmma_error_string", code, "conv3x3 wgmma launch")
    runtime.count_launch("conv3x3", variant="wgmma")
    return y


def _launch_cudnn(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The ``"cudnn"`` route: ``F.conv2d`` on NCHW views of NHWC ``x`` (a
    channels-last tensor, so the output is one too) and HWIO ``w``."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    runtime.count_launch("conv3x3", variant="cudnn")
    return out.permute(0, 2, 3, 1).contiguous()


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check(x, w)
    route = conv3x3_variant(x.shape, w.shape[-1], x.dtype)
    if route == "wgmma":
        return _launch_wgmma(x, w)
    if route == "ffma":
        return _launch_ffma(x, w)
    return _launch_cudnn(x, w)


def conv3x3_weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dw [3,3,C,O]`` of a 3x3/s1/SAME conv from ``x [B,H,W,C]`` and the
    cotangent ``g [B,H,W,O]``, in ``x.dtype``: the reduction over the batch
    that JAX's ``_bwd`` hands to XLA, here ``aten.convolution_backward`` on
    NCHW views of the NHWC tensors (cuDNN on the card); on DTensors each
    rank's rows, a partial sum (``runtime.rows_reduced``)."""
    return runtime.rows_reduced(_weight_grad, x, g)


def _weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    b, h, wd, c = x.shape
    o = g.shape[3]
    weight = x.new_empty((o, c, 3, 3))  # only its shape is read
    _, dw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), weight, None, [1, 1], [1, 1], [1, 1],
        False, [0, 0], 1, [False, True, False])
    return dw.permute(2, 3, 1, 0).contiguous()


def conv3x3_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The op's CUDA implementation: the route :func:`conv3x3_variant`
    names, on the current stream, or an error; tensors that are not all on
    one CUDA device raise (``runtime.on_cuda``)."""
    if not runtime.on_cuda(x, w):
        raise ValueError("conv3x3's CUDA implementation takes CUDA tensors")
    return _launch(x, w)


def _conv3x3_fake(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check(x, w)
    return x.new_empty((*x.shape[:3], w.shape[3]))


_lib = torch.library.Library("rcgan", "FRAGMENT")
_lib.define("conv3x3(Tensor x, Tensor w) -> Tensor")
_lib.impl("conv3x3", conv3x3_plain, "CPU")
_lib.impl("conv3x3", conv3x3_cuda, "CUDA")
torch.library.register_fake("rcgan::conv3x3", _conv3x3_fake, lib=_lib)
conv3x3_op = torch.ops.rcgan.conv3x3.default


@register_sharding(conv3x3_op)
def _conv3x3_sharding(x, w):
    """The batch sharded (``x`` on dim 0, the filter whole), or all
    replicated."""
    return [([Shard(0)], [Shard(0), Replicate()]), ([Replicate()], [Replicate(), Replicate()])]


def _flipped_filter(w: torch.Tensor) -> torch.Tensor:
    """``[3,3,C,O] → [3,3,O,C]``, spatially flipped: the input grad's filter."""
    return torch.flip(w, (0, 1)).transpose(2, 3).contiguous()


class Conv3x3Fn(torch.autograd.Function):
    """``(x, w) → conv`` through :data:`conv3x3_op`: a CUDA kernel or cuDNN by
    shape on the card, :func:`conv3x3_plain` on the CPU.  Backward as the
    module note says."""

    @staticmethod
    def forward(ctx, x, w):
        out = conv3x3_op(x, w)
        ctx.save_for_backward(x, w)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # a DTensor filter whole on each rank, as the op takes it: DTensor
            # has no rule for flip in every PyTorch version
            dx = conv3x3(g, runtime.replicated_local(_flipped_filter, w))
        if ctx.needs_input_grad[1]:
            dw = conv3x3_weight_grad(x, g).to(w.dtype)
        return dx, dw


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3/s1/SAME conv.  CPU tensors take :func:`conv3x3_plain`; CUDA
    tensors take the route :func:`conv3x3_variant` names on the current
    stream (or raise).  Differentiable on both (:class:`Conv3x3Fn`)."""
    return Conv3x3Fn.apply(x, w)
