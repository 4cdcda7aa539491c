"""3x3, stride 1, SAME convolution (NHWC x HWIO): CUDA kernel and plain version.

Replaces the Pallas TPU kernel ``_conv3x3_kernel`` / ``conv3x3_fused``
(``rcgan_tpu/ops/pallas/conv_kernel.py``).  The kernel itself is
``rcgan_tpu_torch/csrc/conv3x3.cu``: an implicit GEMM with M = B*H*W,
N = O, K = 9*C, f32 accumulation, output in the input dtype (float32 or
bfloat16).  It is bound by FMA throughput on the H100; the source note in
the ``.cu`` file says how its tiling answers that.

The TPU kernel took only C and O that are multiples of 128 (its lane
width) and padded its input with ``jnp.pad``.  The port masks ragged C and
O and handles the halo with bounds checks, so every 3x3/s1/SAME call is in
its class, the generator's 256 -> 3 output conv included.

Autograd: :class:`Conv3x3Fn` is the route on both devices, the counterpart
of ``conv3x3_fused``'s ``custom_vjp``.  Its backward is the TPU kernel's
``_bwd``: the input grad is another 3x3/s1/SAME conv, of the cotangent with
the spatially flipped, io-transposed filter, so it goes through
:func:`conv3x3` and on the card launches this kernel; the weight grad is the
batch-reducing conv that JAX leaves to XLA, here cuDNN's (or the CPU's)
``convolution_backward``.  Each runs only when its input takes a gradient,
and each cotangent is in its primal's dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rcgan_tpu_torch.ops.kernels import runtime

_ENTRY = {torch.float32: "conv3x3_nhwc_f32", torch.bfloat16: "conv3x3_nhwc_bf16"}
_INT32_MAX = 2**31 - 1


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x [B,H,W,C]``, ``w [3,3,C,O]`` → ``[B,H,W,O]`` in
    ``x.dtype``, computed in float32.  Runs ``F.conv2d`` on permuted views."""
    out = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3 wants x [B,H,W,C] and w [3,3,C,O]; got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _ENTRY or w.dtype != x.dtype:
        raise TypeError(f"conv3x3 takes float32 or bfloat16, x and w alike; got "
                        f"{x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3 wants contiguous NHWC x and HWIO w")
    b, h, wd, _ = x.shape
    if max(x.numel(), b * h * wd * w.shape[3], w.numel()) > _INT32_MAX:
        raise ValueError("conv3x3 indexes with 32-bit ints; tensor too large")


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check(x, w)
    b, h, wd, c = x.shape
    o = w.shape[3]
    y = torch.empty((b, h, wd, o), dtype=x.dtype, device=x.device)
    lib = runtime.cuda_library("conv3x3")
    fn = getattr(lib, _ENTRY[x.dtype])
    if fn.argtypes is None:  # first use of this entry point
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, c, o, stream)
    runtime.check_cuda_status(lib, "conv3x3_error_string", code, "conv3x3 launch")
    runtime.count_launch("conv3x3")
    return y


def conv3x3_weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dw [3,3,C,O]`` of a 3x3/s1/SAME conv from ``x [B,H,W,C]`` and the
    cotangent ``g [B,H,W,O]``, in ``x.dtype``: the reduction over the batch
    that JAX's ``_bwd`` hands to XLA, here ``aten.convolution_backward`` on
    NCHW views of the NHWC tensors (cuDNN on the card)."""
    b, h, wd, c = x.shape
    o = g.shape[3]
    weight = x.new_empty((o, c, 3, 3))  # only its shape is read
    _, dw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), weight, None, [1, 1], [1, 1], [1, 1],
        False, [0, 0], 1, [False, True, False])
    return dw.permute(2, 3, 1, 0).contiguous()


class Conv3x3Fn(torch.autograd.Function):
    """``(x, w) → conv``: the CUDA kernel on the card, :func:`conv3x3_plain`
    on the CPU.  Backward as the module note says."""

    @staticmethod
    def forward(ctx, x, w):
        out = _launch(x, w) if runtime.on_cuda(x, w) else conv3x3_plain(x, w)
        ctx.save_for_backward(x, w)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            w_t = torch.flip(w, (0, 1)).transpose(2, 3).contiguous()  # [3,3,O,C]
            dx = conv3x3(g, w_t)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_weight_grad(x, g).to(w.dtype)
        return dx, dw


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3/s1/SAME conv.  CPU tensors take :func:`conv3x3_plain`; CUDA
    tensors launch the CUDA kernel on the current stream (or raise).
    Differentiable on both (:class:`Conv3x3Fn`)."""
    return Conv3x3Fn.apply(x, w)
