"""Device operations by kind, from the names the profiler gives them.

- the program's hand-written kernels (``rcgan_tpu_torch/csrc/*.cu``), and
  of them the convolutions;
- cuDNN's kernels, which the program calls for convolutions only (its
  forward, data-gradient and weight-gradient kernels and their helpers);
- the matrix products of cuBLAS and CUTLASS (``gemm``, ``gemv`` and their
  split-K reductions).  cuDNN and PyTorch may run a 1x1 convolution as
  such a product, whose name does not tell it from a linear layer's;
- the optimiser's kernels: PyTorch's ``_foreach`` ops run as
  ``multi_tensor_apply_kernel``, and ``ScalelessAdam`` is the only caller
  of those in a training step.
"""

from __future__ import annotations

PORT_CONV = ("conv3x3_wgmma_kernel", "conv3x3_ffma_kernel", "splitk_sum_kernel")
PORT = PORT_CONV + ("cond_bn_kernel", "sn_group_kernel", "projection_kernel", "dequant_kernel")
_LIB_GEMM = ("gemm", "gemv", "cutlass", "xmma", "cublas")


def is_port(name: str) -> bool:
    return any(k in name for k in PORT)


def is_conv(name: str) -> bool:
    """A kernel of a convolution: the program's conv3x3 kernels, or cuDNN's."""
    return any(k in name for k in PORT_CONV) or (not is_port(name) and "cudnn" in name.lower())


def is_gemm(name: str) -> bool:
    low = name.lower()
    return not is_conv(name) and not is_port(name) and any(k in low for k in _LIB_GEMM)


def is_adam(name: str) -> bool:
    return "multi_tensor_apply" in name
