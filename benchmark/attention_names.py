"""The device kernels of the attention op's fused backends, from the names
the profiler gives them: PyTorch's flash attention (``flash_fwd``,
``flash_bwd``) and its memory-efficient attention (CUTLASS's
``fmha_cutlass``), the two that ``rcgan_tpu_torch/ops/attention.py``
allows.  ``kernel_names.py`` classes every other kernel."""

from __future__ import annotations

ATTENTION = ("flash_fwd", "flash_bwd", "fmha_cutlass")


def is_attention(name: str) -> bool:
    return any(k in name for k in ATTENTION)
