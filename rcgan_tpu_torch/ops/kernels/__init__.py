"""Hand-written Hopper kernels (CUDA C++), each beside its plain
PyTorch version.  Counterpart of ``rcgan_tpu/ops/pallas``.

Importing the package registers the ``torch.library`` ops of all the
kernels, each with its DTensor sharding rules: ``rcgan::conv3x3``,
``rcgan::cond_batchnorm``, ``rcgan::upsample2x`` (``conv_kernel``,
``norm_kernel``, ``resample_kernel``; all that a program exported by
``torch.export`` from a sampler needs to load and run,
``rcgan_tpu_torch/exported.py``), ``rcgan::mean_pool`` (``resample_kernel``),
``rcgan::sn_group`` (``sn_kernel``), ``rcgan::projection_logits``
(``projection_kernel``) and ``rcgan::dequantize`` (``dequant_kernel``)."""

from rcgan_tpu_torch.ops.kernels import (conv_kernel, dequant_kernel,  # noqa: F401  (register
                                         norm_kernel, projection_kernel,  # the ops)
                                         resample_kernel, sn_kernel)
