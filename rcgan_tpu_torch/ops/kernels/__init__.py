"""Hand-written Hopper kernels (CUDA C++), each beside its plain
PyTorch version.  Counterpart of ``rcgan_tpu/ops/pallas``.

Importing the package registers the ``torch.library`` ops ``rcgan::conv3x3``
and ``rcgan::cond_batchnorm`` (``conv_kernel``, ``norm_kernel``), which is
all that a program exported by ``torch.export`` from a sampler needs to
load and run (``rcgan_tpu_torch/exported.py``)."""

from rcgan_tpu_torch.ops.kernels import conv_kernel, norm_kernel  # noqa: F401  (register the ops)
