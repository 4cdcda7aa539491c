"""Hand-written Hopper kernels (CUDA C++ and Triton), each beside its plain
PyTorch version.  Counterpart of ``rcgan_tpu/ops/pallas``."""
