"""Hand-written Hopper kernels (CUDA C++), each beside its plain
PyTorch version.  Counterpart of ``rcgan_tpu/ops/pallas``."""
