"""PyTorch port of rcgan_tpu for NVIDIA Hopper GPUs.

The JAX package ``rcgan_tpu`` is the reference; this package keeps its
layout and names so each module has a counterpart there.  It imports
``torch`` and never ``jax`` or ``rcgan_tpu``.  This slice holds the CIFAR-10
generator's serving path (``serving.py``).
"""
