"""PyTorch port of rcgan_tpu for NVIDIA Hopper GPUs.

The JAX package ``rcgan_tpu`` is the reference; this package keeps its
layout and names so each module has a counterpart there.  It imports
``torch`` and never ``jax`` or ``rcgan_tpu``.  It holds the CIFAR-10
generator's serving path (``serving.py``) and the discriminator forward:
``entry.py`` (the counterpart of ``__graft_entry__.entry()``) and the
CIFAR losses of the four algorithms (``algorithms/cifar.py``).
"""
