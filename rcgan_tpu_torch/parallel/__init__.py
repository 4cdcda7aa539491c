"""Data parallelism over ``torch.distributed``, the counterpart of
``rcgan_tpu/parallel``: :mod:`rcgan_tpu_torch.parallel.mesh`."""

from rcgan_tpu_torch.parallel.mesh import (DataGroup, launch,  # noqa: F401
                                           maybe_initialize_distributed)
