"""Parallelism over ``torch.distributed``, the counterpart of
``rcgan_tpu/parallel``: data parallelism with one process per rank
(:mod:`rcgan_tpu_torch.parallel.mesh`, JAX's ``shard_map`` path) and GSPMD,
the single-program cycle partitioned over a ``('data', 'model')`` mesh of
DTensors (:mod:`rcgan_tpu_torch.parallel.gspmd`)."""

from rcgan_tpu_torch.parallel.gspmd import (DEFAULT_TP_RULES,  # noqa: F401
                                            apply_shardings, gspmd_cycle, make_dp_tp_mesh,
                                            train_state_shardings)
from rcgan_tpu_torch.parallel.mesh import (DataGroup, launch,  # noqa: F401
                                           maybe_initialize_distributed)
