"""Dense layer, ported from ``rcgan_tpu/ops/linear.py::linear_lib``.

``W`` keeps the JAX layout ``[in, out]``.  The product is ``torch.matmul``:
the JAX package computes it outside any Pallas kernel too.  Spectral norm
and weight norm are not ported yet (the discriminator slice needs them).
"""

from __future__ import annotations

import torch

from rcgan_tpu_torch.core import initializers as inits
from rcgan_tpu_torch.core.module import Scoped


def linear_lib(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``x [..., in] @ w [in, out] (+ b)``; leading dims are flattened and
    restored, as in the JAX function."""
    lead = x.shape[:-1]
    out = torch.matmul(x.reshape(-1, w.shape[0]), w).reshape(*lead, w.shape[1])
    if b is not None:
        out = out + b
    return out


class LinearLib(Scoped):
    """GAN_Lib Linear: ``W`` from the reference init zoo, optional bias ``b``."""

    def __init__(self, input_dim: int, output_dim: int, scope: str, biases: bool = True,
                 initialization=None, gain: float = 1.0, seed: int = 0):
        super().__init__(scope, seed)
        self.add_param("W", (input_dim, output_dim), inits.linear_uniform(initialization, gain))
        if biases:
            self.add_param("b", (output_dim,), inits.zeros)
        else:
            self.register_parameter("b", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_lib(x, self.W, self.b)
