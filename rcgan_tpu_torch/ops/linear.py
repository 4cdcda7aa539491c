"""Dense layer and label embedding, ported from ``rcgan_tpu/ops/linear.py``
(``linear_lib`` with optional spectral norm, ``embed_y``).

``W`` keeps the JAX layout ``[in, out]``.  The product is ``torch.matmul``
in the layer's ``compute_dtype`` (``x`` and ``W`` cast at the matmul, the
bias to its output dtype), as the JAX package computes it outside any
Pallas kernel in ``ctx.compute_dtype``.  Weight norm and ``embed_y``'s
frozen-table branch are not ported yet.
"""

from __future__ import annotations

import torch

from rcgan_tpu_torch.core import initializers as inits
from rcgan_tpu_torch.core.module import Scoped
from rcgan_tpu_torch.ops.sn import add_sn_state, spectral_normed_weight


def linear_lib(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``x [..., in] @ w [in, out] (+ b)``; leading dims are flattened and
    restored, as in the JAX function.  The bias is cast to the product's
    dtype."""
    lead = x.shape[:-1]
    out = torch.matmul(x.reshape(-1, w.shape[0]), w).reshape(*lead, w.shape[1])
    if b is not None:
        out = out + b.to(out.dtype)
    return out


class LinearLib(Scoped):
    """GAN_Lib Linear: ``W`` from the reference init zoo, optionally
    spectral-normed (with its ``u`` buffer), optional bias ``b``."""

    def __init__(self, input_dim: int, output_dim: int, scope: str, biases: bool = True,
                 initialization=None, gain: float = 1.0, seed: int = 0,
                 spectral_normed: bool = False):
        super().__init__(scope, seed)
        self.add_param("W", (input_dim, output_dim), inits.linear_uniform(initialization, gain))
        self.spectral_normed = spectral_normed
        if spectral_normed:
            add_sn_state(self, output_dim, "W")
        if biases:
            self.add_param("b", (output_dim,), inits.zeros)
        else:
            self.register_parameter("b", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.W
        if self.spectral_normed:
            w = spectral_normed_weight(self, w)
        return linear_lib(x.to(self.compute_dtype), w.to(self.compute_dtype), self.b)


class Embedding(Scoped):
    """``embed_y``: a trainable ``embedding_map [vocab, emb]`` table,
    uniform(±0.08), gathered by integer label."""

    def __init__(self, vocab_size: int, embedding_dim: int, scope: str, seed: int = 0):
        super().__init__(scope, seed)
        self.add_param("embedding_map", (vocab_size, embedding_dim), inits.uniform_range(0.08))

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        return self.embedding_map[labels]
