"""Dense layers and label embedding, ported from ``rcgan_tpu/ops/linear.py``
(``linear_lib`` with optional weight norm and spectral norm, ``embed_y``
with its optional frozen table, and the MNIST stack's DCGAN ``linear``
with its max-norm clip).

``W`` keeps the JAX layout ``[in, out]``.  The product is ``torch.matmul``
in the layer's ``compute_dtype`` (``x`` and ``W`` cast at the matmul, the
bias to its output dtype), as the JAX package computes it outside any
Pallas kernel in ``ctx.compute_dtype``.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from rcgan_tpu_torch.core import initializers as inits
from rcgan_tpu_torch.core.module import Scoped
from rcgan_tpu_torch.ops.conv import add_weight_norm, weight_normed
from rcgan_tpu_torch.ops.kernels import runtime
from rcgan_tpu_torch.ops.sn import add_sn_state, spectral_normed_weight


def linear_lib(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``x [..., in] @ w [in, out] (+ b)``; leading dims are flattened and
    restored, as in the JAX function.  The bias is cast to the product's
    dtype.  On DTensors (``parallel/gspmd.py``) the output takes ``x``'s
    placements: a weight sharded on the ``model`` mesh dimension keeps its
    tensor parallelism inside the layer (a column-parallel output is
    gathered, a row-parallel one's partial sums reduced), as XLA gathers
    ``G.Input``'s output before the first conv."""
    lead = x.shape[:-1]
    out = torch.matmul(x.reshape(-1, w.shape[0]), w).reshape(*lead, w.shape[1])
    if b is not None:
        out = out + b.to(out.dtype)
    if isinstance(out, DTensor) and out.placements != x.placements:
        out = out.redistribute(x.device_mesh, x.placements)
    return out


class LinearLib(Scoped):
    """GAN_Lib Linear: ``W`` from the reference init zoo, through weight
    norm (``weightnorm``: a per-column ``g``, initialised to the initial
    columns' norms) and then spectral norm (with its ``u`` buffer), the
    reference's order; optional bias ``b``."""

    def __init__(self, input_dim: int, output_dim: int, scope: str, biases: bool = True,
                 initialization=None, gain: float = 1.0, seed: int = 0,
                 spectral_normed: bool = False, weightnorm: bool = False):
        super().__init__(scope, seed)
        self.add_param("W", (input_dim, output_dim), inits.linear_uniform(initialization, gain))
        self.weightnorm = weightnorm
        if weightnorm:
            add_weight_norm(self, "W", (0,))
        self.spectral_normed = spectral_normed
        if spectral_normed:
            add_sn_state(self, output_dim, "W")
        if biases:
            self.add_param("b", (output_dim,), inits.zeros)
        else:
            self.register_parameter("b", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.W
        if self.weightnorm:
            w = weight_normed(w, self.g, (0,))
        if self.spectral_normed:
            w = spectral_normed_weight(self, w)
        return linear_lib(x.to(self.compute_dtype), w.to(self.compute_dtype), self.b)


class Embedding(Scoped):
    """``embed_y``: a trainable ``embedding_map [vocab, emb]`` table,
    uniform(±0.08), gathered by integer label; or, given ``frozen_table``
    (pretrained embeddings, the reference's ``word2vec_file``), that table
    as state (``embedding_map_frozen``, a buffer, as JAX keeps it in
    ``ctx.stat``) that no gradient reaches."""

    def __init__(self, vocab_size: int, embedding_dim: int, scope: str, seed: int = 0,
                 frozen_table=None):
        super().__init__(scope, seed)
        self.frozen = frozen_table is not None
        if self.frozen:
            table = torch.as_tensor(frozen_table, dtype=torch.float32)
            self.add_stat("embedding_map_frozen", table.shape,
                          lambda gen, shape, dtype: table.to(dtype).clone())
        else:
            self.add_param("embedding_map", (vocab_size, embedding_dim),
                           inits.uniform_range(0.08))

    def table(self) -> torch.Tensor:
        """The whole table ``[vocab, emb]``, row ``l`` label ``l``'s embedding
        (what gathering every label in order gives, with the same
        gradient)."""
        return self.embedding_map_frozen.detach() if self.frozen else self.embedding_map

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        return take_rows(self.table(), labels)


def take_rows(table: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``table[labels]``: one row of ``table`` per label.  On DTensors each
    rank gathers for its own labels from the whole table, whose gradient is
    a partial sum where the labels are sharded (``runtime.rows_local``):
    DTensor's rules for indexing and its backward differ between PyTorch
    versions."""
    return runtime.rows_local(lambda rows, t: t[rows], labels, table)


class Linear(Scoped):
    """DCGAN linear (JAX ``linear``): normal(``stddev``) ``Matrix [in, out]``
    and a constant ``bias``.  ``max_norm`` registers a [-1, 1] clip of both
    in ``constraints`` (``{var: (lo, hi)}``), which the trainer applies
    after each update (TF's ``constraint=``,
    :func:`rcgan_tpu_torch.train.state.apply_constraints`)."""

    def __init__(self, input_dim: int, output_size: int, scope: str, stddev: float = 0.02,
                 bias_start: float = 0.0, max_norm: bool = False, seed: int = 0):
        super().__init__(scope, seed)
        self.add_param("Matrix", (input_dim, output_size), inits.normal(stddev))
        self.add_param("bias", (output_size,), inits.constant(bias_start))
        self.constraints = {"Matrix": (-1.0, 1.0), "bias": (-1.0, 1.0)} if max_norm else {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.matmul(x.to(self.compute_dtype), self.Matrix.to(self.compute_dtype))
        return out + self.bias.to(out.dtype)
