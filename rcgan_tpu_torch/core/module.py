"""Parameter naming for the port, the counterpart of ``rcgan_tpu/core/module.py``.

The JAX package keeps parameters in a flat ``{layer: {var: array}}`` tree
whose layer keys are the reference's variable scopes (``G.Block.1.Conv1``)
and whose var keys are the reference's variable names (``Filters``).  The
port builds ordinary ``nn.Module`` hierarchies instead, and keeps those
names as follows:

- every layer that owns parameters is a :class:`Scoped` module whose
  ``scope`` attribute is the JAX layer key (``"G.Block.1.Conv1"``);
- its parameters are registered under the JAX var names (``Filters``,
  ``Biases``, ``W``, ``b``, ``scale``, ``offset``), so
  ``module.Filters`` is ``params["G.Block.1.Conv1"]["Filters"]``;
- the attribute path of the layer in the hierarchy
  (``block1.conv1``) is free to follow PyTorch's naming, because
  ``nn.Module`` attribute names cannot contain ``.``; :func:`param_tree`
  walks the hierarchy and keys the tree by ``scope``.

Layouts are the JAX package's (HWIO filters, ``W [in, out]``), so a tree
maps onto the modules by name alone, without transposes.

Initial values come from a ``torch.Generator`` seeded per variable from
(seed, scope/var), as ``Ctx.name_rng`` keys them in JAX: a layer's values do
not depend on the order in which layers are built.

Two pieces of ``Ctx`` live on the layers instead of a context object:

- non-trainable state (the spectral-norm ``u``) is a float32 buffer on the
  layer that owns the weight (:meth:`Scoped.add_stat`), so
  :func:`state_tree` is JAX's state tree; ``Scoped.update_sn`` (default
  True, as ``Ctx``) gates its writes and :func:`sn_updates` flips it for a
  whole sub-hierarchy, as JAX's ``sn_updates(ctx, flag)`` does;
- ``Scoped.compute_dtype`` is ``Ctx.compute_dtype``: the dtype a layer casts
  ``x`` and its weight to at a conv or matmul, set for a whole hierarchy by
  :func:`set_compute_dtype`.  Parameters stay float32.  An entry point that
  chooses float32 also calls :func:`float32_policy`, which turns TF32 off,
  so that float32 on the card is float32 throughout, as it is in JAX.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator

import torch
from torch import nn

Params = Dict[str, Dict[str, torch.Tensor]]


def _stable_hash(s: str) -> int:
    """Deterministic 31-bit string hash (Python's hash() is salted)."""
    h = 0
    for ch in s.encode():
        h = (h * 31 + ch) & 0x7FFFFFFF
    return h


def name_generator(seed: int, layer: str, name: str) -> torch.Generator:
    """CPU generator for one variable, keyed like JAX's ``Ctx.name_rng``."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(((seed & 0xFFFFFFFF) << 31) | _stable_hash(f"{layer}/{name}"))
    return gen


class Scoped(nn.Module):
    """A layer whose parameters carry a JAX scope name (see module doc)."""

    def __init__(self, scope: str, seed: int = 0):
        super().__init__()
        self.scope = scope
        self._seed = seed
        self.update_sn = True
        self.compute_dtype = torch.float32

    def add_param(self, name: str, shape, init_fn: Callable) -> nn.Parameter:
        value = init_fn(name_generator(self._seed, self.scope, name), tuple(shape), torch.float32)
        p = nn.Parameter(value)
        self.register_parameter(name, p)
        return p

    def add_stat(self, name: str, shape, init_fn: Callable) -> torch.Tensor:
        """Non-trainable float32 state (JAX ``Ctx.stat``), a buffer named
        ``name``.  Written by rebinding the attribute to a new tensor, never
        in place, so a tensor that autograd saved is never modified; the
        trainers copy a step's last value back into the buffer at the step's
        end (``train/state.py::state_in_place``), so its address holds."""
        value = init_fn(name_generator(self._seed, self.scope, name), tuple(shape), torch.float32)
        self.register_buffer(name, value)
        return value


@contextlib.contextmanager
def sn_updates(module: nn.Module, flag: bool) -> Iterator[None]:
    """Set ``update_sn`` on every layer under ``module`` for the block, then
    restore each layer's own value (JAX ``core/module.py::sn_updates``)."""
    layers = [m for m in module.modules() if isinstance(m, Scoped)]
    old = [m.update_sn for m in layers]
    for m in layers:
        m.update_sn = flag
    try:
        yield
    finally:
        for m, o in zip(layers, old):
            m.update_sn = o


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Set ``compute_dtype`` on every layer under ``module``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16; got {dtype}")
    for m in module.modules():
        if isinstance(m, Scoped):
            m.compute_dtype = dtype
    return module


def float32_policy(compute_dtype: torch.dtype) -> None:
    """The one place where the port's float32 policy is set; every entry
    point that chooses its compute dtype calls it (``Sampler``,
    ``EntryForward``, ``CifarGAN``, ``CifarTrainer``).  With float32, full
    float32 on the card, for the whole process: cuDNN runs float32
    convolutions in TF32 by default (``torch.backends.cudnn.allow_tf32``;
    the 3-channel convs, the 1x1 shortcuts and the weight grads go there),
    and TF32 matmuls, off by default, are pinned off too
    (``torch.backends.cuda.matmul.allow_tf32``).  With bfloat16 both flags
    stay as they are: no bf16 op reads them."""
    if compute_dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def scoped_modules(module: nn.Module) -> Dict[str, Scoped]:
    out: Dict[str, Scoped] = {}
    for m in module.modules():
        if isinstance(m, Scoped):
            if m.scope in out:
                raise ValueError(f"duplicate scope {m.scope!r}")
            out[m.scope] = m
    return out


def param_tree(module: nn.Module) -> Params:
    """Flat ``{scope: {var: tensor}}`` view of a module's parameters (a
    scope that holds only state, such as a depthwise filter's spectral-norm
    ``u``, is left out, as JAX's tree has no empty layer)."""
    tree = {
        scope: {name: p.detach() for name, p in m.named_parameters(recurse=False)}
        for scope, m in scoped_modules(module).items()
    }
    return {k: v for k, v in tree.items() if v}


def state_tree(module: nn.Module) -> Params:
    """Flat ``{scope: {var: tensor}}`` view of a module's buffers (the JAX
    package's non-trainable state: SN ``u`` vectors, BN moving stats)."""
    tree = {
        scope: {name: b.detach() for name, b in m.named_buffers(recurse=False)}
        for scope, m in scoped_modules(module).items()
    }
    return {k: v for k, v in tree.items() if v}


def count_params(params) -> int:
    return sum(int(x.numel() if hasattr(x, "numel") else x.size)
               for d in params.values() for x in d.values())
