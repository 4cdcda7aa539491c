"""Train state and the scaleless Adam, the counterpart of
``rcgan_tpu/train/state.py``.

JAX threads an immutable pytree (grouped params, SN state, one optax state
per group, step) through its compiled cycle.  The port keeps the same
pieces, but the parameters and the SN ``u`` state live in the model
(:class:`~rcgan_tpu_torch.algorithms.cifar.CifarGAN`) and are updated in
place, which saves a copy of every parameter per update:

- ``groups``: the model's parameters split by the partition predicates
  (``disc`` = ``D.*``, ``gen`` = ``G.*``, ``confusion`` =
  ``confusion_logits`` for rcgan-u), keyed ``(scope, var)`` as the JAX
  trees are;
- ``opt_states``: one :class:`AdamState` per group;
- ``step``: a host int, so the cycle never reads it back from the device.

:class:`ScalelessAdam` is optax's ``scale_by_adam`` ∘ ``scale(-1)`` times a
learning rate that the caller passes every step (``scaleless_adam`` +
``apply_updates_with_lr``): bias-corrected moments, eps outside the square
root, written with ``torch._foreach`` ops in optax's order.  The learning
rate and the bias corrections are read from a small device tensor
(:meth:`ScalelessAdam.apply_`), so that a step captured in a CUDA graph
(``train/graphs.py``) replays with each step's values.  The moments
are float32, or stored in a narrower dtype (``moment_dtype="bfloat16"``,
JAX's ``_scale_by_adam_lowp``): widened to float32 for the update, then
rounded back for storage.

:func:`apply_constraints` is the post-update clip of the MNIST projection
discriminator's max-norm linears (TF's ``constraint=``), registered on the
layers (:func:`constraints_of`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from rcgan_tpu_torch.core.module import scoped_modules
from rcgan_tpu_torch.train.graphs import state_key

ParamKey = Tuple[str, str]  # (scope, var)


@dataclasses.dataclass
class AdamState:
    count: int                 # host int, optax's ``count``
    mu: List[torch.Tensor]     # moment_dtype (float32), in the order of the group's params
    nu: List[torch.Tensor]


class ScalelessAdam:
    """``p ← p − lr · m̂ / (√v̂ + eps)`` with ``m̂, v̂`` optax's bias-corrected
    moments.  ``moment_dtype`` (a torch dtype name such as ``"bfloat16"``)
    stores both moments in that dtype; the arithmetic stays float32 and the
    update uses the float32 moments before they are rounded, as JAX's
    ``_scale_by_adam_lowp``."""

    def __init__(self, b1: float, b2: float, eps: float = 1e-8,
                 moment_dtype: Optional[str] = None):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.moment_dtype = torch.float32
        if moment_dtype is not None:
            dt = getattr(torch, str(moment_dtype), None)
            if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
                raise ValueError(f"moment_dtype must name a torch floating dtype; got "
                                 f"{moment_dtype!r}")
            self.moment_dtype = dt

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        zeros = [torch.zeros_like(p, dtype=self.moment_dtype) for p in params]
        return AdamState(0, zeros, [torch.zeros_like(z) for z in zeros])

    def scalars(self, count: int, lr: float) -> np.ndarray:
        """``[5]`` float32: ``lr``, optax's two bias corrections at step
        ``count`` (``1 − b1^count``, ``1 − b2^count``) and their reciprocals,
        computed on the host, what :meth:`apply_` reads from a device
        tensor."""
        bc1, bc2 = _bias_correction(self.b1, count), _bias_correction(self.b2, count)
        return np.array([lr, bc1, bc2, 1.0 / bc1, 1.0 / bc2], np.float32)

    def update_(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                state: AdamState, lr: float) -> None:
        """One step in place on ``params`` and ``state``, advancing
        ``state.count``; its scalars go to the device with one copy."""
        state.count += 1
        scalars = torch.from_numpy(self.scalars(state.count, lr))
        self.apply_(params, grads, state, scalars.to(params[0].device, non_blocking=True))

    @torch.no_grad()
    def apply_(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               state: AdamState, scalars: torch.Tensor) -> None:
        """One step in place on ``params`` and the moments of ``state``, with
        ``lr`` and the bias corrections read from ``scalars`` (:meth:`scalars`
        of the step's count, a float32 tensor on the parameters' device), so
        that a CUDA graph can replay it with other values; ``state.count`` is
        the caller's to advance.  On each device the arithmetic is, bit for
        bit, that of the same update with the scalars as Python floats
        (``_foreach_div`` by a float, ``add(step, alpha=-lr)``), which the
        float32 card-vs-CPU checks were calibrated on: PyTorch's
        ``_foreach_div`` by a float divides on the CPU and multiplies by the
        float32 reciprocal on CUDA, and so does this form with the tensors;
        ``addcmul`` by the tensor ``-lr`` is the fused multiply-add (one
        rounding) of ``add(step, alpha=-lr)`` on both devices, where
        ``addcmul(step, lr, value=-1)`` would round the product first on
        CUDA.

        On DTensor parameters (``parallel/gspmd.py``) each gradient is first
        redistributed to its parameter's placements (a partial sum on the
        data axis is all-reduced there), and ``scalars`` stays a plain
        device tensor, taken as replicated where its 0-dim rows meet the
        lists."""
        params = list(params)
        grads = [_placed_like(g, p).float() for g, p in zip(grads, params)]
        lr, bc1, bc2, inv1, inv2 = scalars.unbind()
        cuda = params[0].is_cuda
        # the scalars are plain 0-dim device tensors; on DTensor parameters
        # they are taken as replicated where they meet the lists
        scalars_in = implicit_replication if isinstance(params[0], DTensor) \
            else contextlib.nullcontext
        b1, b2 = self.b1, self.b2
        narrow = self.moment_dtype != torch.float32
        mu = [m.float() for m in state.mu] if narrow else state.mu
        nu = [v.float() for v in state.nu] if narrow else state.nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        with scalars_in():
            denom = torch._foreach_mul(nu, inv2) if cuda else torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        with scalars_in():
            step = torch._foreach_mul(mu, inv1) if cuda else torch._foreach_div(mu, bc1)
        torch._foreach_div_(step, denom)
        neg_lr = torch.neg(lr)
        with scalars_in():
            torch._foreach_addcmul_(params, step, [neg_lr] * len(params))
        if narrow:  # rounded to nearest even for storage, as JAX's astype
            torch._foreach_copy_(state.mu, mu)
            torch._foreach_copy_(state.nu, nu)


def _placed_like(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """``grad`` with ``param``'s placements when ``param`` is a DTensor
    (``parallel/gspmd.py``): a gradient that is a partial sum on the data
    axis is all-reduced here, once, before it meets the moments."""
    if isinstance(param, DTensor):
        return grad.redistribute(param.device_mesh, param.placements)
    return grad


def _bias_correction(decay: float, count: int) -> float:
    """``1 − decay^count`` rounded in float32 as optax computes it (for
    β₂ = 0.999 the cancellation makes float32's value differ from the exact
    one by ~1e-5 relative)."""
    one, d = np.float32(1.0), np.float32(decay)
    return float(one - np.power(d, np.float32(count), dtype=np.float32))


@dataclasses.dataclass
class TrainState:
    gan: nn.Module
    groups: Dict[str, Dict[ParamKey, nn.Parameter]]
    opt_states: Dict[str, AdamState]
    step: int = 0

    def group_params(self, name: str) -> List[nn.Parameter]:
        return list(self.groups[name].values())


def split_by_prefix(gan: nn.Module,
                    predicates: Dict[str, Callable[[str], bool]]
                    ) -> Dict[str, Dict[ParamKey, nn.Parameter]]:
    """The model's parameters by group, each layer to the first predicate
    that takes its scope (JAX ``split_by_prefix``); keys sorted."""
    out: Dict[str, Dict[ParamKey, nn.Parameter]] = {g: {} for g in predicates}
    for scope, m in sorted(scoped_modules(gan).items()):
        params = list(m.named_parameters(recurse=False))
        if not params:
            continue
        group = next((g for g, pred in predicates.items() if pred(scope)), None)
        if group is None:
            raise ValueError(f"layer {scope!r} matched no param group")
        for var, p in sorted(params):
            out[group][(scope, var)] = p
    return out


def init_train_state(gan: nn.Module, predicates: Dict[str, Callable[[str], bool]],
                     optimizers: Dict[str, ScalelessAdam]) -> TrainState:
    groups = split_by_prefix(gan, predicates)
    opt_states = {g: optimizers[g].init(list(ps.values()))
                  for g, ps in groups.items() if g in optimizers and ps}
    return TrainState(gan=gan, groups=groups, opt_states=opt_states, step=0)


@contextlib.contextmanager
def trainable(ts: TrainState, names: Sequence[str]) -> Iterator[None]:
    """Only the groups in ``names`` require grad inside the block.  A frozen
    group records no graph, so a step takes no gradient it does not update
    (D's weight grads in the G step, G's whole backward in a D step), as
    XLA drops them as dead code in JAX's cycle."""
    try:
        for g, ps in ts.groups.items():
            for p in ps.values():
                p.requires_grad_(g in names)
        yield
    finally:
        for ps in ts.groups.values():
            for p in ps.values():
                p.requires_grad_(True)


def grads_of(cost: torch.Tensor, params) -> List[torch.Tensor]:
    """d cost / d params, zeros for a parameter the cost does not reach (as
    JAX's grad gives)."""
    grads = torch.autograd.grad(cost, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def state_buffers(module: nn.Module) -> List[torch.Tensor]:
    """The live buffers of the non-trainable state under ``module`` (SN
    ``u``, BN moving statistics: JAX's state tree), in scope order, so that
    every rank lists them alike."""
    return [b for _, m in sorted(scoped_modules(module).items())
            for _, b in sorted(m.named_buffers(recurse=False))]


def train_state_tensors(ts: TrainState) -> List[torch.Tensor]:
    """Every tensor of ``ts`` that a step reads or writes: the groups'
    parameters, the Adam moments and the state buffers."""
    return ([p for ps in ts.groups.values() for p in ps.values()]
            + [t for st in ts.opt_states.values() for t in st.mu + st.nu]
            + state_buffers(ts.gan))


def train_state_key(ts: Optional[TrainState], *more: Iterable[torch.Tensor]) -> Tuple:
    """The key of a graph over ``ts`` and the tensors of ``more``
    (``train/graphs.py``): ``id(ts)`` and the addresses of every tensor of
    :func:`train_state_tensors` and of ``more``; the addresses alone without
    ``ts``.  A state placed on a mesh (``parallel/gspmd.py::
    apply_shardings``, every tensor a DTensor) gives its local tensors'.  A
    graph replays only while each still lies there."""
    tensors = [] if ts is None else train_state_tensors(ts)
    if tensors and isinstance(tensors[0], DTensor):
        with torch.no_grad():
            tensors = [t.to_local() for t in tensors]
    addresses = state_key(tensors + [t for ms in more for t in ms])
    return addresses if ts is None else (id(ts), addresses)


@contextlib.contextmanager
def state_in_place(module: nn.Module) -> Iterator[None]:
    """Inside the block the layers under ``module`` rebind their state
    buffers (SN ``u``, BN moving statistics) to new tensors, as eager
    autograd needs (a saved tensor is never written); at the block's end each
    newest value is copied into the buffer that was there when the block
    began, and that buffer is bound again.  So the state keeps its
    addresses across steps, where a CUDA graph reads and writes it, and a
    step's values chain as before."""
    held = [(m, name, b) for m in scoped_modules(module).values()
            for name, b in m.named_buffers(recurse=False)]
    try:
        yield
    except BaseException:  # the old buffers back, unwritten: a failed capture ran nothing
        for m, name, b in held:
            setattr(m, name, b)
        raise
    with torch.no_grad():
        for m, name, b in held:
            new = getattr(m, name)
            if new is not b:
                b.copy_(new)
                setattr(m, name, b)


def mean_over_ranks(group, grads: Sequence[torch.Tensor], ts: TrainState) -> None:
    """A step's gradients, then the state, meaned in place over the ranks of
    ``group`` (a ``parallel.DataGroup``) by one ``all_reduce``, as JAX's
    ``pavg`` of both; nothing without a group."""
    if group is not None:
        group.mean_(list(grads) + state_buffers(ts.gan))


def constraints_of(module: nn.Module) -> Dict[str, Dict[str, Tuple[float, float]]]:
    """``{scope: {var: (lo, hi)}}``: the clip constraints the layers under
    ``module`` register (JAX's ``ctx.constraints`` after init)."""
    return {scope: dict(m.constraints) for scope, m in scoped_modules(module).items()
            if getattr(m, "constraints", None)}


@torch.no_grad()
def apply_constraints(group: Dict[ParamKey, Any],
                      constraints: Dict[str, Dict[str, Tuple[float, float]]]) -> None:
    """Clip, in place, every parameter of ``group`` (``{(scope, var):
    tensor}``) that ``constraints`` names to its ``[lo, hi]`` (JAX
    ``apply_constraints``)."""
    for (scope, var), p in group.items():
        bounds = constraints.get(scope, {}).get(var)
        if bounds is not None:
            p.clamp_(*bounds)
