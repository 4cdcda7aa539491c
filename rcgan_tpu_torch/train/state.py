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
``apply_updates_with_lr``): float32 moments, bias-corrected, eps outside
the square root, written with ``torch._foreach`` ops in optax's order.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from rcgan_tpu_torch.core.module import scoped_modules

ParamKey = Tuple[str, str]  # (scope, var)


@dataclasses.dataclass
class AdamState:
    count: int                 # host int, optax's ``count``
    mu: List[torch.Tensor]     # float32, in the order of the group's params
    nu: List[torch.Tensor]


class ScalelessAdam:
    """``p ← p − lr · m̂ / (√v̂ + eps)`` with ``m̂, v̂`` optax's bias-corrected
    moments.  ``moment_dtype="bfloat16"`` (the JAX package's low-precision
    moments) is off the reference path and not ported."""

    def __init__(self, b1: float, b2: float, eps: float = 1e-8,
                 moment_dtype: Optional[str] = None):
        if moment_dtype is not None:
            raise NotImplementedError("low-precision Adam moments are not ported: see "
                                      "ROADMAP.md, Queue 1")
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return AdamState(0, zeros, [torch.zeros_like(z) for z in zeros])

    @torch.no_grad()
    def update_(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                state: AdamState, lr: float) -> None:
        """One step in place on ``params`` and ``state``."""
        params, grads = list(params), [g.float() for g in grads]
        state.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(state.nu, _bias_correction(b2, state.count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(state.mu, _bias_correction(b1, state.count))
        torch._foreach_div_(step, denom)
        torch._foreach_add_(params, step, alpha=-lr)


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
