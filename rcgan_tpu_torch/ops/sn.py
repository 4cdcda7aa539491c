"""Spectral normalization with an explicit ``u`` buffer, ported from
``rcgan_tpu/ops/sn.py::spectral_normed_weight``.

The weight is flattened to ``[-1, cout]`` in float32; the layer's ``u``
buffer (``[1, cout]``, :meth:`Scoped.add_stat`) does one power-iteration
step per call, and the layer uses ``W / σ``.  When the layer's
``update_sn`` is off the step still runs (σ uses the refreshed u) but the
stored u is not advanced, as the reference's ``NO_OPS`` skips only the
assign.  A second call in the same forward reads the u that the first
wrote, as JAX's ``Ctx.stat`` chains reads through ``new_state``.

Every ``num_iters == 1`` call goes to the spectral-norm kernel on the card
(:mod:`rcgan_tpu_torch.ops.kernels.sn_kernel`), whatever the weight's size:
the JAX package's 4 MB ``fits_fused`` limit is the TPU's VMEM budget, not a
property of the algorithm.  The kernel takes a group of weights in one
launch: a module that runs many spectral-normed layers in one forward (the
discriminator) calls :func:`prepare_spectral_norms` on them at its start,
which does every layer's step at once and leaves each layer its ``W / σ``
in a slot that the layer's own :func:`spectral_normed_weight` call then
takes; a layer called without a prepared slot does its own group of one.
"""

from __future__ import annotations

from typing import Iterable, List

import torch

from rcgan_tpu_torch.core import initializers as inits
from rcgan_tpu_torch.core.module import Scoped
from rcgan_tpu_torch.ops.kernels.sn_kernel import spectral_norm_group

_SLOT = "_sn_prepared"


def add_sn_state(layer: Scoped, cout: int, weight: str) -> None:
    """The layer's persistent ``u [1, cout]``, truncated-normal(1.0) as in
    JAX; ``weight`` names the parameter that is normalized."""
    layer.add_stat("u", (1, cout), inits.truncated_normal(1.0))
    layer.sn_weight = weight


def sn_layers(module: torch.nn.Module) -> List[Scoped]:
    """The spectral-normed layers under ``module``."""
    return [m for m in module.modules() if getattr(m, "spectral_normed", False)]


def _steps(layers: List[Scoped], weights: List[torch.Tensor]):
    """One power-iteration step per layer, all in one group; advances each
    layer's ``u`` when its ``update_sn`` is on; returns ``[(W/σ, σ), ...]``
    with ``W/σ`` in the weight's shape and dtype."""
    if torch.is_inference_mode_enabled():
        for layer in layers:
            if layer.update_sn:
                raise RuntimeError(
                    f"{layer.scope}: spectral-norm u update under torch.inference_mode would "
                    "keep an inference tensor as state; use torch.no_grad(), or "
                    "sn_updates(module, False)")
    pairs = [(w.float().reshape(-1, w.shape[-1]), layer.u) for layer, w in zip(layers, weights)]
    out = []
    for layer, w, (w_bar, u_new, sigma) in zip(layers, weights, spectral_norm_group(pairs)):
        if layer.update_sn:
            # rebind, never copy_: autograd saved the old u for the backward;
            # a trainer's step copies the last u back into the buffer it
            # started from (train/state.py::state_in_place)
            layer.u = u_new.detach()
        out.append((w_bar.reshape(w.shape).to(w.dtype), sigma))
    return out


def prepare_spectral_norms(layers: Iterable[Scoped]) -> None:
    """Do the step of every layer of ``layers`` in one group (one kernel
    launch on the card) and leave each its result, for its next
    :func:`spectral_normed_weight` call to take."""
    layers = list(layers)
    for layer, result in zip(layers, _steps(layers, [getattr(m, m.sn_weight) for m in layers])):
        layer.__dict__[_SLOT] = result


def clear_prepared(layers: Iterable[Scoped]) -> None:
    """Empty the slots that :func:`prepare_spectral_norms` filled and no
    layer took (a forward that raised midway)."""
    for layer in layers:
        layer.__dict__.pop(_SLOT, None)


def spectral_normed_weight(layer: Scoped, w: torch.Tensor, num_iters: int = 1,
                           with_sigma: bool = False):
    """``w / σ_max(w)`` estimated by one power-iteration step from
    ``layer.u``; writes the new u to ``layer.u`` when ``layer.update_sn``.
    Takes the layer's prepared result when there is one."""
    if num_iters != 1:
        raise NotImplementedError("spectral norm with num_iters > 1 has no caller on the "
                                  "ported paths: see ROADMAP.md, Queue 1")
    prepared = layer.__dict__.pop(_SLOT, None)
    w_bar, sigma = prepared if prepared is not None else _steps([layer], [w])[0]
    return (w_bar, sigma) if with_sigma else w_bar
