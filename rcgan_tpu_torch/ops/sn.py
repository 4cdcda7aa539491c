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

``num_iters > 1`` runs the power iteration in plain PyTorch on both
devices, as JAX runs its ``fori_loop`` outside the Pallas kernel (taken
only at ``num_iters == 1``); the gradient flows through the iterations, as
JAX differentiates its loop.  :func:`exact_sigma` is the SVD's largest
singular value, the test oracle.
"""

from __future__ import annotations

from typing import Iterable, List

import torch

from rcgan_tpu_torch.core import initializers as inits
from rcgan_tpu_torch.core.module import Scoped
from rcgan_tpu_torch.ops.kernels.sn_kernel import spectral_norm_group

_SLOT = "_sn_prepared"


def add_sn_state(layer: Scoped, cout: int, weight: str, transposed: bool = False) -> None:
    """The layer's persistent ``u [1, cout]``, truncated-normal(1.0) as in
    JAX; ``weight`` names the parameter that is normalized.  ``transposed``:
    the 2-D weight ``[m, n]`` is normalized as its transpose ``[n, m]``
    (the same σ), so that ``u`` lies on its input side and ``cout`` is
    ``m``: for a layer whose output is wider than the kernel's ``u`` holds
    (``sn_kernel.MAX_COUT``)."""
    layer.add_stat("u", (1, cout), inits.truncated_normal(1.0))
    layer.sn_weight = weight
    layer.sn_transposed = transposed


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
    flip = [getattr(layer, "sn_transposed", False) for layer in layers]
    pairs = [(w.float().T.contiguous() if t else w.float().reshape(-1, w.shape[-1]), layer.u)
             for layer, w, t in zip(layers, weights, flip)]
    out = []
    for layer, w, t, (w_bar, u_new, sigma) in zip(layers, weights, flip,
                                                   spectral_norm_group(pairs)):
        if layer.update_sn:
            # rebind, never copy_: autograd saved the old u for the backward;
            # a trainer's step copies the last u back into the buffer it
            # started from (train/state.py::state_in_place)
            layer.u = u_new.detach()
        out.append(((w_bar.T if t else w_bar.reshape(w.shape)).to(w.dtype), sigma))
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


def _l2normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.sum(v**2) ** 0.5 + eps)


def _power_iterations(layer: Scoped, w: torch.Tensor, num_iters: int):
    """JAX's loop branch: ``num_iters`` steps from ``layer.u`` in float32,
    ``σ = v W uᵀ``; advances ``layer.u`` when its ``update_sn`` is on;
    returns ``(W/σ, σ)`` with ``W/σ`` in ``w``'s shape and dtype."""
    if torch.is_inference_mode_enabled() and layer.update_sn:
        raise RuntimeError(f"{layer.scope}: spectral-norm u update under torch.inference_mode; "
                           "use torch.no_grad(), or sn_updates(module, False)")
    w_mat = w.float().reshape(-1, w.shape[-1])
    u, v = layer.u.float(), torch.zeros((1, w_mat.shape[0]), device=w.device)
    for _ in range(num_iters):
        v = _l2normalize(u @ w_mat.T)
        u = _l2normalize(v @ w_mat)
    sigma = (v @ w_mat @ u.T)[0, 0]
    if layer.update_sn:
        layer.u = u.detach()
    return (w_mat / sigma).reshape(w.shape).to(w.dtype), sigma


def spectral_normed_weight(layer: Scoped, w: torch.Tensor, num_iters: int = 1,
                           with_sigma: bool = False):
    """``w / σ_max(w)`` estimated by ``num_iters`` power-iteration steps
    from ``layer.u``; writes the new u to ``layer.u`` when
    ``layer.update_sn``.  One step takes the layer's prepared result when
    there is one, else a group of one (the kernel on the card); more steps
    run the plain loop."""
    prepared = layer.__dict__.pop(_SLOT, None)
    if num_iters != 1:
        if prepared is not None:
            raise ValueError(f"{layer.scope}: a prepared one-step result cannot serve "
                             f"num_iters={num_iters}")
        w_bar, sigma = _power_iterations(layer, w, num_iters)
    else:
        w_bar, sigma = prepared if prepared is not None else _steps([layer], [w])[0]
    return (w_bar, sigma) if with_sigma else w_bar


def exact_sigma(w: torch.Tensor) -> torch.Tensor:
    """The largest singular value of the weight flattened to ``[-1, cout]``,
    float32, by SVD (JAX's test oracle)."""
    return torch.linalg.svdvals(w.float().reshape(-1, w.shape[-1]))[0]
