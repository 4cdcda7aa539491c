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
property of the algorithm.
"""

from __future__ import annotations

import torch

from rcgan_tpu_torch.core import initializers as inits
from rcgan_tpu_torch.core.module import Scoped
from rcgan_tpu_torch.ops.kernels.sn_kernel import spectral_norm


def add_sn_state(layer: Scoped, cout: int) -> None:
    """The layer's persistent ``u [1, cout]``, truncated-normal(1.0) as in JAX."""
    layer.add_stat("u", (1, cout), inits.truncated_normal(1.0))


def spectral_normed_weight(layer: Scoped, w: torch.Tensor, num_iters: int = 1,
                           with_sigma: bool = False):
    """``w / σ_max(w)`` estimated by one power-iteration step from
    ``layer.u``; writes the new u to ``layer.u`` when ``layer.update_sn``."""
    if num_iters != 1:
        raise NotImplementedError("spectral norm with num_iters > 1 has no caller on the "
                                  "ported paths: see ROADMAP.md, Queue 1")
    w_mat = w.float().reshape(-1, w.shape[-1])
    w_bar, u_new, sigma = spectral_norm(w_mat, layer.u)
    if layer.update_sn:
        if torch.is_inference_mode_enabled():
            raise RuntimeError(
                f"{layer.scope}: spectral-norm u update under torch.inference_mode would keep "
                "an inference tensor as state; use torch.no_grad(), or sn_updates(module, False)")
        # rebind, never copy_: autograd saved the old u for the backward
        layer.u = u_new.detach()
    w_bar = w_bar.reshape(w.shape).to(w.dtype)
    return (w_bar, sigma) if with_sigma else w_bar
