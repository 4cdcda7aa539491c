"""Spectral norm, one power-iteration step: CUDA kernel and plain version.

Replaces the Pallas TPU kernel ``_kernel`` of ``sn_fused``
(``rcgan_tpu/ops/pallas/sn_kernel.py``).  Same arithmetic, all float32:
``v = l2n(u0 Wᵀ)``, ``u' = l2n(v W)``, ``σ = (v W) u'ᵀ``, returning
``(W/σ, u', σ)`` with ``l2n(x) = x / (‖x‖ + 1e-12)``.

The kernel is ``rcgan_tpu_torch/csrc/sn.cu``: one block per weight runs the
two GEMVs and the norms in a fixed order (the chain needs an order across
all of W, and W ≤ 1.2 MB on the CIFAR path sits in L2 after the first
read), then a grid-wide pass writes ``W/σ``.  It is bound by latency on
the one SM that runs that block, not by FLOPs or bytes; the source note
says more.

The TPU kernel's whole-W VMEM budget (``fits_fused``, 4 MB) is a fact of the
TPU, not of the algorithm: on the card every ``num_iters == 1`` call goes
through the kernel, whatever its size.

Autograd: :class:`SpectralNormFn` is the route on both devices.  Its
backward re-runs :func:`sn_plain` under ``torch.enable_grad()`` and takes
the VJP with respect to W, as the TPU kernel's ``_bwd`` re-runs ``sn_math``
under ``jax.vjp``: gradients flow *through* the power iteration (the
reference differentiates its ``tf.while_loop``), not Miyato's
stop-gradient.  ``u0`` is state and gets no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from rcgan_tpu_torch.ops.kernels import runtime

_EPS = 1e-12
_INT32_MAX = 2**31 - 1


def sn_plain(w_mat: torch.Tensor, u0: torch.Tensor):
    """Plain version (JAX ``sn_math``): ``w_mat [m, cout]``, ``u0 [1, cout]``
    → ``(W/σ [m, cout], u' [1, cout], σ [])``, float32."""
    w = w_mat.float()
    v = u0.float() @ w.T
    v = v / (torch.sqrt(torch.sum(v * v)) + _EPS)
    u = v @ w
    u = u / (torch.sqrt(torch.sum(u * u)) + _EPS)
    sigma = (v @ w @ u.T)[0, 0]
    return w / sigma, u, sigma


def _check(w_mat: torch.Tensor, u0: torch.Tensor) -> None:
    if w_mat.dim() != 2 or u0.shape != (1, w_mat.shape[1]):
        raise ValueError(f"spectral norm wants w [m, cout] and u [1, cout]; got "
                         f"{tuple(w_mat.shape)} and {tuple(u0.shape)}")
    if w_mat.dtype != torch.float32 or u0.dtype != torch.float32:
        raise TypeError(f"spectral norm takes float32 w and u; got {w_mat.dtype} and {u0.dtype}")
    if not (w_mat.is_contiguous() and u0.is_contiguous()):
        raise ValueError("spectral norm wants contiguous w and u")
    if w_mat.numel() == 0 or w_mat.numel() > _INT32_MAX:
        raise ValueError(f"spectral norm: w of {w_mat.numel()} elements is out of range")


def _launch(w_mat: torch.Tensor, u0: torch.Tensor):
    _check(w_mat, u0)
    m, cout = w_mat.shape
    dev = w_mat.device
    wbar = torch.empty_like(w_mat)
    u_new = torch.empty((1, cout), dtype=torch.float32, device=dev)
    sigma = torch.empty((), dtype=torch.float32, device=dev)
    v_scratch = torch.empty((m,), dtype=torch.float32, device=dev)
    lib = runtime.cuda_library("sn")
    fn = lib.sn_f32
    if fn.argtypes is None:  # first use of this entry point
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    code = runtime.on_device(w_mat, fn, w_mat.data_ptr(), u0.data_ptr(), wbar.data_ptr(),
                             u_new.data_ptr(), sigma.data_ptr(), v_scratch.data_ptr(), m, cout)
    runtime.check_cuda_status(lib, "sn_error_string", code, "sn launch")
    runtime.count_launch("sn")
    return wbar, u_new, sigma


class SpectralNormFn(torch.autograd.Function):
    """``(w_mat, u0) → (W/σ, u', σ)``: the kernel on CUDA, :func:`sn_plain`
    on the CPU; backward through the power iteration on both."""

    @staticmethod
    def forward(ctx, w_mat, u0):
        out = _launch(w_mat, u0) if runtime.on_cuda(w_mat, u0) else sn_plain(w_mat, u0)
        ctx.save_for_backward(w_mat, u0)
        return out

    @staticmethod
    def backward(ctx, d_wbar, d_u, d_sigma):
        w_mat, u0 = ctx.saved_tensors
        with torch.enable_grad():
            w = w_mat.detach().requires_grad_(True)
            outs = sn_plain(w, u0.detach())
            (dw,) = torch.autograd.grad(outs, (w,), (d_wbar, d_u, d_sigma))
        return dw.to(w_mat.dtype), None


def spectral_norm(w_mat: torch.Tensor, u0: torch.Tensor):
    """``w_mat [m, cout]``, ``u0 [1, cout]`` float32 → ``(W/σ, u', σ)``.
    CPU tensors take :func:`sn_plain`; CUDA tensors launch the kernel on the
    current stream (or raise)."""
    return SpectralNormFn.apply(w_mat, u0)
