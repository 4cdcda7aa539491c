"""Spectral norm, one power-iteration step: CUDA kernel and plain version.

Replaces the Pallas TPU kernel ``_kernel`` of ``sn_fused``
(``rcgan_tpu/ops/pallas/sn_kernel.py``).  Same arithmetic, all float32:
``v = l2n(u0 Wᵀ)``, ``u' = l2n(v W)``, ``σ = (v W) u'ᵀ``, returning
``(W/σ, u', σ)`` with ``l2n(x) = x / (‖x‖ + 1e-12)``.

The kernel is ``rcgan_tpu_torch/csrc/sn.cu``: one launch serves a *group*
of weights (the 15 spectral-normed layers of a discriminator pass, or a
lone layer as a group of one), a thread-block cluster of eight blocks per
weight.  Each block holds its eighth of W's rows in shared memory, the
norms are folded across the cluster in rank order through distributed
shared memory, and W is read from device memory once and written once.
It is bound by the latency of that chain, not by FLOPs or bytes; the
source note says more.

The TPU kernel's whole-W VMEM budget (``fits_fused``, 4 MB) is a fact of the
TPU, not of the algorithm: on the card every ``num_iters == 1`` call goes
through the kernel, whatever its size.

Autograd: :class:`SpectralNormGroupFn` is the route on both devices.  Its
backward re-runs :func:`sn_plain` under ``torch.enable_grad()`` per weight
that needs a gradient and takes the VJP with respect to W, as the TPU
kernel's ``_bwd`` re-runs ``sn_math`` under ``jax.vjp``: gradients flow
*through* the power iteration (the reference differentiates its
``tf.while_loop``), not Miyato's stop-gradient.  ``u0`` is state and gets
no gradient.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from rcgan_tpu_torch.ops.kernels import runtime

_EPS = 1e-12
_INT32_MAX = 2**31 - 1

# The kernel's geometry (``csrc/sn.cu``).
CLUSTER = 8            # blocks per weight; block r owns rows [r m / 8, (r + 1) m / 8)
MAX_WEIGHTS = 64       # descriptors per launch; a longer group takes several
MAX_COUT = 16384       # t (and u0) live in shared memory
_V_CAP_MAX = 8192      # rows of v kept in shared memory; a longer range parks v in W/σ
_SMEM_FLOATS = 50 * 1024  # dynamic shared memory per block, 200 KB of the SM's 227


class _SnWeight(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p), ("u0", ctypes.c_void_p), ("wbar", ctypes.c_void_p),
                ("u_new", ctypes.c_void_p), ("sigma", ctypes.c_void_p),
                ("m", ctypes.c_int), ("cout", ctypes.c_int)]


class _SnGroup(ctypes.Structure):
    _fields_ = [("w", _SnWeight * MAX_WEIGHTS), ("t_cap", ctypes.c_int),
                ("v_cap", ctypes.c_int), ("tile_cap", ctypes.c_int)]


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


def cluster_rows(m: int) -> List[Tuple[int, int]]:
    """The row range ``[lo, hi)`` of each of the cluster's blocks; ranges of
    a weight with fewer than eight rows may be empty."""
    return [(r * m // CLUSTER, (r + 1) * m // CLUSTER) for r in range(CLUSTER)]


def group_smem(shapes: Sequence[Tuple[int, int]]) -> Tuple[int, int, int]:
    """``(t_cap, v_cap, tile_cap)`` in floats, each a multiple of 4, for one
    launch over weights of ``shapes``: room for the longest ``t``, for the
    longest row range's ``v`` (up to a limit) and for the largest block of
    rows that the rest of the shared memory holds."""
    def up4(n):
        return (n + 3) // 4 * 4

    t_cap = up4(max(cout for _, cout in shapes))
    rows = [max(hi - lo for lo, hi in cluster_rows(m)) for m, _ in shapes]
    v_cap = min(up4(max(rows)), _V_CAP_MAX)
    tile = up4(max(r * cout for r, (_, cout) in zip(rows, shapes)))
    return t_cap, v_cap, max(0, min(tile, _SMEM_FLOATS - t_cap - v_cap))


def _check(w_mat: torch.Tensor, u0: torch.Tensor) -> None:
    if w_mat.dim() != 2 or u0.shape != (1, w_mat.shape[1]):
        raise ValueError(f"spectral norm wants w [m, cout] and u [1, cout]; got "
                         f"{tuple(w_mat.shape)} and {tuple(u0.shape)}")
    if w_mat.dtype != torch.float32 or u0.dtype != torch.float32:
        raise TypeError(f"spectral norm takes float32 w and u; got {w_mat.dtype} and {u0.dtype}")
    if not (w_mat.is_contiguous() and u0.is_contiguous()):
        raise ValueError("spectral norm wants contiguous w and u")
    if w_mat.numel() == 0 or w_mat.numel() > _INT32_MAX or w_mat.shape[1] > MAX_COUT:
        raise ValueError(f"spectral norm: w {tuple(w_mat.shape)} is out of range "
                         f"(0 < m * cout < 2^31, cout <= {MAX_COUT})")


def _launch_group(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
    """One launch per ``MAX_WEIGHTS`` weights of ``pairs``; returns the flat
    list ``[W/σ, u', σ, ...]``.  The outputs of a call are views of two
    buffers: one for every ``W/σ``, one for every ``u'`` and ``σ``."""
    for w, u in pairs:
        _check(w, u)
    dev, n = pairs[0][0].device, len(pairs)
    w_sizes = [w.numel() for w, _ in pairs]
    u_sizes = [w.shape[1] for w, _ in pairs]
    big = torch.empty((sum(w_sizes),), dtype=torch.float32, device=dev)
    small = torch.empty((sum(u_sizes) + n,), dtype=torch.float32, device=dev)
    wbars = [t.view(w.shape) for t, (w, _) in zip(big.split(w_sizes), pairs)]
    *us, sigmas = small.split(u_sizes + [n])
    us = [t.view(1, -1) for t in us]
    sigmas = sigmas.unbind()

    lib = runtime.cuda_library("sn")
    fn = lib.sn_group_f32
    if fn.argtypes is None:  # first use of this entry point
        if lib.sn_group_bytes() != ctypes.sizeof(_SnGroup) or lib.sn_max_weights() != MAX_WEIGHTS:
            raise RuntimeError("sn: the library's group descriptor differs from the wrapper's")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for start in range(0, n, MAX_WEIGHTS):
        chunk = range(start, min(start + MAX_WEIGHTS, n))
        group = _SnGroup()
        group.t_cap, group.v_cap, group.tile_cap = group_smem(
            [tuple(pairs[i][0].shape) for i in chunk])
        for k, i in enumerate(chunk):
            (w, u), d = pairs[i], group.w[k]
            d.w, d.u0, d.wbar = w.data_ptr(), u.data_ptr(), wbars[i].data_ptr()
            d.u_new, d.sigma = us[i].data_ptr(), sigmas[i].data_ptr()
            d.m, d.cout = w.shape
        code = runtime.on_device(big, fn, ctypes.addressof(group), len(chunk),
                                 4 * (group.t_cap + group.v_cap + group.tile_cap))
        runtime.check_cuda_status(lib, "sn_error_string", code, "sn launch")
        runtime.count_launch("sn")
    return [t for triple in zip(wbars, us, sigmas) for t in triple]


class SpectralNormGroupFn(torch.autograd.Function):
    """``(w_0, u_0, w_1, u_1, ...) → (W_0/σ_0, u'_0, σ_0, W_1/σ_1, ...)``: one
    kernel launch for the group on CUDA, :func:`sn_plain` per weight on the
    CPU; backward through the power iteration on both, per weight that
    needs it."""

    @staticmethod
    def forward(ctx, *flat):
        pairs = list(zip(flat[0::2], flat[1::2]))
        if runtime.on_cuda(*flat):
            out = _launch_group(pairs)
        else:
            out = [t for w, u in pairs for t in sn_plain(w, u)]
        ctx.save_for_backward(*flat)
        ctx.set_materialize_grads(False)
        return tuple(out)

    @staticmethod
    def backward(ctx, *cts):
        flat = ctx.saved_tensors
        grads = [None] * len(flat)
        for i in range(len(flat) // 2):
            cot = cts[3 * i:3 * i + 3]
            if not ctx.needs_input_grad[2 * i] or all(c is None for c in cot):
                continue
            w_mat, u0 = flat[2 * i], flat[2 * i + 1]
            with torch.enable_grad():
                w = w_mat.detach().requires_grad_(True)
                outs = sn_plain(w, u0.detach())
                keep = [(o, c) for o, c in zip(outs, cot) if c is not None]
                (dw,) = torch.autograd.grad([o for o, _ in keep], (w,), [c for _, c in keep])
            grads[2 * i] = dw.to(w_mat.dtype)
        return tuple(grads)


def spectral_norm_group(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
    """``[(w_mat [m, cout], u0 [1, cout]), ...]`` float32 →
    ``[(W/σ, u', σ), ...]``.  CPU tensors take :func:`sn_plain` per weight;
    CUDA tensors launch the kernel once for the whole group on the current
    stream (or raise)."""
    if not pairs:
        return []
    out = SpectralNormGroupFn.apply(*[t for pair in pairs for t in pair])
    return [tuple(out[i:i + 3]) for i in range(0, len(out), 3)]


def spectral_norm(w_mat: torch.Tensor, u0: torch.Tensor):
    """``w_mat [m, cout]``, ``u0 [1, cout]`` float32 → ``(W/σ, u', σ)``: a
    group of one."""
    return spectral_norm_group([(w_mat, u0)])[0]
