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

The group is the ``torch.library`` op ``rcgan::sn_group(ws, us) -> (W/σ
buffer, u' and σ buffer)``: a CPU implementation (:func:`sn_plain` per
weight), a CUDA one (the launches, counted there: :func:`sn_group_cuda`)
and a fake one.  It returns the two flat buffers the kernel writes, so that
its outputs are a fixed pair whatever the group's length, and its DTensor
sharding rule (``register_sharding``) replicates every input and output: a
weight sharded on a mesh dimension is gathered before the launch.

Autograd: :class:`SpectralNormGroupFn` calls the op on both devices.  Its
backward is the VJP with respect to W of every weight that needs one, from
the saved ``(W, u0)``, as the TPU kernel's ``_bwd`` re-runs ``sn_math``
under ``jax.vjp``: gradients flow *through* the power iteration (the
reference differentiates its ``tf.while_loop``), not Miyato's
stop-gradient.  ``u0`` is state and gets no gradient.  On the card the
group's VJPs are one launch of ``csrc/sn.cu``'s ``sn_group_kernel_vjp``
(counted as ``sn_bwd``); on the CPU :func:`sn_vjp_plain` per weight, its
closed form in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch
from torch.distributed.tensor import Replicate
from torch.distributed.tensor.experimental import register_sharding

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


class _SnVjpWeight(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p), ("u0", ctypes.c_void_p), ("gbar", ctypes.c_void_p),
                ("gu", ctypes.c_void_p), ("gsigma", ctypes.c_void_p), ("dw", ctypes.c_void_p),
                ("m", ctypes.c_int), ("cout", ctypes.c_int)]


class _SnVjpGroup(ctypes.Structure):
    _fields_ = [("w", _SnVjpWeight * MAX_WEIGHTS), ("scratch", ctypes.c_void_p),
                ("col_cap", ctypes.c_int), ("row_cap", ctypes.c_int), ("tile_cap", ctypes.c_int)]


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


def sn_vjp_plain(w_mat: torch.Tensor, u0: torch.Tensor, g_wbar=None, g_u=None, g_sigma=None):
    """The VJP of :func:`sn_plain` with respect to ``w_mat``, in closed form
    (``csrc/sn.cu``'s ``sn_group_kernel_vjp`` computes the same): the
    cotangents ``g_wbar [m, cout]``, ``g_u [1, cout]`` and ``g_sigma []`` of
    its three outputs, each None for zero → ``dW [m, cout]``, float32.  The
    forward is taken again from ``(w_mat, u0)``; σ and u' are
    :func:`sn_plain`'s own::

        σ̄ = gσ − Σ(Ḡ ⊙ W) / σ²,  ū = gu + σ̄ t
        t̄ = σ̄ u' + ū / (‖t‖ + ε) − t (t · ū) / ((‖t‖ + ε)² ‖t‖)
        ā = t̄ Wᵀ / (‖a‖ + ε) − a (a · t̄ Wᵀ) / ((‖a‖ + ε)² ‖a‖)
        dW = Ḡ / σ + vᵀ t̄ + āᵀ u0

    with ``a = u0 Wᵀ``, ``v = a / (‖a‖ + ε)``, ``t = v W``."""
    w, u0 = w_mat.float(), u0.float()
    _, u, sigma = sn_plain(w, u0)
    a = u0 @ w.T
    a_norm = torch.sqrt(torch.sum(a * a))
    v = a / (a_norm + _EPS)
    t = v @ w
    t_norm = torch.sqrt(torch.sum(t * t))
    tn, an = t_norm + _EPS, a_norm + _EPS
    sigma_bar = -torch.sum(g_wbar * w) / (sigma * sigma) if g_wbar is not None \
        else torch.zeros((), dtype=w.dtype, device=w.device)
    if g_sigma is not None:
        sigma_bar = g_sigma + sigma_bar
    u_bar = sigma_bar * t if g_u is None else g_u + sigma_bar * t
    t_bar = sigma_bar * u + u_bar / tn - t * (torch.sum(t * u_bar) / (tn * tn * t_norm))
    v_bar = t_bar @ w.T
    a_bar = v_bar / an - a * (torch.sum(a * v_bar) / (an * an * a_norm))
    dw = v.T @ t_bar + a_bar.T @ u0
    return dw if g_wbar is None else g_wbar / sigma + dw


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


def vjp_smem(shapes: Sequence[Tuple[int, int]]) -> Tuple[int, int, int]:
    """``(col_cap, row_cap, tile_cap)`` in floats, each a multiple of 4, for
    one VJP launch over weights of ``shapes``: three column vectors (u0, t,
    t̄) of the longest ``cout``, two row vectors (a, ā) of the longest row
    range (up to a limit; a longer range takes scratch, :func:`vjp_scratch`)
    and two tiles (W's and Ḡ's rows) as large as the rest allows."""
    def up4(n):
        return (n + 3) // 4 * 4

    col_cap = up4(max(cout for _, cout in shapes))
    rows = [max(hi - lo for lo, hi in cluster_rows(m)) for m, _ in shapes]
    row_cap = min(up4(max(rows)), _V_CAP_MAX, (_SMEM_FLOATS - 3 * col_cap) // 8 * 4)
    tile = up4(max(r * cout for r, (_, cout) in zip(rows, shapes)))
    rest = _SMEM_FLOATS - 3 * col_cap - 2 * row_cap
    return col_cap, row_cap, max(0, min(tile, rest // 8 * 4))


def vjp_scratch(shapes: Sequence[Tuple[int, int]], row_cap: int) -> int:
    """Floats of the scratch one VJP launch needs: 2 m a weight (a and ā in
    device memory) when a row range of any weight exceeds ``row_cap``, else
    none."""
    if all(max(hi - lo for lo, hi in cluster_rows(m)) <= row_cap for m, _ in shapes):
        return 0
    return 2 * sum(m for m, _ in shapes)


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


def _group_buffers(ws: Sequence[torch.Tensor]):
    """The two buffers of a group's outputs, as the kernel writes them: one
    for every ``W/σ`` (flat, in order), one for every ``u'`` then every
    ``σ``."""
    n, dev = len(ws), ws[0].device
    big = torch.empty((sum(w.numel() for w in ws),), dtype=torch.float32, device=dev)
    small = torch.empty((sum(w.shape[1] for w in ws) + n,), dtype=torch.float32, device=dev)
    return big, small


def _group_views(ws: Sequence[torch.Tensor], big: torch.Tensor, small: torch.Tensor):
    """The flat list ``[W/σ, u', σ, ...]`` as views of the two buffers."""
    wbars = [t.view(w.shape) for t, w in zip(big.split([w.numel() for w in ws]), ws)]
    *us, sigmas = small.split([w.shape[1] for w in ws] + [len(ws)])
    return [t for triple in zip(wbars, [u.view(1, -1) for u in us], sigmas.unbind())
            for t in triple]


def _launch_group(ws: Sequence[torch.Tensor], us: Sequence[torch.Tensor]):
    """One launch per ``MAX_WEIGHTS`` weights; returns the two output
    buffers (:func:`_group_buffers`)."""
    for w, u in zip(ws, us):
        _check(w, u)
    n = len(ws)
    big, small = _group_buffers(ws)
    out = _group_views(ws, big, small)
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
        group.t_cap, group.v_cap, group.tile_cap = group_smem([tuple(ws[i].shape) for i in chunk])
        for k, i in enumerate(chunk):
            d, (wbar, u_new, sigma) = group.w[k], out[3 * i:3 * i + 3]
            d.w, d.u0, d.wbar = ws[i].data_ptr(), us[i].data_ptr(), wbar.data_ptr()
            d.u_new, d.sigma = u_new.data_ptr(), sigma.data_ptr()
            d.m, d.cout = ws[i].shape
        code = runtime.on_device(big, fn, ctypes.addressof(group), len(chunk),
                                 4 * (group.t_cap + group.v_cap + group.tile_cap))
        runtime.check_cuda_status(lib, "sn_error_string", code, "sn launch")
        runtime.count_launch("sn")
    return big, small


def _sn_group_cpu(ws, us):
    """The op's CPU implementation: :func:`sn_plain` per weight, written
    into the two buffers as the kernel writes them."""
    big, small = _group_buffers(ws)
    for dst, t in zip(_group_views(ws, big, small), [t for w, u in zip(ws, us)
                                                      for t in sn_plain(w, u)]):
        dst.copy_(t)
    return big, small


def sn_group_cuda(ws, us):
    """The op's CUDA implementation: the group's launches on the current
    stream, or an error; tensors that are not all on one CUDA device raise
    (``runtime.on_cuda``)."""
    if not runtime.on_cuda(*ws, *us):
        raise ValueError("sn_group's CUDA implementation takes CUDA tensors")
    return _launch_group(ws, us)


def _sn_group_fake(ws, us):
    for w, u in zip(ws, us):
        _check(w, u)
    return _group_buffers(ws)


_lib = torch.library.Library("rcgan", "FRAGMENT")
_lib.define("sn_group(Tensor[] ws, Tensor[] us) -> (Tensor, Tensor)")
_lib.impl("sn_group", _sn_group_cpu, "CPU")
_lib.impl("sn_group", sn_group_cuda, "CUDA")
torch.library.register_fake("rcgan::sn_group", _sn_group_fake, lib=_lib)
sn_group_op = torch.ops.rcgan.sn_group.default


@register_sharding(sn_group_op)
def _sn_group_sharding(ws, us):
    """Every input and both outputs replicated: a cluster normalises a whole
    ``W`` in one launch, so a weight sharded on a mesh dimension is gathered
    first, as XLA gathers before a custom call."""
    return [([Replicate(), Replicate()], [Replicate()] * (len(ws) + len(us)))]


class SpectralNormGroupFn(torch.autograd.Function):
    """``(w_0, u_0, w_1, u_1, ...) → (W_0/σ_0, u'_0, σ_0, W_1/σ_1, ...)``
    through :data:`sn_group_op`: one kernel launch for the group on CUDA,
    :func:`sn_plain` per weight on the CPU; backward through the power
    iteration, one VJP launch for the weights that need it on CUDA,
    :func:`sn_vjp_plain` per weight on the CPU."""

    @staticmethod
    def forward(ctx, *flat):
        ws, us = list(flat[0::2]), list(flat[1::2])
        out = _group_views(ws, *sn_group_op(ws, us))
        ctx.save_for_backward(*flat)
        ctx.set_materialize_grads(False)
        return tuple(out)

    @staticmethod
    def backward(ctx, *cts):
        # on a mesh, every tensor whole on every rank, as the op took them
        return runtime.replicated_local(
            functools.partial(_sn_group_backward, ctx.needs_input_grad, len(cts)),
            *ctx.saved_tensors, *cts)


def _sn_group_backward(needs, n_cts: int, *tensors):
    """The gradients of :class:`SpectralNormGroupFn`'s inputs from its
    saved ``(w, u)`` pairs and the cotangents (None where there are none):
    the VJP of :func:`sn_plain` with respect to each ``w`` that ``needs``
    one and has a cotangent; on the card one launch for all of them
    (:func:`_launch_vjp`), on the CPU :func:`sn_vjp_plain` per weight."""
    flat, cts = tensors[:-n_cts], tensors[-n_cts:]
    grads = [None] * len(flat)
    todo = [i for i in range(len(flat) // 2)
            if needs[2 * i] and any(c is not None for c in cts[3 * i:3 * i + 3])]
    if not todo:
        return tuple(grads)
    items = [(flat[2 * i], flat[2 * i + 1], *cts[3 * i:3 * i + 3]) for i in todo]
    if runtime.on_cuda(*[t for item in items for t in item if t is not None]):
        dws = _launch_vjp(items)
    else:
        dws = [sn_vjp_plain(*item) for item in items]
    for i, dw in zip(todo, dws):
        grads[2 * i] = dw
    return tuple(grads)


def _cotangent(c, shape, what: str):
    if c is None:
        return None
    if c.dtype != torch.float32 or c.shape != shape:
        raise TypeError(f"spectral norm's VJP takes a float32 cotangent of {what} shaped "
                        f"{tuple(shape)}; got {c.dtype} {tuple(c.shape)}")
    return c.contiguous()


def _launch_vjp(items):
    """``[(w, u0, Ḡ, gu, gσ), ...]`` (cotangents None for zero) → ``[dW,
    ...]``: one launch of the VJP kernel per ``MAX_WEIGHTS`` weights, dW
    written into views of one buffer."""
    ws, gbars, gus, gsigmas = [], [], [], []
    for w, u0, gbar, gu, gsigma in items:
        _check(w, u0)
        gbar = _cotangent(gbar, w.shape, "W/σ")
        ws.append(w)
        gbars.append(torch.zeros_like(w) if gbar is None else gbar)
        gus.append(_cotangent(gu, u0.shape, "u'"))
        gsigmas.append(_cotangent(gsigma, torch.Size([]), "σ"))
    big = torch.empty((sum(w.numel() for w in ws),), dtype=torch.float32, device=ws[0].device)
    dws = [t.view(w.shape) for t, w in zip(big.split([w.numel() for w in ws]), ws)]
    lib = runtime.cuda_library("sn")
    fn = lib.sn_vjp_f32
    if fn.argtypes is None:  # first use of this entry point
        if lib.sn_vjp_bytes() != ctypes.sizeof(_SnVjpGroup) or lib.sn_max_weights() != MAX_WEIGHTS:
            raise RuntimeError("sn: the library's VJP descriptor differs from the wrapper's")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for start in range(0, len(items), MAX_WEIGHTS):
        chunk = range(start, min(start + MAX_WEIGHTS, len(items)))
        shapes = [tuple(ws[i].shape) for i in chunk]
        group = _SnVjpGroup()
        group.col_cap, group.row_cap, group.tile_cap = vjp_smem(shapes)
        scratch = torch.empty((vjp_scratch(shapes, group.row_cap),), dtype=torch.float32,
                              device=big.device)
        group.scratch = scratch.data_ptr() or None  # an empty buffer's is null
        for k, i in enumerate(chunk):
            d = group.w[k]
            d.w, d.u0, d.gbar, d.dw = (t.data_ptr() for t in (ws[i], items[i][1], gbars[i],
                                                              dws[i]))
            d.gu = gus[i].data_ptr() if gus[i] is not None else None
            d.gsigma = gsigmas[i].data_ptr() if gsigmas[i] is not None else None
            d.m, d.cout = ws[i].shape
        smem = 4 * (3 * group.col_cap + 2 * group.row_cap + 2 * group.tile_cap)
        code = runtime.on_device(big, fn, ctypes.addressof(group), len(chunk), smem)
        runtime.check_cuda_status(lib, "sn_error_string", code, "sn VJP launch")
        runtime.count_launch("sn_bwd")
    return dws


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
