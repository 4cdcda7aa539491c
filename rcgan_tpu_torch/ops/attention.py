"""The core of BigGAN's non-local attention block: ``softmax(q kᵀ) v`` over
each image's positions, unscaled (no ``1/√d``), as BigGAN-PyTorch's
``layers.Attention`` computes it with ``torch.bmm``.

``q [B, N, dq]``, ``k [B, M, dq]``, ``v [B, M, dv]`` → ``[B, N, dv]`` in
``q``'s dtype.  In BigGAN-128 ``N`` is 4,096 positions of a 64x64 map and
``M`` the 1,024 of its 2x2 max-pool, so the logits of one pass hold ``B``
x 4M numbers, 4 GB in bfloat16 at the critic's 512 rows: the card never
holds them.

- The forward is the ``torch.library`` op ``rcgan::attention(q, k, v)``
  (:data:`attention_op`).  Its CPU implementation is the plain version
  (:func:`attention_plain`, which does hold the logits); its CUDA one is
  PyTorch's ``scaled_dot_product_attention`` at ``scale=1.0``, with the
  backends restricted by ``sdpa_kernel`` to the fused ones (flash and
  memory-efficient, :data:`FUSED`), so that the math backend, which would
  hold the logits, is never picked.  ``q`` and ``k`` are padded with zero
  columns to ``v``'s width, which every fused backend takes (flash wants
  equal widths); zeros add nothing to ``q kᵀ``.
- The backward is the op ``rcgan::attention_backward(g, q, k, v) -> (dq,
  dk, dv)``: on the CPU in closed form (:func:`attention_backward_plain`),
  on the card the same backend's fused backward, reached through autograd
  of the forward taken again from ``q``, ``k`` and ``v``: PyTorch gives a
  fused backward only through autograd, so the card runs the attention's
  forward twice a training step.  A hand-written kernel, whose backward
  would start from the forward's saved log-sum-exp, would save that.
- Each has a fake implementation (shapes only) and a DTensor sharding
  rule: the batch sharded on dim 0 (every image attends over its own
  positions), or everything replicated.
- :class:`AttentionFn` ties the two for autograd.  The forward runs in the
  device span ``attn.fwd`` and the backward in ``attn.bwd``, nested in the
  step's phase (``utils/profiling.py::span``); each CUDA call counts under
  ``attn`` or ``attn_bwd``, variant ``sdpa``, a library route
  (``runtime.LIBRARY_VARIANTS``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from rcgan_tpu_torch.ops.kernels import runtime
from rcgan_tpu_torch.utils.profiling import span

FUSED = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION")  # torch.nn.attention.SDPBackend names


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version, in float32: ``softmax(q kᵀ) v``, in ``q``'s dtype."""
    p = torch.softmax(q.float() @ k.float().transpose(1, 2), dim=-1)
    return (p @ v.float()).to(q.dtype)


def attention_backward_plain(g: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor):
    """``(dq, dk, dv)`` of :func:`attention_plain` for the cotangent ``g``,
    in closed form in float32 (``P = softmax(q kᵀ)``, ``o = P v``)::

        dv = Pᵀ g,  dS = P ⊙ (g vᵀ − rowsum(g ⊙ o)),  dq = dS k,  dk = dSᵀ q
    """
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    p = torch.softmax(qf @ kf.transpose(1, 2), dim=-1)
    out = p @ vf
    ds = p * (gf @ vf.transpose(1, 2) - (gf * out).sum(dim=-1, keepdim=True))
    return ((ds @ kf).to(q.dtype), (ds.transpose(1, 2) @ qf).to(k.dtype),
            (p.transpose(1, 2) @ gf).to(v.dtype))


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or k.shape[:2] != v.shape[:2] \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"attention wants q [B, N, dq], k [B, M, dq], v [B, M, dv]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"attention takes q, k, v of one dtype; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")


def _padded(q, k, v):
    """``q``, ``k``, ``v`` as the fused backends take them, ``[B, 1, N, w]``:
    each padded with zero columns to the common width ``w``, a multiple of 8."""
    width = -(-max(q.shape[2], v.shape[2]) // 8) * 8
    return tuple(F.pad(t, (0, width - t.shape[2]))[:, None] for t in (q, k, v))


def _fused(q, k, v):
    """The fused forward on the card, differentiable (autograd records it
    where the inputs require grad), on :func:`_padded` inputs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([getattr(SDPBackend, b) for b in FUSED]):
        out = F.scaled_dot_product_attention(*_padded(q, k, v), scale=1.0)
    return out[:, 0, :, :v.shape[2]]


def fused_backend(q, k, v) -> str:
    """The name (of ``SDPBackend``) of the backend that :func:`_fused` runs
    on for these inputs: PyTorch's own choice among :data:`FUSED`."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([getattr(SDPBackend, b) for b in FUSED]):
        return SDPBackend(torch._fused_sdp_choice(*_padded(q, k, v), scale=1.0)).name


def attention_cuda(q, k, v):
    """The op's CUDA implementation: the fused forward, counted."""
    if not runtime.on_cuda(q, k, v):
        raise ValueError("attention's CUDA implementation takes CUDA tensors")
    _check(q, k, v)
    out = _fused(q, k, v).contiguous()
    runtime.count_launch("attn", variant="sdpa")
    return out


def attention_backward_cuda(g, q, k, v):
    """The backward op's CUDA implementation: the fused forward again under
    autograd, and the backend's fused backward through it, counted."""
    if not runtime.on_cuda(g, q, k, v):
        raise ValueError("attention_backward's CUDA implementation takes CUDA tensors")
    _check(q, k, v)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = _fused(*leaves)
        grads = torch.autograd.grad(out, leaves, g.to(out.dtype))
    runtime.count_launch("attn_bwd", variant="sdpa")
    return tuple(t.contiguous() for t in grads)


def _attention_fake(q, k, v):
    _check(q, k, v)
    return q.new_empty((q.shape[0], q.shape[1], v.shape[2]))


def _attention_backward_fake(g, q, k, v):
    _check(q, k, v)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


_lib = torch.library.Library("rcgan", "FRAGMENT")
_lib.define("attention(Tensor q, Tensor k, Tensor v) -> Tensor")
_lib.define("attention_backward(Tensor g, Tensor q, Tensor k, Tensor v) "
            "-> (Tensor, Tensor, Tensor)")
_lib.impl("attention", attention_plain, "CPU")
_lib.impl("attention", attention_cuda, "CUDA")
_lib.impl("attention_backward", attention_backward_plain, "CPU")
_lib.impl("attention_backward", attention_backward_cuda, "CUDA")
torch.library.register_fake("rcgan::attention", _attention_fake, lib=_lib)
torch.library.register_fake("rcgan::attention_backward", _attention_backward_fake, lib=_lib)
attention_op = torch.ops.rcgan.attention.default
attention_backward_op = torch.ops.rcgan.attention_backward.default


@register_sharding(attention_op)
def _attention_sharding(q, k, v):
    """The batch sharded on dim 0, or everything replicated."""
    return [([Shard(0)], [Shard(0)] * 3), ([Replicate()], [Replicate()] * 3)]


@register_sharding(attention_backward_op)
def _attention_backward_sharding(g, q, k, v):
    return [([Shard(0)] * 3, [Shard(0)] * 4), ([Replicate()] * 3, [Replicate()] * 4)]


class AttentionFn(torch.autograd.Function):
    """``(q, k, v) → softmax(q kᵀ) v`` through :data:`attention_op`, its
    backward through :data:`attention_backward_op`, each in its device span
    (module doc)."""

    @staticmethod
    def forward(ctx, q, k, v):
        with span("attn.fwd"):
            out = attention_op(q, k, v)
        ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, g):
        with span("attn.bwd"):
            return attention_backward_op(g.contiguous(), *ctx.saved_tensors)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q kᵀ) v`` of ``q [B, N, dq]``, ``k [B, M, dq]``, ``v [B, M,
    dv]``, unscaled; differentiable on both devices (:class:`AttentionFn`)."""
    return AttentionFn.apply(q, k, v)
