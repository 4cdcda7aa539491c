"""Plain PyTorch pieces that the configurations' references share.

Everything is float32 with NHWC activations and HWIO filters, and nothing
here imports the program under test.  What the program derives from a seed
on its own (the latents, the dequantisation noise, the seeds of a cycle)
is worked out again here from the published arithmetic: splitmix64 over the example's index and the
column, Box-Muller for a normal, the top 24 bits for a uniform.

``Precision`` is the one place where a reference's precision is set: the
operands and results of every convolution and matrix product, and the
activations between layers, go through it, so the same code runs as the
reference (float32, TF32 off) and as the control (float8 e4m3 forward
and e5m2 backward with a per-tensor scale, accumulated in float32).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Key = Tuple[str, str]  # (scope, variable)

_U64 = (1 << 64) - 1
_SEED_MASK = (1 << 63) - 1
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}  # the largest finite


# ----------------------------------------------------------------- seeds
def _mix_np(x: np.ndarray) -> np.ndarray:
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _fold_np(seed: int, data: np.ndarray) -> np.ndarray:
    base = _mix_np(np.array([seed & _U64], np.uint64))
    return _mix_np(base ^ _mix_np(np.asarray(data, np.uint64)))


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed from ``(seed, data)``: ``mix(mix(seed) ^ mix(data))``."""
    return int(_fold_np(seed, np.array([data]))[0]) & _SEED_MASK


def example_seeds(seed: int, n: int) -> np.ndarray:
    """``[n]`` int32 seeds in ``[0, 2^31 - 1)``, one per example index."""
    h = _fold_np(seed, np.arange(n, dtype=np.uint64))
    return (h % np.uint64(2**31 - 1)).astype(np.int32)


def seed_base(seed: int) -> int:
    """``mix(seed)`` as the int64 that holds its 64 bits."""
    v = int(_mix_np(np.array([seed & _U64], np.uint64))[0])
    return v - (1 << 64) if v >= 1 << 63 else v


def _signed(x: int) -> int:
    return x - (1 << 64) if x >= 1 << 63 else x


def mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 on int64 tensors holding uint64 bits (wrapping products,
    logical shifts)."""
    def shr(v, k):
        return (v >> k) & ((1 << (64 - k)) - 1)
    x = x + _signed(0x9E3779B97F4A7C15)
    x = (x ^ shr(x, 30)) * _signed(0xBF58476D1CE4E5B9)
    x = (x ^ shr(x, 27)) * _signed(0x94D049BB133111EB)
    return x ^ shr(x, 31)


def normal_rows(seed: int, n: int, dim: int, device) -> torch.Tensor:
    """``[n, dim]`` standard normals: the hash ``mix(mix(mix(i) ^
    mix(seed)) ^ mix(j))`` of row ``i`` and column ``j`` gives ``u1`` (its
    high 32 bits, in (0, 1]) and ``u2`` (its low 32 bits, in [0, 1)), and
    Box-Muller ``sqrt(-2 ln u1) cos(2 pi u2)`` the normal."""
    index = torch.arange(n, dtype=torch.int64, device=device)
    column = torch.arange(dim, dtype=torch.int64, device=device)
    rows = mix(mix(index) ^ seed_base(seed))
    bits = mix(rows[:, None] ^ mix(column)[None, :])
    hi = (bits >> 32) & 0xFFFFFFFF
    lo = bits & 0xFFFFFFFF
    u1 = (hi.to(torch.float32) + 1.0) * 2.0 ** -32
    u2 = lo.to(torch.float32) * 2.0 ** -32
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def dequantize(x_u8: torch.Tensor, seeds: torch.Tensor, size: int, channels: int) -> torch.Tensor:
    """uint8 CHW-flat rows → float32 HWC-flat ``2 (x / 256 - 0.5) + u``,
    ``u`` in [0, 1/128) from the top 24 bits of ``mix(mix(seed) ^
    mix(chw))``: uniform dequantisation noise keyed by the row's seed."""
    dim = x_u8.shape[1]
    col = mix(torch.arange(dim, dtype=torch.int64, device=x_u8.device))
    h = mix(mix(seeds.to(torch.int64))[:, None] ^ col[None, :])
    u = ((h >> 40) & 0xFFFFFF).to(torch.float32) * 2.0 ** -31
    out = 2.0 * (x_u8.float() / 256.0 - 0.5) + u
    b = x_u8.shape[0]
    return out.reshape(b, channels, size, size).permute(0, 2, 3, 1).reshape(b, dim)


# ------------------------------------------------------------- precision
def _fp8(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to the float8 ``dtype`` under a per-tensor scale (its
    largest magnitude to the type's largest), back in float32."""
    scale = t.abs().max().clamp(min=1e-30) / FP8_MAX[dtype]
    return (t / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """Rounds to float8 e4m3 on the way in and the gradient to e5m2 on the
    way back: the two formats of float8 training."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


class _Bf16(torch.autograd.Function):
    """Rounds to bfloat16 on the way in and the gradient on the way back."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(torch.float32)


class Precision:
    """``float32``: tensors as they are.  ``bf16``: the same tensors as
    ``fp8``'s rounded to bfloat16 both ways (the cells' own precision, a
    witness of what it costs).  ``fp8``: every tensor that a step
    computed in bfloat16 stores in it (the operands and the result of each
    convolution and matrix product, and the activations between layers:
    the norms' outputs, the residual sums, the pools) rounded to float8 e4m3
    under a per-tensor scale, and the gradients that flow back through them
    to float8 e5m2, the formats of float8 training; products are accumulated
    and norms computed in float32."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "bf16", "fp8"):
            raise ValueError(f"precision {kind!r}")
        self.kind = kind

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "float32":
            return t
        return _Bf16.apply(t) if self.kind == "bf16" else _Fp8.apply(t)


# ------------------------------------------------------------------ ops
def conv(p: Precision, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """Stride-1 SAME convolution of NHWC ``x`` with an odd HWIO ``w``."""
    k = w.shape[0]
    out = F.conv2d(p.q(x).permute(0, 3, 1, 2), p.q(w).permute(3, 2, 0, 1), padding=k // 2)
    out = p.q(out.permute(0, 2, 3, 1))
    return out if b is None else out + b


def linear(p: Precision, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    out = p.q(p.q(x) @ p.q(w))
    return out if b is None else out + b


def mean_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool of NHWC ``x``."""
    return (x[:, ::2, ::2] + x[:, 1::2, ::2] + x[:, ::2, 1::2] + x[:, 1::2, 1::2]) / 4.0


def upsample(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of NHWC ``x``."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def cond_batch_norm(x: torch.Tensor, labels: torch.Tensor, scale: torch.Tensor,
                    offset: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Batch statistics over (batch, height, width), then each row's
    label's per-channel scale and offset."""
    mean = x.mean(dim=(0, 1, 2), keepdim=True)
    var = torch.square(x - mean).mean(dim=(0, 1, 2), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale[labels][:, None, None, :] \
        + offset[labels][:, None, None, :]


def batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Batch norm in train mode: the batch's statistics over every axis but
    the channels (the moving statistics never reach the output)."""
    mean = x.mean(dim=(0, 1, 2), keepdim=True)
    var = torch.square(x - mean).mean(dim=(0, 1, 2), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=3, keepdim=True) + eps)


def spectral_normed(w: torch.Tensor, u0: torch.Tensor, eps: float = 1e-12):
    """One power-iteration step from the stored ``u0 [1, cout]`` on ``w``
    flattened to ``[m, cout]``: ``v = l2n(u0 Wᵀ)``, ``u = l2n(v W)``,
    ``σ = (v W) uᵀ``.  Returns ``(W / σ in w's shape, u)``; the gradient
    flows through ``v``, ``u`` and ``σ`` (only ``u0`` is constant).  The
    vector products are written elementwise, so that no matrix product of
    the power iteration is counted as model work."""
    wm = w.reshape(-1, w.shape[-1])
    v = (wm * u0.detach()).sum(dim=1)
    v = v / (torch.sqrt(torch.sum(v * v)) + eps)
    t = (v[:, None] * wm).sum(dim=0)
    u = t / (torch.sqrt(torch.sum(t * t)) + eps)
    sigma = torch.sum(t * u)
    return (wm / sigma).reshape(w.shape), u[None, :]


def hinge_d(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    return torch.mean(F.relu(1.0 - real)) + torch.mean(F.relu(1.0 + fake))


# ------------------------------------------------------------ optimiser
class Adam:
    """Adam with the learning rate passed per step: bias-corrected moments,
    eps outside the square root, ``p ← p − lr · m̂ / (√v̂ + eps)``."""

    def __init__(self, keys: Sequence[Key], params: Dict[Key, torch.Tensor], b1: float,
                 b2: float, eps: float = 1e-8):
        self.keys, self.b1, self.b2, self.eps = list(keys), b1, b2, eps
        self.mu = {k: torch.zeros_like(params[k]) for k in self.keys}
        self.nu = {k: torch.zeros_like(params[k]) for k in self.keys}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[Key, torch.Tensor], grads: Dict[Key, torch.Tensor],
             lr: float) -> None:
        self.count += 1
        bc1 = float(np.float32(1.0) - np.power(np.float32(self.b1), np.float32(self.count)))
        bc2 = float(np.float32(1.0) - np.power(np.float32(self.b2), np.float32(self.count)))
        for k in self.keys:
            g = grads[k]
            self.mu[k] = self.b1 * self.mu[k] + (1.0 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1.0 - self.b2) * g * g
            params[k] = params[k] - lr * (self.mu[k] / bc1) / (
                torch.sqrt(self.nu[k] / bc2) + self.eps)

    def first_gradient(self) -> Dict[Key, torch.Tensor]:
        """The gradient of the one step taken: ``mu / (1 - b1)``."""
        return {k: self.mu[k] / (1.0 - self.b1) for k in self.keys}


def grads_of(cost: torch.Tensor, params: Dict[Key, torch.Tensor],
             keys: Sequence[Key]) -> Dict[Key, torch.Tensor]:
    """d cost / d params for ``keys``, zeros where the cost does not reach."""
    gs = torch.autograd.grad(cost, [params[k] for k in keys], allow_unused=True)
    return {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(keys, gs)}


def requiring(params: Dict[Key, torch.Tensor], keys: Sequence[Key]) -> Dict[Key, torch.Tensor]:
    """A view of ``params`` in which only ``keys`` require grad."""
    want = set(keys)
    return {k: v.detach().requires_grad_(k in want) for k, v in params.items()}
