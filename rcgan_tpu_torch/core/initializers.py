"""Weight-initializer zoo, ported from ``rcgan_tpu/core/initializers.py``.

The formulas are the JAX package's (the reference's scaling rules: conv
fans ``fan_in = cin*k^2``, ``fan_out = cout*k^2/stride^2``; the linear init
zoo).  Each initializer is ``f(gen, shape, dtype) -> Tensor`` and draws from
the ``torch.Generator`` it is given, on the CPU.  The values therefore
differ from JAX's ``jax.random`` draws; the distributions match.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def constant(value: float):
    def init(gen, shape, dtype=torch.float32):
        return torch.full(tuple(shape), value, dtype=dtype)

    return init


zeros = constant(0.0)
ones = constant(1.0)


def normal(stddev: float = 0.02):
    def init(gen, shape, dtype=torch.float32):
        return stddev * torch.randn(tuple(shape), generator=gen, dtype=dtype)

    return init


def truncated_normal(stddev: float = 0.02):
    """TF ``truncated_normal_initializer``: resample beyond 2 sigma."""

    def init(gen, shape, dtype=torch.float32):
        out = torch.empty(tuple(shape), dtype=dtype)
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return stddev * out

    return init


def uniform_stdev(stdev: float):
    """Uniform on ``[-stdev*sqrt(3), stdev*sqrt(3)]`` (the GAN_Lib helper)."""
    return uniform_range(stdev * math.sqrt(3.0))


def uniform_range(limit: float):
    def init(gen, shape, dtype=torch.float32):
        u = torch.rand(tuple(shape), generator=gen, dtype=dtype)
        return (2.0 * u - 1.0) * limit

    return init


def conv_fans(shape: Sequence[int], stride: int = 1):
    """(fan_in, fan_out) for HWIO conv filters with the reference's formula."""
    kh, kw, cin, cout = shape
    fan_in = cin * kh * kw
    fan_out = cout * kh * kw / (stride**2)
    return fan_in, fan_out


def conv_uniform(stride: int = 1, he: bool = True, gain: float = 1.0):
    """he: stdev=sqrt(4/(fan_in+fan_out)); else Glorot sqrt(2/(fan_in+fan_out))."""

    def init(gen, shape, dtype=torch.float32):
        fan_in, fan_out = conv_fans(shape, stride)
        factor = 4.0 if he else 2.0
        stdev = math.sqrt(factor / (fan_in + fan_out))
        return gain * uniform_stdev(stdev)(gen, shape, dtype)

    return init


def linear_uniform(initialization=None, gain: float = 1.0):
    """The reference Linear init zoo.  ``initialization`` in
    {None, 'lecun', 'glorot'/'xavier', 'he', 'glorot_he', 'orthogonal',
    ('uniform', range)}.  ``None`` means glorot unless in==out, which the
    reference routes to orthogonal."""

    def init(gen, shape, dtype=torch.float32):
        input_dim, output_dim = shape
        spec = initialization
        if spec is None and input_dim == output_dim:
            spec = "orthogonal"
        if spec is None or spec in ("glorot", "xavier"):
            w = uniform_stdev(math.sqrt(2.0 / (input_dim + output_dim)))(gen, shape, dtype)
        elif spec == "lecun":
            w = uniform_stdev(math.sqrt(1.0 / input_dim))(gen, shape, dtype)
        elif spec == "he":
            w = uniform_stdev(math.sqrt(2.0 / input_dim))(gen, shape, dtype)
        elif spec == "glorot_he":
            w = uniform_stdev(math.sqrt(4.0 / (input_dim + output_dim)))(gen, shape, dtype)
        elif spec == "orthogonal":
            w = orthogonal()(gen, shape, dtype)
        elif isinstance(spec, (tuple, list)) and spec[0] == "uniform":
            w = uniform_range(float(spec[1]))(gen, shape, dtype)
        else:
            raise ValueError(f"Invalid initialization {initialization!r}")
        return gain * w

    return init


def orthogonal(scale: float = 1.0):
    def init(gen, shape, dtype=torch.float32):
        if len(shape) < 2:
            raise ValueError("orthogonal init needs >=2D shape")
        flat = (shape[0], math.prod(shape[1:]))
        a = torch.randn(flat, generator=gen, dtype=torch.float32)
        u, _, vt = torch.linalg.svd(a, full_matrices=False)
        q = u if tuple(u.shape) == flat else vt
        return (scale * q.reshape(tuple(shape))).to(dtype)

    return init


def glorot_uniform():
    """TF1 ``get_variable`` default (the reference's ``confusion_logits``)."""

    def init(gen, shape, dtype=torch.float32):
        fan_in, fan_out = shape[0], shape[-1]
        return uniform_range(math.sqrt(6.0 / (fan_in + fan_out)))(gen, shape, dtype)

    return init
