"""The weights and the spectral-norm state that the benchmark hands to both
the program and the reference, drawn on the device from the seed in one
call.

Each leaf's kind (from the reference's ``param_specs``) sets its scale:
``fan`` a weight, normal with variance ``2 / (fan_in + fan_out)``; ``bias``
and ``offset`` normal at 0.02; ``scale`` 1 plus that; ``embedding`` normal
at 0.05; ``confusion`` rcgan-u's diagonal-dominant start when the traffic
asks for it (``confuse_init``), else a ``fan`` draw.  Each spectral-norm
``u`` is a standard normal row.  Leaves are laid out in sorted order, so
the same seed gives the same values whatever asks for them.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from benchmark.reference.layers import Key


def _fan(shape) -> Tuple[int, int]:
    if len(shape) == 4:  # HWIO
        k = shape[0] * shape[1]
        return k * shape[2], k * shape[3]
    return shape[0], shape[-1]


def draw(specs: Mapping[Key, Tuple[Tuple[int, ...], str]], sn: Mapping[str, int], seed: int,
         device, confusion: Optional[Callable[[Tuple[int, ...]], torch.Tensor]] = None
         ) -> Tuple[Dict[Key, torch.Tensor], Dict[str, torch.Tensor]]:
    """``(params, u)``: float32 leaves by ``(scope, var)`` and ``u [1,
    cout]`` by scope, on ``device``.  ``confusion(shape)``, when given,
    returns the ``confusion`` leaf's fixed start."""
    keys = sorted(specs)
    sizes = [math.prod(specs[k][0]) for k in keys]
    scopes = sorted(sn)
    total = sum(sizes) + sum(sn[s] for s in scopes)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & ((1 << 63) - 1))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    params, pos = {}, 0
    for k, n in zip(keys, sizes):
        shape, kind = specs[k]
        x = flat[pos:pos + n].reshape(shape)
        pos += n
        if kind == "fan" or (kind == "confusion" and confusion is None):
            fi, fo = _fan(shape)
            x = x * math.sqrt(2.0 / (fi + fo))
        elif kind in ("bias", "offset"):
            x = 0.02 * x
        elif kind == "scale":
            x = 1.0 + 0.02 * x
        elif kind == "embedding":
            x = 0.05 * x
        elif kind == "confusion":
            x = confusion(shape).to(device=device, dtype=torch.float32)
        else:
            raise ValueError(f"{k}: unknown kind {kind!r}")
        params[k] = x.clone()
    u = {}
    for s in scopes:
        u[s] = flat[pos:pos + sn[s]].reshape(1, sn[s]).clone()
        pos += sn[s]
    return params, u
