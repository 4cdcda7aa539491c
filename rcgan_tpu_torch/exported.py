"""Exported samplers: a generator pass written by ``Sampler.export_sampler``
with ``torch.export`` (a ``.pt2`` file), and :func:`load_exported`, the
counterpart of ``rcgan_tpu/serving.py::load_exported``.

The file holds the program (ATen ops and the ``rcgan::conv3x3``,
``rcgan::cond_batchnorm`` and ``rcgan::upsample2x`` ops), its weights,
and a small JSON record of what it serves (:data:`META`: the model, the
bucket, ``z_dim`` and the number of labels).  Loading it needs no model
code and no checkpoint: this module imports only
``rcgan_tpu_torch.ops.kernels``, which registers the three ops, and
``core.module`` for the float32 policy.  The program runs
on the device it is loaded onto, whatever device it was exported from: on
the card its ops launch the hand-written kernels (and count, as the live
sampler's do), on the CPU they take their plain versions.
"""

from __future__ import annotations

import json
from typing import Callable

import numpy as np
import torch

from rcgan_tpu_torch.core.module import float32_policy
from rcgan_tpu_torch.ops.kernels import runtime

META = "rcgan_sampler.json"


def save_program(program: torch.export.ExportedProgram, path: str, meta: dict) -> None:
    """Write ``program`` to ``path`` with ``meta`` beside it in the file."""
    torch.export.save(program, path, extra_files={META: json.dumps(meta)})


def load_exported(path: str, device="cuda") -> Callable:
    """Reload an exported sampler onto ``device`` (the card by default; a
    CUDA device that is absent raises): returns ``fn(z [B, z_dim] float32,
    labels [B] int) -> images``, a float32 tensor on ``device`` (CIFAR and
    PGGAN NHWC in [-1, 1], MNIST ``[B, 28, 28, 1]`` in [0, 1]).  ``z`` and
    ``labels`` may be numpy arrays or tensors on any device; ``B`` is the
    exported bucket.  Labels are checked on the host against ``[0,
    n_labels)`` before they reach the device, as the live sampler checks
    them.  Applies the float32 policy (TF32 off)."""
    from torch.export.passes import move_to_device_pass

    dev = runtime.resolve_device(device)
    extra = {META: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[META])
    module = move_to_device_pass(program, dev).module()
    float32_policy(torch.float32)
    b, z_dim, n_labels = meta["bucket"], meta["z_dim"], meta["n_labels"]

    def fn(z, labels) -> torch.Tensor:
        z = torch.as_tensor(z, dtype=torch.float32)
        host = labels.cpu() if isinstance(labels, torch.Tensor) else torch.from_numpy(
            np.asarray(labels))
        if tuple(z.shape) != (b, z_dim) or tuple(host.shape) != (b,):
            raise ValueError(f"the exported bucket-{b} sampler takes z [{b}, {z_dim}] and "
                             f"labels [{b}]; got {tuple(z.shape)} and {tuple(host.shape)}")
        if host.dtype.is_floating_point or host.dtype == torch.bool:
            raise ValueError("labels must be ints")
        if b and (int(host.min()) < 0 or int(host.max()) >= n_labels):
            raise ValueError(f"labels must lie in [0, {n_labels})")
        lab = labels if isinstance(labels, torch.Tensor) else host
        with torch.no_grad():
            return module(z.to(dev), lab.to(dev, torch.int64))

    fn.meta = meta
    return fn
