"""CIFAR-10 on the device: dequantisation and the device-resident dataset,
ported from ``rcgan_tpu/data/cifar10.py`` (``dequantize_chw_to_hwc_keys``)
and ``rcgan_tpu/apps/cifar_app.py`` (``device_dataset_of``).

Images stay uint8, CHW-flat as in the CIFAR pickles, until the training
cycle gathers a micro-batch and dequantises it on the card:
``2(x/256 − 0.5) + U[0, 1/128)``, then CHW → HWC.  Two forms:

- :func:`dequantize_chw_to_hwc` takes the noise ``u [B, 3072]`` (CHW order),
  so a test can hand in the JAX package's;
- :func:`dequantize_chw_to_hwc_seeded` draws it per row from int32 seeds
  through the dequantisation kernel (:mod:`rcgan_tpu_torch.ops.kernels.dequant_kernel`).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from rcgan_tpu_torch.ops.kernels.dequant_kernel import dequantize, dequantize_plain
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device

OUTPUT_DIM = 3072
DATASET_KEYS = ("images", "labels", "labels_random", "labels_biased", "labels_inv_weights")


def dequantize_chw_to_hwc(x_int: torch.Tensor, u: torch.Tensor, img_size: int = 32,
                          img_dim: int = 3) -> torch.Tensor:
    """Integer ``x [B, 3072]`` CHW-flat and float32 noise ``u [B, 3072]`` in
    CHW order → float32 ``[B, 3072]`` HWC-flat."""
    return dequantize_plain(x_int, u, img_size, img_dim)


def dequantize_chw_to_hwc_seeded(x_u8: torch.Tensor, seeds: torch.Tensor, img_size: int = 32,
                                 img_dim: int = 3) -> torch.Tensor:
    """uint8 ``x [B, 3072]`` CHW-flat and int32 ``seeds [B]`` → float32
    ``[B, 3072]`` HWC-flat, each row's noise drawn from its own seed."""
    return dequantize(x_u8, seeds, img_size, img_dim)


def device_dataset_of(split_arrays: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The dataset resident on ``device``: uint8 images ``[N, 3072]``, int32
    ``labels``/``labels_random``/``labels_biased`` ``[N]`` and float32
    ``labels_inv_weights [N, V]`` (about 154 MB of images at N = 50 000)."""
    dev = resolve_device(device)
    images = np.asarray(split_arrays["images"])
    if images.ndim != 2 or images.shape[1] != OUTPUT_DIM:
        raise ValueError(f"images must be [N, {OUTPUT_DIM}]; got {images.shape}")
    if images.dtype != np.uint8:
        if images.min() < 0 or images.max() > 255:
            raise ValueError("images must hold uint8 values")
        images = images.astype(np.uint8)
    out = {"images": torch.from_numpy(images).to(dev)}
    for k in DATASET_KEYS[1:4]:
        out[k] = torch.from_numpy(np.asarray(split_arrays[k]).astype(np.int32)).to(dev)
    out["labels_inv_weights"] = torch.from_numpy(
        np.asarray(split_arrays["labels_inv_weights"]).astype(np.float32)).to(dev)
    n = len(images)
    if any(len(v) != n for v in out.values()):
        raise ValueError("every dataset array needs the same first dimension")
    return out
