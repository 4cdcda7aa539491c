"""Image grids, ported from ``rcgan_tpu/utils/images.py::merge`` (numpy only)."""

from __future__ import annotations

import numpy as np


def merge(images: np.ndarray, size) -> np.ndarray:
    """Tile [N, H, W, C] into one [size0*H, size1*W, C] grid."""
    h, w = images.shape[1], images.shape[2]
    c = images.shape[3] if images.ndim == 4 else 1
    img = np.zeros((int(h * size[0]), int(w * size[1]), c), dtype=images.dtype)
    for idx, image in enumerate(images):
        i = idx % size[1]
        j = idx // size[1]
        img[j * h : j * h + h, i * w : i * w + w] = image.reshape(h, w, c)
    return img if c > 1 else img[..., 0]
