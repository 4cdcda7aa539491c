"""Image grids and PNG files, ported from ``rcgan_tpu/utils/images.py``
(``merge``, ``save_images``, ``save_cifar_samples``, ``to_uint8_samples``;
reference: ``mnist/utils.py:21-250``, ``cifar10/common/misc.py``).

PNGs are encoded here with zlib and struct (:func:`encode_png`), with no
image library: the serving path and the app's sample grids share it.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np


def image_manifold_size(num_images: int):
    h = int(math.floor(np.sqrt(num_images)))
    w = int(math.ceil(np.sqrt(num_images)))
    if h * w != num_images:
        raise ValueError(f"a grid of {num_images} images needs a square count")
    return h, w


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


def encode_png(arr: np.ndarray) -> bytes:
    """8-bit PNG of uint8 ``arr``: ``[H, W, 3]`` RGB or ``[H, W]`` grey."""
    arr = np.ascontiguousarray(arr, np.uint8)
    if arr.ndim == 2:
        color, channels = 0, 1
    elif arr.ndim == 3 and arr.shape[2] == 3:
        color, channels = 2, 3
    else:
        raise ValueError(f"encode_png wants [H, W] or [H, W, 3]; got {arr.shape}")
    h, w = arr.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * channels)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def save_images(images: np.ndarray, size, path: str):
    """``images`` [N, H, W, C] in [0, 1] float or uint8; writes a PNG grid."""
    grid = merge(np.asarray(images), size)
    if grid.dtype != np.uint8:
        grid = (np.clip(grid, 0.0, 1.0) * 255.0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(grid))


def save_cifar_samples(samples_flat: np.ndarray, path: str, img_size: int = 32, img_dim: int = 3):
    """[-1, 1] flat generator output → uint8 grid PNG
    (``gan_resnet.py:829-833``)."""
    n = samples_flat.shape[0]
    imgs = ((samples_flat + 1.0) * (255.0 / 2)).astype(np.uint8)
    imgs = imgs.reshape(n, img_size, img_size, img_dim)
    save_images(imgs, image_manifold_size(n), path)


def to_uint8_samples(samples_flat: np.ndarray, img_size: int = 32, img_dim: int = 3) -> np.ndarray:
    """``((x+1)*255.99/2).astype(int)`` reshaped, as fed to the label-accuracy
    classifier (``gan_resnet.py:850-861``)."""
    out = ((samples_flat + 1.0) * (255.99 / 2)).astype(np.int32)
    return out.reshape(-1, img_size, img_size, img_dim)
