"""CIFAR-10 for the port: the splits with their noisy labels, the synthetic
stand-in, the dequantisation and the device-resident dataset, ported from
``rcgan_tpu/data/cifar10.py`` (``CifarSplit``, ``synthetic_cifar``,
``_make_split``, ``load``, ``dequantize_chw_to_hwc_keys``) and
``rcgan_tpu/apps/cifar_app.py`` (``device_dataset_of``).

A split holds the reference's 5-tuple per example: uint8 images
``[N, 3072]`` CHW-flat as in the CIFAR pickles, the noisy observed labels,
the generator's labels, their corrupted copies and the rows of ``C⁻¹``.
The labels are drawn by the native engine (:mod:`rcgan_tpu_torch.native`,
a copy of the JAX package's), so :func:`load` gives the JAX package's
labels for the same seed.

Images stay uint8 until the training cycle gathers a micro-batch and
dequantises it on the card: ``2(x/256 − 0.5) + U[0, 1/128)``, then CHW →
HWC.  Two forms:

- :func:`dequantize_chw_to_hwc` takes the noise ``u [B, 3072]`` (CHW order),
  so a test can hand in the JAX package's;
- :func:`dequantize_chw_to_hwc_seeded` draws it per row from int32 seeds
  through the dequantisation kernel
  (:mod:`rcgan_tpu_torch.ops.kernels.dequant_kernel`), whose plain version
  gives the same bits on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from rcgan_tpu_torch.data.confusion import build_confusion
from rcgan_tpu_torch.ops.kernels.dequant_kernel import dequantize, dequantize_plain
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device

TRAIN_FILES = ["data_batch_1", "data_batch_2", "data_batch_3", "data_batch_4", "data_batch_5"]
TEST_FILES = ["test_batch"]
OUTPUT_DIM = 3072
DATASET_KEYS = ("images", "labels", "labels_random", "labels_biased", "labels_inv_weights")


@dataclasses.dataclass
class CifarSplit:
    images: np.ndarray  # [N, 3072] uint8, CHW-flattened (CIFAR pickle layout)
    labels: np.ndarray  # [N] int32 noisy observed labels ~ C[y]
    labels_actual: np.ndarray  # [N] int32 true labels (evals only)
    labels_random: np.ndarray  # [N] int32 generator labels (uniform)
    labels_biased: np.ndarray  # [N] int32 ~ C[labels_random]
    labels_inv_weights: np.ndarray  # [N, 10] float32 rows of C^-1

    def __len__(self):
        return len(self.images)

    def epoch(self, batch_size: int, shard: Tuple[int, int] = (0, 1)) -> Iterator[tuple]:
        """The reference's ``get_epoch``: contiguous batches in order, the
        last partial one dropped.  ``shard=(i, n)`` yields the ``i``-th of
        ``n`` contiguous shards of every batch (a rank's rows), as JAX's."""
        i, n = shard
        per = batch_size // n
        for b in range(len(self.images) // batch_size):
            sl = slice(b * batch_size + i * per, b * batch_size + (i + 1) * per)
            yield (self.images[sl], self.labels[sl], self.labels_random[sl],
                   self.labels_biased[sl], self.labels_inv_weights[sl])

    def arrays(self) -> Dict[str, np.ndarray]:
        """The five arrays the training cycle reads, by ``DATASET_KEYS``."""
        return {k: getattr(self, k) for k in DATASET_KEYS}


def _unpickle(path: str):
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    return d[b"data"], np.asarray(d[b"labels"])


def synthetic_cifar(n: int, seed: int = 0, chunk: int = 4096, image_seed: int | None = None,
                    size: int = 32):
    """Memoized front of :func:`_render_synthetic_cifar` (same signature,
    same bits), served from the on-disk cache of
    :mod:`rcgan_tpu_torch.data._cache` when it is enabled."""
    iseed = seed if image_seed is None else image_seed
    from rcgan_tpu_torch.data._cache import memoize_render

    return memoize_render(
        "cifar",
        dict(n=n, seed=seed, chunk=chunk, iseed=iseed, size=size),
        lambda: _render_synthetic_cifar(n, seed, chunk, image_seed, size),
        code_of=_render_synthetic_cifar,
    )


def _render_synthetic_cifar(n: int, seed: int = 0, chunk: int = 4096,
                            image_seed: int | None = None, size: int = 32):
    """Class-conditional image family with continuous intra-class variation
    (CHW-flat uint8, CIFAR pickle layout), the JAX package's renderer
    operation for operation, so its bits are the same:

    - a smooth class-tinted colour gradient in a random direction;
    - two Gaussian blobs whose centres, widths and colours jitter around
      class-specific means;
    - an oriented sinusoidal grating at 2-6 cycles per image with
      class-dependent orientation and per-image frequency and phase jitter;
    - a little pixel noise.

    ``seed`` fixes the per-class distribution; ``image_seed`` (default
    ``seed``) draws the images, so a train and a test split share ``seed``
    and differ in ``image_seed``.  Class parameters are structured (blobs on
    a ring, evenly spaced hues and orientations), so every class keeps the
    same margin from its neighbours."""
    rs = np.random.RandomState(seed if image_seed is None else image_seed)
    odim = size * size * 3  # == OUTPUT_DIM at the CIFAR-native size=32
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size  # [0,1)

    def hue_rgb(h):  # [K] hues in [0,1) -> [K, 3] saturated RGB
        h = np.asarray(h, np.float32)[..., None] * 6.0
        return np.clip(np.abs((h + np.array([0.0, 4.0, 2.0], np.float32)) % 6.0 - 3.0) - 1.0,
                       0.0, 1.0).astype(np.float32)

    k = np.arange(10, dtype=np.float32)
    ang = k * (2 * np.pi / 10)
    cls_blob_centers = np.stack(
        [
            np.stack([0.5 + 0.27 * np.sin(ang), 0.5 + 0.27 * np.cos(ang)], -1),
            np.stack([0.5 + 0.14 * np.sin(ang + 2.4), 0.5 + 0.14 * np.cos(ang + 2.4)], -1),
        ],
        axis=1,
    ).astype(np.float32)  # [cls, blob, yx]
    cls_blob_colors = np.stack(
        [hue_rgb(k / 10) * 0.8 + 0.2, hue_rgb((k / 10 + 0.5) % 1.0) * 0.8 + 0.2], axis=1
    )  # [cls, blob, rgb]
    cls_bg_color = hue_rgb((k / 10 + 0.25) % 1.0) * 0.3
    cls_theta = (k * np.pi / 10).astype(np.float32)  # 18 deg apart
    cls_freq = (2.0 + (np.arange(10) % 4)).astype(np.float32)
    cls_grating_color = hue_rgb((k / 10 + 0.7) % 1.0) * 0.6 + 0.2

    labels = rs.randint(10, size=n).astype(np.int64)
    out = np.empty((n, odim), np.uint8)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        m = hi - lo
        y = labels[lo:hi]
        img = np.empty((m, 3, size, size), np.float32)

        # background: smooth linear gradient in a random direction
        bg_theta = rs.rand(m, 1, 1).astype(np.float32) * (2 * np.pi)
        ramp = (xx * np.cos(bg_theta) + yy * np.sin(bg_theta) + 1.0) * 0.5  # [m,32,32]
        img[:] = cls_bg_color[y][:, :, None, None] * ramp[:, None]

        # two jittered class blobs
        for b in range(2):
            c_yx = cls_blob_centers[y, b] + rs.randn(m, 2).astype(np.float32) * 0.06
            width = (0.10 + 0.05 * rs.rand(m).astype(np.float32)) ** 2
            d2 = (yy - c_yx[:, 0, None, None]) ** 2 + (xx - c_yx[:, 1, None, None]) ** 2
            blob = np.exp(-d2 / (2 * width[:, None, None]))
            color = np.clip(
                cls_blob_colors[y, b] + 0.1 * rs.randn(m, 3).astype(np.float32), 0, 1
            )
            img += color[:, :, None, None] * blob[:, None]

        # oriented mid-frequency grating (orientation jitter 0.08 rad, well
        # inside the 18-degree class spacing)
        theta = cls_theta[y] + rs.randn(m).astype(np.float32) * 0.08
        freq = cls_freq[y] + rs.rand(m).astype(np.float32) - 0.5
        phase = rs.rand(m).astype(np.float32) * (2 * np.pi)
        carrier = np.sin(
            2 * np.pi * freq[:, None, None]
            * (xx * np.cos(theta)[:, None, None] + yy * np.sin(theta)[:, None, None])
            + phase[:, None, None]
        )
        img += 0.18 * cls_grating_color[y][:, :, None, None] * carrier[:, None]

        img += 0.02 * rs.randn(m, 3, size, size).astype(np.float32)
        out[lo:hi] = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8).reshape(m, odim)
    return out, labels


def _make_split(images, labels_actual, alpha: float, seed: int) -> CifarSplit:
    """A split with one-coin ``alpha`` noisy labels drawn by the native
    engine's stream from ``seed`` (the JAX package's draw)."""
    from rcgan_tpu_torch import native

    c, c_inv = build_confusion(alpha, 10)
    labels, labels_random, labels_biased, inv_w = native.make_label_tuple(
        seed, labels_actual.astype(np.int32), c, c_inv, real_match=False)
    return CifarSplit(images=images, labels=labels, labels_actual=labels_actual.astype(np.int32),
                      labels_random=labels_random, labels_biased=labels_biased,
                      labels_inv_weights=inv_w)


def load(data_dir: str, alpha: float, seed: int = 0, allow_synthetic: bool = True,
         synthetic_train_size: int = 50000, synthetic_test_size: int = 10000,
         noise_seed: int | None = None) -> Tuple[CifarSplit, CifarSplit]:
    """``(train, dev)`` splits with corrupted labels, from the CIFAR-10
    pickles under ``data_dir`` or, when they are missing and
    ``allow_synthetic``, from :func:`synthetic_cifar` (train and test share
    the class universe ``seed``; the test images are drawn from ``seed +
    7``).  ``noise_seed`` (default ``seed``) seeds only the label draw:
    ``nseed + 1`` for train, ``nseed + 2`` for dev, as the JAX package."""

    def read(files):
        xs, ys = [], []
        for f in files:
            x, y = _unpickle(os.path.join(data_dir, f))
            xs.append(x)
            ys.append(y)
        return np.concatenate(xs, 0).astype(np.uint8), np.concatenate(ys, 0).astype(np.int64)

    have = all(os.path.exists(os.path.join(data_dir, f)) for f in TRAIN_FILES + TEST_FILES)
    if have:
        train_x, train_y = read(TRAIN_FILES)
        test_x, test_y = read(TEST_FILES)
    elif allow_synthetic:
        train_x, train_y = synthetic_cifar(synthetic_train_size, seed)
        test_x, test_y = synthetic_cifar(synthetic_test_size, seed, image_seed=seed + 7)
    else:
        raise FileNotFoundError(f"CIFAR-10 batches not found under {data_dir}")

    nseed = seed if noise_seed is None else noise_seed
    return (_make_split(train_x, train_y, alpha, nseed + 1),
            _make_split(test_x, test_y, alpha, nseed + 2))


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
