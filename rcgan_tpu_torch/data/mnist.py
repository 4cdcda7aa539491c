"""MNIST with its noisy labels, copied from ``rcgan_tpu/data/mnist.py``
(``MnistData``, the idx readers, ``synthetic_digits``, ``load_mnist``,
``renoise_labels``, ``noise_schedule_alpha``; reference:
``mnist/model.py:770-834``).

The raw idx files (train and test, 70 000 examples) are shuffled by a
fixed-seed permutation; C and C⁻¹ are built; and the five label arrays are
drawn by the native engine (:mod:`rcgan_tpu_torch.native`, a copy of the
JAX package's) from ``seed + 1``, so :func:`load_mnist` gives the JAX
package's labels for the same seed.  Where the idx files are absent, a
deterministic synthetic digit set with the same shapes and dtypes takes
their place (:func:`synthetic_digits`, bit-equal to JAX's, memoised on disk
by ``data/_cache.py``).

The JAX module is numpy-only but lives in a package that imports jax, so
the port keeps its own copy.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from rcgan_tpu_torch import native
from rcgan_tpu_torch.data._cache import memoize_render
from rcgan_tpu_torch.data.confusion import build_confusion


@dataclasses.dataclass
class MnistData:
    x: np.ndarray  # [N, 28, 28, 1] float32 in [0, 1]
    y_actual: np.ndarray  # [N] int32 true labels (held out; evals only)
    y_real: np.ndarray  # [N] int32 observed noisy labels ~ C[y_actual]
    y_gen: np.ndarray  # [N] int32 generator labels
    y_fake: np.ndarray  # [N] int32 ~ C[y_gen] (the RCGAN corruption)
    y_real_weights: np.ndarray  # [N, 10] float32 rows of C^-1
    confusion: np.ndarray  # [10, 10] the true C
    confusion_inv: np.ndarray

    def __len__(self):
        return len(self.x)


def _read_idx_images(path: str, n: int) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.uint8)
    return raw[16:].reshape(n, 28, 28, 1)


def _read_idx_labels(path: str, n: int) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.uint8)
    return raw[8:].reshape(n)


def synthetic_digits(n: int = 70000, seed: int = 0):
    """Memoised front of :func:`_render_synthetic_digits` (the same bits):
    repeats are served from the on-disk cache (``data/_cache.py``;
    ``RCGAN_SYNTH_CACHE=0`` disables)."""
    return memoize_render("mnist", dict(n=n, seed=seed),
                          lambda: _render_synthetic_digits(n, seed),
                          code_of=_render_synthetic_digits)


def _render_synthetic_digits(n: int = 70000, seed: int = 0):
    """Class-identifiable fake digits: three smooth Gaussian blobs per class
    at class-deterministic places and widths, with a small per-example gain,
    shift and noise.  Smooth shapes matter: a deconvolution generator learns
    them, so gen-label accuracy and recovery mean something on this
    stand-in."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    centers = rs.rand(10, 3, 2).astype(np.float32) * 20 + 4
    widths = (rs.rand(10, 3).astype(np.float32) * 3.0 + 2.0) ** 2
    templates = np.zeros((10, 28, 28), np.float32)
    for c in range(10):
        for b in range(3):
            cy, cx = centers[c, b]
            templates[c] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * widths[c, b]))
    templates = np.clip(templates, 0.0, 1.0)

    labels = rs.randint(10, size=n).astype(np.int64)
    gain = (0.8 + 0.4 * rs.rand(n, 1, 1)).astype(np.float32)
    shifts = rs.randint(-2, 3, size=(n, 2))
    imgs = templates[labels] * gain
    imgs = np.stack([np.roll(im, tuple(s), axis=(0, 1)) for im, s in zip(imgs, shifts)])
    imgs = np.clip(imgs + 0.03 * rs.randn(n, 28, 28).astype(np.float32), 0.0, 1.0)
    return (imgs[..., None] * 255).astype(np.uint8), labels


def load_mnist(data_dir: str, alpha: float, class_depend: bool = False,
               real_match: bool = False, seed: int = 547,
               allow_synthetic: bool = True) -> MnistData:
    """The 70 000 examples of ``<data_dir>/mnist`` (or the synthetic stand-in),
    shuffled by ``RandomState(seed)`` (``mnist/model.py:795-799``), with
    labels from ``C(alpha)`` drawn by the native engine from ``seed + 1``."""
    files = ["train-images-idx3-ubyte", "train-labels-idx1-ubyte",
             "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"]
    paths = [os.path.join(data_dir, "mnist", f) for f in files]
    if all(os.path.exists(p) for p in paths):
        x = np.concatenate([_read_idx_images(paths[0], 60000),
                            _read_idx_images(paths[2], 10000)], axis=0)
        y = np.concatenate([_read_idx_labels(paths[1], 60000),
                            _read_idx_labels(paths[3], 10000)], axis=0).astype(np.int64)
    elif allow_synthetic:
        x, y = synthetic_digits()
    else:
        raise FileNotFoundError(f"MNIST idx files not found under {data_dir}/mnist")

    perm = np.random.RandomState(seed).permutation(len(x))
    x, y = x[perm], y[perm]

    c, c_inv = build_confusion(alpha, 10, class_depend)
    y_real, y_gen, y_fake, y_w = native.make_label_tuple(
        seed + 1, y.astype(np.int32), c, c_inv, real_match=real_match)
    return MnistData(x=x.astype(np.float32) / 255.0, y_actual=y.astype(np.int32),
                     y_real=y_real, y_gen=y_gen, y_fake=y_fake, y_real_weights=y_w,
                     confusion=c.astype(np.float32), confusion_inv=c_inv.astype(np.float32))


def renoise_labels(rng: np.random.RandomState, data: MnistData, noise_c: np.ndarray):
    """RCGAN+y's epoch-level re-noising (``mnist/model.py:320-333``): the
    already noisy ``y_real``/``y_fake`` corrupted again through an annealed
    matrix.  Returns new ``(y_real, y_fake)``; ``data`` is left alone."""
    cdf = np.cumsum(noise_c, axis=-1)
    n = len(data)
    y_real = (rng.rand(n, 1) > cdf[data.y_real]).sum(axis=-1).astype(np.int32)
    y_fake = (rng.rand(n, 1) > cdf[data.y_fake]).sum(axis=-1).astype(np.int32)
    return y_real, y_fake


def noise_schedule_alpha(epoch: int, alpha: float, noise_alpha: float, noise_start: int,
                         noise_end: int, n_classes: int = 10) -> float:
    """The annealed noise schedule of ``mnist/model.py:293-318``: the
    *relative* coin weight applied on top of the already noisy labels at
    ``epoch`` (1.0: no extra noise)."""
    uniform = (1.0 - alpha) / (n_classes - 1)
    alpha_start = min(1.0, (noise_alpha - uniform) / (alpha - uniform))
    if noise_alpha > 0.9:
        raise ValueError(f"effective noise alpha {noise_alpha} > 0.9")
    if alpha_start == 1.0:
        end_epoch = noise_start
    else:
        end_epoch = noise_start + (noise_end - noise_start) / (0.9 - noise_alpha) * (
            alpha - noise_alpha)
        end_epoch = min(noise_end, end_epoch)
    if epoch < noise_start:
        out = alpha_start
    elif epoch < end_epoch:
        out = alpha_start + (1.0 - alpha_start) * (epoch - noise_start) / (end_epoch - noise_start)
    else:
        out = 1.0
    return min(1.0, out)
