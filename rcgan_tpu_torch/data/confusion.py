"""Confusion matrices and noisy-label corruption on the host, copied from
``rcgan_tpu/data/confusion.py`` (``one_coin_matrix``,
``class_dependent_matrix``, ``build_confusion``, ``corrupt_dataset_numpy``).

The JAX module imports jax at its top, so the port copies the numpy-only
functions rather than importing them.  The same ``RandomState`` gives the
same labels as the JAX package's ``corrupt_dataset_numpy``; its on-device
``make_label_tuple`` draws another stream, which has no counterpart here.
"""

from __future__ import annotations

import numpy as np


def one_coin_matrix(alpha: float, n_classes: int = 10) -> np.ndarray:
    """P(observed=j | true=i): diagonal alpha, off-diagonal (1-alpha)/(K-1)."""
    k = n_classes
    return ((1.0 - alpha) / (k - 1)) * np.ones((k, k)) + (
        alpha - (1.0 - alpha) / (k - 1)
    ) * np.eye(k)


def class_dependent_matrix(alpha: float, n_classes: int = 10) -> np.ndarray:
    """Class-dependent rows: diagonals linspace(0.15, -0.15+2*alpha) over the
    default 50 linspace points, first ``n_classes`` used (the reference's
    ``mnist/model.py:811-816``, its default-num linspace included)."""
    c = np.zeros((n_classes, n_classes))
    mean_diag = np.linspace(0.15, -0.15 + 2 * alpha)  # default num=50
    for i in range(n_classes):
        c[i, :] = (1.0 - mean_diag[i]) / (n_classes - 1)
        c[i, i] = mean_diag[i]
    return c


def build_confusion(alpha: float, n_classes: int = 10, class_depend: bool = False):
    c = class_dependent_matrix(alpha, n_classes) if class_depend else one_coin_matrix(alpha, n_classes)
    return c, np.linalg.inv(c)


def corrupt_dataset_numpy(rng: np.random.RandomState, y_actual: np.ndarray, c: np.ndarray,
                          c_inv: np.ndarray, real_match: bool = False):
    """``(y_real, y_gen, y_fake, y_real_weights)``: observed noisy labels
    ``~ C[y_actual]``, uniform generator labels (or ``y_real`` with
    ``real_match``), their corruption ``~ C[y_gen]``, and the rows of
    ``C⁻¹`` at ``y_real``."""
    n = len(y_actual)
    k = c.shape[0]
    cdf = np.cumsum(c, axis=-1)
    u = rng.rand(n, 1)
    y_real = (u > cdf[y_actual]).sum(axis=-1)
    y_gen = y_real if real_match else rng.randint(k, size=n)
    u2 = rng.rand(n, 1)
    y_fake = (u2 > cdf[y_gen]).sum(axis=-1)
    return (y_real.astype(np.int32), y_gen.astype(np.int32), y_fake.astype(np.int32),
            c_inv[y_real].astype(np.float32))
