"""Qualitative visualisation, ported from ``rcgan_tpu/utils/visualize.py``
(reference: ``mnist/utils.py``: ``visualize`` options 0-4, ``make_gif``,
``show_all_variables``).

``visualize`` renders generator outputs while one z coordinate sweeps (the
DCGAN interpolation diagnostics); ``make_gif`` animates them, through the
port's own GIF encoder (``utils/images.py::encode_gif``: no image library);
``show_all_variables`` is the parameter census the reference prints at
start-up (``mnist/utils.py:21-23``).
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Sequence

import numpy as np

from rcgan_tpu_torch.core.module import Params, count_params
from rcgan_tpu_torch.utils.images import encode_gif, image_manifold_size, merge, save_images

log = logging.getLogger(__name__)


def show_all_variables(params: Params) -> int:
    """Log every layer's variable shapes and the total count; returns the
    total."""
    total = 0
    for layer in sorted(params):
        for name, arr in sorted(params[layer].items()):
            n = int(np.prod(arr.shape))
            log.info("%s/%s %s (%d)", layer, name, tuple(arr.shape), n)
            total += n
    log.info("Total params: %d", total)
    if total != count_params(params):
        raise AssertionError("parameter census disagrees with count_params")
    return total


def make_gif(images: Sequence[np.ndarray], fname: str, duration_ms: int = 120):
    """An animated GIF of grey ``[H, W, 1]`` (or ``[H, W]``) frames, float in
    [0, 1] or uint8."""
    frames = []
    for im in images:
        arr = np.asarray(im)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        frames.append(arr)
    with open(fname, "wb") as f:
        f.write(encode_gif(frames, duration_ms))


def visualize(sampler: Callable[[np.ndarray, np.ndarray], np.ndarray], z_dim: int, y_dim: int,
              batch_size: int, out_dir: str, option: int = 1, n_frames: int = 10, seed: int = 0):
    """z-space sweep grids; ``sampler(z, y_onehot) -> images [B, H, W, C]``
    (numpy in, numpy out).

    option 0: one random grid.
    option 1: each of ``n_frames`` z dims swept across [-1, 1], one PNG per dim.
    option 2: the same sweep as an animated GIF per dim.
    option 3: for each z dim, the batch sweeps that coordinate across [0, 1)
      from z = 0; one GIF per dim whose frames are the batch's images
      (``mnist/utils.py:219-228``).
    option 4: option 3 for every dim, plus a forward-and-back GIF whose
      frames are grids of every dim at one sweep position
      (``mnist/utils.py:229-243``).
    """
    os.makedirs(out_dir, exist_ok=True)
    rs = np.random.RandomState(seed)
    y = np.eye(y_dim, dtype=np.float32)[np.arange(batch_size) % y_dim]

    if option == 0:
        z = rs.uniform(-1, 1, (batch_size, z_dim)).astype(np.float32)
        samples = np.asarray(sampler(z, y))
        save_images(samples, image_manifold_size(batch_size), os.path.join(out_dir, "test.png"))
        return

    if option in (3, 4):
        values = np.arange(0, 1, 1.0 / batch_size, dtype=np.float32)
        image_set = []
        for dim in range(z_dim):
            z = np.zeros((batch_size, z_dim), np.float32)
            z[:, dim] = values
            samples = np.asarray(sampler(z, y))
            image_set.append(samples)
            make_gif(list(samples), os.path.join(out_dir, f"test_gif_{dim}.gif"))
        if option == 4:
            gh, gw = image_manifold_size(z_dim)
            n_pos = min(64, batch_size)
            idxs = list(range(n_pos)) + list(range(n_pos - 1, -1, -1))
            frames = [merge(np.asarray([images[k] for images in image_set]), (gh, gw))
                      for k in idxs]
            make_gif(frames, os.path.join(out_dir, "test_gif_merged.gif"),
                     duration_ms=max(1, 8000 // len(frames)))
        return

    base_z = rs.uniform(-1, 1, (batch_size, z_dim)).astype(np.float32)
    for dim in range(min(n_frames, z_dim)):
        frames = []
        for v in np.linspace(-1.0, 1.0, n_frames):
            z = base_z.copy()
            z[:, dim] = v
            frames.append(merge(np.asarray(sampler(z, y)), image_manifold_size(batch_size)))
        if option == 1:
            last = frames[-1][..., None] if frames[-1].ndim == 2 else frames[-1]
            save_images(last[None], (1, 1), os.path.join(out_dir, f"test_arange_{dim}.png"))
        else:
            make_gif(frames, os.path.join(out_dir, f"test_gif_{dim}.gif"))
