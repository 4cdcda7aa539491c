"""Auxiliary image datasets, ported from ``rcgan_tpu/data/imagenet.py``
(the reference's vendored extra loaders: ``cifar10/common/data/small_imagenet.py``,
.npy shard batches; ``cifar10/common/data/ILSVRC2012.py``, a resize and
center-crop JPEG pipeline).  Optional library surface, not on the GAN main
path.  numpy only; PIL is imported inside the functions that decode or
resize images, so the module imports where PIL is absent.
"""

from __future__ import annotations

import os
from typing import Iterator, Sequence, Tuple

import numpy as np


def small_imagenet_generator(
    data_dir: str, batch_size: int, n_files: int = 10, seed: int = 0
):
    """Epoch generator over ``train_data_batch_{i}.npy`` shards of
    downsampled ImageNet, yielding [B, C*H*W]-style uint8 batches — the
    protocol of ``small_imagenet.py``."""
    paths = [os.path.join(data_dir, f"train_data_batch_{i}.npy") for i in range(1, n_files + 1)]
    paths = [p for p in paths if os.path.exists(p)]
    if not paths:
        raise FileNotFoundError(f"no small-imagenet shards under {data_dir}")

    def get_epoch() -> Iterator[np.ndarray]:
        rs = np.random.RandomState(seed)
        for p in paths:
            images = np.load(p, mmap_mode="r")
            order = rs.permutation(len(images))
            for i in range(len(images) // batch_size):
                idx = np.sort(order[i * batch_size : (i + 1) * batch_size])
                yield np.asarray(images[idx])

    return get_epoch


def center_crop_resize(img: np.ndarray, size: int) -> np.ndarray:
    """Resize shorter side to ``size`` then center-crop — the ILSVRC2012
    preprocessing (``ILSVRC2012.py`` resize pipeline)."""
    from PIL import Image

    pil = Image.fromarray(img)
    w, h = pil.size
    scale = size / min(w, h)
    pil = pil.resize((max(size, int(round(w * scale))), max(size, int(round(h * scale)))),
                     Image.BILINEAR)
    w, h = pil.size
    left, top = (w - size) // 2, (h - size) // 2
    return np.asarray(pil.crop((left, top, left + size, top + size)))


def image_folder_generator(
    root: str,
    batch_size: int,
    size: int = 64,
    extensions: Sequence[str] = (".png", ".jpg", ".jpeg"),
    class_from_subdir: bool = True,
    seed: int = 0,
):
    """Generic labeled image-folder pipeline: ``root/<class>/<img>`` →
    epoch generator yielding (images uint8 [B,size,size,3], labels int32).
    Replaces the reference's hardcoded ILSVRC reader with a reusable one."""
    samples: list[Tuple[str, int]] = []
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    ) if class_from_subdir else ["."]
    class_idx = {c: i for i, c in enumerate(classes)}
    for c in classes:
        base = os.path.join(root, c)
        for f in sorted(os.listdir(base)):
            if f.lower().endswith(tuple(extensions)):
                samples.append((os.path.join(base, f), class_idx[c]))
    if not samples:
        raise FileNotFoundError(f"no images under {root}")

    def get_epoch():
        from PIL import Image

        rs = np.random.RandomState(seed)
        order = rs.permutation(len(samples))
        for i in range(len(samples) // batch_size):
            batch_imgs = np.empty((batch_size, size, size, 3), np.uint8)
            batch_labels = np.empty((batch_size,), np.int32)
            for j, k in enumerate(order[i * batch_size : (i + 1) * batch_size]):
                path, label = samples[k]
                img = np.asarray(Image.open(path).convert("RGB"))
                batch_imgs[j] = center_crop_resize(img, size)
                batch_labels[j] = label
            yield batch_imgs, batch_labels

    return get_epoch, classes
