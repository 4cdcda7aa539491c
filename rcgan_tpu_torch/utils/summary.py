"""TensorBoard summaries, the counterpart of ``rcgan_tpu/utils/summary.py``
(the reference's ``tf.summary`` scalars, histograms and images,
``mnist/model.py:226-272``, ``cifar10/gan_resnet.py:698,787,905-907``):
PyTorch's TensorBoard writer where the ``tensorboard`` package imports,
else a no-op with one logged warning (metrics still reach
:class:`~rcgan_tpu_torch.utils.metrics.MetricLogger`)."""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)


class SummaryWriter:
    """``log_dir=None``: a writer that writes nothing (a data-parallel
    rank other than 0)."""

    def __init__(self, log_dir: Optional[str]):
        self._w = None
        if log_dir is None:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter as _SW

            self._w = _SW(log_dir)
        except Exception as e:  # no tensorboard package
            log.warning("tensorboard writer unavailable (%s); summaries disabled", e)

    def scalar(self, tag: str, value, step: int):
        if self._w is not None:
            self._w.add_scalar(tag, float(value), step)

    def histogram(self, tag: str, values, step: int, bins: int = 30):
        if self._w is not None:
            self._w.add_histogram(tag, np.asarray(values), step, bins=bins)

    def image(self, tag: str, image, step: int):
        """``image [H, W, C]``, float in [0, 1] or uint8."""
        if self._w is not None:
            arr = np.asarray(image)
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
            self._w.add_image(tag, arr, step, dataformats="HWC")

    def flush(self):
        if self._w is not None:
            self._w.flush()

    def close(self):
        if self._w is not None:
            self._w.close()
