"""Calibrate the inception scorer on real data, the counterpart of
``rcgan_tpu/evals/calibrate_inception.py``.

The reference records real CIFAR-10's score under frozen Inception-v3 as
11.34 (one split) and 11.31 ± 0.08 (10 splits)
(``cifar10/common/inception/inception_score_.py:82``).  This CLI measures
the same for the scorer the app would use: Inception-v3 where
``inception_v3.npz`` lies in ``--data_dir``, else the compact stand-in::

    python -m rcgan_tpu_torch.evals.calibrate_inception --data_dir ../data/cifar10 \\
        [--n 50000] [--splits 10]

It runs on the card; ``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from rcgan_tpu_torch.data import cifar10 as cifar_data
from rcgan_tpu_torch.evals import inception_v3
from rcgan_tpu_torch.evals.classifier import cifar_classifier
from rcgan_tpu_torch.evals.inception import real_data_score
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device


def main(argv=None, device="cuda"):
    """Returns ``(mean, std, scorer)``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", default="../data/cifar10/cifar-10-batches-py/")
    p.add_argument("--n", type=int, default=50000)
    p.add_argument("--splits", type=int, default=10)
    p.add_argument("--batch", type=int, default=500)
    p.add_argument("--allow_synthetic", action=argparse.BooleanOptionalAction, default=True,
                   help="fall back to synthetic data when the CIFAR-10 batches are missing "
                        "(--no-allow_synthetic to require them)")
    args = p.parse_args(argv)
    device = resolve_device(device)

    real = all(os.path.exists(os.path.join(args.data_dir, f))
               for f in cifar_data.TRAIN_FILES + cifar_data.TEST_FILES)
    train_split, _ = cifar_data.load(args.data_dir, alpha=1.0,
                                     allow_synthetic=args.allow_synthetic)
    if not real:
        print(f"WARNING: real CIFAR-10 batches not found under {args.data_dir!r}: calibrating "
              "on SYNTHETIC data. This anchor is NOT comparable to the reference's 11.31 "
              "real-data score. Pass --no-allow_synthetic to fail instead.")
    imgs = train_split.images[: args.n].astype(np.float32)
    imgs = 2.0 * (imgs / 255.0 - 0.5)
    imgs = imgs.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # CHW-flat -> HWC

    path = inception_v3.find_weights(args.data_dir)
    if path is not None:
        params = inception_v3.load_weights(path)
        inception_v3.validate_weights(params)
        logits_fn = inception_v3.make_logits_fn(params, device=device)
        scorer = f"inception_v3 ({path})"
    else:
        cls = cifar_classifier(device=device)
        cls.train(0, imgs[:20000], train_split.labels_actual[:20000], epochs=3)
        logits_fn = cls.logits
        scorer = "compact stand-in (NOT on the 11.31 scale)"

    mean, std = real_data_score(imgs, logits_fn, batch=args.batch, splits=args.splits,
                                device=device)
    print(f"scorer: {scorer}")
    print(f"real-data inception score over {len(imgs)} images: {mean:.3f} +/- {std:.3f}")
    print("reference anchor (Inception-v3, real CIFAR-10): 11.31 +/- 0.08")
    return mean, std, scorer


if __name__ == "__main__":
    main()
