"""Intra-class MS-SSIM diversity report for a checkpoint of the port's
apps, the counterpart of ``scripts/msssim_report.py`` (the same flags, and
``--device``, and the same JSON keys).

The protocol is the mean pairwise intra-class MS-SSIM of Odena et al. 2017
("Conditional image synthesis with auxiliary classifier GANs" §4.2): for
each class, sample image pairs from the generator and average their
MS-SSIM; higher mean similarity means lower sample diversity (mode collapse
shows up as per-class means approaching 1.0).  The same statistic on the
real (training-distribution) images is the calibration baseline: a
generator that matches the data's intra-class diversity lands near the real
number, not below it (memorization) or at 1.0 (collapse).

The checkpoint is read by ``Sampler.from_checkpoint`` (a CIFAR app run's
``<run>/checkpoint``, an MNIST run's ``<run>/ckpt``, or a directory with a
JAX run's ``generator.npz``); generated pools are drawn per class from a
``torch.Generator`` seeded ``seed * 1000 + c`` (not JAX's ``jax.random``
stream, so the generated half is not comparable across the two
frameworks; the real half, from the same synthetic renders and pair draws,
is).  MS-SSIM runs on ``--device``.

    python -m rcgan_tpu_torch.evals.msssim_report --model cifar \\
        --checkpoint_dir <run>/checkpoint --per_class 32 --pairs 200 \\
        [--out msssim.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from rcgan_tpu_torch.evals.msssim import msssim_pairs


def _pair_indices(rs: np.random.RandomState, n: int, pairs: int) -> tuple:
    """``pairs`` random unordered (i, j), i != j, drawn uniformly."""
    i = rs.randint(n, size=pairs)
    j = rs.randint(n - 1, size=pairs)
    j = j + (j >= i)  # shift past i: uniform over the n-1 others
    return i, j


def _per_class_mean(images: np.ndarray, labels: np.ndarray, per_class: int, pairs: int,
                    rs: np.random.RandomState, device) -> dict:
    """Mean pairwise MS-SSIM per class over [N,H,W,C] float images in
    [0, 255]."""
    out = {}
    for c in range(10):
        idx = np.flatnonzero(labels == c)[:per_class]
        if len(idx) < 2:
            raise SystemExit(f"class {c}: only {len(idx)} images available")
        imgs = images[idx]
        i, j = _pair_indices(rs, len(imgs), pairs)
        vals = msssim_pairs(imgs[i], imgs[j], device=device).cpu().numpy()
        out[c] = {"mean": float(vals.mean()), "std": float(vals.std()),
                  "n_images": int(len(imgs)), "n_pairs": int(pairs)}
    return out


def _real_images(model: str, data_seed: int, n: int) -> tuple:
    """Training-distribution images as [N,H,W,C] float in [0,255] + labels."""
    if model == "cifar":
        from rcgan_tpu_torch.data.cifar10 import synthetic_cifar

        raw, labels = synthetic_cifar(n, seed=data_seed)
        imgs = raw.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32)
    elif model == "mnist":
        from rcgan_tpu_torch.data.mnist import synthetic_digits

        raw, labels = synthetic_digits(n, seed=data_seed)
        imgs = raw.astype(np.float32)
    else:
        raise SystemExit(f"unsupported model {model}")
    return imgs, np.asarray(labels)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=("cifar", "mnist"), default="cifar")
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--per_class", type=int, default=32,
                   help="images sampled per class (both generated and real)")
    p.add_argument("--pairs", type=int, default=200, help="random pairs scored per class")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_seed", type=int, default=0,
                   help="class-universe seed of the run's training data")
    p.add_argument("--real_pool", type=int, default=4096,
                   help="real images drawn to fill the per-class pools")
    p.add_argument("--out", default=None, help="write the report JSON here")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args(argv)

    from rcgan_tpu_torch.serving import Sampler

    sampler = Sampler.from_checkpoint(args.model, args.checkpoint_dir, device=args.device)
    rs = np.random.RandomState(args.seed)

    # generated pools: one sampler call per class, a generator seeded per class
    gen_imgs, gen_labels = [], []
    for c in range(10):
        imgs = sampler.sample([c] * args.per_class,
                              torch.Generator().manual_seed(args.seed * 1000 + c))
        gen_imgs.append(np.asarray(imgs, np.float32))
        gen_labels.append(np.full(args.per_class, c, np.int64))
    gen_imgs = np.concatenate(gen_imgs)
    gen_labels = np.concatenate(gen_labels)
    # sampler output range: CIFAR tanh [-1,1], MNIST sigmoid [0,1] -> [0,255]
    if args.model == "cifar":
        gen_imgs = (gen_imgs + 1.0) * 127.5
    else:
        gen_imgs = gen_imgs * 255.0
    gen = _per_class_mean(gen_imgs, gen_labels, args.per_class, args.pairs, rs, args.device)

    real_imgs, real_labels = _real_images(args.model, args.data_seed, args.real_pool)
    real = _per_class_mean(real_imgs, real_labels, args.per_class, args.pairs, rs, args.device)

    g_means = np.array([gen[c]["mean"] for c in range(10)])
    r_means = np.array([real[c]["mean"] for c in range(10)])
    report = {
        "model": args.model,
        "checkpoint_dir": args.checkpoint_dir,
        "per_class": args.per_class,
        "pairs": args.pairs,
        "seed": args.seed,
        "generated": {str(c): gen[c] for c in range(10)},
        "real": {str(c): real[c] for c in range(10)},
        "generated_mean": float(g_means.mean()),
        "real_mean": float(r_means.mean()),
        "max_class_gap": float(np.abs(g_means - r_means).max()),
        "protocol": "mean pairwise intra-class MS-SSIM (Odena et al. 2017)",
    }
    line = json.dumps(report)
    print(line)
    print("per-class mean MS-SSIM (generated / real):")
    for c in range(10):
        print(f"  class {c}: {g_means[c]:.4f} / {r_means[c]:.4f}")
    print(f"overall: generated {report['generated_mean']:.4f} "
          f"vs real {report['real_mean']:.4f} "
          f"(collapse reads as generated >> real; max class gap "
          f"{report['max_class_gap']:.4f})")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return report


if __name__ == "__main__":
    main()
