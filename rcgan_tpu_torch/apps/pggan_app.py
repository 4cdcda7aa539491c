"""The progressive-growing GAN experiment, the counterpart of
``rcgan_tpu/apps/pggan_app.py``: the PGGAN family through its whole
resolution schedule, with a conditional eval per phase against a pinned
classifier at the target resolution.

Default schedule 4 -> 8 -> 16 -> 32 -> 64 (``--max_stage 4``) on the
synthetic class-conditional data rendered at ``--size``.  Each stage is a
transition (fade-in) then a stabilization; at the end of each phase the
generated-label accuracy is scored by resizing the stage's samples to the
classifier's resolution (JAX's ``"nearest"`` resize: an integer repeat),
a row is written to ``stage_accuracy.json``, a 10x10 sample grid is saved
at the stage's resolution, and the train state is checkpointed; a run
whose run dir holds a checkpoint resumes from it (``--resume``).

    python -m rcgan_tpu_torch.apps.pggan_app --run_dir runs/pggan64 \\
        --size 64 --max_stage 4 --trans_iters 1500 --stab_iters 1500

Flags and defaults are the JAX app's.  What differs: the app runs on the
card (``main(argv, device="cpu")`` runs it on the CPU, as the tests do);
``z`` is the port's ``example_normal`` stream, not ``jax.random``'s; the
pinned classifier is the port's (its cache file is shared with the JAX
package's layout).  On the card the step (per phase), the samples (per
stage and batch) and the classifier's logits run captured in CUDA graphs,
as JAX jits them (``train/graphs.py``), and the classifier's train step
eagerly (device-bound; ``PERF.md`` §5); the ``stats`` phases read the
same either way.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from rcgan_tpu_torch.data.cifar10 import synthetic_cifar
from rcgan_tpu_torch.evals.classifier import (cifar_classifier, generated_label_accuracy,
                                              train_pinned)
from rcgan_tpu_torch.models.pggan import PGGANConfig
from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device
from rcgan_tpu_torch.train.checkpoint import Checkpointer
from rcgan_tpu_torch.train.pggan_loop import PGGANTrainConfig, PGGANTrainer
from rcgan_tpu_torch.utils import run_dir as run_dir_lib
from rcgan_tpu_torch.utils.images import image_manifold_size, save_images
from rcgan_tpu_torch.utils.metrics import MetricLogger
from rcgan_tpu_torch.utils.profiling import PhaseClock

log = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", required=True)
    p.add_argument("--size", type=int, default=64, help="data resolution (4*2^max_stage)")
    p.add_argument("--max_stage", type=int, default=4)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--z_dim", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--trans_iters", type=int, default=1500)
    p.add_argument("--stab_iters", type=int, default=1500)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--train_size", type=int, default=20000)
    p.add_argument("--eval_samples", type=int, default=2000)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--classifier_dir", default=None,
                   help="where the pinned eval classifier is cached; default the parent of "
                        "--run_dir, so runs on the same data share it (its file name is "
                        "keyed by size, seed and train_size)")
    p.add_argument("--resume", action=argparse.BooleanOptionalAction, default=True,
                   help="resume from the run dir's latest phase checkpoint")
    p.add_argument("--conditional", action=argparse.BooleanOptionalAction, default=True,
                   help="projection-conditional critic (without it the generator gets no "
                        "conditioning signal)")
    return p.parse_args(argv)


def _to_float(x_u8: np.ndarray, size: int) -> np.ndarray:
    """CHW-flat uint8 → NHWC float32 in [-1, 1], as JAX converts it."""
    x = x_u8.astype(np.float32).reshape(-1, 3, size, size).transpose(0, 2, 3, 1)
    return 2.0 * (x / 255.0 - 0.5)


def main(argv=None, device="cuda", stats: Optional[dict] = None):
    """Run the schedule that ``argv`` describes on ``device``; returns
    ``(train_state, eval_rows)``.  ``stats``, when given, receives host
    seconds and counts by phase: ``"data"``, ``"classifier"``,
    ``"restore"``, ``"train"`` (seconds and iterations, evals and saves left
    out), ``"eval"`` and ``"checkpoint_save"``."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    if args.size != 4 * (2 ** args.max_stage):
        raise ValueError(f"--size must be 4*2^max_stage, got {args.size} vs stage "
                         f"{args.max_stage}")
    dev = resolve_device(device)
    clock = PhaseClock({} if stats is None else stats, dev)
    os.makedirs(args.run_dir, exist_ok=True)
    run_dir_lib.record_setting(args.run_dir, vars(args))

    # ---- data: the synthetic family rendered at the target size
    t = time.perf_counter()
    x_u8, labels = synthetic_cifar(args.train_size, seed=args.seed, size=args.size)
    x = _to_float(x_u8, args.size)
    labels = labels.astype(np.int64)
    xd_u8, yd = synthetic_cifar(5000, seed=args.seed, image_seed=args.seed + 7, size=args.size)
    xd = _to_float(xd_u8, args.size)
    clock.add("data", time.perf_counter() - t)

    # ---- the pinned eval classifier at the target resolution
    t = time.perf_counter()
    cls_dir = args.classifier_dir or os.path.dirname(os.path.abspath(args.run_dir))
    cls_name = f"eval_classifier_{args.size}_s{args.seed}_n{args.train_size}.pkl"
    cls = cifar_classifier(img_size=args.size, device=dev)
    pin = train_pinned(cls, os.path.join(cls_dir, cls_name), x, labels, xd,
                       yd.astype(np.int64), epochs=3, seed=123)
    clock.add("classifier", time.perf_counter() - t)
    log.info("pinned eval classifier (%dx%d) clean accuracy: %.4f", args.size, args.size, pin)

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    cfg = PGGANConfig(z_dim=args.z_dim, dim=args.dim, max_stage=args.max_stage,
                      conditional=args.conditional)
    base = ResnetGANConfig(dim_g=args.dim, dim_d=args.dim, z_dim=args.z_dim)
    tcfg = PGGANTrainConfig(lr=args.lr, trans_iters=args.trans_iters,
                            stab_iters=args.stab_iters)
    tr = PGGANTrainer(cfg, base, tcfg, device=dev, compute_dtype=dtype)
    ts = tr.init(args.seed)

    ckpt = Checkpointer(os.path.join(args.run_dir, "ckpt"))
    restored = None
    if args.resume:
        t = time.perf_counter()
        restored = ckpt.restore(ts)
        if restored is not None:
            clock.add("restore", time.perf_counter() - t)
            ts = restored
            log.info("resuming from phase checkpoint at step %d (the schedule is "
                     "deterministic; completed phases are skipped)", ts.step)
    metrics = MetricLogger()
    x_dev = torch.from_numpy(x).to(dev)
    labels_dev = torch.from_numpy(labels).to(dev)

    def data_fn(it):
        # keyed by the iteration, so a resumed run sees the same batches
        idx = np.random.RandomState(args.seed + 2 + it).randint(len(x), size=args.batch_size)
        idx = torch.from_numpy(idx).to(dev)
        return {"x": x_dev[idx], "labels": labels_dev[idx]}

    acc_path = os.path.join(args.run_dir, "stage_accuracy.json")
    eval_rows = []
    if restored is not None and os.path.exists(acc_path):
        # the rows of the phases this process skips (a row past the restored
        # step cannot exist: the checkpoint is saved after the row)
        with open(acc_path) as f:
            eval_rows = [r for r in json.load(f) if r["iter"] <= ts.step]

    def flush_rows():
        with open(acc_path, "w") as f:
            json.dump(eval_rows, f, indent=2)

    def eval_stage(stage, trans, it, live_ts):
        """Samples at the stage's resolution, repeated up to the
        classifier's, scored for generated-label accuracy; then the grid."""
        n, per = args.eval_samples, args.batch_size
        factor = args.size // cfg.resolution(stage)
        accs = []
        for i in range(0, n, per):
            y = np.arange(i, i + per) % 10
            z = np.random.RandomState(9000 + i).randn(per, cfg.z_dim).astype(np.float32)
            s = tr.sample(live_ts, z, y, stage=stage)
            s = s.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)
            accs.append(generated_label_accuracy(cls, s.cpu().numpy(), y))
        acc = float(np.mean(accs))
        row = {"stage": stage, "res": cfg.resolution(stage), "trans": trans, "iter": it,
               "gen_label_acc": acc, "classifier_pin": pin}
        eval_rows.append(row)
        flush_rows()  # per phase, so a crash never loses a finished row
        metrics.plot_at(f"gen_label_acc_stage{stage}", acc, it)
        log.info("stage %d (%dx%d) trans=%s iter=%d gen_label_acc=%.4f", stage, row["res"],
                 row["res"], trans, it, acc)
        z = np.random.RandomState(77).randn(100, cfg.z_dim).astype(np.float32)
        grid = tr.sample(live_ts, z, np.arange(100) % 10, stage=stage).cpu().numpy()
        save_images((grid + 1.0) / 2.0, image_manifold_size(100),
                    os.path.join(args.run_dir,
                                 f"samples_stage{stage}_{'trans' if trans else 'stab'}.png"))

    t0 = time.time()

    def log_fn(stage, trans, it, m, live_ts):
        log.info("phase done: stage=%d trans=%s iter=%d d_cost=%.4f g_cost=%.4f "
                 "elapsed=%.1fs", stage, trans, it, m["d_cost"], m["g_cost"], time.time() - t0)
        t = time.perf_counter()
        metrics.plot_at("d_cost", m["d_cost"], it)
        metrics.plot_at("g_cost", m["g_cost"], it)
        eval_stage(stage, trans, it, live_ts)
        metrics.dir_flush(args.run_dir)
        clock.add("eval", time.perf_counter() - t)

    def inside():  # host seconds of the evals and saves inside train_progressive
        return sum(clock.stats.get(k, (0.0, 0))[0] for k in ("eval", "checkpoint_save"))

    start, before = ts.step, inside()
    t = time.perf_counter()
    ts = tr.train_progressive(ts, data_fn, args.seed + 1, log_fn=log_fn, ckpt=ckpt, clock=clock)
    clock.sync()
    clock.add("train", time.perf_counter() - t - (inside() - before), ts.step - start)
    ckpt.close()
    flush_rows()
    log.info("final per-stage accuracy table: %s", json.dumps(eval_rows[-args.max_stage:]))
    return ts, eval_rows


if __name__ == "__main__":
    main()
