"""The MNIST experiment, the counterpart of ``rcgan_tpu/apps/mnist_app.py``
(reference: ``mnist/main.py:70-145`` and ``DCGAN.train``,
``mnist/model.py:249-491``): the run dir, the data with its noisy labels,
the epochs (RCGAN+y's re-noising under ``--add_noise``), the sample grid
and checkpoint every 700 iterations, the generated-label accuracy and the
learned-C recovery report every 5 epochs, restore, ``--visualize``, and the
final label recovery with ``recovery.txt`` and
``recover_wrong_images.png``.

    python -m rcgan_tpu_torch.apps.mnist_app --algorithm rcgan --alpha 0.3 \\
        --disc_type projection --noestimate_confuse --noaux_classifier \\
        --noadd_noise --noconcat_y --spectral_norm --max_norm --train --epoch 100

Flags, cadences and file layout are the JAX app's.  What differs:

- The app runs on the card; ``main(argv, device="cpu")`` runs it on the CPU
  (the tests do).
- ``--mesh_devices N`` (0: every card present) trains data-parallel as
  JAX's mesh does, one process per rank (:mod:`rcgan_tpu_torch.parallel.mesh`),
  each on its rows of every batch of ``--batch_size``: under ``torchrun
  --nproc_per_node N`` the app joins the launcher's group; alone it spawns
  its ranks (NCCL on ``cuda:0`` to ``cuda:N-1``, gloo ranks on the CPU with
  ``device="cpu"``).  Rank 0 alone writes the run dir, the samples, the
  log, the checkpoints and the recovery; the ranks step iteration by
  iteration (no blocks), as JAX's mesh path.
- With ``--device_data`` (the default) the epoch runs in blocks of 50
  iterations over the dataset resident on the device
  (``MnistTrainer.step_scan``); iteration ``i`` takes the seed
  ``fold_in(train_seed, i)`` (JAX splits a key per block).
- The eval classifier is the port's, trained and pinned under
  ``--checkpoint_dir`` as JAX's is.
- On the card (alone, or in an NCCL group, whose collectives each rank's
  graph captures) the iteration, ``step_scan``'s blocks (alone), the
  samples and the classifier's logits run captured in CUDA graphs, as JAX
  jits or scans them (``train/graphs.py``); label recovery and the
  classifier's train step run eagerly, as their step is device-bound and
  a capture made per call costs more than its replays save (``PERF.md``
  §5).  The ``stats`` phases read the same either way.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from rcgan_tpu_torch import config as flagslib
from rcgan_tpu_torch.algorithms.mnist import MnistAlgoConfig
from rcgan_tpu_torch.core import rng as trng
from rcgan_tpu_torch.core.module import param_tree
from rcgan_tpu_torch.data import mnist as mnist_data
from rcgan_tpu_torch.data.confusion import one_coin_matrix
from rcgan_tpu_torch.evals.classifier import (generated_label_accuracy, mnist_classifier,
                                              train_pinned)
from rcgan_tpu_torch.evals.confusion_recovery import recovery_report
from rcgan_tpu_torch.evals.recover import (RecoverConfig, recover_labels,
                                           render_wrong_image_diagnostics)
from rcgan_tpu_torch.models.dcgan import DCGANConfig
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device
from rcgan_tpu_torch.parallel.mesh import join_app_group, spawn_app
from rcgan_tpu_torch.train.checkpoint import Checkpointer, load_payload
from rcgan_tpu_torch.train.failures import PreemptionGuard
from rcgan_tpu_torch.train.mnist_loop import MnistTrainConfig, MnistTrainer, dataset_to_device
from rcgan_tpu_torch.train.state import trainable
from rcgan_tpu_torch.utils import run_dir as run_dir_lib
from rcgan_tpu_torch.utils.images import image_manifold_size, merge, save_images
from rcgan_tpu_torch.utils.metrics import MetricLogger
from rcgan_tpu_torch.utils.profiling import PhaseClock
from rcgan_tpu_torch.utils.summary import SummaryWriter
from rcgan_tpu_torch.utils.visualize import show_all_variables, visualize

log = logging.getLogger(__name__)

BLOCK = 50  # iterations per step_scan block
SAMPLE_EVERY = 700  # the sample grid and checkpoint cadence (mnist/model.py:466)


def build_configs(flags):
    cfg = DCGANConfig(batch_size=flags.batch_size, z_dim=flags.z_dim, disc_type=flags.disc_type,
                      spectral_norm=flags.spectral_norm, max_norm=flags.max_norm,
                      concat_y=flags.concat_y,
                      concat_y_layers=tuple(int(x) for x in flags.concat_y_layers))
    acfg = MnistAlgoConfig(algorithm=flags.algorithm, estimate_confuse=flags.estimate_confuse,
                           perm_regularizer=flags.perm_regularizer, loss_fn=flags.loss_fn,
                           perm_multiplier=flags.perm_multiplier,
                           confuse_multiplier=flags.confuse_multiplier,
                           confuse_init=flags.confuse_init,
                           confuse_init_diag=flags.confuse_init_diag)
    tcfg = MnistTrainConfig(learning_rate=flags.learning_rate, beta1=flags.beta1,
                            confuse_multiplier=flags.confuse_multiplier,
                            perm_multiplier=flags.perm_multiplier)
    return cfg, acfg, tcfg


def get_eval_classifier(data: mnist_data.MnistData, cache_dir: str, train_size: int = 60000,
                        device="cuda"):
    """The stand-in for the missing frozen ``mnist_dcnn`` classifier, trained
    on clean labels and pinned: its held-out clean accuracy is stored with
    the weights and checked again on load."""
    cls = mnist_classifier(device=device)
    path = os.path.join(cache_dir, "mnist_eval_classifier.pkl")
    n_val = min(5000, len(data) // 10)
    n_train = min(train_size, len(data) - n_val)
    acc = train_pinned(cls, path, data.x[:n_train], data.y_actual[:n_train],
                       data.x[len(data) - n_val:], data.y_actual[len(data) - n_val:],
                       epochs=3, seed=123)
    log.info("MNIST eval classifier clean accuracy: %.4f (pin %s)", acc,
             cls.meta.get("clean_accuracy"))
    return cls


def batch_dict(data: mnist_data.MnistData, idx, y_real=None, y_fake=None) -> dict:
    y_real = data.y_real if y_real is None else y_real
    y_fake = data.y_fake if y_fake is None else y_fake
    return {"images": data.x[idx], "y_real": y_real[idx], "y_gen": data.y_gen[idx],
            "y_fake": y_fake[idx], "y_real_weights": data.y_real_weights[idx]}


def _learned_confusion(ts) -> np.ndarray:
    logits = ts.groups["confusion"][("confusion_logits", "logits")]
    return torch.softmax(logits.detach().float(), dim=-1).cpu().numpy()


def train(flags, trainer: MnistTrainer, ts, data: mnist_data.MnistData, ckpt: Checkpointer,
          sample_dir: str, eval_cls, metrics: MetricLogger, clock: PhaseClock):
    group = trainer.group
    main_rank = group is None or group.is_main
    tb = SummaryWriter(flags.logs_dir if main_rank else None)
    dev = trainer.device
    bs = flags.batch_size
    n = min(len(data), int(flags.train_size) if np.isfinite(flags.train_size) else len(data))
    batch_idxs = n // bs
    train_seed = trng.fold_in(flags.seed + 11, 0)

    # the fixed sample grid: up to 10 examples per class by generator label
    sample_z = np.random.RandomState(0).uniform(-1, 1, (bs, flags.z_dim)).astype(np.float32)
    per_class = [np.where(data.y_gen == i)[0][:10] for i in range(10)]
    sample_labels = data.y_gen[np.concatenate(per_class)[:bs]]
    sample_y = torch.from_numpy(np.eye(10, dtype=np.float32)[sample_labels]).to(dev)

    guard = PreemptionGuard()
    counter = 1
    pending = []
    dataset_dev = None
    start = time.time()
    try:
        for epoch in range(flags.epoch):
            # with a group, the ranks stop together
            if guard.should_stop() if group is None else group.any(guard.should_stop()):
                log.warning("preemption requested: checkpointing at epoch %d and exiting", epoch)
                ckpt.save(counter, ts)
                break
            y_real_ep, y_fake_ep = data.y_real, data.y_fake
            if flags.add_noise:  # RCGAN+y's annealed re-noising (mnist/model.py:293-333)
                rel_alpha = mnist_data.noise_schedule_alpha(
                    epoch, flags.alpha, flags.noise_alpha, flags.noise_start, flags.noise_end)
                y_real_ep, y_fake_ep = mnist_data.renoise_labels(
                    np.random.RandomState(epoch), data, one_coin_matrix(rel_alpha, 10))
                survived = float(np.mean(y_real_ep == data.y_real))
                metrics.plot("noise_rel_alpha", rel_alpha)
                metrics.plot("noise_survival_frac", survived)
                log.info("epoch %d re-noising: rel_alpha=%.4f, observed y_real survival=%.4f",
                         epoch, rel_alpha, survived)

            def log_line(idx, m_at):
                pr, pf = m_at["prob_real"], m_at["prob_fake"]
                log.info("Epoch: [%2d] [%4d/%4d] time: %4.2f, d_loss: %.3f, g_loss: %.3f, "
                         "d_real: %2d, %.3f, %.3f, d_fake: %2d, %.3f, %.3f",
                         epoch, idx, batch_idxs, time.time() - start, float(m_at["d_loss"]),
                         float(m_at["g_loss"]), int((pr >= 0.5).sum()), pr.min(), pr.max(),
                         int((pf <= 0.5).sum()), pf.min(), pf.max())

            def tb_post(counter, m_at):  # the tf.summary channel (mnist/model.py:268-272)
                for name in ("d_loss", "g_loss", "d_loss_real", "d_loss_fake",
                             "class_loss_real", "class_loss_fake"):
                    tb.scalar(name, m_at[name], counter)
                tb.histogram("d", m_at["prob_real"], counter)
                tb.histogram("d_", m_at["prob_fake"], counter)

            def sample_and_ckpt(counter, idx):
                if main_rank:
                    t = time.perf_counter()
                    samples = trainer.sample(ts, sample_z, sample_y).cpu().numpy()
                    save_images(samples, image_manifold_size(samples.shape[0]),
                                os.path.join(sample_dir, f"train_{epoch:02d}_{idx:04d}.png"))
                    tb.image("G", merge(samples, image_manifold_size(samples.shape[0]))[..., None],
                             counter)
                    clock.add("samples", time.perf_counter() - t)
                t = time.perf_counter()
                ckpt.save(counter, ts)
                clock.add("checkpoint_save", time.perf_counter() - t)

            if flags.device_data and group is None:
                # the whole split resident on the device; blocks of 50
                # iterations gathered there; only the labels change across
                # epochs, and only under --add_noise
                if dataset_dev is None:
                    dataset_dev = dataset_to_device(data, n, dev)
                if flags.add_noise:
                    dataset_dev = dict(dataset_dev, **{
                        k: torch.from_numpy(v[:n].astype(np.int64)).to(dev)
                        for k, v in (("y_real", y_real_ep), ("y_fake", y_fake_ep))})
                for b0 in range(0, batch_idxs, BLOCK):
                    k = min(BLOCK, batch_idxs - b0)
                    idxs = np.arange(b0 * bs, (b0 + k) * bs, dtype=np.int64).reshape(k, bs)
                    t = time.perf_counter()
                    ts, ms = trainer.step_scan(ts, dataset_dev, idxs, train_seed)
                    # one device-to-host fetch of the block's [K] scalars
                    scalars = sorted(kk for kk, v in ms.items() if v.dim() == 1)
                    fetched = torch.stack([ms[kk].float() for kk in scalars]).cpu().numpy()
                    host = dict(zip(scalars, fetched))
                    host.update({kk: v.cpu().numpy() for kk, v in ms.items() if kk not in host})
                    clock.add("train", time.perf_counter() - t, k)
                    for j in range(k):
                        idx = b0 + j
                        m_at = {kk: v[j] for kk, v in host.items()}
                        counter += 1
                        metrics.plot("d_loss", float(m_at["d_loss"]))
                        metrics.plot("g_loss", float(m_at["g_loss"]))
                        metrics.tick()
                        if (epoch < 1 and idx < 20) or idx % 350 == 0:
                            log_line(idx, m_at)
                        if counter % 50 == 1:
                            tb_post(counter, m_at)
                    # with batch 100 (700 iterations an epoch) the blocks end
                    # on the reference's 700-iteration cadence
                    if any((counter - j) % SAMPLE_EVERY == 1 for j in range(k)) \
                            and counter > 1:
                        sample_and_ckpt(counter, b0 + k - 1)
            else:
                for idx in range(batch_idxs):
                    sl = slice(idx * bs, (idx + 1) * bs)
                    t = time.perf_counter()
                    ts, m = trainer.step(ts, batch_dict(data, sl, y_real_ep, y_fake_ep),
                                         trng.fold_in(train_seed, ts.step))
                    counter += 1
                    if (epoch < 1 and idx < 20) or idx % 350 == 0:
                        log_line(idx, {kk: v.cpu().numpy() for kk, v in m.items()})
                    # loss scalars stay on the device; one host fetch per 50
                    pending.append((m["d_loss"], m["g_loss"]))
                    if len(pending) >= 50 or idx == batch_idxs - 1:
                        vals = torch.stack([torch.stack(p) for p in pending]).cpu().numpy()
                        for dl, gl in vals:
                            metrics.plot("d_loss", float(dl))
                            metrics.plot("g_loss", float(gl))
                            metrics.tick()
                        pending.clear()
                        clock.sync()
                    clock.add("train", time.perf_counter() - t, 1)
                    if counter % 50 == 1:
                        tb_post(counter, {kk: v.cpu().numpy() for kk, v in m.items()})
                    if counter % SAMPLE_EVERY == 1:
                        sample_and_ckpt(counter, idx)

            if main_rank and (epoch + 1) % 5 == 0:  # gen-label-acc every 5 epochs
                # (model.py:473-491)
                t = time.perf_counter()
                # every sample batch issued on the device, one classification
                samps = [trainer.sample(ts, np.random.RandomState(1000 + i).uniform(
                    -1, 1, (bs, flags.z_dim)).astype(np.float32), sample_y) for i in range(100)]
                labels_all = np.tile(sample_labels, 100)
                acc = float(generated_label_accuracy(eval_cls, torch.cat(samps), labels_all))
                metrics.plot("gen_label_acc", acc)
                tb.scalar("gen_label_acc", acc, counter)
                log.info("######EPOCH=%d, mean generated label accuracy=%s", epoch, acc)
                if "confusion" in ts.groups:  # RCGAN-U: the learned C against the true one
                    rep = recovery_report(_learned_confusion(ts), data.confusion)
                    metrics.plot("c_recovery_tv", rep["raw_tv"])
                    metrics.plot("c_recovery_tv_perm", rep["perm_tv"])
                    metrics.plot("c_mean_diag", rep["mean_diag"])
                    tb.scalar("c_recovery_tv_perm", rep["perm_tv"], counter)
                    log.info("######EPOCH=%d, learned-C recovery: TV=%.4f perm-TV=%.4f "
                             "mean-diag=%.4f perm=%s", epoch, rep["raw_tv"], rep["perm_tv"],
                             rep["mean_diag"],
                             "identity" if rep["perm_is_identity"] else rep["perm"].tolist())
                clock.add("gen_label_acc", time.perf_counter() - t)
    finally:
        guard.uninstall()
        tb.flush()
        tb.close()
    return ts


def main(argv=None, device="cuda", stats: Optional[dict] = None):
    """Run the experiment that ``argv`` describes on ``device``; returns
    ``(train_state, recovery_metrics)`` (on more than one device, rank 0's
    metrics, None on the other ranks; a process that spawned the ranks
    returns rank 0's state, on ``device``, and metrics).  ``stats``, when given, receives
    host seconds and counts by phase (``"train"``: seconds and iterations;
    ``"data"``, ``"classifier"``, ``"restore"``, ``"samples"``,
    ``"checkpoint_save"``, ``"gen_label_acc"``, ``"recovery"``)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    flags = flagslib.parse(flagslib.mnist_flags(), argv)
    flags.input_height = flags.output_height = 28
    flags.input_width = flags.input_width or 28
    flags.output_width = flags.output_width or 28
    # the reference forces sample_dir to <run>/samples and the dataset to
    # 'mnist' after parsing (mnist/main.py:84,107); say so instead
    if flags.dataset != "mnist":
        raise SystemExit(f"--dataset {flags.dataset!r}: the MNIST CLI supports only 'mnist' "
                         "(the reference hard-codes FLAGS.dataset='mnist', mnist/main.py:107)")
    if flags.sample_dir not in ("samples/", "samples"):
        log.warning("--sample_dir %r is overridden to <run>/samples, matching the reference "
                    "(mnist/main.py:84)", flags.sample_dir)
    dev = resolve_device(device)
    available = torch.cuda.device_count() if dev.type == "cuda" else 1
    n_devices = flags.mesh_devices or available
    group = join_app_group(n_devices, device)
    cfg, acfg, tcfg = build_configs(flags)
    dtype = torch.bfloat16 if flags.compute_dtype == "bfloat16" else torch.float32
    if group is None and n_devices > 1:  # the ranks, spawned here
        payload, rec_metrics, rank0_stats = spawn_app(main, argv, n_devices, dev,
                                                      stats is not None)
        if stats is not None:
            stats.update(rank0_stats)
        ts = MnistTrainer(cfg, acfg, tcfg, one_coin_matrix(flags.alpha, 10), device=dev,
                          compute_dtype=dtype).init(flags.seed)
        load_payload(ts, payload)
        return ts, rec_metrics
    if group is not None:
        dev = group.device
    main_rank = group is None or group.is_main
    clock = PhaseClock(stats, dev)

    run_path = None
    if main_rank:
        prefix = "" if flags.dir_prefix is None else flags.dir_prefix + "_"
        if flags.checkpoint is None:
            run_path = run_dir_lib.mnist_run_dir(flags.checkpoint_dir, prefix, flags.algorithm,
                                                 flags.alpha, flags.disc_type)
        else:
            run_path = os.path.join(flags.checkpoint_dir, flags.checkpoint)
        os.makedirs(os.path.join(run_path, "samples"), exist_ok=True)
        run_dir_lib.record_setting(run_path, vars(flags), script_file=flags.script_file)
    if group is not None:
        run_path = group.broadcast_object(run_path)
    sample_dir = os.path.join(run_path, "samples")
    logging.basicConfig(level=logging.INFO if main_rank else logging.WARNING, force=True)
    if flags.logs_at_ckpt:
        flags.logs_dir = run_path
    log.info("run dir: %s; device %s", run_path, dev)

    t = time.perf_counter()
    data = mnist_data.load_mnist(flags.data_dir, flags.alpha, flags.confusion_class_depend,
                                 flags.real_match, seed=flags.seed,
                                 allow_synthetic=flags.allow_synthetic)
    clock.add("data", time.perf_counter() - t)
    log.info("C=\n%s\nC_inv=\n%s", data.confusion, data.confusion_inv)

    trainer = MnistTrainer(cfg, acfg, tcfg, data.confusion, device=dev, compute_dtype=dtype,
                           group=group)
    ts = trainer.init(flags.seed)
    if main_rank:
        show_all_variables(param_tree(ts.gan))  # the parameter census (mnist/utils.py:21-23)

    ckpt = Checkpointer(os.path.join(run_path, "ckpt"), group=group)
    metrics = MetricLogger()
    eval_cls = None
    if main_rank:  # the evals run on rank 0
        t = time.perf_counter()
        eval_cls = get_eval_classifier(data, flags.checkpoint_dir, flags.eval_train_size, dev)
        clock.add("classifier", time.perf_counter() - t)

    try:
        t = time.perf_counter()
        restored = ckpt.restore(ts)
        clock.sync()
        if restored is not None:
            clock.add("restore", time.perf_counter() - t)
            log.info("restored from step %s", restored.step)
        if flags.train or restored is None:
            ts = restored if restored is not None else ts
            ts = train(flags, trainer, ts, data, ckpt, sample_dir, eval_cls, metrics, clock)
            ckpt.save(int(ts.step), ts, wait=True)
        else:
            ts = restored
    finally:
        ckpt.close()
    if not main_rank:
        return ts, None
    metrics.dir_flush(run_path)

    def sample_np(z, y):
        return trainer.sample(ts, z, y).cpu().numpy()

    if flags.visualize:  # z-space walks (mnist/utils.py visualize)
        visualize(sample_np, flags.z_dim, 10, flags.batch_size,
                  os.path.join(run_path, "visualize"), option=2)

    # ---- label recovery always runs after training (mnist/main.py:142)
    t = time.perf_counter()
    rcfg = RecoverConfig(batch_size=flags.recover_batch_size, epochs=flags.recover_epoch,
                         learning_rate=flags.recover_learning_rate, z_dim=flags.z_dim)
    pick = np.random.RandomState(0).randint(len(data), size=rcfg.batch_size)
    with trainable(ts, []):  # G frozen: the gradients are z's and the labels'
        _, rec_metrics = recover_labels(
            lambda z, y: ts.gan.G(z, y, train=False), torch.from_numpy(data.x[pick]).to(dev),
            torch.from_numpy(data.y_actual[pick].astype(np.int64)).to(dev), rcfg, seed=7)
    log.info("label recovery accuracy: %s", rec_metrics["accuracy"])
    with open(os.path.join(run_path, "recovery.txt"), "w") as f:
        f.write(f"accuracy {rec_metrics['accuracy']}\n")
    render_wrong_image_diagnostics(sample_np, data.x[pick], data.y_actual[pick],
                                   rec_metrics["y_recover"], rec_metrics["z_recover"],
                                   os.path.join(run_path, "recover_wrong_images.png"))
    clock.add("recovery", time.perf_counter() - t)
    return ts, rec_metrics


if __name__ == "__main__":
    main()
