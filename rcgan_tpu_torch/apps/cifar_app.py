"""The CIFAR-10 experiment, the counterpart of ``rcgan_tpu/apps/cifar_app.py``
(reference: ``cifar10/gan_resnet.py`` ``main(_)``, lines 493-1035): the run
dir, the data with its noisy labels, the training cycles, the periodic
evals (inception score, dev cost and sample grid, generated-label
accuracy, the learned-C recovery for rcgan-u), checkpoints and resume, and
the final, optionally permutation-corrected, label accuracy.

    python -m rcgan_tpu_torch.apps.cifar_app --algorithm rcgan --alpha 0.6 \\
        --niters 50000 --mesh_devices 1 --nomulti_gpu_multi_batch

Flags, cadences and file layout are the JAX app's.  What differs:

- The app runs on the card; ``main(argv, device="cpu")`` runs it on the CPU
  (the tests do).
- Data parallelism: ``--ngpus``/``--mesh_devices`` choose the device count
  as JAX's do; above one, the app runs one process per rank
  (:mod:`rcgan_tpu_torch.parallel.mesh`): under ``torchrun
  --nproc_per_node N`` it joins the launcher's group, whose size must be
  the device count; alone it spawns its ranks itself (NCCL on ``cuda:0``
  to ``cuda:N-1``, which must exist; gloo ranks on the CPU with
  ``device="cpu"``).  Every rank trains on its rows of each global batch;
  rank 0 alone writes the run dir, the log, ``log.pkl``, the samples, the
  evals and the checkpoints.  Blocks (``--scan_block``) run on one device
  only, as JAX's.
- The inception score is JAX's choice of scorer: Inception-v3
  (``evals/inception_v3.py``) where ``<data_dir>/inception_v3.npz`` (or
  ``.pkl``) exists, validated on load, else the compact stand-in.
- Every random draw of training is keyed by the iteration: cycle ``i``
  takes the seed ``fold_in(train_seed, i)`` whether it runs in a block or
  alone (JAX splits a key per block), and the dev cost at iteration ``i``
  ``fold_in(eval_seed, i)``.  A run resumed from a checkpoint therefore
  draws what the uninterrupted run drew; like JAX's, its batch iterators
  restart at position 0 of the split.
- ``--profile_steps`` writes a ``torch.profiler`` Chrome trace.
- On the card (alone, or in an NCCL group, whose collectives each rank's
  graph captures) the cycle, its blocks (alone), the dev cost's scan,
  the samples, the Inception score's batches (one program for the run)
  and the classifier's logits run captured in CUDA graphs, as JAX jits
  or scans them (``train/graphs.py``), and the classifier's train step
  eagerly (device-bound; ``PERF.md`` §5); the ``stats`` phases read the
  same either way.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from rcgan_tpu_torch import config as flagslib
from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
from rcgan_tpu_torch.core import rng as trng
from rcgan_tpu_torch.data import cifar10 as cifar_data
from rcgan_tpu_torch.data.confusion import one_coin_matrix
from rcgan_tpu_torch.data.pipeline import Prefetcher
from rcgan_tpu_torch.evals.classifier import (cifar_classifier, generated_label_accuracy,
                                              train_pinned)
from rcgan_tpu_torch.evals import inception_v3
from rcgan_tpu_torch.evals.inception import InceptionScore
from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device
from rcgan_tpu_torch.parallel.mesh import join_app_group, spawn_app
from rcgan_tpu_torch.train.checkpoint import Checkpointer, load_payload
from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer
from rcgan_tpu_torch.train.failures import (PreemptionGuard, fault_injection_step,
                                            maybe_inject_fault)
from rcgan_tpu_torch.train.state import train_state_tensors
from rcgan_tpu_torch.utils import run_dir as run_dir_lib
from rcgan_tpu_torch.utils.images import save_cifar_samples, to_uint8_samples
from rcgan_tpu_torch.utils.metrics import MetricLogger
from rcgan_tpu_torch.utils.profiling import PhaseClock
from rcgan_tpu_torch.utils.summary import SummaryWriter

log = logging.getLogger(__name__)


def build_configs(flags, n_devices: int):
    batch_size = flags.batch_size
    iters = flags.niters
    if flags.multi_gpu_multi_batch:  # gan_resnet.py:190-192
        batch_size *= n_devices
        iters //= n_devices
    cfg = ResnetGANConfig(z_dim=flags.z_dim, dim_g=flags.dim_g, dim_d=flags.dim_d,
                          embedding_dim=flags.embedding_dim, algorithm=flags.algorithm,
                          perm_type=flags.perm_type)
    acfg = CifarAlgoConfig(algorithm=flags.algorithm, loss_type=flags.loss_type,
                           soft_plus=flags.soft_plus, perm_classifier=flags.perm_classifier,
                           perm_multiplier=flags.perm_multiplier,
                           confuse_init=flags.confuse_init,
                           confuse_init_diag=flags.confuse_init_diag)
    tcfg = CifarTrainConfig(lr=flags.lr, n_critic=flags.n_critic,
                            gen_bs_multiple=flags.gen_bs_multiple, decay=flags.decay,
                            confuse_multiplier=flags.confuse_multiplier,
                            confuse_lr_decay=flags.confuse_lr_decay,
                            moment_dtype=flags.opt_moment_dtype)
    return cfg, acfg, tcfg, batch_size, iters


def _cifar_images_hwc(split) -> np.ndarray:
    imgs = split.images.astype(np.float32)
    imgs = 2.0 * (imgs / 255.0 - 0.5)
    return imgs.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)


def get_eval_classifier(train_split, dev_split, cache_dir: str, train_size: int = 20000,
                        device="cuda"):
    """The stand-in for the frozen ResNet-110 scorer, trained on clean labels
    and pinned: its held-out clean accuracy is stored with the weights and
    checked again on load (``evals.classifier.train_pinned``)."""
    cls = cifar_classifier(device=device)
    path = os.path.join(cache_dir, "cifar_eval_classifier.pkl")
    acc = train_pinned(cls, path, _cifar_images_hwc(train_split)[:train_size],
                       train_split.labels_actual[:train_size], _cifar_images_hwc(dev_split),
                       dev_split.labels_actual, epochs=5, seed=321)
    log.info("CIFAR eval classifier clean accuracy: %.4f (pin %s)", acc,
             cls.meta.get("clean_accuracy"))
    return cls


def stack_batches(split: cifar_data.CifarSplit, it, n_critic: int):
    """Pull ``n_critic`` epoch batches and stack them to ``[n_critic, B]``."""
    outs = []
    for _ in range(n_critic):
        try:
            outs.append(next(it))
        except StopIteration:
            return None
    imgs, labels, rand, biased, inv_w = (np.stack(x) for x in zip(*outs))
    return {"images": imgs, "labels": labels.astype(np.int32),
            "labels_random": rand.astype(np.int32), "labels_biased": biased.astype(np.int32),
            "labels_inv_weights": inv_w.astype(np.float32)}


def infinite_batches(split, batch_size, n_critic):
    it = split.epoch(batch_size)
    while True:
        b = stack_batches(split, it, n_critic)
        if b is None:
            it = split.epoch(batch_size)
            continue
        yield b


def infinite_index_batches(split, batch_size, n_critic):
    """Index batches into the device-resident split, in the order of
    ``CifarSplit.epoch`` (contiguous batches): host int32 ``[n_critic, B]``
    arrays; the trainer gathers on the device."""
    n = (len(split) // batch_size) * batch_size
    pos = 0
    while True:
        idx = np.empty((n_critic, batch_size), np.int32)
        for j in range(n_critic):
            if pos + batch_size > n:
                pos = 0
            idx[j] = np.arange(pos, pos + batch_size, dtype=np.int32)
            pos += batch_size
        yield {"index": idx}


def infinite_g_labels(split, batch_size, gen_bs_multiple):
    """``labels_random``/``labels_biased`` for the generator batch
    (``gen_bs_multiple`` x B), as ``inf_train_gen_G``
    (``gan_resnet.py:869-882``)."""
    it = split.epoch(batch_size)
    while True:
        rs, bs_ = [], []
        for _ in range(gen_bs_multiple):
            try:
                _, _, r, b, _ = next(it)
            except StopIteration:
                it = split.epoch(batch_size)
                _, _, r, b, _ = next(it)
            rs.append(r)
            bs_.append(b)
        yield {"random": np.concatenate(rs).astype(np.int32),
               "biased": np.concatenate(bs_).astype(np.int32)}


def _to_cls_images(samples_flat: np.ndarray) -> np.ndarray:
    """Generator output in [-1, 1], flat → classifier input [B, 32, 32, 3]."""
    return to_uint8_samples(samples_flat).astype(np.float32) / 127.5 - 1.0


def _random_labels(seed: int, n: int, vocab: int, device) -> torch.Tensor:
    """``[n]`` labels in ``[0, vocab)`` from a counter-based hash of
    ``(seed, index)`` on ``device`` (a modulo bias of under 1e-17)."""
    return torch.remainder(trng.example_bits(seed, n, 1, device)[:, 0], vocab)


def _sample_images_for_cls(trainer, ts, cfg, seeds: torch.Tensor, batch: int) -> torch.Tensor:
    """A batch of the Inception score's samples from its device seeds
    (``evals.inception.batch_seeds``: the batch's seed and its labels'
    ``fold_in(seed, 1)``), the draws of :func:`_random_labels` and
    ``example_normal`` keyed on the device."""
    z = trng.example_normal_from(seeds[0], batch, cfg.z_dim)
    labels = torch.remainder(trng.example_bits_from(seeds[1], batch, 1)[:, 0], cfg.vocab_size)
    return trainer.sample(ts, z, labels).reshape(-1, 32, 32, 3)


def _learned_confusion(ts) -> np.ndarray:
    logits = ts.groups["confusion"][("confusion_logits", "logits")]
    return torch.softmax(logits.detach().float(), dim=-1).cpu().numpy()


def _scorers(flags, train_split, dev_split, dev, clock):
    """``(eval classifier, inception logits function)``: the pinned eval
    classifier, and the inception scorer, Inception-v3 (the paper's
    11.31-anchor scale) where its weights lie at
    ``<data_dir>/inception_v3.npz``, else the compact stand-in classifier
    (self-consistent, not on the paper's scale)."""
    t = time.perf_counter()
    eval_cls = get_eval_classifier(train_split, dev_split, flags.parent_dir,
                                   flags.eval_train_size, dev)
    clock.add("classifier", time.perf_counter() - t)
    iv3_path = inception_v3.find_weights(flags.data_dir)
    if iv3_path is None:
        log.info("inception scorer: compact stand-in (drop inception_v3.npz into %s for "
                 "paper-scale scores)", flags.data_dir)
        return eval_cls, eval_cls.logits
    iv3_params = inception_v3.load_weights(iv3_path)
    inception_v3.validate_weights(iv3_params)
    log.info("inception scorer: Inception-v3 from %s (paper-scale; real-CIFAR anchor ~11.31, "
             "inception_score_.py:82)", iv3_path)
    return eval_cls, inception_v3.make_logits_fn(iv3_params, device=dev)


def main(argv=None, device="cuda", stats: Optional[dict] = None):
    """Run the experiment that ``argv`` describes on ``device``; returns
    ``(train_state, final_gen_label_acc)``.  ``stats``, when given, receives
    host seconds and counts by phase (``"train"``: seconds and cycles;
    ``"inception"``, ``"dev_cost"``, ``"samples"``, ``"gen_label_acc"``,
    ``"checkpoint_save"``, ``"restore"``, ``"classifier"``, ``"data"``).
    On more than one device (module doc) every rank returns its train
    state, rank 0 the accuracy and the others None; a process that spawned
    the ranks returns rank 0's state, on ``device``, and accuracy."""
    argv = sys.argv[1:] if argv is None else list(argv)
    flags = flagslib.parse(flagslib.cifar_flags(), argv)
    dev = resolve_device(device)

    # --ngpus sets the device count (gan_resnet.py:53,183-192) unless
    # --mesh_devices overrides; capped at the devices present, as JAX caps it
    available = torch.cuda.device_count() if dev.type == "cuda" else 1
    n_devices = flags.mesh_devices or min(flags.ngpus, available)
    capped = not flags.mesh_devices and flags.ngpus > available
    group = join_app_group(n_devices, device)
    cfg, acfg, tcfg, batch_size, iters = build_configs(flags, n_devices)
    dtype = torch.bfloat16 if flags.compute_dtype == "bfloat16" else torch.float32
    c_alpha = one_coin_matrix(flags.alpha, 10)
    if group is None and n_devices > 1:  # the ranks, spawned here
        payload, acc, rank0_stats = spawn_app(main, argv, n_devices, dev, stats is not None)
        if stats is not None:
            stats.update(rank0_stats)
        ts = CifarTrainer(cfg, acfg, tcfg, c_alpha, device=dev, compute_dtype=dtype).init()
        load_payload(ts, payload)
        return ts, acc
    if group is not None:
        dev = group.device
    main_rank = group is None or group.is_main
    # force=True: a logger configured earlier (a test runner, an import)
    # would otherwise turn this into a no-op and lose the log file; rank 0
    # alone writes it
    logging.basicConfig(filename=flags.log_file if main_rank else None,
                        level=(logging.DEBUG if flags.log_level == "debug" else logging.INFO)
                        if main_rank else logging.WARNING,
                        format="%(asctime)s %(levelname)-8s %(message)s", force=True)
    clock = PhaseClock(stats, dev)
    if capped:
        log.warning("--ngpus %d exceeds available devices (%d); using %d", flags.ngpus,
                    available, n_devices)

    run_path = None
    if main_rank:
        if flags.expt_dir is not None:
            run_path = os.path.join(flags.parent_dir, flags.expt_dir)
        else:
            run_path = run_dir_lib.cifar_run_dir(flags.parent_dir, flags.algorithm,
                                                 flags.alpha, flags.run)
        os.makedirs(run_path, exist_ok=True)
        run_dir_lib.record_setting(run_path, vars(flags))
    if group is not None:
        run_path = group.broadcast_object(run_path)
    ckpt_dir = os.path.join(run_path, "checkpoint")
    log.info("alpha = %s; run dir %s; device %s; %d device(s); batch %d; iters %d",
             flags.alpha, run_path, dev, n_devices, batch_size, iters)

    t = time.perf_counter()
    train_split, dev_split = cifar_data.load(
        flags.data_dir, flags.alpha, allow_synthetic=flags.allow_synthetic,
        synthetic_train_size=flags.synthetic_train_size,
        synthetic_test_size=max(flags.batch_size, flags.synthetic_train_size // 5),
        noise_seed=flags.seed)  # replication knob; 0 = the archived stream
    clock.add("data", time.perf_counter() - t)

    device_dataset = dev_device_dataset = None
    if flags.device_data:
        device_dataset = cifar_data.device_dataset_of(train_split.arrays(), dev)
        dev_device_dataset = cifar_data.device_dataset_of(dev_split.arrays(), dev)
    trainer = CifarTrainer(cfg, acfg, tcfg, c_alpha, device=dev, compute_dtype=dtype,
                           device_dataset=device_dataset, group=group)
    ts = trainer.init(flags.seed)

    ckpt = Checkpointer(ckpt_dir, group=group)
    if flags.restore:
        t = time.perf_counter()
        restored = ckpt.restore(ts)
        clock.sync()
        if restored is not None:
            clock.add("restore", time.perf_counter() - t)
            log.info("restored from step %s", restored.step)
            ts = restored

    metrics = MetricLogger()
    # the reference writes summaries to CHECKPOINT_DIR
    tb = SummaryWriter(ckpt_dir if main_rank else None)
    eval_cls = scorer = None
    if main_rank:  # the evals run on rank 0
        eval_cls, inception_logits_fn = _scorers(flags, train_split, dev_split, dev, clock)
        # one program for every score of the run (its capture paid once)
        scorer = InceptionScore(
            lambda seeds, b: _sample_images_for_cls(trainer, ts, cfg, seeds, b),
            inception_logits_fn, batch=500, device=dev)

    if flags.device_data:
        d_iter = infinite_index_batches(train_split, batch_size, tcfg.n_critic)
    else:
        d_iter = Prefetcher(infinite_batches(train_split, batch_size, tcfg.n_critic), depth=2)
    g_iter = Prefetcher(infinite_g_labels(train_split, batch_size, tcfg.gen_bs_multiple), depth=2)

    fixed_noise = np.random.RandomState(0).normal(size=(100, cfg.z_dim)).astype(np.float32)
    fixed_labels = np.repeat(np.arange(10), 10).astype(np.int64)
    train_seed = trng.fold_in(42 + flags.seed, 0)
    eval_seed = trng.fold_in(42 + flags.seed, 1)

    def make_samples(n, deterministic=True, seed=0):
        # every batch issued, one fetch at the end
        outs, labels = [], []
        for i in range(n // 100):
            z = trng.example_normal(trng.fold_in(seed, i), 100, cfg.z_dim, dev)
            if deterministic:
                lab = torch.from_numpy(fixed_labels).to(dev)
            else:
                lab = _random_labels(trng.fold_in(seed + 1, i), 100, cfg.vocab_size, dev)
            outs.append(trainer.sample(ts, z, lab))
            labels.append(lab)
        return torch.cat(outs).cpu().numpy(), torch.cat(labels).cpu().numpy()

    if flags.profile_steps:
        # a trace of warm steps (utils/profiling; view in chrome://tracing)
        from rcgan_tpu_torch.utils.profiling import trace

        ts, _ = trainer.step(ts, next(d_iter), next(g_iter), ts.step,
                             trng.fold_in(train_seed, ts.step))
        # every rank steps (the collectives), rank 0 traces
        with trace(os.path.join(run_path, "profile")) if main_rank else contextlib.nullcontext():
            for _ in range(flags.profile_steps):
                ts, m = trainer.step(ts, next(d_iter), next(g_iter), ts.step,
                                     trng.fold_in(train_seed, ts.step))
            float(m["d_cost"])
        log.info("wrote profiler trace to %s", os.path.join(run_path, "profile"))

    start_iter = ts.step
    best = {"inception": 0.0, "gen_label_acc": 0.0}
    pending = []
    guard = PreemptionGuard()
    t0 = time.time()

    def cadence_events(iteration, m):
        """Everything the reference's loop does at an iteration after its
        step (``gan_resnet.py:949-1007``): the evals (on rank 0), then the
        flush (rank 0) and the checkpoint (every rank calls it, rank 0
        writes).  Called every iteration by the per-cycle path and at block
        ends by the block path, whose blocks end on every cadence
        iteration."""
        if main_rank:
            evals(iteration, m)
        if (iteration < 500) or (iteration % 1000 == 999):
            # the reference's cadence (gan_resnet.py:1007): flush and save
            # every early iteration, early saves throttled by
            # --ckpt_early_every; curves rendered periodically
            if main_rank:
                metrics.dir_flush(run_path,
                                  render=(iteration % 100 == 99 or iteration == iters - 1))
            if iteration >= 500 or iteration % max(1, flags.ckpt_early_every) == 0:
                t = time.perf_counter()
                ckpt.save(iteration, ts)
                clock.add("checkpoint_save", time.perf_counter() - t)

    def evals(iteration, m):
        """tb scalars, inception score, dev cost and sample grid,
        gen-label accuracy."""
        if iteration % 100 == 0:
            tb.scalar("D_wgan_cost", m["d_cost"], iteration)
            tb.scalar("G_wgan_cost", m["g_cost"], iteration)
            tb.scalar("lr", m["lr"], iteration)
            log.info("iter %d d_cost %.4f g_cost %.4f (%.3fs)", iteration, float(m["d_cost"]),
                     float(m["g_cost"]), time.time() - t0)
            if flags.algorithm == "rcgan-u":
                # learned-C drift from the true C (gan_resnet.py:922-926)
                cm = _learned_confusion(ts)
                drift = float(np.abs(cm - np.asarray(c_alpha)).max())
                diag = float(np.mean(np.diag(cm)))
                tb.scalar("confusion_drift", drift, iteration)
                log.info("iter %d learned-C: max|C-C*| %.4f mean diag %.4f (true %.2f)",
                         iteration, drift, diag, flags.alpha)

        if iteration % flags.inception_freq == flags.inception_freq - 1:
            log.info("starting inception score computation.")
            t = time.perf_counter()
            score, std = scorer(
                train_state_tensors(ts) + list(eval_cls.net.state_dict().values()), n=50000)
            clock.add("inception", time.perf_counter() - t)
            best["inception"] = max(best["inception"], score)
            metrics.plot("inception_50k", score)
            metrics.plot("inception_50k_std", std)
            metrics.plot("inception_50k_max", best["inception"])
            log.info("finished inception score computation.")

        if flags.sample_save_freq and iteration % flags.sample_save_freq == flags.sample_save_freq - 1:
            # periodic raw-sample dump (gan_resnet.py:969-973)
            samples, _ = make_samples(10000)
            np.save(os.path.join(run_path, f"_samples_{iteration}"), to_uint8_samples(samples))

        if iteration % flags.sample_freq == flags.sample_freq - 1:
            # dev cost over the held-out split (gan_resnet.py:976-989)
            t = time.perf_counter()
            dev_seed = trng.fold_in(eval_seed, iteration)
            if flags.device_data:
                n_dev = (len(dev_split) // batch_size) * batch_size
                dev_idx = np.arange(n_dev, dtype=np.int32).reshape(-1, batch_size)
                dev_cost = float(trainer.eval_disc_cost_scan(ts, dev_device_dataset, dev_idx,
                                                             dev_seed))
            else:
                costs = [trainer.eval_disc_cost(ts, dict(zip(cifar_data.DATASET_KEYS, db)),
                                                trng.fold_in(dev_seed, k))
                         for k, db in enumerate(dev_split.epoch(batch_size))]
                dev_cost = float(torch.stack(costs).mean())
            clock.add("dev_cost", time.perf_counter() - t)
            metrics.plot("dev_cost", dev_cost)

            t = time.perf_counter()
            samples = trainer.sample(ts, fixed_noise, fixed_labels).cpu().numpy()
            save_cifar_samples(samples, os.path.join(run_path, f"samples_{iteration}.png"))
            clock.add("samples", time.perf_counter() - t)

        if iteration % flags.generated_label_accuracy_freq == \
                flags.generated_label_accuracy_freq - 1:
            t = time.perf_counter()
            samples, labels = make_samples(1000)
            acc = generated_label_accuracy(eval_cls, _to_cls_images(samples), labels)
            best["gen_label_acc"] = max(best["gen_label_acc"], acc)
            metrics.plot("gen_label_acc", acc)
            metrics.plot("gen_label_acc_max", best["gen_label_acc"])
            if flags.algorithm == "rcgan-u":
                # learned-C recovery error at the same cadence:
                # permutation-corrected row-wise TV from the true C
                from rcgan_tpu_torch.evals.confusion_recovery import recovery_report

                cm = _learned_confusion(ts)
                if flags.perm_gen_label_acc:
                    # the argmax-binarized learned-C label remap the reference
                    # applies at the end of an rcgan-u run
                    # (gan_resnet.py:429-439,1022-1029), here at the cadence
                    acc_perm = generated_label_accuracy(eval_cls, _to_cls_images(samples), labels,
                                                        confusion_matrix=cm)
                    metrics.plot("gen_label_acc_perm", acc_perm)
                    log.info("iter %d gen-label-acc raw %.4f perm-corrected %.4f", iteration,
                             acc, acc_perm)
                rep = recovery_report(cm, np.asarray(c_alpha))
                metrics.plot("c_recovery_tv", rep["raw_tv"])
                metrics.plot("c_recovery_tv_perm", rep["perm_tv"])
                metrics.plot("c_mean_diag", rep["mean_diag"])
                log.info("iter %d learned-C recovery: TV=%.4f perm-TV=%.4f mean-diag=%.4f "
                         "perm=%s", iteration, rep["raw_tv"], rep["perm_tv"], rep["mean_diag"],
                         "identity" if rep["perm_is_identity"] else rep["perm"].tolist())
            clock.add("gen_label_acc", time.perf_counter() - t)

    def next_cadence_stop(i):
        """The smallest iteration >= i at which cadence_events must see the
        live train state: the %100 logs, the eval cadences, the optional
        sample dump and the checkpoint schedule."""
        stops = [i + ((-i) % 100)]
        for freq in (flags.inception_freq, flags.sample_freq,
                     flags.generated_label_accuracy_freq):
            stops.append(i + ((freq - 1 - i) % freq))
        if flags.sample_save_freq:
            stops.append(i + ((flags.sample_save_freq - 1 - i) % flags.sample_save_freq))
        if i < 500:
            stops.append(i + ((-i) % max(1, flags.ckpt_early_every)))
        else:
            stops.append(i + ((999 - i) % 1000))
        stops.append(iters - 1)
        return min(s for s in stops if s >= i)

    use_scan = (flags.device_data and group is None and flags.scan_block
                and flags.scan_block > 1)
    iteration = start_iter
    try:
        while iteration < iters:
            # ranks stop together: a signal one rank saw is shared every 50
            # cycles (a host sync)
            if guard.should_stop() if group is None else (
                    iteration % 50 == 0 and group.any(guard.should_stop())):
                log.warning("preemption requested: checkpointing at iter %d and exiting",
                            iteration)
                ckpt.save(iteration, ts)
                break
            maybe_inject_fault(iteration)
            t0 = time.time()
            if use_scan:
                # a block of up to --scan_block cycles, ending exactly on the
                # next cadence iteration and never crossing an injected fault
                k = min(flags.scan_block, next_cadence_stop(iteration) - iteration + 1,
                        iters - iteration)
                fs = fault_injection_step()
                if fs is not None and iteration < fs < iteration + k:
                    k = fs - iteration
                t = time.perf_counter()
                idxs = np.stack([next(d_iter)["index"] for _ in range(k)])
                gls = [next(g_iter) for _ in range(k)]
                g_random = np.stack([g["random"] for g in gls])
                g_biased = np.stack([g["biased"] for g in gls])
                ts, ms = trainer.step_scan(ts, idxs, g_random, g_biased, train_seed)
                # one stacked device-to-host fetch per block
                host = torch.stack([ms["d_cost"], ms["g_cost"], ms["lr"]]).cpu().numpy()
                clock.add("train", time.perf_counter() - t, k)
                for j in range(k):
                    metrics.plot_at("d_cost", float(host[0, j]), iteration + j)
                    metrics.plot_at("g_cost", float(host[1, j]), iteration + j)
                    metrics.tick()
                iteration += k
                m = {"d_cost": host[0, -1], "g_cost": host[1, -1], "lr": host[2, -1]}
                cadence_events(iteration - 1, m)
            else:
                t = time.perf_counter()
                d_batches = next(d_iter)
                g_labels = next(g_iter)
                ts, m = trainer.step(ts, d_batches, g_labels, iteration,
                                     trng.fold_in(train_seed, iteration))
                # loss scalars stay on the device; one host fetch per flush
                pending.append((iteration, m["d_cost"], m["g_cost"]))
                flush_pending = len(pending) >= 50 or iteration == iters - 1 or (
                    (iteration < 500) or (iteration % 1000 == 999))
                if flush_pending:
                    vals = torch.stack([torch.stack((d, g)) for _, d, g in pending]).cpu().numpy()
                    for (it_i, _, _), (dv, gv) in zip(pending, vals):
                        metrics.plot_at("d_cost", float(dv), it_i)
                        metrics.plot_at("g_cost", float(gv), it_i)
                    pending.clear()
                    clock.sync()
                clock.add("train", time.perf_counter() - t, 1)
                cadence_events(iteration, m)
                metrics.tick()
                iteration += 1
    except BaseException:
        ckpt.close()  # a save in flight finishes before the error leaves
        guard.uninstall()
        raise

    if not main_rank:
        ckpt.close()  # every rank waits for rank 0's last write
        guard.uninstall()
        return ts, None
    # final gen-label accuracy, optionally permutation-corrected
    # (gan_resnet.py:1021-1035); with the correction both numbers are logged
    samples, labels = make_samples(1000)
    cm = None
    if flags.perm_gen_label_acc and flags.algorithm == "rcgan-u":
        cm = _learned_confusion(ts)
    acc = generated_label_accuracy(eval_cls, _to_cls_images(samples), labels, confusion_matrix=cm)
    if cm is not None:
        raw_acc = generated_label_accuracy(eval_cls, _to_cls_images(samples), labels)
        metrics.plot("gen_label_acc_raw", raw_acc)
        log.info("final raw (uncorrected) generated label accuracy: %s", raw_acc)
    metrics.plot("gen_label_acc", acc)
    metrics.dir_flush(run_path)
    ckpt.close()  # finish the save in flight
    tb.flush()
    tb.close()
    guard.uninstall()
    log.info("final generated label accuracy: %s", acc)
    return ts, acc


if __name__ == "__main__":
    main()
